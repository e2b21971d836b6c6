"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from bench_tiny import BENCH, ROOT
from harness.cells import FORBIDDEN, forbidden_modules


@pytest.mark.parametrize("modules,found", [
    (["hamgnn_tpu_torch", "hamgnn_tpu_torch.e3", "torch"], []),
    (["hamgnn_tpu", "torch"], ["hamgnn_tpu"]),
    (["jax.numpy"], ["jax"]),
    (["jaxlib", "flax.linen", "optax", "orbax.checkpoint"], ["flax", "jaxlib", "optax", "orbax"]),
    (["jaxtyping", "flaxen", "hamgnn_tpu_torch_extra"], []),
])
def test_forbidden_modules_compares_whole_top_level_names(modules, found):
    assert forbidden_modules(modules) == found


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_sources_import_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref, name))}
            assert not tops & {"hamgnn_tpu_torch", *FORBIDDEN}, name


def test_reference_and_harness_modules_load_no_program_or_jax():
    """In a fresh process: the reference, the generator and the comparison
    load neither the program nor JAX."""
    code = ("import sys; sys.path[:0] = [%r]; "
            "import reference.build, reference.graph, reference.optim, harness.traffic, "
            "harness.correct, harness.work, harness.trace; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'hamgnn_tpu_torch', 'jax', 'jaxlib', 'flax', 'optax', 'orbax', 'hamgnn_tpu'}))"
            % BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
