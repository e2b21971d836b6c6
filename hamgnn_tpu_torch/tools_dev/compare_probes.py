"""Time probe kernels of this checkout against the same kernels built from
other source trees, in turns, in one process on one card.

    python -m hamgnn_tpu_torch.tools_dev.compare_probes p3 p1 --against build/parent \
        [--against build/variant ...]

A tree is a checkout of the repository (an earlier commit unpacked with
``git archive`` into ``build/``, which is not committed, or a copy with a
changed kernel); its ``hamgnn_tpu_torch/csrc/<source>.cu`` is built with the
port's nvcc flags into ``build/compare/<label>/``, all trees at once, and
ptxas's registers and spill bytes of each build are printed.  Each build of
each named probe is first held to the probe's plain version at every size
and repeated bit for bit; then the builds are timed at the probe's size in
turns (this tree, the others, the others in reverse, this tree; twice), each
a median of 8 CUDA-event readings after 2 warm-up runs, beside the plain
version and the library call.  The medians go to
``chiprun_out/compare_probes.json``.  Launches made here count on the probes'
wrappers as any other.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..e3 import tp_kernel
from ..utils.profiling import device_time_ms
from .op_probe import PROBES as OP
from .op_probe2 import PROBES as OP2
from .probe import check, describe_device
from .throughput_probe import PROBES as THROUGHPUT

ROOT = Path(tp_kernel.CSRC).parents[1]
ALL = {**OP, **OP2, **THROUGHPUT}


def build(trees: dict, source: str) -> dict:
    """label -> (library path, ptxas log) of ``source`` from each tree,
    one nvcc per tree, all started together."""
    jobs = {}
    for label, tree in trees.items():
        src = Path(tree) / "hamgnn_tpu_torch" / "csrc" / f"{source}.cu"
        if not src.exists():
            raise FileNotFoundError(f"{label}: no {src}")
        out = ROOT / "build" / "compare" / label / f"lib{source}.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [tp_kernel._nvcc(), *tp_kernel.NVCC_FLAGS, "-o", str(out), str(src)]
        jobs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out)
    built = {}
    for label, (proc, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        built[label] = (out, log)
    return built


def kernel_from(path: Path, probe) -> tp_kernel.CudaKernel:
    """The probe's kernel, launched from the library at ``path``."""
    k = tp_kernel.CudaKernel(probe.kernel.name, dict(probe.kernel.symbols), source=probe.source)
    lib = ctypes.CDLL(str(path))
    for sym, (argtypes, restype) in k.symbols.items():
        fn = getattr(lib, sym)
        fn.argtypes, fn.restype = argtypes, restype
    k._lib = lib
    return k


@contextlib.contextmanager
def launching(probe, kernel):
    """Run the probe's wrapper on ``kernel`` inside the body."""
    own = probe.kernel
    probe.kernel = kernel
    try:
        yield
    finally:
        probe.kernel = own


def main(argv: Optional[list] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("probes", nargs="+", choices=sorted(ALL))
    parser.add_argument("--against", action="append", default=[],
                        help="another tree (label = its directory name)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_probes: needs a CUDA device")
    dev = torch.device("cuda")
    trees = {"this": ROOT, **{Path(t).name: Path(t) for t in args.against}}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"compare_probes on {describe_device(dev)}; {smi.stdout.strip()}")
    sources = sorted({ALL[n].source for n in args.probes})
    libs = {src: build(trees, src) for src in sources}
    for src, built in libs.items():
        for label, (_path, log) in built.items():
            for line in log.splitlines():
                if any(k in line for k in ("entry function", "spill", "registers")):
                    print(f"[build {label}] {src}: {line.strip()}")
    report = {"card": smi.stdout.strip(), "trees": {k: str(v) for k, v in trees.items()}}
    failed = False
    for name in args.probes:
        p = ALL[name]
        kernels = {label: kernel_from(path, p) for label, (path, _log) in libs[p.source].items()}
        rows = list(p.checked_rows)
        rng = np.random.default_rng(0)
        times = {label: [] for label in kernels}
        for n in rows:
            tensors = p.inputs(rng, dev, n)
            for label, k in kernels.items():
                with launching(p, k):
                    row = check(p, tensors)
                    again = p(*tensors)
                torch.cuda.synchronize()
                same = torch.equal(row["out"], again)
                print(f"{name} {label} rows {n}: max|d| {row['max_abs_err']:.3e} of "
                      f"{row['max_abs_ref']:.3e} ok {row['ok']} repeat {same}", flush=True)
                failed |= not (row["ok"] and same)
                del row, again
            if n != rows[0]:
                continue
            order = list(kernels)
            turns = order + order[1:][::-1] + order[:1]
            for _ in range(2):
                for label in turns:
                    with launching(p, kernels[label]):
                        times[label].append(device_time_ms(p, tensors, n=8, warmup=2))
            bound, bound_by = p.bound_ms(n)
            entry = {label: float(np.median(t)) for label, t in times.items()}
            entry["plain"] = device_time_ms(p.plain, tensors, n=8, warmup=2)
            if p.library is not None:
                entry["library"] = device_time_ms(p.library, tensors, n=8, warmup=2)
            for label, ms in entry.items():
                print(f"TIME {name} {label}: {ms:.4f} ms (readings "
                      + " ".join(f"{t:.4f}" for t in times.get(label, [ms]))
                      + f"), bound {bound:.5f} ms ({bound_by}) share {bound / ms:.3f}",
                      flush=True)
            report[name] = {"rows": n, "bound_ms": bound, "bound_by": bound_by,
                            "ms": entry, "readings": times}
            del tensors
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "compare_probes.json").write_text(json.dumps(report, indent=1))
    if failed:
        print("compare_probes: FAILED: a build disagrees with the plain version or itself",
              file=sys.stderr)
        raise SystemExit(1)
    return report


if __name__ == "__main__":
    main()
