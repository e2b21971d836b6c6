"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json.  The run needs a CUDA
device (it fails without one, and prints no result); it builds the program's
kernels into ``build/kernels/`` of the checkout at its first use, and keeps
the Triton and CUDA caches under ``build/`` too.  The last line of standard
output is one JSON object: correct, attempted, failed, metrics, device
(with ``--trace 1`` also busy_s, window_s, and a breakdown), and last the
numbers compared with their limits, which also end standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda_cache"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(ROOT, "build", sub)
    sys.path[:0] = [HERE, ROOT]
    from harness import cells, runner, spec

    cell = spec.resolve(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    device = torch.device("cuda", 0)
    result = runner.execute(cell, args.seed, args.seconds, bool(args.trace), device,
                            T_START, log=log)
    bad = cells.forbidden_modules()
    if bad:
        log(f"the run loaded {bad}: the port may not load JAX or the JAX package")
        return 3
    for name, c in result["compared"].items():
        log(f"compared {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
