"""Device time of a profiled step by kind of kernel.

Reads the profile files ``chip_smoke.py`` writes to its report directory (a
header line, then ``<ms> ms <n> launches  <kernel name>`` per device kernel) and sums
the milliseconds and launches of each kind: the TP kernels, matrix products,
fills, adds, products of elements, copies, index and scatter kernels,
reductions, the rest.

    python -m hamgnn_tpu_torch.tools_dev.profile_summary <report dir>/profile_rep_*.txt
"""

from __future__ import annotations

import argparse
import re
from typing import Dict, Iterable, Tuple

# (kind, substrings of a kernel name), the first match wins
KINDS = (
    ("tp_kernels", ("packed_tp_", "zonal_tp_")),
    ("products", ("gemm", "cutlass::Kernel2", "splitKreduce")),
    ("fills", ("FillFunctor",)),
    ("adds", ("CUDAFunctor_add",)),
    ("muls", ("MulFunctor",)),
    ("copies", ("copy", "Memcpy", "CatArray")),
    ("index_scatter", ("index", "scatter", "gather")),
    ("reductions", ("reduce_kernel",)),
)
_ROW = re.compile(r"\s*([\d.]+) ms\s+(\d+) launches\s+(.*)")


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def summarize(lines: Iterable[str]) -> Dict[str, Tuple[float, int]]:
    """{kind: (ms, launches)} over the kernel rows of a profile file, with
    the total under ``"all"``."""
    out: Dict[str, Tuple[float, int]] = {}
    for line in lines:
        m = _ROW.match(line)
        if not m:
            continue
        kind = kind_of(m.group(3))
        ms, n = out.get(kind, (0.0, 0))
        out[kind] = (ms + float(m.group(1)), n + int(m.group(2)))
    out["all"] = (sum(v[0] for v in out.values()), sum(v[1] for v in out.values()))
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("files", nargs="+")
    args = parser.parse_args(argv)
    for path in args.files:
        with open(path) as f:
            summary = summarize(f)
        print(path + ": " + ", ".join(
            f"{k} {ms:.3f} ms ({n})" for k, (ms, n) in sorted(
                summary.items(), key=lambda kv: -kv[1][0])))


if __name__ == "__main__":
    main()
