"""Hopper throughput probes of the primitives of the TP mid stage.

Counterpart of ``tools_dev/vpu_probe.py``: its timed Pallas kernels (``p1``,
``p3``, ``p4``, ``p4b``, ``p4c``, ``p5``, ``p6``, ``p7``) as ``__global__``
functions of ``csrc/probe_throughput.cu`` at the same sizes (E = 19,968
edges, S = 25, D1 = 5, MUL = 24, K = 40, so 960 columns per chunk and a slab
of 4,800; the Wcat-stage product (E,2048) @ (2048,64)), each held against
its plain PyTorch version (``plain_<name>`` below) and timed alone:

    python -m hamgnn_tpu_torch.tools_dev.throughput_probe [--device cpu] [--edges E]

  p1: D1 x (sh @ Crep_i, x_i tiled K times, multiply, add)
  p3: the same function as one wide product, one multiply, a tree sum
  p4 / p4b: 8 multiply sweeps over the slab in fp32 / bf16
  p4c: 8 sweeps acc + a * b (FFMA)
  p4c_ns256: the same with 256 sweeps, where the arithmetic and no longer the
      bytes bounds it: the card's FFMA rate (the original has 8 sweeps only)
  p5: the tiling of x alone
  p6: sh @ Crep alone
  p7 / p7_tf32: the Wcat-stage product in fp32 FFMA / on the tensor cores
      with tf32 operands and fp32 accumulation

``p1``, ``p3``, ``p6`` and ``p7_tf32`` run persistent blocks that each keep
their share of the work (``p1``/``p3``/``p6`` a 3xTF32-split panel of Crep
over edge tiles, ``p1`` and ``p3`` one kernel template in two summing
orders, ``p7_tf32`` an even share of the rows streamed through a ring of
bulk copies); ``p7`` splits its tiles' depth evenly over its blocks and adds
the parts in a second kernel.

Per probe it prints the time (median of 8 after 2 warm-up runs, CUDA events
on the card), the achieved rate, the bound max(FLOPs / peak, bytes / 3.35
TB/s) on an H100 (peak: 67 TFLOP/s fp32 outside the tensor cores, also taken
for the bf16 sweeps, which no tensor core runs; 495 TFLOP/s for tf32), the
plain version's time and, where one PyTorch call computes the same function,
that call's (for ``p7_tf32`` ``torch.matmul`` with TF32 allowed for that call
alone, so that it is cuBLAS's TF32 product).  A probe that disagrees with its plain version prints ``FAIL``
and the run exits non-zero.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from typing import Optional

import torch

from .. import resolve_device
from .probe import (BENCH_ROWS, H100_TF32_FLOPS, Probe, describe_device, measure,
                    run_checks, words)

E = BENCH_ROWS
S, D1, MUL, K = 25, 5, 24, 40
KM = K * MUL
W = D1 * KM
NS = 8
NS_DEEP = 256
FAN, V = 2048, 64
_SRC = "tools_dev/vpu_probe.py"
# p1, p3, p6, p7 and p7_tf32 are also checked at 17 tiles of 64 rows, a
# count that no split of their work divides evenly
ODD_TILES = 17 * 64


def _tiled(x, i):
    return x[:, i * MUL : (i + 1) * MUL].repeat(1, K)


def plain_p1(x, sh, crep):
    mid = None
    for i in range(D1):
        term = (sh @ crep[:, i * KM : (i + 1) * KM]) * _tiled(x, i)
        mid = term if mid is None else mid + term
    return mid


def plain_p3(x, sh, crep):
    """One wide product and multiply, then the halving tree over the D1
    column blocks: ((b0 + b2) + (b1 + b3)) + b4 at D1 = 5."""
    prod = (sh @ crep) * torch.cat([_tiled(x, i) for i in range(D1)], dim=1)
    n = D1
    while n > 1:
        h = n // 2
        head = prod[:, : h * KM] + prod[:, h * KM : 2 * h * KM]
        prod = head if n % 2 == 0 else torch.cat([head, prod[:, 2 * h * KM :]], dim=1)
        n -= h
    return prod[:, :KM]


def plain_p4(a, b):
    """NS multiply sweeps, in the inputs' type (fp32, or bf16 for p4b)."""
    acc = a
    for _ in range(NS):
        acc = acc * b
    return acc


def plain_p4c(a, b, ns=NS):
    acc = a
    for _ in range(ns):
        acc = acc + a * b
    return acc


def plain_p4c_ns256(a, b):
    return plain_p4c(a, b, NS_DEEP)


def plain_p5(x):
    return torch.cat([_tiled(x, i) for i in range(D1)], dim=1)


def plain_p6(sh, crep):
    return sh @ crep


def plain_p7(a, b):
    return a @ b


def _lib_p13(x, sh, crep):
    """p1 and p3 as one call: sum over i of (sh @ Crep_i) * (x_i tiled)."""
    return torch.einsum("es,sikm,eim->ekm", sh, crep.view(S, D1, K, MUL),
                        x.view(-1, D1, MUL)).reshape(-1, KM)


# p7's split (csrc/probe_throughput.cu): tiles of P7_BM rows, each cut into
# chunks of depth P7_KC; the chunks of all tiles, tile-major, go in equal
# contiguous runs to at most P7_BLOCKS blocks, and a run's part of a tile
# keeps its partial sums in scratch slot block + tile
P7_BM, P7_KC, P7_BLOCKS = 128, 32, 396


def p7_scratch(rows):
    """Scratch of p7: a P7_BM x V slot of partial sums per block and tile.
    It must hold what the library counts (``p7_scratch_of_library``), or the
    kernel writes past its end: the card test and ``chip_smoke.py`` hold
    the two together."""
    return ((P7_BLOCKS + -(-rows // P7_BM)) * P7_BM * V,)


def p7_scratch_of_library(rows):
    """Floats of p7's scratch as ``csrc/probe_throughput.cu`` counts them
    (``probe_p7_scratch_floats``, from its own constants); builds the
    library, so it needs nvcc."""
    fn = PROBES["p7"].kernel.library().probe_p7_scratch_floats
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_longlong
    return int(fn(rows))


def _lib_p7_tf32(a, b):
    """p7_tf32's yardstick: ``torch.matmul`` with TF32 operands allowed for
    this call alone (``fp32_precision``, or ``allow_tf32`` on an older
    PyTorch), the setting put back as it was, also when the product raises:
    the process keeps full fp32 products everywhere else."""
    m = torch.backends.cuda.matmul
    name, value = ("fp32_precision", "tf32") if hasattr(m, "fp32_precision") \
        else ("allow_tf32", True)
    prev = getattr(m, name)
    setattr(m, name, value)
    try:
        return torch.matmul(a, b)
    finally:
        setattr(m, name, prev)


def _lib_p4c(a, b, ns=NS):
    acc = a
    for _ in range(ns):
        acc = torch.addcmul(acc, a, b)
    return acc


def _p13_work(n):
    # dots, multiplies, adds; x, sh, Crep read once, the chunk written once
    return (n * (2 * S * KM * D1 + KM * D1 + KM * (D1 - 1)),
            4 * words((n, D1 * MUL), (n, S), (S, W), (n, KM)))


def _probe(name, line, what, shapes, out_cols, plain, work, **kw):
    return Probe(name=name, source="probe_throughput", replaces=f"{_SRC}:{line}",
                 what=what, rows=E, shapes=shapes,
                 out_shape=lambda n: (n, out_cols), plain=plain, work=work, **kw)


_x_sh_crep = lambda n: [(n, D1 * MUL), (n, S), (S, W)]  # noqa: E731
_slabs = lambda n: [(n, W), (n, W)]  # noqa: E731
_p7_shapes = lambda n: [(n, FAN), (FAN, V)]  # noqa: E731
_p7_bytes = lambda n: 4 * words((n, FAN), (FAN, V), (n, V))  # noqa: E731

PROBES = {p.name: p for p in [
    _probe("p1", 73, "per i: dot + tile + multiply + add", _x_sh_crep, KM, plain_p1,
           _p13_work, library=_lib_p13, row_quantum=64, odd_rows=ODD_TILES),
    _probe("p3", 104, "one wide dot + multiply + tree sum", _x_sh_crep, KM, plain_p3,
           _p13_work, library=_lib_p13, row_quantum=64, odd_rows=ODD_TILES),
    _probe("p4", 136, f"fp32 multiply x{NS} sweeps of the slab", _slabs, W, plain_p4,
           lambda n: (NS * n * W, 4 * 3 * n * W), library=plain_p4),
    # tolerance: bf16 keeps 8 bits; the kernel and the plain version round
    # after every multiply alike, so they agree far inside it
    _probe("p4b", 136, f"bf16 multiply x{NS} sweeps of the slab", _slabs, W, plain_p4,
           lambda n: (NS * n * W, 2 * 3 * n * W), library=plain_p4,
           dtype=torch.bfloat16, tol=2e-2),
    _probe("p4c", 176, f"fp32 a + a*b x{NS} sweeps (FFMA)", _slabs, W, plain_p4c,
           lambda n: (2 * NS * n * W, 4 * 3 * n * W), library=_lib_p4c),
    _probe("p4c_ns256", 176, f"fp32 a + a*b x{NS_DEEP} sweeps: the FFMA rate", _slabs, W,
           plain_p4c_ns256, lambda n: (2 * NS_DEEP * n * W, 4 * 3 * n * W),
           library=lambda a, b: _lib_p4c(a, b, NS_DEEP)),
    _probe("p5", 196, "x tiled K times per D1 block", lambda n: [(n, D1 * MUL)], W,
           plain_p5, lambda n: (0, 4 * words((n, D1 * MUL), (n, W))),
           library=lambda x: x.view(-1, D1, MUL).repeat(1, 1, K).view(-1, W)),
    _probe("p6", 215, "sh @ Crep, full width", lambda n: [(n, S), (S, W)], W, plain_p6,
           lambda n: (2 * S * W * n, 4 * words((n, S), (S, W), (n, W))),
           library=torch.matmul, row_quantum=64, odd_rows=ODD_TILES),
    _probe("p7", 238, "(E,2048) @ (2048,64), fp32 FFMA", _p7_shapes, V, plain_p7,
           lambda n: (2 * FAN * V * n, _p7_bytes(n)), library=torch.matmul,
           row_quantum=64, scratch=p7_scratch, odd_rows=ODD_TILES),
    # tolerance: tf32 operands keep 11 bits (relative rounding 2^-11 = 4.9e-4
    # per product); over a depth of 2048 the error stays near 2e-4 of
    # max|ref|, and 2e-3 leaves a margin of ten
    _probe("p7_tf32", 238, "(E,2048) @ (2048,64), tensor cores, tf32 operands",
           _p7_shapes, V, plain_p7, lambda n: (2 * FAN * V * n, _p7_bytes(n)),
           library=_lib_p7_tf32, row_quantum=64, tol=2e-3, peak_flops=H100_TF32_FLOPS,
           odd_rows=ODD_TILES),
]}


def rate_line(probe: Probe, rows: int, ms: float) -> Optional[str]:
    """The achieved rate as the original printed it, where it printed one."""
    vol = rows * W * (NS_DEEP if probe.name == "p4c_ns256" else NS)
    if probe.name in ("p4", "p4b"):
        kind = "bf16" if probe.name == "p4b" else "fp32"
        return f"{vol / (ms * 1e-3) / 1e12:.2f} T lane-ops/s {kind}"
    if probe.name in ("p4c", "p4c_ns256"):
        return f"{2 * vol / (ms * 1e-3) / 1e12:.2f} T flop-ops/s if 2ops"
    return None


def main(argv: Optional[list] = None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--edges", type=int, default=E,
                        help="E, a multiple of 64 on the card (default %(default)s)")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    # on the CPU one run is enough: its time says nothing of the card
    on_card = dev.type == "cuda"
    n, warmup = (8, 2) if on_card else (1, 0)
    print(f"throughput_probe: {len(PROBES)} probes at E={args.edges} on "
          f"{describe_device(dev)}; times are medians of {n} after {warmup} warm-up runs")
    rows = []
    for probe, tensors, row in run_checks(list(PROBES.values()), dev, args.seed, args.edges):
        del row["out"]
        if row["ok"]:
            row.update(measure(probe, tensors, n=n, warmup=warmup))
            flops, nbytes, ms = row["flops"], row["bytes"], row["ms"]
            if not on_card:
                print(f"   {ms:8.4f} ms on the host clock (plain version; no device rate)")
            else:
                lib = "none" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms"
                print(f"   {ms:8.4f} ms = {flops / (ms * 1e-3) / 1e12:.3f} TFLOP/s, "
                      f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s; bound {row['bound_ms']:.4f} "
                      f"ms ({row['bound_by']}); plain {row['plain_ms']:.4f} ms; library "
                      f"{lib}", flush=True)
                rate = rate_line(probe, args.edges, ms)
                if rate:
                    print(f"   -> {rate}")
        rows.append(row)
        del tensors
    failed = [r["name"] for r in rows if not r["ok"]]
    if failed:
        print(f"throughput_probe: FAILED: {', '.join(failed)}", file=sys.stderr)
        raise SystemExit(1)
    return rows


if __name__ == "__main__":
    main()
