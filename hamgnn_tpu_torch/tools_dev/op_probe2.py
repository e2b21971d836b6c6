"""Hopper probes, round 2: the ops of the flat k-major kernel formulation.

Counterpart of ``tools_dev/mosaic_probe2.py``: its Pallas closures
(``k_tile`` ... ``k_dot_t``; TE=128, K=25, MUL=48) and the gridded ``k_acc``
((512,48) in, (64,32) out, four grid steps on one output block) as
``__global__`` functions of ``csrc/probe_ops.cu``, each held against its
plain PyTorch version (``plain_<name>`` below) at the closures' size, at the
bench rows (19,968; ``k_acc`` 156 tiles) and, row-wise, at 1,001:

    python -m hamgnn_tpu_torch.tools_dev.op_probe2 [--device cpu] [--seed N]

``k_acc`` crosses blocks: per-tile partial products and one fixed-order
reduce, so a second launch is bit-identical (checked here).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from .probe import BENCH_ROWS, Probe, main_checks, rowwise, words

TE, K, MUL, NV = 128, 25, 48, 24
KM = K * MUL
_SRC = "tools_dev/mosaic_probe2.py"


def plain_k_tile(a):
    """(TE,MUL) tiled K times along the columns."""
    return a.repeat(1, K)


def plain_k_erep(a):
    """Each element of (TE,K) repeated MUL times."""
    return a.repeat_interleave(MUL, dim=1)


def plain_k_split_sum(x):
    return x.reshape(-1, K, MUL).sum(dim=1)


def plain_k_bc_merge(a):
    return a[:, :, None].expand(-1, K, MUL).reshape(-1, KM)


def plain_k_rep_slice(a):
    return a[:, 3 : 3 + 7].repeat(1, 5)


def plain_k_concat(x):
    return torch.cat([x[:, i * MUL : (i + 1) * MUL] * float(i) for i in range(K)], dim=1)


def plain_k_dot_odd(x, w):
    return x[:, 7 : 7 + 120] @ w


def plain_k_dot_t(a, b):
    """Contraction over the rows: (TE,MUL)^T @ (TE,24) -> (MUL,24)."""
    return a.t() @ b


def plain_k_acc(a):
    """(64,32) zeros; rows 3..3+MUL, columns :24 accumulate a_t^T @ a_t[:, :24]
    over the 128-row tiles t in order."""
    out = torch.zeros((64, 32), dtype=a.dtype, device=a.device)
    for t in range(a.shape[0] // TE):
        at = a[t * TE : (t + 1) * TE]
        out[3 : 3 + MUL, :NV] += at.t() @ at[:, :NV]
    return out


@functools.lru_cache(maxsize=None)
def _block_scales(device):
    """(KM,) factors 0,..,0,1,..,1,...: block i of MUL columns holds i."""
    return torch.arange(K, dtype=torch.float32, device=device).repeat_interleave(MUL)


def _rowwise(name, line, *args, **kw):
    return rowwise(name, f"{_SRC}:{line}", *args, **kw)


PROBES = {p.name: p for p in [
    _rowwise("k_tile", 33, f"tile x{K}, (TE,{MUL}) -> (TE,{KM})",
             [(None, MUL)], KM, plain_k_tile, 0, library=lambda a: a.repeat(1, K)),
    _rowwise("k_erep", 44, f"element repeat x{MUL}, (TE,{K}) -> (TE,{KM})",
             [(None, K)], KM, plain_k_erep, 0,
             library=lambda a: a.repeat_interleave(MUL, dim=1)),
    _rowwise("k_split_sum", 55, "view (TE,K,MUL), sum over K (the dx op)",
             [(None, KM)], MUL, plain_k_split_sum, KM,
             library=lambda x: torch.sum(x.view(-1, K, MUL), dim=1)),
    _rowwise("k_bc_merge", 67, "broadcast (TE,K,1) -> (TE,K,MUL), merge",
             [(None, K)], KM, plain_k_bc_merge, 0,
             library=lambda a: a.repeat_interleave(MUL, dim=1)),
    _rowwise("k_rep_slice", 76, "columns 3..9 tiled x5 -> (TE,35)",
             [(None, K)], 35, plain_k_rep_slice, 0, reads=[range(3, 3 + 7)],
             library=lambda a: a[:, 3 : 3 + 7].repeat(1, 5)),
    _rowwise("k_concat", 83, f"{K} column blocks, block i scaled by i, side by side",
             [(None, KM)], KM, plain_k_concat, KM,
             library=lambda x: torch.mul(x, _block_scales(x.device))),
    _rowwise("k_dot_odd", 91, "(TE,120 at column 7) @ (120,24)",
             [(None, KM), (120, NV)], NV, plain_k_dot_odd, 2 * 120 * NV,
             reads=[range(7, 7 + 120), None],
             library=lambda x, w: torch.matmul(x[:, 7 : 7 + 120], w)),
    Probe(name="k_dot_t", source="probe_ops", replaces=f"{_SRC}:100",
          what="(TE,MUL)^T @ (TE,24) -> (MUL,24), the dWcat op", rows=TE,
          shapes=lambda rows: [(rows, MUL), (rows, NV)],
          out_shape=lambda rows: (MUL, NV), plain=plain_k_dot_t,
          work=lambda rows: (2 * rows * MUL * NV,
                             4 * words((rows, MUL), (rows, NV), (MUL, NV))),
          library=lambda a, b: torch.matmul(a.t(), b), row_quantum=TE, max_rows=TE),
    # the library call: the whole sum as one product, the block the tiles
    # add into
    Probe(name="k_acc", source="probe_ops", replaces=f"{_SRC}:111",
          what="out[3:51,:24] += a_t^T @ a_t[:, :24] over 4 tiles of one output block",
          rows=4 * TE, shapes=lambda rows: [(rows, MUL)],
          out_shape=lambda rows: (64, 32), plain=plain_k_acc,
          library=lambda a: a.t() @ a[:, :NV], library_part=lambda out: out[3 : 3 + MUL, :NV],
          work=lambda rows: (2 * rows * MUL * NV + (rows // TE) * MUL * NV,
                             4 * words((rows, MUL), (64, 32))),
          row_quantum=TE, scratch=lambda rows: (rows // TE, MUL * NV),
          bench_rows=BENCH_ROWS),
]}


def main(argv: Optional[list] = None) -> list:
    return main_checks(argv, PROBES, "op_probe2", __doc__)


if __name__ == "__main__":
    main()
