"""Hopper probes of the ops the fused TP kernel is built from.

Counterpart of ``tools_dev/mosaic_probe.py``: its ten Pallas closures
(``k_repeat`` ... ``k_slice_dot``; TE=128, K=16, MUL=64) as ``__global__``
functions of ``csrc/probe_ops.cu``, each held against its plain PyTorch
version (``plain_<name>`` below) at 128 rows, at the bench rows (19,968) and
at 1,001:

    python -m hamgnn_tpu_torch.tools_dev.op_probe [--device cpu] [--seed N]

prints ``name: OK shape max|d|`` per probe, or ``FAIL`` and exits non-zero.
The original asked which reshapes and repeats Mosaic lowers, and with which
semantics (its ``pltpu.repeat`` is a tile; the (TE,16,64) -> (TE,1024) merge
did not lower).  On a GPU all of them are index arithmetic on a row-major
tile and every one runs; ``k_repeat`` keeps the tile semantics.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .probe import main_checks, rowwise

TE, K, MUL, NV = 128, 16, 64, 24
KM = K * MUL
_SRC = "tools_dev/mosaic_probe.py"


def plain_k_repeat(a):
    """(TE,K) -> (TE,4K): the block a tiled four times (a|a|a|a)."""
    return a.repeat(1, 4)


def plain_k_squeeze(x):
    return x.reshape(-1, K, MUL)[:, 3:4, :].reshape(-1, MUL)


def plain_k_merge128(x):
    return (x.reshape(-1, 8, 128) + 1.0).reshape(-1, 8 * 128)


def plain_k_merge64(x):
    return (x.reshape(-1, K, MUL) + 1.0).reshape(-1, KM)


def plain_k_outer(a, b):
    return (a[:, :, None] * b[:, None, :]).sum(dim=1)


def plain_k_lred(x):
    return x.reshape(-1, K, MUL).sum(dim=2)


def plain_k_atadd(x):
    v = torch.zeros((x.shape[0], KM), dtype=x.dtype, device=x.device)
    v[:, 64 : 64 + 128] += x[:, :128]
    return v


def plain_k_gather(x):
    return x[:, torch.arange(0, KM, K, device=x.device)]


def plain_k_dot(a, w):
    return a @ w


def plain_k_slice_dot(x, w):
    blk = x.reshape(-1, K, MUL)[:, 2:4, :]
    return (blk[:, 0, :] + blk[:, 1, :]) @ w


def _rowwise(name, line, *args, **kw):
    return rowwise(name, f"{_SRC}:{line}", *args, **kw)


PROBES = {p.name: p for p in [
    _rowwise("k_repeat", 37, "tile x4 along the columns, (TE,K) -> (TE,4K)",
             [(None, K)], 4 * K, plain_k_repeat, 0, library=lambda a: a.repeat(1, 4)),
    _rowwise("k_squeeze", 48, "view (TE,K,MUL), middle index 3 -> (TE,MUL)",
             [(None, KM)], MUL, plain_k_squeeze, 0, reads=[range(3 * MUL, 4 * MUL)],
             library=lambda x: x[:, 3 * MUL : 4 * MUL].contiguous()),
    _rowwise("k_merge128", 56, "view (TE,8,128), +1, merge -> (TE,1024)",
             [(None, 1024)], 1024, plain_k_merge128, 1024, library=lambda x: x + 1.0),
    _rowwise("k_merge64", 64, "view (TE,16,64), +1, merge -> (TE,1024)",
             [(None, KM)], KM, plain_k_merge64, KM, library=lambda x: x + 1.0),
    _rowwise("k_outer", 71, "outer (TE,K,1)x(TE,1,MUL), sum over K",
             [(None, K), (None, MUL)], MUL, plain_k_outer, 2 * K * MUL,
             library=lambda a, b: torch.einsum("ek,em->em", a, b)),
    _rowwise("k_lred", 79, "view (TE,K,MUL), sum over MUL -> (TE,K)",
             [(None, KM)], K, plain_k_lred, KM,
             library=lambda x: torch.sum(x.view(-1, K, MUL), dim=2)),
    _rowwise("k_atadd", 86, "zeros, add x[:, :128] into columns 64..191",
             [(None, KM)], KM, plain_k_atadd, 128, reads=[range(128)],
             library=lambda x: F.pad(x[:, :128], (64, KM - 64 - 128))),
    _rowwise("k_gather", 94, "columns 0, K, 2K, ... -> (TE,MUL)",
             [(None, KM)], MUL, plain_k_gather, 0, reads=[range(0, KM, K)],
             library=lambda x: x[:, ::K].contiguous()),
    _rowwise("k_dot", 101, "(TE,MUL) @ (MUL,24)",
             [(None, MUL), (MUL, NV)], NV, plain_k_dot, 2 * MUL * NV,
             library=torch.matmul),
    _rowwise("k_slice_dot", 110, "view (TE,K,MUL), middle 2 + 3, @ (MUL,24)",
             [(None, KM), (MUL, NV)], NV, plain_k_slice_dot, MUL + 2 * MUL * NV,
             reads=[range(2 * MUL, 4 * MUL), None],
             library=lambda x, w: torch.einsum("rkm,mn->rn", x.view(-1, K, MUL)[:, 2:4], w)),
]}


def main(argv: Optional[list] = None) -> list:
    return main_checks(argv, PROBES, "op_probe", __doc__)


if __name__ == "__main__":
    main()
