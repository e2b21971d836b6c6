"""Static tables of the spherical-harmonic tensor-product expansion.

Counterpart of ``hamgnn_tpu/e3/fused_tp.py``: the coupling tensor of one
input chunk with the edge SH, and the mid irreps the expansion produces.  The
port runs the expansion only through the packed pipeline (``packed_tp.py``),
so only these tables are needed here.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np

from .irreps import Irrep, Irreps, MulIrrep
from .wigner import wigner_3j


@functools.lru_cache(maxsize=None)
def _coupling_tensor(l1: int, p1: int, sh_key: Tuple[Tuple[int, int], ...],
                     target_key: Tuple[Tuple[int, int], ...]):
    """Constant C[j, i, k] coupling SH components j to output columns k.

    i is the m1 index (2l1+1); k runs over the concatenated output columns,
    one (2l3+1)-block per allowed (l2, l3) path, with component normalisation
    sqrt(2l3+1).  Returns (C, groups) with groups of (ir3, n_cols, k0, k1).
    """
    sh_irreps = [Irrep(l, p) for l, p in sh_key]
    target_set = set(Irrep(l, p) for l, p in target_key)

    S = sum(ir.dim for ir in sh_irreps)
    cols: List[Tuple[int, Irrep, int]] = []  # (sh offset j0, ir3, l2)
    j0 = 0
    for ir_sh in sh_irreps:
        for ir3 in Irrep(l1, p1) * ir_sh:
            if ir3 in target_set:
                cols.append((j0, ir3, ir_sh.l))
        j0 += ir_sh.dim
    cols.sort(key=lambda t: t[1])

    d1 = 2 * l1 + 1
    K = sum(ir3.dim for _, ir3, _ in cols)
    C = np.zeros((S, d1, K))
    k0 = 0
    groups: List[Tuple[Irrep, int, int, int]] = []
    for j0, ir3, l2 in cols:
        w = wigner_3j(l1, l2, ir3.l) * np.sqrt(ir3.dim)  # (d1, 2l2+1, d3)
        C[j0 : j0 + 2 * l2 + 1, :, k0 : k0 + ir3.dim] = np.transpose(w, (1, 0, 2))
        if groups and groups[-1][0] == ir3:
            ir_, n_, s_, _ = groups[-1]
            groups[-1] = (ir_, n_ + 1, s_, k0 + ir3.dim)
        else:
            groups.append((ir3, 1, k0, k0 + ir3.dim))
        k0 += ir3.dim
    return np.ascontiguousarray(C), tuple(groups)


def mid_irreps(irreps_in, irreps_sh, target_irreps) -> Irreps:
    """Irreps of the unweighted expansion of ``irreps_in`` with the SH: per
    input chunk (mul, l1), a (mul * n_cols, l3) chunk per output group.
    (``SHTensorProductExpansion.mid_irreps`` in the reference.)"""
    irreps_in = Irreps(irreps_in)
    sh_key = tuple((mi.ir.l, mi.ir.p) for mi in Irreps(irreps_sh))
    t_key = tuple((mi.ir.l, mi.ir.p) for mi in Irreps(target_irreps))
    out = []
    for mul, ir1 in irreps_in:
        _, groups = _coupling_tensor(ir1.l, ir1.p, sh_key, t_key)
        for ir3, n_cols, _, _ in groups:
            out.append(MulIrrep(mul * n_cols, ir3))
    return Irreps(out)
