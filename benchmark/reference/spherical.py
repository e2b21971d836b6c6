# Frozen copy of hamgnn_tpu_torch/e3/spherical.py, with its imports rewritten.
"""Real spherical harmonics (e3nn convention), counterpart of
``hamgnn_tpu/e3/spherical.py``.

Cartesian vectors are reindexed to (y, z, x) and Y_l follows the CG recursion
Y_l = c_l * w3j(l-1, 1, l) . (Y_{l-1} x Y_1) with component normalisation
(|Y_l|^2 = 2l+1 on the unit sphere), m ordered -l..l.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from .constants import device_constant
from .wigner import wigner_3j


@functools.lru_cache(maxsize=None)
def _recursion_constants(lmax: int):
    """Per-l (w3j tensor, scale) so that |Y_l|^2 = 2l+1 exactly."""
    consts = []
    v = np.array([0.2672612419124244, 0.5345224838248488, 0.8017837257372732])
    q = v[[1, 2, 0]]
    y_prev = np.sqrt(3.0) * q
    for l in range(2, lmax + 1):
        C = wigner_3j(l - 1, 1, l)
        y_raw = np.einsum("i,j,ijk->k", y_prev, np.sqrt(3.0) * q, C)
        scale = float(np.sqrt((2 * l + 1) / np.dot(y_raw, y_raw)))
        consts.append((C, scale))
        y_prev = y_raw * scale
    return consts


def spherical_harmonics(ls: Sequence[int], vectors: torch.Tensor,
                        normalize: bool = True, eps: float = 1e-12):
    """Real SH for each l in ``ls`` of Cartesian vectors (..., 3) ->
    (..., sum(2l+1)), concatenated in the order of ``ls``."""
    lmax = max(ls) if ls else 0
    v = vectors
    if normalize:
        n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
        v = v / torch.clamp(n, min=eps)
    q = torch.cat([v[..., 1:], v[..., :1]], dim=-1)  # (y, z, x)
    ys = {0: torch.ones(v.shape[:-1] + (1,), dtype=v.dtype, device=v.device)}
    if lmax >= 1:
        y1 = np.sqrt(3.0) * q
        ys[1] = y1
        y_prev = y1
        for l in range(2, lmax + 1):
            C, scale = _recursion_constants(lmax)[l - 2]
            Ct = device_constant(("sh_recursion", lmax, l), lambda: scale * C, v.dtype,
                                 v.device)
            y_prev = torch.einsum("...i,...j,ijk->...k", y_prev, y1, Ct)
            ys[l] = y_prev
    return torch.cat([ys[l] for l in ls], dim=-1)
