"""MACE-style symmetric contraction (many-body product basis), counterpart of
``hamgnn_tpu/nn/symmetric_contraction.py``.

The generalised real coupling tensors ("U matrices") are built on the host
with numpy from the port's ``e3.wigner.wigner_3j``, once per process, and
kept by each ``Contraction`` as a buffer in the layout its product reads.

Feature layout: x is (batch, channels, n_ell), n_ell the sum of (2l+1) over
the coupling irreps (every chunk has the same channel count); y is the
element embedding (batch, num_elements), a one-hot only without charge
doping, so it enters as a product and never as an index.

Contraction order.  The main term is
out[b, c, F] = sum_{i,k} U[F, i, k] W[b, k, c] x[b, c, i] with W = y @ w.
It is computed as P[b, c, (k, i)] = W[b, k, c] x[b, c, i], then one product
P @ U[(k, i), F]: the largest tensor is P, (batch, channels, paths, n_ell),
and no (batch, channels, F, paths) or (batch, channels, F, n_ell) tensor is
formed.  torch contracts a many-operand einsum left to right, which here
would build a (batch, channels, F, n_ell, paths) tensor.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch
from torch import nn

from ..e3.irreps import Irrep, Irreps
from ..e3.wigner import wigner_3j


def _wigner_nj(irreps_list: List[Irreps]) -> List[Tuple[Irrep, np.ndarray]]:
    """All coupling paths of n copies of ``irreps`` -> (ir_out, basis tensor)
    of shape (ir_out.dim, dim, ..., dim) with n trailing input dims;
    'component' normalisation (each CG carries sqrt(ir_out.dim))."""
    if len(irreps_list) == 1:
        (irreps,) = irreps_list
        ret = []
        e = np.eye(irreps.dim)
        i = 0
        for mul, ir in irreps:
            for _ in range(mul):
                ret.append((ir, e[i: i + ir.dim]))
                i += ir.dim
        return ret

    *left_list, irreps_right = irreps_list
    ret = []
    for ir_left, C_left in _wigner_nj(left_list):
        i = 0
        for mul, ir in irreps_right:
            for ir_out in ir_left * ir:
                C = wigner_3j(ir_out.l, ir_left.l, ir.l) * np.sqrt(ir_out.dim)
                Cc = np.einsum(
                    "jk,ijl->ikl", C_left.reshape(C_left.shape[0], -1), C
                ).reshape(ir_out.dim, *(irr.dim for irr in left_list), ir.dim)
                for u in range(mul):
                    E = np.zeros(
                        (ir_out.dim, *(irr.dim for irr in left_list), irreps_right.dim))
                    E[..., i + u * ir.dim: i + (u + 1) * ir.dim] = Cc
                    ret.append((ir_out, E))
            i += mul * ir.dim
    return sorted(ret, key=lambda t: t[0])


@functools.lru_cache(maxsize=None)
def u_matrix_real(irreps_in: str, ir_out: str, correlation: int) -> np.ndarray:
    """Stack of invariant coupling tensors, shape
    ([2l_out+1 if l_out > 0], n_ell, ..., n_ell, num_paths)."""
    irreps_in_ = Irreps(irreps_in)
    ir_out_ = Irrep.parse(ir_out)
    stack = [E for (ir, E) in _wigner_nj([irreps_in_] * correlation) if ir == ir_out_]
    if not stack:
        n_ell = irreps_in_.dim
        shape = ([2 * ir_out_.l + 1] if ir_out_.l > 0 else []) + [n_ell] * correlation + [0]
        return np.zeros(shape)
    U = np.stack(stack, axis=-1)
    if ir_out_.l == 0:
        U = U[0]  # the trivial output dim squeezed, as MACE's .squeeze()
    return U


class Contraction(nn.Module):
    """The contraction chain of one output irrep.  ``w<nu>`` is
    (num_elements, paths, channels), N(0, 1), divided by max(paths, 1) at
    apply time; the lower orders without a path have none."""

    def __init__(self, coupling_irreps: str, ir_out: str, correlation: int,
                 num_features: int, num_elements: int):
        super().__init__()
        self.correlation = correlation
        self.num_features = num_features
        self.free = {}   # nu -> the U tensor's dims before its path dim
        self.paths = {}
        for nu in range(1, correlation + 1):
            U = u_matrix_real(coupling_irreps, ir_out, nu)
            self.free[nu], self.paths[nu] = U.shape[:-1], U.shape[-1]
            k, free = U.shape[-1], self.free[nu]
            if nu == correlation:
                # (k, i) rows, the free dims F before i as columns: the main product
                pf = int(np.prod(free[:-1]))
                U = np.moveaxis(U, -1, 0).reshape(k, pf, free[-1])
                U = U.transpose(0, 2, 1).reshape(k * free[-1], pf)
            else:
                U = np.moveaxis(U, -1, 0).reshape(k, int(np.prod(free)))
            self.register_buffer(f"U{nu}", torch.as_tensor(U, dtype=torch.float32),
                                 persistent=False)
            if nu == correlation or self.paths[nu] > 0:
                self.register_parameter(f"w{nu}", nn.Parameter(
                    torch.zeros(num_elements, self.paths[nu], num_features)))

    def _weights(self, nu, y):
        """(batch, channels, paths): y @ w<nu> / max(paths, 1)."""
        w = getattr(self, f"w{nu}")
        k = self.paths[nu]
        W = (y @ w.reshape(w.shape[0], -1)).reshape(y.shape[0], k, self.num_features)
        return W.transpose(1, 2) / max(k, 1)

    def forward(self, x, y):
        b, c, n = x.shape
        nu = self.correlation
        k = self.paths[nu]
        P = self._weights(nu, y)[..., None] * x[:, :, None, :]        # (b, c, k, n)
        out = (P.reshape(b * c, k * n) @ getattr(self, f"U{nu}")).reshape(
            b, c, *self.free[nu][:-1])
        for nu in range(self.correlation - 1, 0, -1):
            if self.paths[nu] == 0:
                c_tensor = out
            else:
                c_tensor = (self._weights(nu, y) @ getattr(self, f"U{nu}")).reshape(
                    b, c, *self.free[nu]) + out
            free = c_tensor.shape[2:-1]
            out = (c_tensor.reshape(b, c, -1, n) @ x[..., None]).reshape(b, c, *free)
        return out.reshape(b, -1)


class SymmetricContraction(nn.Module):
    """Per output irrep a ``contraction_<ir>``; the outputs (batch,
    channels * dim) concatenated in the order of ``irreps_out``."""

    def __init__(self, coupling_irreps: str, irreps_out: str, correlation: int,
                 num_features: int, num_elements: int):
        super().__init__()
        self._names = []
        for _mul, ir in Irreps(irreps_out):
            name = f"contraction_{ir}"
            self.add_module(name, Contraction(coupling_irreps, repr(ir), correlation,
                                              num_features, num_elements))
            self._names.append(name)

    def forward(self, x, y):
        return torch.cat([getattr(self, name)(x, y) for name in self._names], dim=-1)
