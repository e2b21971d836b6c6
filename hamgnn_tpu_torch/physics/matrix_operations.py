"""Legacy matrix <-> irreps transforms, counterpart of
``hamgnn_tpu/physics/matrix_operations.py`` (the reference's
``physics/matrix_operations.py``: TensorExpansion, OverlapExpand,
TensorMerge, off its v2.1 main path but part of its public API).

``TensorExpansion``'s per-(li, lj, L) contractions are fixed linear maps,
built once on the host into one (nao^2, irreps_dim) matrix, so the
decomposition is a single matmul on whatever device the blocks live.
``TensorMerge``'s data-dependent weighted expansion keeps the reference's
instruction semantics, each instruction one einsum chain; its attribute
names are the flax names (``linear_weight_bias`` or ``weights``), so a flax
tree loads through ``interfaces/jax_params.py``.  No TPU kernel lies on this
path: it is plain PyTorch on the card.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch
from torch import nn

from ..e3.irreps import Irrep, Irreps
from ..e3.linear import Linear
from ..e3.wigner import wigner_3j
from ..models.basis import get_basis_set


@functools.lru_cache(maxsize=None)
def _expansion_spec(ham_type: str, nao_max: int):
    """(matrix (nao^2, D_sorted), sorted Irreps) for block -> irreps projection.

    The reference's TensorExpansion.forward: input blocks in DFT order are
    first reordered back to e3nn order (``_change_index_inv``), each
    (li, lj, L) sub-block is contracted with the raw e3nn wigner_3j (no
    sqrt(2L+1) scaling), and the outputs are concatenated in
    ``Irreps.sort()`` order.
    """
    basis = get_basis_set(ham_type, nao_max)
    nao = basis.nao_max

    chunks = []          # (Irrep, (nao, nao, 2L+1) projector) per output chunk
    row_start = 0
    for _, li in basis.orbital_irreps:
        di = li.dim
        col_start = 0
        for _, lj in basis.orbital_irreps:
            dj = lj.dim
            for L in range(abs(li.l - lj.l), li.l + lj.l + 1):
                cg = wigner_3j(li.l, lj.l, L)            # (di, dj, 2L+1)
                proj = np.zeros((nao, nao, 2 * L + 1))
                proj[row_start : row_start + di, col_start : col_start + dj] = cg
                chunks.append((Irrep(L, (-1) ** (li.l + lj.l)), proj))
            col_start += dj
        row_start += di

    combined = Irreps([(1, ir) for ir, _ in chunks])
    sorted_irreps, p, _inv = combined.sort()
    # sort() gives p[old] = new; emit chunks in ascending new position
    order = sorted(range(len(chunks)), key=lambda i: p[i])

    # the input-side ``_change_index_inv`` (sign flips at DFT positions, then
    # the inverse permutation back to e3nn order) folded into the projector:
    # T[i, j, m] = sign[i] sign[j] cg[index_change[i], index_change[j], m]
    sign = np.ones(nao)
    if basis.minus_index is not None:
        sign[np.asarray(basis.minus_index)] = -1.0
    perm = (np.asarray(basis.index_change)
            if basis.index_change is not None else np.arange(nao))

    cols = []
    for i in order:
        proj = chunks[i][1]
        proj = proj[perm[:, None], perm[None, :]]
        proj = proj * sign[:, None, None] * sign[None, :, None]
        cols.append(proj.reshape(nao * nao, -1))
    M = np.ascontiguousarray(np.concatenate(cols, axis=1))
    return M, sorted_irreps.simplify()


class TensorExpansion:
    """Project DFT-ordered (.., nao, nao) blocks onto irreps components:
    ``irreps_out`` is the sorted, simplified combined irreps and
    ``__call__`` one matmul."""

    def __init__(self, ham_type: str, nao_max: int):
        self.ham_type = ham_type
        self.nao_max = nao_max
        M, self.irreps_out = _expansion_spec(ham_type, nao_max)
        self._M = M

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        nao = self.nao_max
        flat = x.reshape(-1, nao * nao)
        return flat @ torch.as_tensor(self._M, dtype=flat.dtype, device=flat.device)


class OverlapExpand:
    """Attach ``Son_expand`` / ``Soff_expand`` irreps features to a graph dict."""

    def __init__(self, ham_type: str, nao_max: int):
        self.tensor_expansion = TensorExpansion(ham_type, nao_max)
        self.irreps_overlap = self.tensor_expansion.irreps_out

    def __call__(self, data: Dict) -> Dict:
        data = dict(data)
        data["Son_expand"] = self.tensor_expansion(data["Son"])
        data["Soff_expand"] = self.tensor_expansion(data["Soff"])
        return data


class TensorMerge(nn.Module):
    """Expand irreps features into (out1.dim x out2.dim) blocks with
    data-dependent path weights.

    With ``internal_weights=False`` (the reference default) an equivariant
    Linear generates per-sample scalar weights and biases; each instruction
    (i, j, k) with ``ir_in in ir_out1 * ir_out2`` contributes
    ``einsum('ijk,buvk->buivj', w3j(l1, l2, l_in), w[b] @ x[b]) / mul_in``.
    """

    def __init__(self, irreps_in, irreps_out_1, irreps_out_2,
                 internal_weights: bool = False):
        super().__init__()
        self.irreps_in = Irreps(irreps_in)
        self.out1 = Irreps(irreps_out_1)
        self.out2 = Irreps(irreps_out_2)
        self.internal_weights = internal_weights
        self.instructions = self.expansion_path(self.irreps_in, self.out1, self.out2)
        self.num_path = sum(int(np.prod(sh)) for *_ijk, sh in self.instructions)
        self.num_bias = sum(int(np.prod(sh[1:]))
                            for i, _j, _k, sh in self.instructions if i == 0)
        if internal_weights:
            # flax's uniform(1.0) init: U[0, 1)
            self.weights = nn.Parameter(torch.rand(self.num_path + self.num_bias))
        else:
            self.linear_weight_bias = Linear(
                self.irreps_in, Irreps(f"{self.num_path + self.num_bias}x0e"))
        for idx, (i, j, k, _sh) in enumerate(self.instructions):
            self.register_buffer(f"w3j{idx}", torch.as_tensor(wigner_3j(
                self.out1[j].ir.l, self.out2[k].ir.l, self.irreps_in[i].ir.l),
                dtype=torch.float32), persistent=False)

    @staticmethod
    def expansion_path(irreps_in: Irreps, out1: Irreps, out2: Irreps):
        ins = []
        for i, (mul_in, ir_in) in enumerate(irreps_in):
            for j, (mul1, ir1) in enumerate(out1):
                for k, (mul2, ir2) in enumerate(out2):
                    if ir_in in ir1 * ir2:
                        ins.append((i, j, k, (mul_in, mul1, mul2)))
        return ins

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        num_path = self.num_path
        if self.internal_weights:
            weights = self.weights[None, :num_path].expand(B, num_path)
            biases = self.weights[None, num_path:].expand(B, self.num_bias)
        else:
            wb = self.linear_weight_bias(x)
            weights, biases = wb[:, :num_path], wb[:, num_path:]

        x_chunks = [x[:, sl].reshape(B, mi.mul, mi.ir.dim)
                    for sl, mi in zip(self.irreps_in.slices(), self.irreps_in)]
        outputs = {}
        w_ofs = b_ofs = 0
        for idx, (i, j, k, (mul_in, mul1, mul2)) in enumerate(self.instructions):
            ir1, ir2 = self.out1[j].ir, self.out2[k].ir
            n_w = mul_in * mul1 * mul2
            w = weights[:, w_ofs : w_ofs + n_w].reshape(B, mul_in, mul1, mul2)
            w_ofs += n_w
            mixed = torch.einsum("bwuv,bwk->buvk", w, x_chunks[i])
            if i == 0 and not self.internal_weights:
                n_b = mul1 * mul2
                bias = biases[:, b_ofs : b_ofs + n_b].reshape(B, mul1, mul2)
                b_ofs += n_b
                mixed = mixed + bias[..., None]
            w3j = getattr(self, f"w3j{idx}").to(x.dtype)
            res = torch.einsum("ijk,buvk->buivj", w3j, mixed) / mul_in
            res = res.reshape(B, mul1 * ir1.dim, mul2 * ir2.dim)
            outputs[(j, k)] = res if (j, k) not in outputs else outputs[(j, k)] + res

        rows = []
        for j, m1 in enumerate(self.out1):
            blocks = [outputs.get((j, k), x.new_zeros((B, m1.dim, m2.dim)))
                      for k, m2 in enumerate(self.out2)]
            rows.append(torch.cat(blocks, dim=-1))
        return torch.cat(rows, dim=-2).reshape(B, -1)
