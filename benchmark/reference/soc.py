"""Spin-orbit-coupling output head: a frozen copy of
``hamgnn_tpu_torch/models/soc.py`` without the band branch.

Per atom and edge the head predicts a (2 nao, 2 nao) complex spinor block as
its real and imaginary parts, (rows, (2 nao)^2) each, spin-major:
``[[uu, ud], [du, dd]]`` of nao x nao orbital blocks in DFT order.

* ``su2``: the head emits each orbital pair's spin-0 and spin-1 irreps
  (re || im); the fixed complex-linear map to the four spin blocks
  (Wigner-3j contractions, the ``(scalar, y, z, x) -> (uu, ud, du, dd)``
  transform, the DFT reorder) is one host table ``su2_codec_matrix``.  The
  forward applies it as one real product of ``[re, im]`` with
  ``[[Re M, Im M], [-Im M, Re M]]``, which is the complex product ``z @ M``.
* ``so3``: a spatial Hamiltonian (the non-SOC merge matrix, or the rows of
  an upstream non-SOC model with ``add_H_nonsoc``) on the spin diagonal, and
  per-orbital-block ksi couplings times the graph's angular-momentum
  matrices ``Lon`` / ``Loff`` in the spin-coupling entries.

The head is written against a ``GraphView``: Hermitian symmetrisation goes
through the inverse edge (``view.inv_exchange``, an exchange under the halo
partition), the zero-point shift and the sparsity ratio sum through
``view.psum``, and the spinor bands run on the rows
``view.gather_*_global`` reassemble when the view carries the whole crystal;
then orbital masks, H0 (its spin-diagonal blocks zeroed with
``add_H_nonsoc``), the zero-point shift on the spin-diagonal real blocks, the
sparsity ratio and, with ``calculate_band_energy`` and k-points, the spinor
bands (``physics.band.band_energies_soc_batched``) of the prediction and of
the graph's reference Hamiltonian.  The submodules keep the flax names
(``onsite_hamiltonian``, ``offsite_hamiltonian``, ``onsite_ksi``,
``offsite_ksi``), so ``interfaces.jax_params.load_flax_params`` fills them
from a JAX SOC tree by name.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .graph import Graph
from .irreps import Irreps
from .wigner import wigner_3j
from .basis import BasisSetInfo, get_basis_set, hamiltonian_irreps
from .output import HamLayer, _merge_reorder_matrix
from .view import as_view

_SQRT2 = 1.4142135623730951

# (scalar, y, z, x)-coupled spin channel -> (uu, ud, du, dd)
_OYZX2SPIN = np.array(
    [[1, 0, 1, 0],
     [0, -1j, 0, 1],
     [0, 1j, 0, 1],
     [1, 0, -1, 0]], dtype=np.complex128) / _SQRT2


def su2_base_irreps(basis: BasisSetInfo) -> Irreps:
    """Irreps of the su2 head's output (one of re, im): per (l1, l2) orbital
    pair, the spin-0 part of every L, then the spin-1-coupled parts per L."""
    out = Irreps()
    for _, li in basis.orbital_irreps:
        for _, lj in basis.orbital_irreps:
            p = (-1) ** (li.l + lj.l)
            Ls = list(range(abs(li.l - lj.l), li.l + lj.l + 1))
            out = out + Irreps([(1, (L, p)) for L in Ls])
            for L in Ls:
                out = out + Irreps([(1, (Lp, p)) for Lp in range(abs(L - 1), L + 2)])
    return out


@functools.lru_cache(maxsize=None)
def su2_codec_matrix(ham_type: str, nao_max: int) -> np.ndarray:
    """(D_base, 4 nao^2) complex64: a complex irreps vector -> the flattened
    (uu, ud, du, dd) nao x nao spin blocks in DFT orbital order."""
    basis = get_basis_set(ham_type, nao_max)
    nao = basis.nao_max
    M = np.zeros((su2_base_irreps(basis).dim, 4, nao, nao), dtype=np.complex128)

    d = 0
    row_start = 0
    for _, li in basis.orbital_irreps:
        ni = li.dim
        col_start = 0
        for _, lj in basis.orbital_irreps:
            nj = lj.dim
            Ls = list(range(abs(li.l - lj.l), li.l + lj.l + 1))
            # a pair's local vector: [scalars per L | spin-1 parts per L]
            dim_scalar = sum(2 * L + 1 for L in Ls)
            dims_sp = [sum(2 * Lp + 1 for Lp in range(abs(L - 1), L + 2)) for L in Ls]
            dim_pair = dim_scalar + sum(dims_sp)
            wm = np.concatenate([wigner_3j(li.l, lj.l, L) for L in Ls], axis=-1)
            for col in range(dim_pair):
                x = np.zeros(dim_pair)
                x[col] = 1.0
                # B[(sum 2L+1), 4]: the (scalar, y, z, x) channels
                B = np.zeros((dim_scalar, 4), dtype=np.complex128)
                B[:, 0] = x[:dim_scalar]
                ofs_sp, ofs_m = dim_scalar, 0
                for L, dsp in zip(Ls, dims_sp):
                    wm_sp = np.concatenate(
                        [wigner_3j(L, 1, Lp) for Lp in range(abs(L - 1), L + 2)], axis=-1)
                    B[ofs_m : ofs_m + 2 * L + 1, 1:4] = np.einsum(
                        "jkl,l->jk", wm_sp, x[ofs_sp : ofs_sp + dsp])
                    ofs_sp += dsp
                    ofs_m += 2 * L + 1
                blk = np.einsum("mn,klm,jn->jkl", B, wm, _OYZX2SPIN)
                M[d + col, :, row_start : row_start + ni, col_start : col_start + nj] = blk
            d += dim_pair
            col_start += nj
        row_start += ni

    # the DFT reorder, the same signed permutation as the non-SOC head's
    if basis.index_change is not None:
        M = M[:, :, basis.index_change[:, None], basis.index_change[None, :]]
    if basis.minus_index is not None:
        s = np.ones(nao)
        s[basis.minus_index] = -1.0
        M = M * s[None, None, :, None] * s[None, None, None, :]
    return np.ascontiguousarray(M.reshape(M.shape[0], 4 * nao * nao).astype(np.complex64))


def _orbital_blocks(basis: BasisSetInfo) -> List[Tuple[int, int]]:
    """(start, end) of each l > 0 orbital block, in the basis' orbital order."""
    out = []
    ofs = 0
    for _, ir in basis.orbital_irreps:
        if ir.l > 0:
            out.append((ofs, ofs + ir.dim))
        ofs += ir.dim
    return out


def orbital_average_matrix(basis: BasisSetInfo) -> np.ndarray:
    """(nao, nao) P with P @ m the mean of m's rows within each block of
    ``_orbital_blocks`` (other rows kept)."""
    P = np.eye(basis.nao_max)
    for s, e in _orbital_blocks(basis):
        P[s:e, s:e] = 1.0 / (e - s)
    return P


def _symmetrize_orbital_coefficients(coeffs: torch.Tensor, avg: torch.Tensor) -> torch.Tensor:
    """(n, nao^2) ksi coefficients averaged within the orbital blocks, rows
    then columns: ``avg @ m @ avg.T`` with ``avg`` the
    ``orbital_average_matrix``."""
    nao = avg.shape[0]
    m = coeffs.reshape(-1, nao, nao)
    return (avg @ m @ avg.T).reshape(-1, nao * nao)


def _spin_tile(pair: torch.Tensor) -> torch.Tensor:
    """(n, nao, nao) orbital mask -> the same mask on each of the 2 x 2 spin
    blocks, (n, 2 nao, 2 nao)."""
    return pair.repeat(1, 2, 2)


class HamGNNSOCOut(nn.Module):
    """SOC head: ``hamiltonian_real_on`` / ``hamiltonian_imag_on`` (N, (2 nao)^2),
    ``hamiltonian_real_off`` / ``hamiltonian_imag_off`` (E, (2 nao)^2),
    ``mask_on`` / ``mask_off`` and ``sparsity_ratio``; with
    ``calculate_band_energy`` and ``k_vecs`` also ``band_energy``,
    ``wavefunction``, ``band_gap`` and, from the graph's reference
    Hamiltonian without gradient, ``band_energy_ref`` / ``band_gap_ref``.
    ``h_nonsoc``: (on, off) rows of an upstream non-SOC prediction, the
    spatial part under ``add_H_nonsoc`` (so3)."""

    def __init__(self, irreps_in_node: str, irreps_in_edge: str, nao_max: int = 14,
                 ham_type: str = "openmx", soc_basis: str = "su2", add_H0: bool = True,
                 add_H_nonsoc: bool = False, symmetrize: bool = True,
                 zero_point_shift: bool = False, nonlinearity_type: str = "gate",
                 calculate_band_energy: bool = False, num_k: int = 5,
                 band_num_control: int = 8, k_path: Optional[Any] = None):
        super().__init__()
        if soc_basis not in ("su2", "so3"):
            raise NotImplementedError(f"soc_basis {soc_basis!r}: su2 or so3")
        self.basis = get_basis_set(ham_type, nao_max)
        self.nao = nao = self.basis.nao_max
        self.soc_basis = soc_basis
        self.add_H0 = add_H0
        self.add_H_nonsoc = add_H_nonsoc
        self.symmetrize = symmetrize
        self.zero_point_shift = zero_point_shift
        self.calculate_band_energy = calculate_band_energy
        self.num_k = num_k
        self.band_num_control = band_num_control
        self.k_path = k_path

        def buffer(name, arr, dtype=torch.float32):
            self.register_buffer(name, torch.as_tensor(np.asarray(arr), dtype=dtype),
                                 persistent=False)

        buffer("mask_table", self.basis.orbital_mask_table)
        buffer("n_orb", self.basis.num_orbital_table)
        buffer("spin_eye", np.eye(2))
        node_in, edge_in = Irreps(irreps_in_node), Irreps(irreps_in_edge)
        if soc_basis == "su2":
            base = su2_base_irreps(self.basis)
            M = su2_codec_matrix(ham_type.lower(), nao_max)
            buffer("codec", np.block([[M.real, M.imag], [-M.imag, M.real]]))
            for name, irreps in (("onsite_hamiltonian", node_in),
                                 ("offsite_hamiltonian", edge_in)):
                self.add_module(name, HamLayer(irreps, base + base, nonlinearity_type))
        else:
            if not add_H_nonsoc:
                buffer("merge", _merge_reorder_matrix(ham_type.lower(), nao_max))
                ham_irreps = hamiltonian_irreps(self.basis)
                for name, irreps in (("onsite_hamiltonian", node_in),
                                     ("offsite_hamiltonian", edge_in)):
                    self.add_module(name, HamLayer(irreps, ham_irreps, nonlinearity_type))
            buffer("orbital_avg", orbital_average_matrix(self.basis))
            ksi = Irreps(f"{nao * nao}x0e")
            self.onsite_ksi = HamLayer(node_in, ksi, nonlinearity_type)
            self.offsite_ksi = HamLayer(edge_in, ksi, nonlinearity_type)

    # --- su2 ------------------------------------------------------------

    def _su2(self, head: nn.Module, feats: torch.Tensor):
        """Real and imaginary (n, 2 nao, 2 nao) spinor blocks of one head."""
        nao = self.nao
        flat = head(feats) @ self.codec                  # (n, 2 * 4 nao^2): re || im

        def blocks(f):
            return f.reshape(-1, 2, 2, nao, nao).transpose(2, 3).reshape(-1, 2 * nao, 2 * nao)

        n4 = 4 * nao * nao
        return blocks(flat[:, :n4]), blocks(flat[:, n4:])

    # --- so3 ------------------------------------------------------------

    def _spatial(self, head: nn.Module, feats: torch.Tensor) -> torch.Tensor:
        return (head(feats) @ self.merge).reshape(-1, self.nao, self.nao)

    def _assemble_so3(self, h_sp, ksi, L, mate):
        """Real and imaginary spinor blocks from the spatial part ``h_sp`` and
        ksi * L; ``mate(m)`` is the block whose transpose symmetrises ``m``
        (itself on site, its inverse edge's off site): the spin-coupling
        parts are antisymmetrised, the three of them through one ``mate``."""
        nao = self.nao
        m = (ksi[:, None, :] * L.transpose(1, 2)).reshape(-1, 3, nao, nao)
        kx, ky, kz = (0.5 * (m - mate(m).transpose(-1, -2))).unbind(1)
        hr = torch.cat([torch.cat([h_sp, ky], 2), torch.cat([ky, h_sp], 2)], 1)
        hi = torch.cat([torch.cat([kz, kx], 2), torch.cat([-kx, -kz], 2)], 1)
        return hr, hi

    # --- forward --------------------------------------------------------

    def forward(self, graph: Graph, representation: Dict[str, torch.Tensor],
                k_vecs: Optional[torch.Tensor] = None,
                h_nonsoc: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        return self.forward_view(as_view(graph), representation, k_vecs=k_vecs,
                                 h_nonsoc=h_nonsoc)

    def forward_view(self, view, representation: Dict[str, torch.Tensor],
                     k_vecs: Optional[torch.Tensor] = None,
                     h_nonsoc: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        nao = self.nao
        n2 = (2 * nao) ** 2
        node_attr = representation["node_attr"]
        edge_attr = representation["edge_attr"]
        dtype = node_attr.dtype
        node_mask = view.node_mask.to(dtype)
        edge_mask = view.edge_mask.to(dtype)

        tab = self.mask_table.to(dtype)
        node_orb = tab[view.z]
        on_pair = node_orb[:, :, None] * node_orb[:, None, :] * node_mask[:, None, None]
        off_pair = (tab[view.z_src][:, :, None] * tab[view.z_dst][:, None, :]
                    * edge_mask[:, None, None])
        m_on, m_off = _spin_tile(on_pair), _spin_tile(off_pair)

        def off_mate(m):
            """The inverse edges' (n, ..., a, b) blocks, one exchange."""
            return view.inv_exchange(m.reshape(m.shape[0], -1)).reshape(m.shape)

        if self.soc_basis == "su2":
            h_on_r, h_on_i = self._su2(self.onsite_hamiltonian, node_attr)
            h_off_r, h_off_i = self._su2(self.offsite_hamiltonian, edge_attr)
            if self.symmetrize:
                # 0.5 (h + h^H): the real part symmetric, the imaginary antisymmetric
                h_on_r = 0.5 * (h_on_r + h_on_r.transpose(-1, -2))
                h_on_i = 0.5 * (h_on_i - h_on_i.transpose(-1, -2))
                inv_r, inv_i = off_mate(torch.stack([h_off_r, h_off_i], 1)).unbind(1)
                h_off_r = 0.5 * (h_off_r + inv_r.transpose(-1, -2))
                h_off_i = 0.5 * (h_off_i - inv_i.transpose(-1, -2))
            h_on_r, h_on_i = h_on_r * m_on, h_on_i * m_on
            h_off_r, h_off_i = h_off_r * m_off, h_off_i * m_off
        else:
            if self.add_H_nonsoc:
                if h_nonsoc is None:
                    raise ValueError("add_H_nonsoc needs h_nonsoc=(on, off)")
                hs_on = h_nonsoc[0].reshape(-1, nao, nao) * on_pair
                hs_off = h_nonsoc[1].reshape(-1, nao, nao) * off_pair
            else:
                hs_on = self._spatial(self.onsite_hamiltonian, node_attr)
                hs_off = self._spatial(self.offsite_hamiltonian, edge_attr)
                if self.symmetrize:
                    hs_on = 0.5 * (hs_on + hs_on.transpose(-1, -2))
                    hs_off = 0.5 * (hs_off + off_mate(hs_off).transpose(-1, -2))
                hs_on = hs_on * on_pair
                hs_off = hs_off * off_pair
            ksi_on = _symmetrize_orbital_coefficients(self.onsite_ksi(node_attr),
                                                      self.orbital_avg)
            ksi_off = _symmetrize_orbital_coefficients(self.offsite_ksi(edge_attr),
                                                       self.orbital_avg)
            h_on_r, h_on_i = self._assemble_so3(
                hs_on, ksi_on, view.Lon.reshape(-1, nao * nao, 3), lambda m: m)
            h_off_r, h_off_i = self._assemble_so3(
                hs_off, ksi_off, view.Loff.reshape(-1, nao * nao, 3), off_mate)

        h_on_r, h_on_i = h_on_r.reshape(-1, n2), h_on_i.reshape(-1, n2)
        h_off_r, h_off_i = h_off_r.reshape(-1, n2), h_off_i.reshape(-1, n2)

        if self.add_H0 and view.Hon0 is not None:
            hon0, hoff0 = view.Hon0, view.Hoff0
            if self.add_H_nonsoc:
                # the upstream prediction carries the spatial H0: keep only
                # H0's spin-coupling blocks
                off_diag = (1.0 - self.spin_eye)[None, :, None, :, None]
                hon0 = (hon0.reshape(-1, 2, nao, 2, nao) * off_diag).reshape(-1, n2)
                hoff0 = (hoff0.reshape(-1, 2, nao, 2, nao) * off_diag).reshape(-1, n2)
            h_on_r = h_on_r + hon0
            h_off_r = h_off_r + hoff0
            if view.iHon0 is not None:
                h_on_i = h_on_i + view.iHon0
                h_off_i = h_off_i + view.iHoff0

        result = {
            "hamiltonian_real_on": h_on_r,
            "hamiltonian_real_off": h_off_r,
            "hamiltonian_imag_on": h_on_i,
            "hamiltonian_imag_off": h_off_i,
            "mask_on": m_on.reshape(-1, n2) * node_mask[:, None],
            "mask_off": m_off.reshape(-1, n2) * edge_mask[:, None],
        }

        if self.zero_point_shift and view.Son is not None and view.Hon is not None:
            self._zero_point_shift(view, result, node_mask, edge_mask)

        n_i = self.n_orb[view.z] * view.node_mask.to(torch.float32)
        eff = view.psum(torch.sum(n_i * n_i) + torch.sum(
            self.n_orb[view.z_src] * self.n_orb[view.z_dst]
            * view.edge_mask.to(torch.float32)))
        total = view.psum((view.node_mask.sum() + view.edge_mask.sum()).to(torch.float32)) \
            * float(nao * nao)
        result["sparsity_ratio"] = total / torch.clamp(eff, min=1.0)

        return result

    def _zero_point_shift(self, view, result: Dict, node_mask, edge_mask) -> None:
        """One energy shift of the spin-diagonal real blocks towards the
        reference, weighted by the overlap: sum w (H - H_ref) / (2 sum w S)
        over both spin-diagonal blocks."""
        nao = self.nao
        s_on, s_off = view.Son, view.Soff
        w_on = (s_on > 1e-6).to(s_on.dtype) * node_mask[:, None]
        w_off = (s_off > 1e-6).to(s_off.dtype) * edge_mask[:, None]

        def diag_sum(h):  # uu + dd, (n, nao^2)
            hb = h.reshape(-1, 2, nao, 2, nao)
            return (hb[:, 0, :, 0, :] + hb[:, 1, :, 1, :]).reshape(-1, nao * nao)

        h_on, h_off = result["hamiltonian_real_on"], result["hamiltonian_real_off"]
        num = view.psum(torch.sum(w_on * (diag_sum(h_on) - diag_sum(view.Hon)))
                        + torch.sum(w_off * (diag_sum(h_off) - diag_sum(view.Hoff))))
        den = 2.0 * view.psum(torch.sum(w_on * s_on) + torch.sum(w_off * s_off))
        shift = num / torch.clamp(den, min=1e-12)

        def apply(h, s, w):
            corr = (shift * s * w).reshape(-1, 1, nao, 1, nao)
            hb = h.reshape(-1, 2, nao, 2, nao) - corr * self.spin_eye[None, :, None, :, None]
            return hb.reshape(h.shape)

        result["hamiltonian_real_on"] = apply(h_on, s_on, w_on)
        result["hamiltonian_real_off"] = apply(h_off, s_off, w_off)
