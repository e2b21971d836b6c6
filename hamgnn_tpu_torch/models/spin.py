"""Spin-constrained (magnetic) output head, counterpart of
``hamgnn_tpu/models/spin.py``.

The head adds Heisenberg-like S.J.S corrections to a spatial Hamiltonian:
per-orbital-pair couplings J (rank 0, or rank 2 with SOC) from two more heads,
contracted with the spins of the atoms an edge joins.  As in the JAX package,
the reference's per-edge loops factorise into segment sums: contributions
keyed by an edge's source atom are a sum over ``src`` then a gather at
``src``, those keyed by (target atom, cell shift) a sum over the graph's
``edge_group_tar`` ids then a gather.

No complex arithmetic: every term is ``sum_k U_k (x) sigma_k`` with real
(rows, nao, nao) Cartesian components ``U_k``.  sigma_x and sigma_z are real
and sigma_y is imaginary, so the real part of a term is
``U_x (x) sigma_x + U_z (x) sigma_z`` and its imaginary part
``U_y (x) Im sigma_y``.  The segment sums run on the (rows, 3, nao, nao)
components (one component, z, when collinear), and the (rows, 2, nao, 2, nao)
spin structure is built once at the end.

Branches:

* ``collinear_spin``: two real spin channels, ``hamiltonian_on`` /
  ``hamiltonian_off`` of (rows, 2, nao^2), from ``h +/- U_z``; with
  ``calculate_band_energy`` and k-points, each channel's bands against the
  spin-independent overlap;
* non-collinear (rank-0 J) and non-collinear with SOC (``soc_switch``,
  rank-2 J): ``hamiltonian_{real,imag}_{on,off}`` of (rows, (2 nao)^2).

The submodules keep the flax names (``onsite_hamiltonian``,
``offsite_hamiltonian``, ``onsite_weight``, ``offsite_weight``, ``onsite_J``,
``offsite_J``), so ``interfaces.jax_params.load_flax_params`` fills them from
a JAX magnetic tree by name.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..data.graph import Graph
from ..e3.irreps import Irreps
from ..e3.wigner import wigner_3j
from ..nn.blocks import segment_sum
from .basis import BasisSetInfo, get_basis_set, hamiltonian_irreps
from .output import HamLayer, _merge_reorder_matrix

SIGMA = np.zeros((3, 2, 2), dtype=np.complex128)
SIGMA[0] = [[0, 1], [1, 0]]
SIGMA[1] = [[0, -1j], [1j, 0]]
SIGMA[2] = [[1, 0], [0, -1]]
# the Pauli matrices' real and imaginary parts, (3, 2, 2) each
SIGMA_RE = np.ascontiguousarray(SIGMA.real)
SIGMA_IM = np.ascontiguousarray(SIGMA.imag)


def j_irreps(basis: BasisSetInfo, soc: bool) -> Irreps:
    """Irreps of the J heads: per orbital pair 0e+1e+2e (rank-2 J) with SOC,
    else one 0e."""
    n_blocks = len(basis.orbital_irreps) ** 2
    if soc:
        return Irreps("+".join(["1x0e+1x1e+1x2e"] * n_blocks))
    return Irreps(f"{n_blocks}x0e")


@functools.lru_cache(maxsize=None)
def _rank2_merge_matrix(ham_type: str, nao_max: int) -> np.ndarray:
    """(D_J, nao, nao, 3, 3): the J irreps components -> each orbital pair's
    3 x 3 Cartesian block (sqrt(2L+1) * w3j(1, 1, L), the yzx -> xyz
    permutation) spread over the pair's orbitals, in DFT orbital order."""
    basis = get_basis_set(ham_type, nao_max)
    nao = basis.nao_max
    perm = np.array([2, 0, 1])
    M = np.zeros((9 * len(basis.orbital_irreps) ** 2, nao, nao, 3, 3))
    blk = np.zeros((9, 3, 3))
    comp = 0
    for L in range(3):
        cg = np.sqrt(2 * L + 1) * wigner_3j(1, 1, L)  # (3, 3, 2L+1)
        for m in range(2 * L + 1):
            blk[comp + m] = cg[:, :, m]
        comp += 2 * L + 1
    blk = blk[:, perm[:, None], perm[None, :]]
    d = 0
    row0 = 0
    for _, li in basis.orbital_irreps:
        col0 = 0
        for _, lj in basis.orbital_irreps:
            M[d : d + 9, row0 : row0 + li.dim, col0 : col0 + lj.dim] = blk[:, None, None]
            d += 9
            col0 += lj.dim
        row0 += li.dim
    if basis.index_change is not None:
        M = M[:, basis.index_change[:, None], basis.index_change[None, :]]
    if basis.minus_index is not None:
        s = np.ones(nao)
        s[basis.minus_index] = -1.0
        M = M * s[None, :, None, None, None] * s[None, None, :, None, None]
    return np.ascontiguousarray(M)


@functools.lru_cache(maxsize=None)
def _rank0_merge_matrix(ham_type: str, nao_max: int) -> np.ndarray:
    """(n_blocks, nao, nao): one scalar J per orbital pair spread over the
    pair's orbitals, in DFT orbital order (no signs: a broadcast scalar)."""
    basis = get_basis_set(ham_type, nao_max)
    nao = basis.nao_max
    M = np.zeros((len(basis.orbital_irreps) ** 2, nao, nao))
    b = 0
    row0 = 0
    for _, li in basis.orbital_irreps:
        col0 = 0
        for _, lj in basis.orbital_irreps:
            M[b, row0 : row0 + li.dim, col0 : col0 + lj.dim] = 1.0
            b += 1
            col0 += lj.dim
        row0 += li.dim
    if basis.index_change is not None:
        M = M[:, basis.index_change[:, None], basis.index_change[None, :]]
    return np.ascontiguousarray(M)


def _spin_components(J: torch.Tensor, s: torch.Tensor, soc: bool, collinear: bool,
                     order: str = "kl") -> torch.Tensor:
    """(rows, C, nao, nao) Cartesian components U_k of a J.S term,
    ``sum_k U_k (x) sigma_k``.  Collinear: C = 1, ``J s_z``.  Rank 0: C = 3,
    ``J s_k``.  Rank 2 (J of (rows, nao, nao, 3, 3)): ``order`` "kl" puts
    sigma on J's first Cartesian axis (``U_k = sum_l J_kl s_l``), "lk" on its
    second (``U_l = sum_k J_kl s_k``), "sym" the sum of the two."""
    if collinear:
        return (J * s[:, 2, None, None])[:, None]
    if not soc:
        return J[:, None] * s[:, :, None, None]
    if order == "sym":
        J = J + J.transpose(-1, -2)
    elif order == "lk":
        J = J.transpose(-1, -2)
    return torch.einsum("nijkl,nl->nkij", J, s)


def heisenberg_components(graph: Graph, J_on, J_off, w_on, w_off, spin_vec, magnetic,
                          soc: bool, collinear: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Heisenberg terms' Cartesian components, (N, C, nao, nao) on site
    and (E, C, nao, nao) off site (C = 1, the z part, when collinear, else
    3): the term is ``sum_k U_k (x) sigma_k``.  ``J_on`` / ``J_off``:
    (rows, nao, nao), or (rows, nao, nao, 3, 3) with ``soc``; ``w_on`` /
    ``w_off``: (rows, nao, nao) weights; ``magnetic``: (N,) 0/1."""
    src, dst = graph.edge_index[0], graph.edge_index[1]
    dtype = w_off.dtype
    e_mask = graph.edge_mask.to(dtype)
    zero_shift = torch.all(graph.cell_shift == 0, dim=1).to(dtype) * e_mask
    group_tar = graph.edge_group_tar

    def bcast(v):
        return v[:, None, None, None]

    # on site a rank-2 J enters in both orders, a rank-0 J once
    t_on = _spin_components(J_on, spin_vec, soc, collinear, "sym") * bcast(magnetic)
    p_src = _spin_components(J_off, spin_vec[dst], soc, collinear, "kl") \
        * bcast(magnetic[dst] * e_mask)
    p_tar = _spin_components(J_off, spin_vec[src], soc, collinear, "lk") \
        * bcast(magnetic[src] * e_mask)
    a = segment_sum(p_src, src, graph.num_nodes)
    a0 = segment_sum(p_tar * bcast(zero_shift), dst, graph.num_nodes)
    b = segment_sum(p_tar, group_tar, graph.num_edges)
    u_on = (t_on + a + a0) * w_on[:, None]
    u_off = (t_on[src] + t_on[dst] * bcast(zero_shift) + a[src] + b[group_tar]) * w_off[:, None]
    return u_on, u_off


def spin_expand(u: torch.Tensor, sigma_re: torch.Tensor, sigma_im: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, 3, nao, nao) components -> the real and imaginary parts of
    ``sum_k U_k (x) sigma_k``, (rows, 2, nao, 2, nao) each."""
    re = torch.einsum("nkij,kop->noipj", u, sigma_re)
    im = torch.einsum("nkij,kop->noipj", u[:, 1:2], sigma_im[1:2])
    return re, im


def heisenberg_terms(graph: Graph, J_on, J_off, w_on, w_off, spin_vec, magnetic,
                     soc: bool, collinear: bool):
    """The JAX package's ``heisenberg_terms`` without complex numbers:
    ((on_re, on_im), (off_re, off_im)), (rows, 2, nao, 2, nao) each; the
    imaginary parts are None when collinear (the term is real,
    ``diag(+U, -U)``)."""
    u_on, u_off = heisenberg_components(graph, J_on, J_off, w_on, w_off, spin_vec,
                                        magnetic, soc, collinear)
    sig_re, sig_im = (torch.as_tensor(a, dtype=u_on.dtype, device=u_on.device)
                      for a in (SIGMA_RE, SIGMA_IM))
    if collinear:  # the z part alone
        return ((torch.einsum("nkij,kop->noipj", u_on, sig_re[2:]), None),
                (torch.einsum("nkij,kop->noipj", u_off, sig_re[2:]), None))
    return spin_expand(u_on, sig_re, sig_im), spin_expand(u_off, sig_re, sig_im)


class HamGNNMagneticOut(nn.Module):
    """Magnetic head.  Collinear: ``hamiltonian_on`` (N, 2, nao^2) and
    ``hamiltonian_off`` (E, 2, nao^2), the up and down channels, with
    ``mask_on`` / ``mask_off`` of the same shapes; with
    ``calculate_band_energy`` and ``k_vecs`` also each channel's bands
    (``band_energy_up/down``, ``band_gap_up/down``), the two stacked on the
    crystal axis (``band_energy``, ``wavefunction``, ``band_gap``), the last
    channel's ``H_sym`` and, from the graph's targets without gradient,
    ``band_energy_ref`` / ``band_gap_ref``.  Non-collinear:
    ``hamiltonian_{real,imag}_{on,off}`` of (rows, (2 nao)^2) with masks of
    that shape.  Both: ``sparsity_ratio``.

    ``use_learned_weight``: the Heisenberg terms are weighted by two more
    heads' blocks, else by the orbital masks.  Atoms whose ``spin_length``
    is at most ``min_magnetic_moment`` carry no spin."""

    def __init__(self, irreps_in_node: str, irreps_in_edge: str, nao_max: int = 14,
                 ham_type: str = "openmx", soc_switch: bool = False,
                 collinear_spin: bool = False, use_learned_weight: bool = True,
                 min_magnetic_moment: float = 0.5, add_H0: bool = True,
                 symmetrize: bool = True, nonlinearity_type: str = "gate",
                 calculate_band_energy: bool = False, num_k: int = 5,
                 band_num_control: int = 8, k_path: Optional[Any] = None,
                 export_reciprocal_values: bool = False):
        super().__init__()
        ham_type = ham_type.lower()
        self.basis = get_basis_set(ham_type, nao_max)
        self.nao = nao = self.basis.nao_max
        self.soc_switch = soc_switch
        self.collinear_spin = collinear_spin
        self.use_learned_weight = use_learned_weight
        self.min_magnetic_moment = min_magnetic_moment
        self.add_H0 = add_H0
        self.symmetrize = symmetrize
        self.calculate_band_energy = calculate_band_energy
        self.num_k = num_k
        self.band_num_control = band_num_control
        self.k_path = k_path
        self.export_reciprocal_values = export_reciprocal_values

        def buffer(name, arr):
            self.register_buffer(name, torch.as_tensor(np.asarray(arr), dtype=torch.float32),
                                 persistent=False)

        buffer("merge", _merge_reorder_matrix(ham_type, nao_max))
        buffer("mask_table", self.basis.orbital_mask_table)
        buffer("n_orb", self.basis.num_orbital_table)
        buffer("sigma_re", SIGMA_RE)
        buffer("sigma_im", SIGMA_IM)
        buffer("spin_eye", np.eye(2))
        if soc_switch:
            buffer("j_merge", _rank2_merge_matrix(ham_type, nao_max).reshape(-1, nao * nao * 9))
        else:
            buffer("j_merge", _rank0_merge_matrix(ham_type, nao_max).reshape(-1, nao * nao))

        node_in, edge_in = Irreps(irreps_in_node), Irreps(irreps_in_edge)
        ham_irreps = hamiltonian_irreps(self.basis)
        heads = [("onsite_hamiltonian", node_in, ham_irreps),
                 ("offsite_hamiltonian", edge_in, ham_irreps)]
        if use_learned_weight:
            heads += [("onsite_weight", node_in, ham_irreps),
                      ("offsite_weight", edge_in, ham_irreps)]
        j_ir = j_irreps(self.basis, soc_switch)
        heads += [("onsite_J", node_in, j_ir), ("offsite_J", edge_in, j_ir)]
        for name, irreps_in, irreps_out in heads:
            self.add_module(name, HamLayer(irreps_in, irreps_out, nonlinearity_type))

    def forward(self, graph: Graph, representation: Dict[str, torch.Tensor],
                k_vecs: Optional[torch.Tensor] = None):
        nao = self.nao
        src, dst = graph.edge_index[0], graph.edge_index[1]
        inv = graph.inv_edge_idx
        node_attr = representation["node_attr"]
        edge_attr = representation["edge_attr"]
        dtype = node_attr.dtype

        tab = self.mask_table.to(dtype)
        node_orb = tab[graph.z]
        on_pair = node_orb[:, :, None] * node_orb[:, None, :] \
            * graph.node_mask[:, None, None].to(dtype)
        off_pair = tab[graph.z[src]][:, :, None] * tab[graph.z[dst]][:, None, :] \
            * graph.edge_mask[:, None, None].to(dtype)

        def sym_on(m, sign=1.0):
            return 0.5 * (m + sign * m.transpose(-1, -2))

        def sym_off(m, sign=1.0):
            return 0.5 * (m + sign * m[inv].transpose(-1, -2))

        def merged(head, feats, off):
            m = (getattr(self, head)(feats) @ self.merge).reshape(-1, nao, nao)
            if self.symmetrize:
                m = sym_off(m) if off else sym_on(m)
            return m * (off_pair if off else on_pair)

        h_on = merged("onsite_hamiltonian", node_attr, False)
        h_off = merged("offsite_hamiltonian", edge_attr, True)
        if self.use_learned_weight:
            w_on = merged("onsite_weight", node_attr, False)
            w_off = merged("offsite_weight", edge_attr, True)
        else:
            # unit weights still carry the orbital masks, as the reference's
            # weights always do before the Heisenberg contractions
            w_on, w_off = on_pair, off_pair

        j_shape = (nao, nao, 3, 3) if self.soc_switch else (nao, nao)
        J_on = (self.onsite_J(node_attr) @ self.j_merge).reshape(-1, *j_shape)
        J_off = (self.offsite_J(edge_attr) @ self.j_merge).reshape(-1, *j_shape)

        spin_vec = graph.spin_vec if graph.spin_vec is not None else \
            node_attr.new_zeros((graph.num_nodes, 3))
        spin_len = graph.spin_length if graph.spin_length is not None else \
            node_attr.new_zeros((graph.num_nodes,))
        magnetic = (spin_len > self.min_magnetic_moment).to(dtype)
        u_on, u_off = heisenberg_components(graph, J_on, J_off, w_on, w_off, spin_vec,
                                            magnetic, self.soc_switch, self.collinear_spin)

        n_i = self.n_orb[graph.z] * graph.node_mask.to(torch.float32)
        eff = torch.sum(n_i * n_i) + torch.sum(
            self.n_orb[graph.z[src]] * self.n_orb[graph.z[dst]]
            * graph.edge_mask.to(torch.float32))
        total = (graph.node_mask.sum() + graph.edge_mask.sum()).to(torch.float32) \
            * float(nao * nao)
        result = {"sparsity_ratio": total / torch.clamp(eff, min=1.0)}

        if self.collinear_spin:
            # sigma_z: the up channel h + U_z, the down channel h - U_z
            col_on = torch.stack([h_on + u_on[:, 0], h_on - u_on[:, 0]], 1)
            col_off = torch.stack([h_off + u_off[:, 0], h_off - u_off[:, 0]], 1)
            col_on = col_on.reshape(-1, 2, nao * nao)
            col_off = col_off.reshape(-1, 2, nao * nao)
            if self.add_H0 and graph.Hon0 is not None:
                col_on = col_on + graph.Hon0
                col_off = col_off + graph.Hoff0
            result["hamiltonian_on"] = col_on
            result["hamiltonian_off"] = col_off
            result["mask_on"] = on_pair.reshape(-1, 1, nao * nao).expand(col_on.shape)
            result["mask_off"] = off_pair.reshape(-1, 1, nao * nao).expand(col_off.shape)
            if self.calculate_band_energy and k_vecs is not None:
                self._band_branch(graph, k_vecs, result)
            return result

        big = 2 * nao
        hh_on_r, hh_on_i = spin_expand(u_on, self.sigma_re, self.sigma_im)
        hh_off_r, hh_off_i = spin_expand(u_off, self.sigma_re, self.sigma_im)
        # the spatial part on both spin-diagonal blocks
        eye = self.spin_eye[None, :, None, :, None]
        h_on_r = (h_on[:, None, :, None, :] * eye + hh_on_r).reshape(-1, big, big)
        h_off_r = (h_off[:, None, :, None, :] * eye + hh_off_r).reshape(-1, big, big)
        h_on_i = hh_on_i.reshape(-1, big, big)
        h_off_i = hh_off_i.reshape(-1, big, big)
        if self.symmetrize:
            h_on_r, h_off_r = sym_on(h_on_r), sym_off(h_off_r)
            h_on_i, h_off_i = sym_on(h_on_i, -1.0), sym_off(h_off_i, -1.0)
        n2 = big * big
        h_on_r, h_off_r = h_on_r.reshape(-1, n2), h_off_r.reshape(-1, n2)
        h_on_i, h_off_i = h_on_i.reshape(-1, n2), h_off_i.reshape(-1, n2)
        if self.add_H0 and graph.Hon0 is not None:
            h_on_r = h_on_r + graph.Hon0
            h_off_r = h_off_r + graph.Hoff0
            if graph.iHon0 is not None:
                h_on_i = h_on_i + graph.iHon0
                h_off_i = h_off_i + graph.iHoff0
        result["hamiltonian_real_on"] = h_on_r
        result["hamiltonian_real_off"] = h_off_r
        result["hamiltonian_imag_on"] = h_on_i
        result["hamiltonian_imag_off"] = h_off_i
        result["mask_on"] = on_pair.repeat(1, 2, 2).reshape(-1, n2)
        result["mask_off"] = off_pair.repeat(1, 2, 2).reshape(-1, n2)
        return result

    def _band_branch(self, graph: Graph, k_vecs: torch.Tensor, result: Dict) -> None:
        """Each spin channel's bands against the spin-independent overlap,
        the channels stacked on the crystal axis (up, then down), and the
        same of the graph's targets without gradient."""
        from ..physics.band import band_energies_batched

        want_sym = not self.export_reciprocal_values

        def solve(h_on, h_off, export_sym):
            return band_energies_batched(graph, h_on, h_off, graph.Son, graph.Soff, k_vecs,
                                         self.basis, num_bands=self.band_num_control,
                                         export_H_sym=export_sym)

        col_on, col_off = result["hamiltonian_on"], result["hamiltonian_off"]
        up = solve(col_on[:, 0], col_off[:, 0], want_sym)
        dn = solve(col_on[:, 1], col_off[:, 1], want_sym)
        result["band_energy_up"], result["band_gap_up"] = up[0], up[2]
        result["band_energy_down"], result["band_gap_down"] = dn[0], dn[2]
        result["band_energy"] = torch.cat([up[0], dn[0]], 0)
        result["wavefunction"] = torch.cat([up[1], dn[1]], 0)
        result["band_gap"] = torch.cat([up[2], dn[2]], 0)
        if want_sym:
            result["H_sym"] = dn[3]  # the last channel's, as the reference keeps
        with torch.no_grad():
            up_r = solve(graph.Hon[:, 0], graph.Hoff[:, 0], False)
            dn_r = solve(graph.Hon[:, 1], graph.Hoff[:, 1], False)
        result["band_energy_ref"] = torch.cat([up_r[0], dn_r[0]], 0)
        result["band_gap_ref"] = torch.cat([up_r[2], dn_r[2]], 0)
