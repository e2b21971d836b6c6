"""HamGNN++ output head (non-SOC), counterpart of
``hamgnn_tpu/models/output.py``.

Irreps features -> nao x nao Hamiltonian blocks through one precomputed
merge/reorder matrix per head; Hermitian symmetrisation through the inverse
edge (the transposed merge matrix ``M_T`` gives the Hermitian mates straight
from the head matmul), orbital masks, H0 and the zero-point shift; with
``calculate_band_energy`` and k-points, the band branch
(``physics/band.py``) on the predicted and on the reference Hamiltonian.
The head is written against a ``GraphView``: under the halo partition the
inverse-edge rows come through ``view.inv_exchange``, the zero-point shift
and the sparsity ratio sum through ``view.psum``, and the band branch runs
when the view carries the whole crystal (``view.graph``), on the rows
``view.gather_nodes_global`` / ``gather_edges_global`` reassemble.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..data.graph import Graph
from ..e3.irreps import Irreps
from ..e3.linear import Linear
from ..e3.wigner import wigner_3j
from ..nn.blocks import ResidualBlock
from .basis import get_basis_set, hamiltonian_irreps
from .view import as_view


@functools.lru_cache(maxsize=None)
def _merge_reorder_matrix(ham_type: str, nao_max: int) -> np.ndarray:
    """(irreps_dim, nao^2) matrix: irreps components -> DFT-ordered nao block
    (sqrt(2L+1) * w3j merge fused with the index_change/minus_index reorder)."""
    basis = get_basis_set(ham_type, nao_max)
    nao = basis.nao_max
    D = hamiltonian_irreps(basis).dim
    M = np.zeros((D, nao, nao))
    comp = 0
    row_start = 0
    for _, li in basis.orbital_irreps:
        di = li.dim
        col_start = 0
        for _, lj in basis.orbital_irreps:
            dj = lj.dim
            for L in range(abs(li.l - lj.l), li.l + lj.l + 1):
                cg = np.sqrt(2 * L + 1) * wigner_3j(li.l, lj.l, L)
                for m in range(2 * L + 1):
                    M[comp + m, row_start : row_start + di,
                      col_start : col_start + dj] += cg[:, :, m]
                comp += 2 * L + 1
            col_start += dj
        row_start += di
    if comp != D:
        raise AssertionError(f"merge matrix covers {comp} of {D} components")
    if basis.index_change is not None:
        M = M[:, basis.index_change[:, None], basis.index_change[None, :]]
    if basis.minus_index is not None:
        sign = np.ones(nao)
        sign[basis.minus_index] = -1.0
        M = M * sign[None, :, None] * sign[None, None, :]
    return np.ascontiguousarray(M.reshape(D, nao * nao))


@functools.lru_cache(maxsize=None)
def _decompose_matrix(ham_type: str, nao_max: int) -> np.ndarray:
    """(nao^2, irreps_dim) inverse map: the merge matrix is orthogonal."""
    return np.ascontiguousarray(_merge_reorder_matrix(ham_type, nao_max).T)


class HamLayer(nn.Module):
    """ResidualBlock + equivariant Linear head."""

    def __init__(self, irreps_in, irreps_out, nonlinearity_type: str = "gate"):
        super().__init__()
        self.residual = ResidualBlock(irreps_in, irreps_in, resnet=True,
                                      nonlinearity_type=nonlinearity_type)
        self.head = Linear(irreps_in, irreps_out)

    def forward(self, x):
        return self.head(self.residual(x))


class HamGNNPlusPlusOut(nn.Module):
    """Non-SOC head: per-atom ``hamiltonian_on`` (N, nao^2) and per-edge
    ``hamiltonian_off`` (E, nao^2), optional overlaps, masks and the
    sparsity ratio.

    Band branch (``calculate_band_energy`` and ``k_vecs`` given):
    ``band_energy``, ``wavefunction``, ``band_gap`` (and ``band_mask`` with
    ``band_species_counts``, ``HK``/``SK``/``dSK`` with
    ``export_reciprocal_values``, else ``H_sym``) from the predicted
    Hamiltonian, and their ``_ref`` twins from the reference Hamiltonian of
    the graph, without gradient.  ``k_path``: None (random k), ``"auto"`` or
    a tuple of reduced nodes, read by the trainer; ``band_num_control``: the
    half-width of the band window, or with ``band_species_counts``
    (((z, count), ...)) the number of bottom bands exported."""

    def __init__(self, irreps_in_node: str, irreps_in_edge: str, nao_max: int = 14,
                 ham_type: str = "openmx", ham_only: bool = True,
                 symmetrize: bool = True, add_H0: bool = True,
                 zero_point_shift: bool = True, nonlinearity_type: str = "gate",
                 export_mask: bool = True, calculate_band_energy: bool = False,
                 num_k: int = 5, k_path: Optional[Any] = None,
                 band_num_control: int = 8,
                 band_species_counts: Optional[Tuple[Tuple[int, int], ...]] = None,
                 export_reciprocal_values: bool = False):
        super().__init__()
        self.calculate_band_energy = calculate_band_energy
        self.num_k = num_k
        self.k_path = k_path
        self.band_num_control = band_num_control
        self.band_species_counts = band_species_counts
        self.export_reciprocal_values = export_reciprocal_values
        self.basis = get_basis_set(ham_type, nao_max)
        self.nao = self.basis.nao_max
        ham_irreps = hamiltonian_irreps(self.basis)
        self.ham_only = ham_only
        self.symmetrize = symmetrize
        self.add_H0 = add_H0
        self.zero_point_shift = zero_point_shift
        self.export_mask = export_mask

        M = _merge_reorder_matrix(ham_type.lower(), nao_max)
        tperm = np.arange(self.nao * self.nao).reshape(self.nao, self.nao).T.reshape(-1)
        self.register_buffer("M", torch.as_tensor(M, dtype=torch.float32), persistent=False)
        self.register_buffer("M_T", torch.as_tensor(M[:, tperm], dtype=torch.float32),
                             persistent=False)
        self.register_buffer("mask_table", torch.as_tensor(self.basis.orbital_mask_table),
                             persistent=False)
        self.register_buffer(
            "n_orb", torch.as_tensor(self.basis.num_orbital_table, dtype=torch.float32),
            persistent=False)
        if band_species_counts is not None:
            from ..physics.band import species_count_table

            self.register_buffer("band_count_table", species_count_table(band_species_counts),
                                 persistent=False)

        heads = ["onsite_hamiltonian", "offsite_hamiltonian"]
        if not ham_only:
            heads += ["onsite_overlap", "offsite_overlap"]
        for name in heads:
            irreps_in = irreps_in_node if name.startswith("onsite") else irreps_in_edge
            self.add_module(name, HamLayer(Irreps(irreps_in), ham_irreps,
                                           nonlinearity_type))

    def _blocks(self, head_name, feats):
        comps = getattr(self, head_name)(feats)
        return comps @ self.M, (comps @ self.M_T if self.symmetrize else None)

    def forward(self, graph: Graph, representation: Dict[str, torch.Tensor],
                k_vecs: Optional[torch.Tensor] = None):
        return self.forward_view(as_view(graph), representation, k_vecs=k_vecs)

    def forward_view(self, view, representation: Dict[str, torch.Tensor],
                     k_vecs: Optional[torch.Tensor] = None):
        nao = self.nao
        node_attr = representation["node_attr"]
        edge_attr = representation["edge_attr"]
        dtype = node_attr.dtype

        def on(head):
            h, hT = self._blocks(head, node_attr)
            return 0.5 * (h + hT) if self.symmetrize else h

        def off(head):
            h, hT = self._blocks(head, edge_attr)
            return 0.5 * (h + view.inv_exchange(hT)) if self.symmetrize else h

        tab = self.mask_table.to(dtype)
        node_orb = tab[view.z]
        on_mask = (node_orb[:, :, None] * node_orb[:, None, :]).reshape(-1, nao * nao)
        off_mask = (tab[view.z_src][:, :, None]
                    * tab[view.z_dst][:, None, :]).reshape(-1, nao * nao)
        on_mask = on_mask * view.node_mask[:, None].to(dtype)
        off_mask = off_mask * view.edge_mask[:, None].to(dtype)

        result: Dict[str, torch.Tensor] = {}
        if not self.ham_only:
            result["overlap_on"] = on("onsite_overlap") * on_mask
            result["overlap_off"] = off("offsite_overlap") * off_mask

        h_on = on("onsite_hamiltonian")
        if self.add_H0 and view.Hon0 is not None:
            h_on = h_on + view.Hon0
        h_off = off("offsite_hamiltonian")
        if self.add_H0 and view.Hoff0 is not None:
            h_off = h_off + view.Hoff0
        h_on = h_on * on_mask
        h_off = h_off * off_mask

        if self.zero_point_shift and view.Son is not None and view.Hon is not None:
            thresh = 1e-6
            s_on, s_off = view.Son, view.Soff
            w_on = (s_on > thresh).to(dtype) * on_mask
            w_off = (s_off > thresh).to(dtype) * off_mask
            num = view.psum(torch.sum(w_on * (h_on - view.Hon))
                            + torch.sum(w_off * (h_off - view.Hoff)))
            den = view.psum(torch.sum(w_on * s_on) + torch.sum(w_off * s_off))
            shift = num / torch.clamp(den, min=1e-12)
            h_on = h_on - shift * s_on * on_mask
            h_off = h_off - shift * s_off * off_mask

        result["hamiltonian_on"] = h_on
        result["hamiltonian_off"] = h_off
        if self.export_mask:
            result["mask_on"] = on_mask
            result["mask_off"] = off_mask

        node_mask = view.node_mask.to(torch.float32)
        edge_mask = view.edge_mask.to(torch.float32)
        n_i = self.n_orb[view.z] * node_mask
        eff = view.psum(torch.sum(n_i * n_i) + torch.sum(
            self.n_orb[view.z_src] * self.n_orb[view.z_dst] * edge_mask))
        total = view.psum(torch.sum(node_mask) + torch.sum(edge_mask)) * float(nao * nao)
        result["sparsity_ratio"] = total / torch.clamp(eff, min=1.0)

        if self.calculate_band_energy and k_vecs is not None and view.graph is not None:
            self._band_branch(view, k_vecs, result)
        return result

    def _band_branch(self, view, k_vecs: torch.Tensor, result: Dict) -> None:
        """Bands of the predicted Hamiltonian, and of the graph's reference
        Hamiltonian (no gradient), against the reference overlap, on the
        whole crystal's rows (``view.gather_*_global``)."""
        from ..physics.band import band_counts_per_crystal, band_energies_batched

        graph = view.graph
        band_counts = None
        if self.band_species_counts is not None:
            band_counts = band_counts_per_crystal(graph, self.band_count_table)
        # ham_only=False + export_reciprocal: the exported SK comes from the
        # PREDICTED overlap while the solve factorizes the reference S
        sk_pred = {}
        if self.export_reciprocal_values and not self.ham_only:
            sk_pred = {"sk_export_on": view.gather_nodes_global(result["overlap_on"]),
                       "sk_export_off": view.gather_edges_global(result["overlap_off"])}
        # H_sym (the Cholesky-transformed H) goes out on the non-reciprocal path
        want_H_sym = not self.export_reciprocal_values
        band, wfn, gap, *extras = band_energies_batched(
            graph, view.gather_nodes_global(result["hamiltonian_on"]),
            view.gather_edges_global(result["hamiltonian_off"]),
            graph.Son, graph.Soff, k_vecs, self.basis,
            num_bands=self.band_num_control,
            export_reciprocal=self.export_reciprocal_values,
            band_counts=band_counts, export_H_sym=want_H_sym, **sk_pred)
        if band_counts is not None:
            result["band_mask"] = extras.pop(0)
        if self.export_reciprocal_values:
            result["HK"] = extras.pop(0)
            result["SK"] = extras.pop(0)
            if len(extras) > (1 if want_H_sym else 0):
                result["dSK"] = extras.pop(0)
        if want_H_sym:
            result["H_sym"] = extras.pop(0)
        result["band_energy"] = band
        result["wavefunction"] = wfn
        result["band_gap"] = gap
        with torch.no_grad():
            ref_out = band_energies_batched(
                graph, graph.Hon, graph.Hoff, graph.Son, graph.Soff, k_vecs, self.basis,
                num_bands=self.band_num_control, band_counts=band_counts,
                export_H_sym=want_H_sym)
        result["band_energy_ref"] = ref_out[0]
        result["band_gap_ref"] = ref_out[2]
        # reference-H twins, so that wavefunction / H_sym can sit under a loss
        # spec like any other result key
        result["wavefunction_ref"] = ref_out[1]
        if want_H_sym:
            result["H_sym_ref"] = ref_out[3 + (1 if band_counts is not None else 0)]
        if self.zero_point_shift:
            result["band_energy"] = band - torch.mean(band - ref_out[0])


def concatenate_by_crystal(graph: Graph, on_rows: np.ndarray, off_rows: np.ndarray):
    """Host-side export in the reference's interleaved layout: per crystal,
    its onsite rows then its offsite rows."""
    on_rows = np.asarray(on_rows)
    off_rows = np.asarray(off_rows)
    node_counts = np.asarray(graph.node_counts.cpu())
    edge_counts = np.asarray(graph.edge_counts.cpu())
    out = []
    n_ofs = e_ofs = 0
    for n, e in zip(node_counts.tolist(), edge_counts.tolist()):
        out.append(on_rows[n_ofs : n_ofs + n])
        out.append(off_rows[e_ofs : e_ofs + e])
        n_ofs += n
        e_ofs += e
    return np.concatenate(out, axis=0)
