"""Batched k-space Hamiltonian assembly and generalized eigensolve,
counterpart of ``hamgnn_tpu/physics/band.py`` (its SOC variant waits for the
SOC head).

H(k) / S(k) of the whole batch are assembled with two scatter-adds over nodes
and edges at static shapes, and the generalized eigenproblem is solved with
identity padding: invalid or padded orbitals get S = 1, H = ``_PAD_ENERGY`` on
the diagonal, which puts them at the top of the spectrum where they never
meet the physical band window.  The XLA ops of the JAX module become
``torch.linalg.cholesky``, ``solve_triangular`` and ``eigh``; the scatter-adds
become ``_scatter_add_rows``, a sort-based sum without atomics, so an
assembly repeats bit for bit on the card as well.

Phase convention: exp(+2*pi*i k . nbr_shift) with both k and nbr_shift
Cartesian; the off-site block (src, dst) sits at row src, column dst.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..data.graph import Graph
from ..models.basis import BasisSetInfo

# Pad-orbital diagonal energy: far above any physical band, but the fp32
# eigh's absolute error grows with the largest entry (~1e-7 * |max|), so it
# is kept as small as is safe (1e3 -> ~1e-4 eV band error).
_PAD_ENERGY = 1.0e3


def _scatter_add_rows(out: torch.Tensor, key: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``out[key[i]] += vals[i]`` along the first axis, in place; rows that
    share a key are first summed with one another in a fixed order (stable
    sort, padded to the largest multiplicity, one reduction), then each key is
    written once.  No atomics: the result is the same on every call."""
    if key.numel() == 0:
        return out
    order = torch.argsort(key, stable=True)
    k = key[order]
    uniq, inverse, counts = torch.unique_consecutive(k, return_inverse=True,
                                                     return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(k.numel(), device=k.device) - starts[inverse]
    padded = vals.new_zeros((uniq.numel(), int(counts.max()), *vals.shape[1:]))
    padded[inverse, rank] = vals[order]
    out[uniq] += padded.sum(dim=1)
    return out


def _local_index(graph: Graph, M: int):
    """(node offset per crystal, local atom index per node clipped to M)."""
    node_offset = torch.cumsum(graph.node_counts, 0) - graph.node_counts
    local = torch.arange(graph.num_nodes, device=graph.z.device) - node_offset[graph.batch]
    return node_offset, torch.clamp(local, 0, M - 1)


def assemble_k_matrices(graph: Graph, h_on: torch.Tensor, h_off: torch.Tensor,
                        k_vecs: torch.Tensor, nao: int, max_atoms: int) -> torch.Tensor:
    """h_on (N, nao^2), h_off (E, nao^2), k_vecs (B, nk, 3) Cartesian ->
    (B, nk, max_atoms*nao, max_atoms*nao) complex H(k)."""
    B = graph.num_graphs
    nk = k_vecs.shape[1]
    M = max_atoms
    if h_on.is_complex():
        dtype_c = h_on.dtype
    else:
        dtype_c = torch.complex64 if h_on.dtype == torch.float32 else torch.complex128

    node_offset, local = _local_index(graph, M)
    src, dst = graph.edge_index[0], graph.edge_index[1]
    b_e = graph.batch[src]
    src_l = torch.clamp(src - node_offset[b_e], 0, M - 1)
    dst_l = torch.clamp(dst - node_offset[b_e], 0, M - 1)

    # rows of hk: (crystal, atom i, atom j) -> (nk, nao, nao)
    hk = torch.zeros((B * M * M, nk, nao, nao), dtype=dtype_c, device=h_on.device)
    on_blocks = (h_on * graph.node_mask[:, None]).reshape(-1, 1, nao, nao).to(dtype_c)
    _scatter_add_rows(hk, (graph.batch * M + local) * M + local,
                      on_blocks.expand(-1, nk, -1, -1))

    # phases (E, nk): exp(+2*pi*i k . nbr_shift), Cartesian dot product
    dot = torch.sum(graph.nbr_shift[:, None, :] * k_vecs[b_e], dim=-1)
    phase = torch.exp((2j * math.pi) * dot.to(dtype_c))
    off_blocks = (h_off * graph.edge_mask[:, None]).reshape(-1, 1, nao, nao).to(dtype_c)
    _scatter_add_rows(hk, (b_e * M + src_l) * M + dst_l,
                      phase[:, :, None, None] * off_blocks)

    # (B, M, M, nk, nao, nao) -> (B, nk, M*nao, M*nao)
    return hk.reshape(B, M, M, nk, nao, nao).permute(0, 3, 1, 4, 2, 5).reshape(
        B, nk, M * nao, M * nao)


def band_counts_per_crystal(graph: Graph, species_counts, num_species: int = 99
                            ) -> torch.Tensor:
    """Per-crystal band counts from per-species counts (the dict-valued
    ``band_num_control`` of the reference): the per-atom counts summed over
    each crystal.  ``species_counts``: iterable of (atomic number, count)."""
    table = np.zeros(num_species, np.int64)
    for z, cnt in species_counts:
        table[int(z)] = int(cnt)
    per_node = torch.as_tensor(table, device=graph.z.device)[graph.z] * graph.node_mask.long()
    return torch.zeros(graph.num_graphs, dtype=torch.long, device=graph.z.device
                       ).index_add_(0, graph.batch, per_node)


def _generalized_eigh(HK: torch.Tensor, SK: torch.Tensor):
    """Cholesky-reduced generalized eigensolve: L L^H = S, A = L^-1 H L^-H;
    returns (eigenvalues ascending, psi = L^-H v, A)."""
    L = torch.linalg.cholesky(SK)
    Hh = torch.linalg.solve_triangular(L, HK, upper=False)
    A = torch.linalg.solve_triangular(L, Hh.mH, upper=False).mH
    A = 0.5 * (A + A.mH)
    eigvals, eigvecs = torch.linalg.eigh(A)
    psi = torch.linalg.solve_triangular(L.mH, eigvecs, upper=True)
    return eigvals, psi, A


def band_energies_batched(
    graph: Graph,
    h_on: torch.Tensor,
    h_off: torch.Tensor,
    s_on: torch.Tensor,
    s_off: torch.Tensor,
    k_vecs: torch.Tensor,
    basis: BasisSetInfo,
    num_bands: int = 8,
    max_atoms: Optional[int] = None,
    export_reciprocal: bool = False,
    band_counts: Optional[torch.Tensor] = None,
    sk_export_on: Optional[torch.Tensor] = None,
    sk_export_off: Optional[torch.Tensor] = None,
    export_H_sym: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Generalized bands around half filling.

    Returns (band_energy (B, nk, 2*num_bands), wavefunction
    (B, nk, 2*num_bands, M*nao), band_gap (B,)); with ``export_reciprocal``
    also (HK, SK[, dSK]).  ``M`` is ``max_atoms``, or the padded node count
    of the batch when that is None.

    With ``band_counts`` (B,) set (the per-species dict mode of
    ``band_num_control``) the *lowest* bands are taken instead of a window
    around half filling: a static block of ``num_bands`` bottom bands plus a
    ``band_mask`` (B, 1, num_bands) flagging the first ``band_counts[b]`` of
    them: (band_energy (B, nk, num_bands), wavefunction, band_gap,
    band_mask[, HK, SK, dSK]).

    ``sk_export_on/off``: when set, the *exported* SK is assembled from these
    (predicted) overlap rows while the eigensolve still factorizes the
    reference overlap.  ``export_H_sym``: append the Cholesky-transformed
    Hamiltonian A = L^-1 H(k) L^-H as (B, nk, M*nao, M*nao).
    """
    nao = basis.nao_max
    M = int(max_atoms) if max_atoms is not None else int(graph.num_nodes)
    B = graph.num_graphs
    dtype = h_on.dtype
    dev = h_on.device

    HK = assemble_k_matrices(graph, h_on, h_off, k_vecs, nao, M)
    SK = assemble_k_matrices(graph, s_on, s_off, k_vecs, nao, M)

    # validity mask per (crystal, local atom, orbital)
    mask_table = torch.as_tensor(basis.orbital_mask_table, dtype=dtype, device=dev)
    node_orb = mask_table[graph.z] * graph.node_mask[:, None]          # (N, nao)
    _, local = _local_index(graph, M)
    orb_valid = torch.zeros((B * M, nao), dtype=dtype, device=dev).scatter_reduce(
        0, (graph.batch * M + local)[:, None].expand(-1, nao), node_orb, reduce="amax")
    orb_valid = orb_valid.reshape(B, M * nao)

    pair_valid = orb_valid[:, :, None] * orb_valid[:, None, :]
    diag_pad = torch.diag_embed(1.0 - orb_valid)[:, None]               # (B, 1, Mnao, Mnao)
    HK = HK * pair_valid[:, None] + (_PAD_ENERGY * diag_pad).to(HK.dtype)
    SK = SK * pair_valid[:, None] + diag_pad.to(SK.dtype)

    eigvals, psi, A = _generalized_eigh(HK, SK)

    # half-filled index per crystal
    valence_table = torch.as_tensor(basis.num_valence_table, dtype=dtype, device=dev)
    val_per_node = valence_table[graph.z] * graph.node_mask
    crystal_valence = torch.zeros(B, dtype=dtype, device=dev).index_add_(
        0, graph.batch, val_per_node)
    half = torch.ceil(crystal_valence / 2.0).long()                     # (B,)

    nk = eigvals.shape[1]
    at_half = half[:, None, None].expand(-1, nk, 1)
    gap = (torch.gather(eigvals, 2, at_half).amin(dim=1)
           - torch.gather(eigvals, 2, at_half - 1).amax(dim=1))[:, 0]

    if band_counts is not None:
        # dict mode: lowest `num_bands` bands, masked to per-crystal counts
        w = min(int(num_bands), M * nao)
        band = eigvals[:, :, :w]
        wfn = psi[:, :, :, :w].transpose(-1, -2)                        # (B, nk, w, Mnao)
        band_mask = (torch.arange(w, device=dev)[None, :] < band_counts[:, None])
        band_mask = band_mask.to(band.dtype)[:, None, :]                # (B, 1, w)
    else:
        # static window [half - w, half + w), kept inside the PHYSICAL
        # spectrum: the upper clip uses the per-crystal valid-orbital count,
        # so the window never slides into the _PAD_ENERGY states
        w = int(num_bands)
        n_valid = torch.sum(orb_valid, dim=1).long()                    # (B,)
        upper = torch.clamp(n_valid - 2 * w, 0, M * nao - 2 * w)
        start = torch.minimum(torch.clamp(half - w, min=0), upper)
        cols = start[:, None] + torch.arange(2 * w, device=dev)[None, :]  # (B, 2w)
        band = torch.gather(eigvals, 2, cols[:, None, :].expand(-1, nk, -1))
        wfn = torch.gather(psi, 3, cols[:, None, None, :].expand(-1, nk, M * nao, -1))
        wfn = wfn.transpose(-1, -2)                                     # (B, nk, 2w, Mnao)
        band_mask = None
    extras = []
    if band_mask is not None:
        extras.append(band_mask)
    if export_reciprocal:
        if sk_export_on is not None and sk_export_off is not None:
            SK_exp = assemble_k_matrices(graph, sk_export_on, sk_export_off, k_vecs, nao, M)
            SK_exp = SK_exp * pair_valid[:, None] + diag_pad.to(SK_exp.dtype)
        else:
            SK_exp = SK
        extras.extend([HK, SK_exp])
        if graph.dSon is not None and graph.dSoff is not None:
            dsk = [assemble_k_matrices(graph, graph.dSon[..., ax], graph.dSoff[..., ax],
                                       k_vecs, nao, M) for ax in range(3)]
            extras.append(torch.stack(dsk, dim=-1))
    if export_H_sym:
        extras.append(A)
    if extras:
        return (band, wfn, gap, *extras)
    return band, wfn, gap
