"""Batched k-space Hamiltonian assembly and generalized eigensolve,
counterpart of ``hamgnn_tpu/physics/band.py``: the bands of the non-SOC head
(``band_energies_batched``) and the spinor bands of the SOC head
(``band_energies_soc_batched``).

H(k) / S(k) of the whole batch are assembled with two ``index_add_`` over
nodes and edges at static shapes, and the generalized eigenproblem is solved
with identity padding: invalid or padded orbitals get S = 1, H =
``_PAD_ENERGY`` on the diagonal, which puts them at the top of the spectrum
where they never meet the physical band window.  The XLA ops of the JAX
module become ``physics.eigh.cholesky`` (``cholesky_ex``), ``solve_triangular``
and ``physics.eigh.hermitian_eigh``, which give NaN where JAX's give NaN
(an overlap that is not positive definite, a matrix that is not finite)
instead of raising.  Nothing here reads the device on the host or builds a
tensor from host data after a first call (the basis tables are made once
per device, ``utils.constants.device_constant``), so a step through the
band branch can be captured as CUDA graphs, cut around the eigensolve
(``physics/eigh.py``).  On the card the assembly's ``index_add_`` sums rows that
share a (crystal, atom, atom) block with atomics, in an order that can
change from call to call; under ``torch.use_deterministic_algorithms(True)``
it sorts them and repeats bit for bit.

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
from ..utils.constants import device_constant
from .eigh import cholesky, hermitian_eigh

# Pad-orbital diagonal energy: far above any physical band, but the fp32
# eigh's absolute error grows with the largest entry (~1e-7 * |max|), so it
# is kept as small as is safe (1e3 -> ~1e-4 eV band error).
_PAD_ENERGY = 1.0e3


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
    hk.index_add_(0, (graph.batch * M + local) * M + local,
                      on_blocks.expand(-1, nk, -1, -1))

    # phases (E, nk): exp(+2*pi*i k . nbr_shift), Cartesian dot product
    dot = torch.sum(graph.nbr_shift[:, None, :] * k_vecs[b_e], dim=-1)
    phase = torch.exp((2j * math.pi) * dot.to(dtype_c))
    off_blocks = (h_off * graph.edge_mask[:, None]).reshape(-1, 1, nao, nao).to(dtype_c)
    hk.index_add_(0, (b_e * M + src_l) * M + dst_l, phase[:, :, None, None] * off_blocks)

    # (B, M, M, nk, nao, nao) -> (B, nk, M*nao, M*nao)
    return hk.reshape(B, M, M, nk, nao, nao).permute(0, 3, 1, 4, 2, 5).reshape(
        B, nk, M * nao, M * nao)


def species_count_table(species_counts, num_species: int = 99) -> torch.Tensor:
    """(num_species,) int64 band count per atomic number from (atomic
    number, count) pairs, on the CPU."""
    table = np.zeros(num_species, np.int64)
    for z, cnt in species_counts:
        table[int(z)] = int(cnt)
    return torch.as_tensor(table)


def band_counts_per_crystal(graph: Graph, count_table: torch.Tensor) -> torch.Tensor:
    """Per-crystal band counts from per-species counts (the dict-valued
    ``band_num_control`` of the reference): the per-atom counts summed over
    each crystal.  ``count_table``: the counts' ``species_count_table`` on
    the graph's device."""
    per_node = count_table[graph.z] * graph.node_mask.long()
    return torch.zeros(graph.num_graphs, dtype=torch.long, device=graph.z.device
                       ).index_add_(0, graph.batch, per_node)


def _generalized_eigh(HK: torch.Tensor, SK: torch.Tensor):
    """Cholesky-reduced generalized eigensolve: L L^H = S, A = L^-1 H L^-H;
    returns (eigenvalues ascending, psi = L^-H v, A).  A crystal whose S(k)
    is not positive definite gets NaN in all three, as in JAX."""
    L = cholesky(SK)
    Hh = torch.linalg.solve_triangular(L, HK, upper=False)
    A = torch.linalg.solve_triangular(L, Hh.mH, upper=False).mH
    A = 0.5 * (A + A.mH)
    eigvals, eigvecs = hermitian_eigh(A)
    psi = torch.linalg.solve_triangular(L.mH, eigvecs, upper=True)
    return eigvals, psi, A


def _orbital_valid(graph: Graph, basis: BasisSetInfo, M: int, dtype,
                   spins: int = 1) -> torch.Tensor:
    """(B, M * spins * nao) 1/0: the orbitals of each crystal's local atoms
    that its species have (``spins`` copies per atom, spin-major)."""
    mask_table = device_constant((basis.ham_type, basis.nao_max, "orbital_mask_table"),
                                 lambda: basis.orbital_mask_table, dtype, graph.z.device)
    node_orb = (mask_table[graph.z] * graph.node_mask[:, None]).repeat(1, spins)
    width = node_orb.shape[1]
    _, local = _local_index(graph, M)
    return torch.zeros((graph.num_graphs * M, width), dtype=dtype,
                       device=graph.z.device).scatter_reduce(
        0, (graph.batch * M + local)[:, None].expand(-1, width), node_orb,
        reduce="amax").reshape(graph.num_graphs, M * width)


def _pad_invalid(mat: torch.Tensor, orb_valid: torch.Tensor, diag: float) -> torch.Tensor:
    """(B, nk, n, n) H(k) or S(k) with the rows and columns of invalid or
    padded orbitals zeroed and ``diag`` on their diagonal."""
    pair_valid = orb_valid[:, :, None] * orb_valid[:, None, :]
    pad = torch.diag_embed(1.0 - orb_valid)[:, None]
    return mat * pair_valid[:, None] + (diag * pad).to(mat.dtype)


def _crystal_valence(graph: Graph, basis: BasisSetInfo, dtype) -> torch.Tensor:
    """(B,) valence electrons of each crystal."""
    table = device_constant((basis.ham_type, basis.nao_max, "num_valence_table"),
                            lambda: basis.num_valence_table, dtype, graph.z.device)
    return torch.zeros(graph.num_graphs, dtype=dtype, device=graph.z.device).index_add_(
        0, graph.batch, table[graph.z] * graph.node_mask)


def _gap(eigvals: torch.Tensor, fill: torch.Tensor) -> torch.Tensor:
    """(B,) lowest state from index ``fill`` over k minus highest below it."""
    at = fill[:, None, None].expand(-1, eigvals.shape[1], 1)
    return (torch.gather(eigvals, 2, at).amin(dim=1)
            - torch.gather(eigvals, 2, at - 1).amax(dim=1))[:, 0]


def _window(eigvals: torch.Tensor, psi: torch.Tensor, fill: torch.Tensor,
            orb_valid: torch.Tensor, w: int):
    """The static window of 2 w bands [fill - w, fill + w), kept inside the
    physical spectrum: the upper clip is each crystal's valid-orbital count,
    so the window never slides into the ``_PAD_ENERGY`` states.  Returns
    (band (B, nk, 2w), wavefunction (B, nk, 2w, n))."""
    nk, n = eigvals.shape[1], eigvals.shape[2]
    n_valid = torch.sum(orb_valid, dim=1).long()
    upper = torch.clamp(n_valid - 2 * w, 0, n - 2 * w)
    start = torch.minimum(torch.clamp(fill - w, min=0), upper)
    cols = start[:, None] + torch.arange(2 * w, device=eigvals.device)[None, :]
    band = torch.gather(eigvals, 2, cols[:, None, :].expand(-1, nk, -1))
    wfn = torch.gather(psi, 3, cols[:, None, None, :].expand(-1, nk, n, -1))
    return band, wfn.transpose(-1, -2)


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
    dtype = h_on.dtype
    dev = h_on.device

    HK = assemble_k_matrices(graph, h_on, h_off, k_vecs, nao, M)
    SK = assemble_k_matrices(graph, s_on, s_off, k_vecs, nao, M)
    orb_valid = _orbital_valid(graph, basis, M, dtype)
    HK = _pad_invalid(HK, orb_valid, _PAD_ENERGY)
    SK = _pad_invalid(SK, orb_valid, 1.0)

    eigvals, psi, A = _generalized_eigh(HK, SK)

    half = torch.ceil(_crystal_valence(graph, basis, dtype) / 2.0).long()  # half filling
    gap = _gap(eigvals, half)

    if band_counts is not None:
        # dict mode: lowest `num_bands` bands, masked to per-crystal counts
        w = min(int(num_bands), M * nao)
        band = eigvals[:, :, :w]
        wfn = psi[:, :, :, :w].transpose(-1, -2)                        # (B, nk, w, Mnao)
        band_mask = (torch.arange(w, device=dev)[None, :] < band_counts[:, None])
        band_mask = band_mask.to(band.dtype)[:, None, :]                # (B, 1, w)
    else:
        band, wfn = _window(eigvals, psi, half, orb_valid, int(num_bands))
        band_mask = None
    extras = []
    if band_mask is not None:
        extras.append(band_mask)
    if export_reciprocal:
        if sk_export_on is not None and sk_export_off is not None:
            SK_exp = _pad_invalid(assemble_k_matrices(graph, sk_export_on, sk_export_off,
                                                      k_vecs, nao, M), orb_valid, 1.0)
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


def band_energies_soc_batched(
    graph: Graph,
    h_on_real: torch.Tensor,
    h_on_imag: torch.Tensor,
    h_off_real: torch.Tensor,
    h_off_imag: torch.Tensor,
    s_on: torch.Tensor,
    s_off: torch.Tensor,
    k_vecs: torch.Tensor,
    basis: BasisSetInfo,
    num_bands: int = 8,
    max_atoms: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Spinor (2 nao) complex generalized bands, for the SOC head.

    ``h_*_real`` / ``h_*_imag``: (rows, (2 nao)^2) spinor blocks; ``s_on`` /
    ``s_off``: the (rows, nao^2) spatial overlap, put on both spin-diagonal
    blocks.  H(k), S(k) are (B, nk, M * 2 nao, M * 2 nao) complex with ``M``
    as in ``band_energies_batched``.  Spinor states are singly occupied, so
    the filling index is the crystal's valence count itself, and the window
    of ``2 * num_bands`` bands sits around it, inside the physical spectrum.

    Returns (band_energy (B, nk, 2 * num_bands), wavefunction
    (B, nk, 2 * num_bands, M * 2 nao), band_gap (B,)).
    """
    nao = basis.nao_max
    nao2 = 2 * nao
    M = int(max_atoms) if max_atoms is not None else int(graph.num_nodes)
    dtype = h_on_real.dtype

    def spin_diag(rows):
        sb = rows.reshape(-1, nao, nao)
        zero = torch.zeros_like(sb)
        out = torch.cat([torch.cat([sb, zero], 2), torch.cat([zero, sb], 2)], 1)
        return out.reshape(-1, nao2 * nao2)

    HK = assemble_k_matrices(graph, torch.complex(h_on_real, h_on_imag),
                             torch.complex(h_off_real, h_off_imag), k_vecs, nao2, M)
    SK = assemble_k_matrices(graph, spin_diag(s_on), spin_diag(s_off), k_vecs, nao2, M)
    orb_valid = _orbital_valid(graph, basis, M, dtype, spins=2)
    eigvals, psi, _A = _generalized_eigh(_pad_invalid(HK, orb_valid, _PAD_ENERGY),
                                         _pad_invalid(SK, orb_valid, 1.0))
    occ = torch.round(_crystal_valence(graph, basis, dtype)).long()   # singly occupied
    band, wfn = _window(eigvals, psi, occ, orb_valid, int(num_bands))
    return band, wfn, _gap(eigvals, occ)
