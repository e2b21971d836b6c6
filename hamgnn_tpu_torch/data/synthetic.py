"""Synthetic crystals with random Hamiltonian targets, for smoke runs and
benchmarks.

The same construction as ``tests/util_fixtures.py`` (``make_crystal``,
``add_random_hamiltonian_targets``), drawing the same numbers from the same
``numpy`` generator, so a seed gives the same crystal in both packages.  It
builds on this package's neighbor list and basis tables.
"""

from __future__ import annotations

import numpy as np

from ..models.basis import get_basis_set
from .neighborlist import inverse_edge_index, neighbor_list_pbc


def make_crystal(rng, n_atoms=4, species=(6, 14), cell_size=6.0, cutoff=4.0):
    """Random periodic crystal dict with edges from a PBC radius graph."""
    cell = np.eye(3) * cell_size + rng.normal(scale=0.1, size=(3, 3))
    frac = rng.uniform(size=(n_atoms, 3))
    pos = frac @ cell
    z = rng.choice(species, size=n_atoms)

    if n_atoms <= 16:
        # brute-force PBC neighbor list over 3^3 images
        src, dst, shifts, cshifts = [], [], [], []
        for i in range(n_atoms):
            for j in range(n_atoms):
                for sx in (-1, 0, 1):
                    for sy in (-1, 0, 1):
                        for sz in (-1, 0, 1):
                            S = np.array([sx, sy, sz])
                            d = pos[j] + S @ cell - pos[i]
                            r = np.linalg.norm(d)
                            if 1e-6 < r < cutoff:
                                src.append(i)
                                dst.append(j)
                                shifts.append(S @ cell)
                                cshifts.append(S)
        edge_index = np.array([src, dst], dtype=np.int64)
        nbr_shift = np.array(shifts, dtype=np.float64).reshape(-1, 3)
        cell_shift = np.array(cshifts, dtype=np.int64).reshape(-1, 3)
        inv = inverse_edge_index(edge_index, cell_shift)
    else:
        edge_index, cell_shift, nbr_shift = neighbor_list_pbc(pos, cell, cutoff)
        inv = inverse_edge_index(edge_index, cell_shift)

    return {
        "z": z.astype(np.int64),
        "pos": pos,
        "cell": cell[None],
        "edge_index": edge_index,
        "inv_edge_idx": inv,
        "nbr_shift": nbr_shift,
        "cell_shift": cell_shift,
    }


def add_random_hamiltonian_targets(rng, crystal, nao_max=14, herm=True,
                                   ham_type="openmx"):
    """Attach random Hermitian-consistent Hon/Hoff/H0/S targets, zeroed
    outside each species' valid orbitals."""
    table = get_basis_set(ham_type, nao_max).orbital_mask_table
    n = crystal["z"].shape[0]
    e = crystal["edge_index"].shape[1]
    nao2 = nao_max * nao_max
    z = crystal["z"]
    src, dst = crystal["edge_index"]
    on_mask = table[z][:, :, None] * table[z][:, None, :]
    off_mask = table[z[src]][:, :, None] * table[z[dst]][:, None, :]

    Hon = rng.normal(size=(n, nao_max, nao_max)) * on_mask
    Hon = 0.5 * (Hon + Hon.transpose(0, 2, 1))
    Hoff = rng.normal(size=(e, nao_max, nao_max)) * off_mask
    if herm:
        inv = crystal["inv_edge_idx"]
        Hoff = 0.5 * (Hoff + Hoff[inv].transpose(0, 2, 1))
    Son = np.stack([np.eye(nao_max)] * n) * on_mask
    Soff = (0.05 / max(e, 1)) * rng.normal(size=(e, nao_max, nao_max)) * off_mask
    if herm:
        Soff = 0.5 * (Soff + Soff[inv].transpose(0, 2, 1))

    crystal = dict(crystal)
    crystal.update(
        Hon=Hon.reshape(n, nao2), Hoff=Hoff.reshape(e, nao2),
        Hon0=np.zeros((n, nao2)), Hoff0=np.zeros((e, nao2)),
        Son=Son.reshape(n, nao2), Soff=Soff.reshape(e, nao2),
    )
    return crystal


def bench_crystal(n_atoms=512, cutoff=6.0, nao_max=19, seed=0):
    """The ``bench.py`` crystal: 512 atoms of C/Si in a 23 A cell, seed 0."""
    rng = np.random.default_rng(seed)
    cell_size = {96: 13.0, 256: 18.0, 512: 23.0}.get(n_atoms, 18.0)
    c = make_crystal(rng, n_atoms=n_atoms, species=(6, 14), cell_size=cell_size,
                     cutoff=cutoff)
    return add_random_hamiltonian_targets(rng, c, nao_max=nao_max)
