"""The one generator of the benchmark's traffic: seeded crystals with random
Hamiltonian targets, as a traffic file's parameters ask for them.

Frozen copies of ``hamgnn_tpu_torch/data/synthetic.py`` (``make_crystal``,
``add_random_hamiltonian_targets``, ``add_random_soc_targets``, ``real_sh_L``,
``angular_momentum_matrices``) and of ``hamgnn_tpu_torch/data/neighborlist.py``
(``neighbor_list_pbc``, ``inverse_edge_index``), drawing the same numbers
from the same numpy generator, except that the targets are drawn and kept in
float32 (``standard_normal(dtype=float32)``), the type the program's batches
take: that halves the host memory of a set and the time to make it.

A crystal is drawn from ``numpy.random.default_rng([seed, seed_offset, i])``:
the same seed gives the same set, and each crystal can be made on its own.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from reference.basis import get_basis_set

TARGET_KINDS = ("hamiltonian", "soc")


def neighbor_list_pbc(pos, cell, cutoff):
    """Edges within ``cutoff`` under periodic boundaries: (edge_index (2, E),
    cell_shift (E, 3), nbr_shift (E, 3)); vector = pos[j] + shift - pos[i]."""
    pos = np.asarray(pos, dtype=np.float64)
    cell = np.asarray(cell, dtype=np.float64).reshape(3, 3)
    heights = 1.0 / np.linalg.norm(np.linalg.inv(cell), axis=1)
    nx, ny, nz = (int(v) for v in np.ceil(cutoff / heights).astype(int))
    shifts = np.array([(sx, sy, sz) for sx in range(-nx, nx + 1)
                       for sy in range(-ny, ny + 1) for sz in range(-nz, nz + 1)],
                      dtype=np.int64)
    src_all, dst_all, shift_all = [], [], []
    for S in shifts:
        disp = pos[None, :, :] + (S.astype(np.float64) @ cell)[None, None, :] - pos[:, None, :]
        hit = np.sum(disp * disp, axis=-1) <= cutoff * cutoff
        if not S.any():
            np.fill_diagonal(hit, False)
        ii, jj = np.nonzero(hit)
        if len(ii):
            src_all.append(ii)
            dst_all.append(jj)
            shift_all.append(np.broadcast_to(S, (len(ii), 3)))
    edge_index = np.stack([np.concatenate(src_all), np.concatenate(dst_all)])
    cell_shift = np.concatenate(shift_all)
    return edge_index, cell_shift, cell_shift.astype(np.float64) @ cell


def inverse_edge_index(edge_index, cell_shift):
    """Index of each edge's inverse (dst, src, -shift); raises if missing."""
    key = {}
    src, dst = edge_index
    for e in range(edge_index.shape[1]):
        key[(int(src[e]), int(dst[e]), tuple(int(v) for v in cell_shift[e]))] = e
    inv = np.full(edge_index.shape[1], -1, dtype=np.int64)
    for e in range(edge_index.shape[1]):
        inv[e] = key.get((int(dst[e]), int(src[e]), tuple(-int(v) for v in cell_shift[e])), -1)
    if np.any(inv < 0):
        raise RuntimeError("some edges lack an inverse edge")
    return inv


def make_crystal(rng, n_atoms, species, cell_size, cutoff):
    """Random periodic crystal dict with edges from a PBC radius graph."""
    cell = np.eye(3) * cell_size + rng.normal(scale=0.1, size=(3, 3))
    frac = rng.uniform(size=(n_atoms, 3))
    pos = frac @ cell
    z = rng.choice(species, size=n_atoms)
    edge_index, cell_shift, nbr_shift = neighbor_list_pbc(pos, cell, cutoff)
    return {"z": z.astype(np.int64), "pos": pos, "cell": cell[None],
            "edge_index": edge_index, "inv_edge_idx": inverse_edge_index(edge_index, cell_shift),
            "nbr_shift": nbr_shift, "cell_shift": cell_shift}


def add_random_hamiltonian_targets(rng, crystal, nao_max, ham_type="openmx"):
    """Random Hermitian-consistent Hon/Hoff/H0/S targets, zeroed outside each
    species' valid orbitals."""
    table = get_basis_set(ham_type, nao_max).orbital_mask_table
    n = crystal["z"].shape[0]
    e = crystal["edge_index"].shape[1]
    nao2 = nao_max * nao_max
    f32 = np.float32
    z = crystal["z"]
    src, dst = crystal["edge_index"]
    inv = crystal["inv_edge_idx"]
    on_mask = table[z][:, :, None] * table[z][:, None, :]
    off_mask = table[z[src]][:, :, None] * table[z[dst]][:, None, :]

    Hon = rng.standard_normal(size=(n, nao_max, nao_max), dtype=f32) * on_mask
    Hon = f32(0.5) * (Hon + Hon.transpose(0, 2, 1))
    Hoff = rng.standard_normal(size=(e, nao_max, nao_max), dtype=f32) * off_mask
    Hoff = f32(0.5) * (Hoff + Hoff[inv].transpose(0, 2, 1))
    Son = np.eye(nao_max, dtype=f32)[None] * on_mask
    Soff = f32(0.05 / max(e, 1)) * rng.standard_normal(size=(e, nao_max, nao_max),
                                                         dtype=f32) * off_mask
    Soff = f32(0.5) * (Soff + Soff[inv].transpose(0, 2, 1))
    return dict(crystal, Hon=Hon.reshape(n, nao2), Hoff=Hoff.reshape(e, nao2),
                Hon0=np.zeros((n, nao2), f32), Hoff0=np.zeros((e, nao2), f32),
                Son=Son.reshape(n, nao2), Soff=Soff.reshape(e, nao2))


def real_sh_L(l: int) -> np.ndarray:
    """Angular-momentum matrices of shell l in the real spherical-harmonic
    basis: (2l+1, 2l+1, 3), the imaginary parts of (Lx, Ly, Lz)."""
    d = 2 * l + 1
    m = np.arange(-l, l + 1)
    Lz = np.diag(m).astype(complex)
    lp = np.zeros((d, d), complex)
    for i, mm in enumerate(m[:-1]):
        lp[i + 1, i] = np.sqrt(l * (l + 1) - mm * (mm + 1))
    lm = lp.conj().T
    Lx = 0.5 * (lp + lm)
    Ly = (lp - lm) / 2j
    U = np.zeros((d, d), complex)
    U[l, l] = 1.0
    for mm in range(1, l + 1):
        U[l + mm, l + mm] = (-1) ** mm / np.sqrt(2)
        U[l + mm, l - mm] = 1 / np.sqrt(2)
        U[l - mm, l + mm] = -1j * (-1) ** mm / np.sqrt(2)
        U[l - mm, l - mm] = 1j / np.sqrt(2)
    out = np.zeros((d, d, 3))
    for k, Lc in enumerate((Lx, Ly, Lz)):
        out[:, :, k] = (U @ Lc @ U.conj().T).imag
    return out


def angular_momentum_matrices(basis) -> np.ndarray:
    """(nao, nao, 3) block-diagonal angular-momentum matrices of the basis'
    shells, in its DFT orbital order."""
    nao = basis.nao_max
    L = np.zeros((nao, nao, 3))
    o = 0
    for _, ir in basis.orbital_irreps:
        if ir.l > 0:
            L[o : o + ir.dim, o : o + ir.dim] = real_sh_L(ir.l)
        o += ir.dim
    perm = basis.index_change
    return L[np.ix_(perm, perm)] if perm is not None else L


def add_random_soc_targets(rng, crystal, nao_max, ham_type="openmx", ksi_amp=0.05):
    """The SOC head's fields on a crystal of ``add_random_hamiltonian_targets``:
    spinor ``Hon``/``iHon``/``Hoff``/``iHoff`` ((2 nao)^2 a row) in the so3
    form, zero H0 of those shapes, and ``Lon``/``Loff`` (rows, nao^2, 3)."""
    basis = get_basis_set(ham_type, nao_max)
    nao = nao_max
    table = basis.orbital_mask_table
    z = crystal["z"]
    src, dst = crystal["edge_index"]
    inv = crystal["inv_edge_idx"]
    n, e = z.shape[0], src.shape[0]
    on_mask = table[z][:, :, None] * table[z][:, None, :]
    off_mask = table[z[src]][:, :, None] * table[z[dst]][:, None, :]
    L = angular_momentum_matrices(basis).astype(np.float32)
    Lon = L[None] * on_mask[..., None]
    Loff = L[None] * off_mask[..., None]

    bounds = np.cumsum([0] + [ir.dim for _, ir in basis.orbital_irreps])
    slot = np.repeat(np.arange(len(bounds) - 1), np.diff(bounds))
    if basis.index_change is not None:
        slot = slot[basis.index_change]
    ksi = {}
    for zz in np.unique(z).tolist():
        kb = ksi_amp * rng.uniform(0.4, 1.0, (len(bounds) - 1,) * 2)
        ksi[zz] = (0.5 * (kb + kb.T)[slot[:, None], slot[None, :]]).astype(np.float32)
    ksi_on = np.stack([ksi[zz] for zz in z.tolist()])
    ksi_off = 0.5 * (np.stack([ksi[zz] for zz in z[src].tolist()])
                     + np.stack([ksi[zz] for zz in z[dst].tolist()]))

    def assemble(hs, k, Lm, mate):
        def anti(x):
            return 0.5 * (x - mate(x).transpose(0, 2, 1))

        kx, ky, kz = (anti(k * Lm[..., a]) for a in range(3))
        hr = np.concatenate([np.concatenate([hs, ky], 2), np.concatenate([ky, hs], 2)], 1)
        hi = np.concatenate([np.concatenate([kz, kx], 2), np.concatenate([-kx, -kz], 2)], 1)
        return hr.reshape(hs.shape[0], -1), hi.reshape(hs.shape[0], -1)

    hr_on, hi_on = assemble(crystal["Hon"].reshape(n, nao, nao), ksi_on, Lon, lambda x: x)
    hr_off, hi_off = assemble(crystal["Hoff"].reshape(e, nao, nao), ksi_off, Loff,
                              lambda x: x[inv])
    big = (2 * nao) ** 2
    f32 = np.float32
    return dict(crystal, Hon=hr_on, Hoff=hr_off, iHon=hi_on, iHoff=hi_off,
                Hon0=np.zeros((n, big), f32), Hoff0=np.zeros((e, big), f32),
                iHon0=np.zeros((n, big), f32), iHoff0=np.zeros((e, big), f32),
                Lon=Lon.reshape(n, nao * nao, 3), Loff=Loff.reshape(e, nao * nao, 3))


def make_one(traffic: Dict, targets: Dict, seed: int, i: int) -> Dict[str, np.ndarray]:
    """Crystal ``i`` of a traffic file for ``seed``.

    ``traffic``: ``atoms``, ``cell_A``, ``species``, ``neighbour_cutoff_A``,
    ``seed_offset``.  ``targets`` (from the configuration): ``kind`` (one of
    ``TARGET_KINDS``), ``ham_type``, ``nao_max``."""
    if targets["kind"] not in TARGET_KINDS:
        raise ValueError(f"target kind {targets['kind']!r}: one of {TARGET_KINDS}")
    rng = np.random.default_rng([int(seed), int(traffic["seed_offset"]), int(i)])
    c = make_crystal(rng, int(traffic["atoms"]), tuple(traffic["species"]),
                     float(traffic["cell_A"]), float(traffic["neighbour_cutoff_A"]))
    c = add_random_hamiltonian_targets(rng, c, targets["nao_max"], targets["ham_type"])
    if targets["kind"] == "soc":
        c = add_random_soc_targets(rng, c, targets["nao_max"], targets["ham_type"])
    return c


def make_set(traffic: Dict, targets: Dict, seed: int) -> List[Dict[str, np.ndarray]]:
    """All ``traffic["crystals"]`` crystals of a traffic file for ``seed``."""
    return [make_one(traffic, targets, seed, i) for i in range(int(traffic["crystals"]))]
