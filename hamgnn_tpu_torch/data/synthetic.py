"""Synthetic crystals with random Hamiltonian targets, for smoke runs and
benchmarks, and the fields of the SOC head (``add_random_soc_targets``) and
of the magnetic head (``add_random_spin_targets``).

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


def real_sh_L(l: int) -> np.ndarray:
    """Angular-momentum matrices of shell l in the real spherical-harmonic
    basis (m = -l..l), which are purely imaginary: (2l+1, 2l+1, 3), their
    imaginary parts for (x, y, z)."""
    d = 2 * l + 1
    m = np.arange(-l, l + 1)
    Lz = np.diag(m).astype(complex)
    lp = np.zeros((d, d), complex)   # L+ |l, m> = sqrt(l(l+1) - m(m+1)) |l, m+1>
    for i, mm in enumerate(m[:-1]):
        lp[i + 1, i] = np.sqrt(l * (l + 1) - mm * (mm + 1))
    lm = lp.conj().T
    Lx = 0.5 * (lp + lm)
    Ly = (lp - lm) / 2j
    # complex -> real basis (rows: real index -l..l)
    U = np.zeros((d, d), complex)
    U[l, l] = 1.0
    for mm in range(1, l + 1):
        U[l + mm, l + mm] = (-1) ** mm / np.sqrt(2)
        U[l + mm, l - mm] = 1 / np.sqrt(2)
        U[l - mm, l + mm] = -1j * (-1) ** mm / np.sqrt(2)
        U[l - mm, l - mm] = 1j / np.sqrt(2)
    out = np.zeros((d, d, 3))
    for k, Lc in enumerate((Lx, Ly, Lz)):
        Lr = U @ Lc @ U.conj().T
        if np.abs(Lr.real).max() >= 1e-12:
            raise ArithmeticError(f"L of shell {l} is not imaginary in the real basis")
        out[:, :, k] = Lr.imag
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


def add_random_soc_targets(rng, crystal, nao_max=14, ham_type="openmx", ksi_amp=0.05):
    """Attach the SOC head's fields to a crystal of
    ``add_random_hamiltonian_targets``: spinor targets ``Hon``/``iHon``
    (n, (2 nao)^2) and ``Hoff``/``iHoff`` (e, (2 nao)^2) in the so3 form (its
    spatial ``Hon``/``Hoff`` on both spin-diagonal blocks, block-constant
    per-species ksi times L in the spin-coupling entries), zero H0 of the
    same shapes, and ``Lon``/``Loff`` (rows, nao^2, 3), the shells' L
    matrices on each species pair's valid orbitals.  ``Son``/``Soff`` stay
    the spatial (rows, nao^2) overlap."""
    basis = get_basis_set(ham_type, nao_max)
    nao = nao_max
    table = basis.orbital_mask_table
    z = crystal["z"]
    src, dst = crystal["edge_index"]
    inv = crystal["inv_edge_idx"]
    n, e = z.shape[0], src.shape[0]
    on_mask = table[z][:, :, None] * table[z][:, None, :]
    off_mask = table[z[src]][:, :, None] * table[z[dst]][:, None, :]
    L = angular_momentum_matrices(basis)
    Lon = L[None] * on_mask[..., None]
    Loff = L[None] * off_mask[..., None]

    bounds = np.cumsum([0] + [ir.dim for _, ir in basis.orbital_irreps])
    slot = np.repeat(np.arange(len(bounds) - 1), np.diff(bounds))
    if basis.index_change is not None:
        slot = slot[basis.index_change]
    ksi = {}
    for zz in np.unique(z).tolist():
        kb = ksi_amp * rng.uniform(0.4, 1.0, (len(bounds) - 1,) * 2)
        ksi[zz] = 0.5 * (kb + kb.T)[slot[:, None], slot[None, :]]
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
    crystal = dict(crystal)
    big = (2 * nao) ** 2
    crystal.update(
        Hon=hr_on, Hoff=hr_off, iHon=hi_on, iHoff=hi_off,
        Hon0=np.zeros((n, big)), Hoff0=np.zeros((e, big)),
        iHon0=np.zeros((n, big)), iHoff0=np.zeros((e, big)),
        Lon=Lon.reshape(n, nao * nao, 3), Loff=Loff.reshape(e, nao * nao, 3))
    return crystal


SPIN_MODES = ("collinear", "noncollinear", "spinsoc")


def add_random_spin_targets(rng, crystal, mode, nao_max=14, ham_type="openmx",
                            split=0.1, weak_moment=0.2):
    """Attach the magnetic head's fields to a crystal of
    ``add_random_hamiltonian_targets``: ``spin_vec`` / ``spin_length`` and
    spin-resolved targets.  One atom in eight (at least one) gets a moment
    of ``weak_moment``, below the configs' ``minMagneticMoment`` of 0.5; the
    others a moment of length 1: +/-z when ``mode`` is ``collinear`` (as
    ``hamgnn_tpu.tools.sk_dataset`` draws them), a random direction else.

    The spin part of each target block is ``sum_k A_k (x) sigma_k`` with real
    A_k = ``split`` * a random block * the spins of the magnetic atoms it
    joins, symmetric through the inverse edge, so every block stays
    Hermitian.  ``collinear``: ``Hon`` / ``Hoff`` (rows, 2, nao^2), the up
    and down channels ``H +/- A_z``, and zero H0 of that shape.
    ``noncollinear``: ``Hon`` / ``Hoff`` (real) and ``iHon`` / ``iHoff``
    (imaginary), (rows, (2 nao)^2), the spatial ``Hon`` / ``Hoff`` on the
    spin-diagonal blocks plus the spin part; ``spinsoc``: the same on the
    SOC spinor targets of ``add_random_soc_targets``.  Both carry zero
    ``Hon0`` / ``Hoff0`` / ``iHon0`` / ``iHoff0`` of that shape.  ``Son`` /
    ``Soff`` stay the spatial (rows, nao^2) overlap."""
    if mode not in SPIN_MODES:
        raise ValueError(f"mode {mode!r}: one of {SPIN_MODES}")
    nao = nao_max
    table = get_basis_set(ham_type, nao_max).orbital_mask_table
    z = crystal["z"]
    src, dst = crystal["edge_index"]
    inv = crystal["inv_edge_idx"]
    n, e = z.shape[0], src.shape[0]
    on_mask = table[z][:, :, None] * table[z][:, None, :]
    off_mask = table[z[src]][:, :, None] * table[z[dst]][:, None, :]

    if mode == "collinear":
        direction = np.zeros((n, 3))
        direction[:, 2] = rng.choice([-1.0, 1.0], size=n)
    else:
        direction = rng.normal(size=(n, 3))
        direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    length = np.ones(n)
    length[rng.choice(n, size=max(1, n // 8), replace=False)] = weak_moment
    spin = direction * length[:, None]
    moment = spin * (length > 0.5)[:, None]      # the spins the head sees

    comps = range(2, 3) if mode == "collinear" else range(3)
    a_on, a_off = {}, {}
    for k in comps:
        r_on = rng.normal(size=(n, nao, nao))
        r_on = 0.5 * (r_on + r_on.transpose(0, 2, 1))
        a_on[k] = split * r_on * moment[:, k, None, None] * on_mask
        r_off = rng.normal(size=(e, nao, nao)) \
            * 0.5 * (moment[src, k] + moment[dst, k])[:, None, None]
        a_off[k] = split * 0.5 * (r_off + r_off[inv].transpose(0, 2, 1)) * off_mask

    crystal = dict(crystal, spin_vec=spin, spin_length=length)
    if mode == "collinear":
        def channels(h, a):
            h = h.reshape(a.shape)
            return np.stack([h + a, h - a], 1).reshape(len(h), 2, nao * nao)

        crystal.update(Hon=channels(crystal["Hon"], a_on[2]),
                       Hoff=channels(crystal["Hoff"], a_off[2]),
                       Hon0=np.zeros((n, 2, nao * nao)), Hoff0=np.zeros((e, 2, nao * nao)))
        return crystal

    if mode == "spinsoc":
        crystal = add_random_soc_targets(rng, crystal, nao_max=nao, ham_type=ham_type)
        base = {key: crystal[key].reshape(-1, 2, nao, 2, nao)
                for key in ("Hon", "Hoff", "iHon", "iHoff")}
    else:
        eye = np.eye(2)[None, :, None, :, None]
        base = {"Hon": crystal["Hon"].reshape(n, 1, nao, 1, nao) * eye,
                "Hoff": crystal["Hoff"].reshape(e, 1, nao, 1, nao) * eye,
                "iHon": np.zeros((n, 2, nao, 2, nao)), "iHoff": np.zeros((e, 2, nao, 2, nao))}
    # the Pauli matrices' real (x, z) and imaginary (y) parts
    sig_re = {0: np.array([[0, 1], [1, 0]]), 2: np.array([[1, 0], [0, -1]])}
    sig_im = {1: np.array([[0, -1], [1, 0]])}
    big = (2 * nao) ** 2
    for where, a in (("on", a_on), ("off", a_off)):
        for key, sig in ((f"H{where}", sig_re), (f"iH{where}", sig_im)):
            term = sum(np.einsum("nij,op->noipj", a[k], m) for k, m in sig.items())
            crystal[key] = (base[key] + term).reshape(-1, big)
    for key in ("Hon0", "Hoff0", "iHon0", "iHoff0"):
        crystal[key] = np.zeros((n if key.endswith("on0") else e, big))
    return crystal


def bench_crystal(n_atoms=512, cutoff=6.0, nao_max=19, seed=0):
    """The ``bench.py`` crystal: 512 atoms of C/Si in a 23 A cell, seed 0."""
    rng = np.random.default_rng(seed)
    cell_size = {96: 13.0, 256: 18.0, 512: 23.0}.get(n_atoms, 18.0)
    c = make_crystal(rng, n_atoms=n_atoms, species=(6, 14), cell_size=cell_size,
                     cutoff=cutoff)
    return add_random_hamiltonian_targets(rng, c, nao_max=nao_max)
