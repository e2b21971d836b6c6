"""Synthetic Slater-Koster DFT dataset generator, the port's counterpart of
``hamgnn_tpu/tools/sk_dataset.py`` (host only: numpy and CPU float64 torch).

    python -m hamgnn_tpu_torch.tools.sk_dataset --out datasets/sk_v1 --band-set
        [--soc] [--format openmx|siesta|abacus]
    python -m hamgnn_tpu_torch.tools.sk_dataset collinear|noncollinear|spinsoc --out DIR

Produces physically consistent tight-binding Hamiltonians and overlaps for
rattled Si / C (diamond) and SiC (zincblende) crystals and writes genuine
SCFOUT v3 binaries (+ ``overlap.scfout`` H0 files and OpenMX ``.dat``
inputs), SIESTA ``.HSX`` + FDF or ABACUS CSR + STRU containers, so the data
flows through the port's own readers:

    sk_dataset -> openmx.scfout -> graph_data_gen (parse_scfout + pack_crystal)
               -> graph_data.npz -> cli fit -> band_cal

The teacher is a generalized two-center Slater-Koster model expressed in the
irreps machinery: for each orbital-pair path (l_i, l_j, L) the block
contribution is ``V_p(r, z_i, z_j) * Y_L(n)`` assembled with the exact
``sqrt(2L+1) w3j`` merge matrix of the output head, plus an environment-
dependent (crystal-field) on-site term, so the targets are exactly
E(3)-equivariant in the model's convention.  H = H0 + dH with independent
parameter sets.  The spin sets (collinear, non-collinear, spin-constrained
SOC) add Heisenberg terms computed by the magnetic head's own
``heisenberg_terms``.

Everything is computed in float64 (the JAX package's teacher evaluates its
spherical harmonics and Heisenberg terms in float32), and all randomness is
seeded: the draws, geometry and edges equal the JAX teacher's, element for
element, and a dataset regenerates bit-identically.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..data.dataset import save_graph_npz
from ..data.graph import pad_and_batch
from ..data.neighborlist import inverse_edge_index, neighbor_list_pbc
from ..e3.spherical import spherical_harmonics
from ..interfaces.abacus import write_abacus_csr, write_stru
from ..interfaces.scfout_writer import write_scfout
from ..interfaces.siesta import write_fdf, write_hsx
from ..models.basis import get_basis_set
from ..models.output import _merge_reorder_matrix
from ..models.spin import _rank0_merge_matrix, _rank2_merge_matrix, heisenberg_terms

AU2ANG = 0.5291772490000065

# synthetic "PAO" radii (Bohr); pair cutoff = r_i + r_j
PAO_RADIUS = {14: 4.5, 6: 3.4}

# lattice constants (Angstrom)
A_SI, A_C, A_SIC = 5.431, 3.567, 4.360


def _fcc_primitive(a_ang: float, z1: int, z2: int):
    """Two-atom diamond/zincblende primitive cell, in Bohr."""
    a = a_ang / AU2ANG
    cell = 0.5 * a * np.array([[0.0, 1, 1], [1, 0, 1], [1, 1, 0]])
    pos = np.array([[0.0, 0, 0], [0.25, 0.25, 0.25]]) @ cell
    return cell, pos, np.array([z1, z2], np.int64)


@dataclass
class SKParams:
    """Seeded teacher parameters for one (H-like or S-like) channel."""
    A: np.ndarray          # (P,) path amplitudes
    rho: np.ndarray        # (P,) decay lengths (Bohr)
    kappa: np.ndarray      # (P,) crystal-field strengths
    omega: Dict[int, np.ndarray]   # z -> (P,) static on-site (L=0 paths only)
    species: Dict[int, np.ndarray]  # z -> (n_slots,) per-orbital-slot factor


class SKTeacher:
    """Generalized Slater-Koster two-center model over the basis irreps."""

    def __init__(self, ham_type: str = "openmx", nao_max: int = 14,
                 seed: int = 0, amp: float = 0.6, s_amp: float = 0.08,
                 zs: Tuple[int, ...] = (14, 6)):
        self.basis = get_basis_set(ham_type, nao_max)
        self.nao = nao_max
        self.M = _merge_reorder_matrix(ham_type, nao_max)  # (D, nao^2)
        self.D = self.M.shape[0]
        # path table in the exact merge-matrix component order
        self.paths: List[Tuple[int, int, int, int, int, int]] = []
        comp = 0
        slots = list(self.basis.orbital_irreps)
        for i, (_, li) in enumerate(slots):
            for j, (_, lj) in enumerate(slots):
                for L in range(abs(li.l - lj.l), li.l + lj.l + 1):
                    self.paths.append((i, j, li.l, lj.l, L, comp))
                    comp += 2 * L + 1
        assert comp == self.D
        self.n_slots = len(slots)
        self.lmax = 2 * max(ir.l for _, ir in slots)
        rng = np.random.RandomState(seed)

        # A two-center term V(r)*Y_L(n) is O(3)-equivariant in the orbital
        # channel (l1, l2, L) ONLY when l1+l2+L is even (Gaunt selection rule;
        # the channel parity is (-1)^(l1+l2) while Y_L has parity (-1)^L).
        # Real Slater-Koster blocks obey this; paths violating it would be
        # provably unfittable by an equivariant model (measured as a hard
        # ~7.6e-4 Ha MAE floor when they were included).
        natural = np.array([(l1 + l2 + L) % 2 == 0
                            for (_i, _j, l1, l2, L, _o) in self.paths])

        def draw(scale_A):
            P = len(self.paths)
            A = scale_A * rng.randn(P) * natural
            rho = rng.uniform(1.8, 2.6, P)
            kappa = 0.08 * scale_A / amp * rng.randn(P) * natural
            omega, species = {}, {}
            for z in zs:
                om = np.zeros(P)
                for p, (i, j, l1, l2, L, _) in enumerate(self.paths):
                    if L == 0:
                        # shell energies (i == j) and weaker inter-shell mixing
                        om[p] = rng.uniform(-1.0, 0.6) if i == j \
                            else 0.2 * rng.randn()
                omega[z] = om * (scale_A / amp)
                species[z] = rng.uniform(0.7, 1.3, self.n_slots)
            return SKParams(A, rho, kappa, omega, species)

        # H = H0 + dH: independent parameter draws; S has its own channel.
        self.h0 = draw(amp)
        self.dh = draw(0.15 * amp)
        self.s = draw(s_amp)
        for z in zs:                     # overlap has no on-site static part
            self.s.omega[z][:] = 0.0
        self.s.kappa[:] = 0.0            # ... and no crystal field
        # steeper overlap decay keeps S(k) safely positive definite even for
        # the short C-C bonds (many neighbors inside the pair cutoff)
        self.s.rho = np.random.RandomState(seed + 101).uniform(
            1.1, 1.4, len(self.paths))

    # -- component builders ------------------------------------------------
    def _ylm(self, vec: np.ndarray) -> np.ndarray:
        # float64 on the host: the blocks are data, made the same wherever
        ls = list(range(self.lmax + 1))
        v = torch.as_tensor(np.asarray(vec, np.float64), dtype=torch.float64)
        return spherical_harmonics(ls, v, normalize=True).numpy()

    def _pair_cutoff(self, zi, zj):
        return np.array([PAO_RADIUS[int(a)] + PAO_RADIUS[int(b)]
                         for a, b in zip(zi, zj)])

    def _radial(self, prm: SKParams, r, zi, zj):
        """(E, P) radial factors incl. species slots and smooth cutoff."""
        rc = self._pair_cutoff(zi, zj)
        fc = np.where(r < rc, 0.5 * (np.cos(np.pi * r / rc) + 1.0), 0.0)
        out = np.zeros((r.shape[0], len(self.paths)))
        r0 = 0.45 * rc  # species-pair reference distance ~ 1NN bond length
        for p, (i, j, l1, l2, L, _) in enumerate(self.paths):
            sp_i = np.array([prm.species[int(z)][i] for z in zi])
            sp_j = np.array([prm.species[int(z)][j] for z in zj])
            out[:, p] = (prm.A[p] * sp_i * sp_j
                         * np.exp((r0 - r) / prm.rho[p]) * fc)
        return out

    def _assemble(self, comps: np.ndarray) -> np.ndarray:
        """(N, D) components -> (N, nao, nao) dense DFT-ordered blocks."""
        return (comps @ self.M).reshape(-1, self.nao, self.nao)

    def offsite(self, prm: SKParams, vec, r, zi, zj) -> np.ndarray:
        Y = self._ylm(vec)
        rad = self._radial(prm, r, zi, zj)
        comps = np.zeros((r.shape[0], self.D))
        for p, (_, _, _, _, L, ofs) in enumerate(self.paths):
            comps[:, ofs:ofs + 2 * L + 1] = rad[:, p:p + 1] * Y[:, L * L:(L + 1) * (L + 1)]
        return self._assemble(comps)

    def onsite(self, prm: SKParams, z, src, vec, r, zj) -> np.ndarray:
        """Static shell terms + crystal field summed over neighbor edges."""
        n = z.shape[0]
        comps = np.zeros((n, self.D))
        for p, (i, j, l1, l2, L, ofs) in enumerate(self.paths):
            if L == 0:
                comps[:, ofs] += np.array([prm.omega[int(zz)][p] for zz in z])
        if np.any(prm.kappa != 0.0):
            Y = self._ylm(vec)
            rc = self._pair_cutoff(z[src], zj)
            fc = np.where(r < rc, 0.5 * (np.cos(np.pi * r / rc) + 1.0), 0.0)
            g = np.exp((0.45 * rc - r) / 2.0) * fc
            for p, (i, j, l1, l2, L, ofs) in enumerate(self.paths):
                contrib = (prm.kappa[p] * g)[:, None] * Y[:, L * L:(L + 1) * (L + 1)]
                for m in range(2 * L + 1):
                    comps[:, ofs + m] += np.bincount(src, contrib[:, m], minlength=n)
        return self._assemble(comps)

    # -- full crystal ------------------------------------------------------
    def build(self, z, pos, cell):
        """Teacher H0/H/S blocks for a crystal (positions/cell in Bohr).

        Returns dict with edge tables and per-atom/per-edge valid-orbital
        blocks ready for :func:`write_scfout`.
        """
        radii = np.array([PAO_RADIUS[int(v)] for v in z])
        edge_index, cell_shift, nbr_shift = neighbor_list_pbc(pos, cell, radii)
        inv = inverse_edge_index(edge_index, cell_shift)
        src, dst = edge_index
        vec = pos[dst] + nbr_shift - pos[src]
        r = np.linalg.norm(vec, axis=1)

        def channel(prm, with_onsite=True, identity_onsite=False):
            off = self.offsite(prm, vec, r, z[src], z[dst])
            off = 0.5 * (off + np.transpose(off[inv], (0, 2, 1)))
            if identity_onsite:
                on = np.broadcast_to(np.eye(self.nao), (z.shape[0], self.nao, self.nao)).copy()
            else:
                on = self.onsite(prm, z, src, vec, r, z[dst])
                on = 0.5 * (on + np.transpose(on, (0, 2, 1)))
            return on, off

        H0on, H0off = channel(self.h0)
        dHon, dHoff = channel(self.dh)
        Son, Soff = channel(self.s, identity_onsite=True)
        Hon, Hoff = H0on + dHon, H0off + dHoff

        bd = self.basis.basis_def

        def valid(blocks, zrow, zcol):
            return [np.ascontiguousarray(
                b[np.ix_(bd[int(zr)], bd[int(zc)])])
                for b, zr, zc in zip(blocks, zrow, zcol)]

        num_orbs = np.array([len(bd[int(v)]) for v in z])
        nval = self.basis.num_valence_table
        return {
            "edge_src": src, "edge_dst": dst, "cell_shift": cell_shift,
            "num_orbs": num_orbs,
            "Hon": valid(Hon, z, z), "Hoff": valid(Hoff, z[src], z[dst]),
            "H0on": valid(H0on, z, z), "H0off": valid(H0off, z[src], z[dst]),
            "Son": valid(Son, z, z), "Soff": valid(Soff, z[src], z[dst]),
            "valence": float(sum(nval[int(v)] for v in z)),
        }


def min_overlap_eig(data, z, kpts=8, seed=0) -> float:
    """Smallest eigenvalue of S(k) over random k (positive-definiteness check)."""
    rng = np.random.RandomState(seed)
    norbs = data["num_orbs"]
    offs = np.concatenate([[0], np.cumsum(norbs)])
    ntot = int(offs[-1])
    src, dst, shift = data["edge_src"], data["edge_dst"], data["cell_shift"]
    lo = np.inf
    for k in rng.rand(kpts, 3):
        S = np.zeros((ntot, ntot), complex)
        for a in range(len(norbs)):
            S[offs[a]:offs[a + 1], offs[a]:offs[a + 1]] += data["Son"][a]
        for e in range(src.shape[0]):
            ph = np.exp(2j * np.pi * np.dot(k, shift[e]))
            S[offs[src[e]]:offs[src[e] + 1], offs[dst[e]]:offs[dst[e] + 1]] += \
                ph * data["Soff"][e]
        lo = min(lo, float(np.linalg.eigvalsh(0.5 * (S + S.conj().T)).min()))
    return lo


_Z_SYMBOL = {14: "Si", 6: "C"}


def _real_sh_L(l: int) -> np.ndarray:
    """Im part of the angular-momentum matrices in the REAL spherical-harmonic
    basis, wiki m-order (-l..l): L_real = U L_complex U^dagger is purely
    imaginary; returns (2l+1, 2l+1, 3) with the imaginary parts (x, y, z)."""
    d = 2 * l + 1
    m = np.arange(-l, l + 1)
    Lz = np.diag(m).astype(complex)
    lp = np.zeros((d, d), complex)   # L+ |l,m> = sqrt(l(l+1)-m(m+1)) |l,m+1>
    for i, mm in enumerate(m[:-1]):
        lp[i + 1, i] = np.sqrt(l * (l + 1) - mm * (mm + 1))
    lm = lp.conj().T
    Lx = 0.5 * (lp + lm)
    Ly = (lp - lm) / (2j)
    # complex -> real transform (rows: real index -l..l)
    U = np.zeros((d, d), complex)
    U[l, l] = 1.0
    for mm in range(1, l + 1):
        U[l + mm, l + mm] = (-1) ** mm / np.sqrt(2)   # cos-type
        U[l + mm, l - mm] = 1 / np.sqrt(2)
        U[l - mm, l + mm] = -1j * (-1) ** mm / np.sqrt(2)  # sin-type
        U[l - mm, l - mm] = 1j / np.sqrt(2)
    out = np.zeros((d, d, 3))
    for k, Lc in enumerate((Lx, Ly, Lz)):
        Lr = U @ Lc @ U.conj().T
        assert np.abs(Lr.real).max() < 1e-12, "real part must vanish"
        out[:, :, k] = Lr.imag
    return out


class SOCTerms:
    """On-site atomic SOC in the model's so3 ksi*L form: exact shell
    angular-momentum matrices (DFT orbital order) and block-constant
    per-species ksi couplings — exactly representable by HamGNNSOCOut
    (models/soc.py so3 branch)."""

    def __init__(self, basis, seed: int = 0, amp: float = 0.05,
                 zs=(14, 6)):
        self.nao = basis.nao_max
        rng = np.random.RandomState(seed + 77)
        slots = list(basis.orbital_irreps)
        # internal (wiki-order) block-diagonal L, then permute to DFT order
        L_int = np.zeros((self.nao, self.nao, 3))
        o = 0
        for _, ir in slots:
            dl = ir.dim
            if ir.l > 0:
                L_int[o:o + dl, o:o + dl, :] = _real_sh_L(ir.l)
            o += dl
        perm = basis.index_change
        self.L = L_int[np.ix_(perm, perm)] if perm is not None else L_int
        # block-constant symmetric ksi per species (only l>0 shell pairs
        # couple through L; s-blocks get 0 weight via L anyway)
        self.ksi = {}
        n_slots = len(slots)
        bounds = np.cumsum([0] + [ir.dim for _, ir in slots])
        for zz in zs:
            kb = amp * rng.uniform(0.4, 1.0, (n_slots, n_slots))
            kb = 0.5 * (kb + kb.T)
            k_int = np.zeros((self.nao, self.nao))
            for i in range(n_slots):
                for j in range(n_slots):
                    k_int[bounds[i]:bounds[i + 1], bounds[j]:bounds[j + 1]] = kb[i, j]
            self.ksi[zz] = (k_int[np.ix_(perm, perm)]
                            if perm is not None else k_int)

    def spinor_parts(self, z, Hs_on, Hs_off):
        """Model-exact so3 assembly (on-site SOC only; Loff = 0):
        returns (Hr_on, Hi_on, Hr_off, Hi_off, Lon) full-nao blocks."""
        nao = self.nao
        n = len(Hs_on)
        Lon = np.broadcast_to(self.L, (n, nao, nao, 3)).copy()
        ksi = np.stack([self.ksi[int(zz)] for zz in z])

        def asym(x):
            return 0.5 * (x - np.transpose(x, (0, 2, 1)))

        kx = asym(ksi * Lon[..., 0])
        ky = asym(ksi * Lon[..., 1])
        kz = asym(ksi * Lon[..., 2])
        Hr_on = np.zeros((n, 2 * nao, 2 * nao))
        Hi_on = np.zeros((n, 2 * nao, 2 * nao))
        Hs_on = np.asarray(Hs_on)
        Hr_on[:, :nao, :nao] = Hs_on
        Hr_on[:, nao:, nao:] = Hs_on
        Hr_on[:, :nao, nao:] = ky
        Hr_on[:, nao:, :nao] = ky
        Hi_on[:, :nao, :nao] = kz
        Hi_on[:, nao:, nao:] = -kz
        Hi_on[:, :nao, nao:] = kx
        Hi_on[:, nao:, :nao] = -kx

        e = len(Hs_off)
        Hs_off = np.asarray(Hs_off)
        Hr_off = np.zeros((e, 2 * nao, 2 * nao))
        Hi_off = np.zeros((e, 2 * nao, 2 * nao))
        Hr_off[:, :nao, :nao] = Hs_off
        Hr_off[:, nao:, nao:] = Hs_off
        return Hr_on, Hi_on, Hr_off, Hi_off, Lon


def write_structure_dir_siesta(d: str, teacher: SKTeacher, z, pos, cell
                               ) -> None:
    """Write input.fdf + siesta.HSX + H0.HSX for a crystal (ham_type=siesta).

    The blocks are the teacher's valid-orbital blocks in SIESTA orbital
    order (the merge matrix folds the siesta minus_index signs), so the
    FULL SIESTA pipeline — write_hsx -> parse_hsx/hsx_reader ->
    hsx_to_graph -> pack_crystal_siesta -> training -> band_cal — exercises
    those conventions end to end."""
    os.makedirs(d, exist_ok=True)
    data = teacher.build(z, pos, cell)
    write_fdf(os.path.join(d, "input.fdf"), z=z, pos=pos, cell=cell)
    common = dict(z=z, pos=pos, cell=cell, num_orbs=data["num_orbs"],
                  edge_src=data["edge_src"], edge_dst=data["edge_dst"],
                  cell_shift=data["cell_shift"])
    write_hsx(os.path.join(d, "siesta.HSX"), Hon=data["Hon"],
              Hoff=data["Hoff"], Son=data["Son"], Soff=data["Soff"], **common)
    write_hsx(os.path.join(d, "H0.HSX"), Hon=data["H0on"],
              Hoff=data["H0off"], Son=data["Son"], Soff=data["Soff"], **common)


def write_structure_dir_abacus(d: str, teacher: SKTeacher, z, pos, cell
                               ) -> None:
    """Write STRU + CSR containers for a crystal (ham_type=abacus)."""
    os.makedirs(d, exist_ok=True)
    data = teacher.build(z, pos, cell)
    write_stru(os.path.join(d, "STRU"), z=z, pos=pos, cell=cell)
    write_abacus_csr(
        d, z=z, num_orbs=data["num_orbs"], edge_src=data["edge_src"],
        edge_dst=data["edge_dst"], cell_shift=data["cell_shift"],
        Hon=data["Hon"], Hoff=data["Hoff"], Son=data["Son"],
        Soff=data["Soff"], H0on=data["H0on"], H0off=data["H0off"])


def write_structure_dir(d: str, teacher: SKTeacher, z, pos, cell,
                        soc: "SOCTerms" = None) -> None:
    """Write openmx.dat / openmx.scfout / overlap.scfout (H0) for a crystal.

    With ``soc``, the .scfout files carry SpinP_switch=3 non-collinear data:
    spin components (uu, dd, ud_re, ud_im) + iHks (im_uu, im_dd, 0) and the
    OLP_L angular-momentum matrices, exactly as openmx_postprocess would."""
    os.makedirs(d, exist_ok=True)
    data = teacher.build(z, pos, cell)
    common = dict(
        cell=cell, pos=pos, num_orbs=data["num_orbs"],
        edge_src=data["edge_src"], edge_dst=data["edge_dst"],
        cell_shift=data["cell_shift"],
        Son=data["Son"], Soff=data["Soff"],
        valence_electrons=data["valence"],
    )
    if soc is not None:
        bd = teacher.basis.basis_def
        src, dst = data["edge_src"], data["edge_dst"]

        def full(blocks, zrow, zcol):
            """valid-orbital blocks -> full-nao blocks (zero-padded)."""
            out = np.zeros((len(blocks), teacher.nao, teacher.nao))
            for k, (b, zr, zc) in enumerate(zip(blocks, zrow, zcol)):
                out[k][np.ix_(bd[int(zr)], bd[int(zc)])] = b
            return out

        def spin_valid(Hr, Hi, zrow, zcol, Lon=None):
            """full (2nao)x(2nao) blocks -> scfout spin-component lists of
            valid-orbital blocks."""
            nao = teacher.nao
            uu, dd = Hr[:, :nao, :nao], Hr[:, nao:, nao:]
            udr, udi = Hr[:, :nao, nao:], Hi[:, :nao, nao:]
            iuu, idd = Hi[:, :nao, :nao], Hi[:, nao:, nao:]

            def valid(blocks):
                return [np.ascontiguousarray(b[np.ix_(bd[int(zr)], bd[int(zc)])])
                        for b, zr, zc in zip(blocks, zrow, zcol)]

            Hks = [valid(uu), valid(dd), valid(udr), valid(udi)]
            iHks = [valid(iuu), valid(idd),
                    [np.zeros_like(v) for v in valid(udi)]]
            Lv = None
            if Lon is not None:
                Lv = [np.ascontiguousarray(
                    Lon[k][np.ix_(bd[int(zr)], bd[int(zc)])])
                    for k, (zr, zc) in enumerate(zip(zrow, zcol))]
            return Hks, iHks, Lv

        Hs_on = full(data["Hon"], z, z)
        Hs_off = full(data["Hoff"], z[src], z[dst])
        H0s_on = full(data["H0on"], z, z)
        H0s_off = full(data["H0off"], z[src], z[dst])
        Hr_on, Hi_on, Hr_off, Hi_off, Lon = soc.spinor_parts(z, Hs_on, Hs_off)
        H0r_on, H0i_on, H0r_off, H0i_off, _ = soc.spinor_parts(
            z, H0s_on, H0s_off)
        # H0 carries NO SOC: spatial diag only
        H0i_on[:] = 0.0
        H0r_on[:, : teacher.nao, teacher.nao:] = 0.0
        H0r_on[:, teacher.nao:, : teacher.nao] = 0.0

        Hks_on, iHks_on, Lv = spin_valid(Hr_on, Hi_on, z, z, Lon)
        Hks_off, iHks_off, _ = spin_valid(Hr_off, Hi_off, z[src], z[dst])
        H0ks_on, iH0ks_on, _ = spin_valid(H0r_on, H0i_on, z, z, Lon)
        H0ks_off, iH0ks_off, _ = spin_valid(H0r_off, H0i_off, z[src], z[dst])
        Loff_zero = [np.zeros((len(bd[int(a)]), len(bd[int(b)]), 3))
                     for a, b in zip(z[src], z[dst])]
        write_scfout(os.path.join(d, "openmx.scfout"),
                     Hon=Hks_on, Hoff=Hks_off, iHon=iHks_on, iHoff=iHks_off,
                     Lon=Lv, Loff=Loff_zero, **common)
        write_scfout(os.path.join(d, "overlap.scfout"),
                     Hon=H0ks_on, Hoff=H0ks_off, iHon=iH0ks_on,
                     iHoff=iH0ks_off, Lon=Lv, Loff=Loff_zero, **common)
    else:
        write_scfout(os.path.join(d, "openmx.scfout"),
                     Hon=[data["Hon"]], Hoff=[data["Hoff"]], **common)
        write_scfout(os.path.join(d, "overlap.scfout"),
                     Hon=[data["H0on"]], Hoff=[data["H0off"]], **common)
    cell_ang, pos_ang = cell * AU2ANG, pos * AU2ANG
    # trailing comment required: the graph_data_gen lattice regex needs >=1
    # char after the tag
    lines = ["<Atoms.UnitVectors                     # unit=Ang."]
    for row in cell_ang:
        lines.append("  " + "  ".join(f"{v:.10f}" for v in row))
    lines.append("Atoms.UnitVectors>")
    lines.append("<Atoms.SpeciesAndCoordinates")
    for i, (zz, p) in enumerate(zip(z, pos_ang)):
        lines.append(f"  {i + 1}  {_Z_SYMBOL[int(zz)]}  "
                     + "  ".join(f"{v:.10f}" for v in p) + "  2.0  2.0")
    lines.append("Atoms.SpeciesAndCoordinates>")
    with open(os.path.join(d, "openmx.dat"), "w") as f:
        f.write("\n".join(lines) + "\n")


def rattled(rng, proto, max_strain=0.03, max_sigma=0.10):
    cell0, pos0, z = proto
    eps = max_strain * rng.uniform(-1, 1, (3, 3))
    F = np.eye(3) + 0.5 * (eps + eps.T)
    cell = cell0 @ F
    frac = pos0 @ np.linalg.inv(cell0)
    sigma = rng.uniform(0.02, max_sigma) / AU2ANG  # Angstrom -> Bohr
    pos = frac @ cell + sigma * rng.randn(*pos0.shape)
    return cell, pos, z


def main(argv=None):
    ap = argparse.ArgumentParser(description="Slater-Koster synthetic dataset")
    ap.add_argument("--out", required=True)
    ap.add_argument("--n-si", type=int, default=150)
    ap.add_argument("--n-c", type=int, default=150)
    ap.add_argument("--n-sic", type=int, default=100)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--nao-max", type=int, default=14)
    ap.add_argument("--band-set", action="store_true",
                    help="also write pristine (unrattled) prediction structures")
    ap.add_argument("--soc", action="store_true",
                    help="add an on-site atomic SOC term (so3 ksi*L form) and "
                         "write SpinP_switch=3 non-collinear scfout files")
    ap.add_argument("--format", default="openmx",
                    choices=("openmx", "siesta", "abacus"),
                    help="DFT-code container format (and basis conventions)")
    args = ap.parse_args(argv)

    if args.format != "openmx":
        assert not args.soc, "--soc is the openmx (scfout) pipeline"
    teacher = SKTeacher(ham_type=args.format, nao_max=args.nao_max,
                        seed=args.seed)
    soc = SOCTerms(teacher.basis, seed=args.seed) if args.soc else None
    protos = {
        "si": _fcc_primitive(A_SI, 14, 14),
        "c": _fcc_primitive(A_C, 6, 6),
        "sic": _fcc_primitive(A_SIC, 14, 6),
    }
    # overlap positive-definiteness sanity on the pristine prototypes
    for name, (cell, pos, z) in protos.items():
        lo = min_overlap_eig(teacher.build(z, pos, cell), z)
        print(f"{name}: min eig S(k) = {lo:.4f}")
        assert lo > 0.05, f"overlap not safely positive definite for {name}"

    writers = {
        "openmx": lambda d, z, pos, cell: write_structure_dir(
            d, teacher, z, pos, cell, soc=soc),
        "siesta": lambda d, z, pos, cell: write_structure_dir_siesta(
            d, teacher, z, pos, cell),
        "abacus": lambda d, z, pos, cell: write_structure_dir_abacus(
            d, teacher, z, pos, cell),
    }
    writer = writers[args.format]

    rng = np.random.RandomState(args.seed + 1)
    idx = 0
    for name, count in (("si", args.n_si), ("c", args.n_c), ("sic", args.n_sic)):
        for _ in range(count):
            cell, pos, z = rattled(rng, protos[name])
            writer(os.path.join(args.out, f"struct_{idx:04d}"), z, pos, cell)
            idx += 1
    print(f"wrote {idx} structures under {args.out}")

    if args.band_set:
        for name, proto in protos.items():
            cell, pos, z = proto
            writer(os.path.join(args.out + "_band", f"pristine_{name}"),
                   z, pos, cell)
        print(f"wrote pristine band-test structures under {args.out}_band")




class CollinearTerms:
    """Collinear (sigma_z) Heisenberg-like spin splitting IN the magnetic
    head's own function space (models/spin.py), so the spin-constrained
    collinear model family can provably fit it:

      J_on,i  = c_{z_i} per orbital-pair block (rank-0 merge expansion)
      J_off,e = c_{z_src, z_dst} * (1 + r/r0) * exp(-r/r0) per block
      H_sigma = H_SK + sign(sigma) * Delta  with Delta from the model's exact
                heisenberg_terms (unit weights, magnetic = all atoms)

    The teacher literally CALLS heisenberg_terms with these ground-truth J
    arrays, so representability is by construction — any training floor is
    model capacity/optimization, not teacher mismatch.
    """

    def __init__(self, basis, seed: int = 0, amp: float = 0.002,
                 zs=(14, 6), r0: float = 4.0):
        # amp: the all-positive per-block couplings accumulate coherently
        # over ~25-50 neighbor edges in heisenberg_terms, so the resulting
        # exchange splitting is ~20x amp * nao-block norms; 0.002 Ha puts the
        # max splitting at ~1.5 eV — the physical exchange-splitting regime
        # (0.01 made it ~8 eV, 5x the spatial H, which both dominates the
        # MAE loss and is physically nonsensical)
        self.nao = basis.nao_max
        self.r0 = r0
        rng = np.random.RandomState(seed + 77)
        nb = len(basis.orbital_irreps) ** 2
        self.M0 = _rank0_merge_matrix("openmx", self.nao)  # (nb, nao, nao)
        self.c_on = {z: amp * rng.uniform(0.5, 1.5, size=nb) for z in zs}
        self.c_off = {}
        for zi in zs:
            for zj in zs:
                key = tuple(sorted((zi, zj)))
                if key not in self.c_off:
                    self.c_off[key] = amp * rng.uniform(0.3, 1.0, size=nb)

    def j_arrays(self, z, src, dst, r):
        """Full-nao (N, nao, nao) onsite and (E, nao, nao) offsite J."""
        J_on = np.stack([
            np.einsum("b,bij->ij", self.c_on[int(zz)], self.M0) for zz in z])
        rad = (1.0 + r / self.r0) * np.exp(-r / self.r0)
        J_off = np.stack([
            np.einsum("b,bij->ij",
                      self.c_off[tuple(sorted((int(z[s]), int(z[d]))))],
                      self.M0) * rr
            for s, d, rr in zip(src, dst, rad)])
        return J_on, J_off


def _heisenberg(c, nao, J_on, J_off, spin_vec, magnetic, soc, collinear):
    """The magnetic head's own ``heisenberg_terms`` with unit weights, as
    numpy ((on_re, on_im), (off_re, off_im)), (rows, 2, nao, 2, nao) each (the
    imaginary parts None when collinear).  It runs on CPU float64 tensors: the
    teacher makes data, which must come out the same wherever it is made, and
    no model step runs here."""
    n, e = len(c["z"]), c["edge_index"].shape[1]
    graph = pad_and_batch([dict(c, Hon=np.zeros((n, nao * nao)), Hoff=np.zeros((e, nao * nao)))],
                          node_bucket=n, edge_bucket=e, dtype=np.float64, device="cpu")
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=torch.float64)  # noqa: E731
    out = heisenberg_terms(graph, t(J_on), t(J_off), t(np.ones((n, nao, nao))),
                           t(np.ones((e, nao, nao))), t(spin_vec), t(magnetic),
                           soc=soc, collinear=collinear)
    return tuple(tuple(None if x is None else x.numpy() for x in part) for part in out)


def collinear_crystal(teacher: SKTeacher, col: CollinearTerms, z, pos, cell,
                      rng) -> Dict[str, np.ndarray]:
    """One crystal dict with collinear (N/E, 2, nao^2) targets + spins."""
    data = teacher.build(z, pos, cell)
    bd = teacher.basis.basis_def
    nao = teacher.nao
    src, dst = data["edge_src"], data["edge_dst"]

    def full(blocks, zrow, zcol):
        out = np.zeros((len(blocks), nao, nao))
        for k, (b, zr, zc) in enumerate(zip(blocks, zrow, zcol)):
            out[k][np.ix_(bd[int(zr)], bd[int(zc)])] = b
        return out

    Hs_on = full(data["Hon"], z, z)
    Hs_off = full(data["Hoff"], z[src], z[dst])
    H0_on = full(data["H0on"], z, z)
    H0_off = full(data["H0off"], z[src], z[dst])
    S_on = full(data["Son"], z, z)
    S_off = full(data["Soff"], z[src], z[dst])

    m = rng.choice([-1.0, 1.0], size=len(z))
    spin_vec = np.zeros((len(z), 3))
    spin_vec[:, 2] = m
    spin_length = np.ones(len(z))

    vec = pos[dst] + (data["cell_shift"] @ cell) - pos[src]
    r = np.linalg.norm(vec, axis=1)
    J_on, J_off = col.j_arrays(z, src, dst, r)

    c = {
        "z": z, "pos": pos, "cell": cell[None],
        "edge_index": np.stack([src, dst]),
        "inv_edge_idx": inverse_edge_index(np.stack([src, dst]),
                                           data["cell_shift"]),
        "cell_shift": data["cell_shift"],
        "nbr_shift": data["cell_shift"] @ cell,
        "spin_vec": spin_vec, "spin_length": spin_length,
    }
    # the model's exact collinear Heisenberg math, with unit weights
    (hh_on, _), (hh_off, _) = _heisenberg(
        c, nao, J_on, J_off, spin_vec, np.ones(len(z)), soc=False, collinear=True)

    def stack2(base, hh):
        up = base + hh[:, 0, :, 0, :]
        dn = base + hh[:, 1, :, 1, :]
        return np.stack([up, dn], axis=1).reshape(len(base), 2, nao * nao)

    def valid_mask(zrow, zcol):
        mrow = np.zeros((len(zrow), nao))
        for k, zr in enumerate(zrow):
            mrow[k, bd[int(zr)]] = 1.0
        mcol = np.zeros((len(zcol), nao))
        for k, zc in enumerate(zcol):
            mcol[k, bd[int(zc)]] = 1.0
        return (mrow[:, :, None] * mcol[:, None, :]).reshape(-1, 1, nao * nao)

    c["Hon"] = stack2(Hs_on, hh_on) * valid_mask(z, z)
    c["Hoff"] = stack2(Hs_off, hh_off) * valid_mask(z[src], z[dst])
    c["Hon0"] = np.repeat(H0_on.reshape(-1, 1, nao * nao), 2, axis=1) \
        * valid_mask(z, z)
    c["Hoff0"] = np.repeat(H0_off.reshape(-1, 1, nao * nao), 2, axis=1) \
        * valid_mask(z[src], z[dst])
    c["Son"] = S_on.reshape(-1, nao * nao)
    c["Soff"] = S_off.reshape(-1, nao * nao)
    return c


def main_collinear(argv=None):
    """Collinear spin-constrained dataset: graph_data.npz with
    (rows, 2, nao^2) spin-channel targets + per-atom spins."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--nao-max", type=int, default=14)
    ap.add_argument("--band-set", action="store_true",
                    help="also write pristine (unrattled) prediction "
                         "structures with seeded spins under <out>_band")
    args = ap.parse_args(argv)

    teacher = SKTeacher(nao_max=args.nao_max, seed=args.seed)
    col = CollinearTerms(teacher.basis, seed=args.seed)
    protos = {
        "si": _fcc_primitive(A_SI, 14, 14),
        "c": _fcc_primitive(A_C, 6, 6),
        "sic": _fcc_primitive(A_SIC, 14, 6),
    }
    rng = np.random.RandomState(args.seed + 1)
    crystals = []
    names = list(protos)
    for i in range(args.n):
        cell, pos, z = rattled(rng, protos[names[i % len(names)]])
        crystals.append(collinear_crystal(teacher, col, z, pos, cell, rng))
    os.makedirs(args.out, exist_ok=True)
    save_graph_npz(os.path.join(args.out, "graph_data.npz"), crystals)
    print(f"wrote {len(crystals)} collinear structures under {args.out}")

    if args.band_set:
        brng = np.random.RandomState(args.seed + 2)
        band = [collinear_crystal(teacher, col, proto[2], proto[1], proto[0],
                                  brng)
                for proto in protos.values()]
        os.makedirs(args.out + "_band", exist_ok=True)
        save_graph_npz(os.path.join(args.out + "_band", "graph_data.npz"),
                       band)
        print(f"wrote {len(band)} pristine collinear band-test structures "
              f"under {args.out}_band")


class NonCollinearTerms:
    """Heisenberg terms for the NON-collinear spin-constrained families, in the
    magnetic head's own function space (models/spin.py heisenberg_terms with
    collinear=False): rank-0 scalar J per orbital-pair block, or rank-2
    (nao, nao, 3, 3) J when ``soc`` (the spin-constrained-SOC family).  The
    teacher literally calls heisenberg_terms with these ground-truth J arrays
    and unit weights, so representability is by construction.
    """

    def __init__(self, basis, seed: int = 0, amp: float = 0.01,
                 zs=(14, 6), r0: float = 4.0, soc: bool = False):
        self.nao = basis.nao_max
        self.r0 = r0
        self.soc = soc
        rng = np.random.RandomState(seed + 177)
        nb = len(basis.orbital_irreps) ** 2
        if soc:
            M2 = _rank2_merge_matrix("openmx", self.nao)  # (9*nb, nao, nao, 3, 3)
            self.M = M2.reshape(M2.shape[0], -1)
            self.shape = (self.nao, self.nao, 3, 3)
            d = 9 * nb
        else:
            M0 = _rank0_merge_matrix("openmx", self.nao)  # (nb, nao, nao)
            self.M = M0.reshape(M0.shape[0], -1)
            self.shape = (self.nao, self.nao)
            d = nb
        self.c_on = {z: amp * rng.uniform(-1.0, 1.0, size=d) for z in zs}
        self.c_off = {}
        for zi in zs:
            for zj in zs:
                key = tuple(sorted((zi, zj)))
                if key not in self.c_off:
                    self.c_off[key] = amp * rng.uniform(-0.7, 0.7, size=d)

    def j_arrays(self, z, src, dst, r):
        J_on = np.stack([
            (self.c_on[int(zz)] @ self.M).reshape(self.shape) for zz in z])
        rad = (1.0 + r / self.r0) * np.exp(-r / self.r0)
        J_off = np.stack([
            (self.c_off[tuple(sorted((int(z[s]), int(z[d]))))] @ self.M
             ).reshape(self.shape) * rr
            for s, d, rr in zip(src, dst, rad)])
        return J_on, J_off


def noncollinear_crystal(teacher: SKTeacher, terms: NonCollinearTerms, z, pos,
                         cell, rng, soc: bool = False) -> Dict[str, np.ndarray]:
    """One crystal dict with non-collinear (2 nao)^2 real/imag targets built
    exactly as the magnetic head's non-collinear branch assembles them
    (models/spin.py non-collinear path):
    spin-diagonal spatial H + complex sigma.S Heisenberg terms, model-identical
    symmetrization, H0 on the spin diagonal, valid-orbital masking."""
    data = teacher.build(z, pos, cell)
    bd = teacher.basis.basis_def
    nao = teacher.nao
    big = 2 * nao
    src, dst = data["edge_src"], data["edge_dst"]
    n, e = len(z), len(src)

    def full(blocks, zrow, zcol):
        out = np.zeros((len(blocks), nao, nao))
        for k, (b, zr, zc) in enumerate(zip(blocks, zrow, zcol)):
            out[k][np.ix_(bd[int(zr)], bd[int(zc)])] = b
        return out

    Hs_on = full(data["Hon"], z, z)
    Hs_off = full(data["Hoff"], z[src], z[dst])
    H0_on = full(data["H0on"], z, z)
    H0_off = full(data["H0off"], z[src], z[dst])
    S_on = full(data["Son"], z, z)
    S_off = full(data["Soff"], z[src], z[dst])

    # random unit spin directions, all atoms magnetic
    sv = rng.normal(size=(n, 3))
    sv = sv / np.linalg.norm(sv, axis=1, keepdims=True)
    spin_length = np.ones(n)

    vec = pos[dst] + (data["cell_shift"] @ cell) - pos[src]
    r = np.linalg.norm(vec, axis=1)
    J_on, J_off = terms.j_arrays(z, src, dst, r)

    edge_index = np.stack([src, dst])
    inv_edge = inverse_edge_index(edge_index, data["cell_shift"])
    c = {
        "z": z, "pos": pos, "cell": cell[None],
        "edge_index": edge_index,
        "inv_edge_idx": inv_edge,
        "cell_shift": data["cell_shift"],
        "nbr_shift": data["cell_shift"] @ cell,
        "spin_vec": sv, "spin_length": spin_length,
    }
    (on_re, on_im), (off_re, off_im) = _heisenberg(
        c, nao, J_on, J_off, sv, spin_length, soc=soc, collinear=False)
    hh_on = (on_re + 1j * on_im).reshape(n, big, big)
    hh_off = (off_re + 1j * off_im).reshape(e, big, big)

    def spin_diag(m):
        out = np.zeros((m.shape[0], big, big))
        out[:, :nao, :nao] = m
        out[:, nao:, nao:] = m
        return out

    # model-identical assembly + symmetrization (models/spin.py)
    h_on_r = spin_diag(Hs_on - H0_on) + hh_on.real
    h_on_i = hh_on.imag
    h_off_r = spin_diag(Hs_off - H0_off) + hh_off.real
    h_off_i = hh_off.imag
    h_on_r = 0.5 * (h_on_r + np.swapaxes(h_on_r, -1, -2))
    h_on_i = 0.5 * (h_on_i - np.swapaxes(h_on_i, -1, -2))
    h_off_r = 0.5 * (h_off_r + np.swapaxes(h_off_r[inv_edge], -1, -2))
    h_off_i = 0.5 * (h_off_i - np.swapaxes(h_off_i[inv_edge], -1, -2))
    h_on_r = h_on_r + spin_diag(H0_on)
    h_off_r = h_off_r + spin_diag(H0_off)

    def pair_mask(zrow, zcol):
        mrow = np.zeros((len(zrow), nao))
        for k, zr in enumerate(zrow):
            mrow[k, bd[int(zr)]] = 1.0
        mcol = np.zeros((len(zcol), nao))
        for k, zc in enumerate(zcol):
            mcol[k, bd[int(zc)]] = 1.0
        m = mrow[:, :, None] * mcol[:, None, :]
        m2 = np.concatenate([m, m], axis=1)
        return np.concatenate([m2, m2], axis=2)

    m_on = pair_mask(z, z)
    m_off = pair_mask(z[src], z[dst])
    c["Hon"] = (h_on_r * m_on).reshape(n, big * big)
    c["iHon"] = (h_on_i * m_on).reshape(n, big * big)
    c["Hoff"] = (h_off_r * m_off).reshape(e, big * big)
    c["iHoff"] = (h_off_i * m_off).reshape(e, big * big)
    c["Hon0"] = (spin_diag(H0_on) * m_on).reshape(n, big * big)
    c["Hoff0"] = (spin_diag(H0_off) * m_off).reshape(e, big * big)
    c["iHon0"] = np.zeros((n, big * big))
    c["iHoff0"] = np.zeros((e, big * big))
    c["Son"] = S_on.reshape(n, nao * nao)
    c["Soff"] = S_off.reshape(e, nao * nao)
    return c


def main_noncollinear(argv=None, soc: bool = False):
    """Non-collinear spin-constrained dataset: (2 nao)^2 real/imag targets
    with sigma.S (rank-0 J) or full rank-2-J SOC Heisenberg corrections."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--nao-max", type=int, default=14)
    args = ap.parse_args(argv)

    teacher = SKTeacher(nao_max=args.nao_max, seed=args.seed)
    terms = NonCollinearTerms(teacher.basis, seed=args.seed, soc=soc)
    protos = {
        "si": _fcc_primitive(A_SI, 14, 14),
        "c": _fcc_primitive(A_C, 6, 6),
        "sic": _fcc_primitive(A_SIC, 14, 6),
    }
    rng = np.random.RandomState(args.seed + 1)
    crystals = []
    names = list(protos)
    for i in range(args.n):
        cell, pos, z = rattled(rng, protos[names[i % len(names)]])
        crystals.append(noncollinear_crystal(teacher, terms, z, pos, cell,
                                             rng, soc=soc))
    os.makedirs(args.out, exist_ok=True)
    save_graph_npz(os.path.join(args.out, "graph_data.npz"), crystals)
    kind = "spin-constrained-SOC" if soc else "non-collinear"
    print(f"wrote {len(crystals)} {kind} structures under {args.out}")


def run(argv) -> None:
    """The command line: ``collinear``, ``noncollinear`` or ``spinsoc``
    first for a spin set, else the container sets of :func:`main`."""
    kind = argv[0] if argv else None
    if kind == "collinear":
        main_collinear(argv[1:])
    elif kind in ("noncollinear", "spinsoc"):
        main_noncollinear(argv[1:], soc=kind == "spinsoc")
    else:
        main(argv)


if __name__ == "__main__":
    import sys

    run(sys.argv[1:])
