"""ABACUS interface: STRU parsing, sparse H(R)/S(R) CSR reading and graph
packing, the port's counterpart of ``hamgnn_tpu/interfaces/abacus.py``
(numpy and scipy, host only).

The ABACUS ``data-HR-sparse`` / ``data-SR-sparse`` text format stores, per
cell shift (cx, cy, cz), one CSR matrix over supercell orbitals; SOC runs
interleave the two spins along the orbital axis (even/odd strides) with
complex entries.  Per-edge dense blocks are cut per (atom_i, atom_j, shift).
:func:`read_csr_native` runs ``native/csr_reader.cpp`` (built on first use).
"""

from __future__ import annotations

import os
import re
import subprocess
import tempfile
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..models.basis import get_basis_set
from .native import native_tool
from .openmx import _dense_rows, inverse_edges

AU2ANG = 0.5291772490000065
RY2HA = 13.60580 / 27.21138506

_SYM2Z = {s: i for i, s in enumerate([
    "X", "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne", "Na", "Mg",
    "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca", "Sc", "Ti", "V", "Cr", "Mn",
    "Fe", "Co", "Ni", "Cu", "Zn", "Ga", "Ge", "As", "Se", "Br", "Kr", "Rb",
    "Sr", "Y", "Zr", "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd", "In",
    "Sn", "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd", "Pm",
    "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb", "Lu", "Hf", "Ta",
    "W", "Re", "Os", "Ir", "Pt", "Au", "Hg", "Tl", "Pb", "Bi"])}

_L_DIM = {"s": 1, "p": 3, "d": 5, "f": 7, "g": 9}


def orbital_count_from_name(orb_name: str) -> int:
    """Number of orbitals from an ABACUS .orb filename, e.g.
    'C_gga_7au_100Ry_2s2p1d.orb' -> 2*1 + 2*3 + 1*5 = 13."""
    total = 0
    for count, l in re.findall(r"(\d+)([spdfg])", orb_name.split("_")[-1]):
        total += int(count) * _L_DIM[l]
    return total


@dataclass
class Stru:
    species: List[str]
    num_atoms_per_species: List[int]
    num_orbitals: List[int]
    cell: np.ndarray          # Bohr
    positions: np.ndarray     # Bohr, cartesian
    z: np.ndarray

    @property
    def num_atoms_unit_cell(self) -> int:
        return int(sum(self.num_atoms_per_species))


def parse_stru(path: str) -> Stru:
    """Parse an ABACUS STRU file (sections ATOMIC_SPECIES, NUMERICAL_ORBITAL,
    LATTICE_CONSTANT, LATTICE_VECTORS, ATOMIC_POSITIONS)."""
    with open(path) as f:
        lines = [ln.split("#")[0].rstrip() for ln in f]
    text = "\n".join(lines)

    def section(name):
        # section headers are long uppercase tokens; a bare element symbol
        # line (e.g. "C") must not terminate a section
        m = re.search(rf"{name}\s*\n(.*?)(?=\n[A-Z][A-Z_]{{3,}}\s*\n|\Z)", text, re.S)
        return m.group(1).strip().splitlines() if m else []

    species = [ln.split()[0] for ln in section("ATOMIC_SPECIES") if ln.strip()]
    orbs = [orbital_count_from_name(ln.split()[0])
            for ln in section("NUMERICAL_ORBITAL") if ln.strip()]
    lat_const = float(section("LATTICE_CONSTANT")[0].split()[0])  # in Bohr
    cell = np.array([[float(v) for v in ln.split()[:3]]
                     for ln in section("LATTICE_VECTORS")[:3]]) * lat_const

    pos_lines = section("ATOMIC_POSITIONS")
    mode = pos_lines[0].strip().lower()  # 'direct' or 'cartesian'
    counts, positions, z = [], [], []
    i = 1
    for s in species:
        while not pos_lines[i].strip():
            i += 1
        assert pos_lines[i].split()[0] == s, (pos_lines[i], s)
        i += 1  # species label
        i += 1  # magnetism
        n = int(pos_lines[i].split()[0])
        i += 1
        counts.append(n)
        for _ in range(n):
            while not pos_lines[i].strip():
                i += 1
            vals = [float(v) for v in pos_lines[i].split()[:3]]
            positions.append(vals)
            z.append(_SYM2Z[s])
            i += 1
    positions = np.asarray(positions)
    if mode.startswith("direct"):
        positions = positions @ cell
    else:
        positions = positions * lat_const
    return Stru(species=species, num_atoms_per_species=counts,
                num_orbitals=orbs, cell=cell, positions=positions,
                z=np.asarray(z, np.int64))


def _atom_orbitals(stru: Stru, repeat: int):
    per_atom = []
    for si in range(len(stru.species)):
        per_atom += [stru.num_orbitals[si]] * stru.num_atoms_per_species[si]
    no = np.asarray(per_atom, np.int64) * repeat
    indo = np.concatenate([[0], np.cumsum(no[:-1])])
    return no, indo


def read_csr_file(path: str, soc: bool = False):
    """Yield (shift (3,), csr components) per cell shift from an ABACUS sparse
    matrix file."""
    from scipy.sparse import csr_matrix

    with open(path) as f:
        line = f.readline()
        if "STEP" in line:
            line = f.readline()
        no_u = int(line.split()[-1])
        f.readline()  # ncell_shift
        while True:
            line = f.readline()
            if not line:
                break
            t = line.split()
            if len(t) < 4:
                continue
            shift = np.array([int(t[0]), int(t[1]), int(t[2])])
            nh = int(t[3])
            if nh == 0:
                continue
            val_line = f.readline()
            col = np.array(f.readline().split(), int)
            row = np.array(f.readline().split(), int)
            if soc:
                raw = np.asarray(re.findall(r"[\-\+\d\.eE]+", val_line), np.float64)
                val = raw[0::2] + 1j * raw[1::2]
                dtype = np.complex128
            else:
                val = np.asarray(val_line.split(), np.float64)
                dtype = np.float64
            yield shift, csr_matrix((val, col, row), shape=(no_u, no_u), dtype=dtype)


def read_csr_native(path: str, soc: bool = False):
    """Native counterpart of :func:`read_csr_file`: ``native/csr_reader.cpp``
    (built on first use) parses the text CSR file into a binary container,
    read back here as the same (shift, csr_matrix) stream."""
    from scipy.sparse import csr_matrix

    exe = native_tool("csr_reader")
    with tempfile.NamedTemporaryFile(suffix=".bin", delete=False) as tmp:
        out = tmp.name
    try:
        cmd = [exe, path, out] + (["--soc"] if soc else [])
        subprocess.run(cmd, check=True, capture_output=True)
        with open(out, "rb") as f:
            buf = f.read()
        assert buf[:6] == b"ABCSR1", "bad csr_reader container"
        no_u, is_complex, n_blocks = np.frombuffer(buf, "<i8", 3, offset=8)
        ofs = 8 + 3 * 8
        for _ in range(n_blocks):
            shift = np.frombuffer(buf, "<i8", 3, offset=ofs)
            (nnz,) = np.frombuffer(buf, "<i8", 1, offset=ofs + 24)
            ofs += 32
            nv = int(nnz) * (2 if is_complex else 1)
            raw = np.frombuffer(buf, "<f8", nv, offset=ofs)
            ofs += nv * 8
            col = np.frombuffer(buf, "<i8", int(nnz), offset=ofs)
            ofs += int(nnz) * 8
            row = np.frombuffer(buf, "<i8", int(no_u) + 1, offset=ofs)
            ofs += (int(no_u) + 1) * 8
            if is_complex:
                val = raw[0::2] + 1j * raw[1::2]
                dtype = np.complex128
            else:
                val = raw
                dtype = np.float64
            yield shift.astype(np.int64), csr_matrix(
                (val, col, row), shape=(int(no_u), int(no_u)), dtype=dtype)
    finally:
        os.unlink(out)


def build_graph_from_csr(stru: Stru, h_path: str, s_path: Optional[str] = None,
                         soc: bool = False, native: bool = False) -> Dict:
    """Edges + per-edge dense blocks from ABACUS H(R)/S(R) sparse files, read
    by :func:`read_csr_file` or, with ``native``, :func:`read_csr_native`."""
    read = read_csr_native if native else read_csr_file
    repeat = 2 if soc else 1
    nspin = 4 if soc else 1
    no, indo = _atom_orbitals(stru, repeat)
    na = stru.num_atoms_unit_cell

    src, dst, cshift, nshift = [], [], [], []
    Hon = [[] for _ in range(nspin)]
    Hoff = [[] for _ in range(nspin)]
    Son, Soff = [], []
    edge_key = {}

    def spin_blocks(m):
        if not soc:
            return [m]
        return [m[0::2, 0::2], m[0::2, 1::2], m[1::2, 0::2], m[1::2, 1::2]]

    for shift, H in read(h_path, soc=soc):
        H = H * RY2HA
        for ia in range(na):
            for ja in range(na):
                blk = H[indo[ia] : indo[ia] + no[ia], indo[ja] : indo[ja] + no[ja]]
                onsite = ia == ja and not shift.any()
                if not onsite and blk.getnnz() == 0:
                    continue
                bl = [b.toarray() for b in spin_blocks(blk)]
                if onsite:
                    for s in range(nspin):
                        Hon[s].append(bl[s])
                else:
                    for s in range(nspin):
                        Hoff[s].append(bl[s])
                    edge_key[(ia, ja, tuple(shift))] = len(src)
                    src.append(ia)
                    dst.append(ja)
                    cshift.append(shift)
                    nshift.append(shift @ stru.cell)

    # overlap file (non-SOC storage even for SOC runs)
    Son = [np.zeros((no[a] // repeat, no[a] // repeat)) for a in range(na)]
    Soff = [np.zeros((no[src[e]] // repeat, no[dst[e]] // repeat))
            for e in range(len(src))]
    if s_path is not None:
        no1, indo1 = _atom_orbitals(stru, 1)
        for shift, S in read(s_path, soc=False):
            for ia in range(na):
                for ja in range(na):
                    blk = S[indo1[ia] : indo1[ia] + no1[ia],
                            indo1[ja] : indo1[ja] + no1[ja]]
                    onsite = ia == ja and not shift.any()
                    if onsite:
                        Son[ia] = blk.toarray()
                    elif blk.getnnz() > 0:
                        e = edge_key.get((ia, ja, tuple(shift)))
                        if e is not None:
                            Soff[e] = blk.toarray()

    return {
        "edge_src": np.asarray(src, np.int64),
        "edge_dst": np.asarray(dst, np.int64),
        "cell_shift": np.asarray(cshift, np.int64).reshape(-1, 3),
        "nbr_shift": np.asarray(nshift, float).reshape(-1, 3),
        "Hon": Hon, "Hoff": Hoff, "Son": Son, "Soff": Soff,
    }


def pack_crystal_abacus(graph: Dict, stru: Stru, nao_max: int,
                        soc: bool = False) -> Dict[str, np.ndarray]:
    basis = get_basis_set("abacus", nao_max)
    z = stru.z
    src, dst = graph["edge_src"], graph["edge_dst"]
    inv = inverse_edges(src, dst, graph["cell_shift"])
    nao = nao_max
    out = {
        "z": z, "pos": stru.positions, "cell": stru.cell[None],
        "edge_index": np.stack([src, dst]), "inv_edge_idx": inv,
        "cell_shift": graph["cell_shift"], "nbr_shift": graph["nbr_shift"],
        "Son": _dense_rows(graph["Son"], z, z, basis, nao),
        "Soff": _dense_rows(graph["Soff"], z[src], z[dst], basis, nao),
    }
    if not soc:
        out["Hon"] = _dense_rows([np.real(b) for b in graph["Hon"][0]], z, z, basis, nao)
        out["Hoff"] = _dense_rows([np.real(b) for b in graph["Hoff"][0]],
                                  z[src], z[dst], basis, nao)
        return out

    def rows_on(bl):
        return _dense_rows(bl, z, z, basis, nao)

    def rows_off(bl):
        return _dense_rows(bl, z[src], z[dst], basis, nao)

    def assemble(uu, ud, du, dd, rows):
        r = [rows([np.real(b) for b in blk]) for blk in (uu, ud, du, dd)]
        i = [rows([np.imag(b) for b in blk]) for blk in (uu, ud, du, dd)]
        m = r[0].shape[0]
        Hr = np.zeros((m, 2 * nao, 2 * nao))
        Hi = np.zeros((m, 2 * nao, 2 * nao))
        for (si, sj), idx in (((0, 0), 0), ((0, 1), 1), ((1, 0), 2), ((1, 1), 3)):
            Hr[:, si * nao : (si + 1) * nao, sj * nao : (sj + 1) * nao] = \
                r[idx].reshape(m, nao, nao)
            Hi[:, si * nao : (si + 1) * nao, sj * nao : (sj + 1) * nao] = \
                i[idx].reshape(m, nao, nao)
        return Hr.reshape(m, -1), Hi.reshape(m, -1)

    out["Hon"], out["iHon"] = assemble(*graph["Hon"], rows_on)
    out["Hoff"], out["iHoff"] = assemble(*graph["Hoff"], rows_off)
    return out


# ----------------------------------------------------------------------
# STRU / CSR writers (synthetic data): inverses of the parsers
# ----------------------------------------------------------------------

_Z2SYM = {z: s for s, z in _SYM2Z.items()}


def _orb_name(sym: str, z: int, basis) -> str:
    """Encode the species' valid-orbital composition as an ABACUS .orb
    filename (the count source for parse_stru -> orbital_count_from_name)."""
    counts: Dict[str, int] = {}
    slot_of = []
    for _, ir in basis.orbital_irreps:
        slot_of.append(ir.l)
    # count valid slots per l for this species
    ofs = 0
    present = []
    for _, ir in basis.orbital_irreps:
        idx = list(range(ofs, ofs + ir.dim))
        if all(i in set(basis.basis_def[z]) for i in idx):
            present.append(ir.l)
        ofs += ir.dim
    lnames = "spdfg"
    for l in present:
        counts[lnames[l]] = counts.get(lnames[l], 0) + 1
    comp = "".join(f"{n}{l}" for l, n in
                   sorted(counts.items(), key=lambda t: lnames.index(t[0])))
    return f"{sym}_{comp}.orb"


def write_stru(path: str, *, z, pos, cell) -> None:
    """Minimal STRU (Bohr inputs; atoms must already be species-grouped)."""
    z = np.asarray(z)
    basis = get_basis_set("abacus", 27)
    sp: List[int] = []
    for zz in z:
        if int(zz) not in sp:
            sp.append(int(zz))
    # parser expects species-grouped atom blocks
    order = np.argsort([sp.index(int(zz)) for zz in z], kind="stable")
    assert np.all(order == np.arange(len(z))), \
        "write_stru requires species-grouped atom order"
    lines = ["ATOMIC_SPECIES"]
    for zz in sp:
        lines.append(f"{_Z2SYM[zz]} 1.0 {_Z2SYM[zz]}.upf")
    lines += ["", "NUMERICAL_ORBITAL"]
    for zz in sp:
        lines.append(_orb_name(_Z2SYM[zz], zz, basis))
    lines += ["", "LATTICE_CONSTANT", "1.0", "", "LATTICE_VECTORS"]
    for row in np.asarray(cell, float):
        lines.append("  " + "  ".join(f"{v:.10f}" for v in row))
    lines += ["", "ATOMIC_POSITIONS", "Cartesian"]
    for zz in sp:
        lines.append(_Z2SYM[zz])
        lines.append("0.0")
        idx = [i for i in range(len(z)) if int(z[i]) == zz]
        lines.append(str(len(idx)))
        for i in idx:
            p = np.asarray(pos, float)[i]
            lines.append("  " + "  ".join(f"{v:.10f}" for v in p) + " 1 1 1")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _write_csr_file(path: str, header: str, no_u: int, mats: Dict) -> None:
    from scipy.sparse import csr_matrix

    shifts = sorted(mats.keys())
    lines = [f"Matrix Dimension of {header}: {no_u}",
             f"Matrix number of {header}: {len(shifts)}"]
    for cs in shifts:
        m = csr_matrix(mats[cs])
        m.eliminate_zeros()
        lines.append(f"{cs[0]} {cs[1]} {cs[2]} {m.nnz}")
        if m.nnz == 0:
            continue
        lines.append(" ".join(f"{v:.12e}" for v in m.data))
        lines.append(" ".join(str(int(c)) for c in m.indices))
        lines.append(" ".join(str(int(r)) for r in m.indptr))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def write_abacus_csr(out_dir: str, *, z, num_orbs, edge_src, edge_dst,
                     cell_shift, Hon, Hoff, Son, Soff,
                     H0on=None, H0off=None) -> None:
    """Write data-HR/SR(-H0R)-sparse_SPIN0.csr containers that
    build_graph_from_csr round-trips (H stored in Ry like ABACUS; S raw)."""
    num_orbs = np.asarray(num_orbs, np.int64)
    no_u = int(num_orbs.sum())
    indo = np.concatenate([[0], np.cumsum(num_orbs[:-1])])
    edge_src = np.asarray(edge_src, np.int64)
    edge_dst = np.asarray(edge_dst, np.int64)
    cell_shift = np.asarray(cell_shift, np.int64).reshape(-1, 3)

    def assemble(on_blocks, off_blocks, to_ry):
        mats: Dict[Tuple[int, int, int], np.ndarray] = {}

        def mat(cs):
            if cs not in mats:
                mats[cs] = np.zeros((no_u, no_u))
            return mats[cs]

        scale = (1.0 / RY2HA) if to_ry else 1.0
        for ia, blk in enumerate(on_blocks):
            m = mat((0, 0, 0))
            m[indo[ia] : indo[ia] + num_orbs[ia],
              indo[ia] : indo[ia] + num_orbs[ia]] += np.asarray(blk) * scale
        for e, blk in enumerate(off_blocks):
            ia, ja = int(edge_src[e]), int(edge_dst[e])
            m = mat(tuple(cell_shift[e]))
            m[indo[ia] : indo[ia] + num_orbs[ia],
              indo[ja] : indo[ja] + num_orbs[ja]] += np.asarray(blk) * scale
        return mats

    _write_csr_file(os.path.join(out_dir, "data-HR-sparse_SPIN0.csr"),
                    "H(R)", no_u, assemble(Hon, Hoff, True))
    _write_csr_file(os.path.join(out_dir, "data-SR-sparse_SPIN0.csr"),
                    "S(R)", no_u, assemble(Son, Soff, False))
    if H0on is not None:
        _write_csr_file(os.path.join(out_dir, "data-H0R-sparse_SPIN0.csr"),
                        "H0(R)", no_u, assemble(H0on, H0off, True))
