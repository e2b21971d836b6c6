"""SIESTA/HONPAS interface: .HSX parsing and graph packing, the port's
counterpart of ``hamgnn_tpu/interfaces/siesta.py`` (numpy, host only).

The .HSX Fortran sequential unformatted file is read directly in numpy:

  records: (no_u, no_s, nspin, nh); (gamma); [indxuo if not gamma];
  numh(no_u); listh per row; H per (spin, row) float32 in Ry; S per row;
  (qtot, temp); xij per row (3*numh floats, Bohr); nspecies;
  (label, zval, no)*; (nquant, lquant, zeta)*; na_u; isa; (iaorb, iphorb).

Graph construction: supercell column blocks -> per-(atom_i, atom_j, image)
dense blocks; the cell shift comes from round((pos_i - pos_j + xij) @ invcell).
:func:`parse_hsx_native` runs ``native/hsx_reader.cpp`` (built on first use).
"""

from __future__ import annotations

import json
import re
import struct
import subprocess
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from ..models.basis import get_basis_set
from .native import native_tool
from .openmx import _dense_rows, inverse_edges

AU2ANG = 0.5291772490000065
RY2HA = 13.60580 / 27.21138506


class FortranFile:
    """Minimal sequential-unformatted reader (4-byte record markers)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.buf = f.read()
        self.ofs = 0

    def record(self) -> bytes:
        (n,) = struct.unpack_from("<i", self.buf, self.ofs)
        self.ofs += 4
        data = self.buf[self.ofs : self.ofs + n]
        self.ofs += n
        (n2,) = struct.unpack_from("<i", self.buf, self.ofs)
        self.ofs += 4
        assert n == n2, "corrupt Fortran record"
        return data

    def ints(self) -> np.ndarray:
        return np.frombuffer(self.record(), dtype="<i4").astype(np.int64)

    def floats(self) -> np.ndarray:
        return np.frombuffer(self.record(), dtype="<f4").astype(np.float64)

    def doubles(self) -> np.ndarray:
        return np.frombuffer(self.record(), dtype="<f8")


@dataclass
class HSXData:
    no_u: int
    no_s: int
    nspin: int
    indxuo: np.ndarray       # (no_s,) 1-based unit-cell orbital of each SC orbital
    numh: np.ndarray
    listh: np.ndarray        # (nh,) 1-based supercell column indices
    hamilt: np.ndarray       # (nspin, nh) Hartree
    sover: np.ndarray        # (nh,)
    xij: np.ndarray          # (nh, 3) Bohr
    species_no: np.ndarray   # orbitals per species
    isa: np.ndarray          # (na_u,) species of each atom (1-based)
    iaorb: np.ndarray        # (no_u,) atom of each orbital (1-based)
    zval: np.ndarray


def parse_hsx_native(path: str) -> HSXData:
    """Parse .HSX with the native C++ reader (``native/hsx_reader.cpp``,
    built on first use): the same :class:`HSXData` as :func:`parse_hsx`,
    element for element."""
    exe = native_tool("hsx_reader")
    d = json.loads(subprocess.run([exe, path], check=True,
                                  capture_output=True).stdout)
    return HSXData(
        no_u=d["no_u"], no_s=d["no_s"], nspin=d["nspin"],
        indxuo=np.asarray(d["indxuo"], np.int64),
        numh=np.asarray(d["numh"], np.int64),
        listh=np.asarray(d["listh"], np.int64),
        hamilt=np.asarray(d["hamilt"], np.float64),
        sover=np.asarray(d["sover"], np.float64),
        xij=np.asarray(d["xij"], np.float64).reshape(-1, 3),
        species_no=np.asarray(d["species_no"], np.int64),
        isa=np.asarray(d["isa"], np.int64),
        iaorb=np.asarray(d["iaorb"], np.int64),
        zval=np.asarray(d["zval"], np.float64),
    )


def parse_hsx(path: str) -> HSXData:
    f = FortranFile(path)
    no_u, no_s, nspin, nh = f.ints()
    gamma = bool(np.frombuffer(f.record(), dtype="<i4")[0])
    if not gamma:
        indxuo = f.ints()
    else:
        indxuo = np.arange(1, no_u + 1)
    numh = f.ints()
    listhptr = np.concatenate([[0], np.cumsum(numh[:-1])])
    listh = np.zeros(nh, np.int64)
    for io in range(no_u):
        listh[listhptr[io] : listhptr[io] + numh[io]] = f.ints()
    hamilt = np.zeros((nspin, nh))
    for s in range(nspin):
        for io in range(no_u):
            hamilt[s, listhptr[io] : listhptr[io] + numh[io]] = f.floats()
    sover = np.zeros(nh)
    for io in range(no_u):
        sover[listhptr[io] : listhptr[io] + numh[io]] = f.floats()
    f.record()  # qtot, temp
    xij = np.zeros((nh, 3))
    for io in range(no_u):
        row = f.floats().reshape(-1, 3)
        xij[listhptr[io] : listhptr[io] + numh[io]] = row
    nspecies = int(f.ints()[0])
    rec = f.record()  # (label char*20, zval f8?, no int) * nspecies — mixed record
    # layout per write: label(20 bytes), zval(real sp? dp?), no(int)
    # hsx_m writes label, zval, no in one record: char*20 + real(dp) + int
    item = len(rec) // nspecies
    species_no = np.zeros(nspecies, np.int64)
    zval = np.zeros(nspecies)
    for s in range(nspecies):
        chunk = rec[s * item : (s + 1) * item]
        # trailing 4 bytes: int no; preceding 8: double zval
        species_no[s] = struct.unpack_from("<i", chunk, item - 4)[0]
        zval[s] = struct.unpack_from("<d", chunk, item - 12)[0]
    for s in range(nspecies):
        for _ in range(int(species_no[s])):
            f.record()  # nquant, lquant, zeta
    na_u = int(f.ints()[0])
    isa = f.ints()
    pair = f.ints()  # iaorb, iphorb interleaved
    iaorb = pair.reshape(no_u, 2)[:, 0] if len(pair) == 2 * no_u else pair
    return HSXData(no_u=int(no_u), no_s=int(no_s), nspin=int(nspin),
                   indxuo=indxuo, numh=numh, listh=listh,
                   hamilt=hamilt * RY2HA, sover=sover, xij=xij,
                   species_no=species_no, isa=isa, iaorb=iaorb, zval=zval)


@dataclass
class FDFStructure:
    z: np.ndarray
    pos: np.ndarray     # Bohr
    cell: np.ndarray    # Bohr


def parse_fdf(path: str) -> FDFStructure:
    """FDF structure parser."""
    with open(path) as f:
        content = f.read()
    num = r"-?\d+\.?\d*"
    wht = r"\s+"
    lattconst, lattunit = re.compile(
        r"LatticeConstant\s+" + f"({num})" + r"\s+([A-Za-z]+)", re.I
    ).findall(content)[0]
    latt = re.compile(
        r"%block LatticeVectors.*" + f"{wht}({num})" * 9 +
        r"\s+%endblock LatticeVectors", re.I | re.S
    ).findall(content)[0]
    cell = np.array([float(v) for v in latt]).reshape(3, 3) * float(lattconst)
    if lattunit.lower() == "ang":
        cell /= AU2ANG
    unit = re.compile(r"AtomicCoordinatesFormat\s+([A-Za-z]+)", re.I).findall(content)[0]
    sblk = re.compile(
        r"%block ChemicalSpeciesLabel(.+)%endblock ChemicalSpeciesLabel", re.S
    ).findall(content)[0]
    species = {}
    for idx, iz, _name in re.compile(r"\s+(\d+)\s+(\d+)\s+(\w+)").findall(sblk):
        species[int(idx)] = int(iz)
    cblk = re.compile(
        r"%block AtomicCoordinatesAndAtomicSpecies(.+)"
        r"%endblock AtomicCoordinatesAndAtomicSpecies", re.S
    ).findall(content)[0]
    pos, z = [], []
    for c in re.compile(f"{wht}({num}){wht}({num}){wht}({num}){wht}(\\d+)").findall(cblk):
        pos.append([float(c[0]), float(c[1]), float(c[2])])
        z.append(species[int(c[3])])
    pos = np.asarray(pos)
    if unit.lower().startswith("ang"):
        pos /= AU2ANG
    return FDFStructure(z=np.asarray(z, np.int64), pos=pos, cell=cell)


def hsx_to_graph(hsx: HSXData, fdf: FDFStructure) -> Dict[str, np.ndarray]:
    """CSR supercell matrix -> per-edge dense blocks + onsite blocks."""
    na = len(fdf.z)
    invcell = np.linalg.inv(fdf.cell)
    # per-atom orbital counts / offsets in the unit cell
    no = np.array([(hsx.iaorb == a + 1).sum() for a in range(na)], np.int64)
    indo = np.concatenate([[0], np.cumsum(no[:-1])])
    listhptr = np.concatenate([[0], np.cumsum(hsx.numh[:-1])])

    # dense (no_u, no_s) for simplicity (host-side prep; fine at these sizes)
    H = np.zeros((hsx.nspin, hsx.no_u, hsx.no_s))
    S = np.zeros((hsx.no_u, hsx.no_s))
    X = np.zeros((hsx.no_u, hsx.no_s, 3))
    for io in range(hsx.no_u):
        cols = hsx.listh[listhptr[io] : listhptr[io] + hsx.numh[io]] - 1
        H[:, io, cols] = hsx.hamilt[:, listhptr[io] : listhptr[io] + hsx.numh[io]]
        S[io, cols] = hsx.sover[listhptr[io] : listhptr[io] + hsx.numh[io]]
        X[io, cols] = hsx.xij[listhptr[io] : listhptr[io] + hsx.numh[io]]

    src, dst, cshift, nshift = [], [], [], []
    Hon = [[] for _ in range(hsx.nspin)]
    Hoff = [[] for _ in range(hsx.nspin)]
    Son, Soff = [], []
    for ia in range(na):
        rows = slice(indo[ia], indo[ia] + no[ia])
        for jsuper in range(0, hsx.no_s, hsx.no_u):
            for ja in range(na):
                cols = slice(jsuper + indo[ja], jsuper + indo[ja] + no[ja])
                blk_S = S[rows, cols]
                blk_H = H[:, rows, cols]
                if not (np.any(blk_S) or np.any(blk_H)):
                    continue
                nz = np.nonzero(np.any(blk_H, axis=0) | (blk_S != 0))
                xij = X[rows, cols][nz[0][0], nz[1][0]]
                cs = np.round((fdf.pos[ia] - fdf.pos[ja] + xij) @ invcell).astype(int)
                if ia == ja and not cs.any():
                    for s in range(hsx.nspin):
                        Hon[s].append(blk_H[s])
                    Son.append(blk_S)
                else:
                    for s in range(hsx.nspin):
                        Hoff[s].append(blk_H[s])
                    Soff.append(blk_S)
                    src.append(ia)
                    dst.append(ja)
                    cshift.append(cs)
                    nshift.append(cs @ fdf.cell)
    return {
        "edge_src": np.asarray(src, np.int64),
        "edge_dst": np.asarray(dst, np.int64),
        "cell_shift": np.asarray(cshift, np.int64).reshape(-1, 3),
        "nbr_shift": np.asarray(nshift, float).reshape(-1, 3),
        "Hon": Hon, "Hoff": Hoff, "Son": Son, "Soff": Soff,
        "num_orbs": no,
    }


def pack_crystal_siesta(graph: Dict, fdf: FDFStructure, nao_max: int,
                        spin: int = 0) -> Dict[str, np.ndarray]:
    """Dense nao_max^2 rows for the SIESTA basis (graph_data_gen_siesta)."""
    basis = get_basis_set("siesta", nao_max)
    z = fdf.z
    src, dst = graph["edge_src"], graph["edge_dst"]
    inv = inverse_edges(src, dst, graph["cell_shift"])
    out = {
        "z": z, "pos": fdf.pos, "cell": fdf.cell[None],
        "edge_index": np.stack([src, dst]),
        "inv_edge_idx": inv,
        "cell_shift": graph["cell_shift"],
        "nbr_shift": graph["nbr_shift"],
        "Son": _dense_rows(graph["Son"], z, z, basis, nao_max),
        "Soff": _dense_rows(graph["Soff"], z[src], z[dst], basis, nao_max),
    }
    if len(graph["Hon"]) == 1:
        out["Hon"] = _dense_rows(graph["Hon"][0], z, z, basis, nao_max)
        out["Hoff"] = _dense_rows(graph["Hoff"][0], z[src], z[dst], basis, nao_max)
    else:  # collinear: stack spin channels
        out["Hon"] = np.stack([
            _dense_rows(graph["Hon"][s], z, z, basis, nao_max)
            for s in range(len(graph["Hon"]))], axis=1)
        out["Hoff"] = np.stack([
            _dense_rows(graph["Hoff"][s], z[src], z[dst], basis, nao_max)
            for s in range(len(graph["Hoff"]))], axis=1)
    return out


# ----------------------------------------------------------------------
# HSX / FDF writers (synthetic data): inverses of the parsers
# ----------------------------------------------------------------------

_ELEMENT = {1: "H", 6: "C", 8: "O", 14: "Si", 26: "Fe"}


class _FortranWriter:
    def __init__(self):
        self.parts: List[bytes] = []

    def record(self, data: bytes):
        n = struct.pack("<i", len(data))
        self.parts.append(n + data + n)

    def ints(self, a):
        self.record(np.asarray(a, "<i4").tobytes())

    def floats(self, a):
        self.record(np.asarray(a, "<f4").tobytes())

    def doubles(self, a):
        self.record(np.asarray(a, "<f8").tobytes())

    def tobytes(self) -> bytes:
        return b"".join(self.parts)


def write_hsx(path: str, *, z, pos, cell, num_orbs, edge_src, edge_dst,
              cell_shift, Hon, Hoff, Son, Soff, zval=None) -> None:
    """Write a SIESTA ``.HSX`` sparse container that ``parse_hsx`` (and the
    native hsx_reader) round-trips exactly.

    Inputs use this repo's graph conventions: valid-orbital dense blocks per
    atom (``Hon``/``Son``: (no_i, no_i)) and per edge (``Hoff``/``Soff``:
    (no_src, no_dst)); energies in Hartree (stored as Ry single precision,
    the HSX on-disk unit); positions/cell in Bohr.  The SK teacher's SIESTA
    sets (``tools/sk_dataset.py --format siesta``) are written with it.
    """
    z = np.asarray(z)
    pos = np.asarray(pos, float)
    cell = np.asarray(cell, float)
    num_orbs = np.asarray(num_orbs, np.int64)
    edge_src = np.asarray(edge_src, np.int64)
    edge_dst = np.asarray(edge_dst, np.int64)
    cell_shift = np.asarray(cell_shift, np.int64).reshape(-1, 3)
    na = len(z)
    no_u = int(num_orbs.sum())
    indo = np.concatenate([[0], np.cumsum(num_orbs[:-1])])

    # supercell cells: home cell first
    cells = [(0, 0, 0)]
    cell_of = {(0, 0, 0): 0}
    for cs in map(tuple, cell_shift):
        if cs not in cell_of:
            cell_of[cs] = len(cells)
            cells.append(cs)
    n_cells = len(cells)
    no_s = n_cells * no_u

    # per unit-cell-orbital sparse rows
    rows_cols: List[List[int]] = [[] for _ in range(no_u)]
    rows_h: List[List[float]] = [[] for _ in range(no_u)]
    rows_s: List[List[float]] = [[] for _ in range(no_u)]
    rows_x: List[List[np.ndarray]] = [[] for _ in range(no_u)]

    def add_block(ia, ja, cidx, H, S, xij):
        H = np.asarray(H, float)
        S = np.asarray(S, float)
        for r in range(num_orbs[ia]):
            io = indo[ia] + r
            for c in range(num_orbs[ja]):
                col = cidx * no_u + indo[ja] + c + 1  # 1-based
                rows_cols[io].append(col)
                rows_h[io].append(H[r, c] / RY2HA)
                rows_s[io].append(S[r, c])
                rows_x[io].append(xij)

    for ia in range(na):
        add_block(ia, ia, 0, Hon[ia], Son[ia], np.zeros(3))
    for e in range(len(edge_src)):
        ia, ja = int(edge_src[e]), int(edge_dst[e])
        cs = tuple(cell_shift[e])
        xij = pos[ja] - pos[ia] + np.asarray(cs, float) @ cell
        add_block(ia, ja, cell_of[cs], Hoff[e], Soff[e], xij)

    numh = np.array([len(c) for c in rows_cols], np.int64)
    nh = int(numh.sum())

    # species bookkeeping (order of first appearance)
    sp_z: List[int] = []
    for zz in z:
        if int(zz) not in sp_z:
            sp_z.append(int(zz))
    isa = np.array([sp_z.index(int(zz)) + 1 for zz in z], np.int64)
    sp_no = np.zeros(len(sp_z), np.int64)
    for ia in range(na):
        sp_no[isa[ia] - 1] = num_orbs[ia]
    if zval is None:
        basis = get_basis_set("siesta", 19)
        zval_arr = np.array([float(basis.num_valence_table[s]) for s in sp_z])
    else:
        zval_arr = np.asarray([float(zval[s]) for s in sp_z])

    w = _FortranWriter()
    w.ints([no_u, no_s, 1, nh])
    w.ints([0])  # gamma = false
    indxuo = np.tile(np.arange(1, no_u + 1), n_cells)
    w.ints(indxuo)
    w.ints(numh)
    for io in range(no_u):
        w.ints(rows_cols[io])
    for io in range(no_u):  # nspin = 1
        w.floats(rows_h[io])
    for io in range(no_u):
        w.floats(rows_s[io])
    qtot = float(sum(zval_arr[s - 1] for s in isa))
    w.doubles([qtot, 0.0])
    for io in range(no_u):
        w.floats(np.concatenate([np.asarray(x, float) for x in rows_x[io]])
                 if rows_x[io] else np.zeros(0))
    w.ints([len(sp_z)])
    rec = b""
    for s, zz in enumerate(sp_z):
        label = _ELEMENT.get(zz, f"Z{zz}").encode().ljust(20)
        rec += label + struct.pack("<d", zval_arr[s]) + struct.pack(
            "<i", int(sp_no[s]))
    w.record(rec)
    for s in range(len(sp_z)):
        for o in range(int(sp_no[s])):
            w.ints([1, 0, 1])  # nquant, lquant, zeta (skipped by readers)
    w.ints([na])
    w.ints(isa)
    pair = np.zeros(2 * no_u, np.int64)
    io = 0
    for ia in range(na):
        for o in range(num_orbs[ia]):
            pair[2 * io] = ia + 1
            pair[2 * io + 1] = o + 1
            io += 1
    w.ints(pair)
    with open(path, "wb") as f:
        f.write(w.tobytes())


def write_fdf(path: str, *, z, pos, cell) -> None:
    """Minimal FDF structure file (Bohr inputs) that parse_fdf reads back."""
    z = np.asarray(z)
    pos_ang = np.asarray(pos, float) * AU2ANG
    cell_ang = np.asarray(cell, float) * AU2ANG
    sp = []
    for zz in z:
        if int(zz) not in sp:
            sp.append(int(zz))
    lines = ["LatticeConstant 1.0 Ang", "%block LatticeVectors"]
    for row in cell_ang:
        lines.append("  " + "  ".join(f"{v:.10f}" for v in row))
    lines += ["%endblock LatticeVectors", "AtomicCoordinatesFormat Ang",
              "%block ChemicalSpeciesLabel"]
    for i, zz in enumerate(sp):
        lines.append(f"  {i + 1}  {zz}  {_ELEMENT.get(zz, f'Z{zz}')}")
    lines += ["%endblock ChemicalSpeciesLabel",
              "%block AtomicCoordinatesAndAtomicSpecies"]
    for p, zz in zip(pos_ang, z):
        lines.append("  " + "  ".join(f"{v:.10f}" for v in p)
                     + f"  {sp.index(int(zz)) + 1}")
    lines += ["%endblock AtomicCoordinatesAndAtomicSpecies"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
