"""OpenMX interface: SCFOUT v3 parsing and graph_data packing, the port's
counterpart of ``hamgnn_tpu/interfaces/openmx.py`` (numpy, host only).

  * :func:`parse_scfout` reads the SCFOUT v3 binary (header, periodic-image
    tables, per-atom orbital and neighbour tables, Hks[spin], iHks (SOC), OLP,
    D_OLP, OLP_L, DM/iDM, solver and chemp trailer), with the postprocess
    extension (overlap derivatives, angular momentum) or without it;
  * :func:`parse_scfout_native` runs the port's C++ reader
    (``hamgnn_tpu_torch/native/scfout_reader.cpp``, built on first use) and
    :func:`scfout_from_native` turns its JSON into the same
    :class:`ScfoutData`, element for element;
  * :func:`pack_crystal` packs dense nao_max^2 rows through the basis_def
    masks, including the SOC 2x2 spin packing.
"""

from __future__ import annotations

import json
import struct
import subprocess
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..models.basis import get_basis_set, validate_elements_in_basis_def
from .native import native_tool


@dataclass
class ScfoutData:
    atomnum: int
    spinp_switch: int          # 0 non-spin, 1 collinear, 3 non-collinear/SOC
    cell: np.ndarray           # (3, 3) Bohr
    pos: np.ndarray            # (N, 3) Bohr
    num_orbs: np.ndarray       # (N,)
    edge_src: np.ndarray       # (E,) 0-based
    edge_dst: np.ndarray       # (E,)
    cell_shift: np.ndarray     # (E, 3)
    nbr_shift: np.ndarray      # (E, 3) Bohr
    Hon: List[List[np.ndarray]]   # [spin][atom] (no_i, no_i)
    Hoff: List[List[np.ndarray]]  # [spin][edge] (no_i, no_j)
    iHon: Optional[List[List[np.ndarray]]]
    iHoff: Optional[List[List[np.ndarray]]]
    Son: List[np.ndarray]
    Soff: List[np.ndarray]
    Lon: Optional[List[np.ndarray]]   # (no_i, no_i, 3)
    Loff: Optional[List[np.ndarray]]
    dSon: Optional[List[np.ndarray]] = None   # overlap derivative blocks
    dSoff: Optional[List[np.ndarray]] = None
    chemp: float = 0.0
    valence_electrons: float = 0.0


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.ofs = 0
        self.swap = False

    def ints(self, n):
        fmt = (">" if self.swap else "<") + f"{n}i"
        out = np.asarray(struct.unpack_from(fmt, self.buf, self.ofs), np.int64)
        self.ofs += 4 * n
        return out

    def doubles(self, n):
        fmt = (">" if self.swap else "<") + f"{n}d"
        out = np.asarray(struct.unpack_from(fmt, self.buf, self.ofs))
        self.ofs += 8 * n
        return out


def parse_scfout(path: str, with_postprocess_ext: bool = True) -> ScfoutData:
    """Parse an OpenMX SCFOUT v3 file (optionally with the postprocess
    extensions D_OLP / OLP_L that the reference's modified exporter writes)."""
    with open(path, "rb") as f:
        r = _Reader(f.read())

    head = r.ints(6)
    if not (0 <= head[1] <= 15):  # byte order: the spin/version word is small
        r.swap = True
        r.ofs = 0
        head = r.ints(6)
    atomnum = int(head[0])
    spinp = int(head[1]) % 4
    version = int(head[1]) // 4
    if version != 3:
        raise ValueError(f"unsupported scfout version {version} (need 3)")
    tcpycell = int(head[5])

    r.ints(1)  # order_max
    atv = r.doubles(4 * (tcpycell + 1)).reshape(tcpycell + 1, 4)
    atv_ijk = r.ints(4 * (tcpycell + 1)).reshape(tcpycell + 1, 4)
    num_orbs = r.ints(atomnum)
    fnan = r.ints(atomnum)
    natn = [r.ints(fnan[a] + 1) for a in range(atomnum)]
    ncn = [r.ints(fnan[a] + 1) for a in range(atomnum)]
    tv = np.stack([r.doubles(4)[1:] for _ in range(3)])
    r.doubles(4 * 3)  # rtv
    pos = np.stack([r.doubles(4)[1:] for _ in range(atomnum)])

    def read_blocks(per_spin: int, vec: int = 1):
        out_spin = []
        for _ in range(per_spin):
            on, off = [], []
            for a in range(atomnum):
                no1 = int(num_orbs[a])
                for h in range(int(fnan[a]) + 1):
                    gh = int(natn[a][h]) - 1
                    no2 = int(num_orbs[gh])
                    blk = r.doubles(no1 * no2 * vec).reshape(
                        (no1, no2) if vec == 1 else (no1, no2, vec))
                    (on if h == 0 else off).append(blk)
            out_spin.append((on, off))
        return out_spin

    hks = read_blocks(spinp + 1)
    ihks = read_blocks(3) if spinp == 3 else None
    olp = read_blocks(1)[0]
    if with_postprocess_ext:
        dolp = read_blocks(1, vec=3)[0]   # overlap derivatives (dS)
        olp_l = read_blocks(1, vec=3)[0]  # angular momentum matrices
    else:
        dolp = None
        olp_l = None
    _dm = read_blocks(spinp + 1)
    _idm = read_blocks(2)
    r.ints(1)  # solver
    d = r.doubles(10)
    chemp, valence = float(d[0]), float(d[8])

    # edge tables (0-based)
    src, dst, shifts, nshift = [], [], [], []
    for a in range(atomnum):
        for h in range(1, int(fnan[a]) + 1):
            src.append(a)
            dst.append(int(natn[a][h]) - 1)
            rn = int(ncn[a][h])
            shifts.append(atv_ijk[rn][1:4])
            nshift.append(atv[rn][1:4])

    Hon = [s[0] for s in hks]
    Hoff = [s[1] for s in hks]
    iHon = [s[0] for s in ihks] if ihks else None
    iHoff = [s[1] for s in ihks] if ihks else None

    return ScfoutData(
        atomnum=atomnum, spinp_switch=spinp, cell=tv, pos=pos,
        num_orbs=num_orbs,
        edge_src=np.asarray(src, np.int64), edge_dst=np.asarray(dst, np.int64),
        cell_shift=np.asarray(shifts, np.int64).reshape(-1, 3),
        nbr_shift=np.asarray(nshift, float).reshape(-1, 3),
        Hon=Hon, Hoff=Hoff, iHon=iHon, iHoff=iHoff,
        Son=olp[0], Soff=olp[1],
        Lon=olp_l[0] if olp_l else None,
        Loff=olp_l[1] if olp_l else None,
        dSon=dolp[0] if dolp else None,
        dSoff=dolp[1] if dolp else None,
        chemp=chemp, valence_electrons=valence,
    )


def native_reader_path() -> str:
    """The port's native scfout reader, built on first use."""
    return native_tool("scfout_reader")


def parse_scfout_native(path: str, out_json: Optional[str] = None,
                        with_postprocess_ext: bool = True) -> Dict:
    """Run the native reader and load its JSON: the fields of
    :class:`ScfoutData` with the blocks as flat rows."""
    out_json = out_json or (path + ".HS.json")
    cmd = [native_reader_path(), path, out_json]
    if not with_postprocess_ext:
        cmd.append("--standard")
    subprocess.run(cmd, check=True)
    with open(out_json) as f:
        return json.load(f)


def scfout_from_native(d: Dict) -> ScfoutData:
    """:class:`ScfoutData` from the native reader's JSON, element-identical
    to :func:`parse_scfout` on the same file."""
    num_orbs = np.asarray(d["num_orbs"], np.int64)
    src = np.asarray(d["edge_src"], np.int64)
    dst = np.asarray(d["edge_dst"], np.int64)

    def blocks(rows, on: bool, vec: int = 1):
        shape = [(num_orbs[a], num_orbs[a]) for a in range(len(num_orbs))] if on else \
            [(num_orbs[s], num_orbs[t]) for s, t in zip(src, dst)]
        return [np.asarray(r, np.float64).reshape(sh if vec == 1 else sh + (vec,))
                for r, sh in zip(rows, shape)]

    def spins(key, on):
        return [blocks(s, on) for s in d[key]] if key in d else None

    def vec3(key, on):
        return blocks(d[key], on, vec=3) if key in d else None

    return ScfoutData(
        atomnum=len(num_orbs), spinp_switch=int(d["spinp_switch"]),
        cell=np.asarray(d["cell"], np.float64).reshape(3, 3),
        pos=np.asarray(d["pos"], np.float64).reshape(-1, 3),
        num_orbs=num_orbs, edge_src=src, edge_dst=dst,
        cell_shift=np.asarray(d["cell_shift"], np.int64).reshape(-1, 3),
        nbr_shift=np.asarray(d["nbr_shift"], np.float64).reshape(-1, 3),
        Hon=spins("Hon", True), Hoff=spins("Hoff", False),
        iHon=spins("iHon", True), iHoff=spins("iHoff", False),
        Son=blocks(d["Son"], True), Soff=blocks(d["Soff"], False),
        Lon=vec3("Lon", True), Loff=vec3("Loff", False),
        dSon=vec3("dSon", True), dSoff=vec3("dSoff", False),
        chemp=float(d["chemp"]), valence_electrons=float(d["valence_electrons"]),
    )


def inverse_edges(src, dst, cell_shift) -> np.ndarray:
    key = {}
    for e in range(len(src)):
        key[(int(src[e]), int(dst[e]), tuple(int(v) for v in cell_shift[e]))] = e
    inv = np.full(len(src), -1, np.int64)
    for e in range(len(src)):
        inv[e] = key.get(
            (int(dst[e]), int(src[e]), tuple(-int(v) for v in cell_shift[e])), -1)
    if (inv < 0).any():
        raise RuntimeError("missing inverse edges in scfout data")
    return inv


def _dense_rows(blocks: List[np.ndarray], z_rows, z_cols, basis, nao: int):
    """Scatter per-pair (no_i, no_j) blocks into dense nao^2 rows via
    basis_def masks."""
    out = np.zeros((len(blocks), nao * nao))
    for n, blk in enumerate(blocks):
        oi = np.asarray(basis.basis_def[int(z_rows[n])], int)
        oj = np.asarray(basis.basis_def[int(z_cols[n])], int)
        dense = np.zeros((nao, nao))
        dense[oi[:, None], oj[None, :]] = blk
        out[n] = dense.ravel()
    return out


def pack_crystal(
    scf: ScfoutData,
    z: np.ndarray,
    nao_max: int,
    scf0: Optional[ScfoutData] = None,
    soc: bool = False,
    total_energy: float = 0.0,
    doping_charge: float = 0.0,
) -> Dict[str, np.ndarray]:
    """Build a reference-format crystal dict from parsed scfout data
    (+ optional H0 scfout from the non-SCF postprocess run)."""
    basis = get_basis_set("openmx", nao_max)
    nao = nao_max
    n = scf.atomnum
    src, dst = scf.edge_src, scf.edge_dst
    inv = inverse_edges(src, dst, scf.cell_shift)
    z = np.asarray(z, np.int64)
    # fail fast on elements without a basis_def entry
    validate_elements_in_basis_def(z, basis)

    out = {
        "z": z,
        "cell": scf.cell[None],
        "pos": scf.pos,
        "edge_index": np.stack([src, dst]),
        "inv_edge_idx": inv,
        "nbr_shift": scf.nbr_shift,
        "cell_shift": scf.cell_shift,
        "total_energy": np.asarray([total_energy]),
        "doping_charge": np.asarray([doping_charge]),
    }

    def rows_on(blocks):
        return _dense_rows(blocks, z, z, basis, nao)

    def rows_off(blocks):
        return _dense_rows(blocks, z[src], z[dst], basis, nao)

    Son = rows_on(scf.Son)
    Soff = rows_off(scf.Soff)
    out["Son"], out["Soff"] = Son, Soff
    out["overlap"] = np.concatenate([Son, Soff], 0)

    if not soc:
        out["Hon"] = rows_on(scf.Hon[0])
        out["Hoff"] = rows_off(scf.Hoff[0])
        out["hamiltonian"] = np.concatenate([out["Hon"], out["Hoff"]], 0)
        if scf0 is not None:
            out["Hon0"] = rows_on(scf0.Hon[0])
            out["Hoff0"] = rows_off(scf0.Hoff[0])
        return out

    # SOC packing: spin components
    # Hks = (uu, dd, ud_re, ud_im2) and iHks = (iuu, idd, iud) mapped to
    # real/imag (2 nao)^2 blocks with NO transposes:
    #   Hr = [[uu, ud_re], [ud_re, dd]];
    #   Hi = [[iuu, ud_im2+iud], [-(ud_im2+iud), idd]].
    def soc_rows(Hs, iHs, on: bool):
        rows = rows_on if on else rows_off
        uu = rows(Hs[0]).reshape(-1, nao, nao)
        dd = rows(Hs[1]).reshape(-1, nao, nao)
        udr = rows(Hs[2]).reshape(-1, nao, nao)
        udi = rows(Hs[3]).reshape(-1, nao, nao)
        if iHs is not None:
            udi = udi + rows(iHs[2]).reshape(-1, nao, nao)
            iuu = rows(iHs[0]).reshape(-1, nao, nao)
            idd = rows(iHs[1]).reshape(-1, nao, nao)
        else:
            iuu = np.zeros_like(uu)
            idd = np.zeros_like(dd)
        m = uu.shape[0]
        Hr = np.zeros((m, 2 * nao, 2 * nao))
        Hi = np.zeros((m, 2 * nao, 2 * nao))
        Hr[:, :nao, :nao] = uu
        Hr[:, :nao, nao:] = udr
        Hr[:, nao:, :nao] = udr
        Hr[:, nao:, nao:] = dd
        Hi[:, :nao, :nao] = iuu
        Hi[:, :nao, nao:] = udi
        Hi[:, nao:, :nao] = -udi
        Hi[:, nao:, nao:] = idd
        return Hr.reshape(m, -1), Hi.reshape(m, -1)

    Hr_on, Hi_on = soc_rows(scf.Hon, scf.iHon, True)
    Hr_off, Hi_off = soc_rows(scf.Hoff, scf.iHoff, False)
    out["Hon"], out["iHon"] = Hr_on, Hi_on
    out["Hoff"], out["iHoff"] = Hr_off, Hi_off
    if scf0 is not None:
        H0r_on, H0i_on = soc_rows(scf0.Hon, scf0.iHon, True)
        H0r_off, H0i_off = soc_rows(scf0.Hoff, scf0.iHoff, False)
        out["Hon0"], out["iHon0"] = H0r_on, H0i_on
        out["Hoff0"], out["iHoff0"] = H0r_off, H0i_off
    if scf.dSon is not None:
        out["dSon"] = np.stack([
            _dense_rows([b[..., k] for b in scf.dSon], z, z, basis, nao)
            for k in range(3)], axis=-1)
        out["dSoff"] = np.stack([
            _dense_rows([b[..., k] for b in scf.dSoff], z[src], z[dst], basis, nao)
            for k in range(3)], axis=-1)
    if scf.Lon is not None:
        out["Lon"] = np.stack([
            _dense_rows([b[..., k] for b in scf.Lon], z, z, basis, nao)
            for k in range(3)], axis=-1)
        out["Loff"] = np.stack([
            _dense_rows([b[..., k] for b in scf.Loff], z[src], z[dst], basis, nao)
            for k in range(3)], axis=-1)
    return out
