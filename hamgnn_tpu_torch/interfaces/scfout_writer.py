"""SCFOUT v3 binary writer (postprocess-extended layout), the port's
counterpart of ``hamgnn_tpu/interfaces/scfout_writer.py``: the same arrays
give the same bytes.

The inverse of :func:`hamgnn_tpu_torch.interfaces.openmx.parse_scfout`:

  6-int header [atomnum, 4*version+spinp, Cat, Lat, Rat, TCpyCell], order_max,
  atv (TCpyCell+1, 4) doubles, atv_ijk ints, Total_NumOrbs, FNAN, natn, ncn,
  tv/rtv (rows of 4 doubles, slot 0 unused), Gxyz, Hks[spin+1],
  iHks[3] (spinp==3 only), OLP, D_OLP (vec 3), OLP_L (vec 3), DM[spin+1],
  iDM[2], Solver int, 10-double trailer (ChemP at [0], valence electrons [8]).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def _pack_ints(vals) -> bytes:
    return np.asarray(vals, dtype=np.int32).astype("<i4").tobytes()


def _pack_doubles(vals) -> bytes:
    return np.asarray(vals, dtype=np.float64).astype("<f8").tobytes()


def write_scfout(
    path: str,
    *,
    cell: np.ndarray,                 # (3, 3) Bohr, lattice rows
    pos: np.ndarray,                  # (N, 3) Bohr
    num_orbs: Sequence[int],          # (N,) orbitals per atom
    edge_src: np.ndarray,             # (E,) 0-based
    edge_dst: np.ndarray,             # (E,)
    cell_shift: np.ndarray,           # (E, 3) integer images
    Hon: Sequence[Sequence[np.ndarray]],   # [spin][atom] (no_i, no_i)
    Hoff: Sequence[Sequence[np.ndarray]],  # [spin][edge] (no_i, no_j)
    Son: Sequence[np.ndarray],
    Soff: Sequence[np.ndarray],
    iHon: Optional[Sequence[Sequence[np.ndarray]]] = None,
    iHoff: Optional[Sequence[Sequence[np.ndarray]]] = None,
    Lon: Optional[Sequence[np.ndarray]] = None,    # (no_i, no_i, 3)
    Loff: Optional[Sequence[np.ndarray]] = None,
    dSon: Optional[Sequence[np.ndarray]] = None,
    dSoff: Optional[Sequence[np.ndarray]] = None,
    chemp: float = 0.0,
    valence_electrons: float = 0.0,
    solver: int = 2,
    e_temp: float = 300.0,
) -> None:
    """Write an SCFOUT v3 file with the postprocess D_OLP/OLP_L extensions.

    ``Hon``/``Hoff`` carry one list per spin component (1 for non-spin, 4 for
    non-collinear where iHon/iHoff must also be given with 3 components).
    Edges must be grouped so that, per source atom, they appear in a stable
    order; this function performs the grouping itself from ``edge_src``.
    """
    cell = np.asarray(cell, np.float64).reshape(3, 3)
    pos = np.asarray(pos, np.float64).reshape(-1, 3)
    n = pos.shape[0]
    num_orbs = np.asarray(num_orbs, np.int64)
    edge_src = np.asarray(edge_src, np.int64)
    edge_dst = np.asarray(edge_dst, np.int64)
    cell_shift = np.asarray(cell_shift, np.int64).reshape(-1, 3)
    nspin = len(Hon)
    spinp = {1: 0, 2: 1, 4: 3}[nspin]

    # periodic-image table: index 0 must be the home cell (ncn==0 -> R=0).
    shifts = [(0, 0, 0)]
    seen = {(0, 0, 0): 0}
    image_of_edge = np.zeros(edge_src.size, np.int64)
    for e in range(edge_src.size):
        key = tuple(int(v) for v in cell_shift[e])
        if key not in seen:
            seen[key] = len(shifts)
            shifts.append(key)
        image_of_edge[e] = seen[key]
    tcpycell = len(shifts) - 1
    atv_ijk = np.zeros((tcpycell + 1, 4), np.int64)
    atv = np.zeros((tcpycell + 1, 4), np.float64)
    for rn, s in enumerate(shifts):
        atv_ijk[rn, 1:] = s
        atv[rn, 1:] = np.asarray(s, np.float64) @ cell

    # group edges per source atom (h_AN order = file order)
    per_atom_edges: List[List[int]] = [[] for _ in range(n)]
    for e in range(edge_src.size):
        per_atom_edges[int(edge_src[e])].append(e)
    fnan = np.array([len(g) for g in per_atom_edges], np.int64)

    out = bytearray()
    out += _pack_ints([n, 4 * 3 + spinp, 0, 0, 0, tcpycell])
    out += _pack_ints([1])  # order_max
    out += _pack_doubles(atv)
    out += _pack_ints(atv_ijk)
    out += _pack_ints(num_orbs)
    out += _pack_ints(fnan)
    for a in range(n):
        out += _pack_ints([a + 1] + [int(edge_dst[e]) + 1 for e in per_atom_edges[a]])
    for a in range(n):
        out += _pack_ints([0] + [int(image_of_edge[e]) for e in per_atom_edges[a]])
    rtv = 2.0 * np.pi * np.linalg.inv(cell).T
    for row in cell:
        out += _pack_doubles([0.0, *row])
    for row in rtv:
        out += _pack_doubles([0.0, *row])
    for p in pos:
        out += _pack_doubles([0.0, *p])

    def emit_blocks(on: Sequence[np.ndarray], off: Sequence[np.ndarray], vec: int = 1):
        nonlocal out
        for a in range(n):
            blk = np.asarray(on[a], np.float64)
            assert blk.shape[:2] == (num_orbs[a], num_orbs[a]), (a, blk.shape)
            out += _pack_doubles(blk)
            for e in per_atom_edges[a]:
                b = np.asarray(off[e], np.float64)
                assert b.shape[:2] == (num_orbs[a], num_orbs[int(edge_dst[e])])
                out += _pack_doubles(b)

    for s in range(nspin):
        emit_blocks(Hon[s], Hoff[s])
    if spinp == 3:
        assert iHon is not None and iHoff is not None
        for s in range(3):
            emit_blocks(iHon[s], iHoff[s])
    emit_blocks(Son, Soff)

    def zeros_vec3():
        on = [np.zeros((num_orbs[a], num_orbs[a], 3)) for a in range(n)]
        off = [np.zeros((num_orbs[int(edge_src[e])], num_orbs[int(edge_dst[e])], 3))
               for e in range(edge_src.size)]
        return on, off

    d_on, d_off = (dSon, dSoff) if dSon is not None else zeros_vec3()
    emit_blocks(d_on, d_off, vec=3)
    l_on, l_off = (Lon, Loff) if Lon is not None else zeros_vec3()
    emit_blocks(l_on, l_off, vec=3)

    # DM (spin+1) and iDM (2): zeros — not consumed by the graph pipeline.
    z_on = [np.zeros((num_orbs[a], num_orbs[a])) for a in range(n)]
    z_off = [np.zeros((num_orbs[int(edge_src[e])], num_orbs[int(edge_dst[e])]))
             for e in range(edge_src.size)]
    for _ in range(nspin):
        emit_blocks(z_on, z_off)
    for _ in range(2):
        emit_blocks(z_on, z_off)

    out += _pack_ints([solver])
    trailer = np.zeros(10)
    trailer[0] = chemp
    trailer[1] = e_temp
    trailer[8] = valence_electrons
    out += _pack_doubles(trailer)

    with open(path, "wb") as f:
        f.write(bytes(out))
