"""Periodic neighbor list (numpy), a copy of the part of
``hamgnn_tpu/data/neighborlist.py`` that builds synthetic crystals: edges
within a cutoff under periodic boundary conditions, and the inverse-edge
index via the (src, dst, shift) <-> (dst, src, -shift) map.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np


# element symbols by atomic number (0 = pad)
_SYMBOLS = [
    "X", "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne", "Na", "Mg",
    "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca", "Sc", "Ti", "V", "Cr", "Mn",
    "Fe", "Co", "Ni", "Cu", "Zn", "Ga", "Ge", "As", "Se", "Br", "Kr", "Rb",
    "Sr", "Y", "Zr", "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd", "In",
    "Sn", "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd", "Pm",
    "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb", "Lu", "Hf", "Ta",
    "W", "Re", "Os", "Ir", "Pt", "Au", "Hg", "Tl", "Pb", "Bi",
]


def _image_ranges(cell: np.ndarray, cutoff: float, pbc) -> Tuple[int, int, int]:
    """Number of periodic images needed along each lattice vector."""
    inv = np.linalg.inv(cell)
    heights = 1.0 / np.linalg.norm(inv, axis=1)  # plane spacings
    n = np.where(pbc, np.ceil(cutoff / heights).astype(int), 0)
    return tuple(int(v) for v in n)


def neighbor_list_pbc(
    pos: np.ndarray,
    cell: Optional[np.ndarray],
    cutoff: Union[float, np.ndarray],
    pbc: Union[bool, Tuple[bool, bool, bool]] = True,
    self_interaction: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Edges within cutoff under periodic boundary conditions.

    Args:
      pos: (N, 3) positions.
      cell: (3, 3) lattice rows, or None for open boundaries.
      cutoff: scalar, or per-atom radii r (pair cutoff r_i + r_j).
      self_interaction: keep (i, i, 0) self edges.

    Returns (edge_index (2, E) int64, cell_shift (E, 3) int64,
    nbr_shift (E, 3) float).  Edge convention: edge_index[0]=src i,
    edge_index[1]=dst j, vector = pos[j] + shift - pos[i].
    """
    pos = np.asarray(pos, dtype=np.float64)
    n = pos.shape[0]
    if isinstance(pbc, bool):
        pbc = (pbc,) * 3
    if cell is None:
        cell = np.eye(3) * (np.ptp(pos, axis=0).max() + 1.0)
        pbc = (False, False, False)
    cell = np.asarray(cell, dtype=np.float64).reshape(3, 3)

    per_atom = not np.isscalar(cutoff)
    if per_atom:
        radii = np.asarray(cutoff, dtype=np.float64)
        max_cut = float(2.0 * radii.max())
    else:
        max_cut = float(cutoff)

    nx, ny, nz = _image_ranges(cell, max_cut, pbc)
    shifts = np.array([
        (sx, sy, sz)
        for sx in range(-nx, nx + 1)
        for sy in range(-ny, ny + 1)
        for sz in range(-nz, nz + 1)
    ], dtype=np.int64)

    src_all, dst_all, shift_all = [], [], []
    for S in shifts:
        disp = pos[None, :, :] + (S.astype(np.float64) @ cell)[None, None, :] - pos[:, None, :]
        d2 = np.sum(disp * disp, axis=-1)  # (N, N) center i -> neighbor j
        if per_atom:
            cut = radii[:, None] + radii[None, :]
        else:
            cut = max_cut
        hit = d2 <= np.square(cut)
        if not S.any():
            if not self_interaction:
                np.fill_diagonal(hit, False)
        ii, jj = np.nonzero(hit)
        if len(ii):
            src_all.append(ii)
            dst_all.append(jj)
            shift_all.append(np.broadcast_to(S, (len(ii), 3)))

    if not src_all:
        return (np.zeros((2, 0), np.int64), np.zeros((0, 3), np.int64),
                np.zeros((0, 3)))
    src = np.concatenate(src_all)
    dst = np.concatenate(dst_all)
    cell_shift = np.concatenate(shift_all)
    edge_index = np.stack([src, dst])
    nbr_shift = cell_shift.astype(np.float64) @ cell
    return edge_index, cell_shift, nbr_shift


def inverse_edge_index(edge_index: np.ndarray, cell_shift: np.ndarray) -> np.ndarray:
    """Index of each edge's inverse (dst, src, -shift); raises if missing."""
    key = {}
    src, dst = edge_index
    for e in range(edge_index.shape[1]):
        key[(int(src[e]), int(dst[e]), tuple(int(v) for v in cell_shift[e]))] = e
    inv = np.full(edge_index.shape[1], -1, dtype=np.int64)
    for e in range(edge_index.shape[1]):
        k = (int(dst[e]), int(src[e]), tuple(-int(v) for v in cell_shift[e]))
        inv[e] = key.get(k, -1)
    if np.any(inv < 0):
        raise RuntimeError("some edges lack an inverse edge")
    return inv
