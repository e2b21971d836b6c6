"""Periodic neighbor list (numpy), a copy of the part of
``hamgnn_tpu/data/neighborlist.py`` that builds synthetic crystals and sizes
basis functions: edges within a cutoff under periodic boundary conditions,
the inverse-edge index via the (src, dst, shift) <-> (dst, src, -shift) map,
and the per-species basis radii (``radii_for_z``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

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

# Per-species basis radii in Bohr (the reference's base_model.py tables).
ATOMIC_RADII: Dict[str, Dict[str, float]] = {
    "openmx": {
        "H": 6.0, "He": 8.0, "Li": 8.0, "Be": 7.0, "B": 7.0, "C": 6.0,
        "N": 6.0, "O": 6.0, "F": 6.0, "Ne": 9.0, "Na": 9.0, "Mg": 9.0,
        "Al": 7.0, "Si": 7.0, "P": 7.0, "S": 7.0, "Cl": 7.0, "Ar": 9.0,
        "K": 10.0, "Ca": 9.0, "Sc": 9.0, "Ti": 7.0, "V": 6.0, "Cr": 6.0,
        "Mn": 6.0, "Fe": 5.5, "Co": 6.0, "Ni": 6.0, "Cu": 6.0, "Zn": 6.0,
        "Ga": 7.0, "Ge": 7.0, "As": 7.0, "Se": 7.0, "Br": 7.0, "Kr": 10.0,
        "Rb": 11.0, "Sr": 10.0, "Y": 10.0, "Zr": 7.0, "Nb": 7.0, "Mo": 7.0,
        "Tc": 7.0, "Ru": 7.0, "Rh": 7.0, "Pd": 7.0, "Ag": 7.0, "Cd": 7.0,
        "In": 7.0, "Sn": 7.0, "Sb": 7.0, "Te": 7.0, "I": 7.0, "Xe": 11.0,
        "Cs": 12.0, "Ba": 10.0, "La": 8.0, "Ce": 8.0, "Pr": 8.0, "Nd": 8.0,
        "Pm": 8.0, "Sm": 8.0, "Dy": 8.0, "Ho": 8.0, "Lu": 8.0, "Hf": 9.0,
        "Ta": 7.0, "W": 7.0, "Re": 7.0, "Os": 7.0, "Ir": 7.0, "Pt": 7.0,
        "Au": 7.0, "Hg": 8.0, "Tl": 8.0, "Pb": 8.0, "Bi": 8.0,
    },
    "siesta": {},
    "abacus": {
        "Ag": 7, "Cu": 8, "Mo": 7, "Sc": 8, "Al": 7, "Fe": 8, "Na": 8,
        "Se": 8, "Ar": 7, "F": 7, "Nb": 8, "S": 7, "As": 7, "Ga": 8,
        "Ne": 6, "Si": 7, "Au": 7, "Ge": 8, "N": 7, "Sn": 7, "Ba": 10,
        "He": 6, "Ni": 8, "Sr": 9, "Be": 7, "Hf": 7, "O": 7, "Ta": 8,
        "B": 8, "H": 6, "Os": 7, "Tc": 7, "Bi": 7, "Hg": 9, "Pb": 7,
        "Te": 7, "Br": 7, "I": 7, "Pd": 7, "Ti": 8, "Ca": 9, "In": 7,
        "P": 7, "Tl": 7, "Cd": 7, "Ir": 7, "Pt": 7, "V": 8, "C": 7,
        "K": 9, "Rb": 10, "W": 8, "Cl": 7, "Kr": 7, "Re": 7, "Xe": 8,
        "Co": 8, "Li": 7, "Rh": 7, "Y": 8, "Cr": 8, "Mg": 8, "Ru": 7,
        "Zn": 8, "Cs": 10, "Mn": 8, "Sb": 7, "Zr": 8,
    },
}


def radii_for_z(z: np.ndarray, radius_type: str = "openmx",
                radius_scale: float = 1.0) -> np.ndarray:
    """Per-atom basis radii (Bohr) for atomic numbers z."""
    table = ATOMIC_RADII[radius_type]
    out = np.zeros(len(z))
    for i, zi in enumerate(np.asarray(z)):
        sym = _SYMBOLS[int(zi)]
        if sym not in table:
            raise KeyError(f"no {radius_type} radius for element {sym} (Z={zi})")
        out[i] = table[sym] * radius_scale
    return out


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
