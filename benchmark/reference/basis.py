# Frozen copy of hamgnn_tpu_torch/models/basis.py, with its imports rewritten.
"""NAO basis tables for OpenMX / SIESTA / ABACUS Hamiltonians.

A copy of ``hamgnn_tpu/models/basis.py`` (which cannot be imported without
jax), tested element-exact against it.  Pure data: per-(ham_type,
nao_max) orbital irreps of the basis (``row == col``), the ``index_change``
permutation and ``minus_index`` sign flips that map the internal real-SH
ordering to each DFT code's orbital ordering, per-element valid-orbital lists
(``basis_def``) and valence electron counts (``num_valence``).

These tables define the data contract with the DFT interfaces; they are not
algorithmic code.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .irreps import Irreps

MAX_Z = 99  # lookup-table size, covers the periodic table slice used


@dataclasses.dataclass(frozen=True)
class BasisSetInfo:
    ham_type: str
    nao_max: int
    orbital_irreps: Irreps                  # "row" == "col" irreps
    index_change: Optional[np.ndarray]      # permutation internal -> DFT order
    minus_index: Optional[np.ndarray]       # DFT-order indices with sign flip
    basis_def: Dict[int, List[int]]         # Z -> valid orbital indices (DFT order)
    num_valence: Dict[int, int]             # Z -> valence electron count

    @property
    def orbital_mask_table(self) -> np.ndarray:
        """(MAX_Z, nao_max) 0/1 table of valid orbitals per atomic number."""
        t = np.zeros((MAX_Z, self.nao_max), dtype=np.float32)
        for z, idx in self.basis_def.items():
            if z < MAX_Z:
                t[z, np.asarray(idx, dtype=int)] = 1.0
        return t

    @property
    def num_valence_table(self) -> np.ndarray:
        t = np.zeros((MAX_Z,), dtype=np.float32)
        for z, v in self.num_valence.items():
            if z < MAX_Z:
                t[z] = v
        return t

    @property
    def num_orbital_table(self) -> np.ndarray:
        """(MAX_Z,) count of valid orbitals; nao_max for unknown elements."""
        t = np.full((MAX_Z,), self.nao_max, dtype=np.int32)
        for z, idx in self.basis_def.items():
            if z < MAX_Z:
                t[z] = len(idx)
        return t


# ---------------------------------------------------------------------------
# OpenMX (reference hamgnn_output.py:345-527)
# ---------------------------------------------------------------------------

_OPENMX_NUM_VALENCE = {
    1: 1, 2: 2, 3: 3, 4: 2, 5: 3, 6: 4, 7: 5, 8: 6, 9: 7, 10: 8,
    11: 9, 12: 8, 13: 3, 14: 4, 15: 5, 16: 6, 17: 7, 18: 8, 19: 9, 20: 10,
    21: 11, 22: 12, 23: 13, 24: 14, 25: 15, 26: 16, 27: 17, 28: 18, 29: 19, 30: 20,
    31: 13, 32: 4, 33: 15, 34: 6, 35: 7, 36: 8, 37: 9, 38: 10, 39: 11, 40: 12,
    41: 13, 42: 14, 43: 15, 44: 14, 45: 15, 46: 16, 47: 17, 48: 12, 49: 13, 50: 14,
    51: 15, 52: 16, 53: 7, 54: 8, 55: 9, 56: 10, 57: 11, 58: 12, 59: 13, 60: 14,
    61: 15, 62: 16, 66: 20, 67: 21, 71: 11, 72: 12, 73: 13, 74: 12, 75: 15, 76: 14,
    77: 15, 78: 16, 79: 17, 80: 18, 81: 19, 82: 14, 83: 15,
}


def _expand(*groups):
    out = []
    for g in groups:
        out.extend(g)
    return out


def _openmx_nao14():
    index_change = np.array([0, 1, 2, 5, 3, 4, 8, 6, 7, 11, 13, 9, 12, 10])
    irreps = Irreps("1x0e+1x0e+1x0e+1x1o+1x1o+1x2e")
    full = list(range(14))
    no_s3 = [0, 1, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13]
    sp = [0, 1, 3, 4, 5]
    basis_def = {
        1: sp, 2: sp, 3: [0, 1, 2, 3, 4, 5, 6, 7, 8], 4: [0, 1, 3, 4, 5, 6, 7, 8],
        5: no_s3, 6: no_s3, 7: no_s3, 8: no_s3, 9: no_s3, 10: no_s3,
        11: full, 12: full, 13: no_s3, 14: no_s3, 15: no_s3, 16: no_s3,
        17: no_s3, 18: no_s3, 19: full, 20: full, 23: full, 25: full, 35: full,
    }
    return BasisSetInfo("openmx", 14, irreps, index_change, None, basis_def,
                        _OPENMX_NUM_VALENCE)


def _openmx_nao13():
    index_change = np.array([0, 1, 4, 2, 3, 7, 5, 6, 10, 12, 8, 11, 9])
    irreps = Irreps("1x0e+1x0e+1x1o+1x1o+1x2e")
    full = list(range(13))
    basis_def = {1: [0, 1, 2, 3, 4], 5: full, 6: full, 7: full, 8: full}
    return BasisSetInfo("openmx", 13, irreps, index_change, None, basis_def,
                        _OPENMX_NUM_VALENCE)


def _openmx_nao19():
    index_change = np.array(
        [0, 1, 2, 5, 3, 4, 8, 6, 7, 11, 13, 9, 12, 10, 16, 18, 14, 17, 15])
    irreps = Irreps("1x0e+1x0e+1x0e+1x1o+1x1o+1x2e+1x2e")
    d1 = [0, 1, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13]      # s2p2d1 without s3
    d1s3 = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13]  # s3p2d1
    d2 = list(range(19))                                    # s3p2d2
    sp = [0, 1, 3, 4, 5]
    basis_def = {
        1: sp, 2: sp, 3: [0, 1, 2, 3, 4, 5, 6, 7, 8], 4: [0, 1, 3, 4, 5, 6, 7, 8],
        5: d1, 6: d1, 7: d1, 8: d1, 9: d1, 10: d1,
        11: d1s3, 12: d1s3, 13: d1, 14: d1, 15: d1, 16: d1, 17: d1, 18: d1,
        19: d1s3, 20: d1s3, 23: d1s3, 24: d1s3, 25: d1s3, 26: d1s3, 28: d1s3,
        34: d2, 35: d2, 42: d2, 51: d2, 52: d2, 53: d2, 77: d2, 83: d2,
    }
    return BasisSetInfo("openmx", 19, irreps, index_change, None, basis_def,
                        _OPENMX_NUM_VALENCE)


def _openmx_nao26():
    index_change = np.array(
        [0, 1, 2, 5, 3, 4, 8, 6, 7, 11, 13, 9, 12, 10, 16, 18, 14, 17, 15,
         22, 23, 21, 24, 20, 25, 19])
    irreps = Irreps("1x0e+1x0e+1x0e+1x1o+1x1o+1x2e+1x2e+1x3o")
    s1, s2, s3 = [0], [1], [2]
    p1, p2 = [3, 4, 5], [6, 7, 8]
    d1, d2 = [9, 10, 11, 12, 13], [14, 15, 16, 17, 18]
    f1 = [19, 20, 21, 22, 23, 24, 25]
    s2p1 = _expand(s1, s2, p1)
    s3p2 = _expand(s1, s2, s3, p1, p2)
    s2p2d1 = _expand(s1, s2, p1, p2, d1)
    s3p2d1 = _expand(s1, s2, s3, p1, p2, d1)
    s3p2d2 = _expand(s1, s2, s3, p1, p2, d1, d2)
    s3p2d2f1 = _expand(s1, s2, s3, p1, p2, d1, d2, f1)
    basis_def = {
        1: s2p1, 2: s2p1, 3: s3p2, 4: _expand(s1, s2, p1, p2),
        **{z: s2p2d1 for z in (5, 6, 7, 8, 9, 10, 13, 14, 15, 16, 17, 18)},
        **{z: s3p2d1 for z in (11, 12, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30)},
        **{z: s3p2d2 for z in (31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43,
                               44, 45, 46, 47, 48, 49, 50, 51, 54, 55, 56)},
        **{z: s3p2d2f1 for z in (52, 53, 57, 58, 59, 60, 61, 62, 66, 67, 71, 72,
                                 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 83)},
    }
    return BasisSetInfo("openmx", 26, irreps, index_change, None, basis_def,
                        _OPENMX_NUM_VALENCE)


# ---------------------------------------------------------------------------
# SIESTA (reference hamgnn_output.py:528-595)
# ---------------------------------------------------------------------------

_SIESTA_NUM_VALENCE = {
    1: 1, 2: 2, 3: 1, 4: 2, 5: 3, 6: 4, 7: 5, 8: 6, 9: 7, 10: 8,
    11: 1, 12: 2, 13: 3, 14: 4, 15: 5, 16: 6, 17: 7, 18: 8,
    19: 1, 20: 2, 22: 12, 31: 3, 33: 5, 72: 4,
}


def _siesta_nao13():
    irreps = Irreps("1x0e+1x0e+1x1o+1x1o+1x2e")
    minus_index = np.array([2, 4, 5, 7, 9, 11])
    s1, s2 = [0], [1]
    p1, p2 = [2, 3, 4], [5, 6, 7]
    d1 = [8, 9, 10, 11, 12]
    s2p1 = _expand(s1, s2, p1)
    s2p2d1 = _expand(s1, s2, p1, p2, d1)
    basis_def = {
        1: s2p1, 2: s2p1, 3: s2p1, 4: s2p1, 11: s2p1, 12: s2p1, 19: s2p1, 20: s2p1,
        **{z: s2p2d1 for z in (5, 6, 7, 8, 9, 10, 13, 14, 15, 16, 17, 18, 31, 33)},
    }
    return BasisSetInfo("siesta", 13, irreps, None, minus_index, basis_def,
                        _SIESTA_NUM_VALENCE)


def _siesta_nao19():
    irreps = Irreps("1x0e+1x0e+1x0e+1x1o+1x1o+1x2e+1x2e")
    minus_index = np.array([3, 5, 6, 8, 10, 12, 15, 17])
    s1, s2, s3 = [0], [1], [2]
    p1, p2 = [3, 4, 5], [6, 7, 8]
    d1, d2 = [9, 10, 11, 12, 13], [14, 15, 16, 17, 18]
    s2p1 = _expand(s1, s2, p1)
    s2p2d1 = _expand(s1, s2, p1, p2, d1)
    basis_def = {
        1: s2p1, 2: s2p1, 3: s2p1, 4: s2p1, 11: s2p1, 12: s2p1, 19: s2p1, 20: s2p1,
        **{z: s2p2d1 for z in (5, 6, 7, 8, 9, 10, 13, 14, 15, 16, 17, 18)},
        22: _expand(s1, s2, s3, p1, p2, d1, d2),
    }
    return BasisSetInfo("siesta", 19, irreps, None, minus_index, basis_def,
                        _SIESTA_NUM_VALENCE)


# ---------------------------------------------------------------------------
# ABACUS (reference hamgnn_output.py:596-811)
# ---------------------------------------------------------------------------

_ABACUS_NUM_VALENCE = {
    1: 1, 2: 2, 3: 3, 4: 4, 5: 3, 6: 4, 7: 5, 8: 6, 9: 7, 10: 8,
    11: 9, 12: 10, 13: 11, 14: 4, 15: 5, 16: 6, 17: 7, 18: 8, 19: 9, 20: 10,
    21: 11, 22: 12, 23: 13, 24: 14, 25: 15, 26: 16, 27: 17, 28: 18, 29: 19, 30: 20,
    31: 13, 32: 14, 33: 5, 34: 6, 35: 7, 36: 8, 37: 9, 38: 10, 39: 11, 40: 12,
    41: 13, 42: 14, 43: 15, 44: 16, 45: 17, 46: 18, 47: 19, 48: 20, 49: 13, 50: 14,
    51: 15, 52: 16, 53: 17, 54: 18, 55: 9, 56: 10, 57: 11, 72: 26, 73: 27, 74: 28,
    75: 15, 76: 16, 77: 17, 78: 18, 79: 19, 80: 20, 81: 13, 82: 14, 83: 15,
}


def _abacus_nao13():
    index_change = np.array([0, 1, 3, 4, 2, 6, 7, 5, 10, 11, 9, 12, 8])
    irreps = Irreps("1x0e+1x0e+1x1o+1x1o+1x2e")
    minus_index = np.array([3, 4, 6, 7, 9, 10])
    s1, s2 = [0], [1]
    p1, p2 = [2, 3, 4], [5, 6, 7]
    d1 = [8, 9, 10, 11, 12]
    s2p1 = _expand(s1, s2, p1)
    s2p2d1 = _expand(s1, s2, p1, p2, d1)
    basis_def = {
        1: s2p1, 2: s2p1,
        **{z: s2p2d1 for z in (5, 6, 7, 8, 9, 10, 14, 15, 16, 17, 18)},
    }
    return BasisSetInfo("abacus", 13, irreps, index_change, minus_index, basis_def,
                        _ABACUS_NUM_VALENCE)


def _abacus_nao27():
    index_change = np.array(
        [0, 1, 2, 3, 5, 6, 4, 8, 9, 7, 12, 13, 11, 14, 10, 17, 18, 16, 19, 15,
         23, 24, 22, 25, 21, 26, 20])
    irreps = Irreps("1x0e+1x0e+1x0e+1x0e+1x1o+1x1o+1x2e+1x2e+1x3o")
    minus_index = np.array([5, 6, 8, 9, 11, 12, 16, 17, 21, 22, 25, 26])
    s1, s2, s3, s4 = [0], [1], [2], [3]
    p1, p2 = [4, 5, 6], [7, 8, 9]
    d1, d2 = [10, 11, 12, 13, 14], [15, 16, 17, 18, 19]
    f1 = [20, 21, 22, 23, 24, 25, 26]
    s2p1 = _expand(s1, s2, p1)
    s4p1 = _expand(s1, s2, s3, s4, p1)
    s2p2d1 = _expand(s1, s2, p1, p2, d1)
    s4p2d1 = _expand(s1, s2, s3, s4, p1, p2, d1)
    s4p2d2f1 = _expand(s1, s2, s3, s4, p1, p2, d1, d2, f1)
    s2p2d2f1 = _expand(s1, s2, p1, p2, d1, d2, f1)
    basis_def = {
        1: s2p1, 2: s2p1, 3: s4p1, 4: s4p1,
        **{z: s2p2d1 for z in (5, 6, 7, 8, 9, 10, 14, 15, 16, 17, 18, 33, 34, 35, 36)},
        **{z: s4p2d1 for z in (11, 12, 19, 20, 37, 38, 55)},
        **{z: s4p2d2f1 for z in (21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 39, 40,
                                 41, 42, 43, 44, 45, 46, 47, 48, 56, 79, 80)},
        **{z: s2p2d2f1 for z in (31, 32, 49, 50, 51, 52, 53, 54, 81, 82, 83)},
    }
    return BasisSetInfo("abacus", 27, irreps, index_change, minus_index, basis_def,
                        _ABACUS_NUM_VALENCE)


def _abacus_nao40():
    index_change = np.array(
        [0, 1, 2, 3, 5, 6, 4, 8, 9, 7, 11, 12, 10, 14, 15, 13, 18, 19, 17, 20,
         16, 23, 24, 22, 25, 21, 29, 30, 28, 31, 27, 32, 26, 36, 37, 35, 38, 34,
         39, 33])
    irreps = Irreps(
        "1x0e+1x0e+1x0e+1x0e+1x1o+1x1o+1x1o+1x1o+1x2e+1x2e+1x3o+1x3o")
    minus_index = np.array(
        [5, 6, 8, 9, 11, 12, 14, 15, 17, 18, 22, 23, 27, 28, 31, 32, 34, 35, 38, 39])
    s1, s2, s3, s4 = [0], [1], [2], [3]
    p1, p2, p3, p4 = [4, 5, 6], [7, 8, 9], [10, 11, 12], [13, 14, 15]
    d1, d2 = [16, 17, 18, 19, 20], [21, 22, 23, 24, 25]
    f1 = [26, 27, 28, 29, 30, 31, 32]
    f2 = [33, 34, 35, 36, 37, 38, 39]
    s2p1 = _expand(s1, s2, p1)
    s4p1 = _expand(s1, s2, s3, s4, p1)
    s2p2d1 = _expand(s1, s2, p1, p2, d1)
    s4p2d1 = _expand(s1, s2, s3, s4, p1, p2, d1)
    s4p2d2f1 = _expand(s1, s2, s3, s4, p1, p2, d1, d2, f1)
    s2p2d2f1 = _expand(s1, s2, p1, p2, d1, d2, f1)
    s4p2d2f2 = _expand(s1, s2, s3, s4, p1, p2, d1, d2, f1, f2)
    basis_def = {
        1: s2p1, 2: s2p1, 3: s4p1, 4: s4p1,
        13: _expand(s1, s2, s3, s4, p1, p2, p3, p4, d1),
        **{z: s2p2d1 for z in (5, 6, 7, 8, 9, 10, 14, 15, 16, 17, 18, 33, 34, 35, 36)},
        **{z: s4p2d1 for z in (11, 12, 19, 20, 37, 38, 55)},
        20: _expand(s1, s2, s3, s4, p1, p2, d1),
        **{z: s4p2d2f1 for z in (21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 39, 40,
                                 41, 42, 43, 44, 45, 46, 47, 48, 56, 75, 76, 77,
                                 78, 79, 80)},
        **{z: s2p2d2f1 for z in (31, 32, 49, 50, 51, 52, 53, 54, 81, 82, 83)},
        **{z: s4p2d2f2 for z in (72, 73, 74)},
    }
    return BasisSetInfo("abacus", 40, irreps, index_change, minus_index, basis_def,
                        _ABACUS_NUM_VALENCE)


def _pasp():
    return BasisSetInfo("pasp", 3, Irreps("1x1o"), None, None, {}, {})


_REGISTRY = {
    ("openmx", 13): _openmx_nao13,
    ("openmx", 14): _openmx_nao14,
    ("openmx", 19): _openmx_nao19,
    ("openmx", 26): _openmx_nao26,
    ("siesta", 13): _siesta_nao13,
    ("siesta", 19): _siesta_nao19,
    ("abacus", 13): _abacus_nao13,
    ("abacus", 27): _abacus_nao27,
    ("abacus", 40): _abacus_nao40,
    ("pasp", 3): _pasp,
}


def get_basis_set(ham_type: str, nao_max: int) -> BasisSetInfo:
    key = (ham_type.lower(), nao_max)
    if key not in _REGISTRY:
        raise NotImplementedError(f"no basis table for {key}")
    return _REGISTRY[key]()


# minimal Z -> symbol table for error messages (no external deps)
_SYMBOLS = (
    "n H He Li Be B C N O F Ne Na Mg Al Si P S Cl Ar K Ca Sc Ti V Cr Mn Fe Co "
    "Ni Cu Zn Ga Ge As Se Br Kr Rb Sr Y Zr Nb Mo Tc Ru Rh Pd Ag Cd In Sn Sb Te "
    "I Xe Cs Ba La Ce Pr Nd Pm Sm Eu Gd Tb Dy Ho Er Tm Yb Lu Hf Ta W Re Os Ir "
    "Pt Au Hg Tl Pb Bi Po At Rn Fr Ra Ac Th Pa U Np Pu").split()


def validate_elements_in_basis_def(z, basis: BasisSetInfo) -> None:
    """Hard-error when a structure contains an element with no ``basis_def``
    entry for the configured (ham_type, nao_max) — otherwise the orbital mask
    table silently zeroes every block of that species and training runs on
    masked-to-zero garbage.  Parity with the reference's
    ``validate_elements_in_basis_def`` (hamgnn_output.py:2874-2914)."""
    zs = np.unique(np.asarray(z, dtype=np.int64))
    missing = [int(v) for v in zs if int(v) not in basis.basis_def]
    if missing:
        names = ", ".join(
            f"{_SYMBOLS[v]} (Z={v})" if 0 < v < len(_SYMBOLS) else f"Z={v}"
            for v in missing)
        raise ValueError(
            f"elements missing from basis_def for ham_type="
            f"{basis.ham_type!r}, nao_max={basis.nao_max}: {names}")


def hamiltonian_irreps(basis: BasisSetInfo) -> Irreps:
    """Irreps of the flattened Hamiltonian block: for each (l_i, l_j) orbital
    pair, L = |l_i - l_j| .. l_i + l_j with parity (-1)^(l_i + l_j)
    (reference hamgnn_output.py:258-278)."""
    out = Irreps()
    for _, li in basis.orbital_irreps:
        for _, lj in basis.orbital_irreps:
            for L in range(abs(li.l - lj.l), li.l + lj.l + 1):
                out = out + Irreps([(1, (L, (-1) ** (li.l + lj.l)))])
    return out
