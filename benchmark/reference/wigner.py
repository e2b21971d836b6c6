# Frozen copy of hamgnn_tpu_torch/e3/wigner.py, with its imports rewritten.
"""Clebsch-Gordan coefficients and Wigner-3j tensors in the real SH basis.

Counterpart of ``hamgnn_tpu/e3/wigner.py`` (host-side numpy, no framework):
su(2) Clebsch-Gordan coefficients by the Racah formula in exact rational
arithmetic, carried to the real spherical-harmonic basis by the standard
real<->complex change of basis with a ``(-i)^l`` phase, so the 3j tensors are
real and follow e3nn's convention.
"""

from __future__ import annotations

import functools
from fractions import Fraction
from math import factorial

import numpy as np

__all__ = ["su2_clebsch_gordan", "change_basis_real_to_complex", "wigner_3j",
           "wigner_D"]


@functools.lru_cache(maxsize=None)
def _su2_cg_coeff(j1: Fraction, j2: Fraction, j3: Fraction,
                  m1: Fraction, m2: Fraction, m3: Fraction) -> float:
    """<j1 m1 j2 m2 | j3 m3> by the Racah formula (exact until the final sqrt)."""
    if m3 != m1 + m2:
        return 0.0

    def fr(x: Fraction) -> int:
        if x.denominator != 1:
            raise ValueError(f"non-integer factorial argument {x}")
        return factorial(int(x))

    norm = (
        Fraction(int(2 * j3 + 1))
        * Fraction(fr(j3 + j1 - j2) * fr(j3 - j1 + j2) * fr(j1 + j2 - j3), fr(j1 + j2 + j3 + 1))
        * Fraction(fr(j3 + m3) * fr(j3 - m3) * fr(j1 - m1) * fr(j1 + m1) * fr(j2 - m2) * fr(j2 + m2))
    )
    kmin = int(max(0, j2 - j3 - m1, j1 - j3 + m2))
    kmax = int(min(j1 + j2 - j3, j1 - m1, j2 + m2))
    s = Fraction(0)
    for k in range(kmin, kmax + 1):
        s += Fraction(
            (-1) ** k,
            factorial(k) * fr(j1 + j2 - j3 - k) * fr(j1 - m1 - k) * fr(j2 + m2 - k)
            * fr(j3 - j2 + m1 + k) * fr(j3 - j1 - m2 + k),
        )
    if s == 0:
        return 0.0
    sign = 1.0 if s > 0 else -1.0
    return sign * float(norm * s * s) ** 0.5


@functools.lru_cache(maxsize=None)
def su2_clebsch_gordan(j1: int, j2: int, j3: int) -> np.ndarray:
    """CG tensor C[m1+j1, m2+j2, m3+j3] = <j1 m1 j2 m2 | j3 m3> (float64)."""
    J1, J2, J3 = Fraction(j1), Fraction(j2), Fraction(j3)
    out = np.zeros((2 * j1 + 1, 2 * j2 + 1, 2 * j3 + 1))
    if not (abs(j1 - j2) <= j3 <= j1 + j2):
        return out
    for i1, m1 in enumerate(range(-j1, j1 + 1)):
        for i2, m2 in enumerate(range(-j2, j2 + 1)):
            m3 = m1 + m2
            if -j3 <= m3 <= j3:
                out[i1, i2, m3 + j3] = _su2_cg_coeff(
                    J1, J2, J3, Fraction(m1), Fraction(m2), Fraction(m3))
    return out


@functools.lru_cache(maxsize=None)
def change_basis_real_to_complex(l: int) -> np.ndarray:
    """Matrix Q with Y_real = Q^dag Y_complex, including the (-i)^l phase that
    renders the real-basis 3j tensors real."""
    q = np.zeros((2 * l + 1, 2 * l + 1), dtype=np.complex128)
    inv_sqrt2 = 1.0 / np.sqrt(2.0)
    for m in range(-l, 0):
        q[l + m, l + abs(m)] = inv_sqrt2
        q[l + m, l - abs(m)] = -1j * inv_sqrt2
    q[l, l] = 1.0
    for m in range(1, l + 1):
        q[l + m, l + abs(m)] = (-1) ** m * inv_sqrt2
        q[l + m, l - abs(m)] = 1j * (-1) ** m * inv_sqrt2
    return (-1j) ** l * q


@functools.lru_cache(maxsize=None)
def wigner_3j(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis Wigner-3j tensor C[i, j, k], normalised so sum(C**2) = 1."""
    C = su2_clebsch_gordan(l1, l2, l3).astype(np.complex128)
    Q1 = change_basis_real_to_complex(l1)
    Q2 = change_basis_real_to_complex(l2)
    Q3 = change_basis_real_to_complex(l3)
    C = np.einsum("ai,bj,ck,abc->ijk", Q1, Q2, np.conj(Q3), C)
    if np.abs(C.imag).max() >= 1e-10:
        raise ArithmeticError(f"3j tensor ({l1},{l2},{l3}) is not real")
    C = C.real
    n = np.linalg.norm(C.ravel())
    if n > 0:
        C = C / n
    return np.ascontiguousarray(C)


# rows (y, z, x) <- (x, y, z): Cartesian vectors in the l=1 real-SH order
PERM_YZX = np.array([[0.0, 1.0, 0.0],
                     [0.0, 0.0, 1.0],
                     [1.0, 0.0, 0.0]])


def wigner_D(l: int, R: np.ndarray) -> np.ndarray:
    """Real Wigner-D matrix of angular momentum l for a Cartesian rotation R,
    in the yzx real-SH basis (float64).

    CG recursion D_l = (2l+1) W^T (D_{l-1} (x) D_1) W with
    W = wigner_3j(l-1, 1, l), exact because W^T W = I / (2l+1).  The oracle
    of ``zonal_tp.batched_wigner_D``.
    """
    if l == 0:
        return np.ones((1, 1))
    D1 = PERM_YZX @ np.asarray(R, dtype=np.float64) @ PERM_YZX.T
    if l == 1:
        return D1
    W = wigner_3j(l - 1, 1, l).reshape((2 * l - 1) * 3, 2 * l + 1)
    return (2.0 * l + 1.0) * (W.T @ np.kron(wigner_D(l - 1, R), D1) @ W)
