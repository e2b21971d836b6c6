"""OpenMX PAO basis files: parser and exact radial/angular evaluation,
counterpart of ``hamgnn_tpu/interfaces/pao.py`` (numpy, host-side tooling).

The same numerics as the reference's cube writer (``wfn_plot/wfn2cube.c``):

* ``parse_pao`` reads a ``DFT_DATA*/PAO/<basis>.pao`` file: the
  ``PAO.Lmax`` / ``PAO.Mul`` / ``grid.num.output`` header plus one
  ``<pseudo.atomic.orbitals.L=l>`` block per l with rows
  ``XV RV RWF[l][0] ... RWF[l][Mul-1]``.
* ``phi_f`` is OpenMX's Hermite-cubic radial interpolation with parabolic
  extrapolation to the origin and a hard zero beyond the PAO cutoff
  (wfn2cube.c PhiF, from OpenMX's PhiF.c), vectorized over R.
* ``angular_f`` is the OpenMX real-harmonic table in OpenMX's native m
  ordering for l <= 3: p = (x, y, z), d = (3z^2-r^2, x^2-y^2, xy, xz, yz),
  f = OpenMX's 7-term order.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


@dataclass
class PAOBasis:
    name: str
    lmax: int
    mul: int
    rv: np.ndarray            # (mesh,) radial grid (Bohr)
    rwf: Dict[int, np.ndarray]  # l -> (mul, mesh) radial functions

    @property
    def cutoff(self) -> float:
        return float(self.rv[-1])


def parse_pao(path: str) -> PAOBasis:
    """Parse an OpenMX ``.pao`` file (wfn2cube.c:309-412 semantics)."""
    with open(path, encoding="utf-8", errors="replace") as f:
        text = f.read()
    lmax = mul = mesh = None
    for line in text.splitlines():
        if line.startswith("PAO.Lmax"):
            lmax = int(line.split()[1])
        elif line.startswith("PAO.Mul"):
            mul = int(line.split()[1])
        elif "grid.num.output" in line:
            mesh = int(line.split("grid.num.output")[1].split()[0])
    if lmax is None or mul is None or mesh is None or mul < 1 or mesh < 1:
        raise ValueError(f"invalid PAO header in {path} "
                         f"(Lmax={lmax} Mul={mul} Mesh={mesh})")

    rv = None
    rwf: Dict[int, np.ndarray] = {}
    for l in range(lmax + 1):
        m = re.search(
            rf"<pseudo\.atomic\.orbitals\.L={l}\s*\n(.*?)"
            rf"pseudo\.atomic\.orbitals\.L={l}>",
            text, re.S)
        if m is None:
            raise ValueError(f"missing pseudo.atomic.orbitals.L={l} in {path}")
        rows = np.array(m.group(1).split(), float).reshape(mesh, 2 + mul)
        if rv is None:
            rv = rows[:, 1].copy()
        rwf[l] = rows[:, 2:].T.copy()   # (mul, mesh)
    name = os.path.basename(path)
    if name.endswith(".pao"):
        name = name[:-4]
    return PAOBasis(name, lmax, mul, np.asarray(rv), rwf)


def phi_f(r: np.ndarray, phi0: np.ndarray, rv: np.ndarray) -> np.ndarray:
    """OpenMX PhiF Hermite-cubic interpolation, vectorized over ``r``.

    Matches wfn2cube.c PhiF bit-for-bit in the interior; beyond the grid
    returns 0; inside the first grid point uses the parabolic a*R^2 + b
    extrapolation fitted at grid index m=4.
    """
    r = np.asarray(r, float)
    n = rv.shape[0]
    out = np.zeros_like(r)

    # interior: bisect for the bracketing index, clamp to [2, n-2]
    inside = (r >= rv[0]) & (r <= rv[n - 1])
    m = np.searchsorted(rv, r, side="left")
    m = np.clip(m, 2, n - 2)

    h1 = rv[m - 1] - rv[m - 2]
    h2 = rv[m] - rv[m - 1]
    h3 = rv[m + 1] - rv[m]
    f1, f2, f3, f4 = phi0[m - 2], phi0[m - 1], phi0[m], phi0[m + 1]
    g1 = ((f3 - f2) * h1 / h2 + (f2 - f1) * h2 / h1) / (h1 + h2)
    g2 = ((f4 - f3) * h2 / h3 + (f3 - f2) * h3 / h2) / (h2 + h3)
    x1 = r - rv[m - 1]
    x2 = r - rv[m]
    y1 = x1 / h2
    y2 = x2 / h2
    interior = (y2 * y2 * (3.0 * f2 + h2 * g1 + (2.0 * f2 + h2 * g1) * y2)
                + y1 * y1 * (3.0 * f3 - h2 * g2 - (2.0 * f3 - h2 * g2) * y1))
    out = np.where(inside, interior, out)

    # near-origin parabolic extrapolation (fit at fixed index m=4)
    near = r < rv[0]
    if np.any(near):
        mm = min(max(4, 2), n - 2)
        rm = rv[mm]
        h1 = rv[mm - 1] - rv[mm - 2]
        h2 = rv[mm] - rv[mm - 1]
        h3 = rv[mm + 1] - rv[mm]
        f1, f2, f3, f4 = phi0[mm - 2], phi0[mm - 1], phi0[mm], phi0[mm + 1]
        g1 = ((f3 - f2) * h1 / h2 + (f2 - f1) * h2 / h1) / (h1 + h2)
        g2 = ((f4 - f3) * h2 / h3 + (f3 - f2) * h3 / h2) / (h2 + h3)
        x1 = rm - rv[mm - 1]
        x2 = rm - rv[mm]
        y1 = x1 / h2
        y2 = x2 / h2
        f = (y2 * y2 * (3.0 * f2 + h2 * g1 + (2.0 * f2 + h2 * g1) * y2)
             + y1 * y1 * (3.0 * f3 - h2 * g2 - (2.0 * f3 - h2 * g2) * y1))
        df = (2.0 * y2 / h2 * (3.0 * f2 + h2 * g1 + (2.0 * f2 + h2 * g1) * y2)
              + y2 * y2 * (2.0 * f2 + h2 * g1) / h2
              + 2.0 * y1 / h2 * (3.0 * f3 - h2 * g2 - (2.0 * f3 - h2 * g2) * y1)
              - y1 * y1 * (2.0 * f3 - h2 * g2) / h2)
        a = 0.5 * df / rm
        b = f - a * rm * rm
        out = np.where(near, a * r * r + b, out)
    return out


def angular_f(l: int, m: int, theta: np.ndarray, phi: np.ndarray) -> np.ndarray:
    """OpenMX real harmonics, native m ordering (wfn2cube.c:158-204)."""
    siQ, coQ = np.sin(theta), np.cos(theta)
    siP, coP = np.sin(phi), np.cos(phi)
    if l == 0:
        return np.full_like(siQ, 0.5 / np.sqrt(np.pi))
    if l == 1:
        return {
            0: 0.5 * np.sqrt(3.0 / np.pi) * siQ * coP,
            1: 0.5 * np.sqrt(3.0 / np.pi) * siQ * siP,
            2: 0.5 * np.sqrt(3.0 / np.pi) * coQ,
        }[m]
    if l == 2:
        return {
            0: 0.94617469575756 * coQ * coQ - 0.31539156525252,
            1: 0.54627421529604 * siQ * siQ * (1.0 - 2.0 * siP * siP),
            2: 1.09254843059208 * siQ * siQ * siP * coP,
            3: 1.09254843059208 * siQ * coQ * coP,
            4: 1.09254843059208 * siQ * coQ * siP,
        }[m]
    if l == 3:
        return {
            0: 0.373176332590116 * (5 * coQ ** 3 - 3.0 * coQ),
            1: 0.457045799464466 * coP * siQ * (5 * coQ * coQ - 1.0),
            2: 0.457045799464466 * siP * siQ * (5 * coQ * coQ - 1.0),
            3: 1.44530572132028 * siQ * siQ * coQ * (coP * coP - siP * siP),
            4: 2.89061144264055 * siQ * siQ * coQ * siP * coP,
            5: 0.590043589926644 * siQ ** 3 * (4 * coP ** 3 - 3.0 * coP),
            6: 0.590043589926644 * siQ ** 3 * (3.0 * siP - 4 * siP ** 3),
        }[m]
    raise NotImplementedError(f"angular_f l={l} (reference supports l<=3)")


def xyz_to_spherical(d: np.ndarray):
    """(..., 3) displacement -> (R, theta, phi) per wfn2cube xyz2spherical."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    r = np.sqrt(x * x + y * y + z * z)
    theta = np.arccos(np.clip(np.divide(z, np.maximum(r, 1e-30)), -1.0, 1.0))
    phi = np.arctan2(y, x)
    return r, theta, phi


def find_pao_file(data_path: str, basis_name: str) -> Optional[str]:
    """``DFT_DATA*/PAO/<basis up to first '-'>.pao`` (wfn2cube.c:431-440)."""
    trunc = basis_name.split("-")[0]
    p = os.path.join(data_path, "PAO", trunc + ".pao")
    return p if os.path.exists(p) else None
