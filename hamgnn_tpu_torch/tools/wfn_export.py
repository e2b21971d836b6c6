"""Wavefunction export: eigenvector dumps and Gaussian-cube visualization,
counterpart of ``hamgnn_tpu/tools/wfn_export.py`` (host numpy, no device).

    python -m hamgnn_tpu_torch.tools.wfn_export --config wfn_export.yaml

The surface of the reference's wfn_plot tooling (wfn_export.py,
wfn2cube.c): ``export_wavefunctions`` saves per-k eigenvector data produced
by the band head; ``main`` renders |psi|^2 of one band on a real-space grid
into a cube file.

With a ``dft_data_path`` (an OpenMX ``DFT_DATA*`` directory) and per-species
basis names, the cube writer evaluates the exact PAO radial functions through
the same Hermite-spline interpolation and OpenMX real-harmonic table as the
native wfn2cube (``interfaces/pao.py``).  Without the data files it falls
back to normalized Gaussian-type orbitals with per-species basis radii, an
approximation flagged in the cube header.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import numpy as np
import yaml

from ..data.neighborlist import radii_for_z

AU2ANG = 0.5291772490000065


def export_wavefunctions(band_npz: str, out_dir: str) -> None:
    """Split a band-result npz (band_energy/wavefunction arrays) per k-point."""
    os.makedirs(out_dir, exist_ok=True)
    data = np.load(band_npz)
    wfn = data["wavefunction"] if "wavefunction" in data else data["bands"]
    np.save(os.path.join(out_dir, "wavefunctions.npy"), wfn)


def _gaussian_orbital_grid(grid, center, radius, l, m):
    """Crude normalized GTO-like value of orbital (l, m-real) at grid points."""
    d = grid - center
    r2 = np.sum(d * d, axis=-1)
    alpha = 2.0 / max(radius, 1.0) ** 2
    radial = np.exp(-alpha * r2)
    if l == 0:
        ang = np.ones_like(r2)
    else:
        import torch

        from ..e3.spherical import spherical_harmonics

        v = d / np.maximum(np.sqrt(r2), 1e-9)[..., None]
        # float32, as the JAX package evaluates them
        Y = spherical_harmonics([l], torch.as_tensor(
            v.reshape(-1, 3), dtype=torch.float32)).numpy()
        ang = Y[:, m].reshape(r2.shape)
    return radial * ang


def write_cube(path: str, cell, pos, z, values, comment: str = "") -> None:
    """Gaussian cube file (volumetric data on a cell-aligned grid)."""
    n1, n2, n3 = values.shape
    with open(path, "w") as f:
        f.write("hamgnn_tpu wavefunction cube\n")
        f.write((comment or "approx-GTO basis") + "\n")
        f.write(f"{len(z):5d} {0.0:12.6f} {0.0:12.6f} {0.0:12.6f}\n")
        for i, n in enumerate((n1, n2, n3)):
            v = np.asarray(cell)[i] / n
            f.write(f"{n:5d} {v[0]:12.6f} {v[1]:12.6f} {v[2]:12.6f}\n")
        for zi, p in zip(z, pos):
            f.write(f"{int(zi):5d} {0.0:12.6f} {p[0]:12.6f} {p[1]:12.6f} {p[2]:12.6f}\n")
        flat = values.ravel()
        for i in range(0, len(flat), 6):
            f.write(" ".join(f"{v:13.5E}" for v in flat[i : i + 6]) + "\n")


def _slot_table(basis):
    """DFT-order (l, mul-within-l, m) per orbital slot.

    OpenMX's native layout per atom is contiguous (l, mul) blocks, each
    spanning 2l+1 m-components in the OpenMX real-harmonic order
    (wfn2cube.c's orbital enumeration); ``basis.orbital_irreps``
    lists the blocks in that order.
    """
    table = []
    count_by_l: Dict[int, int] = {}
    for _, ir in basis.orbital_irreps:
        mul_idx = count_by_l.get(ir.l, 0)
        count_by_l[ir.l] = mul_idx + 1
        for m in range(ir.dim):
            table.append((ir.l, mul_idx, m))
    return table


def density_on_grid(crystal: Dict, coeffs: np.ndarray, basis, nao: int,
                    grid_shape=(24, 24, 24),
                    pao_by_z: Optional[Dict[int, "object"]] = None
                    ) -> np.ndarray:
    """|psi|^2 on a grid from orbital coefficients.

    With ``pao_by_z`` (Z -> interfaces.pao.PAOBasis) the exact OpenMX PAO
    radials are used (wfn2cube.c eval_basis); otherwise a GTO approximation.
    """
    from ..interfaces.pao import angular_f, phi_f, xyz_to_spherical

    cell = np.asarray(crystal["cell"]).reshape(3, 3)
    pos = np.asarray(crystal["pos"])
    z = np.asarray(crystal["z"], int)
    fr = np.stack(np.meshgrid(
        *[np.linspace(0, 1, n, endpoint=False) for n in grid_shape],
        indexing="ij"), axis=-1)
    grid = fr @ cell
    radii = radii_for_z(z, "openmx")
    lm = _slot_table(basis)

    psi = np.zeros(grid_shape, complex)
    ofs = 0
    for a, zi in enumerate(z):
        pao = pao_by_z.get(int(zi)) if pao_by_z else None
        d = grid - pos[a]
        r, theta, phi = xyz_to_spherical(d)
        for oi in basis.basis_def[int(zi)]:
            l, mul, m = lm[oi]
            if pao is not None and l <= pao.lmax and mul < pao.mul:
                val = (phi_f(r, pao.rwf[l][mul], pao.rv)
                       * angular_f(l, m, theta, phi))
            else:
                val = _gaussian_orbital_grid(grid, pos[a], radii[a], l, m)
            psi = psi + coeffs[ofs] * val
            ofs += 1
    return np.abs(psi) ** 2


def main(argv=None):
    parser = argparse.ArgumentParser(description="wavefunction export / cube")
    parser.add_argument("--config", default="wfn_export.yaml")
    args = parser.parse_args(argv)
    with open(args.config, encoding="utf-8") as f:
        cfg = yaml.safe_load(f)

    from ..data.dataset import load_graph_npz
    from ..models.basis import get_basis_set

    graphs = load_graph_npz(cfg["graph_data_path"])
    vecs = np.load(cfg["eigen_vecs_path"])
    basis = get_basis_set(cfg.get("Ham_type", "openmx"), cfg["nao_max"])
    save_dir = cfg.get("save_dir", "./wfn")
    os.makedirs(save_dir, exist_ok=True)
    band_idx = cfg.get("band_index", 0)
    c = graphs[cfg.get("structure_index", 0)]
    coeffs = vecs[band_idx]

    # exact PAO radials when DFT_DATA + basis names are configured
    # (wfn2cube.c resolve_species); else GTO approximation
    pao_by_z = None
    data_path = cfg.get("dft_data_path")
    basis_names = cfg.get("basis_names", {})  # e.g. {14: "Si7.0-s2p2d1"}
    if data_path:
        from ..interfaces.pao import find_pao_file, parse_pao

        pao_by_z = {}
        for zi in sorted(set(int(v) for v in np.asarray(c["z"]))):
            name = basis_names.get(zi) or basis_names.get(str(zi))
            p = find_pao_file(data_path, name) if name else None
            if p is not None:
                pao_by_z[zi] = parse_pao(p)
        if not pao_by_z:
            pao_by_z = None

    rho = density_on_grid(c, coeffs, basis, cfg["nao_max"],
                          tuple(cfg.get("grid", (24, 24, 24))),
                          pao_by_z=pao_by_z)
    write_cube(os.path.join(save_dir, f"band_{band_idx}.cube"),
               np.asarray(c["cell"]).reshape(3, 3), np.asarray(c["pos"]),
               np.asarray(c["z"], int), rho,
               comment=("exact-PAO basis" if pao_by_z else "approx-GTO basis"))
    print(f"wrote cube for band {band_idx}")


if __name__ == "__main__":
    main()
