"""band_cal: band structures from predicted (or stored) Hamiltonians.

    python -m hamgnn_tpu_torch.tools.band_cal --config band_cal.yaml

Counterpart of ``hamgnn_tpu/tools/band_cal.py`` (host numpy/scipy, no
device), with the reference's YAML keys: nao_max, graph_data_path,
hamiltonian_path (the ``prediction_hamiltonian.npy`` of a ``stage: test``
run; without it the stored Hamiltonians are used), nk, save_dir,
strcture_name, Ham_type, soc_switch, spin_colinear, auto_mode, k_path, label.
Per crystal it writes ``<name>_<i>_bands.npz`` / ``.png`` / ``.dat`` and a
CIF, and prints the gap and the Fermi level (the ``.png`` needs matplotlib and
is skipped without it).

auto_mode: the reference calls pymatgen's KPathSeek; here the lattice is
classified from its metric and mapped to the Setyawan-Curtarolo path
(``physics.kpoints.auto_k_path``), with the explicit ``k_path`` otherwise.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import yaml

from ..data.dataset import load_graph_npz
from ..models.basis import get_basis_set
from ..physics.kpoints import k_path as make_k_path

HARTREE2EV = 27.211324570273


def _auto_k_path(cell: np.ndarray) -> Tuple[List[List[float]], List[str]]:
    """High-symmetry path from the metric-based Bravais classification
    (``physics.kpoints.auto_k_path``)."""
    from ..physics.kpoints import auto_k_path

    return auto_k_path(np.asarray(cell, float).reshape(3, 3))


def assemble_k_matrices_numpy(rows: np.ndarray, n_atoms: int, edge_index: np.ndarray,
                              nbr_shift: np.ndarray, k_cart: np.ndarray,
                              nao: int, valid: np.ndarray) -> np.ndarray:
    """H(k)/S(k): (nk, norb, norb) complex from per-row blocks (on || off)."""
    on = rows[:n_atoms].reshape(n_atoms, nao, nao)
    off = rows[n_atoms:].reshape(-1, nao, nao)
    nk = k_cart.shape[0]
    HK = np.zeros((nk, n_atoms, n_atoms, nao, nao), complex)
    idx = np.arange(n_atoms)
    HK[:, idx, idx] += on[None]
    phase = np.exp(2j * np.pi * (nbr_shift @ k_cart.T))  # (E, nk)
    src, dst = edge_index
    for e in range(src.shape[0]):
        HK[:, src[e], dst[e]] += phase[e][:, None, None] * off[e]
    HK = HK.transpose(0, 1, 3, 2, 4).reshape(nk, n_atoms * nao, n_atoms * nao)
    return HK[:, valid][:, :, valid]


def band_structure_for_crystal(
    crystal: Dict[str, np.ndarray],
    h_rows: np.ndarray,
    nao: int,
    basis,
    nk: int,
    k_path_nodes: Sequence[Sequence[float]],
    soc: bool = False,
    ih_rows: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Bands along a path; Fermi level from valence electron counting."""
    import scipy.linalg

    z = np.asarray(crystal["z"], int)
    n_atoms = len(z)
    cell = np.asarray(crystal["cell"]).reshape(3, 3)
    edge_index = np.asarray(crystal["edge_index"], int)
    nbr_shift = np.asarray(crystal["nbr_shift"], float)
    table = basis.orbital_mask_table
    valid = np.concatenate([table[zi] > 0 for zi in z])

    k_frac, k_dist, k_node, lat_inv = make_k_path(k_path_nodes, nk, cell)
    k_cart = k_frac @ lat_inv

    s_rows = np.concatenate([np.asarray(crystal["Son"]), np.asarray(crystal["Soff"])])
    SK = assemble_k_matrices_numpy(s_rows, n_atoms, edge_index, nbr_shift,
                                   k_cart, nao, valid)

    if soc:
        # h_rows real (2nao)^2, ih_rows imag
        big = 2 * nao
        HKr = _assemble_soc(h_rows, n_atoms, edge_index, nbr_shift, k_cart, big, valid)
        HKi = _assemble_soc(ih_rows, n_atoms, edge_index, nbr_shift, k_cart, big, valid)
        HK = HKr + 1j * HKi
        nv = valid.sum()
        SK2 = np.zeros((SK.shape[0], 2 * nv, 2 * nv), complex)
        SK2[:, :nv, :nv] = SK
        SK2[:, nv:, nv:] = SK
        SK = SK2
    else:
        HK = assemble_k_matrices_numpy(h_rows, n_atoms, edge_index, nbr_shift,
                                       k_cart, nao, valid)

    bands = []
    for k in range(HK.shape[0]):
        Hk = 0.5 * (HK[k] + HK[k].conj().T)
        Sk = 0.5 * (SK[k] + SK[k].conj().T)
        bands.append(scipy.linalg.eigh(Hk, Sk, eigvals_only=True))
    bands = np.stack(bands) * HARTREE2EV  # (nk, norb), eV

    n_electrons = sum(basis.num_valence.get(int(zi), 0) for zi in z)
    occ = n_electrons if soc else int(np.ceil(n_electrons / 2))
    fermi = bands[:, occ - 1].max() if occ > 0 else 0.0
    gap = bands[:, occ].min() - bands[:, occ - 1].max() if occ < bands.shape[1] else 0.0

    return {
        "k_dist": k_dist, "k_node": k_node, "bands": bands,
        "fermi": fermi, "gap": max(gap, 0.0), "n_electrons": n_electrons,
    }


def _assemble_soc(rows, n_atoms, edge_index, nbr_shift, k_cart, big, valid):
    on = rows[:n_atoms].reshape(n_atoms, big, big)
    off = rows[n_atoms:].reshape(-1, big, big)
    nao = big // 2
    nk = k_cart.shape[0]
    nv = valid.sum()
    out = np.zeros((nk, 2 * nv, 2 * nv), complex)
    phase = np.exp(2j * np.pi * (nbr_shift @ k_cart.T))
    src, dst = edge_index
    # per-atom orbital offsets within the compacted (valid-orbital) space
    atom_orb_ofs = []
    ofs = 0
    per_atom_valid = valid.reshape(n_atoms, nao)
    for a in range(n_atoms):
        atom_orb_ofs.append(ofs)
        ofs += int(per_atom_valid[a].sum())

    def put(mat_k, blk, i, j, ph_k):
        vi = per_atom_valid[i]
        vj = per_atom_valid[j]
        sub = blk.reshape(2, nao, 2, nao)[:, vi][:, :, :, vj]
        ni, nj = int(vi.sum()), int(vj.sum())
        oi, oj = atom_orb_ofs[i], atom_orb_ofs[j]
        for si in range(2):
            for sj in range(2):
                mat_k[:, si * nv + oi : si * nv + oi + ni,
                      sj * nv + oj : sj * nv + oj + nj] += (
                    ph_k[:, None, None] * sub[si, :, sj][None])

    for a in range(n_atoms):
        put(out, on[a], a, a, np.ones(nk))
    for e in range(src.shape[0]):
        put(out, off[e], src[e], dst[e], phase[e])
    return out


def plot_bands(result: Dict[str, np.ndarray], labels: Sequence[str], path: str,
               window: float = 5.0):
    """Band plot to ``path``; without matplotlib the plot is skipped with a
    note (the .npz and .dat exports hold the same data)."""
    try:
        import matplotlib
    except ImportError:
        print(f"band_cal: matplotlib is not installed, {os.path.basename(path)} not written")
        return

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5, 4))
    e = result["bands"] - result["fermi"]
    ax.plot(result["k_dist"], e, lw=0.8, color="tab:blue")
    for kn in result["k_node"]:
        ax.axvline(kn, color="k", lw=0.5)
    ax.axhline(0.0, color="r", lw=0.5, ls="--")
    if labels:
        ax.set_xticks(result["k_node"][: len(labels)])
        ax.set_xticklabels(labels)
    ax.set_ylim(-window, window)
    ax.set_ylabel("E - E_F (eV)")
    ax.set_xlim(result["k_dist"][0], result["k_dist"][-1])
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)


def write_band_dat(result: Dict[str, np.ndarray], path: str,
                   labels: Sequence[str] = ()):
    """Text export matching the reference's band .dat layout: k_label/k_node
    header lines, then one block per band of ``k_dist  E-E_F`` pairs with a
    blank line between bands."""
    bands = result["bands"] - result["fermi"]
    with open(path, "w") as f:
        f.write("# k_lable: " + " ".join(str(l) for l in labels) + "\n")
        f.write("# k_node: " + "  ".join(f"{k:f}" for k in result["k_node"]) + "\n")
        for nb in range(bands.shape[1]):
            for kd, en in zip(result["k_dist"], bands[:, nb]):
                f.write(f"{kd:f}    {en:f}\n")
            f.write("\n")


def write_cif(crystal: Dict[str, np.ndarray], path: str, au2ang: float = 0.5291772083):
    """Minimal CIF export (reference writes CIFs via pymatgen)."""
    from ..data.neighborlist import _SYMBOLS

    cell = np.asarray(crystal["cell"]).reshape(3, 3) * au2ang
    pos = np.asarray(crystal["pos"]) * au2ang
    frac = pos @ np.linalg.inv(cell)
    a, b, c = (np.linalg.norm(cell[i]) for i in range(3))
    import math

    def ang(u, v):
        return math.degrees(math.acos(
            np.dot(u, v) / (np.linalg.norm(u) * np.linalg.norm(v))))

    with open(path, "w") as f:
        f.write("data_structure\n")
        f.write(f"_cell_length_a {a:.6f}\n_cell_length_b {b:.6f}\n_cell_length_c {c:.6f}\n")
        f.write(f"_cell_angle_alpha {ang(cell[1], cell[2]):.4f}\n")
        f.write(f"_cell_angle_beta {ang(cell[0], cell[2]):.4f}\n")
        f.write(f"_cell_angle_gamma {ang(cell[0], cell[1]):.4f}\n")
        f.write("loop_\n_atom_site_label\n_atom_site_fract_x\n_atom_site_fract_y\n_atom_site_fract_z\n")
        for zi, fr in zip(np.asarray(crystal["z"], int), frac):
            f.write(f"{_SYMBOLS[zi]} {fr[0]:.6f} {fr[1]:.6f} {fr[2]:.6f}\n")


def main(argv=None):
    parser = argparse.ArgumentParser(description="band calculation")
    parser.add_argument("--config", default="band_cal.yaml", type=str)
    args = parser.parse_args(argv)
    with open(args.config, encoding="utf-8") as f:
        cfg = yaml.safe_load(f)

    nao = cfg["nao_max"]
    ham_type = cfg.get("Ham_type", "openmx").lower()
    soc = cfg.get("soc_switch", False)
    spin_col = cfg.get("spin_colinear", cfg.get("spin_collinear", False))
    basis = get_basis_set(ham_type, nao)
    save_dir = cfg["save_dir"]
    os.makedirs(save_dir, exist_ok=True)
    name = cfg.get("strcture_name", cfg.get("structure_name", "structure"))
    nk = cfg["nk"]

    graphs = load_graph_npz(cfg["graph_data_path"])
    ham_path = cfg.get("hamiltonian_path")
    H_flat = np.load(ham_path) if ham_path else None

    if cfg.get("auto_mode", False):
        k_nodes, labels = None, None  # per-crystal below
    else:
        k_nodes, labels = cfg["k_path"], cfg.get("label", [])

    ofs = 0
    for idx, c in enumerate(graphs):
        n = len(c["z"])
        e = np.asarray(c["edge_index"]).shape[1]
        rows = (2 if soc else 1) * (n + e)
        if H_flat is not None:
            h_rows = H_flat[ofs : ofs + (n + e)]
            ih_rows = H_flat[ofs + (n + e) : ofs + rows] if soc else None
            ofs += rows
        else:
            if soc:
                h_rows = np.concatenate([c["Hon"], c["Hoff"]])
                ih_rows = np.concatenate([c["iHon"], c["iHoff"]])
            else:
                h_rows = np.concatenate([c["Hon"], c["Hoff"]])
                ih_rows = None

        nodes, labs = (k_nodes, labels)
        if nodes is None:
            nodes, labs = _auto_k_path(np.asarray(c["cell"]).reshape(3, 3))

        if spin_col:
            # collinear-spin mode: rows carry a 2-channel spin dim; solve
            # each channel against the
            # spin-independent overlap, export band_spin{i}_* outputs
            h2 = np.asarray(h_rows)
            if h2.ndim != 3 or h2.shape[1] != 2:
                raise ValueError(
                    f"spin_colinear expects (rows, 2, nao^2) Hamiltonian "
                    f"stacks, got {h2.shape}")
            for ispin in range(2):
                res = band_structure_for_crystal(
                    c, h2[:, ispin], nao, basis, nk, nodes, soc=False)
                stem = os.path.join(save_dir, f"band_spin{ispin}_{idx}")
                np.savez(stem + ".npz", k_dist=res["k_dist"],
                         k_node=res["k_node"], bands=res["bands"],
                         fermi=res["fermi"], gap=res["gap"])
                plot_bands(res, labs, stem + ".png")
                write_band_dat(res, stem + ".dat", labs or ())
                print(f"[{idx}] spin {ispin}: gap = {res['gap']:.4f} eV, "
                      f"E_F = {res['fermi']:.4f} eV")
            write_cif(c, os.path.join(save_dir, f"{name}_{idx}.cif"))
            continue

        res = band_structure_for_crystal(
            c, h_rows, nao, basis, nk, nodes, soc=soc, ih_rows=ih_rows)
        np.savez(os.path.join(save_dir, f"{name}_{idx}_bands.npz"),
                 k_dist=res["k_dist"], k_node=res["k_node"], bands=res["bands"],
                 fermi=res["fermi"], gap=res["gap"])
        plot_bands(res, labs, os.path.join(save_dir, f"{name}_{idx}_bands.png"))
        write_band_dat(res, os.path.join(save_dir, f"{name}_{idx}_bands.dat"), labs or ())
        write_cif(c, os.path.join(save_dir, f"{name}_{idx}.cif"))
        print(f"[{idx}] gap = {res['gap']:.4f} eV, E_F = {res['fermi']:.4f} eV")


if __name__ == "__main__":
    main()
