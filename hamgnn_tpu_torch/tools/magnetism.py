"""Magnetism workflows for OpenMX: spin-polarized inputs and graph packing,
counterpart of ``hamgnn_tpu/tools/magnetism.py`` (host numpy, no device).

    python -m hamgnn_tpu_torch.tools.magnetism <workflow> --config magnetism.yaml

A condensed equivalent of the reference's magnetism subpackage (cli.py,
graph_data.py, spin.py, openmx_input.py), four workflows behind one CLI:

  * ``convert-collinear``   - POSCAR -> spin-polarized OpenMX .dat (per-species
    up/down spins with per-atom overrides);
  * ``convert-noncollinear``- XSF (with spin vectors) -> non-collinear .dat
    (theta/phi from the spin direction, the reference's spin.py semantics);
  * ``make-xsf-spin``       - attach generated spin vectors to structures as XSF;
  * ``pack-graph-data``     - scfout dirs -> graph_data.npz with collinear
    H_u/H_d stacks or non-collinear (2 nao)^2 + spin vectors
    (the reference's graph_data.py semantics, via ``interfaces/openmx.py``).
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Dict, List, Sequence

import numpy as np
import yaml

from ..interfaces.openmx_tables import PAO_dict, PBE_dict, spin_set


# --- spin utilities (the reference's magnetism/spin.py) -------------------

def read_xsf_spin(path: str):
    """Parse an XSF file whose PRIMCOORD rows carry (x y z sx sy sz)."""
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    cell = None
    pos, spins, syms = [], [], []
    i = 0
    while i < len(lines):
        if lines[i].upper().startswith("PRIMVEC"):
            cell = np.array([[float(v) for v in lines[i + 1 + k].split()[:3]]
                             for k in range(3)])
            i += 4
        elif lines[i].upper().startswith("PRIMCOORD"):
            n = int(lines[i + 1].split()[0])
            for k in range(n):
                t = lines[i + 2 + k].split()
                syms.append(t[0])
                pos.append([float(v) for v in t[1:4]])
                spins.append([float(v) for v in t[4:7]] if len(t) >= 7 else [0, 0, 0])
            i += 2 + n
        else:
            i += 1
    return cell, syms, np.asarray(pos), np.asarray(spins)


def spin_to_spherical(spin: np.ndarray, nonmagnetic_threshold: float = 0.01):
    """(sx, sy, sz) -> (|s|, theta_deg, phi_deg); zero vector -> (0, 0, 0)."""
    s = np.linalg.norm(spin)
    if s < nonmagnetic_threshold:
        return 0.0, 0.0, 0.0
    theta = np.degrees(np.arccos(np.clip(spin[2] / s, -1, 1)))
    phi = np.degrees(np.arctan2(spin[1], spin[0]))
    return float(s), float(theta), float(phi)


def generate_spin_vectors(n: int, mode: str = "fm", axis=(0, 0, 1),
                          magnitude: float = 1.0, seed: int = 0) -> np.ndarray:
    axis = np.asarray(axis, float)
    axis = axis / np.linalg.norm(axis)
    if mode == "fm":
        return np.tile(axis * magnitude, (n, 1))
    if mode == "afm":
        out = np.tile(axis * magnitude, (n, 1))
        out[1::2] *= -1
        return out
    if mode == "random":
        rng = np.random.default_rng(seed)
        v = rng.normal(size=(n, 3))
        return magnitude * v / np.linalg.norm(v, axis=1, keepdims=True)
    raise ValueError(f"unknown spin mode {mode}")


# --- input generation ------------------------------------------------------

def _atom_spins(symbols: Sequence[str], species_overrides: Dict,
                atom_overrides: Dict) -> List[List[float]]:
    out = []
    for i, s in enumerate(symbols):
        spin = list(spin_set.get(s, [0.0, 0.0]))
        if s in species_overrides and "spin" in species_overrides[s]:
            spin = list(species_overrides[s]["spin"])
        if (i + 1) in atom_overrides:
            spin = list(atom_overrides[i + 1])
        out.append(spin)
    return out


def write_collinear_dat(cell, symbols, pos, template: str, filename: str,
                        species_overrides=None, atom_overrides=None):
    species_overrides = species_overrides or {}
    atom_overrides = atom_overrides or {}
    spins = _atom_spins(symbols, species_overrides, atom_overrides)
    species = list(dict.fromkeys(symbols))
    out = template
    out += "#\n# Definition of Atomic Species\n#\n"
    out += f"Species.Number       {len(species)}\n<Definition.of.Atomic.Species\n"
    for s in species:
        out += f"{s}   {PAO_dict[s]}       {PBE_dict[s]}\n"
    out += "Definition.of.Atomic.Species>\n\n"
    out += "Atoms.Number%12d" % len(symbols)
    out += "\nAtoms.SpeciesAndCoordinates.Unit   Ang"
    out += "\n<Atoms.SpeciesAndCoordinates"
    for i, s in enumerate(symbols):
        out += "\n%3d  %s  %10.7f  %10.7f  %10.7f   %.2f   %.2f" % (
            i + 1, s, *pos[i], *spins[i])
    out += "\nAtoms.SpeciesAndCoordinates>"
    out += "\nAtoms.UnitVectors.Unit             Ang"
    out += "\n<Atoms.UnitVectors"
    for r in cell:
        out += "\n      %10.7f  %10.7f  %10.7f" % tuple(r)
    out += "\nAtoms.UnitVectors>"
    with open(filename, "w") as f:
        f.write(out)


def write_noncollinear_dat(cell, symbols, pos, spins_xyz, template: str,
                           filename: str, species_overrides=None,
                           atom_overrides=None):
    """Non-collinear deck: per-atom spin magnitude split up/down plus
    theta/phi angles and constraint flags (OpenMX NC format)."""
    species_overrides = species_overrides or {}
    atom_overrides = atom_overrides or {}
    base = _atom_spins(symbols, species_overrides, atom_overrides)
    species = list(dict.fromkeys(symbols))
    out = template
    out += "#\n# Definition of Atomic Species\n#\n"
    out += f"Species.Number       {len(species)}\n<Definition.of.Atomic.Species\n"
    for s in species:
        out += f"{s}   {PAO_dict[s]}       {PBE_dict[s]}\n"
    out += "Definition.of.Atomic.Species>\n\n"
    out += "Atoms.Number%12d" % len(symbols)
    out += "\nAtoms.SpeciesAndCoordinates.Unit   Ang"
    out += "\n<Atoms.SpeciesAndCoordinates"
    for i, s in enumerate(symbols):
        mag, theta, phi = spin_to_spherical(np.asarray(spins_xyz[i]))
        up, dn = base[i]
        out += ("\n%3d  %s  %10.7f  %10.7f  %10.7f   %.2f  %.2f  %.2f  %.2f"
                "  %.2f  %.2f  1 on" % (
                    i + 1, s, *pos[i], up, dn, theta, phi, theta, phi))
    out += "\nAtoms.SpeciesAndCoordinates>"
    out += "\nAtoms.UnitVectors.Unit             Ang"
    out += "\n<Atoms.UnitVectors"
    for r in cell:
        out += "\n      %10.7f  %10.7f  %10.7f" % tuple(r)
    out += "\nAtoms.UnitVectors>"
    with open(filename, "w") as f:
        f.write(out)


def write_xsf(cell, symbols, pos, spins, filename: str):
    with open(filename, "w") as f:
        f.write("CRYSTAL\nPRIMVEC\n")
        for r in cell:
            f.write("  %12.7f %12.7f %12.7f\n" % tuple(r))
        f.write(f"PRIMCOORD\n{len(symbols)} 1\n")
        for s, p, sv in zip(symbols, pos, spins):
            f.write("%s  %12.7f %12.7f %12.7f  %8.4f %8.4f %8.4f\n"
                    % (s, *p, *sv))


# --- graph packing ---------------------------------------------------------

def pack_collinear_graph(scf, z, nao_max, scf0=None, spin_vectors=None):
    """Collinear spin graph: H stacked as (rows, 2, nao^2) up/down channels
    (the reference's magnetism/graph_data.py)."""
    from ..interfaces.openmx import _dense_rows, inverse_edges
    from ..models.basis import get_basis_set

    basis = get_basis_set("openmx", nao_max)
    z = np.asarray(z, np.int64)
    src, dst = scf.edge_src, scf.edge_dst
    inv = inverse_edges(src, dst, scf.cell_shift)
    assert scf.spinp_switch >= 1, "collinear packing needs spin-polarized scfout"

    def on(blocks):
        return _dense_rows(blocks, z, z, basis, nao_max)

    def off(blocks):
        return _dense_rows(blocks, z[src], z[dst], basis, nao_max)

    out = {
        "z": z, "cell": scf.cell[None], "pos": scf.pos,
        "edge_index": np.stack([src, dst]), "inv_edge_idx": inv,
        "cell_shift": scf.cell_shift, "nbr_shift": scf.nbr_shift,
        "Hon": np.stack([on(scf.Hon[0]), on(scf.Hon[1])], axis=1),
        "Hoff": np.stack([off(scf.Hoff[0]), off(scf.Hoff[1])], axis=1),
        "Son": on(scf.Son), "Soff": off(scf.Soff),
    }
    if scf0 is not None:
        h0_on = on(scf0.Hon[0] if scf0.spinp_switch == 0 else scf0.Hon[0])
        h0_off = off(scf0.Hoff[0] if scf0.spinp_switch == 0 else scf0.Hoff[0])
        out["Hon0"] = np.stack([h0_on, h0_on], axis=1)
        out["Hoff0"] = np.stack([h0_off, h0_off], axis=1)
    if spin_vectors is not None:
        out["spin_vec"] = np.asarray(spin_vectors, float)
        out["spin_length"] = np.linalg.norm(out["spin_vec"], axis=-1)
    return out


def pack_noncollinear_graph(scf, z, nao_max, scf0=None, spin_vectors=None):
    """Non-collinear: SOC-style (2 nao)^2 packing + spin vectors + L matrices."""
    from ..interfaces.openmx import pack_crystal

    out = pack_crystal(scf, z=z, nao_max=nao_max, scf0=scf0, soc=True)
    if spin_vectors is not None:
        out["spin_vec"] = np.asarray(spin_vectors, float)
        out["spin_length"] = np.linalg.norm(out["spin_vec"], axis=-1)
    return out


# --- CLI -------------------------------------------------------------------

def main(argv=None):
    parser = argparse.ArgumentParser(description="OpenMX magnetism workflows")
    parser.add_argument("workflow", choices=[
        "convert-collinear", "convert-noncollinear", "make-xsf-spin",
        "pack-graph-data"])
    parser.add_argument("--config", required=True)
    parser.add_argument("--dry-run", action="store_true")
    args = parser.parse_args(argv)
    with open(args.config, encoding="utf-8") as f:
        cfg = yaml.safe_load(f)

    patterns = cfg.get("inputs", {}).get("patterns", [])
    out_dir = cfg.get("outputs", {}).get("directory", "./out")
    dry = args.dry_run or cfg.get("runtime", {}).get("dry_run", False)
    files = sorted(sum((glob.glob(p) for p in patterns), []))
    if not dry:
        os.makedirs(out_dir, exist_ok=True)

    if args.workflow == "convert-collinear":
        from .poscar2openmx import read_poscar

        wf = cfg.get("convert_collinear", {})
        for i, path in enumerate(files):
            cell, syms, pos = read_poscar(path)
            name = os.path.join(out_dir, f"collinear_{i + 1}.dat")
            print(("DRY " if dry else "") + f"write {name}")
            if not dry:
                write_collinear_dat(
                    cell, syms, pos, wf.get("template", ""), name,
                    cfg.get("species", {}).get("overrides", {}),
                    cfg.get("atom_spins", {}))
    elif args.workflow == "convert-noncollinear":
        wf = cfg.get("convert_noncollinear", {})
        for i, path in enumerate(files):
            cell, syms, pos, spins = read_xsf_spin(path)
            name = os.path.join(out_dir, f"noncollinear_{i + 1}.dat")
            print(("DRY " if dry else "") + f"write {name}")
            if not dry:
                write_noncollinear_dat(
                    cell, syms, pos, spins, wf.get("template", ""), name,
                    cfg.get("species", {}).get("overrides", {}),
                    cfg.get("atom_spins", {}))
    elif args.workflow == "make-xsf-spin":
        from .poscar2openmx import read_poscar

        wf = cfg.get("make_xsf_spin", {})
        for i, path in enumerate(files):
            cell, syms, pos = read_poscar(path)
            spins = generate_spin_vectors(
                len(syms), mode=wf.get("mode", "fm"),
                axis=wf.get("axis", (0, 0, 1)),
                magnitude=wf.get("magnitude", 1.0))
            name = os.path.join(out_dir, f"spin_{i + 1}.xsf")
            print(("DRY " if dry else "") + f"write {name}")
            if not dry:
                write_xsf(cell, syms, pos, spins, name)
    else:  # pack-graph-data
        from ..data.dataset import save_graph_npz
        from ..interfaces.openmx import parse_scfout
        from .graph_data_gen import read_openmx_dat

        wf = cfg.get("pack_graph_data", {})
        nao_max = wf.get("nao_max", 14)
        collinear = wf.get("collinear", True)
        crystals = []
        for d in files:
            scfout = os.path.join(d, wf.get("scfout_file_name", "openmx.scfout"))
            dat = os.path.join(d, wf.get("dat_file_name", "openmx.dat"))
            if not (os.path.exists(scfout) and os.path.exists(dat)):
                continue
            z, _, _ = read_openmx_dat(dat)
            scf = parse_scfout(scfout)
            pack = pack_collinear_graph if collinear else pack_noncollinear_graph
            crystals.append(pack(scf, z, nao_max))
        if dry:
            print(f"DRY would pack {len(crystals)} structures")
            return
        save_graph_npz(os.path.join(out_dir, "graph_data.npz"), crystals)
        print(f"packed {len(crystals)} structures")


if __name__ == "__main__":
    main()
