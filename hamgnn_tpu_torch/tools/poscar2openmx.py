"""poscar2openmx: POSCAR/VASP structures -> OpenMX .dat input decks, the
port's counterpart of ``hamgnn_tpu/tools/poscar2openmx.py``.

    python -m hamgnn_tpu_torch.tools.poscar2openmx --config poscar2openmx.yaml

YAML keys: system_name, poscar_path (glob), filepath, basic_command.  A
minimal POSCAR reader (no pymatgen or ASE); the species tables are in
:mod:`hamgnn_tpu_torch.interfaces.openmx_tables`.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import List, Tuple

import numpy as np
import yaml

from ..interfaces.openmx_tables import PAO_dict, PBE_dict, spin_set


def read_poscar(path: str) -> Tuple[np.ndarray, List[str], np.ndarray]:
    """Minimal VASP5 POSCAR reader -> (cell Ang, symbols, cartesian pos Ang)."""
    with open(path) as f:
        lines = [ln.rstrip() for ln in f if ln.strip()]
    scale = float(lines[1].split()[0])
    cell = np.array([[float(v) for v in lines[2 + i].split()[:3]] for i in range(3)])
    if scale < 0:  # negative scale = target volume
        vol = abs(np.linalg.det(cell))
        scale = (-scale / vol) ** (1.0 / 3.0)
    cell = cell * scale
    symbols = lines[5].split()
    counts = [int(v) for v in lines[6].split()]
    idx = 7
    if lines[idx][0].lower() == "s":  # Selective dynamics
        idx += 1
    direct = lines[idx][0].lower() in ("d",)
    idx += 1
    n = sum(counts)
    coords = np.array([[float(v) for v in lines[idx + i].split()[:3]] for i in range(n)])
    pos = coords @ cell if direct else coords * scale
    syms = [s for s, c in zip(symbols, counts) for _ in range(c)]
    return cell, syms, pos


def write_openmx_dat(cell: np.ndarray, symbols: List[str], pos: np.ndarray,
                     basic_command: str, filename: str) -> None:
    """Emit the OpenMX .dat deck."""
    species = list(dict.fromkeys(symbols))
    out = basic_command
    out += "#\n# Definition of Atomic Species\n#\n"
    out += f"Species.Number       {len(species)}\n"
    out += "<Definition.of.Atomic.Species\n"
    for s in species:
        out += f"{s}   {PAO_dict[s]}       {PBE_dict[s]}\n"
    out += "Definition.of.Atomic.Species>\n\n"
    out += "#\n# Atoms\n#\n"
    out += "Atoms.Number%12d" % len(symbols)
    out += "\nAtoms.SpeciesAndCoordinates.Unit   Ang # Ang|AU"
    out += "\n<Atoms.SpeciesAndCoordinates           # Unit=Ang."
    for i, sym in enumerate(symbols):
        out += "\n%3d  %s  %10.7f  %10.7f  %10.7f   %.2f   %.2f" % (
            i + 1, sym, *pos[i], *spin_set[sym])
    out += "\nAtoms.SpeciesAndCoordinates>"
    out += "\nAtoms.UnitVectors.Unit             Ang #  Ang|AU"
    out += "\n<Atoms.UnitVectors                     # unit=Ang."
    out += "\n      %10.7f  %10.7f  %10.7f\n      %10.7f  %10.7f  %10.7f\n      %10.7f  %10.7f  %10.7f" % (
        *cell[0], *cell[1], *cell[2])
    out += "\nAtoms.UnitVectors>"
    with open(filename, "w") as f:
        f.write(out)


def main(argv=None):
    parser = argparse.ArgumentParser(description="openmx dat file generation")
    parser.add_argument("--config", default="poscar2openmx.yaml", type=str)
    args = parser.parse_args(argv)
    with open(args.config, encoding="utf-8") as f:
        cfg = yaml.safe_load(f)

    system_name = cfg["system_name"]
    out_dir = cfg["filepath"]
    os.makedirs(out_dir, exist_ok=True)
    files = sorted(glob.glob(cfg["poscar_path"]))
    for i, poscar in enumerate(files):
        cell, syms, pos = read_poscar(poscar)
        filename = os.path.join(out_dir, f"{system_name}_{i + 1}.dat")
        write_openmx_dat(cell, syms, pos, cfg["basic_command"], filename)
    print(f"wrote {len(files)} .dat files to {out_dir}")


if __name__ == "__main__":
    main()
