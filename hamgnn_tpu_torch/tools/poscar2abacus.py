"""poscar2abacus: POSCAR structures -> ABACUS STRU decks, and poscar2siesta's
FDF files, the port's counterpart of ``hamgnn_tpu/tools/poscar2abacus.py``.

    python -m hamgnn_tpu_torch.tools.poscar2abacus --config poscar2abacus.yaml [--format siesta]

YAML keys: system_name, poscar_path (glob), filepath, and per-species
pseudopotential and orbital file names (pp_dict / orb_dict) for ABACUS, or a
``template`` for SIESTA.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import Dict, List

import numpy as np
import yaml

from .poscar2openmx import read_poscar

_Z = {"H": 1, "He": 2, "Li": 3, "Be": 4, "B": 5, "C": 6, "N": 7, "O": 8,
      "F": 9, "Ne": 10, "Na": 11, "Mg": 12, "Al": 13, "Si": 14, "P": 15,
      "S": 16, "Cl": 17, "Ar": 18, "K": 19, "Ca": 20, "Fe": 26, "Cu": 29}


def write_stru(cell, symbols: List[str], pos, pp: Dict[str, str],
               orb: Dict[str, str], filename: str) -> None:
    """ABACUS STRU in Cartesian Angstrom -> LATTICE_CONSTANT 1.8897 (Bohr/Ang)."""
    species = list(dict.fromkeys(symbols))
    with open(filename, "w") as f:
        f.write("ATOMIC_SPECIES\n")
        for s in species:
            f.write(f"{s} 1.0 {pp.get(s, s + '.upf')}\n")
        f.write("\nNUMERICAL_ORBITAL\n")
        for s in species:
            f.write(f"{orb.get(s, s + '_gga_7au_100Ry_2s2p1d.orb')}\n")
        f.write("\nLATTICE_CONSTANT\n1.8897259886\n")
        f.write("\nLATTICE_VECTORS\n")
        for r in cell:
            f.write("%.10f %.10f %.10f\n" % tuple(r))
        f.write("\nATOMIC_POSITIONS\nDirect\n")
        frac = np.asarray(pos) @ np.linalg.inv(cell)
        for s in species:
            f.write(f"{s}\n0.0\n")
            idx = [i for i, x in enumerate(symbols) if x == s]
            f.write(f"{len(idx)}\n")
            for i in idx:
                f.write("%.10f %.10f %.10f 0 0 0\n" % tuple(frac[i]))


def write_fdf(cell, symbols: List[str], pos, template: str, filename: str) -> None:
    """SIESTA FDF structure block (Ang)."""
    species = list(dict.fromkeys(symbols))
    with open(filename, "w") as f:
        f.write(template)
        f.write("\nLatticeConstant 1.0 Ang\n%block LatticeVectors\n")
        for r in cell:
            f.write("  %.10f %.10f %.10f\n" % tuple(r))
        f.write("%endblock LatticeVectors\n")
        f.write(f"\nNumberOfSpecies {len(species)}\n")
        f.write("%block ChemicalSpeciesLabel\n")
        for i, s in enumerate(species):
            f.write(f"  {i + 1}  {_Z.get(s, 1)}  {s}\n")
        f.write("%endblock ChemicalSpeciesLabel\n")
        f.write(f"\nNumberOfAtoms {len(symbols)}\n")
        f.write("AtomicCoordinatesFormat Ang\n")
        f.write("%block AtomicCoordinatesAndAtomicSpecies\n")
        for i, s in enumerate(symbols):
            f.write("  %.10f %.10f %.10f %d\n" % (*pos[i], species.index(s) + 1))
        f.write("%endblock AtomicCoordinatesAndAtomicSpecies\n")


def main(argv=None):
    parser = argparse.ArgumentParser(description="POSCAR -> ABACUS STRU / SIESTA FDF")
    parser.add_argument("--config", default="poscar2abacus.yaml")
    parser.add_argument("--format", choices=["abacus", "siesta"], default="abacus")
    args = parser.parse_args(argv)
    with open(args.config, encoding="utf-8") as f:
        cfg = yaml.safe_load(f)
    out_dir = cfg["filepath"]
    os.makedirs(out_dir, exist_ok=True)
    name = cfg.get("system_name", "structure")
    for i, poscar in enumerate(sorted(glob.glob(cfg["poscar_path"]))):
        cell, syms, pos = read_poscar(poscar)
        if args.format == "abacus":
            write_stru(cell, syms, pos, cfg.get("pp_dict", {}),
                       cfg.get("orb_dict", {}),
                       os.path.join(out_dir, f"{name}_{i + 1}.STRU"))
        else:
            write_fdf(cell, syms, pos, cfg.get("template", ""),
                      os.path.join(out_dir, f"{name}_{i + 1}.fdf"))
    print("done")


def main_siesta(argv=None):
    """``poscar2siesta``: the same driver with the SIESTA FDF writer selected
    and its own default config."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(a.startswith("--config") for a in argv):
        argv += ["--config", "poscar2siesta.yaml"]
    return main(argv + ["--format", "siesta"])


if __name__ == "__main__":
    main()
