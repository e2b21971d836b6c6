"""graph_data_gen: OpenMX scfout directories -> graph_data.npz, the port's
counterpart of ``hamgnn_tpu/tools/graph_data_gen.py`` (host only).

    python -m hamgnn_tpu_torch.tools.graph_data_gen --config graph_data_gen.yaml [--native]

YAML keys: nao_max, graph_data_save_path, max_SCF_skip, scfout_paths (glob),
dat_file_name, std_file_name, scfout_file_name, soc_switch, doping_charge
(``read_openmx_path`` is accepted and unused: parsing happens in-process).
A directory is skipped when its .dat or scfout is missing, when its .std
counts ``max_SCF_skip`` SCF steps or more, or when its scfout cannot be read.

H0: a file named ``overlap.scfout`` beside the target scfout is read as the
non-self-consistent H0.  ``--native`` reads the scfout files with the port's
C++ reader (``interfaces/native.py``) in place of the Python parser.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import tempfile

import numpy as np
import yaml

from ..data.dataset import save_graph_npz
from ..interfaces.openmx import (pack_crystal, parse_scfout, parse_scfout_native,
                                 scfout_from_native)

AU2ANG = 0.5291772490000065

_PATTERN_ENG = re.compile(r"Enpy  =(\W+)(\-\d+\.?\d*)")
_PATTERN_MD = re.compile(r"MD= 1  SCF=(\W*)(\d+)")
_PATTERN_LATT = re.compile(
    r"<Atoms.UnitVectors.+?\s+(\-?\d+\.?\d+)\s+(\-?\d+\.?\d+)\s+(\-?\d+\.?\d+)"
    r"\s+(\-?\d+\.?\d+)\s+(\-?\d+\.?\d+)\s+(\-?\d+\.?\d+)"
    r"\s+(\-?\d+\.?\d+)\s+(\-?\d+\.?\d+)\s+(\-?\d+\.?\d+)\s+Atoms.UnitVectors>")
_PATTERN_COOR = re.compile(
    r"\s+\d+\s+(\w+)\s+(\-?\d+\.?\d+)\s+(\-?\d+\.?\d+)\s+(\-?\d+\.?\d+)"
    r"\s+\-?\d+\.?\d+\s+\-?\d+\.?\d+")

_SYMBOL_Z = {s: i for i, s in enumerate([
    "X", "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne", "Na", "Mg",
    "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca", "Sc", "Ti", "V", "Cr", "Mn",
    "Fe", "Co", "Ni", "Cu", "Zn", "Ga", "Ge", "As", "Se", "Br", "Kr", "Rb",
    "Sr", "Y", "Zr", "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd", "In",
    "Sn", "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd", "Pm",
    "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb", "Lu", "Hf", "Ta",
    "W", "Re", "Os", "Ir", "Pt", "Au", "Hg", "Tl", "Pb", "Bi"])}


def read_openmx_dat(path: str):
    """Parse lattice/species/coords from an OpenMX .dat input (Bohr units)."""
    with open(path) as f:
        content = f.read()
    latt = _PATTERN_LATT.findall(content.strip())[0]
    latt = np.array([float(v) for v in latt]).reshape(3, 3) / AU2ANG
    species, coords = [], []
    for item in _PATTERN_COOR.findall(content.strip()):
        species.append(item[0])
        coords.extend(item[1:])
    z = np.array([_SYMBOL_Z[s] for s in species], np.int64)
    pos = np.array([float(c) for c in coords]).reshape(-1, 3) / AU2ANG
    return z, latt, pos


def read_std(path: str):
    """Total energy and SCF step count from an OpenMX .std log."""
    with open(path) as f:
        content = f.read()
    eng = _PATTERN_ENG.findall(content)
    scf = _PATTERN_MD.findall(content)
    total_energy = float(eng[0][1]) if eng else 0.0
    scf_steps = int(scf[0][1]) if scf else 0
    return total_energy, scf_steps


def _read_native(path: str):
    """:func:`parse_scfout`'s result through the native reader; its JSON goes
    to a temporary file."""
    with tempfile.TemporaryDirectory() as tmp:
        return scfout_from_native(parse_scfout_native(path, os.path.join(tmp, "HS.json")))


def main(argv=None):
    parser = argparse.ArgumentParser(description="graph data generation")
    parser.add_argument("--config", default="graph_data_gen.yaml", type=str)
    parser.add_argument("--native", action="store_true",
                        help="read the scfout files with the native reader (built on "
                             "first use) instead of the Python parser")
    args = parser.parse_args(argv)
    read = _read_native if args.native else parse_scfout
    with open(args.config, encoding="utf-8") as f:
        cfg = yaml.safe_load(f)

    nao_max = cfg["nao_max"]
    out_dir = cfg["graph_data_save_path"]
    max_scf_skip = cfg.get("max_SCF_skip", 200)
    soc = cfg.get("soc_switch", False)
    doping = cfg.get("doping_charge", 0.0)
    dat_name = cfg.get("dat_file_name", "openmx.dat")
    std_name = cfg.get("std_file_name")
    scfout_name = cfg.get("scfout_file_name", "openmx.scfout")

    os.makedirs(out_dir, exist_ok=True)
    dirs = sorted(glob.glob(cfg["scfout_paths"]))
    crystals = []
    for d in dirs:
        dat = os.path.join(d, dat_name)
        scfout = os.path.join(d, scfout_name)
        if not (os.path.exists(dat) and os.path.exists(scfout)):
            print(f"skip {d}: missing {dat_name} or {scfout_name}")
            continue
        total_energy, scf_steps = (0.0, 0)
        if std_name:
            std = os.path.join(d, std_name)
            if os.path.exists(std):
                total_energy, scf_steps = read_std(std)
                if scf_steps >= max_scf_skip:
                    print(f"skip {d}: SCF did not converge ({scf_steps} steps)")
                    continue
        z, _latt, _pos = read_openmx_dat(dat)
        try:
            scf = read(scfout)
        except Exception as exc:  # an unreadable scfout is skipped
            print(f"skip {d}: {exc}")
            continue
        scf0 = None
        h0_path = os.path.join(d, "overlap.scfout")
        if os.path.exists(h0_path) and os.path.abspath(h0_path) != os.path.abspath(scfout):
            scf0 = read(h0_path)
        crystals.append(pack_crystal(
            scf, z=z, nao_max=nao_max, scf0=scf0, soc=soc,
            total_energy=total_energy, doping_charge=doping))

    if not crystals:
        print("No valid data found! Check input paths / DFT convergence.")
        return
    out_path = os.path.join(out_dir, "graph_data.npz")
    save_graph_npz(out_path, crystals)
    print(f"The graph data is saved in {out_path} ({len(crystals)} structures)")


if __name__ == "__main__":
    main()
