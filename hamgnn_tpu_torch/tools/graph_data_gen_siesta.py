"""graph_data_gen_siesta: SIESTA/HONPAS outputs -> graph_data.npz, the port's
counterpart of ``hamgnn_tpu/tools/graph_data_gen_siesta.py`` (host only).

    python -m hamgnn_tpu_torch.tools.graph_data_gen_siesta --config <yaml> [--native]

YAML keys: nao_max, graph_data_save_path, calc_paths (glob of run
directories), fdf_file_name, hsx_file_name, [h0_hsx_file_name].  The .HSX
files are parsed directly, or with ``--native`` by ``native/hsx_reader.cpp``.
"""

from __future__ import annotations

import argparse
import glob
import os

import yaml

from ..data.dataset import save_graph_npz
from ..interfaces.siesta import (hsx_to_graph, pack_crystal_siesta, parse_fdf, parse_hsx,
                                 parse_hsx_native)


def main(argv=None):
    parser = argparse.ArgumentParser(description="SIESTA graph data generation")
    parser.add_argument("--config", default="graph_data_gen_siesta.yaml")
    parser.add_argument("--native", action="store_true",
                        help="read the .HSX files with the native reader (built on "
                             "first use) instead of the Python parser")
    args = parser.parse_args(argv)
    read = parse_hsx_native if args.native else parse_hsx
    with open(args.config, encoding="utf-8") as f:
        cfg = yaml.safe_load(f)

    nao_max = cfg["nao_max"]
    out_dir = cfg["graph_data_save_path"]
    os.makedirs(out_dir, exist_ok=True)
    fdf_name = cfg.get("fdf_file_name", "input.fdf")
    hsx_name = cfg.get("hsx_file_name", "siesta.HSX")
    h0_name = cfg.get("h0_hsx_file_name")

    crystals = []
    for d in sorted(glob.glob(cfg["calc_paths"])):
        fdf_p = os.path.join(d, fdf_name)
        hsx_p = os.path.join(d, hsx_name)
        if not (os.path.exists(fdf_p) and os.path.exists(hsx_p)):
            print(f"skip {d}: missing inputs")
            continue
        try:
            fdf = parse_fdf(fdf_p)
            hsx = read(hsx_p)
            g = hsx_to_graph(hsx, fdf)
            c = pack_crystal_siesta(g, fdf, nao_max)
            if h0_name and os.path.exists(os.path.join(d, h0_name)):
                hsx0 = read(os.path.join(d, h0_name))
                g0 = hsx_to_graph(hsx0, fdf)
                c0 = pack_crystal_siesta(g0, fdf, nao_max)
                c["Hon0"] = c0["Hon"]
                c["Hoff0"] = c0["Hoff"]
            crystals.append(c)
        except Exception as exc:
            print(f"skip {d}: {exc}")
    if not crystals:
        print("No valid data found!")
        return
    save_graph_npz(os.path.join(out_dir, "graph_data.npz"), crystals)
    print(f"saved {len(crystals)} structures")


if __name__ == "__main__":
    main()
