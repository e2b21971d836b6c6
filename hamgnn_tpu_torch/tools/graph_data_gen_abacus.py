"""graph_data_gen_abacus: ABACUS sparse-matrix outputs -> graph_data.npz, the
port's counterpart of ``hamgnn_tpu/tools/graph_data_gen_abacus.py`` (host only).

    python -m hamgnn_tpu_torch.tools.graph_data_gen_abacus --config <yaml> [--native]

YAML keys: nao_max, graph_data_save_path, calc_paths (glob of OUT.* run
dirs), stru_file_name, hr_file_name, sr_file_name, [h0_file_name],
soc_switch.  The CSR files are read in Python, or with ``--native`` by
``native/csr_reader.cpp``.
"""

from __future__ import annotations

import argparse
import glob
import os

import yaml

from ..data.dataset import save_graph_npz
from ..interfaces.abacus import build_graph_from_csr, pack_crystal_abacus, parse_stru


def main(argv=None):
    parser = argparse.ArgumentParser(description="ABACUS graph data generation")
    parser.add_argument("--config", default="graph_data_gen_abacus.yaml")
    parser.add_argument("--native", action="store_true",
                        help="read the CSR files with the native reader (built on "
                             "first use) instead of the Python parser")
    args = parser.parse_args(argv)
    with open(args.config, encoding="utf-8") as f:
        cfg = yaml.safe_load(f)

    nao_max = cfg["nao_max"]
    out_dir = cfg["graph_data_save_path"]
    os.makedirs(out_dir, exist_ok=True)
    stru_name = cfg.get("stru_file_name", "STRU")
    hr_name = cfg.get("hr_file_name", "data-HR-sparse_SPIN0.csr")
    sr_name = cfg.get("sr_file_name", "data-SR-sparse_SPIN0.csr")
    h0_name = cfg.get("h0_file_name")
    soc = cfg.get("soc_switch", False)

    crystals = []
    for d in sorted(glob.glob(cfg["calc_paths"])):
        stru_p = os.path.join(d, stru_name)
        hr_p = os.path.join(d, hr_name)
        if not (os.path.exists(stru_p) and os.path.exists(hr_p)):
            print(f"skip {d}: missing inputs")
            continue
        try:
            stru = parse_stru(stru_p)
            sr_p = os.path.join(d, sr_name)
            g = build_graph_from_csr(stru, hr_p,
                                     sr_p if os.path.exists(sr_p) else None,
                                     soc=soc, native=args.native)
            c = pack_crystal_abacus(g, stru, nao_max, soc=soc)
            if h0_name and os.path.exists(os.path.join(d, h0_name)):
                g0 = build_graph_from_csr(stru, os.path.join(d, h0_name),
                                          None, soc=soc, native=args.native)
                c0 = pack_crystal_abacus(g0, stru, nao_max, soc=soc)
                c["Hon0"] = c0["Hon"]
                c["Hoff0"] = c0["Hoff"]
                if soc:
                    c["iHon0"] = c0["iHon"]
                    c["iHoff0"] = c0["iHoff"]
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
