"""What the benchmark's CPU tests share: the benchmark's folder and the
checkout's root on the path (as ``benchmark/run.py`` puts them), and a cell
cut to a size the CPU holds (the configuration's widths and the traffic's
crystals made small, the cell's limits kept)."""

import copy
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for _p in (ROOT, BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import spec  # noqa: E402

TINY_REPRESENTATION = {"irreps_node_features": "8x0e+4x1o+2x2e+2x3o",
                       "irreps_edge_sh": "0e+1o+2e", "num_layers": 2, "num_radial": 8,
                       "radial_MLP": [8]}
TINY_TRAFFIC = {"atoms": 6, "cell_A": 6.0, "neighbour_cutoff_A": 4.0, "edge_quantum": 64}
CELLS = ("nao26-train-c512", "nao26soc-train-c512", "nao26-predict-c512")


def tiny_cell(name: str) -> spec.Cell:
    cell = copy.deepcopy(spec.resolve(ROOT, name))
    cell.config["model"]["representation_nets"]["HamGNN_pre"].update(TINY_REPRESENTATION)
    cell.traffic.update(TINY_TRAFFIC)
    return cell
