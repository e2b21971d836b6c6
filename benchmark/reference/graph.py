"""The crystal graph the reference model reads: the ``Graph`` fields of
``hamgnn_tpu_torch/data/graph.py`` (a frozen copy of the dataclass), built
here from one crystal's arrays with no padding (``graph_from_crystal``).

Conventions: ``edge_index[0]`` is the source, ``edge_index[1]`` the
destination, edge vector = pos[dst] + nbr_shift - pos[src].
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Graph:
    z: torch.Tensor            # (N,) int64 atomic numbers (0 = pad)
    pos: torch.Tensor          # (N, 3)
    node_mask: torch.Tensor    # (N,) bool
    batch: torch.Tensor        # (N,) int64 crystal id per node
    edge_index: torch.Tensor   # (2, E) int64
    edge_mask: torch.Tensor    # (E,) bool
    nbr_shift: torch.Tensor    # (E, 3) Cartesian PBC shift of dst
    cell_shift: torch.Tensor   # (E, 3) int64
    inv_edge_idx: torch.Tensor  # (E,) int64, batch-global inverse edge ids
    cell: torch.Tensor         # (B, 3, 3)
    node_counts: torch.Tensor  # (B,) int64
    edge_counts: torch.Tensor  # (B,) int64
    doping_charge: Optional[torch.Tensor] = None  # (B,)
    spin_vec: Optional[torch.Tensor] = None
    spin_length: Optional[torch.Tensor] = None
    edge_group_tar: Optional[torch.Tensor] = None
    Hon: Optional[torch.Tensor] = None
    Hoff: Optional[torch.Tensor] = None
    Hon0: Optional[torch.Tensor] = None
    Hoff0: Optional[torch.Tensor] = None
    iHon: Optional[torch.Tensor] = None
    iHoff: Optional[torch.Tensor] = None
    iHon0: Optional[torch.Tensor] = None
    iHoff0: Optional[torch.Tensor] = None
    Son: Optional[torch.Tensor] = None
    Soff: Optional[torch.Tensor] = None
    Lon: Optional[torch.Tensor] = None
    Loff: Optional[torch.Tensor] = None
    dSon: Optional[torch.Tensor] = None
    dSoff: Optional[torch.Tensor] = None

    @property
    def num_nodes(self) -> int:
        return self.z.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edge_index.shape[1]

    @property
    def num_graphs(self) -> int:
        return self.cell.shape[0]

    def edge_vectors(self):
        src, dst = self.edge_index[0], self.edge_index[1]
        return (self.pos[dst] + self.nbr_shift) - self.pos[src]


_TARGETS = ("Hon", "Hoff", "Hon0", "Hoff0", "iHon", "iHoff", "iHon0", "iHoff0",
            "Son", "Soff", "Lon", "Loff")


def graph_from_crystal(c: Dict[str, np.ndarray], device, dtype=torch.float32) -> Graph:
    """One crystal's arrays (the generator's field names) as an unpadded
    ``Graph`` on ``device``: every node and edge real, floats in ``dtype``."""
    n, e = int(c["z"].shape[0]), int(c["edge_index"].shape[1])

    def f(a):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    def i(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    cell = np.asarray(c["cell"]).reshape(1, 3, 3)
    return Graph(
        z=i(c["z"]), pos=f(c["pos"]), node_mask=torch.ones(n, dtype=torch.bool, device=device),
        batch=torch.zeros(n, dtype=torch.long, device=device), edge_index=i(c["edge_index"]),
        edge_mask=torch.ones(e, dtype=torch.bool, device=device), nbr_shift=f(c["nbr_shift"]),
        cell_shift=i(c["cell_shift"]), inv_edge_idx=i(c["inv_edge_idx"]), cell=f(cell),
        node_counts=i([n]), edge_counts=i([e]),
        **{k: f(c[k]) for k in _TARGETS if k in c})
