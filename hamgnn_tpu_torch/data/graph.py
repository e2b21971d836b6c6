"""Padded crystal-graph batch, counterpart of ``hamgnn_tpu/data/graph.py``.

A batch of crystals is flattened into one graph padded to bucket sizes, with
masks, batch-global inverse-edge indices and per-crystal data stacked along a
batch axis.  Conventions as in the reference: ``edge_index[0]`` is the source,
``edge_index[1]`` the destination, edge vector = pos[dst] + nbr_shift -
pos[src]; padded nodes have z = 0 and padded edges point 0 -> 0 with mask 0.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

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


_TARGET_FIELDS = (
    "Hon", "Hoff", "Hon0", "Hoff0", "iHon", "iHoff", "iHon0", "iHoff0",
    "Son", "Soff", "Lon", "Loff", "dSon", "dSoff",
)
_NODE_FIELDS = {"Hon", "Hon0", "iHon", "iHon0", "Son", "Lon", "dSon"}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_and_batch(crystals: Sequence[Dict[str, np.ndarray]],
                  node_bucket: Optional[int] = None,
                  edge_bucket: Optional[int] = None,
                  bucket_multiple: int = 32, dtype=np.float32,
                  device="cpu") -> Graph:
    """Pack per-crystal numpy dicts (reference field names) into one padded
    :class:`Graph` on ``device``; same padding as the reference's."""
    n_tot = sum(int(c["z"].shape[0]) for c in crystals)
    e_tot = sum(int(c["edge_index"].shape[1]) for c in crystals)
    N = node_bucket or _round_up(max(n_tot, 1), bucket_multiple)
    E = edge_bucket or _round_up(max(e_tot, 1), bucket_multiple)
    if N < n_tot or E < e_tot:
        raise ValueError(f"bucket too small: need ({n_tot},{e_tot}), got ({N},{E})")
    B = len(crystals)

    z = np.zeros(N, np.int64)
    pos = np.zeros((N, 3), dtype)
    node_mask = np.zeros(N, bool)
    batch = np.zeros(N, np.int64)
    edge_index = np.zeros((2, E), np.int64)
    edge_mask = np.zeros(E, bool)
    nbr_shift = np.zeros((E, 3), dtype)
    cell_shift = np.zeros((E, 3), np.int64)
    inv_edge = np.zeros(E, np.int64)
    cell = np.zeros((B, 3, 3), dtype)
    node_counts = np.zeros(B, np.int64)
    edge_counts = np.zeros(B, np.int64)
    doping = np.zeros(B, dtype)

    targets: Dict[str, List[np.ndarray]] = {
        k: [] for k in _TARGET_FIELDS if all(k in c for c in crystals)}
    has_spin = all("spin_vec" in c for c in crystals)
    spin_vec = np.zeros((N, 3), dtype) if has_spin else None
    spin_length = np.zeros(N, dtype) if has_spin else None

    n_ofs = e_ofs = 0
    for b, c in enumerate(crystals):
        n = int(c["z"].shape[0])
        e = int(c["edge_index"].shape[1])
        z[n_ofs : n_ofs + n] = c["z"]
        pos[n_ofs : n_ofs + n] = c["pos"]
        node_mask[n_ofs : n_ofs + n] = True
        batch[n_ofs : n_ofs + n] = b
        edge_index[:, e_ofs : e_ofs + e] = np.asarray(c["edge_index"]) + n_ofs
        edge_mask[e_ofs : e_ofs + e] = True
        nbr_shift[e_ofs : e_ofs + e] = c["nbr_shift"]
        if "cell_shift" in c:
            cell_shift[e_ofs : e_ofs + e] = c["cell_shift"]
        inv_edge[e_ofs : e_ofs + e] = np.asarray(c["inv_edge_idx"]) + e_ofs
        cc = np.asarray(c["cell"], dtype)
        cell[b] = cc.reshape(3, 3) if cc.size == 9 else cc[0]
        node_counts[b] = n
        edge_counts[b] = e
        if "doping_charge" in c:
            doping[b] = np.asarray(c["doping_charge"]).reshape(-1)[0]
        if has_spin:
            sv = np.asarray(c["spin_vec"], dtype)
            spin_vec[n_ofs : n_ofs + n] = sv
            spin_length[n_ofs : n_ofs + n] = (
                np.asarray(c["spin_length"], dtype) if "spin_length" in c
                else np.linalg.norm(sv, axis=-1))
        for k in targets:
            targets[k].append(np.asarray(c[k], dtype))
        n_ofs += n
        e_ofs += e

    # segment id per edge over unique (dst, cell_shift) pairs
    group_key = {}
    edge_group = np.zeros(E, np.int64)
    for e2 in range(E):
        key = (int(edge_index[1, e2]), tuple(int(v) for v in cell_shift[e2]))
        edge_group[e2] = group_key.setdefault(key, len(group_key))

    def t(a):
        return None if a is None else torch.as_tensor(a, device=device)

    packed = {}
    for k, rows in targets.items():
        arr = np.zeros((N if k in _NODE_FIELDS else E, *rows[0].shape[1:]), dtype)
        arr[: sum(r.shape[0] for r in rows)] = np.concatenate(rows, axis=0)
        packed[k] = t(arr)

    graph = Graph(
        z=t(z), pos=t(pos), node_mask=t(node_mask), batch=t(batch),
        edge_index=t(edge_index), edge_mask=t(edge_mask), nbr_shift=t(nbr_shift),
        cell_shift=t(cell_shift), inv_edge_idx=t(inv_edge), cell=t(cell),
        node_counts=t(node_counts), edge_counts=t(edge_counts),
        doping_charge=t(doping), spin_vec=t(spin_vec), spin_length=t(spin_length),
        edge_group_tar=t(edge_group), **packed)
    # the cells as collated, not a field: host code that needs them (the
    # trainer's k-points) reads them here instead of waiting for the device
    graph.cell_host = cell
    return graph
