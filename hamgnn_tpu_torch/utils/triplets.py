"""k->j->i triplet enumeration over a periodic crystal graph, counterpart of
``hamgnn_tpu/utils/triplets.py`` (numpy, host-side data preparation).

The reference builds a torch_sparse ``SparseTensor`` adjacency and repeats
rows; here plain numpy sorting does the same job.

Geometry convention (as in the reference's docstring):
  idx_i -> pos[idx_i]
  idx_j -> pos[idx_j] - nbr_shift[idx_ji]
  idx_k -> pos[idx_k] - nbr_shift[idx_ji] - nbr_shift[idx_kj]

Triplets with ``i == k`` and zero relative cell shift (the edge paired with
its own inverse) are removed, as in the reference.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def triplets(edge_index: np.ndarray, num_nodes: int,
             cell_shift: np.ndarray) -> Tuple[np.ndarray, ...]:
    """Enumerate k->j->i paths: for every edge (j->i), all edges (k->j).

    Args:
      edge_index: (2, E) int array, row 0 = j (source), row 1 = i (target).
      num_nodes: node count (unused, kept for reference signature parity).
      cell_shift: (E, 3) integer periodic-image shifts per edge.

    Returns (col, row, idx_i, idx_j, idx_k, idx_kj, idx_ji) exactly as the
    reference: per-triplet node ids and the edge ids of the (k->j) and (j->i)
    legs.
    """
    edge_index = np.asarray(edge_index)
    cell_shift = np.asarray(cell_shift)
    row, col = edge_index[0], edge_index[1]  # j -> i
    E = row.shape[0]

    # incoming edges per node: edges (k->j) grouped by their target (col) j
    order = np.argsort(col, kind="stable")
    grouped_tgt = col[order]
    # for each edge e=(j->i): all edges whose target == row[e] (= j)
    starts = np.searchsorted(grouped_tgt, row, side="left")
    ends = np.searchsorted(grouped_tgt, row, side="right")
    counts = ends - starts

    idx_ji = np.repeat(np.arange(E), counts)
    # per-triplet position inside its group
    offs = np.concatenate([np.arange(c) for c in counts]) if E else np.zeros(0, int)
    idx_kj = order[np.repeat(starts, counts) + offs]

    idx_i = col[idx_ji]
    idx_j = row[idx_ji]
    idx_k = row[idx_kj]

    rel_shift = cell_shift[idx_kj] + cell_shift[idx_ji]
    mask = (idx_i != idx_k) | np.any(rel_shift != 0, axis=-1)
    return (col, row, idx_i[mask], idx_j[mask], idx_k[mask],
            idx_kj[mask], idx_ji[mask])
