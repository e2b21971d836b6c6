"""The halo edge partition, counterpart of ``hamgnn_tpu/parallel/halo.py``.

A crystal's nodes are split into S contiguous blocks, one per rank of its
graph group; every edge lives on the rank that owns its destination, so the
message aggregation is local.  The only node traffic is one all-to-all per
gather of remote source rows: rank s receives exactly the rows its edges
reference, padded to a common bucket H, in the order the plan fixes
(``EdgePartitionPlan``).  The plan is numpy, built once per crystal topology;
the collectives are ``torch.distributed`` calls over the graph group, each
wrapped in an autograd function whose backward is the matching collective
(an all-to-all's is the reverse all-to-all, a sum's is a sum, a gather's is a
sum of the ranks' gradients for the owner's block).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def _round_up(x: int, m: int) -> int:
    return max(m, ((x + m - 1) // m) * m)


@dataclasses.dataclass(frozen=True)
class EdgePartitionPlan:
    """Pack-time (numpy) partition of a padded graph over S shards.

    Shapes: S = n_shards, N_loc = nodes per shard, E_loc = padded local edge
    count, H = halo bucket (the most rows any shard requests from a peer).
    ``src_pos`` indexes the shard's node table ``[owned rows (N_loc) | halo
    rows (S*H)]``: position ``N_loc + p*H + r`` is row r of the request list
    this shard sent to peer p.  ``send_idx[s, p]`` are the s-owned local rows
    that peer p requested.  With ``inv_edge_idx``: ``inv_pos`` indexes
    ``[local edge rows | received inverse-edge rows (S*HE)]`` and
    ``edge_send_idx`` lists the local edge rows each peer requested.
    ``boundary_pos`` lists the local rows of the edges whose source is remote
    (the boundary pass of the overlap split)."""

    n_shards: int
    n_nodes_local: int
    halo_bucket: int
    edge_id: np.ndarray      # (S, E_loc) int32 global edge ids (pad: a masked id)
    src_pos: np.ndarray      # (S, E_loc) int32 into the local node table
    dst_local: np.ndarray    # (S, E_loc) int32 owned destination row
    edge_mask: np.ndarray    # (S, E_loc) bool
    send_idx: np.ndarray     # (S, S, H) int32 owned rows to send to each peer
    edge_halo_bucket: int = 0
    inv_pos: Optional[np.ndarray] = None        # (S, E_loc) int32 into the edge table
    edge_send_idx: Optional[np.ndarray] = None  # (S, S, HE) int32 local edge rows
    boundary_bucket: int = 0
    boundary_pos: Optional[np.ndarray] = None   # (S, E_b) int32 local edge rows
    boundary_mask: Optional[np.ndarray] = None  # (S, E_b) bool

    @property
    def table_size(self) -> int:
        return self.n_nodes_local + self.n_shards * self.halo_bucket


def make_plan(edge_index: np.ndarray, edge_mask: np.ndarray, n_nodes: int,
              n_shards: int, edge_quantum: int = 64,
              inv_edge_idx: Optional[np.ndarray] = None,
              force_edge_loc: Optional[int] = None,
              force_halo: Optional[int] = None,
              force_edge_halo: Optional[int] = None,
              force_boundary: Optional[int] = None) -> EdgePartitionPlan:
    """Partition edges by destination owner and build the exchange plan.

    ``force_*`` pin the padded local-edge, halo, edge-halo and boundary
    bucket sizes, so plans of different graphs stack along a data axis (the
    table positions depend on the bucket sizes)."""
    edge_index = np.asarray(edge_index)
    edge_mask = np.asarray(edge_mask).astype(bool)
    if n_nodes % n_shards:
        raise ValueError(f"{n_nodes} nodes do not split into {n_shards} shards")
    n_loc = n_nodes // n_shards
    src, dst = edge_index[0], edge_index[1]
    owner = dst // n_loc

    per_shard_edges = [np.nonzero(edge_mask & (owner == s))[0] for s in range(n_shards)]
    e_loc = _round_up(max((len(i) for i in per_shard_edges), default=1), edge_quantum)
    if force_edge_loc is not None:
        if force_edge_loc < e_loc:
            raise ValueError(f"force_edge_loc {force_edge_loc} < {e_loc}")
        e_loc = force_edge_loc

    # request lists: for shard s and peer p != s, the unique source rows owned
    # by p that s's edges reference, sorted
    requests = [[np.zeros(0, np.int64)] * n_shards for _ in range(n_shards)]
    for s in range(n_shards):
        s_src = src[per_shard_edges[s]]
        s_owner = s_src // n_loc
        for p in range(n_shards):
            if p != s:
                requests[s][p] = np.unique(s_src[s_owner == p])
    halo = max((len(requests[s][p]) for s in range(n_shards) for p in range(n_shards)),
               default=0)
    halo = _round_up(max(halo, 1), 8)
    if force_halo is not None:
        if force_halo < halo:
            raise ValueError(f"force_halo {force_halo} < {halo}")
        halo = force_halo

    edge_id = np.zeros((n_shards, e_loc), np.int32)
    src_pos = np.zeros((n_shards, e_loc), np.int32)
    dst_local = np.zeros((n_shards, e_loc), np.int32)
    mask_out = np.zeros((n_shards, e_loc), bool)
    send_idx = np.zeros((n_shards, n_shards, halo), np.int32)
    for s in range(n_shards):
        es = per_shard_edges[s]
        ne = len(es)
        edge_id[s, :ne] = es
        dst_local[s, :ne] = dst[es] - s * n_loc
        mask_out[s, :ne] = True
        pos_of = {}
        for p in range(n_shards):
            for r, g in enumerate(requests[s][p]):
                pos_of[int(g)] = n_loc + p * halo + r
        s_src = src[es]
        s_owner = s_src // n_loc
        pos = np.empty(ne, np.int32)
        for k in range(ne):
            g = int(s_src[k])
            pos[k] = g - s * n_loc if s_owner[k] == s else pos_of[g]
        src_pos[s, :ne] = pos
    for s in range(n_shards):        # sender
        for p in range(n_shards):    # receiver
            req = requests[p][s]
            send_idx[s, p, : len(req)] = req - s * n_loc

    edge_halo = 0
    inv_pos = None
    edge_send_idx = None
    if inv_edge_idx is not None:
        inv_edge_idx = np.asarray(inv_edge_idx)
        local_row = np.zeros(edge_index.shape[1], np.int64)
        owner_of_edge = np.zeros(edge_index.shape[1], np.int64)
        for s in range(n_shards):
            es = per_shard_edges[s]
            local_row[es] = np.arange(len(es))
            owner_of_edge[es] = s
        ereq = [[np.zeros(0, np.int64)] * n_shards for _ in range(n_shards)]
        for s in range(n_shards):
            iv = inv_edge_idx[per_shard_edges[s]]
            iv_owner = owner_of_edge[iv]
            for p in range(n_shards):
                if p != s:
                    ereq[s][p] = np.unique(iv[iv_owner == p])
        edge_halo = _round_up(max((len(ereq[s][p]) for s in range(n_shards)
                                   for p in range(n_shards)), default=1), 8)
        if force_edge_halo is not None:
            if force_edge_halo < edge_halo:
                raise ValueError(f"force_edge_halo {force_edge_halo} < {edge_halo}")
            edge_halo = force_edge_halo
        inv_pos = np.zeros((n_shards, e_loc), np.int32)
        edge_send_idx = np.zeros((n_shards, n_shards, edge_halo), np.int32)
        for s in range(n_shards):
            es = per_shard_edges[s]
            pos_of = {}
            for p in range(n_shards):
                for r, g in enumerate(ereq[s][p]):
                    pos_of[int(g)] = e_loc + p * edge_halo + r
            iv = inv_edge_idx[es]
            iv_owner = owner_of_edge[iv]
            for k in range(len(es)):
                g = int(iv[k])
                inv_pos[s, k] = local_row[g] if iv_owner[k] == s else pos_of[g]
        for s in range(n_shards):
            for p in range(n_shards):
                req = ereq[p][s]
                edge_send_idx[s, p, : len(req)] = local_row[req]

    # boundary edges: local rows whose source position points into the halo
    b_counts = [int(np.sum(mask_out[s] & (src_pos[s] >= n_loc))) for s in range(n_shards)]
    e_b = _round_up(max(max(b_counts), 1), 8)
    if force_boundary is not None:
        if force_boundary < e_b:
            raise ValueError(f"force_boundary {force_boundary} < {e_b}")
        e_b = force_boundary
    boundary_pos = np.zeros((n_shards, e_b), np.int32)
    boundary_mask = np.zeros((n_shards, e_b), bool)
    for s in range(n_shards):
        rows = np.nonzero(mask_out[s] & (src_pos[s] >= n_loc))[0]
        boundary_pos[s, : len(rows)] = rows
        boundary_mask[s, : len(rows)] = True

    return EdgePartitionPlan(
        n_shards=n_shards, n_nodes_local=n_loc, halo_bucket=halo,
        edge_id=edge_id, src_pos=src_pos, dst_local=dst_local,
        edge_mask=mask_out, send_idx=send_idx,
        edge_halo_bucket=edge_halo, inv_pos=inv_pos, edge_send_idx=edge_send_idx,
        boundary_bucket=e_b, boundary_pos=boundary_pos, boundary_mask=boundary_mask)


# --- differentiable collectives over a process group ----------------------

class _AllToAll(torch.autograd.Function):
    """Block p of the rows goes to rank p; the backward sends the gradient
    blocks back the same way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _all_to_all(x, group):
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGatherRows(torch.autograd.Function):
    """The ranks' rows stacked in rank order; the backward gives each rank
    the sum over ranks of the gradient of its own block."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rows = x.shape[0]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, 0)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        r = dist.get_rank(group=ctx.group)
        return g[r * ctx.rows : (r + 1) * ctx.rows], None


def all_to_all_rows(x: torch.Tensor, group) -> torch.Tensor:
    """(S*H, ...) rows, block p to rank p of ``group``; differentiable."""
    return _AllToAll.apply(x, group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``; its backward is the same
    sum of the gradients."""
    return _AllReduceSum.apply(x, group)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """(S*n, ...) rows of every rank of ``group`` in rank order."""
    return _AllGatherRows.apply(x, group)


# --- the node exchange -----------------------------------------------------

def halo_recv_rows(local_feats: torch.Tensor, send_idx: torch.Tensor, group) -> torch.Tensor:
    """The halo rows alone, (S*H, D): one all-to-all carrying exactly the rows
    each peer requested.  Kept apart from the owned rows, so the interior
    pass does not depend on the exchange."""
    send = local_feats[send_idx.reshape(-1)]                 # (S*H, D)
    return all_to_all_rows(send, group)


def halo_gather(local_feats: torch.Tensor, send_idx: torch.Tensor, group) -> torch.Tensor:
    """The local node table ``[owned rows | halo rows]``."""
    return torch.cat([local_feats, halo_recv_rows(local_feats, send_idx, group)], 0)


def make_halo_conv_forward(conv_module, group, pair_module=None):
    """One GNN layer under the halo partition, on this rank's shard.

    Returns ``f(node_loc, edge_feats, edge_sh, edge_scalars, src_pos,
    dst_local, edge_mask, send_idx) -> (new_node_rows, new_edge_rows)``:
    ``conv_module`` a ``ConvBlockE3`` (its ``gathered_call``), ``pair_module``
    an optional ``PairInteractionBlock`` whose lift runs on owned rows before
    its exchange."""

    def fwd(node_loc, edge_feats, edge_sh, edge_scalars, src_pos, dst_local,
            edge_mask, send_idx):
        table = halo_gather(node_loc, send_idx, group)
        new_nodes = conv_module.gathered_call(
            node_loc, table[src_pos], node_loc[dst_local], edge_feats, edge_sh,
            edge_scalars, dst_local, edge_mask)
        new_edges = edge_feats
        if pair_module is not None:
            up_src, up_dst = pair_module.lift(new_nodes)
            src_table = halo_gather(up_src, send_idx, group)
            new_edges = pair_module.gathered_call(
                src_table[src_pos], up_dst[dst_local], edge_feats, edge_sh, edge_scalars)
        return new_nodes, new_edges

    return fwd


def gather_edge_arrays(plan: EdgePartitionPlan, *edge_arrays):
    """Global (E, ...) per-edge arrays -> (S, E_loc, ...) in the plan's order
    (numpy arrays or tensors).  Padded local slots read a masked edge; the
    layer's edge mask kills their contributions."""
    out = []
    for a in edge_arrays:
        if isinstance(a, torch.Tensor):
            out.append(a[torch.as_tensor(plan.edge_id, dtype=torch.long, device=a.device)])
        else:
            out.append(np.asarray(a)[plan.edge_id])
    return tuple(out)


def scatter_back_nodes(plan: EdgePartitionPlan, node_feats_sharded, n_nodes: int):
    """(S*N_loc, D) owned-major node rows are in the global node order
    already (the ownership blocks are contiguous)."""
    if node_feats_sharded.shape[0] != n_nodes:
        raise ValueError(f"{node_feats_sharded.shape[0]} rows, expected {n_nodes}")
    return node_feats_sharded


def scatter_back_edges(plan: EdgePartitionPlan, edge_feats_sharded, n_edges: int):
    """(S, E_loc, D) per-shard edge rows -> (E, D) in the global edge order
    (padded global edges stay zero)."""
    ef = torch.as_tensor(edge_feats_sharded)
    ef = ef.reshape(-1, ef.shape[-1])
    flat_mask = torch.as_tensor(plan.edge_mask.reshape(-1), device=ef.device)
    flat_id = torch.as_tensor(plan.edge_id.reshape(-1), dtype=torch.long, device=ef.device)
    out = ef.new_zeros((n_edges, ef.shape[-1]))
    out[flat_id[flat_mask]] = ef[flat_mask]
    return out
