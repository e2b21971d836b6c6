"""Whole-model training under the halo edge partition, counterpart of
``hamgnn_tpu/parallel/halo_model.py``.

The model forward is not written again here: the representation networks and
the heads speak ``GraphView`` (``models/view.py``).  This module

* packs a padded Graph into per-shard halo inputs (host numpy, once a batch;
  each rank slices out its own shard, ``local_inputs``);
* builds the rank's ``GraphView`` whose hooks are the collectives over its
  graph group (``halo_view``): an all-to-all of the requested source rows, an
  all-to-all of the inverse-edge rows for the Hermitian symmetrisation, a
  differentiable sum for the global reductions, and a gather of the block rows
  in the global order for the band solve;
* and runs ``model.forward_view`` and the loss on it.

The gradient: every ``psum`` is a differentiable sum, so each rank's backward
of ``loss / S`` (S ranks hold the same replicated loss) gives its own
contributions to the parameter gradient; one sum of the flat gradient over
the world, divided by the number of data rows, is then the mean over the
step's crystals of the one-device gradient (``reduce_gradient``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..data.graph import Graph
from ..models.view import GraphView
from .halo import (EdgePartitionPlan, all_gather_rows, all_to_all_rows, halo_gather,
                   halo_recv_rows, make_plan, psum)
from .sharding import Mesh, mean_over_data, reduce_gradient

_NODE_TARGETS = ("Hon", "Son", "Hon0", "iHon", "iHon0", "Lon", "spin_vec", "spin_length")
_EDGE_TARGETS = ("Hoff", "Soff", "Hoff0", "iHoff", "iHoff0", "Loff")
# inputs with the global node axis (every other one has a leading shard axis)
NODE_KEYS = frozenset(("z", "node_mask", "doping_node") + _NODE_TARGETS)


def _np(t):
    return None if t is None else (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                                   else np.asarray(t))


def build_halo_inputs(graph: Graph, plan: EdgePartitionPlan) -> Dict[str, np.ndarray]:
    """Host pack of a padded Graph into per-shard halo inputs: node arrays
    keep their global (S*N_loc) axis (the ownership blocks are contiguous),
    per-edge arrays become (S, E_loc, ...) through the plan's edge ids."""
    if plan.inv_pos is None:
        raise ValueError("the plan must be built with inv_edge_idx")
    edge_index = _np(graph.edge_index)
    src, dst = edge_index[0], edge_index[1]
    eid = plan.edge_id
    z = _np(graph.z)

    def opt_edge(a):
        return None if a is None else _np(a)[eid]

    doping = (None if graph.doping_charge is None
              else _np(graph.doping_charge)[_np(graph.batch)])
    out = {
        "z": z,
        "node_mask": _np(graph.node_mask),
        **{k: _np(getattr(graph, k)) for k in _NODE_TARGETS},
        "doping_node": doping,
        "edge_vec": _np(graph.edge_vectors())[eid],
        "z_src": z[src][eid],
        "z_dst": z[dst][eid],
        "doping_src": None if doping is None else doping[src][eid],
        "doping_dst": None if doping is None else doping[dst][eid],
        **{k: opt_edge(getattr(graph, k)) for k in _EDGE_TARGETS},
        "src_pos": plan.src_pos,
        "dst_local": plan.dst_local,
        "edge_mask_sh": plan.edge_mask,
        "send_idx": plan.send_idx,
        "inv_pos": plan.inv_pos,
        "edge_send_idx": plan.edge_send_idx,
        "boundary_pos": plan.boundary_pos,
        "boundary_mask": plan.boundary_mask,
    }
    return {k: v for k, v in out.items() if v is not None}


def edge_unperm_for_plan(plan: EdgePartitionPlan, n_edges_global: int) -> np.ndarray:
    """(E_glob,) map: global edge row -> its position ``s*E_loc + r`` in the
    gathered per-shard edge rows.  Padded global edges point at a masked
    local row."""
    e_loc = plan.edge_id.shape[1]
    unperm = np.zeros(n_edges_global, np.int64)
    masked = np.nonzero(~plan.edge_mask.reshape(-1))[0]
    if masked.size:
        unperm[:] = masked[0]
    for s in range(plan.n_shards):
        rows = np.nonzero(plan.edge_mask[s])[0]
        unperm[plan.edge_id[s, rows]] = s * e_loc + rows
    return unperm


def edge_halo_gather(local_rows: torch.Tensor, edge_send_idx: torch.Tensor, group):
    """``[local edge rows | received inverse-edge rows]`` (one all-to-all)."""
    recv = all_to_all_rows(local_rows[edge_send_idx.reshape(-1)], group)
    return torch.cat([local_rows, recv], 0)


def local_inputs(inputs: Dict[str, np.ndarray], n_shards: int, shard: int,
                 device, data_row: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """This rank's slice of packed inputs, on ``device``: node arrays' rows of
    block ``shard``, per-shard arrays' entry ``shard``; ``data_row`` first
    picks one crystal of a stack."""
    out = {}
    for k, v in inputs.items():
        if data_row is not None:
            v = v[data_row]
        if k in NODE_KEYS:
            n_loc = v.shape[0] // n_shards
            v = v[shard * n_loc : (shard + 1) * n_loc]
        else:
            v = v[shard]
        t = torch.as_tensor(np.ascontiguousarray(v))
        if t.dtype == torch.int32:
            t = t.long()
        out[k] = t.to(device)
    return out


def halo_view(inp: Dict[str, torch.Tensor], group, band_graph: Optional[Graph] = None,
              edge_unperm: Optional[torch.Tensor] = None) -> GraphView:
    """The rank's GraphView over its local halo inputs, with the collectives
    over ``group`` (its graph group) as hooks.  A group of one rank has no
    remote source: the overlap split is left out (its boundary pass would
    run on padding alone), and the step launches what the one-device step
    does."""
    src_pos, dst_local = inp["src_pos"], inp["dst_local"]
    send_idx, inv_pos, edge_send_idx = inp["send_idx"], inp["inv_pos"], inp["edge_send_idx"]
    n_loc = inp["z"].shape[0]
    overlap = {}
    if dist.get_world_size(group) > 1:
        boundary_pos = inp["boundary_pos"]
        is_interior = src_pos < n_loc
        src_pos_int = torch.where(is_interior, src_pos, torch.zeros_like(src_pos))
        overlap = dict(
            gather_src_interior=lambda rows: rows[src_pos_int],
            halo_rows=lambda rows: halo_recv_rows(rows, send_idx, group),
            interior_mask=inp["edge_mask_sh"] & is_interior,
            boundary_pos=boundary_pos, boundary_mask=inp["boundary_mask"],
            src_halo_pos=torch.clamp(src_pos[boundary_pos] - n_loc, min=0))

    def gather_edges_global(rows):
        return all_gather_rows(rows, group)[edge_unperm]

    kw: Dict[str, Any] = {k: inp[k] for k in _NODE_TARGETS + _EDGE_TARGETS if k in inp}
    return GraphView(
        z=inp["z"], node_mask=inp["node_mask"], num_nodes=n_loc,
        edge_vec=inp["edge_vec"], edge_mask=inp["edge_mask_sh"],
        z_src=inp["z_src"], z_dst=inp["z_dst"], dst_index=dst_local,
        gather_src=lambda rows: halo_gather(rows, send_idx, group)[src_pos],
        gather_dst=lambda rows: rows[dst_local],
        inv_exchange=lambda rows: edge_halo_gather(rows, edge_send_idx, group)[inv_pos],
        psum=lambda x: psum(x, group),
        gather_nodes_global=lambda rows: all_gather_rows(rows, group),
        gather_edges_global=(gather_edges_global if edge_unperm is not None
                             else (lambda rows: rows)),
        doping_own=inp.get("doping_node"), doping_src=inp.get("doping_src"),
        doping_dst=inp.get("doping_dst"), graph=band_graph, **overlap, **kw)


def make_halo_loss_fn(model, mesh: Mesh, losses: Optional[Sequence[Dict[str, Any]]] = None,
                      metrics: Sequence[Dict[str, Any]] = (), with_band: bool = False):
    """``loss_fn(inp, band_graph=None, k_vecs=None, edge_unperm=None) ->
    (loss, logs, metrics)`` of this rank's crystal, the same on every rank of
    its graph group.  ``with_band``: the whole-crystal Graph, k-points and the
    edge unpermutation come along for the band solve (one crystal a step,
    ``n_data`` 1)."""
    from ..models.model import compute_losses, compute_metrics

    losses = losses or [{"metric": "mae", "prediction": "hamiltonian",
                         "target": "hamiltonian", "loss_weight": 27.211}]
    if with_band and mesh.n_data != 1:
        raise ValueError("halo band losses train one crystal a step (n_data 1)")

    def loss_fn(inp, band_graph=None, k_vecs=None, edge_unperm=None):
        view = halo_view(inp, mesh.graph_group, band_graph=band_graph,
                         edge_unperm=edge_unperm)
        preds = model.forward_view(view, k_vecs=k_vecs)
        total, logs = compute_losses(preds, view, losses, psum=view.psum)
        mets = compute_metrics(preds, view, metrics, psum=view.psum) if metrics else {}
        return total, logs, mets

    return loss_fn


def make_halo_train_step(model, opt, losses, mesh: Mesh, flat: torch.Tensor,
                         grad: torch.Tensor, with_band: bool = False):
    """An eager data-parallel x halo train step over the flat-vector amsgrad
    (``train/optim.py``): ``step(inp, lr, band_graph=None, k_vecs=None,
    edge_unperm=None) -> (mean loss, mean logs)``, the means over the data
    rows, the same on every rank; ``logs["nonfinite_step"]`` is 1.0 where the
    guard dropped the step (on every rank alike)."""
    loss_fn = make_halo_loss_fn(model, mesh, losses, with_band=with_band)

    def step(inp, lr, band_graph=None, k_vecs=None, edge_unperm=None):
        grad.zero_()
        total, logs, _ = loss_fn(inp, band_graph, k_vecs, edge_unperm)
        (total / mesh.n_graph).backward()
        reduce_gradient(mesh, grad)
        keys = list(logs)
        means = mean_over_data(mesh, [total.detach()] + [logs[k].detach() for k in keys])
        ok = opt.step(flat, grad, lr, loss=means[0])
        out = dict(zip(keys, means[1:]))
        out["nonfinite_step"] = 1.0 - ok.to(torch.float32)
        return means[0], out

    return step


def plan_for_graph(graph: Graph, n_shards: int, edge_quantum: int = 64,
                   **force) -> EdgePartitionPlan:
    """The halo plan, with the inverse-edge exchange, of a padded graph."""
    return make_plan(_np(graph.edge_index), _np(graph.edge_mask), graph.num_nodes,
                     n_shards, edge_quantum=edge_quantum,
                     inv_edge_idx=_np(graph.inv_edge_idx), **force)


def halo_bucket_sizes(graphs: Sequence[Graph], n_shards: int,
                      edge_quantum: int = 64) -> Tuple[int, int, int, int]:
    """(edge_loc, halo, edge_halo, boundary): the largest natural plan sizes,
    so every stacked batch has one shape."""
    nat = [plan_for_graph(g, n_shards, edge_quantum) for g in graphs]
    return (max(p.edge_id.shape[1] for p in nat), max(p.halo_bucket for p in nat),
            max(p.edge_halo_bucket for p in nat), max(p.boundary_bucket for p in nat))


def stack_halo_inputs(graphs: Sequence[Graph], n_shards: int, edge_quantum: int = 64,
                      force_sizes: Optional[Tuple[int, int, int, int]] = None
                      ) -> Dict[str, np.ndarray]:
    """Pack same-bucket padded graphs for a data x halo mesh: plans at common
    bucket sizes (the dataset's ``force_sizes``, else these graphs' largest),
    inputs stacked along a leading data axis."""
    if force_sizes is None:
        force_sizes = halo_bucket_sizes(graphs, n_shards, edge_quantum)
    e_loc, halo, ehalo, e_b = force_sizes
    packed = [build_halo_inputs(g, plan_for_graph(
        g, n_shards, edge_quantum, force_edge_loc=e_loc, force_halo=halo,
        force_edge_halo=ehalo, force_boundary=e_b)) for g in graphs]
    keys = set(packed[0])
    for p in packed[1:]:
        keys &= set(p)
    return {k: np.stack([p[k] for p in packed]) for k in keys}
