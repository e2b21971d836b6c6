"""Process groups and the data-parallel step, counterpart of
``hamgnn_tpu/parallel/sharding.py``.

The JAX package lays its devices out as a ``Mesh(('data', 'graph'))``.  Here
the mesh is two sets of ``torch.distributed`` process groups over the world:
rank r is data row ``r // n_graph`` and graph column ``r % n_graph``; the
ranks of one data row (its graph group) share one crystal and run the halo
collectives, the ranks of one graph column (its data group) hold different
crystals.  Every rank creates every group, in the same order, as
``torch.distributed.new_group`` requires.

``make_parallel_train_step`` is the data-parallel step on whole crystals:
each rank runs the one-device forward on its own crystal, and the loss is
the mean of the per-crystal losses over the data rows (what the JAX ``vmap``
gives, not the masked mean of one stacked batch).

The multi-device trainers capture their steps as CUDA graphs on the card
under an NCCL group (``capture_default``), as the JAX package jits them: no
step reads the host, and the learning rate is the trainer's device tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..data.graph import Graph


@dataclasses.dataclass
class Mesh:
    n_data: int
    n_graph: int
    rank: int
    graph_group: Any    # this rank's data row: the ranks sharing its crystal
    data_group: Any     # this rank's graph column

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_graph

    @property
    def graph_rank(self) -> int:
        return self.rank % self.n_graph

    @property
    def size(self) -> int:
        return self.n_data * self.n_graph


def make_mesh(n_data: int, n_graph: int) -> Mesh:
    """The (n_data, n_graph) layout of the initialised world."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed process group "
                           "(parallel.multihost.maybe_initialize_distributed)")
    world = dist.get_world_size()
    if world != n_data * n_graph:
        raise ValueError(f"mesh {n_data} x {n_graph} needs {n_data * n_graph} ranks, "
                         f"the world has {world}")
    rank = dist.get_rank()
    graph_group = data_group = None
    for d in range(n_data):
        g = dist.new_group([d * n_graph + c for c in range(n_graph)])
        if d == rank // n_graph:
            graph_group = g
    for c in range(n_graph):
        g = dist.new_group([d * n_graph + c for d in range(n_data)])
        if c == rank % n_graph:
            data_group = g
    return Mesh(n_data, n_graph, rank, graph_group, data_group)


def capture_default(capture: Optional[bool], device: torch.device) -> bool:
    """Whether a multi-device trainer replays its steps from CUDA graphs.
    By default on the card under an NCCL process group.  The CPU has no
    graphs, and a gloo collective is host code that no graph can hold, so
    both run the steps eagerly (a stated rule, not a fallback: ``capture=
    True`` there raises ``ValueError``)."""
    backend = dist.get_backend()
    if capture is None:
        return device.type == "cuda" and backend == "nccl"
    if capture and device.type != "cuda":
        raise ValueError(f"a captured step needs the card, not {device}")
    if capture and backend != "nccl":
        raise ValueError(f"a captured step with collectives needs an NCCL process group, "
                         f"not {backend}")
    return bool(capture)


def mean_over_data(mesh: Mesh, values: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The means over the data rows of per-crystal scalars that every rank
    of a graph group holds alike.  One sum over the world, to which only
    graph column 0 contributes: every rank gets the same bits."""
    v = torch.stack(list(values)).detach()
    v = v * float(mesh.graph_rank == 0)
    dist.all_reduce(v)
    return list((v / mesh.n_data).unbind(0))


def reduce_gradient(mesh: Mesh, grad: torch.Tensor) -> None:
    """Sum the ranks' flat gradients and divide by the data rows, in place:
    the graph group's partial gradients add up to each crystal's, and the
    data rows are averaged."""
    dist.all_reduce(grad)
    grad.div_(mesh.n_data)


def stack_graphs(graphs: Sequence[Graph]) -> Graph:
    """Same-shape padded Graphs stacked along a new leading axis."""
    fields = {}
    for f in dataclasses.fields(Graph):
        vals = [getattr(g, f.name) for g in graphs]
        fields[f.name] = None if vals[0] is None else torch.stack(vals)
    return Graph(**fields)


def replicate_to_mesh(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
    """Rank 0's values of ``tensors`` on every rank (a broadcast in place)."""
    for t in tensors:
        dist.broadcast(t, src=0)
    return tensors


def init_flat_opt_state(flat: torch.Tensor, gradient_clip_val: float = 0.0):
    """The amsgrad state over the flat parameter vector (``train/optim.py``)."""
    from ..train.optim import Amsgrad

    return Amsgrad(flat.numel(), flat.device, gradient_clip_val)


def _losses(model, graph, losses):
    from ..models.model import compute_losses

    return compute_losses(model(graph), graph, losses)


def make_parallel_train_step(model, opt, losses: List[Dict[str, Any]], mesh: Mesh,
                             flat: torch.Tensor, grad: torch.Tensor):
    """``step(graph, lr) -> (mean loss, mean logs)``: ``graph`` is this rank's
    crystal, ``lr`` the trainer's 0-dim float32 device tensor ``lr_t`` (a
    captured step reads it at every replay); the gradient is the mean over
    the data rows of the crystals' gradients (ranks of one graph group hold
    the same crystal and count it once)."""

    def step(graph, lr):
        grad.zero_()
        total, logs = _losses(model, graph, losses)
        total.backward()
        dist.all_reduce(grad)
        grad.div_(mesh.size)
        keys = list(logs)
        means = mean_over_data(mesh, [total.detach()] + [logs[k].detach() for k in keys])
        ok = opt.step(flat, grad, lr, loss=means[0])
        out = dict(zip(keys, means[1:]))
        out["nonfinite_step"] = 1.0 - ok.to(torch.float32)
        return means[0], out

    return step


def make_parallel_eval_step(model, losses: List[Dict[str, Any]], mesh: Mesh):
    def step(graph):
        with torch.inference_mode():
            total, logs = _losses(model, graph, losses)
            keys = list(logs)
            means = mean_over_data(mesh, [total] + [logs[k] for k in keys])
        return means[0], dict(zip(keys, means[1:]))

    return step
