"""The training and eval steps captured as CUDA graphs: the counterpart of
the JAX trainer's jitted steps (``hamgnn_tpu/train/trainer.py:185-248``).

JAX compiles the forward, the loss, the gradient, the non-finite guard and
the amsgrad update into one XLA program per batch shape (``_shape_key``:
nodes, edges, graphs), and the eval forward, losses and metrics into
another.  Here each is one ``torch.cuda.CUDAGraph`` per shape key, which a
step replays: the host launches one graph instead of the step's kernels.

- A batch is copied into static buffers of its key, one for every tensor
  field of ``Graph``, shared by the key's training and eval graphs.  The
  loss and logs a step returns are clones: the next replay overwrites the
  graph's outputs.  An eval step's predictions are the graph's own outputs,
  valid until the next replay.
- The parameters, their gradients and the optimizer state are the trainer's
  flat buffers, which a replay updates in place, as JAX donates them.  The
  learning rate is the trainer's 0-dim device tensor, refilled outside the
  graph when the scheduler changes it.
- Before a capture, a warm-up step on the capture's side stream does every
  first use: the kernel libraries load, their index tables and the zonal
  tables are made, cuBLAS takes its workspace.  The parameters and optimizer
  state are saved before it and put back after it, so a capture changes
  nothing.  The zonal engine's Wigner-D memo is cleared before the capture,
  so that the frames' build is recorded in the graph and runs in every
  replay.
- All graphs of a trainer share one memory pool; each replay's outputs are
  cloned or read before another graph replays.
- Every trainer on a device warms up and captures on one side stream of
  that device (``capture_stream``).  cuBLAS keeps a workspace for each
  stream it has run on, for the life of the process: a new stream per
  trainer left one more workspace held after each trainer was gone.
- The cyclic garbage collector is off during a capture (``torch.cuda.graph``
  collects just before it): an earlier trainer's graph destroyed by a
  collection in the middle of a capture calls the runtime while the stream
  is capturing, which invalidates the capture.

A capture that fails raises: nothing falls back to the eager step.  The
kernels' launch counters are host-side, so they count the warm-up and the
capture (one pass through each wrapper each), not the replays; a replay's
launches show in a profiler trace.
"""

from __future__ import annotations

import dataclasses
import gc
from typing import Callable, Dict, Tuple

import torch

from ..data.graph import Graph
from ..e3 import zonal_tp


def shape_key(graph: Graph) -> Tuple[int, int, int]:
    """(nodes, edges, graphs), the JAX trainer's ``_shape_key``."""
    return (graph.num_nodes, graph.num_edges, graph.num_graphs)


def tensor_fields(graph: Graph) -> Dict[str, torch.Tensor]:
    """Every tensor field of ``graph`` by name (the fields that are None are
    left out)."""
    return {f.name: getattr(graph, f.name) for f in dataclasses.fields(graph)
            if isinstance(getattr(graph, f.name), torch.Tensor)}


def _signature(graph: Graph) -> tuple:
    return tuple((n, tuple(t.shape), t.dtype, t.device) for n, t in tensor_fields(graph).items())


def static_graph(graph: Graph) -> Graph:
    """A ``Graph`` of new buffers holding a copy of ``graph``'s tensors."""
    with torch.inference_mode(False):
        return dataclasses.replace(graph, **{n: t.clone(memory_format=torch.contiguous_format)
                                             for n, t in tensor_fields(graph).items()})


def copy_into(static: Graph, graph: Graph) -> None:
    """Copy ``graph``'s tensors into the buffers of ``static``; raises unless
    the two have the same tensor fields of the same shapes, types and
    device."""
    if _signature(static) != _signature(graph):
        raise ValueError(f"batch of shape key {shape_key(graph)} has other fields than the "
                         f"captured one: {_signature(graph)} vs {_signature(static)}")
    for name, t in tensor_fields(graph).items():
        getattr(static, name).copy_(t)


_CAPTURE_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream on which every capture on ``device`` warms up and is
    recorded, made at its first use."""
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device=device)
    return _CAPTURE_STREAMS[device]


@dataclasses.dataclass
class _Captured:
    graph: torch.cuda.CUDAGraph
    out: tuple


class CapturedSteps:
    """The captured training and eval steps of one trainer.

    ``train_body(graph)`` is the trainer's step (gradient zeroed, forward,
    loss, backward, guarded update at the device learning rate; returns
    (loss, logs)); ``eval_body(graph)`` its eval step ((loss, logs, metrics,
    predictions)), run under ``torch.inference_mode``; ``state()`` the
    tensors a training step updates in place.  ``captures`` counts the
    graphs captured."""

    def __init__(self, device, train_body: Callable, eval_body: Callable,
                 state: Callable):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if self.device.type != "cuda":
            raise ValueError(f"a captured step runs on the card, not {self.device}")
        self.train_body, self.eval_body, self.state = train_body, eval_body, state
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = capture_stream(self.device)
        self.static: Dict[tuple, Graph] = {}
        self.train_graphs: Dict[tuple, _Captured] = {}
        self.eval_graphs: Dict[tuple, _Captured] = {}
        self.captures = 0

    def _static_for(self, graph: Graph) -> Graph:
        key = shape_key(graph)
        if key not in self.static:
            self.static[key] = static_graph(graph)
        static = self.static[key]
        copy_into(static, graph)
        return static

    def _capture(self, body: Callable, static: Graph, inference: bool) -> _Captured:
        cur = torch.cuda.current_stream(self.device)
        saved = None if inference else [t.clone() for t in self.state()]
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream), torch.inference_mode(inference):
            body(static)
        cur.wait_stream(self.stream)
        if saved is not None:
            with torch.no_grad():
                for t, s in zip(self.state(), saved):
                    t.copy_(s)
        del saved
        zonal_tp.FRAME_MEMO.clear()
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        try:
            with torch.inference_mode(inference), \
                    torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                gc.disable()
                out = body(static)
        finally:
            if collecting:
                gc.enable()
        self.captures += 1
        return _Captured(graph, out)

    def train_step(self, graph: Graph):
        """One replayed training step on ``graph`` (captured at the first
        batch of its shape key): (loss, logs), clones of the graph's."""
        static = self._static_for(graph)
        key = shape_key(graph)
        if key not in self.train_graphs:
            self.train_graphs[key] = self._capture(self.train_body, static, inference=False)
        entry = self.train_graphs[key]
        entry.graph.replay()
        loss, logs = entry.out
        return loss.clone(), {k: v.clone() for k, v in logs.items()}

    def eval_step(self, graph: Graph):
        """One replayed eval step on ``graph``: (loss, logs, metrics) as
        clones, and the predictions as the graph's own outputs."""
        static = self._static_for(graph)
        key = shape_key(graph)
        if key not in self.eval_graphs:
            self.eval_graphs[key] = self._capture(self.eval_body, static, inference=True)
        entry = self.eval_graphs[key]
        entry.graph.replay()
        total, logs, mets, preds = entry.out
        return (total.clone(), {k: v.clone() for k, v in logs.items()},
                {k: v.clone() for k, v in mets.items()}, preds)
