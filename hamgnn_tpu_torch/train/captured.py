"""The training and eval steps captured as CUDA graphs: the counterpart of
the JAX trainer's jitted steps (``hamgnn_tpu/train/trainer.py:185-248``).

JAX compiles the forward, the loss, the gradient, the non-finite guard and
the amsgrad update into one XLA program per batch shape (``_shape_key``:
nodes, edges, graphs), and the eval forward, losses and metrics into
another.  Here each is one ``torch.cuda.CUDAGraph`` per shape key, which a
step replays: the host launches one graph instead of the step's kernels.

- A batch is copied into static buffers of its key, one for every tensor
  field of ``Graph`` and one for every input the step takes besides it (the
  k-points of a head with bands, made on the host outside the graph),
  shared by the key's training and eval graphs.  The loss and logs a step
  returns are clones: the next replay overwrites the graph's outputs.  An
  eval step's predictions are the graph's own outputs, valid until the next
  replay.
- Work that a graph cannot hold runs between graphs: the Hermitian
  eigensolve of the band branch, which waits for the card inside its call.
  Each step is captured through ``utils.cuda_graphs.segmented_capture``, so
  a step that hands such work to ``host_step`` becomes one graph before
  each such call and one after the last, and a replay runs the graphs and,
  between them, the calls, in the order of the capture.
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
- The cyclic garbage collector runs just before a capture and is off
  during it: an earlier trainer's graph destroyed by a collection in the
  middle of a capture calls the runtime while the stream is capturing,
  which invalidates the capture.

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
from ..utils.cuda_graphs import Segments, segmented_capture


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


def _input_signature(inputs: Dict[str, torch.Tensor]) -> tuple:
    return tuple((n, tuple(t.shape), t.dtype, t.device) for n, t in sorted(inputs.items()))


def copy_inputs(static: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor]) -> None:
    """Copy a step's inputs besides the batch into the buffers of
    ``static``; raises unless the two have the same names, shapes, types and
    device."""
    if _input_signature(static) != _input_signature(inputs):
        raise ValueError(f"step inputs {_input_signature(inputs)} differ from the captured "
                         f"ones {_input_signature(static)}")
    for name, t in inputs.items():
        static[name].copy_(t)


_CAPTURE_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream on which every capture on ``device`` warms up and is
    recorded, made at its first use."""
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device=device)
    return _CAPTURE_STREAMS[device]


@dataclasses.dataclass
class _Captured:
    graph: Segments
    out: tuple


class CapturedSteps:
    """The captured training and eval steps of one trainer.

    ``train_body(graph, **inputs)`` is the trainer's step (gradient zeroed,
    forward, loss, backward, guarded update at the device learning rate;
    returns (loss, logs)); ``eval_body(graph, **inputs)`` its eval step
    ((loss, logs, metrics, predictions)), run under
    ``torch.inference_mode``; ``inputs`` are the tensors a step takes
    besides the batch (``k_vecs``), static buffers of the shape key like the
    batch's; ``state()`` the tensors a training step updates in place.
    ``captures`` counts the graphs captured."""

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
        self.static: Dict[tuple, Tuple[Graph, Dict[str, torch.Tensor]]] = {}
        self.train_graphs: Dict[tuple, _Captured] = {}
        self.eval_graphs: Dict[tuple, _Captured] = {}
        self.captures = 0

    def _static_for(self, graph: Graph, inputs: Dict[str, torch.Tensor]):
        key = shape_key(graph)
        if key not in self.static:
            with torch.inference_mode(False):
                self.static[key] = (static_graph(graph),
                                    {n: t.clone() for n, t in inputs.items()})
        static, static_inputs = self.static[key]
        copy_into(static, graph)
        copy_inputs(static_inputs, inputs)
        return static, static_inputs

    def _capture(self, body: Callable, static: Graph, inputs: Dict[str, torch.Tensor],
                 inference: bool) -> _Captured:
        cur = torch.cuda.current_stream(self.device)
        saved = None if inference else [t.clone() for t in self.state()]
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream), torch.inference_mode(inference):
            body(static, **inputs)
        cur.wait_stream(self.stream)
        if saved is not None:
            with torch.no_grad():
                for t, s in zip(self.state(), saved):
                    t.copy_(s)
        del saved
        zonal_tp.FRAME_MEMO.clear()
        torch.cuda.synchronize(self.device)
        gc.collect()
        torch.cuda.empty_cache()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.inference_mode(inference), torch.cuda.stream(self.stream), \
                    segmented_capture(self.pool) as segments:
                out = body(static, **inputs)
        finally:
            if collecting:
                gc.enable()
        self.captures += 1
        return _Captured(segments, out)

    def train_step(self, graph: Graph, **inputs):
        """One replayed training step on ``graph`` and ``inputs`` (captured
        at the first batch of its shape key): (loss, logs), clones of the
        graph's."""
        static, static_inputs = self._static_for(graph, inputs)
        key = shape_key(graph)
        if key not in self.train_graphs:
            self.train_graphs[key] = self._capture(self.train_body, static, static_inputs,
                                                   inference=False)
        entry = self.train_graphs[key]
        entry.graph.replay()
        loss, logs = entry.out
        return loss.clone(), {k: v.clone() for k, v in logs.items()}

    def eval_step(self, graph: Graph, **inputs):
        """One replayed eval step on ``graph`` and ``inputs``: (loss, logs,
        metrics) as clones, and the predictions as the graph's own
        outputs."""
        static, static_inputs = self._static_for(graph, inputs)
        key = shape_key(graph)
        if key not in self.eval_graphs:
            self.eval_graphs[key] = self._capture(self.eval_body, static, static_inputs,
                                                  inference=True)
        entry = self.eval_graphs[key]
        entry.graph.replay()
        total, logs, mets, preds = entry.out
        return (total.clone(), {k: v.clone() for k, v in logs.items()},
                {k: v.clone() for k, v in mets.items()}, preds)
