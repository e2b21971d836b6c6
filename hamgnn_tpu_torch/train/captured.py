"""The training and eval steps captured as CUDA graphs: the counterpart of
the JAX trainer's jitted steps (``hamgnn_tpu/train/trainer.py:185-248``)
and of the Uni-HamGNN predictor's jitted stages
(``hamgnn_tpu/tools/uni_hamgnn.py:143``, ``:151``).

JAX compiles the forward, the loss, the gradient, the non-finite guard and
the amsgrad update into one XLA program per batch shape (``_shape_key``:
nodes, edges, graphs), and the eval forward, losses and metrics into
another.  Here each is one ``torch.cuda.CUDAGraph`` per shape key, which a
step replays: the host launches one graph instead of the step's kernels.
A user with no training step (a predictor stage) holds ``CapturedSteps``
with only a forward body and replays it through ``forward``.

- A batch is copied into static buffers of its key, one for every tensor
  field of ``Graph`` and one for every input the step takes besides it (the
  k-points of a head with bands, made on the host outside the graph),
  shared by the key's training and eval graphs.  The batch of a
  multi-device step is a dict of the rank's packed halo inputs, and its
  inputs may hold a Graph (the whole crystal of a band-mode halo step): the
  key is then the shapes of all the step's tensors by name (``step_key``).
- A tensor that comes from the host (a multi-device step's packed inputs)
  is copied into its static buffer from pinned memory without waiting
  (``non_blocking``); PyTorch's caching host allocator keeps the pinned
  block until the copy is done.
- The loss and logs a step returns are clones: the next replay overwrites
  the graph's outputs.  An eval step's predictions are the graph's own
  outputs, valid until the next replay.
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
- Under an NCCL process group (the multi-device trainers) the graphs are
  captured in the ``thread_local`` error mode (``utils.cuda_graphs.
  capture_mode``).  The warm-up runs every collective of the step once, so
  each process group has made its communicator before the capture.

A capture that fails raises: nothing falls back to the eager step.  The
kernels' launch counters are host-side, so they count the warm-up and the
capture (one pass through each wrapper each), not the replays; a replay's
launches show in a profiler trace.
"""

from __future__ import annotations

import dataclasses
import gc
from typing import Any, Callable, Dict, Optional, Tuple

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


def step_tensors(x, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Every tensor of a step argument by name: a Graph's tensor fields, a
    dict's entries (a Graph or dict inside one as ``name.field``), a tensor
    itself under ``prefix``.  None is left out."""
    if isinstance(x, torch.Tensor):
        return {prefix: x}
    items = tensor_fields(x) if isinstance(x, Graph) else x
    out: Dict[str, torch.Tensor] = {}
    for name, v in items.items():
        if v is not None:
            out.update(step_tensors(v, f"{prefix}.{name}" if prefix else name))
    return out


def step_key(batch, inputs: Dict[str, Any]) -> tuple:
    """The key a step is captured under.  A Graph batch: its ``shape_key``
    (the one-device trainer's, JAX's ``_shape_key``); any other batch (a
    rank's packed halo inputs): the shapes of every tensor of the batch and
    the inputs, in the order of their names.  The names and types must be
    the key's capture's: ``copy_inputs`` raises otherwise."""
    if isinstance(batch, Graph):
        return shape_key(batch)
    return tuple(tuple(t.shape) for _, t in
                 sorted(step_tensors({"batch": batch, **inputs}).items()))


def static_copy(x, device=None):
    """New contiguous buffers on ``device`` (``x``'s by default) holding a
    copy of a step argument, of the same structure (Graph, dict, tensor)."""
    if isinstance(x, torch.Tensor):
        return x.to(device or x.device, copy=True, memory_format=torch.contiguous_format)
    if isinstance(x, Graph):
        return dataclasses.replace(x, **{n: static_copy(t, device)
                                         for n, t in tensor_fields(x).items()})
    return {n: static_copy(v, device) for n, v in x.items() if v is not None}


def static_graph(graph: Graph) -> Graph:
    """A ``Graph`` of new buffers holding a copy of ``graph``'s tensors."""
    with torch.inference_mode(False):
        return static_copy(graph)


def _input_signature(inputs: Dict[str, torch.Tensor]) -> tuple:
    return tuple((n, tuple(t.shape), t.dtype) for n, t in sorted(inputs.items()))


def copy_inputs(static, inputs) -> None:
    """Copy a step's arguments (a Graph, a dict of tensors and Graphs, a
    tensor) into the buffers of ``static``, of the same structure; raises
    unless every tensor has the same name, shape and type, and lies on its
    buffer's device or on the host.  A tensor on the host fills a buffer on
    the card from pinned memory, without waiting for the card."""
    dst, src = step_tensors(static), step_tensors(inputs)
    if _input_signature(dst) != _input_signature(src) or any(
            t.device != dst[n].device and t.device.type != "cpu" for n, t in src.items()):
        raise ValueError(f"step arguments {_input_signature(src)} have other fields than "
                         f"the captured ones {_input_signature(dst)}")
    for name, t in src.items():
        if dst[name].is_cuda and not t.is_cuda:
            dst[name].copy_(t.pin_memory(), non_blocking=True)
        else:
            dst[name].copy_(t)


def copy_into(static: Graph, graph: Graph) -> None:
    """Copy ``graph``'s tensors into the buffers of ``static``; raises unless
    the two have the same tensor fields of the same shapes and types
    (``copy_inputs`` of a batch)."""
    copy_inputs(static, graph)


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
    """The captured training and eval steps of one trainer, or the captured
    forward of one predictor stage.

    ``train_body(batch, **inputs)`` is the trainer's step (gradient zeroed,
    forward, loss, backward, guarded update at the device learning rate;
    returns (loss, logs)); ``eval_body(batch, **inputs)`` its eval step
    ((loss, logs, metrics, predictions)), run under
    ``torch.inference_mode``.  ``batch`` is a ``Graph`` or a dict of a
    rank's packed halo inputs; ``inputs`` are what a step takes besides it
    (``k_vecs``; a band-mode halo step's whole-crystal Graph and edge
    unpermutation; the upstream prediction of a SOC stage), static buffers
    of the step key like the batch's.  ``state()`` gives the tensors a
    training step updates in place.  Without a training step
    (``train_body`` and ``state`` None) ``eval_body`` may return anything,
    and ``forward`` replays it.  ``pool``: the memory pool of the graphs
    (a new one by default; several ``CapturedSteps`` whose graphs never
    replay at once may share one, if each replay's outputs are read
    before the next: a graph of the pool may reuse another's freed memory
    for its outputs).  ``captures`` counts the graphs captured."""

    def __init__(self, device, train_body: Optional[Callable], eval_body: Callable,
                 state: Optional[Callable] = None, pool=None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if self.device.type != "cuda":
            raise ValueError(f"a captured step runs on the card, not {self.device}")
        self.train_body, self.eval_body, self.state = train_body, eval_body, state
        self.pool = torch.cuda.graph_pool_handle() if pool is None else pool
        self.stream = capture_stream(self.device)
        self.static: Dict[tuple, Tuple[Any, Dict[str, Any]]] = {}
        self.train_graphs: Dict[tuple, _Captured] = {}
        self.eval_graphs: Dict[tuple, _Captured] = {}
        self.captures = 0

    def _static_for(self, batch, inputs: Dict[str, Any]):
        key = step_key(batch, inputs)
        if key not in self.static:
            with torch.inference_mode(False):
                self.static[key] = (static_copy(batch, self.device),
                                    {n: static_copy(t, self.device) for n, t in inputs.items()})
        static, static_inputs = self.static[key]
        copy_inputs({"batch": static, **static_inputs}, {"batch": batch, **inputs})
        return key, static, static_inputs

    def _capture(self, body: Callable, static, inputs: Dict[str, Any],
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

    def train_step(self, batch, **inputs):
        """One replayed training step on ``batch`` and ``inputs`` (captured
        at the first step of its key): (loss, logs), clones of the
        graph's."""
        key, static, static_inputs = self._static_for(batch, inputs)
        if key not in self.train_graphs:
            self.train_graphs[key] = self._capture(self.train_body, static, static_inputs,
                                                   inference=False)
        entry = self.train_graphs[key]
        entry.graph.replay()
        loss, logs = entry.out
        return loss.clone(), {k: v.clone() for k, v in logs.items()}

    def forward(self, batch, **inputs):
        """One replay of ``eval_body`` on ``batch`` and ``inputs`` (captured
        in inference mode at the first call of its key): its outputs, the
        graph's own, valid until the next replay of any graph of the pool."""
        key, static, static_inputs = self._static_for(batch, inputs)
        if key not in self.eval_graphs:
            self.eval_graphs[key] = self._capture(self.eval_body, static, static_inputs,
                                                  inference=True)
        entry = self.eval_graphs[key]
        entry.graph.replay()
        return entry.out

    def eval_step(self, batch, **inputs):
        """One replayed eval step on ``batch`` and ``inputs``: (loss, logs,
        metrics) as clones, and the predictions as the graph's own
        outputs."""
        total, logs, mets, preds = self.forward(batch, **inputs)
        return (total.clone(), {k: v.clone() for k, v in logs.items()},
                {k: v.clone() for k, v in mets.items()}, preds)
