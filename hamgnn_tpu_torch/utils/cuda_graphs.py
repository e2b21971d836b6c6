"""CUDA graphs cut around work that a graph cannot hold.

Some work on a stream cannot be recorded in a CUDA graph: cuSOLVER's
Hermitian eigensolvers wait for the card inside their call, which
invalidates a capture.  Code that runs such work hands it to ``host_step``.
A capture made through ``segmented_capture`` is then cut there: it records
one graph before each ``host_step`` and one after the last, and its
``Segments.replay`` runs the graphs and, between them, the handed-over
work, in the order of the capture.  The work's inputs and outputs are
tensors of the capture's pool, as the graphs' own, so every replay finds
them at the same addresses.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, List, Optional

import torch


class Segments:
    """One capture as CUDA graphs cut at each ``host_step``: ``graphs`` in
    capture order, ``host[i]`` the work that runs after ``graphs[i]``."""

    def __init__(self, pool):
        self.pool = pool
        self.graphs: List[torch.cuda.CUDAGraph] = []
        self.host: List[Callable] = []

    def begin(self) -> None:
        self.graphs.append(torch.cuda.CUDAGraph())
        self.graphs[-1].capture_begin(pool=self.pool)

    def cut(self, fn: Callable) -> None:
        self.graphs[-1].capture_end()
        self.host.append(fn)
        self.begin()

    def end(self) -> None:
        self.graphs[-1].capture_end()

    def replay(self) -> None:
        for i, graph in enumerate(self.graphs):
            graph.replay()
            if i < len(self.host):
                self.host[i]()


# the segmented capture in progress on this process, if any
_ACTIVE: Optional[Segments] = None


@contextlib.contextmanager
def segmented_capture(pool) -> Iterator[Segments]:
    """Capture the body on the current stream into graphs of ``pool``, cut
    at each ``host_step``; yields the ``Segments``."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a segmented capture is already in progress")
    segments = _ACTIVE = Segments(pool)
    try:
        segments.begin()
        try:
            yield segments
        finally:
            segments.end()
    finally:
        _ACTIVE = None


def host_step(fn: Callable) -> None:
    """Run ``fn()``, work on the current stream that a CUDA graph cannot
    hold.  Outside a capture it runs now.  Inside ``segmented_capture`` it
    does not run: the graph is cut here, and ``fn`` runs at this point of
    every replay, on the stream of the replay, so it must read and write
    only tensors that exist when it is handed over.  Inside any other
    capture it raises."""
    if not torch.cuda.is_current_stream_capturing():
        fn()
        return
    if _ACTIVE is None:
        raise RuntimeError("this step runs work that a CUDA graph cannot hold (the band "
                           "branch's eigensolve): capture it through utils.cuda_graphs."
                           "segmented_capture (train.captured.CapturedSteps does)")
    _ACTIVE.cut(fn)
