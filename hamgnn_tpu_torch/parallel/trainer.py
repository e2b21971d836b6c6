"""Data-parallel trainer on whole crystals, counterpart of
``hamgnn_tpu/parallel/trainer.py``.

Extends the one-device ``train.trainer.Trainer``: a step takes ``n_data``
crystals, pads them to one common node and edge bucket, and gives each data
row one of them (the ranks of a graph column's row hold the same crystal);
the step (``parallel.sharding.make_parallel_train_step``) averages the
per-crystal losses and gradients over the data rows.  On the card under an
NCCL group the training and eval steps are replayed from CUDA graphs, one
set per padded crystal's shape (``train/captured.py``), as the JAX trainer
caches one jitted program per ``(z.shape, edge_index.shape)``; the crystals
are padded on the host and copied into the graphs' buffers.  On the CPU,
over gloo and with ``capture=False`` the steps run eagerly
(``sharding.capture_default``).  An epoch reads the device once.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..data.graph import pad_and_batch
from ..train.captured import CapturedSteps
from ..train.trainer import Trainer
from .multihost import is_primary
from .sharding import (capture_default, make_mesh, make_parallel_eval_step,
                       make_parallel_train_step, replicate_to_mesh)


def _round_up(x: int, m: int) -> int:
    return max(m, ((x + m - 1) // m) * m)


def _host_mean(losses: List[torch.Tensor]) -> float:
    """The float64 mean of per-step device losses, read in one copy."""
    if not losses:
        return 0.0
    return float(np.mean(torch.stack(losses).cpu().numpy().astype(np.float64)))


class ParallelTrainer(Trainer):
    """``capture``: replay the steps from CUDA graphs (default: on the card
    under an NCCL group); ``parallel_steps`` holds them (None when eager)."""

    def __init__(self, *args, n_data: int = 1, n_graph: int = 1,
                 node_quantum: int = 16, edge_quantum: int = 512, capture=None, **kwargs):
        super().__init__(*args, capture=False, **kwargs)
        if getattr(self.model.output, "calculate_band_energy", False):
            raise ValueError("the data-parallel step on whole crystals takes no band "
                             "loss; the halo trainer does (n_data 1)")
        self.mesh = make_mesh(n_data, n_graph)
        self.n_data = n_data
        self.node_quantum = node_quantum
        self.edge_quantum = edge_quantum
        self.primary = is_primary()
        replicate_to_mesh(self.mesh, [self.flat, *self.opt.state_dict().values()])
        self._pstep = make_parallel_train_step(self.model, self.opt, self.losses, self.mesh,
                                               self.flat, self.grad)
        self._pev = make_parallel_eval_step(self.model, self.losses, self.mesh)
        capture = capture_default(capture, self.device)
        self.parallel_steps = CapturedSteps(
            self.device, lambda g: self._pstep(g, self.lr_t), lambda g: (*self._pev(g), {}, {}),
            self.state) if capture else None

    def _stack(self, crystals: List[Dict], device=None):
        """This rank's crystal of the group, padded to the group's buckets, on
        ``device`` (the trainer's by default)."""
        n_bucket = _round_up(max(c["z"].shape[0] for c in crystals), self.node_quantum)
        e_bucket = _round_up(max(c["edge_index"].shape[1] for c in crystals),
                             self.edge_quantum)
        return pad_and_batch([crystals[self.mesh.data_rank]], node_bucket=n_bucket,
                             edge_bucket=e_bucket, device=device or self.device)

    def _iter_stacked(self, crystals: List[Dict], shuffle: bool, rng=None):
        """The padded crystals of an epoch: on the host for the captured
        steps (copied into their buffers), else on the card."""
        device = "cpu" if self.parallel_steps is not None else self.device
        order = list(range(len(crystals)))
        if shuffle:
            (rng or np.random.default_rng()).shuffle(order)
        d = self.n_data
        for i in range(0, len(order) - d + 1, d):
            yield self._stack([crystals[j] for j in order[i : i + d]], device)

    def train_step(self, graph):
        """One update on this rank's padded crystal; returns the means over
        the data rows of the loss and the logs."""
        self.model.train()
        self.fill_lr()
        if self.parallel_steps is None:
            return self._pstep(graph, self.lr_t)
        return self.parallel_steps.train_step(graph)

    def train_epoch_crystals(self, crystals: List[Dict], rng=None) -> float:
        """One pass; every rank must pass the same ``rng`` state."""
        return _host_mean([self.train_step(g)[0]
                           for g in self._iter_stacked(crystals, shuffle=True, rng=rng)])

    def eval_epoch_crystals(self, crystals: List[Dict]) -> float:
        self.model.eval()
        losses = []
        with torch.inference_mode():
            for g in self._iter_stacked(crystals, shuffle=False):
                losses.append(self._pev(g)[0] if self.parallel_steps is None
                              else self.parallel_steps.eval_step(g)[0])
        return _host_mean(losses)
