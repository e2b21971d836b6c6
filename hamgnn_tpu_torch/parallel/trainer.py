"""Data-parallel trainer on whole crystals, counterpart of
``hamgnn_tpu/parallel/trainer.py``.

Extends the one-device ``train.trainer.Trainer``: a step takes ``n_data``
crystals, pads them to one common node and edge bucket, and gives each data
row one of them (the ranks of a graph column's row hold the same crystal);
the step (``parallel.sharding.make_parallel_train_step``) averages the
per-crystal losses and gradients over the data rows.  Every step runs
eagerly: a step with collectives is not captured.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..data.graph import pad_and_batch
from ..train.trainer import Trainer
from .multihost import is_primary
from .sharding import (make_mesh, make_parallel_eval_step, make_parallel_train_step,
                       replicate_to_mesh)


def _round_up(x: int, m: int) -> int:
    return max(m, ((x + m - 1) // m) * m)


class ParallelTrainer(Trainer):
    def __init__(self, *args, n_data: int = 1, n_graph: int = 1,
                 node_quantum: int = 16, edge_quantum: int = 512, **kwargs):
        kwargs["capture"] = False
        super().__init__(*args, **kwargs)
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

    def _stack(self, crystals: List[Dict]):
        """This rank's crystal of the group, padded to the group's buckets."""
        n_bucket = _round_up(max(c["z"].shape[0] for c in crystals), self.node_quantum)
        e_bucket = _round_up(max(c["edge_index"].shape[1] for c in crystals),
                             self.edge_quantum)
        return pad_and_batch([crystals[self.mesh.data_rank]], node_bucket=n_bucket,
                             edge_bucket=e_bucket, device=self.device)

    def _iter_stacked(self, crystals: List[Dict], shuffle: bool, rng=None):
        order = list(range(len(crystals)))
        if shuffle:
            (rng or np.random.default_rng()).shuffle(order)
        d = self.n_data
        for i in range(0, len(order) - d + 1, d):
            yield self._stack([crystals[j] for j in order[i : i + d]])

    def train_step(self, graph):
        """One update on this rank's padded crystal; returns the means over
        the data rows of the loss and the logs."""
        self.model.train()
        return self._pstep(graph, self.sched.lr)

    def train_epoch_crystals(self, crystals: List[Dict], rng=None) -> float:
        """One pass; every rank must pass the same ``rng`` state."""
        losses = [self.train_step(g)[0]
                  for g in self._iter_stacked(crystals, shuffle=True, rng=rng)]
        if not losses:
            return 0.0
        return float(np.mean([float(x) for x in losses]))

    def eval_epoch_crystals(self, crystals: List[Dict]) -> float:
        self.model.eval()
        losses = [float(self._pev(g)[0]) for g in self._iter_stacked(crystals, shuffle=False)]
        return float(np.mean(losses)) if losses else 0.0
