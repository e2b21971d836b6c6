"""The trainer for data parallel x the halo edge partition, counterpart of
``hamgnn_tpu/parallel/halo_trainer.py``; the path behind ``setup.parallel``:

    setup:
      parallel:
        mode: halo        # none | dp | halo
        n_data: 2         # data rows (crystals a step)
        n_graph: 4        # edge-partition shards a crystal
        edge_quantum: 64

``dp`` is the same path with ``n_graph`` 1.  ``HaloTrainer`` extends the
one-device ``train.trainer.Trainer`` and keeps its plateau schedule, early
stopping, ``metrics.jsonl`` and ``best.pt`` (written by rank 0 alone, in the
one-device format, so a halo-trained ``best.pt`` loads into ``mode: none``;
every rank reads it on resume).  What changes: the parameters and the
optimizer state start from rank 0's, the train and eval steps are the halo
steps of ``parallel/halo_model.py`` (eager: a step with collectives is not
captured), and batches are packed halo inputs.  With a band loss a step
takes one crystal (``n_data`` 1) and the whole-crystal Graph rides along for
the band solve.  ``eval_epoch(collect=True)``, the prediction export, runs
the one-device forward on rank 0.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable

import numpy as np
import torch

from ..data.graph import Graph, pad_and_batch
from ..train.trainer import Trainer
from .halo_model import (edge_unperm_for_plan, halo_bucket_sizes, local_inputs,
                         make_halo_loss_fn, make_halo_train_step, plan_for_graph,
                         stack_halo_inputs)
from .multihost import is_primary
from .sharding import make_mesh, mean_over_data, replicate_to_mesh


def _bucket(n: int, quantum: int) -> int:
    return max(quantum, int(math.ceil(n / quantum)) * quantum)


def graph_to(graph: Graph, device) -> Graph:
    """The Graph with every tensor on ``device``."""
    return Graph(**{f.name: (None if getattr(graph, f.name) is None
                             else getattr(graph, f.name).to(device))
                    for f in dataclasses.fields(Graph)})


class HaloDataAdapter:
    """Wraps a ``GraphDataModule``: train and val batches become stacked halo
    inputs (``n_data`` crystals a step, each split ``n_graph`` ways, at bucket
    sizes common to the data set, so every step has one shape); the test
    batches stay the padded Graphs of the one-device export."""

    def __init__(self, dm, n_data: int, n_graph: int, edge_quantum: int = 64,
                 band_mode: bool = False):
        self.dm = dm
        self.n_data = n_data
        self.n_graph = n_graph
        self.edge_quantum = edge_quantum
        self.band_mode = band_mode
        gs = dm.graphs
        self.node_bucket = _bucket(max(c["z"].shape[0] for c in gs), dm.node_quantum)
        self.edge_bucket = _bucket(max(c["edge_index"].shape[1] for c in gs),
                                   dm.edge_quantum)
        padded = [self._pad(gs[i]) for i in range(min(len(gs), 64))]
        self.halo_sizes = halo_bucket_sizes(padded, n_graph, edge_quantum)

    def _pad(self, c) -> Graph:
        return pad_and_batch([c], node_bucket=self.node_bucket,
                             edge_bucket=self.edge_bucket)

    def _halo_batches(self, indices, shuffle: bool, rng=None):
        order = list(indices)
        if not order:
            return
        if shuffle:
            (rng or np.random.default_rng()).shuffle(order)
        d = self.n_data
        # wrap the last group as torch's DistributedSampler does: every
        # crystal is visited and every step has one shape
        if len(order) % d:
            order = order + order[: d - len(order) % d]
        for i in range(0, len(order), d):
            graphs = [self._pad(self.dm.graphs[j]) for j in order[i : i + d]]
            inputs = stack_halo_inputs(graphs, self.n_graph, self.edge_quantum,
                                       force_sizes=self.halo_sizes)
            # band mode (n_data 1): the whole-crystal Graph for the k-space solve
            yield (inputs, graphs[0]) if self.band_mode else inputs

    def train_batches(self, rng=None):
        """Every rank must pass the same ``rng`` state."""
        return self._halo_batches(self.dm.train_idx, shuffle=True, rng=rng)

    def val_batches(self):
        return self._halo_batches(self.dm.val_idx, shuffle=False)

    def test_batches(self):
        return self.dm.test_batches()


class HaloTrainer(Trainer):
    def __init__(self, *args, n_data: int = 1, n_graph: int = 1,
                 edge_quantum: int = 64, **kwargs):
        kwargs["capture"] = False
        super().__init__(*args, **kwargs)
        self.mesh = make_mesh(n_data, n_graph)
        self.n_data = n_data
        self.n_graph = n_graph
        self.edge_quantum = edge_quantum
        self.primary = is_primary()
        replicate_to_mesh(self.mesh, [self.flat, *self.opt.state_dict().values()])
        if self._band_mode and n_data != 1:
            raise ValueError("halo band losses train one crystal a step (n_data 1)")
        self._hstep = None
        self._heval = None
        self._plan_cache: Dict[tuple, torch.Tensor] = {}

    @property
    def _band_mode(self) -> bool:
        return bool(getattr(self.model.output, "calculate_band_energy", False))

    def _halo_step(self):
        if self._hstep is None:
            self._hstep = make_halo_train_step(self.model, self.opt, self.losses, self.mesh,
                                               self.flat, self.grad,
                                               with_band=self._band_mode)
        return self._hstep

    def _halo_eval(self):
        if self._heval is None:
            self._heval = make_halo_loss_fn(self.model, self.mesh, self.losses,
                                            metrics=self.metrics, with_band=self._band_mode)
        return self._heval

    def _args(self, item):
        """(this rank's local inputs, band arguments) of a batch."""
        if not self._band_mode:
            return local_inputs(item, self.n_graph, self.mesh.graph_rank, self.device,
                                data_row=self.mesh.data_rank), ()
        inputs, graph = item
        return (local_inputs(inputs, self.n_graph, self.mesh.graph_rank, self.device,
                             data_row=0), self._band_args(graph))

    def _band_args(self, graph: Graph):
        """(band graph, k_vecs, edge_unperm) of a band-mode step.  The
        partition plan depends on the crystal's edge topology alone and is
        cached by it; the k-points are drawn anew, as the one-device trainer
        draws them."""
        from ..physics.kpoints import k_vecs_for_graph

        out = self.model.output
        k_vecs = torch.as_tensor(k_vecs_for_graph(graph, out.num_k, out.k_path),
                                 device=self.device)
        ei = graph.edge_index.numpy()
        key = (graph.num_nodes, graph.num_edges, hash(ei.tobytes()))
        unperm = self._plan_cache.get(key)
        if unperm is None:
            plan = plan_for_graph(graph, self.n_graph, self.edge_quantum)
            unperm = torch.as_tensor(edge_unperm_for_plan(plan, graph.num_edges),
                                     device=self.device)
            self._plan_cache[key] = unperm
        return graph_to(graph, self.device), k_vecs, unperm

    def train_step(self, item):
        """One update on a batch as ``HaloDataAdapter`` yields it; returns the
        means over the data rows of the loss and the logs, the same on every
        rank (``logs["nonfinite_step"]`` 1.0 where the guard dropped it)."""
        self.model.train()
        inp, band = self._args(item)
        return self._halo_step()(inp, self.sched.lr, *band)

    def train_epoch(self, batches: Iterable) -> float:
        losses, bad = [], []
        for item in batches:
            loss, logs = self.train_step(item)
            losses.append(loss)
            bad.append(logs["nonfinite_step"])
        if not losses:
            self.nonfinite_steps = 0
            return 0.0
        vals = torch.stack(losses).double().cpu().numpy()
        self.nonfinite_steps = int(torch.stack(bad).sum().cpu())
        finite = np.isfinite(vals)
        return float(vals[finite].mean()) if finite.any() else 0.0

    def eval_epoch(self, batches: Iterable, collect: bool = False):
        """(mean loss, mean logs and metrics) over the halo batches; with
        ``collect``, the one-device forward of the plain Graph batches on
        rank 0 (the other ranks return nothing)."""
        if collect:
            if self.primary:
                return super().eval_epoch(batches, collect=True)
            return 0.0, {}, []
        self.model.eval()
        loss_fn = self._halo_eval()
        losses, aggs = [], []
        with torch.inference_mode():
            for item in batches:
                inp, band = self._args(item)
                total, logs, mets = loss_fn(inp, *band)
                d = {**logs, **mets}
                means = mean_over_data(self.mesh, [total] + list(d.values()))
                losses.append(means[0])
                aggs.append(dict(zip(d, means[1:])))
        agg: Dict[str, float] = {}
        if aggs:
            keys = list(aggs[0])
            host = torch.stack([torch.stack([a[k] for k in keys]) for a in aggs]).cpu()
            for i, k in enumerate(keys):
                agg[k] = float(host[:, i].double().mean())
        loss = float(torch.stack(losses).double().mean().cpu()) if losses else 0.0
        return loss, agg
