"""One run of a cell: set-up, the measured window, the traced reading, and
the comparison with the plain reference once the window has closed.

A ``train`` traffic drives ``Trainer.train_step`` (captured on the card)
over the training split of a ``GraphDataModule``, epoch after epoch in a
seeded order, as ``stage: fit`` does.  Set-up runs the first epoch, which
warms every shape key; its first three steps are the ones the reference
follows.  A ``predict`` traffic drives ``Trainer.eval_step`` over
``GraphDataModule(test_mode=True).test_batches`` in a closed loop with one
client, as ``stage: test`` does, and copies each Hamiltonian to the host.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import sys
import time
from collections.abc import Sequence
from typing import Dict, List

import numpy as np
import torch

from . import correct
from . import traffic as traffic_mod
from .trace import SPAN_PREFIX, WINDOW
from .trace import read as read_trace
from .weights import make_weights

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "hamgnn_tpu")
TRAIN_DIR = "build/benchmark_train"
# occurrences of each crystal among which the prediction that is compared
# is drawn
SAMPLE_AMONG = 8


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names of ``sys.modules`` (compared whole) that the run must
    not hold."""
    tops = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(tops & set(FORBIDDEN))


class LazySet(Sequence):
    """The traffic's crystals, each made at its first use and kept: a data
    module reads only those its batches need."""

    def __init__(self, traffic: Dict, targets: Dict, seed: int):
        self.traffic, self.targets, self.seed = traffic, targets, seed
        self._made: Dict[int, Dict] = {}

    def __len__(self) -> int:
        return int(self.traffic["crystals"])

    def __getitem__(self, i):
        if not 0 <= i < len(self):
            raise IndexError(i)
        if i not in self._made:
            self._made[i] = traffic_mod.make_one(self.traffic, self.targets, self.seed, i)
        return self._made[i]


def spans(traced: bool):
    """The window's host spans by name (``pack``, ``step``, ``copy_out``): in a
    traced run each is a ``record_function`` range the trace reads, else
    nothing."""
    if traced:
        return lambda name: torch.profiler.record_function(SPAN_PREFIX + name)
    return lambda name: contextlib.nullcontext()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_program(config: Dict, device):
    """The program's model and trainer for a configuration, as the CLI builds
    them."""
    from hamgnn_tpu_torch.cli import build_model
    from hamgnn_tpu_torch.train.config import config_to_dict, load_config
    from hamgnn_tpu_torch.train.trainer import Trainer

    cfg = load_config(overrides=copy.deepcopy(config["model"]))
    model = build_model(cfg)
    opt = cfg.optim_params
    return Trainer(model, losses=[config_to_dict(x) for x in cfg.losses_metrics.losses],
                   metrics=[config_to_dict(x) for x in cfg.losses_metrics.metrics],
                   lr=opt.lr, lr_decay=opt.lr_decay, lr_patience=opt.lr_patience,
                   gradient_clip_val=opt.gradient_clip_val, stop_patience=opt.stop_patience,
                   min_epochs=opt.min_epochs, max_epochs=opt.max_epochs,
                   train_dir=TRAIN_DIR, device=device)


def leaves_of(model) -> List:
    return [(n, tuple(p.shape)) for n, p in model.named_parameters()]


def data_module(crystals, traffic: Dict, device, test_mode: bool):
    from hamgnn_tpu_torch.data.dataset import GraphDataModule

    split = traffic.get("split", [0.6, 0.2, 0.2])
    return GraphDataModule(crystals, batch_size=int(traffic["batch_size"]),
                           train_ratio=split[0], val_ratio=split[1], test_ratio=split[2],
                           test_mode=test_mode, node_quantum=int(traffic["node_quantum"]),
                           edge_quantum=int(traffic["edge_quantum"]), device=device)


def _order(indices, batch_size: int, rng=None) -> List[List[int]]:
    order = list(indices)
    if rng is not None:
        copy.deepcopy(rng).shuffle(order)
    return [order[i : i + batch_size] for i in range(0, len(order), batch_size)]


def release() -> None:
    """Give back what a finished run's program held on the card (its
    graphs, pool and buffers are cyclic garbage once the run has returned)."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


class Run:
    """What a run hands on: its numbers, the traced reading, and the
    program's parameters' names and shapes (the weights' leaves)."""

    def __init__(self, leaves):
        self.leaves = leaves
        self.setup_s = 0.0
        self.window_s = 0.0
        self.items: List[tuple] = []     # (nodes, edges) of each step or prediction
        self.latency_s: List[float] = []
        self.failed = 0
        self.trace = None
        self.memory_peak = 0
        self.shape_keys = 0


def _window(run: Run, seconds: float, traced: bool, device, body):
    """Run ``body(span, t0)`` until it returns False, timing the window; in a
    traced run under the profiler."""
    span = spans(traced)
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
    try:
        with (torch.profiler.record_function(SPAN_PREFIX + WINDOW) if traced
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            while body(span, t0):
                pass
            _sync(device)
            run.window_s = time.perf_counter() - t0
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    if prof is not None:
        run.trace = read_trace(prof)


def train(cell, seed: int, seconds: float, traced: bool, device, t_start: float,
          log=print):
    """One run of a ``train`` cell: (Run, the program's record of its first
    three steps, the crystals those steps read)."""
    traffic = cell.traffic
    trainer = build_program(cell.config, device)
    from hamgnn_tpu_torch.train.trainer import load_params

    leaves = leaves_of(trainer.model)
    load_params(trainer.model, make_weights(leaves, seed, device))
    crystals = LazySet(traffic, cell.config["targets"], seed)
    dm = data_module(crystals, traffic, device, test_mode=False)
    bs = int(traffic["batch_size"])
    rng = np.random.default_rng([int(seed), int(traffic["order_seed_offset"])])
    n_follow = int(traffic["reference_steps"])

    first = _order(dm.train_idx, bs, rng)
    theta0 = trainer.flat.detach().to("cpu", copy=True)
    losses, mu1, theta_n = [], None, None
    for i, g in enumerate(dm.train_batches(rng)):
        loss, _logs = trainer.train_step(g)
        if i < n_follow:
            losses.append(loss)
        if i == 0:
            mu1 = trainer.opt.mu.detach().to("cpu", copy=True)
        if i == n_follow - 1:
            theta_n = trainer.flat.detach().to("cpu", copy=True)
    if theta_n is None:
        raise ValueError(f"an epoch of {len(first)} steps is shorter than the "
                         f"{n_follow} the reference follows")
    record = correct.program_train_record(
        [float(x) for x in torch.stack(losses).cpu()], mu1, theta0, theta_n, leaves,
        float(np.float32(1.0 - trainer.opt.b1)))
    run = Run(leaves)
    run.shape_keys = len(trainer.captured.train_graphs) if trainer.captured else 0
    log(f"set-up: {run.shape_keys} shape key(s) captured over {len(first)} steps")
    _sync(device)
    run.setup_s = time.perf_counter() - t_start

    flags = []
    state = {"order": [], "it": None}

    def body(span, t0):
        if not state["order"]:
            state["order"] = _order(dm.train_idx, bs, rng)
            state["it"] = dm.train_batches(rng)
        idx = state["order"].pop(0)
        with span("pack"):
            g = next(state["it"])
        with span("step"):
            _loss, logs = trainer.train_step(g)
        flags.append(logs["nonfinite_step"])
        run.items.append((sum(crystals[j]["z"].shape[0] for j in idx),
                          sum(crystals[j]["edge_index"].shape[1] for j in idx)))
        return time.perf_counter() - t0 < seconds

    _window(run, seconds, traced, device, body)
    run.failed = int(torch.stack(flags).sum().item()) if flags else 0
    if device.type == "cuda":
        run.memory_peak = torch.cuda.max_memory_allocated(device)
    return run, record, [[crystals[j] for j in idx] for idx in first[:n_follow]]


def predict(cell, seed: int, seconds: float, traced: bool, device, t_start: float,
            log=print):
    """One run of a ``predict`` cell: (Run, {crystal index: its sampled
    prediction on the host}, the crystals)."""
    traffic = cell.traffic
    trainer = build_program(cell.config, device)
    from hamgnn_tpu_torch.train.trainer import load_params

    leaves = leaves_of(trainer.model)
    load_params(trainer.model, make_weights(leaves, seed, device))
    crystals = LazySet(traffic, cell.config["targets"], seed)
    dm = data_module(crystals, traffic, device, test_mode=True)
    keys = correct.hamiltonian_keys(cell.config)
    n = len(crystals)
    draw = np.random.default_rng([int(seed), int(traffic["sample_seed_offset"])])
    want = {j: int(draw.integers(0, SAMPLE_AMONG)) for j in range(n)}

    def to_host(preds):
        return {k: preds[k].to("cpu", copy=True) for k in keys}

    for g in dm.test_batches():
        _t, _l, _m, preds = trainer.eval_step(g)
        to_host(preds)
    run = Run(leaves)
    run.shape_keys = len(trainer.captured.eval_graphs) if trainer.captured else 0
    log(f"set-up: {run.shape_keys} shape key(s) captured over {n} crystals")
    _sync(device)
    run.setup_s = time.perf_counter() - t_start

    seen = {j: 0 for j in range(n)}
    kept: Dict[int, Dict] = {}
    flags = []
    state = {"it": None, "j": 0}

    def body(span, t0):
        if state["j"] % n == 0:
            state["it"] = dm.test_batches()
        j = state["j"] % n
        state["j"] += 1
        t_req = time.perf_counter()
        with span("pack"):
            g = next(state["it"])
        with span("step"):
            total, _l, _m, preds = trainer.eval_step(g)
        with span("copy_out"):
            host = to_host(preds)
        run.latency_s.append(time.perf_counter() - t_req)
        flags.append(total)
        if seen[j] <= want[j]:
            kept[j] = host
        seen[j] += 1
        run.items.append((crystals[j]["z"].shape[0], crystals[j]["edge_index"].shape[1]))
        return time.perf_counter() - t0 < seconds

    _window(run, seconds, traced, device, body)
    run.failed = int((~torch.isfinite(torch.stack(flags))).sum().item()) if flags else 0
    if device.type == "cuda":
        run.memory_peak = torch.cuda.max_memory_allocated(device)
    return run, kept, crystals
