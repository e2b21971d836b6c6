"""Training loop, counterpart of ``hamgnn_tpu/train/trainer.py``.

One train step is a forward, the masked loss, a backward (through the packed
TP kernels on the card) and the flat-vector amsgrad update of
``train/optim.py``, with the JAX trainer's non-finite guard on the device.
On the card the training and eval steps are captured as CUDA graphs, one per
batch shape, and replayed (``train/captured.py``), as the JAX trainer jits
one program per shape, the band steps of a head with
``calculate_band_energy`` as well: their k-points are made on the host from
the batch's cells before the step and copied into a static input of the
graph.  On the CPU and with ``capture=False`` the steps run eagerly.
Host-side ``PlateauScheduler`` (torch ReduceLROnPlateau semantics: factor
lr_decay, threshold 1e-6, cooldown patience // 2, min_lr 1e-6) and
``EarlyStopping`` are the JAX classes.  ``fit`` writes ``metrics.jsonl``
records with the JAX trainer's keys and keeps the best validation
checkpoint as ``train_dir/best.pt`` (a ``torch.save`` of params, optimizer
state and learning rate); ``load_checkpoint`` also resumes from an orbax
checkpoint of the JAX trainer.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..models.model import HamGNNModel, compute_losses, compute_metrics
from .captured import CapturedSteps
from .optim import Amsgrad, flatten_parameters


@dataclasses.dataclass
class PlateauScheduler:
    """ReduceLROnPlateau with cooldown, matching torch semantics."""

    lr: float
    factor: float = 0.5
    patience: int = 5
    threshold: float = 1e-6
    cooldown: int = 2
    min_lr: float = 1e-6

    best: float = float("inf")
    num_bad: int = 0
    cooldown_counter: int = 0

    def step(self, metric: float) -> float:
        if metric < self.best - self.threshold:
            self.best = metric
            self.num_bad = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.cooldown_counter = self.cooldown
                self.num_bad = 0
        return self.lr


@dataclasses.dataclass
class EarlyStopping:
    patience: int = 30
    threshold: float = 0.0
    best: float = float("inf")
    num_bad: int = 0

    def step(self, metric: float) -> bool:
        if metric < self.best - self.threshold:
            self.best = metric
            self.num_bad = 0
            return False
        self.num_bad += 1
        return self.num_bad > self.patience


class Trainer:
    """Single-device trainer.  The model's parameters become views of one
    flat buffer on ``device`` (cuda unless the caller asks for the CPU).

    ``capture``: replay each step as a CUDA graph (default: on the card);
    False runs every step eagerly.  The
    learning rate lives on the device as ``lr_t``, refilled from
    ``sched.lr`` before a step whenever the scheduler has changed it."""

    def __init__(self, model: HamGNNModel, losses: List[Dict[str, Any]],
                 metrics: List[Dict[str, Any]], lr: float = 0.01,
                 lr_decay: float = 0.5, lr_patience: int = 5,
                 gradient_clip_val: float = 0.0, stop_patience: int = 30,
                 min_epochs: int = 100, max_epochs: int = 3000,
                 train_dir: str = "./train_out", device=None,
                 capture: Optional[bool] = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.losses = losses
        self.metrics = metrics
        self.sched = PlateauScheduler(lr=lr, factor=lr_decay, patience=lr_patience,
                                      cooldown=lr_patience // 2)
        self.stopper = EarlyStopping(patience=stop_patience)
        self.min_epochs = min_epochs
        self.max_epochs = max_epochs
        self.train_dir = train_dir
        self.flat, self.grad = flatten_parameters(self.model)
        self.opt = Amsgrad(self.flat.numel(), self.device, gradient_clip_val)
        self.lr_t = torch.tensor(lr, dtype=torch.float32, device=self.device)
        self._lr_filled = lr
        if capture is None:
            capture = self.device.type == "cuda"
        elif capture and self.device.type != "cuda":
            raise ValueError(f"a captured step needs the card, not {self.device}")
        self.captured = self.captured_steps() if capture else None
        self.nonfinite_steps = 0  # of the last train_epoch
        # the process that writes metrics.jsonl and checkpoints (rank 0 of a
        # multi-process trainer)
        self.primary = True
        os.makedirs(train_dir, exist_ok=True)
        self._log_path = os.path.join(train_dir, "metrics.jsonl")

    # --- steps -----------------------------------------------------------

    def state(self):
        """The tensors a training step updates in place: the flat
        parameters, their gradient and the optimizer state."""
        return (self.flat, self.grad, *self.opt.state_dict().values())

    def captured_steps(self) -> CapturedSteps:
        """This trainer's one-device steps, captured."""
        return CapturedSteps(self.device, lambda g, **kw: self._step(g, self.lr_t, **kw),
                             self._eval, self.state)

    def fill_lr(self) -> None:
        """Refill the device learning rate ``lr_t`` from ``sched.lr`` when
        the scheduler has changed it (outside any graph: a replay reads
        ``lr_t``)."""
        if self._lr_filled != self.sched.lr:
            self.lr_t.fill_(self.sched.lr)
            self._lr_filled = self.sched.lr

    def _band_kwargs(self, graph) -> Dict[str, torch.Tensor]:
        """Host-generated k-points when the output head computes bands, a
        step's input besides the batch.

        Without a ``k_path`` the random k set comes from a fresh seeded
        generator at every call, as in the JAX trainer: each crystal slot of
        a batch sees the same k set in every step and validation pass.  The
        cells are the batch's host copy where it has one
        (``graph.cell_host``): no read of the device."""
        out = self.model.output
        if not getattr(out, "calculate_band_energy", False):
            return {}
        from ..physics.kpoints import k_vecs_for_graph

        k = k_vecs_for_graph(graph, out.num_k, out.k_path)
        return {"k_vecs": torch.as_tensor(k, device=self.device)}

    def _step(self, graph, lr, **kw):
        self.grad.zero_()
        preds = self.model(graph, **kw)
        total, logs = compute_losses(preds, graph, self.losses)
        total.backward()
        ok = self.opt.step(self.flat, self.grad, lr, loss=total.detach())
        logs = {k: v.detach() for k, v in logs.items()}
        logs["nonfinite_step"] = 1.0 - ok.to(torch.float32)
        return total.detach(), logs

    def _eval(self, graph, **kw):
        preds = self.model(graph, **kw)
        total, logs = compute_losses(preds, graph, self.losses)
        return total, logs, compute_metrics(preds, graph, self.metrics), preds

    def train_step(self, graph):
        """One update on ``graph``; returns (loss, logs) as device scalars,
        with ``logs["nonfinite_step"]`` 1.0 where the guard dropped it."""
        self.model.train()
        kw = self._band_kwargs(graph)
        if self.captured is None:
            return self._step(graph, self.sched.lr, **kw)
        self.fill_lr()
        return self.captured.train_step(graph, **kw)

    def eval_step(self, graph):
        """(loss, logs, metrics, predictions) of ``graph`` in inference mode.
        Replayed, the predictions are the graph's outputs, valid until the
        next eval step."""
        self.model.eval()
        with torch.inference_mode():
            kw = self._band_kwargs(graph)
            if self.captured is None:
                return self._eval(graph, **kw)
            return self.captured.eval_step(graph, **kw)

    # --- loops -----------------------------------------------------------

    def train_epoch(self, batches: Iterable) -> float:
        """Mean loss of the finite steps; one host sync per epoch."""
        losses, bad = [], []
        for g in batches:
            loss, logs = self.train_step(g)
            losses.append(loss)
            bad.append(logs["nonfinite_step"])
        if not losses:
            self.nonfinite_steps = 0
            return 0.0
        vals, bad = torch.stack([torch.stack(losses), torch.stack(bad)]).double().cpu().numpy()
        self.nonfinite_steps = int(bad.sum())
        finite = np.isfinite(vals)
        return float(vals[finite].mean()) if finite.any() else 0.0

    def eval_epoch(self, batches: Iterable, collect: bool = False):
        """(mean loss, mean logs and metrics[, [(graph, numpy predictions)]])."""
        losses, aggs, preds_all = [], [], []
        for g in batches:
            total, logs, mets, preds = self.eval_step(g)
            losses.append(total)
            aggs.append({**logs, **mets})
            if collect:
                preds_all.append((g, {k: v.cpu().numpy() for k, v in preds.items()}))
        agg: Dict[str, float] = {}
        if aggs:
            keys = list(aggs[0])
            host = torch.stack([torch.stack([d[k] for k in keys]) for d in aggs]).cpu()
            for i, k in enumerate(keys):
                agg[k] = float(host[:, i].double().mean())
        loss = float(torch.stack(losses).double().mean().cpu()) if losses else 0.0
        return (loss, agg, preds_all) if collect else (loss, agg)

    def fit(self, data_module, max_epochs: Optional[int] = None,
            checkpoint: bool = True) -> float:
        max_epochs = max_epochs or self.max_epochs
        rng = np.random.default_rng(666)
        best_val = float("inf")
        with (open(self._log_path, "a") if self.primary
              else contextlib.nullcontext()) as log_f:
            for epoch in range(max_epochs):
                t0 = time.time()
                train_loss = self.train_epoch(data_module.train_batches(rng))
                val_loss, val_logs = self.eval_epoch(data_module.val_batches())
                lr = self.sched.step(val_loss)
                record = {
                    "epoch": epoch,
                    "train_loss": train_loss,
                    "val_loss": val_loss,
                    "lr": lr,
                    "sec": time.time() - t0,
                    **{f"val/{k}": v for k, v in val_logs.items()},
                }
                if self.nonfinite_steps:
                    record["nonfinite_steps"] = self.nonfinite_steps
                if log_f is not None:
                    log_f.write(json.dumps(record) + "\n")
                    log_f.flush()
                if val_loss < best_val:
                    best_val = val_loss
                    if checkpoint and self.primary:
                        self.save_checkpoint(os.path.join(self.train_dir, "best.pt"))
                if epoch >= self.min_epochs and self.stopper.step(val_loss):
                    break
        return best_val

    # --- checkpointing ---------------------------------------------------

    def save_checkpoint(self, path: str) -> None:
        torch.save({
            "params": {n: p.detach().cpu() for n, p in self.model.named_parameters()},
            "opt_state": {k: v.cpu() for k, v in self.opt.state_dict().items()},
            "lr": float(self.sched.lr),
        }, path)

    def load_checkpoint(self, path: str) -> None:
        """A checkpoint of this trainer, or an orbax directory of the JAX
        trainer (its parameters, amsgrad state and learning rate; the
        moments reordered from jax's leaf order into this model's)."""
        if os.path.isdir(path):
            from ..interfaces.jax_params import load_flax_params
            from ..interfaces.orbax_reader import trainer_checkpoint

            params, state, lr = trainer_checkpoint(path, self.model)
            load_flax_params(self.model, params)
            self.opt.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
            self.sched.lr = lr
            return
        ckpt = torch.load(path, map_location=self.device)
        load_params(self.model, ckpt["params"])
        self.opt.load_state_dict(ckpt["opt_state"])
        self.sched.lr = float(ckpt["lr"])


def load_params(model: torch.nn.Module, params: Dict[str, torch.Tensor]) -> None:
    """Copy named tensors into ``model``'s parameters in place (the flat
    views stay); raises on a missing or extra name or a shape mismatch."""
    own = dict(model.named_parameters())
    if set(own) != set(params):
        raise KeyError(f"checkpoint parameters do not match the model: missing "
                       f"{sorted(set(own) - set(params))[:5]}, extra "
                       f"{sorted(set(params) - set(own))[:5]}")
    with torch.no_grad():
        for name, p in own.items():
            src = params[name]
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: checkpoint shape {tuple(src.shape)}, "
                                 f"model shape {tuple(p.shape)}")
            p.copy_(src)
