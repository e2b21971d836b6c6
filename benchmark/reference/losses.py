# Frozen copy of hamgnn_tpu_torch/train/losses.py, with its imports rewritten.
"""Masked loss/metric registry, counterpart of ``hamgnn_tpu/train/losses.py``.

All metrics are masked means: padded rows never contribute, so a padded batch
gives the reference's variable-size means exactly.

Every metric takes a ``psum`` reduction hook, the identity by default.  Under
the halo edge partition each rank holds a disjoint subset of the rows;
``view.psum`` sums the numerator and the denominator over the partition, so
the masked means are the global ones (rows replicated on every rank, such as
band energies, come out right too: the rank count cancels).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch


def _identity(x):
    return x


def _masked_mean(x, mask, psum=_identity):
    w = torch.broadcast_to(mask.to(x.dtype), x.shape)
    return psum(torch.sum(x * w)) / torch.clamp(psum(torch.sum(w)), min=1.0)


def mae(pred, target, mask, psum=_identity):
    return _masked_mean(torch.abs(pred - target), mask, psum)


def mse(pred, target, mask, psum=_identity):
    return _masked_mean((pred - target) ** 2, mask, psum)


def rmse(pred, target, mask, psum=_identity):
    return torch.sqrt(mse(pred, target, mask, psum))


def cosine_similarity(pred, target, mask, psum=_identity):
    dot = torch.sum(pred * target, dim=-1)
    pn = torch.linalg.norm(pred, dim=-1)
    tn = torch.linalg.norm(target, dim=-1)
    per_row = 1.0 - dot / torch.clamp(pn * tn, min=1e-12)
    m = mask.squeeze(-1) if mask.ndim == per_row.ndim + 1 else mask
    return _masked_mean(per_row, m, psum)


def euclidean(pred, target, mask, psum=_identity):
    d = torch.sqrt(torch.sum((pred - target) ** 2, dim=-1))
    m = mask.squeeze(-1) if mask.ndim == d.ndim + 1 else mask
    return _masked_mean(d, m, psum)


def sum_zero(pred, target, mask, psum=_identity):
    s = psum(torch.sum(pred * torch.broadcast_to(mask.to(pred.dtype), pred.shape), dim=0))
    return torch.sqrt(torch.sum(s**2, dim=-1))


METRICS: Dict[str, Callable] = {
    "mae": mae,
    "mse": mse,
    "rmse": rmse,
    "cosine_similarity": cosine_similarity,
    "euclidean_loss": euclidean,
    "sum_zero": sum_zero,
}


def get_metric(name: str) -> Callable:
    return METRICS[name.lower()]
