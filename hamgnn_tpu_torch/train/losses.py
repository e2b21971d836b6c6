"""Masked loss/metric registry, counterpart of ``hamgnn_tpu/train/losses.py``.

All metrics are masked means: padded rows never contribute, so a padded batch
gives the reference's variable-size means exactly.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch


def _masked_mean(x, mask):
    w = torch.broadcast_to(mask.to(x.dtype), x.shape)
    return torch.sum(x * w) / torch.clamp(torch.sum(w), min=1.0)


def mae(pred, target, mask):
    return _masked_mean(torch.abs(pred - target), mask)


def mse(pred, target, mask):
    return _masked_mean((pred - target) ** 2, mask)


def rmse(pred, target, mask):
    return torch.sqrt(mse(pred, target, mask))


def cosine_similarity(pred, target, mask):
    dot = torch.sum(pred * target, dim=-1)
    pn = torch.linalg.norm(pred, dim=-1)
    tn = torch.linalg.norm(target, dim=-1)
    per_row = 1.0 - dot / torch.clamp(pn * tn, min=1e-12)
    m = mask.squeeze(-1) if mask.ndim == per_row.ndim + 1 else mask
    return _masked_mean(per_row, m)


def euclidean(pred, target, mask):
    d = torch.sqrt(torch.sum((pred - target) ** 2, dim=-1))
    m = mask.squeeze(-1) if mask.ndim == d.ndim + 1 else mask
    return _masked_mean(d, m)


def sum_zero(pred, target, mask):
    s = torch.sum(pred * torch.broadcast_to(mask.to(pred.dtype), pred.shape), dim=0)
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
