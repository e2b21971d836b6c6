"""Radial basis functions and cutoff envelopes, counterpart of
``hamgnn_tpu/nn/radial.py``."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn


def smooth_cutoff(x, cutoff: float):
    """C-inf bump: exp(-x^2/((c-x)(c+x))) inside, 0 outside."""
    inside = x < cutoff
    x_ = torch.where(inside, x, torch.zeros_like(x))
    val = torch.exp(-(x_**2) / ((cutoff - x_) * (cutoff + x_)))
    return torch.where(inside, val, torch.zeros_like(val))


def cosine_cutoff(r, cutoff: float):
    return 0.5 * (torch.cos(r * math.pi / cutoff) + 1.0) * (r < cutoff)


def polynomial_envelope(x, cutoff: float, p: int = 6):
    a = -(p + 1) * (p + 2) / 2
    b = p * (p + 2)
    c = -p * (p + 1) / 2
    xs = x / cutoff
    xp = xs**p
    return (1.0 + a * xp + b * xp * xs + c * xp * xs * xs) * (xs < 1.0)


def softplus_inverse(x: float) -> float:
    return float(x + np.log(-np.expm1(-x)))


class SoftUnitStepCutoff(nn.Module):
    """soft_unit_step(k * (1 - r/c)) with a trainable sharpness k (init 10):
    exp(-1/x) for x > 0, else 0."""

    def __init__(self, cutoff: float):
        super().__init__()
        self.cutoff = cutoff
        self.cut_param = nn.Parameter(torch.tensor(10.0))

    def forward(self, r):
        x = self.cut_param * (1.0 - r / self.cutoff)
        pos = x > 0
        # the inner where keeps exp(-1/x) off x <= 0: its gradient there
        # would be NaN, and 0 * NaN stays NaN in the backward
        safe = torch.where(pos, x, torch.ones_like(x))
        return torch.where(pos, torch.exp(-1.0 / safe), torch.zeros_like(x))


def _log_binomial(n: int) -> np.ndarray:
    logf = np.zeros(n)
    for i in range(2, n):
        logf[i] = logf[i - 1] + np.log(i)
    v = np.arange(n)
    return logf[-1] - logf[v] - logf[n - 1 - v]


class BesselBasis(nn.Module):
    """2/c * sin(n pi r / c) / r with trainable frequencies (init n pi)."""

    def __init__(self, cutoff: float, num_basis: int = 8, trainable: bool = True):
        super().__init__()
        self.cutoff = cutoff
        init = torch.as_tensor(
            np.linspace(1.0, num_basis, num_basis) * math.pi, dtype=torch.float32)
        if trainable:
            self.bessel_weights = nn.Parameter(init)
        else:
            self.register_buffer("bessel_weights", init, persistent=False)

    def forward(self, r):
        r = r[..., None]
        return (2.0 / self.cutoff) * torch.sin(self.bessel_weights * r / self.cutoff) / r


class GaussianSmearing(nn.Module):
    def __init__(self, start: float = 0.0, stop: float = 5.0, num_gaussians: int = 50):
        super().__init__()
        self.start, self.stop, self.num_gaussians = start, stop, num_gaussians

    def forward(self, r):
        offset = torch.linspace(self.start, self.stop, self.num_gaussians,
                                dtype=r.dtype, device=r.device)
        coeff = -0.5 / float((self.stop - self.start) / (self.num_gaussians - 1)) ** 2
        d = r[..., None] - offset
        return torch.exp(coeff * d * d)


class BernsteinRadialBasis(nn.Module):
    def __init__(self, num_basis: int, cutoff: float):
        super().__init__()
        self.num_basis, self.cutoff = num_basis, cutoff

    def forward(self, r):
        logc = torch.as_tensor(_log_binomial(self.num_basis), dtype=r.dtype, device=r.device)
        v = torch.arange(self.num_basis, dtype=r.dtype, device=r.device)
        n = (self.num_basis - 1) - v
        x = torch.log(torch.clamp(r[..., None] / self.cutoff, min=1e-12))
        x = logc + n * x + v * torch.log(-torch.expm1(torch.clamp(x, max=-1e-7)))
        return smooth_cutoff(r, self.cutoff)[..., None] * torch.exp(x)


class ExponentialBernsteinRadialBasis(nn.Module):
    def __init__(self, num_basis: int, cutoff: float, ini_alpha: float = 0.5):
        super().__init__()
        self.num_basis, self.cutoff = num_basis, cutoff
        self._alpha = nn.Parameter(torch.tensor(softplus_inverse(ini_alpha)))

    def forward(self, r):
        alpha = torch.nn.functional.softplus(self._alpha)
        logc = torch.as_tensor(_log_binomial(self.num_basis), dtype=r.dtype, device=r.device)
        v = torch.arange(self.num_basis, dtype=r.dtype, device=r.device)
        n = (self.num_basis - 1) - v
        x = -alpha * r[..., None]
        x = logc + n * x + v * torch.log(-torch.expm1(torch.clamp(x, max=-1e-7)))
        return smooth_cutoff(r, self.cutoff)[..., None] * torch.exp(x)


class ExponentialGaussianRadialBasis(nn.Module):
    def __init__(self, num_basis: int, cutoff: float, ini_alpha: float = 0.5):
        super().__init__()
        self.num_basis, self.cutoff = num_basis, cutoff
        self._alpha = nn.Parameter(torch.tensor(softplus_inverse(ini_alpha)))

    def forward(self, r):
        alpha = torch.nn.functional.softplus(self._alpha)
        center = torch.linspace(1.0, 0.0, self.num_basis, dtype=r.dtype, device=r.device)
        d = torch.exp(-alpha * r[..., None]) - center
        return smooth_cutoff(r, self.cutoff)[..., None] * torch.exp(-float(self.num_basis) * d * d)


class GaussianRadialBasis(nn.Module):
    def __init__(self, num_basis: int, cutoff: float):
        super().__init__()
        self.num_basis, self.cutoff = num_basis, cutoff

    def forward(self, r):
        center = torch.linspace(0.0, self.cutoff, self.num_basis, dtype=r.dtype, device=r.device)
        width = self.num_basis / self.cutoff
        d = r[..., None] - center
        return smooth_cutoff(r, self.cutoff)[..., None] * torch.exp(-width * d * d)


RBF_REGISTRY = {
    "bessel": lambda num, cutoff, **kw: BesselBasis(cutoff=cutoff, num_basis=num, **kw),
    "gaussian": lambda num, cutoff, **kw: GaussianSmearing(start=0.0, stop=cutoff, num_gaussians=num, **kw),
    "exp-gaussian": lambda num, cutoff, **kw: ExponentialGaussianRadialBasis(num_basis=num, cutoff=cutoff, **kw),
    "exp-bernstein": lambda num, cutoff, **kw: ExponentialBernsteinRadialBasis(num_basis=num, cutoff=cutoff, **kw),
    "bernstein": lambda num, cutoff, **kw: BernsteinRadialBasis(num_basis=num, cutoff=cutoff, **kw),
}
