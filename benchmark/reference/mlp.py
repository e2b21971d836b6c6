# Frozen copy of hamgnn_tpu_torch/nn/mlp.py, with its imports rewritten.
"""Scalar MLPs, counterpart of ``hamgnn_tpu/nn/mlp.py``.

``FullyConnectedNet``: e3nn-style, weights N(0, 1) scaled by 1/sqrt(fan_in)
at apply time, normalised hidden activations, no biases, linear last layer.
``KANLinear`` / ``KAN``: the efficient-KAN B-spline layer on a fixed grid
(3 intervals on [-1, 1], cubic), evaluated as a dense basis expansion and
one product.  ``make_weight_generator`` builds either; its owner names the
attribute after the generator's class (``FullyConnectedNet_<i>`` or
``KAN_<i>``), as flax names it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from .gate import act


class FullyConnectedNet(nn.Module):
    """``out_perm``: static permutation applied as a view of the stored last
    weight's columns (output k reads column out_perm[k]), so the stored
    parameter keeps the reference channel order and copies verbatim."""

    def __init__(self, hs: Sequence[int], act_name: str = "silu",
                 out_perm: Optional[Sequence[int]] = None):
        super().__init__()
        self.hs = tuple(int(h) for h in hs)
        self.act_name = act_name
        for i in range(len(self.hs) - 1):
            self.register_parameter(
                f"w{i}", nn.Parameter(torch.zeros(self.hs[i], self.hs[i + 1])))
        self.register_buffer("out_perm", _perm_buffer(out_perm), persistent=False)

    def forward(self, x):
        f = act(self.act_name)
        n = len(self.hs) - 1
        for i in range(n):
            w = getattr(self, f"w{i}")
            if i == n - 1 and self.out_perm is not None:
                w = w[:, self.out_perm]
            x = x @ (w / np.sqrt(self.hs[i]))
            if i < n - 1:
                x = f(x)
        return x


def _perm_buffer(out_perm):
    return None if out_perm is None else torch.as_tensor(np.asarray(out_perm),
                                                         dtype=torch.long)


class KANLinear(nn.Module):
    """y = silu(x) @ base_weight + B(x) @ spline_weight, with B the cubic
    B-spline bases over 3 half-open intervals of [-1, 1] (the reference's
    fixed grid, no grid updates).  ``out_perm`` permutes the columns of both
    weights, as ``FullyConnectedNet``'s last layer."""

    GRID_SIZE, SPLINE_ORDER, GRID_RANGE = 3, 3, (-1.0, 1.0)

    def __init__(self, in_features: int, out_features: int,
                 out_perm: Optional[Sequence[int]] = None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        k = self.SPLINE_ORDER
        self.n_b = self.GRID_SIZE + k
        g0, g1 = self.GRID_RANGE
        h = (g1 - g0) / self.GRID_SIZE
        grid = np.arange(-k, self.GRID_SIZE + k + 1) * h + g0
        self.register_buffer("grid", torch.as_tensor(grid, dtype=torch.float32),
                             persistent=False)
        self.base_weight = nn.Parameter(torch.zeros(in_features, out_features))
        self.spline_weight = nn.Parameter(torch.zeros(in_features * self.n_b, out_features))
        self.register_buffer("out_perm", _perm_buffer(out_perm), persistent=False)

    def draw_parameters(self, gen: torch.Generator) -> None:
        """flax's variance_scaling(1/3, "fan_in", "uniform"): U(-a, a) with
        a = 1 / sqrt(fan_in), fan_in the weight's row count."""
        for p in (self.base_weight, self.spline_weight):
            a = 1.0 / np.sqrt(p.shape[0])
            p.copy_((torch.rand(p.shape, generator=gen) * 2.0 - 1.0) * a)

    def b_splines(self, x):
        """x: (..., in) -> (..., in, grid_size + spline_order) basis values."""
        grid = self.grid.to(x.dtype)
        xx = x[..., None]
        bases = ((xx >= grid[:-1]) & (xx < grid[1:])).to(x.dtype)
        for p in range(1, self.SPLINE_ORDER + 1):
            left = (xx - grid[: -(p + 1)]) / (grid[p:-1] - grid[: -(p + 1)]) * bases[..., :-1]
            right = (grid[p + 1:] - xx) / (grid[p + 1:] - grid[1:-p]) * bases[..., 1:]
            bases = left + right
        return bases

    def forward(self, x):
        base_w, spline_w = self.base_weight, self.spline_weight
        if self.out_perm is not None:
            base_w, spline_w = base_w[:, self.out_perm], spline_w[:, self.out_perm]
        silu = x * torch.reciprocal(1.0 + torch.exp(-x))
        b = self.b_splines(x).reshape(*x.shape[:-1], self.in_features * self.n_b)
        return silu @ base_w + b @ spline_w


class KAN(nn.Module):
    """A stack of ``KANLinear_<i>``; ``out_perm`` applies to the last."""

    def __init__(self, hs: Sequence[int], out_perm: Optional[Sequence[int]] = None):
        super().__init__()
        self.hs = tuple(int(h) for h in hs)
        n = len(self.hs) - 1
        for i in range(n):
            self.add_module(f"KANLinear_{i}", KANLinear(
                self.hs[i], self.hs[i + 1], out_perm=out_perm if i == n - 1 else None))

    def forward(self, x):
        for layer in self.children():
            x = layer(x)
        return x


def make_weight_generator(input_dim: int, hidden: Sequence[int], output_dim: int,
                          use_kan: bool = False, out_perm=None):
    hs = [input_dim, *hidden, output_dim]
    if use_kan:
        return KAN(hs, out_perm=out_perm)
    return FullyConnectedNet(hs, act_name="silu", out_perm=out_perm)


def add_generator(owner: nn.Module, index: int, generator: nn.Module) -> str:
    """Register ``generator`` on ``owner`` under flax's automatic name,
    ``<class>_<index>``, and return that name."""
    name = f"{type(generator).__name__}_{index}"
    owner.add_module(name, generator)
    return name
