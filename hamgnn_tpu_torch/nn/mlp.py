"""Scalar MLPs, counterpart of ``hamgnn_tpu/nn/mlp.py``.

``FullyConnectedNet``: e3nn-style, weights N(0, 1) scaled by 1/sqrt(fan_in)
at apply time, normalised hidden activations, no biases, linear last layer.
The KAN generator waits for a later slice.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..e3.gate import act


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
        perm = None if out_perm is None else torch.as_tensor(
            np.asarray(out_perm), dtype=torch.long)
        self.register_buffer("out_perm", perm, persistent=False)

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


def make_weight_generator(input_dim: int, hidden: Sequence[int], output_dim: int,
                          use_kan: bool = False, out_perm=None):
    if use_kan:
        raise NotImplementedError("KAN radial generators are not ported yet")
    return FullyConnectedNet([input_dim, *hidden, output_dim], act_name="silu",
                             out_perm=out_perm)
