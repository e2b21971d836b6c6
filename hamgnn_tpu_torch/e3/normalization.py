"""Equivariant layer normalisation, counterpart of
``hamgnn_tpu/e3/normalization.py``: per chunk, scalars lose their mean over
the channels, every channel is divided by the RMS of its norm over the
chunk, then scaled by a per-channel weight ``w<i>`` (initial value one), and
the scalar chunks shifted by a bias ``b<j>`` (initial value zero)."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .irreps import Irreps


class E3LayerNorm(nn.Module):
    def __init__(self, irreps_in, eps: float = 1e-5, affine: bool = True,
                 subtract_mean: bool = True, divide_norm: bool = False,
                 normalization: str = "component"):
        super().__init__()
        self.irreps = Irreps(irreps_in)
        self.eps, self.affine = eps, affine
        self.subtract_mean, self.divide_norm = subtract_mean, divide_norm
        self.normalization = normalization
        self._affine = []   # per chunk: (weight name, bias name or None)
        w_idx = b_idx = 0
        for mul, ir in self.irreps:
            if not affine:
                self._affine.append((None, None))
                continue
            self.register_parameter(f"w{w_idx}", nn.Parameter(torch.ones(mul)))
            bias = None
            if ir.l == 0:
                bias = f"b{b_idx}"
                self.register_parameter(bias, nn.Parameter(torch.zeros(mul)))
                b_idx += 1
            self._affine.append((f"w{w_idx}", bias))
            w_idx += 1

    def draw_parameters(self, gen: torch.Generator) -> None:
        """The affine weights start at one and the biases at zero: nothing
        is drawn."""
        with torch.no_grad():
            for w, b in self._affine:
                if w is not None:
                    getattr(self, w).fill_(1.0)
                if b is not None:
                    getattr(self, b).zero_()

    def forward(self, x):
        out = []
        for sl, (mul, ir), (w, b) in zip(self.irreps.slices(), self.irreps, self._affine):
            c = x[..., sl].reshape(x.shape[:-1] + (mul, ir.dim))
            if self.subtract_mean and ir.l == 0:
                c = c - c.mean(dim=-2, keepdim=True)
            norm2 = (c * c).sum(dim=-1).mean(dim=-1, keepdim=True)
            if self.normalization == "component":
                norm2 = norm2 / ir.dim
            field_norm = torch.reciprocal(torch.sqrt(norm2 + self.eps))
            if self.divide_norm:
                field_norm = field_norm / np.sqrt(ir.dim)
            c = c * field_norm[..., None]
            if w is not None:
                c = c * getattr(self, w)[:, None]
            if b is not None:
                c = c + getattr(self, b)[:, None]
            out.append(c.reshape(x.shape[:-1] + (mul * ir.dim,)))
        return torch.cat(out, dim=-1)
