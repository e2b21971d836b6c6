"""Equivariant linear layers (e3nn ``o3.Linear`` semantics), counterpart of
``hamgnn_tpu/e3/linear.py``.

One flat weight ``w`` per layer (N(0, 1), scaled by 1/sqrt(fan_in) at apply
time); per output chunk, the input chunks of the same irrep are mixed by one
matmul.  Output chunks with no matching input irrep are zero.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .irreps import Irreps
from .packed_tp import get_plan


class Linear(nn.Module):
    def __init__(self, irreps_in, irreps_out):
        super().__init__()
        self.irreps_in = Irreps(irreps_in)
        self.irreps_out = Irreps(irreps_out)
        self._in_slices = self.irreps_in.slices()
        plans = []
        total = 0
        for mio in self.irreps_out:
            sources = [i for i, mi in enumerate(self.irreps_in) if mi.ir == mio.ir]
            fan_in = sum(self.irreps_in[i].mul for i in sources)
            plans.append((sources, fan_in, total))
            total += fan_in * mio.mul
        self._plans = plans
        self.weight_size = total
        if total > 0:
            self.w = nn.Parameter(torch.zeros(total))
        else:
            self.register_parameter("w", None)

    def forward(self, x):
        out_chunks = []
        for k, mio in enumerate(self.irreps_out):
            sources, fan_in, ofs = self._plans[k]
            if fan_in == 0:
                out_chunks.append(x.new_zeros(x.shape[:-1] + (mio.dim,)))
                continue
            w = self.w[ofs : ofs + fan_in * mio.mul].reshape(fan_in, mio.mul)
            xs = []
            for i in sources:
                mi = self.irreps_in[i]
                c = x[..., self._in_slices[i]]
                xs.append(c.reshape(c.shape[:-1] + (mi.mul, mi.ir.dim)))
            xin = torch.cat(xs, dim=-2) if len(xs) > 1 else xs[0]
            y = torch.einsum("...ui,uv->...vi", xin, w / np.sqrt(fan_in))
            out_chunks.append(y.reshape(y.shape[:-2] + (mio.dim,)))
        return torch.cat(out_chunks, dim=-1)

    def packed_tp_call(self, tp_irreps_in, tp_irreps_sh, x, sh):
        """Fused TP -> this Linear (no radial scale) through the packed
        pipeline, with the TP's target irreps = this layer's output."""
        out = repr(self.irreps_out)
        plan = get_plan(repr(Irreps(tp_irreps_in)), repr(Irreps(tp_irreps_sh)),
                        out, out)
        if plan.linear_numel != self.weight_size:
            raise ValueError("packed plan does not match this Linear's weights")
        return plan(x, sh, None, self.w)


class ElementwiseChannelScale(nn.Module):
    """Scale each irrep channel by a per-sample scalar, then an equivariant
    Linear (the reference's ``LinearScaleWithWeights``)."""

    def __init__(self, irreps_in, irreps_out):
        super().__init__()
        self.irreps_in = Irreps(irreps_in)
        self.irreps_out = Irreps(irreps_out)
        self.linear_out = Linear(self.irreps_in, self.irreps_out)
        idx = []
        ch = 0
        for mi in self.irreps_in:
            for _ in range(mi.mul):
                idx.extend([ch] * mi.ir.dim)
                ch += 1
        self.register_buffer("_expand", torch.as_tensor(idx, dtype=torch.long),
                             persistent=False)

    @property
    def weight_numel(self) -> int:
        return self.irreps_in.num_irreps

    def forward(self, x, weight):
        """x: (..., irreps_in.dim); weight: (..., num_irreps)."""
        return self.linear_out(x * weight[..., self._expand])

    def packed_plan(self, tp_irreps_in, tp_irreps_sh, target_irreps=None):
        target = Irreps(target_irreps if target_irreps is not None
                        else self.irreps_out)
        plan = get_plan(repr(Irreps(tp_irreps_in)), repr(Irreps(tp_irreps_sh)),
                        repr(target), repr(self.irreps_out))
        if plan.weight_numel != self.weight_numel:
            raise ValueError(
                f"packed plan has {plan.weight_numel} scale channels, "
                f"scaler expects {self.weight_numel}")
        return plan

    def packed_tp_call(self, tp_irreps_in, tp_irreps_sh, x, sh, weight,
                       target_irreps=None, weight_packed=False):
        """Fused TP -> per-channel radial scale -> linear_out through the
        packed pipeline.  ``weight_packed``: the radial generator already
        emits packed channel order (``make_weight_generator(out_perm=...)``)."""
        plan = self.packed_plan(tp_irreps_in, tp_irreps_sh, target_irreps)
        if plan.linear_numel != self.linear_out.weight_size:
            raise ValueError("packed plan does not match linear_out weights")
        if not weight_packed:
            weight = weight[..., torch.as_tensor(plan.scale_perm, dtype=torch.long,
                                                 device=weight.device)]
        return plan(x, sh, weight, self.linear_out.w)
