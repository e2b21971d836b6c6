"""Equivariant nonlinearities: Gate, NormActivation and scalar activations,
counterpart of ``hamgnn_tpu/e3/gate.py``.

Scalar activations are normalised to unit second moment under a standard
normal input (e3nn's ``normalize2mom``) with constants computed once by
Gauss-Hermite quadrature.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict

import numpy as np
import torch
from torch import nn

from .irreps import Irreps, irreps2gate


def _ssp_np(x):
    return np.logaddexp(x, 0.0) - math.log(2.0)


@functools.lru_cache(maxsize=None)
def _second_moment(name: str) -> float:
    """1 / E[f(z)^2]^(1/2) for z ~ N(0,1)."""
    fns = {
        "ssp": _ssp_np,
        "tanh": np.tanh,
        "abs": np.abs,
        "silu": lambda x: x / (1.0 + np.exp(-x)),
    }
    f = fns[name]
    x, w = np.polynomial.hermite_e.hermegauss(101)
    m2 = float(np.sum(w * f(x) ** 2) / np.sum(w))
    return float(1.0 / np.sqrt(m2))


def shifted_softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device)) \
        - math.log(2.0)


_RAW_ACTS: Dict[str, Callable] = {
    "ssp": shifted_softplus,
    "tanh": torch.tanh,
    "abs": torch.abs,
    "silu": lambda x: x * torch.reciprocal(1.0 + torch.exp(-x)),
}


def act(name: str, normalized: bool = True) -> Callable:
    f = _RAW_ACTS[name]
    if not normalized:
        return f
    c = _second_moment(name)
    return lambda x: c * f(x)


class Gate(nn.Module):
    """Input [scalars | gates | gated] -> [act(scalars) | act(gates) * gated]."""

    def __init__(self, irreps_scalars, irreps_gates, irreps_gated,
                 act_scalars, act_gates):
        super().__init__()
        self.irreps_scalars = Irreps(irreps_scalars)
        self.irreps_gates = Irreps(irreps_gates)
        self.irreps_gated = Irreps(irreps_gated)
        self.act_scalars = tuple(act_scalars)
        self.act_gates = tuple(act_gates)
        idx = []
        ch = 0
        for mi in self.irreps_gated:
            for _ in range(mi.mul):
                idx.extend([ch] * mi.ir.dim)
                ch += 1
        self.register_buffer("_expand", torch.as_tensor(idx, dtype=torch.long),
                             persistent=False)

    @property
    def irreps_in(self) -> Irreps:
        return self.irreps_scalars + self.irreps_gates + self.irreps_gated

    @property
    def irreps_out(self) -> Irreps:
        return (self.irreps_scalars + self.irreps_gated).simplify()

    def forward(self, x):
        ds, dg = self.irreps_scalars.dim, self.irreps_gates.dim
        scalars = x[..., :ds]
        gates = x[..., ds : ds + dg]
        gated = x[..., ds + dg :]
        out = [act(name)(scalars[..., sl])
               for sl, name in zip(self.irreps_scalars.slices(), self.act_scalars)]
        if self.irreps_gated.dim > 0:
            out_g = [act(name)(gates[..., sl])
                     for sl, name in zip(self.irreps_gates.slices(), self.act_gates)]
            g = torch.cat(out_g, dim=-1) if out_g else gates
            out.append(gated * g[..., self._expand])
        return torch.cat(out, dim=-1)


class NormActivation(nn.Module):
    """Scale each channel by f(|x_u|) / |x_u|."""

    def __init__(self, irreps_in, scalar_nonlinearity: str = "ssp",
                 epsilon: float = 1e-8):
        super().__init__()
        self.irreps_in = Irreps(irreps_in)
        self.scalar_nonlinearity = scalar_nonlinearity
        self.epsilon = epsilon

    def forward(self, x):
        f = act(self.scalar_nonlinearity)
        chunks = []
        for sl, mi in zip(self.irreps_in.slices(), self.irreps_in):
            c = x[..., sl].reshape(x.shape[:-1] + (mi.mul, mi.ir.dim))
            n = torch.sqrt(torch.sum(c * c, dim=-1, keepdim=True) + self.epsilon**2)
            c = c * (f(n) / n)
            chunks.append(c.reshape(x.shape[:-1] + (mi.dim,)))
        return torch.cat(chunks, dim=-1)


def make_gate(irreps_mid, nonlinearity_scalars=("ssp", "tanh"),
              nonlinearity_gates=("ssp", "abs")):
    """Gate for the target irreps; returns (gate, irreps_in it requires)."""
    irreps_scalars, irreps_gates, irreps_gated = irreps2gate(irreps_mid)
    sc_e, sc_o = nonlinearity_scalars
    g_e, g_o = nonlinearity_gates
    gate = Gate(
        irreps_scalars, irreps_gates, irreps_gated,
        act_scalars=tuple(sc_e if mi.ir.p == 1 else sc_o for mi in irreps_scalars),
        act_gates=tuple(g_e if mi.ir.p == 1 else g_o for mi in irreps_gates),
    )
    return gate, gate.irreps_in
