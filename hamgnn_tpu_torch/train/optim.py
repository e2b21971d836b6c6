"""The optimizer of the JAX trainer, written for one flat fp32 vector.

``hamgnn_tpu/train/trainer.py`` updates the raveled parameter vector with
``optax.chain(optax.clip_by_global_norm(c), optax.amsgrad(learning_rate=1.0))``
(the clip only when c > 0) and applies the plateau learning rate as
``p + update * lr``.  ``Amsgrad`` is that rule, operation for operation, in
float32 on whatever device the vector lives:

    g       <- g if |g| < c else g / |g| * c           (clip, c > 0)
    mu      <- (1 - b1) g + b1 mu          (one rounding, as XLA fuses it)
    nu      <- (1 - b2) g^2 + b2 nu
    count   <- count + 1
    nu_max  <- max(nu_max, nu / (1 - b2^count))
    update  <- -(mu / (1 - b1^count)) / (sqrt(nu_max) + eps)
    p       <- p + update * lr

``torch.optim.AdamW(amsgrad=True)`` is not this rule: it takes the maximum of
the second moment before the bias correction, optax after it.

``flatten_parameters`` turns a module's parameters into views of one flat
buffer (and their gradients into views of another), so the update is a
handful of elementwise launches over one vector, not hundreds of small ones.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn


def flatten_parameters(model: nn.Module) -> Tuple[torch.Tensor, torch.Tensor]:
    """Move every parameter of ``model`` into one flat fp32 buffer, in
    ``model.parameters()`` order, and give each a gradient that is a view of
    a second flat buffer; returns (flat parameters, flat gradients).

    Autograd accumulates into an existing ``.grad`` in place, so a backward
    fills the flat gradient directly; zero it before each step.  Moving the
    model to another device afterwards would break the views."""
    params = list(model.parameters())
    if not params:
        raise ValueError("the model has no parameters")
    device = params[0].device
    n = sum(p.numel() for p in params)
    flat = torch.empty(n, dtype=torch.float32, device=device)
    grad = torch.zeros(n, dtype=torch.float32, device=device)
    ofs = 0
    with torch.no_grad():
        for p in params:
            if p.dtype != torch.float32 or p.device != device:
                raise ValueError("flat parameters must be float32 on one device")
            k = p.numel()
            flat[ofs : ofs + k].copy_(p.reshape(-1))
            p.data = flat[ofs : ofs + k].view_as(p)
            p.grad = grad[ofs : ofs + k].view_as(p)
            ofs += k
    return flat, grad


def _fma(a: float, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """round32(a * x + c) with one rounding, as XLA fuses optax's moment
    update ``(1 - decay) * g + decay * m``: the float32 product is exact in
    float64, so the sum is rounded once (to float64, then float32)."""
    return (a * x.double() + c.double()).float()


class Amsgrad:
    """optax's clip_by_global_norm + amsgrad over one flat vector.

    State (all on the vector's device): ``count`` (int32 scalar), ``mu``,
    ``nu``, ``nu_max``.  ``step`` updates the parameters and the state in
    place and returns a device bool: whether the step was taken.  A step
    whose loss or gradient is not finite is dropped on the device, with no
    host sync: the parameters and every state tensor, the count included,
    stay as they were (the JAX trainer's guard)."""

    def __init__(self, numel: int, device, gradient_clip_val: float = 0.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.clip = float(gradient_clip_val)
        self.b1, self.b2, self.eps = b1, b2, eps
        zeros = lambda: torch.zeros(numel, dtype=torch.float32, device=device)  # noqa: E731
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        self.mu, self.nu, self.nu_max = zeros(), zeros(), zeros()
        self._b1 = torch.tensor(b1, dtype=torch.float32, device=device)
        self._b2 = torch.tensor(b2, dtype=torch.float32, device=device)
        # 1 - b as the float32 scalar optax multiplies by
        self._a1 = float(np.float32(1 - b1))
        self._a2 = float(np.float32(1 - b2))

    def update(self, g: torch.Tensor):
        """The unit-LR update and the new state for gradient ``g``, without
        touching the current state (optax's ``tx.update``)."""
        if self.clip > 0:
            g_norm = torch.sqrt(torch.sum(g * g))
            g = torch.where(g_norm < self.clip, g, (g / g_norm) * self.clip)
        mu = _fma(self._a1, g, self.b1 * self.mu)
        nu = _fma(self._a2, g * g, self.b2 * self.nu)
        count = self.count + 1
        c = count.to(torch.float32)
        mu_hat = mu / (1 - torch.pow(self._b1, c))
        nu_hat = nu / (1 - torch.pow(self._b2, c))
        nu_max = torch.maximum(self.nu_max, nu_hat)
        upd = -1.0 * (mu_hat / (torch.sqrt(nu_max) + self.eps))
        return upd, (count, mu, nu, nu_max)

    def step(self, params: torch.Tensor, grad: torch.Tensor, lr: float,
             loss: torch.Tensor = None) -> torch.Tensor:
        ok = torch.all(torch.isfinite(grad))
        if loss is not None:
            ok = ok & torch.isfinite(loss)
        g = torch.where(ok, grad, torch.zeros_like(grad))
        upd, new = self.update(g)
        scale = torch.where(ok, torch.tensor(lr, dtype=torch.float32, device=ok.device),
                            torch.zeros((), dtype=torch.float32, device=ok.device))
        with torch.no_grad():
            params.add_(upd * scale)
            for old, fresh in zip((self.count, self.mu, self.nu, self.nu_max), new):
                old.copy_(torch.where(ok, fresh, old))
        return ok

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {"count": self.count, "mu": self.mu, "nu": self.nu,
                "nu_max": self.nu_max}

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        for key, t in self.state_dict().items():
            src = state[key]
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"optimizer state {key}: shape {tuple(src.shape)}, "
                                 f"expected {tuple(t.shape)}")
            t.copy_(src)
