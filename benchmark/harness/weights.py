"""The weights of a run, made on the device from the seed.

Every leaf named ``w`` or ``w<digits>`` (the equivariant Linears' and the
radial MLPs' weights) is drawn N(0, 1), as the reference model draws them,
from one ``torch.Generator`` on the device in one call, in the order of the
leaves' names (so the order a model lists them in does not matter); the Bessel
frequencies ``bessel_weights`` take their fixed initial values n pi.  Both
the program and the reference are given the same tensors.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch


def is_drawn(name: str) -> bool:
    leaf = name.rsplit(".", 1)[-1]
    return leaf == "w" or (leaf[0] == "w" and leaf[1:].isdigit())


def make_weights(leaves: Sequence[Tuple[str, Tuple[int, ...]]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for every (name, shape) leaf."""
    device = torch.device(device)
    drawn = sorted((n, tuple(s)) for n, s in leaves if is_drawn(n))
    total = sum(math.prod(s) for _n, s in drawn)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, ofs = {}, 0
    for name, shape in drawn:
        k = math.prod(shape)
        out[name] = flat[ofs : ofs + k].view(shape)
        ofs += k
    for name, shape in leaves:
        if name in out:
            continue
        if name.rsplit(".", 1)[-1] != "bessel_weights" or len(shape) != 1:
            raise KeyError(f"no rule makes the weight {name} {shape}")
        out[name] = torch.arange(1, shape[0] + 1, device=device,
                                 dtype=torch.float32) * math.pi
    return out
