"""Load a flax parameter tree of the reference model into the port.

The port's module attribute names follow the reference's flax module names,
so the flax tree flattened to ``"a/b/w"`` keys (relative to the ``params``
collection) maps one to one onto ``state_dict`` keys ``"a.b.w"``.  The
``.npz`` form of such a tree (``np.savez(path, **flat)``) is what the CLI's
``setup.checkpoint_path`` accepts besides the port's own ``torch.save``
state dict.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn


def load_flax_params(model: nn.Module, flat: Dict[str, np.ndarray]) -> nn.Module:
    """Fill ``model``'s parameters from a flattened flax tree.  Raises on any
    missing or extra key and on any shape mismatch."""
    if flat and all(k.startswith("params/") for k in flat):
        flat = {k[len("params/"):]: v for k, v in flat.items()}
    params = dict(model.named_parameters())
    want = {name.replace(".", "/") for name in params}
    have = set(flat)
    missing, extra = sorted(want - have), sorted(have - want)
    if missing or extra:
        raise KeyError(f"flax parameters do not match the model: missing "
                       f"{missing[:10]}{'...' if len(missing) > 10 else ''}, "
                       f"extra {extra[:10]}{'...' if len(extra) > 10 else ''}")
    with torch.no_grad():
        for name, p in params.items():
            arr = np.array(flat[name.replace(".", "/")])
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: flax shape {arr.shape}, "
                                 f"model shape {tuple(p.shape)}")
            p.copy_(torch.as_tensor(arr, dtype=p.dtype))
    return model


def load_flax_npz(model: nn.Module, path: str) -> nn.Module:
    with np.load(path) as f:
        return load_flax_params(model, {k: f[k] for k in f.files})
