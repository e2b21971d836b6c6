"""PyTorch/CUDA port of hamgnn_tpu for NVIDIA Hopper (H100).

The JAX package ``hamgnn_tpu`` is the reference; this package mirrors its
module layout and names so each counterpart is easy to find.  It imports
``torch`` and never ``jax``/``flax``/``optax`` or anything of ``hamgnn_tpu``:
the static tables it needs are re-derived here and tested element-exact
against the reference's.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, the CPU only
    when asked.  Raises when no GPU is present and the CPU was not asked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev
