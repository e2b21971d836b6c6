# Frozen copy of hamgnn_tpu_torch/utils/constants.py, with its imports rewritten.
"""Host tables as device tensors, made once per device and type.

A forward that takes its constant tables from here copies nothing from the
host after its first run, which a CUDA graph needs: a copy from pageable host
memory waits for the device and cannot be captured
(``train/captured.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable

import numpy as np
import torch

_TABLES: Dict[tuple, torch.Tensor] = {}


def device_constant(key: Hashable, make: Callable[[], np.ndarray], dtype: torch.dtype,
                    device) -> torch.Tensor:
    """``make()`` as a ``dtype`` tensor on ``device``, built at the first call
    for (``key``, ``dtype``, ``device``) and the same tensor after it.  Made
    outside inference mode, so that autograd may save it."""
    k = (key, dtype, str(torch.device(device)))
    t = _TABLES.get(k)
    if t is None:
        with torch.inference_mode(False):
            t = _TABLES[k] = torch.as_tensor(np.asarray(make()), dtype=dtype, device=device)
    return t
