"""Multi-process runtime, counterpart of ``hamgnn_tpu/parallel/multihost.py``.

One process per card.  ``maybe_initialize_distributed`` brings up the
``torch.distributed`` process group from the environment ``torchrun`` sets
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``)
or from explicit arguments: NCCL when the device is CUDA (each rank on
``cuda:LOCAL_RANK``), gloo when the caller asks for the CPU.  Host-side
effects (checkpoints, metrics files, exports) are gated on ``is_primary``;
``allgather_metrics`` gathers every rank's values.
"""

from __future__ import annotations

import os
import socket
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device


def local_device(device=None) -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK`` (``cuda:0`` outside a
    launcher) unless the caller asks for the CPU; raises without a GPU."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def maybe_initialize_distributed(init_method: Optional[str] = None,
                                 world_size: Optional[int] = None,
                                 rank: Optional[int] = None, device=None) -> bool:
    """Initialise the process group when several processes are asked for:
    from ``init_method``/``world_size``/``rank`` when given, else from the
    launcher's environment (``WORLD_SIZE`` set).  Returns whether a group is
    up; a no-op when one already is, and when nothing asks for one."""
    if dist.is_initialized():
        return True
    if init_method is None and "WORLD_SIZE" not in os.environ:
        return False
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {}
    if init_method is not None:
        kw = dict(init_method=init_method, world_size=int(world_size), rank=int(rank))
    dist.init_process_group(_backend(dev), **kw)
    return True


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def ensure_process_group(device=None) -> bool:
    """A process group for this process: one already up, the launcher's, or
    else a one-process group on a free localhost port.  Returns whether this
    call brought it up (the caller then destroys it)."""
    if dist.is_initialized():
        return False
    if not maybe_initialize_distributed(device=device):
        maybe_initialize_distributed(f"tcp://localhost:{free_port()}", 1, 0, device)
    return True


def is_primary() -> bool:
    """True on the process that owns host-side effects (rank 0)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _stack_leaves(trees):
    head = trees[0]
    if isinstance(head, dict):
        return {k: _stack_leaves([t[k] for t in trees]) for k in head}
    if isinstance(head, (list, tuple)):
        return type(head)(_stack_leaves(list(t)) for t in zip(*trees))
    return np.stack([np.asarray(t) for t in trees])


def allgather_metrics(tree: Any):
    """Every process's values of a tree (dicts, lists, tuples) of scalars and
    arrays, each leaf stacked along a new leading process axis (size 1 in
    one process)."""
    if process_count() == 1:
        return _stack_leaves([tree])
    host = _to_host(tree)
    gathered = [None] * process_count()
    dist.all_gather_object(gathered, host)
    return _stack_leaves(gathered)


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)
