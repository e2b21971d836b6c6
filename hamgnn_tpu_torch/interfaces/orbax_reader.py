"""Read the orbax checkpoints that the JAX package writes, without JAX.

``hamgnn_tpu/train/trainer.py`` ``save_checkpoint`` and
``hamgnn_tpu/tools/uni_hamgnn.py`` ``HamiltonianPredictor.save`` write
``orbax.checkpoint.StandardCheckpointer`` directories: a ``_METADATA`` JSON
whose ``tree_metadata`` names every leaf by its key path, and the arrays in
zarr form (``zarr3`` where ``use_zarr3``), inside one OCDBT key-value store
where ``use_ocdbt`` (the default), else one directory per array.  An array's
name in the store is its key path joined with ``.``; a Python scalar (the
trainer's learning rate) is a 0-d array.  ``tensorstore`` alone reads them:
``read_orbax`` raises ``ImportError`` where it is missing (the card machine
has none), naming the way out: an ``.npz`` of the flattened tree, or the
port's own package form.

The JAX trainer runs optax on the raveled parameter vector, whose leaves lie
in jax's order (dict keys sorted at every level); the port's flat buffer
lies in ``model.parameters()`` order (``train/optim.py``).
``trainer_checkpoint`` reorders the amsgrad moments from the one to the
other, and finds the amsgrad state by its field names, wherever the optax
chain puts it (after the clip's empty state when ``gradient_clip_val > 0``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np
from torch import nn

_ARRAY_TYPES = ("jax.Array", "np.ndarray", "scalar")
AMSGRAD_FIELDS = ("count", "mu", "nu", "nu_max")


def is_orbax_dir(path: str) -> bool:
    return os.path.isdir(path) and os.path.isfile(os.path.join(path, "_METADATA"))


def read_orbax(path: str) -> Dict[str, np.ndarray]:
    """Every array leaf of a ``StandardCheckpointer`` directory as
    ``{"a/b/c": ndarray}`` (leaves stored as None are skipped)."""
    if not is_orbax_dir(path):
        raise FileNotFoundError(f"{path} is not an orbax checkpoint directory "
                                "(no _METADATA)")
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError(
            f"reading the orbax checkpoint {path} needs the tensorstore package, "
            "which is not installed. Convert it where JAX is installed: an .npz of "
            "the flattened parameter tree (np.savez(out, **{'a/b/w': array})), or, "
            "for a Uni-HamGNN package, the port's own form "
            "(hamgnn_tpu_torch.tools.uni_hamgnn HamiltonianPredictor.save)") from e
    with open(os.path.join(path, "_METADATA"), encoding="utf-8") as f:
        meta = json.load(f)
    root = os.path.abspath(path)
    if meta.get("use_ocdbt", True):
        kvstore = {"driver": "ocdbt", "base": f"file://{root}"}
    else:
        kvstore = {"driver": "file", "path": root + "/"}
    driver = "zarr3" if meta.get("use_zarr3", False) else "zarr"
    out: Dict[str, np.ndarray] = {}
    for entry in meta["tree_metadata"].values():
        value = entry["value_metadata"]
        if value.get("skip_deserialize") or value["value_type"] == "None":
            continue
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        if value["value_type"] not in _ARRAY_TYPES:
            raise ValueError(f"{path}: leaf {'/'.join(keys)} has value type "
                             f"{value['value_type']!r}, not an array")
        store = ts.open({"driver": driver, "kvstore": kvstore,
                         "path": ".".join(keys)}, open=True).result()
        out["/".join(keys)] = np.asarray(store.read().result())
    return out


def subtree(tree: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    """The leaves under ``prefix/``, keyed relative to it."""
    pre = prefix.rstrip("/") + "/"
    return {k[len(pre):]: v for k, v in tree.items() if k.startswith(pre)}


def jax_leaf_order(keys) -> list:
    """``keys`` ("/"-joined paths of one tree) in jax's leaf order: dict keys
    sorted at every level, i.e. the paths sorted component by component."""
    return sorted(keys, key=lambda k: tuple(k.split("/")))


def port_order_index(model: nn.Module, params: Dict[str, np.ndarray]) -> np.ndarray:
    """Gather index ``idx`` with ``port_vector = jax_vector[idx]``: the
    raveled flax tree ``params`` (the ``params`` collection, jax's leaf order)
    -> ``model.parameters()`` order."""
    if params and all(k.startswith("params/") for k in params):
        params = subtree(params, "params")
    ofs, pos = 0, {}
    for k in jax_leaf_order(params):
        n = int(np.asarray(params[k]).size)
        pos[k] = (ofs, n)
        ofs += n
    idx = []
    for name, p in model.named_parameters():
        key = name.replace(".", "/")
        if key not in pos:
            raise KeyError(f"{key}: not in the checkpoint's parameters")
        start, n = pos[key]
        if n != p.numel():
            raise ValueError(f"{key}: {n} values in the checkpoint, {p.numel()} in the model")
        idx.append(np.arange(start, start + n))
    index = np.concatenate(idx) if idx else np.zeros(0, np.int64)
    if index.size != ofs:
        raise ValueError(f"the checkpoint holds {ofs} parameter values, "
                         f"the model {index.size}")
    return index


def amsgrad_state(tree: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The amsgrad state under ``opt_state``, found by its field names."""
    found: Dict[str, Dict[str, np.ndarray]] = {}
    for key, value in subtree(tree, "opt_state").items():
        parent, _, leaf = key.rpartition("/")
        if leaf in AMSGRAD_FIELDS:
            found.setdefault(parent, {})[leaf] = value
    states = [s for s in found.values() if set(s) == set(AMSGRAD_FIELDS)]
    if len(states) != 1:
        raise ValueError(f"expected one amsgrad state (count, mu, nu, nu_max) under "
                         f"opt_state, found {len(states)}")
    return states[0]


def trainer_checkpoint(path: str, model: nn.Module
                       ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray], float]:
    """A JAX trainer checkpoint (``{"params": variables, "opt_state",
    "lr"}``) as (the flattened ``params`` collection, the amsgrad state with
    its moments in ``model.parameters()`` order, the learning rate)."""
    tree = read_orbax(path)
    params = subtree(tree, "params")
    state = amsgrad_state(tree)
    index = port_order_index(model, params)
    reordered = {"count": np.asarray(state["count"], np.int32)}
    for key in ("mu", "nu", "nu_max"):
        reordered[key] = np.asarray(state[key]).reshape(-1)[index]
    return params, reordered, float(tree["lr"])


def checkpoint_params(path: str) -> Dict[str, np.ndarray]:
    """The flattened parameters of an orbax directory: a trainer checkpoint's
    or a Uni-HamGNN package's (``{"params": ...}``), keyed as
    ``interfaces/jax_params.py`` ``load_flax_params`` takes them."""
    return subtree(read_orbax(path), "params")
