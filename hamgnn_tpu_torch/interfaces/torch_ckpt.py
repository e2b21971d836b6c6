"""PyTorch / Lightning checkpoint import utilities, counterpart of
``hamgnn_tpu/interfaces/torch_ckpt.py``.

The reference trains with Lightning and saves ``.ckpt`` files whose
``state_dict`` holds e3nn module parameters.  The native path of this package
is parametrised otherwise (fused tensor products, one flat weight per
equivariant Linear), so such checkpoints are not weight-compatible with it as
they are.  What converts exactly:

* ``o3.Linear`` flat weights: the same map (per-output-chunk
  ``1/sqrt(fan_in)``), another flat layout (e3nn concatenates per-instruction
  ``(mul_in, mul_out)`` blocks in input-major instruction order, this package
  per-output-chunk ``(fan_in, mul_out)`` blocks);
  ``convert_o3_linear_weight`` is the exact bijection.
* e3nn ``FullyConnectedNet`` layers (``layers.{i}.weight``, ``(d_in,
  d_out)``): the same layout and normalisation, copied by
  ``convert_fcn_weights``.

Everything else is mapped module by module (``interfaces/e3nn_compat.py``
``map_reference_state``).  ``flatten_params`` / ``assign_params`` /
``suggest_shape_matches`` take a nested dict of arrays, as the JAX functions
do, or an ``nn.Module`` of this package, whose parameters they read and fill
under the flax key form (``state_dict`` names with ``.`` -> ``/``), so the
output of ``map_reference_state`` applies to a module as it is.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..e3.irreps import Irreps

__all__ = [
    "load_torch_checkpoint",
    "e3nn_linear_instructions",
    "convert_o3_linear_weight",
    "convert_fcn_weights",
    "flatten_params",
    "unflatten_params",
    "assign_params",
    "suggest_shape_matches",
]


def load_torch_checkpoint(path: str, strip_prefixes: Sequence[str] = ("model.",)
                          ) -> Dict[str, np.ndarray]:
    """Load a torch / Lightning checkpoint into a flat ``{name: ndarray}`` dict.

    Unwraps the Lightning ``{"state_dict": ...}`` envelope and strips the given
    module prefixes (Lightning prepends the attribute name of the wrapped
    ``nn.Module``).  Non-tensor entries are dropped.  A Lightning ``.ckpt``
    pickles its hyperparameters beside the tensors, so it is loaded with
    ``weights_only=False``: load only checkpoints you trust.
    """
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    out: Dict[str, np.ndarray] = {}
    for name, value in obj.items():
        if not hasattr(value, "detach"):
            continue
        for pre in strip_prefixes:
            if name.startswith(pre):
                name = name[len(pre):]
                break
        out[name] = value.detach().cpu().numpy()
    return out


def e3nn_linear_instructions(irreps_in, irreps_out) -> List[Tuple[int, int]]:
    """e3nn ``o3.Linear``'s default instruction list: input-major
    (i_in, i_out) pairs of matching irrep."""
    irreps_in, irreps_out = Irreps(irreps_in), Irreps(irreps_out)
    return [
        (i, j)
        for i, mi in enumerate(irreps_in)
        for j, mo in enumerate(irreps_out)
        if mi.ir == mo.ir
    ]


def convert_o3_linear_weight(flat_w: np.ndarray, irreps_in, irreps_out) -> np.ndarray:
    """Exact e3nn ``o3.Linear.weight`` -> ``e3.linear.Linear.w`` conversion.

    Both apply ``y_k = (1/sqrt(fan_in_k)) * concat_i(x_i) @ W_k``; only the
    flat storage order differs, so this is a pure reindexing.
    """
    irreps_in, irreps_out = Irreps(irreps_in), Irreps(irreps_out)
    flat_w = np.asarray(flat_w).reshape(-1)
    instr = e3nn_linear_instructions(irreps_in, irreps_out)

    blocks: Dict[Tuple[int, int], np.ndarray] = {}
    ofs = 0
    for (i, j) in instr:
        mul_in, mul_out = irreps_in[i].mul, irreps_out[j].mul
        n = mul_in * mul_out
        blocks[(i, j)] = flat_w[ofs : ofs + n].reshape(mul_in, mul_out)
        ofs += n
    if ofs != flat_w.size:
        raise ValueError(
            f"weight numel {flat_w.size} != expected {ofs} for "
            f"{irreps_in} -> {irreps_out}")

    chunks = []
    for j, mo in enumerate(irreps_out):
        sources = [i for i, mi in enumerate(irreps_in) if mi.ir == mo.ir]
        if not sources:
            continue
        chunks.append(np.concatenate([blocks[(i, j)] for i in sources], axis=0))
    if not chunks:
        return np.zeros(0, flat_w.dtype)
    return np.concatenate([c.reshape(-1) for c in chunks])


def convert_fcn_weights(state: Mapping[str, np.ndarray], prefix: str
                        ) -> Dict[str, np.ndarray]:
    """e3nn ``FullyConnectedNet`` ``{prefix}layers.{i}.weight`` ->
    ``nn.mlp.FullyConnectedNet`` ``{"w{i}": (d_in, d_out)}`` (identical layout)."""
    out: Dict[str, np.ndarray] = {}
    i = 0
    while f"{prefix}layers.{i}.weight" in state:
        out[f"w{i}"] = np.asarray(state[f"{prefix}layers.{i}.weight"])
        i += 1
    if not out:
        raise KeyError(f"no '{prefix}layers.*.weight' entries found")
    return out


def flatten_params(params, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested dict of arrays, or a module's parameters, as
    ``{"a/b/w": ndarray}``."""
    if isinstance(params, nn.Module):
        return {prefix + name.replace(".", "/"): p.detach().cpu().numpy()
                for name, p in params.named_parameters()}
    flat: Dict[str, np.ndarray] = {}
    if isinstance(params, Mapping):
        for k, v in params.items():
            flat.update(flatten_params(v, f"{prefix}{k}/"))
    else:
        flat[prefix[:-1]] = np.asarray(params)
    return flat


def unflatten_params(flat: Mapping[str, np.ndarray]):
    tree: Dict = {}
    for path, value in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def assign_params(params, assignments: Mapping[str, np.ndarray],
                  strict_shapes: bool = True):
    """Replace the leaves at the given "/"-joined paths; raises on unknown
    paths or shape mismatches.  A nested dict is copied; a module's
    parameters are filled in place.

    Returns ``(new_params, untouched_paths)`` so callers can report coverage.
    """
    flat = flatten_params(params)
    for path, value in assignments.items():
        if path not in flat:
            raise KeyError(f"no parameter at '{path}'; available e.g. "
                           f"{list(flat)[:5]}")
        value = np.asarray(value, flat[path].dtype)
        if strict_shapes and value.shape != flat[path].shape:
            raise ValueError(
                f"shape mismatch at '{path}': checkpoint {value.shape} vs "
                f"model {flat[path].shape}")
        flat[path] = value
    untouched = [p for p in flat if p not in assignments]
    if not isinstance(params, nn.Module):
        return unflatten_params(flat), untouched
    with torch.no_grad():
        for name, p in params.named_parameters():
            key = name.replace(".", "/")
            if key in assignments:
                p.copy_(torch.as_tensor(flat[key].reshape(p.shape)))
    return params, untouched


def suggest_shape_matches(params, state: Mapping[str, np.ndarray],
                          max_candidates: int = 5
                          ) -> Dict[str, List[str]]:
    """For each model parameter, the checkpoint entries of the same shape
    (or of the same numel, for flat-layout weights): a starting point for an
    explicit mapping."""
    flat = flatten_params(params)
    out: Dict[str, List[str]] = {}
    for path, leaf in flat.items():
        cands = [k for k, v in state.items() if v.shape == leaf.shape]
        if not cands:
            cands = [f"~{k}" for k, v in state.items() if v.size == leaf.size]
        out[path] = cands[:max_candidates]
    return out
