"""Import of the reference's pickled Uni-HamGNN predictors, counterpart of
``hamgnn_tpu/interfaces/uni_pickle.py``.

The reference publishes its universal models as pickled live
``HamiltonianPredictor`` objects whose module tree references
``HamGNN_v_2_1.*`` / e3nn / Lightning classes (the reference's
Uni-HamiltonianPredictor.py).  None of those packages is needed here:
``stub_unpickle`` loads such pickles with a permissive unpickler, which
replaces every class that cannot be imported by a generated stub that keeps
its state.  Tensors rebuild through torch's own hooks: a plain pickle's by
``pickle`` itself, a ``torch.save`` zip container's through ``torch.load``
with the permissive unpickler as its pickle module.

``extract_state_dicts`` walks the stubbed ``torch.nn.Module`` tree
(``_modules`` / ``_parameters`` / ``_buffers``) into flat numpy state dicts,
and ``convert_predictor_pickle`` maps both stages through
``interfaces/e3nn_compat.py`` ``map_reference_state`` onto the compat models
of ``tools/uni_hamgnn.py`` and writes a predictor package in the port's own
form (YAML configs and ``.npz`` parameters, no orbax).
"""

from __future__ import annotations

import io
import pickle
import types
from typing import Any, Dict, Tuple

import numpy as np
import torch

_STUB_CACHE: Dict[Tuple[str, str], type] = {}


class StubBase:
    """Generic stand-in for an unimportable pickled class."""

    _stub_module = "?"
    _stub_name = "?"

    def __new__(cls, *args, **kwargs):
        obj = object.__new__(cls)
        obj.__dict__["_stub_new_args"] = args
        return obj

    def __init__(self, *args, **kwargs):
        self.__dict__.setdefault("_stub_init_args", args)

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif (isinstance(state, tuple) and len(state) == 2
              and isinstance(state[0], (dict, type(None)))):
            if state[0]:
                self.__dict__.update(state[0])
            if isinstance(state[1], dict):
                self.__dict__.update(state[1])
        else:
            self.__dict__["_stub_state"] = state

    def __call__(self, *args, **kwargs):  # reduce-style factories
        return self

    def __repr__(self):
        return f"<stub {self._stub_module}.{self._stub_name}>"


def _make_stub(module: str, name: str) -> type:
    key = (module, name)
    if key not in _STUB_CACHE:
        _STUB_CACHE[key] = type(
            f"Stub_{name}", (StubBase,),
            {"_stub_module": module, "_stub_name": name})
    return _STUB_CACHE[key]


class _PermissiveUnpickler(pickle.Unpickler):
    """Unpickler that stubs unimportable classes."""

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except Exception:  # noqa: BLE001 - any unimportable class gets a stub
            return _make_stub(module, name)


# what ``torch.load`` takes as ``pickle_module``: for the zip container it
# unpickles with a subclass of ``Unpickler``
_PERMISSIVE_PICKLE = types.ModuleType("permissive_pickle")
_PERMISSIVE_PICKLE.Unpickler = _PermissiveUnpickler


def _unpickle_torch_zip(path_or_bytes) -> Any:
    """A ``torch.save`` zip container (``<name>/data.pkl`` + raw storages):
    ``torch.load`` on the CPU with the permissive unpickler.  Such a pickle
    can run code on load, as any pickle: load only files you trust."""
    f = io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, (bytes, bytearray)) \
        else path_or_bytes
    return torch.load(f, map_location="cpu", weights_only=False,
                      pickle_module=_PERMISSIVE_PICKLE)


def stub_unpickle(path_or_bytes) -> Any:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        if bytes(path_or_bytes[:4]).startswith(b"PK"):
            return _unpickle_torch_zip(path_or_bytes)
        return _PermissiveUnpickler(io.BytesIO(path_or_bytes)).load()
    with open(path_or_bytes, "rb") as f:
        head = f.read(4)
    if head.startswith(b"PK"):  # torch.save zip container
        return _unpickle_torch_zip(path_or_bytes)
    with open(path_or_bytes, "rb") as f:
        return _PermissiveUnpickler(f).load()


def _to_numpy(v):
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def extract_state_dicts(module_obj, prefix: str = "") -> Dict[str, np.ndarray]:
    """Flatten a (possibly stubbed) torch module tree into {name: ndarray}."""
    out: Dict[str, np.ndarray] = {}
    d = getattr(module_obj, "__dict__", {})
    for bag in ("_parameters", "_buffers"):
        for name, value in (d.get(bag) or {}).items():
            if value is None:
                continue
            out[f"{prefix}{name}"] = _to_numpy(value)
    for name, child in (d.get("_modules") or {}).items():
        if child is not None:
            out.update(extract_state_dicts(child, f"{prefix}{name}."))
    return out


def predictor_state_dicts(predictor) -> Dict[str, Dict[str, np.ndarray]]:
    """non_soc / soc state dicts from a stub-unpickled HamiltonianPredictor.

    The reference predictor wraps each model in the Lightning ``Model``,
    whose attributes are ``representation`` and ``output_module``.
    """
    out = {}
    non_soc = getattr(predictor, "non_soc_model", None)
    if non_soc is not None:
        out["non_soc"] = extract_state_dicts(non_soc)
    soc = getattr(predictor, "soc_model", None)
    if soc is not None:
        out["soc"] = extract_state_dicts(soc)
    if not out:
        raise ValueError("pickle holds no non_soc_model/soc_model attributes")
    return out


def convert_predictor_pickle(pickle_path: str, config, out_dir: str,
                             example_graph=None, soc_config=None) -> Dict[str, int]:
    """Reference predictor pickle -> Uni-HamGNN package directory.

    ``config`` / ``soc_config`` are resolved reference-schema configs (the
    hyperparameters of the published two-stage predictor).  The non-SOC
    model maps onto the e3nn-compat representation + Hamiltonian head, the
    SOC model (when present and ``soc_config`` is given) onto the
    e3nn-compat representation + ``HamGNNSOCOut(add_H_nonsoc=True)``.  The
    parameter tree is the compat models' own; ``example_graph`` is accepted
    for the JAX signature and not needed.  Returns the count of converted
    parameters per model.
    """
    from ..models.basis import get_basis_set, hamiltonian_irreps
    from ..models.soc import su2_base_irreps
    from ..tools.uni_hamgnn import HamiltonianPredictor
    from .e3nn_compat import map_reference_state
    from .torch_ckpt import assign_params

    states = predictor_state_dicts(stub_unpickle(pickle_path))
    two_stage = "soc" in states and soc_config is not None
    pred = HamiltonianPredictor(config, soc_config if two_stage else None,
                                soc_switch=two_stage, compat=True, device="cpu")
    pre = pred.config_nonsoc.representation_nets.HamGNN_pre
    out_cfg = pred.config_nonsoc.output_nets.HamGNN_out
    ham = hamiltonian_irreps(get_basis_set(out_cfg.ham_type.lower(), out_cfg.nao_max))
    # drop keys of heads that are not mapped (no overlap heads: ham_only)
    state = {k: v for k, v in states["non_soc"].items()
             if not k.startswith("output_module.") or "hamiltonian_network" in k}
    assignments = map_reference_state(
        state, num_types=pre.num_types, irreps_node_features=pre.irreps_node_features,
        irreps_edge_sh=pre.irreps_edge_sh, num_layers=pre.num_layers, irreps_ham=ham)
    _, untouched = assign_params(pred.model_nonsoc, assignments)
    if untouched:
        raise ValueError(f"unmapped model parameters: {untouched[:10]}")
    counts = {"non_soc": len(assignments)}

    if two_stage:
        spre = pred.config_soc.representation_nets.HamGNN_pre
        sout = pred.config_soc.output_nets.HamGNN_out
        soc_basis = sout.get("soc_basis", "so3")
        nao = int(sout.nao_max)
        basis = get_basis_set(sout.ham_type.lower(), nao)
        s_assign = map_reference_state(
            states["soc"], num_types=spre.num_types,
            irreps_node_features=spre.irreps_node_features,
            irreps_edge_sh=spre.irreps_edge_sh, num_layers=spre.num_layers,
            irreps_ham=hamiltonian_irreps(basis), soc_basis=soc_basis,
            irreps_ham_su2=su2_base_irreps(basis) if soc_basis == "su2" else None,
            nao_max=nao, add_H_nonsoc=True)
        _, s_untouched = assign_params(pred.model_soc, s_assign)
        if s_untouched:
            raise ValueError(f"unmapped SOC parameters: {s_untouched[:10]}")
        counts["soc"] = len(s_assign)
    pred.save(out_dir)
    return counts
