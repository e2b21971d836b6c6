"""Minimal torch_geometric pickle compatibility shim.

A copy of ``hamgnn_tpu/interfaces/pyg_shim.py``.  The reference stores
``graph_data.npz`` as a pickled dict of PyG ``Data`` objects, and LMDB
entries the same way.  torch_geometric is not a dependency of this
framework, so this module registers just enough fake classes under the
``torch_geometric.*`` module paths for pickle to resolve:

  * loading: reference-produced files unpickle into lightweight attribute
    containers;
  * saving: graphs we write carry the same class paths, so they unpickle fine
    in an environment with the real torch_geometric installed.

Only attribute storage semantics are implemented — no graph ops.
"""

from __future__ import annotations

import sys
import types
from typing import Any, Dict


class _Storage:
    """Stands in for torch_geometric.data.storage.{GlobalStorage,BaseStorage}."""

    def __init__(self, _parent=None, **kwargs):
        self.__dict__["_mapping"] = dict(kwargs)

    def __setstate__(self, state):
        mapping = state.get("_mapping", {k: v for k, v in state.items() if not k.startswith("_")})
        self.__dict__["_mapping"] = dict(mapping)

    def __getstate__(self):
        return {"_mapping": dict(self._mapping)}

    def __getattr__(self, key):
        try:
            return self.__dict__["_mapping"][key]
        except KeyError:
            raise AttributeError(key)

    def __setattr__(self, key, value):
        self.__dict__["_mapping"][key] = value

    def __getitem__(self, key):
        return self._mapping[key]

    def __setitem__(self, key, value):
        self._mapping[key] = value

    def __contains__(self, key):
        return key in self._mapping

    def keys(self):
        return self._mapping.keys()

    def items(self):
        return self._mapping.items()


class Data:
    """Attribute-bag equivalent of torch_geometric.data.Data."""

    def __init__(self, **kwargs):
        self.__dict__["_store"] = _Storage(**kwargs)

    def __setstate__(self, state):
        store = state.get("_store")
        if store is None:
            store = _Storage(**{k: v for k, v in state.items() if not k.startswith("_")})
        elif isinstance(store, dict):
            store = _Storage(**store)
        self.__dict__["_store"] = store

    def __getstate__(self):
        return {"_store": self._store}

    def __getattr__(self, key):
        if key.startswith("_"):
            raise AttributeError(key)
        try:
            return getattr(self.__dict__["_store"], key)
        except AttributeError:
            raise AttributeError(key)

    def __setattr__(self, key, value):
        setattr(self._store, key, value)

    def __getitem__(self, key):
        return self._store[key]

    def __contains__(self, key):
        return key in self._store

    def keys(self):
        return list(self._store.keys())

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._store.items())


def _passthrough(*args, **kwargs):  # attr classes PyG registers in pickles
    return None


def install_shim() -> None:
    """Register fake torch_geometric modules (no-op if the real one exists)."""
    try:
        import torch_geometric  # noqa: F401
        return
    except ImportError:
        pass
    if "torch_geometric" in sys.modules:
        return

    tg = types.ModuleType("torch_geometric")
    tg_data = types.ModuleType("torch_geometric.data")
    tg_data_data = types.ModuleType("torch_geometric.data.data")
    tg_storage = types.ModuleType("torch_geometric.data.storage")

    Data.__module__ = "torch_geometric.data.data"
    _Storage.__module__ = "torch_geometric.data.storage"
    # pickle resolves classes by (module, qualname): ours must serialize under
    # the name the real torch_geometric exposes.
    _Storage.__name__ = "GlobalStorage"
    _Storage.__qualname__ = "GlobalStorage"

    tg_data_data.Data = Data
    tg_data_data.DataEdgeAttr = _passthrough
    tg_data_data.DataTensorAttr = _passthrough
    tg_storage.GlobalStorage = _Storage
    tg_storage.BaseStorage = _Storage
    tg_storage.NodeStorage = _Storage
    tg_storage.EdgeStorage = _Storage
    tg_data.Data = Data
    tg_data.data = tg_data_data
    tg_data.storage = tg_storage
    tg.data = tg_data

    sys.modules["torch_geometric"] = tg
    sys.modules["torch_geometric.data"] = tg_data
    sys.modules["torch_geometric.data.data"] = tg_data_data
    sys.modules["torch_geometric.data.storage"] = tg_storage
