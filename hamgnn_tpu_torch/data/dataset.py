"""Dataset loading, splitting and bucketed batching, counterpart of
``hamgnn_tpu/data/dataset.py``.

  * ``graph_data.npz``: a pickled dict of PyG ``Data`` (read via the shim);
  * an LMDB store (``graph_{i}`` records, the count in ``num_graphs``), read
    on demand by ``LmdbGraphStore``, or its lmdb-lite directory form;
  * the seed-42 split of the reference (numpy RandomState shuffle, rounded
    ratios) and ``split_file`` save/load;
  * batches padded to quantised node/edge buckets, as in the reference, so
    both packages see identical batches.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .graph import Graph, pad_and_batch

_FIELDS = (
    "z", "pos", "cell", "edge_index", "inv_edge_idx", "nbr_shift", "cell_shift",
    "Hon", "Hoff", "Hon0", "Hoff0", "iHon", "iHoff", "iHon0", "iHoff0",
    "Son", "Soff", "Lon", "Loff", "doping_charge",
    "H0_u", "H0_d", "H_u", "H_d",
    "spin_vec", "spin_length",
)


def _to_numpy(v):
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _crystal_dict(obj) -> Dict[str, np.ndarray]:
    """Normalise a loaded graph object (PyG Data / shim / dict) to a numpy dict."""
    if isinstance(obj, dict):
        items = obj.items()
    elif hasattr(obj, "to_dict"):
        items = obj.to_dict().items()
    else:
        items = ((k, getattr(obj, k)) for k in _FIELDS if hasattr(obj, k))
    out = {k: _to_numpy(v) for k, v in items if k in _FIELDS}
    return _repack_legacy_collinear(out)


def _repack_legacy_collinear(c: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Legacy collinear format: ``H0_u`` etc. hold onsite rows for the first
    ``len(z)`` entries and offsite rows for the rest; repack into
    2-spin-channel ``Hon0/Hoff0/Hon/Hoff`` stacks."""
    if "H0_u" not in c:
        return c
    n = int(np.asarray(c["z"]).shape[0])

    def flat(a):
        a = np.asarray(a)
        return a.reshape(a.shape[0], -1)

    c["Hon0"] = np.stack([flat(c["H0_u"][:n]), flat(c["H0_d"][:n])], axis=1)
    c["Hoff0"] = np.stack([flat(c["H0_u"][n:]), flat(c["H0_d"][n:])], axis=1)
    c["Hon"] = np.stack([flat(c["H_u"][:n]), flat(c["H_d"][:n])], axis=1)
    c["Hoff"] = np.stack([flat(c["H_u"][n:]), flat(c["H_d"][n:])], axis=1)
    for k in ("H0_u", "H0_d", "H_u", "H_d"):
        del c[k]
    return c


def load_graph_npz(path: str) -> List[Dict[str, np.ndarray]]:
    """Load a reference-format graph_data.npz into a list of crystal dicts."""
    from ..interfaces.pyg_shim import install_shim

    install_shim()
    with np.load(path, allow_pickle=True) as f:
        graphs = f["graph"].item()
    keys = sorted(graphs.keys(), key=lambda k: (isinstance(k, str), k))
    return [_crystal_dict(graphs[k]) for k in keys]


class LmdbGraphStore:
    """Graphs read on demand from the reference's LMDB layout (a pickled
    PyG ``Data`` under ``graph_{i}``, the count under ``num_graphs``), with a
    small LRU cache: only the graphs a batch touches are in memory.

    The lmdb-lite form, a directory with a ``num_graphs`` text file and one
    ``graph_{i}.pkl`` per graph (what ``tools.npz_to_lmdb`` writes where the
    ``lmdb`` module is missing), is read with no module.  A real LMDB file
    needs ``lmdb``, and raises ``ImportError`` without it.  The pickles name
    ``torch_geometric.data.data.Data``; the port's shim reads them."""

    def __init__(self, path: str, cache_size: int = 64):
        from ..interfaces.pyg_shim import install_shim

        install_shim()
        self.path = path
        self._cache: Dict[int, Dict[str, np.ndarray]] = {}
        self._cache_size = cache_size
        self._env = None
        count = os.path.join(path, "num_graphs")
        if os.path.isdir(path) and os.path.exists(count):
            with open(count) as f:
                self._n = int(f.read().strip())
        else:
            try:
                import lmdb
            except ImportError as exc:
                raise ImportError(
                    f"{path} is not an lmdb-lite directory (no num_graphs file), and "
                    "reading an LMDB file needs the lmdb module, which is not "
                    "installed") from exc
            self._env = lmdb.open(path, readonly=True, lock=False, readahead=False,
                                  meminit=False)
            with self._env.begin() as txn:
                self._n = int(txn.get(b"num_graphs").decode())

    def __len__(self) -> int:
        return self._n

    def _load(self, i: int):
        if self._env is None:
            with open(os.path.join(self.path, f"graph_{i}.pkl"), "rb") as f:
                return pickle.load(f)
        with self._env.begin() as txn:
            return pickle.loads(txn.get(f"graph_{i}".encode()))

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(self._n))]
        if i < 0:
            i += self._n
        if not 0 <= i < self._n:
            raise IndexError(f"graph {i} of a store of {self._n}")
        if i in self._cache:
            return self._cache[i]
        c = _crystal_dict(self._load(i))
        if len(self._cache) >= self._cache_size:
            self._cache.pop(next(iter(self._cache)))
        self._cache[i] = c
        return c

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for i in range(self._n):
            yield self[i]


def load_graph_lmdb(path: str, indices: Optional[Sequence[int]] = None
                    ) -> List[Dict[str, np.ndarray]]:
    """The graphs of an LMDB (or lmdb-lite) store, read into memory."""
    store = LmdbGraphStore(path, cache_size=1)
    return [store[i] for i in (range(len(store)) if indices is None else indices)]


def save_graph_npz(path: str, crystals: Sequence[Dict[str, np.ndarray]]) -> None:
    """Write a reference-compatible graph_data.npz (via shim Data objects)."""
    from ..interfaces.pyg_shim import Data, install_shim

    install_shim()
    graphs = {i: Data(**dict(c)) for i, c in enumerate(crystals)}
    np.savez(path, graph=graphs)


def reference_split(n: int, train_ratio: float = 0.6, val_ratio: float = 0.2,
                    test_ratio: float = 0.2, split_file: Optional[str] = None,
                    ) -> Tuple[List[int], List[int], List[int]]:
    """Seed-42 split identical to the reference's."""
    if split_file is not None and os.path.exists(split_file):
        data = np.load(split_file)
        return (data["train_idx"].tolist(), data["val_idx"].tolist(),
                data["test_idx"].tolist())
    rs = np.random.RandomState(seed=42)
    indices = list(range(n))
    rs.shuffle(indices)
    num_train = round(train_ratio * n)
    num_val = round(val_ratio * n)
    train = indices[:num_train]
    val = indices[num_train : num_train + num_val]
    test = indices[num_train + num_val :]
    if split_file is not None:
        np.savez(split_file, train_idx=np.array(train), val_idx=np.array(val),
                 test_idx=np.array(test))
    return train, val, test


def _bucket(x: int, quantum: int) -> int:
    return max(quantum, ((x + quantum - 1) // quantum) * quantum)


class GraphDataModule:
    """Split + batching front end; batches are built on ``device``.  A
    sequence of graphs is kept as it is (a lazy store stays lazy), an
    iterator is read into a list."""

    def __init__(self, graphs: Sequence[Dict[str, np.ndarray]], batch_size: int = 1,
                 train_ratio: float = 0.6, val_ratio: float = 0.2,
                 test_ratio: float = 0.2, split_file: Optional[str] = None,
                 test_mode: bool = False, node_quantum: int = 16,
                 edge_quantum: int = 256, device="cpu"):
        self.graphs = graphs if hasattr(graphs, "__getitem__") else list(graphs)
        self.batch_size = batch_size
        self.node_quantum = node_quantum
        self.edge_quantum = edge_quantum
        self.device = device
        n = len(self.graphs)
        if test_mode:
            self.train_idx, self.val_idx = [], []
            self.test_idx = list(range(n))
        else:
            self.train_idx, self.val_idx, self.test_idx = reference_split(
                n, train_ratio, val_ratio, test_ratio, split_file)

    def _batches(self, indices: Sequence[int], shuffle: bool = False,
                 rng=None) -> Iterator[Graph]:
        order = list(indices)
        if shuffle:
            (rng or np.random.default_rng()).shuffle(order)
        for i in range(0, len(order), self.batch_size):
            chunk = [self.graphs[j] for j in order[i : i + self.batch_size]]
            n_tot = sum(c["z"].shape[0] for c in chunk)
            e_tot = sum(c["edge_index"].shape[1] for c in chunk)
            yield pad_and_batch(chunk, node_bucket=_bucket(n_tot, self.node_quantum),
                                edge_bucket=_bucket(e_tot, self.edge_quantum),
                                device=self.device)

    def train_batches(self, rng: Optional[np.random.Generator] = None
                      ) -> Iterator[Graph]:
        """Train batches in an order shuffled by ``rng`` exactly as the JAX
        data module shuffles them, so one generator state gives one order."""
        return self._batches(self.train_idx, shuffle=True, rng=rng)

    def val_batches(self) -> Iterator[Graph]:
        return self._batches(self.val_idx)

    def test_batches(self) -> Iterator[Graph]:
        return self._batches(self.test_idx)
