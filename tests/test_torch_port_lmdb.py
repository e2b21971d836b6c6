"""The port's LMDB graph store (``data/dataset.py`` ``LmdbGraphStore``,
``tools/npz_to_lmdb.py``) and the lazy data module.

* a store written by the port's ``npz_to_lmdb`` (the lmdb-lite form where the
  ``lmdb`` module is missing) reads back the npz's graphs, on demand and
  within its LRU cache; ``load_graph_lmdb`` reads them all;
* the npz and the store give the same seed-42 splits and bit-identical
  batches;
* stores cross between the packages: one written by
  ``hamgnn_tpu.tools.npz_to_lmdb`` is read by the port, one written by the
  port by ``hamgnn_tpu.data.dataset.LmdbGraphStore``;
* ``GraphDataModule`` keeps a store lazy: building it reads no graph, one
  batch reads that batch's graphs; ``prepare_dataset`` reads each graph once
  more, to validate the elements;
* ``python -m hamgnn_tpu_torch.cli`` trains and tests on a store
  (``data_format: lmdb``, and ``auto`` with a ``.lmdb`` path);
* a path that is neither an lmdb-lite directory nor readable without the
  ``lmdb`` module raises ``ImportError``.
"""

import numpy as np
import pytest
import torch
import yaml
from util_fixtures import add_random_hamiltonian_targets, make_crystal

from hamgnn_tpu.data import dataset as j_dataset
from hamgnn_tpu.tools import npz_to_lmdb as j_npz_to_lmdb
from hamgnn_tpu_torch import cli as t_cli
from hamgnn_tpu_torch.data.dataset import (GraphDataModule, LmdbGraphStore, load_graph_lmdb,
                                           load_graph_npz, save_graph_npz)
from hamgnn_tpu_torch.data.synthetic import add_random_spin_targets
from hamgnn_tpu_torch.tools.npz_to_lmdb import convert
from hamgnn_tpu_torch.train.config import load_config

FIELDS = ("z", "pos", "edge_index", "inv_edge_idx", "cell_shift", "node_mask", "edge_mask",
          "Hon", "Hoff", "Son", "Soff", "spin_vec", "spin_length", "edge_group_tar")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so that parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _crystals(n=6, seed=2):
    rng = np.random.default_rng(seed)
    return [add_random_spin_targets(rng, add_random_hamiltonian_targets(
        rng, make_crystal(rng, n_atoms=3 + i % 2, species=(6, 14)), nao_max=14), "collinear")
        for i in range(n)]


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """An npz of 6 crystals and its store written by the port."""
    root = tmp_path_factory.mktemp("lmdb")
    crystals = _crystals()
    npz = str(root / "graph_data.npz")
    save_graph_npz(npz, crystals)
    path = str(root / "graph_data.lmdb")
    assert convert(npz, path) == len(crystals)
    return root, npz, path, crystals


def _same_batches(a, b):
    n = 0
    for ga, gb in zip(a, b, strict=True):
        for name in FIELDS:
            np.testing.assert_array_equal(getattr(ga, name).numpy(), getattr(gb, name).numpy(),
                                          err_msg=name)
        n += 1
    return n


def test_store_reads_back_on_demand(stores):
    _root, _npz, path, crystals = stores
    store = LmdbGraphStore(path, cache_size=2)
    assert len(store) == len(crystals)
    for i in (0, 3, 5, -1):
        for key in ("Hon", "pos", "spin_vec"):
            np.testing.assert_array_equal(store[i][key], crystals[i][key])
    assert len(store._cache) <= 2
    assert [c["z"].tolist() for c in store[1:3]] == [c["z"].tolist() for c in crystals[1:3]]
    with pytest.raises(IndexError):
        store[len(crystals)]
    eager = load_graph_lmdb(path)
    np.testing.assert_array_equal(eager[4]["Hoff"], crystals[4]["Hoff"])
    assert [c["z"].tolist() for c in load_graph_lmdb(path, [2, 0])] == [
        crystals[2]["z"].tolist(), crystals[0]["z"].tolist()]


def test_npz_and_store_give_the_same_splits_and_batches(stores):
    _root, npz, path, _crystals_ = stores
    dm_npz = GraphDataModule(load_graph_npz(npz), batch_size=2)
    dm_store = GraphDataModule(LmdbGraphStore(path), batch_size=2)
    for split in ("train_idx", "val_idx", "test_idx"):
        assert getattr(dm_npz, split) == getattr(dm_store, split)
    assert _same_batches(dm_npz.test_batches(), dm_store.test_batches()) >= 1
    assert _same_batches(dm_npz.train_batches(np.random.default_rng(0)),
                         dm_store.train_batches(np.random.default_rng(0))) >= 1


def test_stores_cross_between_the_packages(stores, tmp_path):
    _root, npz, path, crystals = stores
    jax_path = str(tmp_path / "jax.lmdb")
    assert j_npz_to_lmdb.convert(npz, jax_path) == len(crystals)
    port = LmdbGraphStore(jax_path)
    ref = j_dataset.LmdbGraphStore(path)
    for i in range(len(crystals)):
        for key in ("z", "Hon", "Hoff", "spin_length", "edge_index"):
            np.testing.assert_array_equal(port[i][key], crystals[i][key], err_msg=key)
            np.testing.assert_array_equal(np.asarray(ref[i][key]), crystals[i][key],
                                          err_msg=key)


class _CountingStore:
    """A sequence of graphs that counts its reads."""

    def __init__(self, graphs):
        self.graphs, self.reads = graphs, []

    def __len__(self):
        return len(self.graphs)

    def __getitem__(self, i):
        self.reads.append(i)
        return self.graphs[i]


def test_data_module_keeps_a_store_lazy():
    store = _CountingStore(_crystals())
    dm = GraphDataModule(store, batch_size=2)
    assert dm.graphs is store and store.reads == []
    next(iter(dm.test_batches()))
    assert sorted(store.reads) == sorted(dm.test_idx[:2])
    # an iterator is read into a list
    assert len(GraphDataModule(iter(_crystals(2)), batch_size=1, test_mode=True).graphs) == 2


def test_prepare_dataset_validates_the_store_once(stores, monkeypatch):
    root, _npz, path, crystals = stores
    reads = []
    real = LmdbGraphStore._load
    monkeypatch.setattr(LmdbGraphStore, "_load",
                        lambda self, i: (reads.append(i), real(self, i))[1])
    cfg = load_config(None, overrides={"dataset_params": {
        "graph_data_path": path, "data_format": "lmdb", "batch_size": 2}})
    dm = t_cli.prepare_dataset(cfg, "cpu")
    assert isinstance(dm.graphs, LmdbGraphStore)
    assert sorted(reads) == list(range(len(crystals)))
    with pytest.raises(ImportError, match="lmdb"):
        LmdbGraphStore(str(root / "graph_data.npz"))


@pytest.mark.parametrize("fmt", ["lmdb", "auto"])
def test_cli_fits_and_tests_on_a_store(stores, tmp_path, fmt):
    _root, npz, path, crystals = stores
    cfg = {
        "setup": {"stage": "fit"},
        "dataset_params": {"graph_data_path": path, "data_format": fmt, "batch_size": 2},
        "optim_params": {"min_epochs": 0, "max_epochs": 1},
        "profiler_params": {"train_dir": str(tmp_path / "fit")},
        "representation_nets": {"HamGNN_pre": {
            "irreps_node_features": "4x0e+2x1o", "irreps_edge_sh": "0e+1o+2e",
            "num_layers": 1, "num_radial": 4, "cutoff": 4.0, "radial_MLP": [4],
            "num_types": 16}},
        "output_nets": {"HamGNN_out": {"nao_max": 14, "spin_constrained": True,
                                       "collinear_spin": True, "use_learned_weight": False}},
    }
    for stage in ("fit", "test"):
        if stage == "test":
            cfg["setup"] = {"stage": "test", "checkpoint_path": str(tmp_path / "fit" / "best")}
            cfg["profiler_params"] = {"train_dir": str(tmp_path / "test")}
        with open(tmp_path / "cfg.yaml", "w") as f:
            yaml.safe_dump(cfg, f)
        t_cli.main(["--config", str(tmp_path / "cfg.yaml"), "--device", "cpu"])
    pred = np.load(tmp_path / "test" / "prediction_hamiltonian.npy")
    rows = sum(c["z"].shape[0] + c["edge_index"].shape[1] for c in crystals)
    assert pred.shape == (rows, 2, 196) and np.isfinite(pred).all()
