"""The port's ``stage: test`` CLI and data loading against the JAX package.

The CLI of ``hamgnn_tpu_torch`` runs on the CPU with weights from an ``.npz``
of the JAX model's flattened flax tree (or the port's own state dict) and
must write the predictions ``model.apply`` gives on the same batches, in the
reference's interleaved layout.  f32 on both sides; atol 5e-5 / rtol 1e-4.
"""

import os

import jax
import numpy as np
import pytest
import torch
import yaml
from flax.traverse_util import flatten_dict
from util_fixtures import add_random_hamiltonian_targets, make_crystal

from hamgnn_tpu.cli import build_model as j_build
from hamgnn_tpu.data.dataset import GraphDataModule as JDataModule
from hamgnn_tpu.data.dataset import save_graph_npz
from hamgnn_tpu.models.output import concatenate_by_crystal as j_concat
from hamgnn_tpu.train.config import load_config as j_load_config
from hamgnn_tpu.train.trainer import init_params_on_cpu
from hamgnn_tpu_torch import cli as t_cli
from hamgnn_tpu_torch.interfaces.jax_params import load_flax_params
from hamgnn_tpu_torch.train.config import load_config

TOL = dict(atol=5e-5, rtol=1e-4)
BASE = {
    "representation_nets": {"HamGNN_pre": {
        "irreps_node_features": "8x0e+4x1o+2x2e", "irreps_edge_sh": "0e+1o+2e",
        "num_layers": 2, "num_radial": 8, "cutoff": 4.0, "radial_MLP": [8],
        "num_types": 16}},
    "output_nets": {"HamGNN_out": {"nao_max": 14}},
}


def _merge(a, b):
    out = dict(a)
    for k, v in b.items():
        out[k] = _merge(a[k], v) if isinstance(v, dict) and k in a else v
    return out


def _crystals(n, seed):
    rng = np.random.default_rng(seed)
    return [add_random_hamiltonian_targets(
        rng, make_crystal(rng, n_atoms=4 + i % 2, cutoff=4.0), nao_max=14)
        for i in range(n)]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """graph_data.npz, params.npz, model.pt and the JAX predictions."""
    root = tmp_path_factory.mktemp("cli")
    crystals = _crystals(4, seed=1)
    save_graph_npz(str(root / "graph_data.npz"), crystals)
    jm = j_build(j_load_config(None, overrides=BASE))
    batches = list(JDataModule(crystals, batch_size=2, test_mode=True).test_batches())
    params = init_params_on_cpu(jm, batches[0], 0)
    flat = {"/".join(k): np.asarray(v) for k, v in flatten_dict(params["params"]).items()}
    np.savez(root / "params.npz", **flat)
    tm = t_cli.build_model(load_config(None, overrides=BASE))
    load_flax_params(tm, flat)
    torch.save(tm.state_dict(), root / "model.pt")
    apply = jax.jit(jm.apply)
    pred, target = [], []
    for g in batches:
        p = apply(params, g)
        pred.append(j_concat(g, p["hamiltonian_on"], p["hamiltonian_off"]))
        target.append(j_concat(g, np.asarray(g.Hon), np.asarray(g.Hoff)))
    return root, np.concatenate(pred), np.concatenate(target)


@pytest.mark.parametrize("ckpt", ["params.npz", "model.pt"])
def test_cli_stage_test_predictions(case, tmp_path, ckpt):
    root, j_pred, j_target = case
    cfg = _merge(BASE, {
        "setup": {"stage": "test", "checkpoint_path": str(root / ckpt)},
        "dataset_params": {"graph_data_path": str(root), "batch_size": 2},
        "profiler_params": {"train_dir": str(tmp_path / "out")},
    })
    with open(tmp_path / "config.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    t_cli.main(["--config", str(tmp_path / "config.yaml"), "--device", "cpu"])
    pred = np.load(tmp_path / "out" / "prediction_hamiltonian.npy")
    target = np.load(tmp_path / "out" / "target_hamiltonian.npy")
    assert pred.shape == j_pred.shape and np.isfinite(pred).all()
    np.testing.assert_allclose(pred, j_pred, **TOL)
    np.testing.assert_array_equal(target, j_target)
    assert os.path.exists(tmp_path / "out" / "config_resolved.yaml")


_MAGNETIC = {"output_nets": {"HamGNN_out": {"spin_constrained": True,
                                            "collinear_spin": True}}}


@pytest.mark.parametrize("override,match", [
    (_merge({"setup": {"stage": "fit", "parallel": {"mode": "dp"}}}, _MAGNETIC), "GraphView"),
    (_merge({"setup": {"stage": "fit", "parallel": {"mode": "halo"}}}, _MAGNETIC), "GraphView"),
    ({"setup": {"stage": "test", "checkpoint_path": "{tmp}/orbax"}}, "directory"),
])
def test_cli_unported_paths_raise(tmp_path, override, match):
    """What the port does not run: the magnetic head under data parallel or
    the halo partition (it has no GraphView forward, and raises the JAX
    package's NotImplementedError); and a checkpoint directory that is not an
    orbax checkpoint (orbax directories themselves are read,
    ``tests/test_torch_port_compat.py``)."""
    exc = NotImplementedError
    if "checkpoint_path" in override["setup"]:
        (tmp_path / "orbax").mkdir()
        override = {"setup": dict(override["setup"], checkpoint_path=str(tmp_path / "orbax"))}
        exc = FileNotFoundError
    cfg = load_config(None, overrides=_merge(_merge(BASE, {
        "dataset_params": {"graph_data_path": str(tmp_path)},
        "profiler_params": {"train_dir": str(tmp_path / "out")}}), override))
    save_graph_npz(str(tmp_path / "graph_data.npz"), _crystals(2, seed=0))
    with pytest.raises(exc, match=match):
        t_cli.train_and_evaluate(cfg, device="cpu")
    import torch.distributed as dist

    assert not dist.is_initialized()   # the CLI took down the group it brought up


def test_entry_points_default_to_cuda():
    from hamgnn_tpu_torch import resolve_device

    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()


def test_dataset_batches_match(tmp_path):
    """Same split, buckets and batch-global inverse edges as the JAX loader."""
    from hamgnn_tpu.data.dataset import load_graph_npz as j_load
    from hamgnn_tpu_torch.data.dataset import GraphDataModule as TDataModule
    from hamgnn_tpu_torch.data.dataset import load_graph_npz as t_load

    crystals = _crystals(5, seed=2)
    for i, c in enumerate(crystals):
        c["doping_charge"] = np.array([0.5 * i])
    save_graph_npz(str(tmp_path / "g.npz"), crystals)
    jd = JDataModule(j_load(str(tmp_path / "g.npz")), batch_size=2)
    td = TDataModule(t_load(str(tmp_path / "g.npz")), batch_size=2)
    assert (jd.train_idx, jd.val_idx, jd.test_idx) == (td.train_idx, td.val_idx, td.test_idx)
    pairs = list(zip(list(jd.val_batches()) + list(jd.test_batches()),
                     list(td.val_batches()) + list(td.test_batches())))
    assert pairs
    for jb, tb in pairs:
        for f in ("z", "pos", "node_mask", "batch", "edge_index", "edge_mask",
                  "nbr_shift", "cell_shift", "inv_edge_idx", "cell", "node_counts",
                  "edge_counts", "doping_charge", "edge_group_tar", "Hon", "Hoff",
                  "Son", "Soff", "Hon0", "Hoff0"):
            np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                          np.asarray(getattr(jb, f)), err_msg=f)
