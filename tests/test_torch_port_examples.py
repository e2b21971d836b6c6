"""The shipped examples' accuracy chains through the port
(``hamgnn_tpu_torch/tools_dev/sk_accuracy.py --example``) against the JAX
package, on the CPU at a tiny size:

* every ``--example`` end to end with ``--device cpu`` on 5 structures at a
  narrow width, 1 epoch: the result line and ``result.json`` with every key,
  finite numbers, the marks judged; ``--resume`` on a spin npz and on the
  LMDB store; ``--soc`` as ``--example sk_soc``;
* SIESTA and ABACUS bands: the port's band computation on one tiny crystal's
  teacher H (float64) equal within 1e-8 eV to the JAX package's
  ``tools.band_cal`` in the same basis, and the harness's band deviation of a
  perturbed prediction equal to ``tools_dev/band_acceptance.py``'s
  arithmetic on the JAX side;
* the collinear decomposition: its MAE and mean |splitting| against a numpy
  transcription of ``tools_dev/collinear_diag.py`` step 3, and its spatial
  and splitting parts (the port's own definition, which no JAX script
  computes) on predictions off in one part only; each chain's train / val /
  test split against the JAX package's;
* a tiny ``sk_siesta`` and ``sk_collinear`` fit on the harness's own packed
  data, 6 steps of the port's trainer against the JAX trainer from the same
  weights at the config's learning rate: losses within rtol 1e-4
  (``test_torch_port_train.py``'s step tolerance); and the port's initial
  weights drawn as the flax init draws them.
"""

import json
import shutil

import numpy as np
import pytest
import torch
import yaml
from flax.traverse_util import flatten_dict

from hamgnn_tpu.cli import build_model as j_build
from hamgnn_tpu.data.dataset import GraphDataModule as JDataModule
from hamgnn_tpu.data.dataset import reference_split as j_split
from hamgnn_tpu.models.basis import get_basis_set as j_basis
from hamgnn_tpu.physics.kpoints import auto_k_path as j_auto_k_path
from hamgnn_tpu.tools.band_cal import band_structure_for_crystal as j_bands
from hamgnn_tpu.train import trainer as j_trainer
from hamgnn_tpu.train.config import load_config as j_load_config
from hamgnn_tpu_torch import cli as t_cli
from hamgnn_tpu_torch.data.dataset import GraphDataModule as TDataModule
from hamgnn_tpu_torch.data.dataset import load_graph_npz
from hamgnn_tpu_torch.data.dataset import reference_split as t_split
from hamgnn_tpu_torch.interfaces.jax_params import load_flax_params
from hamgnn_tpu_torch.models.model import init_weights
from hamgnn_tpu_torch.models.basis import get_basis_set as t_basis
from hamgnn_tpu_torch.physics.kpoints import auto_k_path as t_auto_k_path
from hamgnn_tpu_torch.tools.band_cal import band_structure_for_crystal as t_bands
from hamgnn_tpu_torch.tools_dev import sk_accuracy, sk_examples
from hamgnn_tpu_torch.train import trainer as t_trainer
from hamgnn_tpu_torch.train.config import config_to_dict, load_config

NARROW = dict(irreps_node_features="4x0e+2x1o+2x2e", num_radial=4, radial_MLP=[4])
SPIN = ("sk_collinear", "sk_ncl", "sk_spinsoc")
KEYS = ("example", "soc", "test_mae_Ha", "test_metrics", "best_val_mae_Ha", "best_val_metrics",
        "best_val_epoch", "val_mae_last_Ha", "test_mae_best_Ha", "epochs", "sec_per_epoch_median", "sec_first_epoch",
        "band_dev_max_meV", "band_dev_mean_meV", "bands", "seconds", "resumed", "seed", "init_seed",
        "band_ft", "tp_launches_run", "tp_launches_per_step", "jax", "card", "marks")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A copy of ``examples/`` whose configs have 1-layer narrow networks."""
    root = tmp_path_factory.mktemp("root")
    shutil.copytree(sk_accuracy.ROOT / "examples", root / "examples")
    for path in (root / "examples").glob("*/config*.yaml"):
        cfg = yaml.safe_load(path.read_text())
        cfg["representation_nets"]["HamGNN_pre"].update(NARROW, num_layers=1)
        path.write_text(yaml.safe_dump(cfg))
    return root


def _sizes(name):
    return ["--n", "5"] if name in SPIN else ["--n-si", "2", "--n-c", "2", "--n-sic", "1"]


def _run(monkeypatch, root, out, name, *extra):
    monkeypatch.setattr(sk_accuracy, "ROOT", root)
    return sk_accuracy.main(["--example", name, "--out", str(out), "--device", "cpu",
                             *_sizes(name), *extra])


def _finite(*values):
    return all(v is not None and np.isfinite(v) for v in values)


@pytest.mark.parametrize("name", sorted(sk_examples.EXAMPLES))
def test_every_example_runs_on_the_cpu(tmp_path, monkeypatch, tiny_root, name):
    ex = sk_examples.EXAMPLES[name]
    r = _run(monkeypatch, tiny_root, tmp_path / "out", name, "--max-epochs", "1")
    assert all(k in r for k in KEYS), [k for k in KEYS if k not in r]
    assert json.loads((tmp_path / "out" / "result.json").read_text()) == \
        json.loads(json.dumps(r))
    assert r["example"] == name and r["epochs"] == 1 and not r["resumed"]
    assert _finite(r["test_mae_Ha"], r["best_val_mae_Ha"], *r["test_metrics"].values())
    # one epoch: best is the final state, on the same test split
    assert r["test_mae_best_Ha"] == r["test_mae_Ha"] and r["val_mae_last_Ha"] == r["best_val_mae_Ha"]
    if name in ("sk_ncl", "sk_spinsoc", "sk_soc"):
        assert set(r["test_metrics"]) == {"mae_hamiltonian_real", "mae_hamiltonian_imag"}
    # the plain versions on the CPU launch no kernel
    assert r["tp_launches_run"] == {} and r["tp_launches_per_step"] == {}
    assert set(r["marks"]) == {key for key, _limit in ex.marks}
    for key, mark in r["marks"].items():
        assert mark["met"] == (mark["value"] <= mark["limit"]), key
    if ex.acceptance == "mae":
        assert r["bands"] == [] and r["band_dev_mean_meV"] is None
    else:
        assert _finite(r["band_dev_max_meV"], r["band_dev_mean_meV"])
    if ex.acceptance == "bands":
        assert len(r["bands"]) == 3
    if ex.acceptance == "collinear":
        assert _finite(*r["decomposition"].values())
        assert sorted(r["spin_bands"]) == ["0", "1"]
        assert len(list((tmp_path / "out" / "bands").glob("band_spin*_*.npz"))) == 6
    if ex.lmdb:
        assert r["store"] == "lmdb-lite"
    # the data and the test set's arrays are removed, the checkpoint kept
    assert not (tmp_path / "out" / "datasets").exists()
    assert (tmp_path / "out" / "train" / "best.pt").exists()
    assert not list((tmp_path / "out" / "train").glob("*.npy"))


@pytest.mark.parametrize("name", ["sk_ncl", "sk_lmdb"])
def test_resume_continues_an_example(tmp_path, monkeypatch, tiny_root, name):
    first = _run(monkeypatch, tiny_root, tmp_path, name, "--max-epochs", "1")
    again = _run(monkeypatch, tiny_root, tmp_path, name, "--max-epochs", "2", "--resume")
    assert (first["epochs"], again["epochs"]) == (1, 2) and again["resumed"]
    assert _finite(again["test_mae_Ha"])


def test_soc_is_the_sk_soc_example(tmp_path, monkeypatch):
    seen = []
    monkeypatch.setattr(sk_accuracy, "make_data", lambda name, *a: seen.append(name) or 1 / 0)
    with pytest.raises(ZeroDivisionError):
        sk_accuracy.main(["--soc", "--device", "cpu", "--out", str(tmp_path / "out")])
    assert seen == ["sk_soc"]
    for argv in (["--soc", "--example", "sk"], ["--band-ft", "--example", "sk_ncl"]):
        with pytest.raises(SystemExit):
            sk_accuracy.main(argv + ["--device", "cpu"])


def test_init_seed_is_a_fresh_start_from_that_draw(tmp_path, monkeypatch, tiny_root):
    """``--init-seed 666`` (the CLI's own draw) reproduces the default run;
    ``initial_checkpoint`` holds ``init_weights``' draw of its seed and a
    fresh optimizer state."""
    runs = [_run(monkeypatch, tiny_root, tmp_path / tag, "sk_ncl", "--max-epochs", "1", *extra)
            for tag, extra in (("a", ()), ("b", ("--init-seed", "666")))]
    assert runs[1]["init_seed"] == runs[0]["init_seed"] == 666
    assert runs[1]["test_metrics"] == runs[0]["test_metrics"]
    config = tiny_root / "examples" / "sk_ncl" / "config.yaml"
    path = sk_accuracy.initial_checkpoint(config, 1, tmp_path / "init.pt")
    ckpt = torch.load(path)
    model = init_weights(t_cli.build_model(load_config(str(config))), 1)
    for n, p in model.named_parameters():
        assert torch.equal(ckpt["params"][n], p.detach()), n
    assert all(float(v.abs().sum()) == 0 for v in ckpt["opt_state"].values())
    with pytest.raises(SystemExit):
        sk_accuracy.main(["--init-seed", "1", "--resume", "--device", "cpu",
                          "--out", str(tmp_path / "c")])


# ----------------------------------------------------------------------
# SIESTA and ABACUS bands against the JAX package's band_cal
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    """The harness's steps 1-2 (the teacher, packed through the native readers) for one
    Si, one C and one SiC in each container format: {example: graphs}."""
    out = {}
    for name in ("sk_siesta", "sk_abacus"):
        root = tmp_path_factory.mktemp(name)
        ex = sk_examples.EXAMPLES[name]
        args = type("A", (), dict(n_si=1, n_c=1, n_sic=1, n=None, seed=7))
        graphs = sk_accuracy.make_data(name, ex, args, root / "datasets" / name, {})
        out[name] = graphs
    return out


@pytest.mark.parametrize("name", ["sk_siesta", "sk_abacus"])
def test_bands_equal_the_jax_band_cal(packed, name):
    ex = sk_examples.EXAMPLES[name]
    nao = 19 if ex.ham_type == "siesta" else 27
    c = load_graph_npz(str(packed[name]["band"] / "graph_data.npz"))[2]  # SiC
    rows = np.concatenate([np.asarray(c["Hon"]), np.asarray(c["Hoff"])]).astype(np.float64)
    cell = np.asarray(c["cell"], float).reshape(3, 3)
    nodes, _ = t_auto_k_path(cell)
    assert np.array_equal(np.asarray(nodes, float), np.asarray(j_auto_k_path(cell)[0], float))
    got = t_bands(c, rows, nao, t_basis(ex.ham_type, nao), 12, nodes)
    ref = j_bands(c, rows, nao, j_basis(ex.ham_type, nao), 12, nodes)
    assert got["bands"].shape == ref["bands"].shape and got["bands"].dtype == np.float64
    np.testing.assert_allclose(got["bands"], ref["bands"], rtol=0, atol=1e-8)
    assert abs(got["fermi"] - ref["fermi"]) <= 1e-8 and abs(got["gap"] - ref["gap"]) <= 1e-8


@pytest.mark.parametrize("name", ["sk_siesta", "sk_abacus"])
def test_band_deviation_is_band_acceptances(tmp_path, packed, name):
    """``sk_examples.band_deviation`` of the teacher plus noise against the
    arithmetic of ``tools_dev/band_acceptance.py`` through the JAX package."""
    ex = sk_examples.EXAMPLES[name]
    nao = 19 if ex.ham_type == "siesta" else 27
    path = str(packed[name]["band"] / "graph_data.npz")
    graphs = load_graph_npz(path)
    teacher = np.concatenate([np.concatenate([c["Hon"], c["Hoff"]]) for c in graphs])
    pred = teacher + np.random.default_rng(0).normal(scale=1e-3, size=teacher.shape) * (
        teacher != 0)
    np.save(tmp_path / "prediction_hamiltonian.npy", pred.astype(np.float32))
    got = sk_examples.band_deviation(path, str(tmp_path), ex.ham_type, nao, False, nk=8)
    devs, ofs = [], 0
    for c in graphs:
        n, e = len(c["z"]), np.asarray(c["edge_index"]).shape[1]
        h_pred = np.load(tmp_path / "prediction_hamiltonian.npy")[ofs:ofs + n + e]
        ofs += n + e
        nodes, _ = j_auto_k_path(np.asarray(c["cell"], float).reshape(3, 3))
        basis = j_basis(ex.ham_type, nao)
        rp = j_bands(c, h_pred, nao, basis, 8, nodes)
        rr = j_bands(c, np.concatenate([c["Hon"], c["Hoff"]]), nao, basis, 8, nodes)
        win = np.abs(rr["bands"] - rr["fermi"]) < 5.0
        devs.append(np.abs(rp["bands"] - rr["bands"])[win])
    dev = np.concatenate([d.ravel() for d in devs])
    assert 0 < got["band_dev_mean_meV"]
    assert abs(got["band_dev_max_meV"] - dev.max() * 1e3) <= 1e-5
    assert abs(got["band_dev_mean_meV"] - dev.mean() * 1e3) <= 1e-5


# ----------------------------------------------------------------------
# the collinear decomposition
# ----------------------------------------------------------------------

def _collinear_diag_step3(pred, tgt, row_mask):
    """``tools_dev/collinear_diag.py`` step 3 in numpy: its masked MAE over
    every entry of the valid rows and its mean |splitting|, 0.5 * (up - down)
    of the target."""
    mask2 = np.broadcast_to(row_mask[:, None, None], tgt.shape).astype(np.float64)
    split = 0.5 * (tgt[:, 0] - tgt[:, 1])
    return {"mae_Ha": float(np.sum(np.abs(pred - tgt) * mask2) / np.sum(mask2)),
            "mean_abs_splitting_Ha": float(np.sum(np.abs(split) * mask2[:, 0])
                                           / np.sum(mask2[:, 0]))}


def test_collinear_decomposition_is_collinear_diags(tmp_path):
    from hamgnn_tpu_torch.tools import sk_dataset

    sk_dataset.run(["collinear", "--out", str(tmp_path / "c"), "--n", "2"])
    crystals = load_graph_npz(str(tmp_path / "c" / "graph_data.npz"))
    tgt = np.concatenate([np.concatenate([c["Hon"], c["Hoff"]]) for c in crystals])
    assert tgt.ndim == 3 and tgt.shape[1] == 2
    rng = np.random.default_rng(3)
    pred = (tgt + rng.normal(scale=2e-3, size=tgt.shape)).astype(np.float32)
    got = sk_examples.spin_decomposition(pred, tgt)
    assert set(got) == {"mae_Ha", "mean_abs_splitting_Ha", "spatial_mae_Ha",
                        "splitting_mae_Ha"}
    # the diagnostic's padded batch: rows past the crystals carry mask 0
    pad = np.zeros((7,) + tgt.shape[1:])
    ref = _collinear_diag_step3(np.concatenate([pred, pad + 5.0]), np.concatenate([tgt, pad]),
                                np.r_[np.ones(len(tgt)), np.zeros(7)])
    for key in ref:
        assert got[key] == pytest.approx(ref[key], rel=1e-12), key
    assert got["mean_abs_splitting_Ha"] > 0
    # the two parts: an error the same in both channels is spatial alone, an
    # error of opposite signs is splitting alone, each of its mean size
    d = rng.normal(scale=1e-3, size=tgt[:, 0].shape)
    same = sk_examples.spin_decomposition(tgt + d[:, None], tgt)
    opposite = sk_examples.spin_decomposition(tgt + np.stack([d, -d], 1), tgt)
    size = float(np.abs(d).mean())
    assert same["spatial_mae_Ha"] == pytest.approx(size, rel=1e-12)
    assert opposite["splitting_mae_Ha"] == pytest.approx(size, rel=1e-12)
    assert max(same["splitting_mae_Ha"], opposite["spatial_mae_Ha"]) <= 1e-15
    assert same["mae_Ha"] == opposite["mae_Ha"] == pytest.approx(size, rel=1e-12)
    with pytest.raises(ValueError):
        sk_examples.spin_decomposition(pred[:, 0], tgt[:, 0])


@pytest.mark.parametrize("n", [160, 320, 120, 100])
def test_examples_split_their_sets_as_jax(n):
    """The train / val / test split of each chain's set (SIESTA, ABACUS, LMDB,
    the spin sets) at the configs' 0.6 / 0.2 / 0.2."""
    for a, b in zip(t_split(n, 0.6, 0.2, 0.2), j_split(n, 0.6, 0.2, 0.2), strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ----------------------------------------------------------------------
# the port's trainer against the JAX trainer on the examples' own data
# ----------------------------------------------------------------------

def _narrow_config(name):
    cfg = yaml.safe_load((sk_accuracy.ROOT / "examples" / name / "config.yaml").read_text())
    # the narrow features reach l = 2: edge SH to 2e, which keeps the JAX step's compile short
    cfg["representation_nets"]["HamGNN_pre"].update(NARROW, num_layers=1,
                                                    irreps_edge_sh="0e + 1o + 2e")
    for section in ("setup", "profiler_params", "dataset_params"):
        cfg.pop(section, None)
    return cfg


@pytest.mark.parametrize("name", ["sk_siesta", "sk_collinear"])
def test_example_steps_match_the_jax_trainer(tmp_path, packed, name):
    """Six steps of the example's (narrowed) config at its own losses and
    learning rate on its chain's data: the port's trainer and the JAX
    trainer from the same weights. And the port's own initial weights
    (``init_weights``) against the flax init's: the same parameters drawn,
    at the same spread, and the same fixed values."""
    if name == "sk_collinear":
        from hamgnn_tpu_torch.tools import sk_dataset

        sk_dataset.run(["collinear", "--out", str(tmp_path / "c"), "--n", "3"])
        crystals = load_graph_npz(str(tmp_path / "c" / "graph_data.npz"))
    else:
        crystals = load_graph_npz(str(packed[name]["train"] / "graph_data.npz"))
    cfg = _narrow_config(name)
    t_cfg = load_config(None, overrides=cfg)
    losses = [config_to_dict(s) for s in t_cfg.losses_metrics.losses]
    kw = dict(losses=losses, metrics=[], lr=float(cfg["optim_params"]["lr"]), min_epochs=0,
              max_epochs=2)
    jd = JDataModule(crystals, batch_size=2, train_ratio=1.0, val_ratio=0.0, test_ratio=0.0)
    td = TDataModule(crystals, batch_size=2, train_ratio=1.0, val_ratio=0.0, test_ratio=0.0,
                     device="cpu")
    jb = list(jd.train_batches(np.random.default_rng(1)))
    tb = list(td.train_batches(np.random.default_rng(1)))
    jt = j_trainer.Trainer(j_build(j_load_config(None, overrides=cfg)),
                           train_dir=str(tmp_path / "jax"), **kw)
    jt.init_params(jb[0])
    tm = t_cli.build_model(t_cfg)
    load_flax_params(tm, {"/".join(k): np.asarray(v)
                          for k, v in flatten_dict(jt.params["params"]).items()})
    own = dict(init_weights(t_cli.build_model(t_cfg), 666).named_parameters())
    checked = []
    for n, p in tm.named_parameters():
        a, b = own[n].detach().numpy(), p.detach().numpy()
        if b.std() == 0:
            np.testing.assert_array_equal(a, b, err_msg=n)
        elif b.size >= 64:
            assert 0.8 < a.std() / b.std() < 1.25, n
            checked.append(n)
    assert len(checked) >= 10
    tt = t_trainer.Trainer(tm, train_dir=str(tmp_path / "torch"), device="cpu", **kw)
    j_losses, t_losses = [], []
    for _step in range(6):  # one batch shape: one compile of the JAX step
        j_losses.append(jt.train_epoch([jb[0]]))
        loss, logs = tt.train_step(tb[0])
        t_losses.append(float(loss))
        assert float(logs["nonfinite_step"]) == 0.0
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4, atol=0)
    assert t_losses[-1] < t_losses[0]
