"""The port's magnetic head (``models/spin.py``) against the JAX package's.

* the host tables, element-exact: ``j_irreps``, ``_rank2_merge_matrix`` and
  ``_rank0_merge_matrix`` (openmx 14 and 19, siesta 19, abacus 27);
* ``heisenberg_terms`` in its three branches (collinear, non-collinear,
  non-collinear with SOC) on one padded crystal with a non-magnetic atom,
  edges with zero and non-zero cell shifts and more than one edge per
  (target atom, shift) group: the JAX complex result as ``.real`` and
  ``.imag`` against the port's two real parts, atol 5e-5 / rtol 1e-4;
* ``HamGNNMagneticOut`` on the same weights (flax init ->
  ``load_flax_params``) and the same numpy features, for the three branches
  x ``use_learned_weight``, with ``add_H0`` and ``symmetrize`` both on (the
  shipped configs) and both off: every output and
  the configs' losses at atol 5e-5 / rtol 1e-4; the gradients of the masked
  MAE against ``jax.grad`` within 5e-4 * max|ref| per tensor;
* the collinear band branch against the JAX head: bands and gaps within 5e-4;
* ``data.synthetic.add_random_spin_targets``: the fields, their shapes, the
  Hermitian structure through the inverse edge, a weak moment in each crystal;
* the CLI, collinear and non-collinear: ``stage: test`` through both CLIs on
  the JAX CLI's initial weights writes the same ``prediction_hamiltonian*.npy``;
  ``stage: fit`` then ``stage: test`` from ``<train_dir>/best``;
* the trainer: the steps take nothing from the host after a first run, so the
  trainer captures them on the card, those of the collinear head with bands too.

f32 on both sides; small widths (features up to 2e and 2o, one layer,
3-atom crystals).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax.traverse_util import flatten_dict
from util_fixtures import add_random_hamiltonian_targets, make_crystal

from hamgnn_tpu import cli as j_cli
from hamgnn_tpu.data.graph import pad_and_batch as j_pad
from hamgnn_tpu.models import spin as j_spin
from hamgnn_tpu.models.basis import get_basis_set as j_basis
from hamgnn_tpu.models.model import compute_losses as j_losses
from hamgnn_tpu.train.config import load_config as j_load_config
from hamgnn_tpu_torch import cli as t_cli
from hamgnn_tpu_torch.data.dataset import save_graph_npz
from hamgnn_tpu_torch.data.graph import pad_and_batch as t_pad
from hamgnn_tpu_torch.data.synthetic import add_random_spin_targets
from hamgnn_tpu_torch.interfaces.jax_params import load_flax_params
from hamgnn_tpu_torch.models import spin as t_spin
from hamgnn_tpu_torch.models.basis import get_basis_set
from hamgnn_tpu_torch.models.model import compute_losses as t_losses
from hamgnn_tpu_torch.models.model import init_weights
from hamgnn_tpu_torch.train import trainer as t_trainer
from hamgnn_tpu_torch.train.config import load_config

FEAT = "4x0e+2x0o+2x1o+2x1e+2x2e+1x2o"
NAO = 14
BIG = (2 * NAO) ** 2
TOL = dict(atol=5e-5, rtol=1e-4)
MODES = ("collinear", "noncollinear", "spinsoc")
# mode -> (soc_switch, collinear_spin)
BRANCH = {"collinear": (False, True), "noncollinear": (False, False),
          "spinsoc": (True, False)}
HAM = [{"metric": "mae", "prediction": "hamiltonian", "target": "hamiltonian",
        "loss_weight": 27.211}]
NCL = [{"metric": "mae", "prediction": p, "target": p, "loss_weight": 27.211}
       for p in ("hamiltonian_real", "hamiltonian_imag")]
NCL_KEYS = ("hamiltonian_real_on", "hamiltonian_real_off", "hamiltonian_imag_on",
            "hamiltonian_imag_off")
CLI_BASE = {
    "representation_nets": {"HamGNN_pre": {
        "irreps_node_features": "8x0e+4x1o+2x2e", "irreps_edge_sh": "0e+1o+2e",
        "num_layers": 1, "num_radial": 8, "cutoff": 4.0, "radial_MLP": [8],
        "num_types": 16}},
    "output_nets": {"HamGNN_out": {
        "nao_max": NAO, "spin_constrained": True, "use_learned_weight": False,
        "minMagneticMoment": 0.5, "add_H0": True, "symmetrize": True,
        "zero_point_shift": False}},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so that parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _merge(a, b):
    out = dict(a)
    for k, v in b.items():
        out[k] = _merge(a[k], v) if isinstance(v, dict) and k in a else v
    return out


def _flat(params):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(params).items()}


def _spin_crystal(rng, mode, n_atoms=3, random_h0=True):
    c = add_random_spin_targets(rng, add_random_hamiltonian_targets(
        rng, make_crystal(rng, n_atoms=n_atoms, species=(6, 14)), nao_max=NAO), mode)
    if random_h0:
        for key in ("Hon0", "Hoff0", "iHon0", "iHoff0"):
            if key in c:
                c[key] = 0.01 * rng.normal(size=c[key].shape)
    return c


def _losses(mode):
    return HAM if mode == "collinear" else NCL


def _cli_out(mode):
    soc, collinear = BRANCH[mode]
    return {"output_nets": {"HamGNN_out": {"collinear_spin": collinear, "soc_switch": soc}},
            "losses_metrics": {"losses": _losses(mode), "metrics": _losses(mode)}}


# ----------------------------------------------------------------------
# host tables and the Heisenberg terms
# ----------------------------------------------------------------------

@pytest.mark.parametrize("ham_type,nao", [("openmx", 14), ("openmx", 19), ("siesta", 19),
                                          ("abacus", 27)])
def test_tables_equal_the_jax_packages(ham_type, nao):
    for soc in (False, True):
        assert repr(t_spin.j_irreps(get_basis_set(ham_type, nao), soc)) == repr(
            j_spin.j_irreps(j_basis(ham_type, nao), soc))
    for name in ("_rank2_merge_matrix", "_rank0_merge_matrix"):
        got, want = getattr(t_spin, name)(ham_type, nao), getattr(j_spin, name)(ham_type, nao)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(t_spin.SIGMA, j_spin.SIGMA)


@pytest.fixture(scope="module")
def terms_case():
    """A 3-atom crystal (5 A cell, cutoff 4) padded by both packages, atom 1
    not magnetic."""
    rng = np.random.default_rng(1)
    c = make_crystal(rng, n_atoms=3, species=(6, 14), cell_size=5.0, cutoff=4.0)
    jg, tg = j_pad([c], bucket_multiple=8), t_pad([c], bucket_multiple=8)
    shifts = c["cell_shift"]
    zero = np.all(shifts == 0, axis=1)
    assert zero.any() and (~zero).any()
    groups = np.unique(tg.edge_group_tar.numpy()[: shifts.shape[0]], return_counts=True)[1]
    assert groups.max() > 1
    assert tg.num_nodes > 3 and tg.num_edges > shifts.shape[0]
    mag = np.zeros(tg.num_nodes, np.float32)
    mag[[0, 2]] = 1.0
    return rng, jg, tg, mag


@pytest.mark.parametrize("mode", MODES)
def test_heisenberg_terms_match_jax(terms_case, mode):
    rng, jg, tg, mag = terms_case
    soc, collinear = BRANCH[mode]
    N, E = tg.num_nodes, tg.num_edges
    jshape = (NAO, NAO, 3, 3) if soc else (NAO, NAO)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((N, *jshape), (E, *jshape), (N, NAO, NAO), (E, NAO, NAO), (N, 3))]
    j_on, j_off = j_spin.heisenberg_terms(jg, *arrs, mag, soc=soc, collinear=collinear)
    (on_r, on_i), (off_r, off_i) = t_spin.heisenberg_terms(
        tg, *map(torch.as_tensor, arrs), torch.as_tensor(mag), soc, collinear)
    for got, want, what in ((on_r, j_on, "on"), (off_r, j_off, "off")):
        np.testing.assert_allclose(got.numpy(), np.real(np.asarray(want)), err_msg=what, **TOL)
    if collinear:
        assert on_i is None and off_i is None and not np.iscomplexobj(np.asarray(j_on))
    else:
        for got, want, what in ((on_i, j_on, "on"), (off_i, j_off, "off")):
            np.testing.assert_allclose(got.numpy(), np.imag(np.asarray(want)), err_msg=what,
                                       **TOL)
    # the padded atoms carry no term
    np.testing.assert_array_equal(on_r[3:].numpy(), 0.0)


# ----------------------------------------------------------------------
# the head
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def cases():
    """Per mode: one 3-atom crystal with spin targets padded by both
    packages, and random features."""
    out = {}
    d = t_spin.Irreps(FEAT).dim
    rng = np.random.default_rng(11)
    base = add_random_hamiltonian_targets(rng, make_crystal(rng, n_atoms=3, species=(6, 14)),
                                          nao_max=NAO)
    for mode in MODES:
        # one geometry for all modes: JAX compiles each primitive once
        c = add_random_spin_targets(rng, base, mode)
        for key in ("Hon0", "Hoff0", "iHon0", "iHoff0"):
            if key in c:
                c[key] = 0.01 * rng.normal(size=c[key].shape)
        tg = t_pad([c], bucket_multiple=8)
        feats = {"node_attr": rng.normal(size=(tg.num_nodes, d)).astype(np.float32),
                 "edge_attr": rng.normal(size=(tg.num_edges, d)).astype(np.float32)}
        out[mode] = (j_pad([c], bucket_multiple=8), tg, feats)
    return out


_PARAMS = {}


def _heads(cases, mode, **kw):
    """The JAX head with its flax parameters and the port's head on them;
    the parameters are made once per (mode, use_learned_weight)."""
    jg, _tg, feats = cases[mode]
    soc, collinear = BRANCH[mode]
    kw = dict(irreps_in_node=FEAT, irreps_in_edge=FEAT, nao_max=NAO, ham_type="openmx",
              soc_switch=soc, collinear_spin=collinear, **kw)
    jh = j_spin.HamGNNMagneticOut(**kw)
    key = (mode, kw.get("use_learned_weight", True))
    if key not in _PARAMS:
        _PARAMS[key] = jh.init(jax.random.PRNGKey(1), jg,
                               {k: jnp.asarray(v) for k, v in feats.items()})
    th = t_spin.HamGNNMagneticOut(**kw)
    load_flax_params(th, _flat(_PARAMS[key]["params"]))
    return jh, _PARAMS[key], th


def _t_feats(feats, grad=False):
    return {k: torch.as_tensor(v).requires_grad_(grad) for k, v in feats.items()}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("learned", [False, True])
@pytest.mark.parametrize("add_H0,symmetrize", [(True, True), (False, False)])
def test_magnetic_head_matches_jax(cases, mode, learned, add_H0, symmetrize):
    jg, tg, feats = cases[mode]
    jh, params, th = _heads(cases, mode, use_learned_weight=learned, add_H0=add_H0,
                            symmetrize=symmetrize)
    assert hasattr(th, "onsite_weight") == learned
    jr = jh.apply(params, jg, {k: jnp.asarray(v) for k, v in feats.items()})
    with torch.no_grad():
        tr = th(tg, _t_feats(feats))
    assert set(tr) == set(jr)
    for k in jr:
        np.testing.assert_allclose(tr[k].numpy(), np.asarray(jr[k]), err_msg=k, **TOL)
    if mode == "collinear":
        assert tuple(tr["hamiltonian_on"].shape) == (tg.num_nodes, 2, NAO * NAO)
        assert tuple(tr["mask_off"].shape) == (tg.num_edges, 2, NAO * NAO)
    else:
        assert all(tr[k].shape[1] == BIG for k in NCL_KEYS)
        if symmetrize:
            # H = H^dagger through the inverse edge (H0 aside)
            inv, m = tg.inv_edge_idx, tg.edge_mask
            for part, sign, h0 in (("real", 1.0, tg.Hoff0), ("imag", -1.0, tg.iHoff0)):
                h = tr[f"hamiltonian_{part}_off"] - (h0 if add_H0 else 0)
                h = h.reshape(-1, 2 * NAO, 2 * NAO)
                torch.testing.assert_close(h[m], sign * h[inv][m].mT, atol=1e-6, rtol=0)
    jl, _ = j_losses(jr, jg, _losses(mode))
    tl, _ = t_losses(tr, tg, _losses(mode))
    np.testing.assert_allclose(float(tl), float(jl), **TOL)


@pytest.mark.parametrize("mode", MODES)
def test_magnetic_head_gradients_match_jax(cases, mode):
    """d(the configs' masked MAE) by every parameter and both feature
    inputs, against ``jax.grad``: 5e-4 * max|ref| per tensor."""
    jg, tg, feats = cases[mode]
    jh, params, th = _heads(cases, mode)

    def j_loss(p, f):
        return j_losses(jh.apply(p, jg, f), jg, _losses(mode))[0]

    gp, gf = jax.grad(j_loss, argnums=(0, 1))(params, {k: jnp.asarray(v)
                                                       for k, v in feats.items()})
    tf = _t_feats(feats, grad=True)
    t_losses(th(tg, tf), tg, _losses(mode))[0].backward()
    got = {n.replace(".", "/"): p.grad.numpy() for n, p in th.named_parameters()}
    got.update({k: v.grad.numpy() for k, v in tf.items()})
    want = _flat(gp["params"])
    want.update({k: np.asarray(v) for k, v in gf.items()})
    assert set(got) == set(want)
    for k, ref in want.items():
        assert np.isfinite(got[k]).all(), k
        np.testing.assert_allclose(got[k], ref, err_msg=k, atol=5e-4 * np.abs(ref).max(),
                                   rtol=0)


def test_collinear_band_branch_matches_jax():
    """tests/test_spin.py's band setup (spin channels H and 1.01 H, 2 k, a
    window of 2 x 2 bands) on random features through both heads: every
    band output within 5e-4, the band loss at the output tolerance."""
    from hamgnn_tpu.physics.kpoints import random_k_cartesian

    rng = np.random.default_rng(7)
    c = add_random_hamiltonian_targets(rng, make_crystal(rng, n_atoms=3, species=(6, 14)),
                                       nao_max=NAO)
    n = len(c["z"])
    c["Hon"] = np.stack([c["Hon"], c["Hon"] * 1.01], axis=1)
    c["Hoff"] = np.stack([c["Hoff"], c["Hoff"] * 1.01], axis=1)
    c["spin_vec"] = rng.normal(size=(n, 3))
    c["spin_length"] = np.linalg.norm(c["spin_vec"], axis=-1)
    jg, tg = j_pad([c], bucket_multiple=8), t_pad([c], bucket_multiple=8)
    d = t_spin.Irreps(FEAT).dim
    feats = {"node_attr": 0.3 * rng.normal(size=(tg.num_nodes, d)).astype(np.float32),
             "edge_attr": 0.3 * rng.normal(size=(tg.num_edges, d)).astype(np.float32)}

    k = np.asarray(random_k_cartesian(rng, 2, np.asarray(c["cell"][0])), np.float32)[None]
    kw = dict(irreps_in_node=FEAT, irreps_in_edge=FEAT, nao_max=NAO, collinear_spin=True,
              add_H0=False, calculate_band_energy=True, num_k=2, band_num_control=2)
    jh = j_spin.HamGNNMagneticOut(**kw)
    jf = {key: jnp.asarray(v) for key, v in feats.items()}
    # the band branch adds no parameter: init without it
    params = j_spin.HamGNNMagneticOut(**dict(kw, calculate_band_energy=False)).init(
        jax.random.PRNGKey(1), jg, jf)
    jr = jh.apply(params, jg, jf, k_vecs=jnp.asarray(k))
    th = t_spin.HamGNNMagneticOut(**kw)
    load_flax_params(th, _flat(params["params"]))
    with torch.no_grad():
        tr = th(tg, _t_feats(feats), k_vecs=torch.as_tensor(k))
    assert set(tr) == set(jr)
    assert tuple(tr["band_energy"].shape) == (2, 2, 4)
    for key in ("band_energy_up", "band_energy_down", "band_gap_up", "band_gap_down",
                "band_energy", "band_gap", "band_energy_ref", "band_gap_ref"):
        np.testing.assert_allclose(tr[key].numpy(), np.asarray(jr[key]), err_msg=key,
                                   atol=5e-4, rtol=0)
    for key in ("wavefunction", "H_sym"):
        assert tuple(tr[key].shape) == jr[key].shape, key
    spec = [{"metric": "mae", "prediction": "band_energy", "target": "band_energy"}]
    np.testing.assert_allclose(float(t_losses(tr, tg, spec)[0]),
                               float(j_losses(jr, jg, spec)[0]), atol=5e-4, rtol=0)


# ----------------------------------------------------------------------
# synthetic spin data
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_random_spin_targets(mode):
    rng = np.random.default_rng(3)
    c = _spin_crystal(rng, mode, n_atoms=9, random_h0=False)
    n, e = len(c["z"]), c["edge_index"].shape[1]
    inv = c["inv_edge_idx"]
    assert ((c["spin_length"] < 0.5).sum()) == 1 and np.allclose(
        np.linalg.norm(c["spin_vec"], axis=1), c["spin_length"])
    if mode == "collinear":
        assert c["Hon"].shape == (n, 2, NAO * NAO) and c["Hoff0"].shape == (e, 2, NAO * NAO)
        np.testing.assert_array_equal(c["spin_vec"][:, :2], 0.0)
        h = c["Hoff"].reshape(e, 2, NAO, NAO)
        np.testing.assert_allclose(h, h[inv].transpose(0, 1, 3, 2), atol=1e-12)
        assert np.abs(h[:, 0] - h[:, 1]).max() > 0
        return
    for key in ("Hon", "iHon", "Hon0", "iHon0"):
        assert c[key].shape == (n, BIG), key
    hr = c["Hoff"].reshape(e, 2, NAO, 2, NAO)
    hi = c["iHoff"].reshape(e, 2, NAO, 2, NAO)
    if mode == "spinsoc":
        # the SOC targets' spin-coupling blocks hold the antisymmetrised
        # ksi * L of the reference's convention: the spin-diagonal blocks only
        assert c["Lon"].shape == (n, NAO * NAO, 3)
        hr, hi = (np.stack([h[:, 0, :, 0], h[:, 1, :, 1]], 1) for h in (hr, hi))
    else:
        hr, hi = (h.reshape(e, 1, 2 * NAO, 2 * NAO) for h in (hr, hi))
    np.testing.assert_allclose(hr, hr[inv].transpose(0, 1, 3, 2), atol=1e-12)
    np.testing.assert_allclose(hi, -hi[inv].transpose(0, 1, 3, 2), atol=1e-12)
    assert np.abs(hi).max() > 0


# ----------------------------------------------------------------------
# CLI and trainer
# ----------------------------------------------------------------------

def _write(path, cfg):
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def _graphs(root, mode, n=3, seed=1):
    rng = np.random.default_rng(seed)
    crystals = [_spin_crystal(rng, mode, n_atoms=3 + i % 2) for i in range(n)]
    save_graph_npz(str(root / "graph_data.npz"), crystals)
    return crystals


@pytest.mark.parametrize("mode", ["collinear", "noncollinear"])
def test_cli_stage_test_matches_jax(tmp_path, monkeypatch, mode):
    """``stage: test`` through both CLIs on the same weights: the JAX CLI
    with no checkpoint (its own initial parameters, kept as it makes them),
    the port's from those parameters' flax .npz; the prediction and target
    files within the output tolerance."""
    from hamgnn_tpu.train.trainer import Trainer as JTrainer

    crystals = _graphs(tmp_path, mode)
    base = _merge(CLI_BASE, _cli_out(mode))
    made = []
    real_init = JTrainer.init_params

    def init_params(self, *a, **k):
        made.append(real_init(self, *a, **k))
        return made[-1]

    monkeypatch.setattr(JTrainer, "init_params", init_params)
    for pkg, main, extra in (("jax", j_cli.main, []), ("port", t_cli.main, ["--device", "cpu"])):
        if pkg == "port":
            np.savez(tmp_path / "params.npz", **_flat(made[0]["params"]))
        cfg = _merge(base, {
            "setup": {"stage": "test", "checkpoint_path": str(
                tmp_path / ("missing" if pkg == "jax" else "params.npz"))},
            "dataset_params": {"graph_data_path": str(tmp_path), "batch_size": 2},
            "profiler_params": {"train_dir": str(tmp_path / pkg)}})
        main(["--config", _write(tmp_path / f"{pkg}.yaml", cfg), *extra])
    assert len(made) == 1
    rows = sum(c["z"].shape[0] + c["edge_index"].shape[1] for c in crystals)
    names, shape = (["prediction_hamiltonian", "target_hamiltonian"], (rows, 2, NAO * NAO)) \
        if mode == "collinear" else \
        ([f"{w}_hamiltonian_{p}" for w in ("prediction", "target") for p in ("real", "imag")],
         (rows, BIG))
    for name in names:
        got = np.load(tmp_path / "port" / f"{name}.npy")
        want = np.load(tmp_path / "jax" / f"{name}.npy")
        assert got.shape == want.shape == shape, name
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)


@pytest.mark.parametrize("mode", ["collinear", "noncollinear"])
def test_cli_fit_then_test_from_best(tmp_path, mode):
    """A magnetic fit writes ``best.pt``; ``stage: test`` with
    ``checkpoint_path: <train_dir>/best`` predicts with the trained weights,
    not the untrained model's."""
    _graphs(tmp_path, mode, seed=5)
    split = {"graph_data_path": str(tmp_path), "batch_size": 1, "train_ratio": 1 / 3,
             "val_ratio": 1 / 3, "test_ratio": 1 / 3}
    fit = _merge(_merge(CLI_BASE, _cli_out(mode)), {
        "setup": {"stage": "fit"}, "dataset_params": split,
        "optim_params": {"lr": 1e-2, "min_epochs": 0, "max_epochs": 1},
        "profiler_params": {"train_dir": str(tmp_path / "fit")}})
    t_cli.main(["--config", _write(tmp_path / "fit.yaml", fit), "--device", "cpu"])
    assert (tmp_path / "fit" / "best.pt").exists()
    name = "prediction_hamiltonian" + ("" if mode == "collinear" else "_real")
    preds = {}
    for tag, ckpt in (("best", "fit/best"), ("none", "missing")):
        cfg = _merge(fit, {"setup": {"stage": "test", "checkpoint_path": str(tmp_path / ckpt)},
                           "profiler_params": {"train_dir": str(tmp_path / tag)}})
        t_cli.main(["--config", _write(tmp_path / f"{tag}.yaml", cfg), "--device", "cpu"])
        preds[tag] = np.load(tmp_path / tag / f"{name}.npy")
    assert np.abs(preds["best"] - preds["none"]).max() > 1e-3


def _model(**out):
    cfg = _merge(CLI_BASE, {"output_nets": {"HamGNN_out": out}})
    return init_weights(t_cli.build_model(load_config(None, overrides=cfg)), 0)


def test_build_model_takes_the_references_magnetic_branch():
    m = _model(collinear_spin=True)
    assert isinstance(m.output, t_spin.HamGNNMagneticOut)
    assert m.output.collinear_spin and not m.output.soc_switch
    assert not m.output.use_learned_weight and m.output.min_magnetic_moment == 0.5
    m = _model(soc_switch=True, minMagneticMoment=0.25, band_num_control=0.5,
               use_learned_weight=True)
    assert m.output.soc_switch and not m.output.collinear_spin
    assert m.output.min_magnetic_moment == 0.25 and m.output.band_num_control == 8
    assert m.output.onsite_J.head.irreps_out.dim == 9 * 36 and hasattr(m.output,
                                                                       "offsite_weight")


@pytest.mark.parametrize("engine", ["auto", "zonal"])
def test_magnetic_steps_take_nothing_from_the_host_after_warm_up(tmp_path, monkeypatch,
                                                                engine):
    """The magnetic head's training and eval steps, as a capture records
    them: after a first run neither builds a tensor from host data nor reads
    the device, so the trainer captures them on the card."""
    from test_torch_port_train import _HostTraffic, _port_line

    if engine != "auto":
        monkeypatch.setenv("HAMGNN_TP_ENGINE", engine)
    for mode in MODES:
        rng = np.random.default_rng(6)
        g = t_pad([_spin_crystal(rng, mode) for _ in range(2)], bucket_multiple=8)
        soc, collinear = BRANCH[mode]
        tr = t_trainer.Trainer(_model(soc_switch=soc, collinear_spin=collinear),
                               losses=_losses(mode), metrics=_losses(mode), lr=1e-3,
                               train_dir=str(tmp_path / mode), device="cpu")

        def steps():
            tr._step(g, tr.lr_t)
            with torch.inference_mode():
                tr._eval(g)

        steps()
        mode_ = _HostTraffic()
        calls = []
        for name in ("tensor", "as_tensor", "from_numpy"):
            real = getattr(torch, name)
            monkeypatch.setattr(torch, name, lambda *a, _real=real, _n=name, **k: (
                calls.append((_n, _port_line())), _real(*a, **k))[1])
        with mode_:
            steps()
        monkeypatch.undo()
        if engine != "auto":
            monkeypatch.setenv("HAMGNN_TP_ENGINE", engine)
        assert calls == [] and mode_.seen == [], mode


@pytest.mark.parametrize("engine", ["auto", "zonal"])
def test_collinear_band_steps_take_nothing_from_the_host_after_warm_up(tmp_path, monkeypatch,
                                                                        engine):
    """The collinear head with each channel's bands: after a first training
    and eval step neither builds a tensor from host data, reads the device,
    calls a solver that checks its info on the host nor copies to the CPU
    (``band_step_traffic`` of test_torch_port_train.py), so its steps are
    captured on the card; on the CPU they run eagerly and a capture
    raises."""
    from test_torch_port_train import band_step_traffic

    if engine != "auto":
        monkeypatch.setenv("HAMGNN_TP_ENGINE", engine)
    m = _model(collinear_spin=True, calculate_band_energy=True, num_k=2, band_num_control=2)
    losses = HAM + [{"metric": "mae", "prediction": "band_energy", "target": "band_energy",
                     "loss_weight": 0.27211}]
    tr = t_trainer.Trainer(m, losses=losses, metrics=HAM, train_dir=str(tmp_path / "a"),
                           device="cpu")
    assert tr.captured is None
    with pytest.raises(ValueError, match="needs the card"):
        t_trainer.Trainer(m, losses=losses, metrics=[], train_dir=str(tmp_path / "b"),
                          device="cpu", capture=True)
    g = t_pad([_spin_crystal(np.random.default_rng(s), "collinear") for s in range(2)],
              bucket_multiple=8)
    kw = tr._band_kwargs(g)
    out = []

    def steps():
        out[:] = [tr._step(g, tr.lr_t, **kw)]
        with torch.inference_mode():
            out.append(tr._eval(g, **kw))

    assert band_step_traffic(monkeypatch, steps) == []
    (loss, logs), (_total, _logs, _mets, preds) = out
    assert torch.isfinite(loss) and float(logs["nonfinite_step"]) == 0.0
    # the two channels stacked on the crystal axis
    assert tuple(preds["band_energy"].shape) == (4, 2, 4) and "mae_band_energy" in logs
