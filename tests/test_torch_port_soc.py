"""The port's SOC slice against the JAX package, and the repairs that came with it.

* ``models/soc.py``: ``su2_base_irreps`` / ``su2_codec_matrix`` equal to the
  reference's within 1e-7 (openmx 14 and 19, siesta 19, abacus 27); the
  spinor equivariance of the port's codec; ``HamGNNSOCOut`` on the same
  weights (flax init -> ``load_flax_params``) and the same numpy features
  over the flag matrix (``soc_basis`` x ``symmetrize`` x ``add_H0`` x
  ``zero_point_shift``) and with ``add_H_nonsoc``: outputs at atol 5e-5 /
  rtol 1e-4, the SOC losses and metrics at the same tolerance, gradients
  against ``jax.grad`` within 5e-4 * max|ref| per tensor;
* ``physics/band.py`` ``band_energies_soc_batched`` within 5e-4 of the
  reference's, and a finite band-loss gradient through the SOC head;
* ``stage: test`` through both CLIs from one flax ``.npz``: the four SOC
  ``.npy`` files within the output tolerance; a SOC fit, then ``stage:
  test`` and a warm start from ``<train_dir>/best`` (the reference's name;
  the port writes ``best.pt``) with the trained weights; ``audit_config``
  warning on each knob the reference warns on, 9 for all together;
* the trainer: a SOC head captures like any other (its step builds nothing
  from host data and never reads the device after its first run), with
  bands too (no solver that checks its info on the host either); the reference's SOC band chain
  (``prediction_hamiltonian_{real,imag}.npy`` into ``band_structure_for_crystal``);
* the lab-frame and zonal kernels' host schedules at the ``sk_soc`` width
  (``examples/sk_soc/config.yaml``: 2x4o and a new mix of paths) through the
  numpy emulations of ``test_torch_port_tp.py`` / ``test_torch_port_zonal.py``.

f32 on both sides; small widths (the features and SH of tests/test_soc.py,
one layer, a 3-atom crystal) except the schedule emulations.
"""

import itertools
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax.traverse_util import flatten_dict
from util_fixtures import add_random_hamiltonian_targets, make_crystal

from hamgnn_tpu import cli as j_cli
from hamgnn_tpu.data.dataset import save_graph_npz
from hamgnn_tpu.data.graph import pad_and_batch as j_pad
from hamgnn_tpu.models import soc as j_soc
from hamgnn_tpu.models.basis import get_basis_set as j_basis
from hamgnn_tpu.models.model import compute_losses as j_losses
from hamgnn_tpu.models.model import compute_metrics as j_metrics
from hamgnn_tpu.physics.band import band_energies_soc_batched as j_soc_bands
from hamgnn_tpu.train.config import load_config as j_load_config
from hamgnn_tpu_torch import cli as t_cli
from hamgnn_tpu_torch.data.graph import pad_and_batch as t_pad
from hamgnn_tpu_torch.data.synthetic import add_random_soc_targets
from hamgnn_tpu_torch.e3 import tp_kernel, zonal_kernel
from hamgnn_tpu_torch.e3.irreps import Irreps
from hamgnn_tpu_torch.e3.packed_tp import get_plan
from hamgnn_tpu_torch.e3.wigner import wigner_D
from hamgnn_tpu_torch.interfaces.jax_params import load_flax_params
from hamgnn_tpu_torch.models import soc as t_soc
from hamgnn_tpu_torch.models.basis import get_basis_set
from hamgnn_tpu_torch.models.model import compute_losses as t_losses
from hamgnn_tpu_torch.models.model import compute_metrics as t_metrics
from hamgnn_tpu_torch.physics.band import band_energies_soc_batched as t_soc_bands
from hamgnn_tpu_torch.train import trainer as t_trainer
from hamgnn_tpu_torch.train.config import load_config

FEAT = "8x0e+8x0o+6x1o+4x1e+4x2e+2x2o+1x3o+1x3e+1x4e"
SH = "0e + 1o + 2e + 3o + 4e"
NAO = 14
BIG = (2 * NAO) ** 2
TOL = dict(atol=5e-5, rtol=1e-4)
FLAGS = list(itertools.product([False, True], repeat=3))
HAM_KEYS = ("hamiltonian_real_on", "hamiltonian_real_off", "hamiltonian_imag_on",
            "hamiltonian_imag_off")
SOC_LOSSES = [{"metric": "mae", "prediction": p, "target": p, "loss_weight": 27.211}
              for p in ("hamiltonian_real", "hamiltonian_imag")]
SOC_METRICS = [{"metric": m, "prediction": p, "target": p}
               for m in ("mae", "mse") for p in ("hamiltonian_real", "hamiltonian_imag")]
# the sk_soc width (examples/sk_soc/config.yaml)
SK_SOC_FEAT = "64x0e+16x0o+24x1o+12x1e+16x2e+8x2o+8x3o+6x3e+4x4e+2x4o"
SK_SOC_IN = {"pair": "96x0e",
             "node": repr(Irreps([(2 * m, ir) for m, ir in Irreps(SK_SOC_FEAT)])),
             "edge": SK_SOC_FEAT}
# a small model for the CLI runs
CLI_BASE = {
    "representation_nets": {"HamGNN_pre": {
        "irreps_node_features": "8x0e+4x1o+2x2e", "irreps_edge_sh": "0e+1o+2e",
        "num_layers": 1, "num_radial": 8, "cutoff": 4.0, "radial_MLP": [8],
        "num_types": 16}},
    "output_nets": {"HamGNN_out": {"nao_max": NAO, "soc_switch": True, "soc_basis": "so3",
                                   "zero_point_shift": False}},
    "losses_metrics": {"losses": SOC_LOSSES, "metrics": SOC_METRICS[:2]},
}


def _merge(a, b):
    out = dict(a)
    for k, v in b.items():
        out[k] = _merge(a[k], v) if isinstance(v, dict) and k in a else v
    return out


def _flat(params):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(params).items()}


def _soc_crystal(rng, n_atoms=3, random_h0=True):
    c = add_random_soc_targets(rng, add_random_hamiltonian_targets(
        rng, make_crystal(rng, n_atoms=n_atoms, species=(6, 14)), nao_max=NAO), nao_max=NAO)
    if random_h0:
        for on, off in (("Hon0", "Hoff0"), ("iHon0", "iHoff0")):
            c[on] = 0.01 * rng.normal(size=c[on].shape)
            c[off] = 0.01 * rng.normal(size=c[off].shape)
    return c


@pytest.fixture(scope="module")
def case():
    """One 3-atom SOC crystal padded by both packages, and random features."""
    rng = np.random.default_rng(11)
    c = _soc_crystal(rng)
    jg, tg = j_pad([c], bucket_multiple=8), t_pad([c], bucket_multiple=8)
    d = Irreps(FEAT).dim
    feats = {"node_attr": rng.normal(size=(tg.num_nodes, d)).astype(np.float32),
             "edge_attr": rng.normal(size=(tg.num_edges, d)).astype(np.float32)}
    return jg, tg, feats


_PARAMS = {}


def _heads(case, **kw):
    """The JAX head with its flax parameters, and the port's head on them.
    The parameters depend on the basis and ``add_H_nonsoc`` only: they are
    made once for each."""
    jg, _tg, feats = case
    kw = dict(irreps_in_node=FEAT, irreps_in_edge=FEAT, nao_max=NAO, ham_type="openmx", **kw)
    jh = j_soc.HamGNNSOCOut(**kw)
    key = (kw["soc_basis"], bool(kw.get("add_H_nonsoc")))
    if key not in _PARAMS:
        jf = {k: jnp.asarray(v) for k, v in feats.items()}
        extra = {"h_nonsoc": _h_nonsoc(case, jnp.asarray)} if key[1] else {}
        _PARAMS[key] = jh.init(jax.random.PRNGKey(1), jg, jf, **extra)
    params = _PARAMS[key]
    th = t_soc.HamGNNSOCOut(**kw)
    load_flax_params(th, _flat(params["params"]))
    return jh, params, th


def _h_nonsoc(case, to):
    _jg, tg, _feats = case
    rng = np.random.default_rng(3)
    return (to(rng.normal(size=(tg.num_nodes, NAO * NAO)).astype(np.float32)),
            to(rng.normal(size=(tg.num_edges, NAO * NAO)).astype(np.float32)))


def _t_feats(case):
    return {k: torch.as_tensor(v) for k, v in case[2].items()}


# ----------------------------------------------------------------------
# host tables
# ----------------------------------------------------------------------

@pytest.mark.parametrize("ham_type,nao", [("openmx", 14), ("openmx", 19), ("siesta", 19),
                                          ("abacus", 27)])
def test_su2_codec_matches_jax(ham_type, nao):
    assert repr(t_soc.su2_base_irreps(get_basis_set(ham_type, nao))) == repr(
        j_soc.su2_base_irreps(j_basis(ham_type, nao)))
    got = t_soc.su2_codec_matrix(ham_type, nao)
    want = j_soc.su2_codec_matrix(ham_type, nao)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)
    assert t_soc._orbital_blocks(get_basis_set(ham_type, nao)) == j_soc._orbital_blocks(
        j_basis(ham_type, nao))


def _irreps_D(irreps, R):
    """Block-diagonal Wigner-D of ``irreps`` for a proper rotation R."""
    blocks = [wigner_D(ir.l, R) for mul, ir in irreps for _ in range(mul)]
    D = np.zeros((irreps.dim, irreps.dim))
    ofs = 0
    for b in blocks:
        D[ofs : ofs + len(b), ofs : ofs + len(b)] = b
        ofs += len(b)
    return D


def _spin_half_U(R):
    """SU(2) element covering the rotation R: exp(-i theta/2 n.sigma)."""
    theta = np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))
    n = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    n = n / max(np.linalg.norm(n), 1e-30)
    sx = np.array([[0, 1], [1, 0]], complex)
    sy = np.array([[0, -1j], [1j, 0]], complex)
    sz = np.array([[1, 0], [0, -1]], complex)
    return np.cos(theta / 2) * np.eye(2) - 1j * np.sin(theta / 2) * (
        n[0] * sx + n[1] * sy + n[2] * sz)


def test_spinor_equivariance_of_the_port_codec():
    """Rotating the irreps input conjugates the spin blocks:
    H(D x) = (U (x) D_orb) H(x) (U (x) D_orb)^dagger (tests/test_soc.py)."""
    basis = get_basis_set("openmx", NAO)
    base = t_soc.su2_base_irreps(basis)
    M = t_soc.su2_codec_matrix("openmx", NAO).astype(np.complex128)
    rng = np.random.default_rng(0)
    x = rng.normal(size=base.dim) + 1j * rng.normal(size=base.dim)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    R = q if np.linalg.det(q) > 0 else -q

    def to_block(v):
        return (v @ M).reshape(2, 2, NAO, NAO).transpose(0, 2, 1, 3).reshape(2 * NAO, 2 * NAO)

    D_orb = np.zeros((NAO, NAO))
    ofs = 0
    for _, ir in basis.orbital_irreps:
        D_orb[ofs : ofs + ir.dim, ofs : ofs + ir.dim] = wigner_D(ir.l, R)
        ofs += ir.dim
    perm = basis.index_change
    D_orb = D_orb[np.ix_(perm, perm)]
    if basis.minus_index is not None:
        s = np.ones(NAO)
        s[basis.minus_index] = -1
        D_orb = D_orb * s[:, None] * s[None, :]
    big = np.kron(_spin_half_U(R), D_orb)
    want = big @ to_block(x) @ big.conj().T
    np.testing.assert_allclose(to_block(_irreps_D(base, R) @ x), want, atol=2e-5)


# ----------------------------------------------------------------------
# the head
# ----------------------------------------------------------------------

@pytest.mark.parametrize("soc_basis", ["su2", "so3"])
@pytest.mark.parametrize("symmetrize,add_H0,zps", FLAGS)
def test_soc_head_matches_jax(case, soc_basis, symmetrize, add_H0, zps):
    jg, tg, feats = case
    jh, params, th = _heads(case, soc_basis=soc_basis, symmetrize=symmetrize,
                            add_H0=add_H0, zero_point_shift=zps)
    jr = jh.apply(params, jg, {k: jnp.asarray(v) for k, v in feats.items()})
    with torch.no_grad():
        tr = th(tg, _t_feats(case))
    assert set(tr) == set(jr)
    for k in jr:
        np.testing.assert_allclose(tr[k].numpy(), np.asarray(jr[k]), err_msg=k, **TOL)
    for k in HAM_KEYS:
        assert tr[k].shape[1] == BIG and bool(torch.isfinite(tr[k]).all())
    if soc_basis == "su2" and symmetrize:
        # H = H^dagger: the real part symmetric, the imaginary antisymmetric
        hr = tr["hamiltonian_real_on"].reshape(-1, 2 * NAO, 2 * NAO)
        hi = tr["hamiltonian_imag_on"].reshape(-1, 2 * NAO, 2 * NAO)
        h0r = tg.Hon0.reshape(hr.shape) if add_H0 else 0
        h0i = tg.iHon0.reshape(hr.shape) if add_H0 else 0
        if not zps:
            torch.testing.assert_close(hr - h0r, (hr - h0r).mT, atol=1e-6, rtol=0)
            torch.testing.assert_close(hi - h0i, -(hi - h0i).mT, atol=1e-6, rtol=0)
    # the SOC loss targets
    jl, jlogs = j_losses(jr, jg, SOC_LOSSES)
    tl, tlogs = t_losses(tr, tg, SOC_LOSSES)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    jm, tm = j_metrics(jr, jg, SOC_METRICS), t_metrics(tr, tg, SOC_METRICS)
    assert set(tm) == set(jm) and set(tlogs) == set(jlogs)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("add_H0", [False, True])
def test_add_H_nonsoc_matches_jax(case, add_H0):
    """so3 with the spatial part from an upstream non-SOC prediction; with
    H0 its spin-diagonal blocks are zeroed."""
    jg, tg, feats = case
    jh, params, th = _heads(case, soc_basis="so3", add_H_nonsoc=True, add_H0=add_H0)
    assert not hasattr(th, "onsite_hamiltonian") and hasattr(th, "onsite_ksi")
    jr = jh.apply(params, jg, {k: jnp.asarray(v) for k, v in feats.items()},
                  h_nonsoc=_h_nonsoc(case, jnp.asarray))
    with torch.no_grad():
        tr = th(tg, _t_feats(case), h_nonsoc=_h_nonsoc(case, torch.as_tensor))
    for k in jr:
        np.testing.assert_allclose(tr[k].numpy(), np.asarray(jr[k]), err_msg=k, **TOL)
    with pytest.raises(ValueError, match="h_nonsoc"):
        th(tg, _t_feats(case))


@pytest.mark.parametrize("soc_basis", ["su2", "so3"])
def test_soc_head_gradients_match_jax(case, soc_basis):
    """d(sum R * outputs) with respect to every parameter and both feature
    inputs, against ``jax.grad``: 5e-4 * max|ref| per tensor."""
    jg, tg, feats = case
    jh, params, th = _heads(case, soc_basis=soc_basis, zero_point_shift=True)
    rng = np.random.default_rng(7)
    R = {k: rng.normal(size=(tg.num_nodes if k.endswith("_on") else tg.num_edges, BIG)
                       ).astype(np.float32) for k in HAM_KEYS}

    def j_loss(p, f):
        out = jh.apply(p, jg, f)
        return sum(jnp.sum(out[k] * R[k]) for k in HAM_KEYS)

    jf = {k: jnp.asarray(v) for k, v in feats.items()}
    gp, gf = jax.grad(j_loss, argnums=(0, 1))(params, jf)
    tf = {k: v.clone().requires_grad_(True) for k, v in _t_feats(case).items()}
    out = th(tg, tf)
    sum(torch.sum(out[k] * torch.as_tensor(R[k])) for k in HAM_KEYS).backward()
    got = {n.replace(".", "/"): p.grad.numpy() for n, p in th.named_parameters()}
    want = _flat(gp["params"])
    got.update({k: v.grad.numpy() for k, v in tf.items()})
    want.update({k: np.asarray(v) for k, v in gf.items()})
    assert set(got) == set(want)
    for k, ref in want.items():
        assert np.isfinite(got[k]).all(), k
        np.testing.assert_allclose(got[k], ref, err_msg=k, atol=5e-4 * np.abs(ref).max(),
                                   rtol=0)


# ----------------------------------------------------------------------
# spinor bands
# ----------------------------------------------------------------------

def test_soc_bands_match_jax():
    """Two crystals in one batch, the graph's reference spinor Hamiltonian,
    4 random k-points: band, wavefunction norm and gap within 5e-4."""
    rng = np.random.default_rng(4)
    crystals = [_soc_crystal(rng, n_atoms=n) for n in (2, 3)]
    jg, tg = j_pad(crystals, bucket_multiple=8), t_pad(crystals, bucket_multiple=8)
    k = rng.uniform(-0.5, 0.5, size=(2, 4, 3)).astype(np.float32)
    basis = get_basis_set("openmx", NAO)
    jb, jw, jgap = j_soc_bands(jg, jg.Hon, jg.iHon, jg.Hoff, jg.iHoff, jg.Son, jg.Soff,
                               jnp.asarray(k), j_basis("openmx", NAO), num_bands=3)
    tb, tw, tgap = t_soc_bands(tg, tg.Hon, tg.iHon, tg.Hoff, tg.iHoff, tg.Son, tg.Soff,
                               torch.as_tensor(k), basis, num_bands=3)
    assert tuple(tb.shape) == (2, 4, 6) and tuple(tw.shape) == (2, 4, 6, 8 * 2 * NAO)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=5e-4, rtol=0)
    np.testing.assert_allclose(tgap.numpy(), np.asarray(jgap), atol=5e-4, rtol=0)
    # spinor states come in near-degenerate pairs: the eigenvectors are
    # compared only as far as their shapes and finiteness
    assert jw.shape == tw.shape and bool(torch.isfinite(tw.abs()).all())


def test_soc_band_loss_has_a_finite_gradient(case):
    """The SOC head with ``calculate_band_energy``: band outputs of the
    window's shape, and the band-energy loss's gradient finite and nonzero."""
    _jg, tg, _feats = case
    th = t_soc.HamGNNSOCOut(irreps_in_node=FEAT, irreps_in_edge=FEAT, nao_max=NAO,
                            soc_basis="so3", calculate_band_energy=True, num_k=2,
                            band_num_control=2, zero_point_shift=True)
    from hamgnn_tpu_torch.models.model import init_weights

    init_weights(th, 0)
    tf = {k: 0.1 * v for k, v in _t_feats(case).items()}
    k = torch.as_tensor(np.random.default_rng(2).uniform(-0.5, 0.5, (1, 2, 3)),
                        dtype=torch.float32)
    out = th(tg, tf, k_vecs=k)
    assert tuple(out["band_energy"].shape) == (1, 2, 4)
    assert tuple(out["band_energy_ref"].shape) == (1, 2, 4)
    loss, _ = t_losses(out, tg, [{"metric": "mae", "prediction": "band_energy",
                                  "target": "band_energy"}])
    loss.backward()
    grads = torch.cat([p.grad.reshape(-1) for p in th.parameters() if p.grad is not None])
    assert bool(torch.isfinite(loss)) and bool(torch.isfinite(grads).all())
    assert float(grads.abs().max()) > 0


# ----------------------------------------------------------------------
# CLI, checkpoints, config audit
# ----------------------------------------------------------------------

def _write(path, cfg):
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def _soc_graphs(root, n=3, seed=1):
    rng = np.random.default_rng(seed)
    crystals = [_soc_crystal(rng, n_atoms=3 + i % 2) for i in range(n)]
    save_graph_npz(str(root / "graph_data.npz"), crystals)
    return crystals


@pytest.mark.parametrize("soc_basis", ["so3"])
def test_cli_stage_test_soc_matches_jax(tmp_path, soc_basis):
    """Both CLIs, ``stage: test`` on the same weights (the JAX CLI from an
    orbax checkpoint of them, the port's from their flax .npz): the four SOC
    files within the output tolerance (targets equal), and the port's SOC
    files feed the reference's SOC band chain (``band_structure_for_crystal``
    with the real and the imaginary rows, as
    tools_dev/soc_band_acceptance.py reads them)."""
    from hamgnn_tpu.data.dataset import GraphDataModule
    from hamgnn_tpu.train.trainer import Trainer as JTrainer

    crystals = _soc_graphs(tmp_path)
    base = _merge(CLI_BASE, {"output_nets": {"HamGNN_out": {"soc_basis": soc_basis}}})
    jm = j_cli.build_model(j_load_config(None, overrides=base))
    jt = JTrainer(jm, losses=SOC_LOSSES, metrics=[], train_dir=str(tmp_path / "init"))
    jt.init_params(next(iter(GraphDataModule(crystals, batch_size=2,
                                             test_mode=True).test_batches())), seed=0)
    jt.save_checkpoint(str(tmp_path / "ckpt"))
    np.savez(tmp_path / "params.npz", **_flat(jt.params["params"]))
    for pkg, ckpt, main, extra in (("jax", "ckpt", j_cli.main, []),
                                   ("port", "params.npz", t_cli.main, ["--device", "cpu"])):
        cfg = _merge(base, {
            "setup": {"stage": "test", "checkpoint_path": str(tmp_path / ckpt)},
            "dataset_params": {"graph_data_path": str(tmp_path), "batch_size": 2},
            "profiler_params": {"train_dir": str(tmp_path / pkg)}})
        main(["--config", _write(tmp_path / f"{pkg}.yaml", cfg), *extra])
    rows = sum(c["z"].shape[0] + c["edge_index"].shape[1] for c in crystals)
    for name in ("prediction_hamiltonian_real", "prediction_hamiltonian_imag",
                 "target_hamiltonian_real", "target_hamiltonian_imag"):
        got = np.load(tmp_path / "port" / f"{name}.npy")
        want = np.load(tmp_path / "jax" / f"{name}.npy")
        assert got.shape == want.shape == (rows, BIG)
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)
    assert not (tmp_path / "port" / "prediction_hamiltonian.npy").exists()

    from hamgnn_tpu_torch.tools.band_cal import band_structure_for_crystal

    hr = np.load(tmp_path / "port" / "prediction_hamiltonian_real.npy")
    hi = np.load(tmp_path / "port" / "prediction_hamiltonian_imag.npy")
    c = crystals[0]
    n = c["z"].shape[0] + c["edge_index"].shape[1]
    basis = get_basis_set("openmx", NAO)
    res = band_structure_for_crystal(c, hr[:n], NAO, basis, 6, [[0, 0, 0], [0.5, 0, 0]],
                                     soc=True, ih_rows=hi[:n])
    n_valid = int(sum(basis.orbital_mask_table[z].sum() for z in c["z"]))
    assert res["bands"].shape == (6, 2 * n_valid) and np.isfinite(res["bands"]).all()


def test_soc_fit_then_test_and_warm_start_from_best(tmp_path):
    """C1: a SOC fit writes ``best.pt``; ``stage: test`` and a warm start
    with ``checkpoint_path: <train_dir>/best`` (the name the shipped
    two-stage configs use) load it: their predictions equal those through
    ``best.pt`` and differ from the untrained model's."""
    _soc_graphs(tmp_path, seed=5)
    split = {"graph_data_path": str(tmp_path), "batch_size": 1, "train_ratio": 1 / 3,
             "val_ratio": 1 / 3, "test_ratio": 1 / 3}
    fit = _merge(CLI_BASE, {"setup": {"stage": "fit"}, "dataset_params": split,
                            "optim_params": {"lr": 1e-2, "min_epochs": 0, "max_epochs": 2},
                            "profiler_params": {"train_dir": str(tmp_path / "fit")}})
    t_cli.main(["--config", _write(tmp_path / "fit.yaml", fit), "--device", "cpu"])
    assert (tmp_path / "fit" / "best.pt").exists()
    assert not (tmp_path / "fit" / "best").exists()

    def run(name, setup, max_epochs=None):
        cfg = _merge(fit, {"setup": setup, "profiler_params": {"train_dir": str(tmp_path / name)}})
        if max_epochs is not None:
            cfg["optim_params"] = dict(cfg["optim_params"], max_epochs=max_epochs)
        t_cli.main(["--config", _write(tmp_path / f"{name}.yaml", cfg), "--device", "cpu"])
        return [np.load(tmp_path / name / f"prediction_hamiltonian_{p}.npy")
                for p in ("real", "imag")]

    best = str(tmp_path / "fit" / "best")
    for stage in ("test", "fit"):
        # a warm start with no epoch left predicts with the loaded weights
        epochs = 0 if stage == "fit" else None
        extra = {"load_from_checkpoint": True} if stage == "fit" else {}
        by_name = run(f"{stage}_best", {"stage": stage, "checkpoint_path": best, **extra},
                      epochs)
        by_file = run(f"{stage}_best_pt", {"stage": stage, "checkpoint_path": best + ".pt",
                                           **extra}, epochs)
        untrained = run(f"{stage}_none", {"stage": stage,
                                          "checkpoint_path": str(tmp_path / "missing"),
                                          **extra}, epochs)
        for a, b, c in zip(by_name, by_file, untrained):
            np.testing.assert_array_equal(a, b)
            assert np.abs(a - c).max() > 1e-3


def test_resolve_checkpoint():
    assert t_cli.resolve_checkpoint(None) is None
    assert t_cli.resolve_checkpoint("/nonexistent/best") == "/nonexistent/best"
    here = os.path.abspath(__file__)
    assert t_cli.resolve_checkpoint(here) == here
    assert t_cli.resolve_checkpoint(here[: -len(".py")]) == here[: -len(".py")]


AUDIT_KNOBS = {
    "precision": {"setup": {"precision": 64}},
    "edge_sh_normalization": {"representation_nets": {"HamGNN_pre": {
        "edge_sh_normalization": "norm"}}},
    "edge_sh_normalize": {"representation_nets": {"HamGNN_pre": {"edge_sh_normalize": False}}},
    "build_internal_graph": {"representation_nets": {"HamGNN_pre": {
        "build_internal_graph": True}}},
    "include_triplet": {"output_nets": {"HamGNN_out": {"include_triplet": True}}},
    "return_forces": {"output_nets": {"HamGNN_out": {"return_forces": True}}},
    "create_graph": {"output_nets": {"HamGNN_out": {"create_graph": True}}},
    "get_nonzero_mask_tensor": {"output_nets": {"HamGNN_out": {
        "get_nonzero_mask_tensor": True}}},
    "calculate_sparsity": {"output_nets": {"HamGNN_out": {"calculate_sparsity": False}}},
    "num_workers": {"dataset_params": {"num_workers": 8}},
    "preload": {"dataset_params": {"preload": 1}},
}


def _audit_warnings(audit, cfg):
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        audit(cfg)
    return [str(w.message) for w in seen]


@pytest.mark.parametrize("knob", sorted(AUDIT_KNOBS))
def test_audit_config_warns_on_each_knob(knob):
    over = AUDIT_KNOBS[knob]
    assert _audit_warnings(t_cli.audit_config, load_config(None, overrides={})) == []
    got = _audit_warnings(t_cli.audit_config, load_config(None, overrides=over))
    want = _audit_warnings(j_cli.audit_config, j_load_config(None, overrides=over))
    assert len(got) == len(want) == 1
    assert knob.split("_")[0] in got[0] and "TPU" not in got[0]


def test_audit_config_all_knobs_raise_the_references_nine(tmp_path):
    """All knobs together on examples/sk/config.yaml: the reference's 9
    warnings, which ``train_and_evaluate`` raises on its way to a checkpoint
    directory that holds no orbax checkpoint and is refused (after the data
    and the model, with no other warning)."""
    over = {}
    for o in AUDIT_KNOBS.values():
        over = _merge(over, o)
    path = os.path.join(os.path.dirname(__file__), "..", "examples", "sk", "config.yaml")
    want = _audit_warnings(j_cli.audit_config, j_load_config(path, overrides=over))
    got = _audit_warnings(t_cli.audit_config, load_config(path, overrides=over))
    assert len(want) == len(got) == 9
    rng = np.random.default_rng(0)
    save_graph_npz(str(tmp_path / "graph_data.npz"), [add_random_hamiltonian_targets(
        rng, make_crystal(rng, n_atoms=3, species=(6, 14)), nao_max=14) for _ in range(2)])
    (tmp_path / "orbax").mkdir()
    cfg = load_config(path, overrides=_merge(over, {
        "setup": {"stage": "test", "checkpoint_path": str(tmp_path / "orbax")},
        "dataset_params": {"graph_data_path": str(tmp_path)},
        "profiler_params": {"train_dir": str(tmp_path / "out")}}))
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        with pytest.raises(FileNotFoundError, match="directory"):
            t_cli.train_and_evaluate(cfg, device="cpu")
    assert len(seen) == 9


# ----------------------------------------------------------------------
# trainer
# ----------------------------------------------------------------------

def _soc_model(**out):
    cfg = _merge(CLI_BASE, {"representation_nets": {"HamGNN_pre": {"irreps_edge_sh": SH}},
                            "output_nets": {"HamGNN_out": out}})
    from hamgnn_tpu_torch.models.model import init_weights

    return init_weights(t_cli.build_model(load_config(None, overrides=cfg)), 0)


def test_build_model_takes_the_references_soc_branch():
    m = _soc_model(soc_basis="so3")
    assert isinstance(m.output, t_soc.HamGNNSOCOut) and m.output.soc_basis == "so3"
    assert m.output.zero_point_shift is False
    # outside openmx the su2 codec is forced; band_num_control is int only
    m = _soc_model(ham_type="siesta", nao_max=19, soc_basis="so3", band_num_control=0.5)
    assert m.output.soc_basis == "su2" and m.output.band_num_control == 8
    cfg = _merge(CLI_BASE, {"output_nets": {"HamGNN_out": {"zero_point_shift": True}}})
    del cfg["output_nets"]["HamGNN_out"]["zero_point_shift"]
    assert t_cli.build_model(load_config(None, overrides=cfg)).output.zero_point_shift


@pytest.mark.parametrize("engine", ["auto", "zonal"])
def test_soc_steps_take_nothing_from_the_host_after_warm_up(tmp_path, monkeypatch, engine):
    """The SOC head's training and eval steps, as a capture records them:
    after a first run neither builds a tensor from host data nor reads the
    device (the check of test_torch_port_train.py), so the trainer captures
    them on the card like any other head's."""
    from test_torch_port_train import _HostTraffic, _port_line

    if engine != "auto":
        monkeypatch.setenv("HAMGNN_TP_ENGINE", engine)
    rng = np.random.default_rng(6)
    g = t_pad([_soc_crystal(rng) for _ in range(2)], bucket_multiple=8)
    for basis in ("su2", "so3"):
        tr = t_trainer.Trainer(_soc_model(soc_basis=basis, zero_point_shift=True),
                               losses=SOC_LOSSES, metrics=SOC_METRICS, lr=1e-3,
                               train_dir=str(tmp_path / basis), device="cpu")

        def steps():
            tr._step(g, tr.lr_t)
            with torch.inference_mode():
                tr._eval(g)

        steps()
        mode = _HostTraffic()
        calls = []
        for name in ("tensor", "as_tensor", "from_numpy"):
            real = getattr(torch, name)
            monkeypatch.setattr(torch, name, lambda *a, _real=real, _n=name, **k: (
                calls.append((_n, _port_line())), _real(*a, **k))[1])
        with mode:
            steps()
        monkeypatch.undo()
        if engine != "auto":
            monkeypatch.setenv("HAMGNN_TP_ENGINE", engine)
        assert calls == [] and mode.seen == [], basis


@pytest.mark.parametrize("engine", ["auto", "zonal"])
def test_soc_band_steps_take_nothing_from_the_host_after_warm_up(tmp_path, monkeypatch,
                                                                  engine):
    """The SOC head with spinor bands: after a first training and eval step
    neither builds a tensor from host data, reads the device, calls a solver
    that checks its info on the host nor copies to the CPU
    (``band_step_traffic`` of test_torch_port_train.py), so its steps are
    captured on the card; on the CPU they run eagerly and a capture
    raises."""
    from test_torch_port_train import band_step_traffic

    if engine != "auto":
        monkeypatch.setenv("HAMGNN_TP_ENGINE", engine)
    m = _soc_model(calculate_band_energy=True, num_k=2, band_num_control=2)
    losses = SOC_LOSSES + [{"metric": "mae", "prediction": "band_energy",
                            "target": "band_energy", "loss_weight": 0.27211}]
    tr = t_trainer.Trainer(m, losses=losses, metrics=SOC_METRICS, lr=1e-3,
                           train_dir=str(tmp_path / "a"), device="cpu")
    assert tr.captured is None
    with pytest.raises(ValueError, match="needs the card"):
        t_trainer.Trainer(m, losses=losses, metrics=[], train_dir=str(tmp_path / "b"),
                          device="cpu", capture=True)
    g = t_pad([_soc_crystal(np.random.default_rng(s)) for s in range(2)], bucket_multiple=8)
    kw = tr._band_kwargs(g)
    assert tuple(kw["k_vecs"].shape) == (2, 2, 3)
    out = []

    def steps():
        out[:] = [tr._step(g, tr.lr_t, **kw)]
        with torch.inference_mode():
            out.append(tr._eval(g, **kw))

    assert band_step_traffic(monkeypatch, steps) == []
    (loss, logs), (_total, _logs, _mets, preds) = out
    assert torch.isfinite(loss) and float(logs["nonfinite_step"]) == 0.0
    assert tuple(preds["band_energy"].shape) == (2, 2, 4) and "mae_band_energy" in logs


# ----------------------------------------------------------------------
# the kernels' host schedules at the sk_soc width
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SK_SOC_IN))
def test_lab_frame_schedule_at_the_sk_soc_width(name):
    """B1's and B2's index tables at the sk_soc plans, through the numpy
    emulations of their loop nests, against the plain versions."""
    from test_torch_port_tp import _inputs, _plain, _plain_bwd, emulate_backward, emulate_kernel

    f = repr(Irreps(SK_SOC_FEAT))
    plan = get_plan(repr(Irreps(SK_SOC_IN[name])), repr(Irreps(SH)), f, f)
    spec = tp_kernel.get_spec(plan)
    x, sh, w, fw = _inputs(plan, seed=3, E=20)
    wcat = spec.build_wcat(torch.as_tensor(fw)).numpy()
    ref = _plain(plan, x, sh, w, fw)
    np.testing.assert_allclose(emulate_kernel(spec, x, sh, w, wcat), ref,
                               atol=1e-4 * np.abs(ref).max(), rtol=0)
    gy = np.random.default_rng(11).normal(size=(20, spec.d_out)).astype(np.float32)
    got = emulate_backward(spec, x, sh, w, wcat, gy, need_dsh=True)
    for what, a, b in zip(("dx", "dsh", "dw", "dflat_w"), got,
                          _plain_bwd(plan, x, sh, w, fw, gy)):
        np.testing.assert_allclose(a, b, err_msg=what, atol=1e-4 * np.abs(b).max(), rtol=0)
    # one work item per chunk, d1 up to 9 (4e, 4o), slabs within SLAB_SLOTS
    assert len(spec.fitems) == len(spec.grp) and spec.fwd_pairs <= tp_kernel.ITEM_PAIRS
    assert spec.d1_max <= 9 and spec.sq_max <= tp_kernel.SLAB_SLOTS


@pytest.mark.parametrize("name", sorted(SK_SOC_IN))
def test_zonal_schedule_at_the_sk_soc_width(name):
    """B3's and B4's entry tables at the sk_soc plans, through the numpy
    emulations of their loop nests, against the plain zonal core."""
    from test_torch_port_zonal import _check_schedule

    f = repr(Irreps(SK_SOC_FEAT))
    plan = get_plan(repr(Irreps(SK_SOC_IN[name])), repr(Irreps(SH)), f, f)
    spec = zonal_kernel.get_zonal_kernel_spec(plan)
    _check_schedule(plan, spec, True, 6, lambda ref: dict(atol=1e-4 * np.abs(ref).max(),
                                                          rtol=0))
    assert spec.fwd_tiles <= zonal_kernel.FWD_ITEM_TILES
    assert spec.v_max <= 64 and len(spec.fitems) == len(spec.zgrp)
