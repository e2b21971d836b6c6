"""Whole-model parity of the PyTorch port against the JAX package.

The JAX model's parameters (``init_params_on_cpu``) go into the port through
``load_flax_params``; the same crystals are padded by both packages.  f32 on both sides; tolerance
atol 5e-5 / rtol 1e-4, tighter than the atol 5e-4 / rtol 1e-3 that
tests/test_torch_parity.py allows, and it holds.
"""

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from util_fixtures import add_random_hamiltonian_targets, make_crystal

from hamgnn_tpu.cli import build_model as j_build
from hamgnn_tpu.data.graph import pad_and_batch as j_pad
from hamgnn_tpu.models.model import compute_losses as j_losses
from hamgnn_tpu.models.model import compute_metrics as j_metrics
from hamgnn_tpu.train.config import load_config
from hamgnn_tpu.train.trainer import init_params_on_cpu
from hamgnn_tpu_torch import cli as t_cli
from hamgnn_tpu_torch.data.graph import pad_and_batch as t_pad
from hamgnn_tpu_torch.interfaces.jax_params import load_flax_params
from hamgnn_tpu_torch.models.model import compute_losses as t_losses
from hamgnn_tpu_torch.models.model import compute_metrics as t_metrics

TOL = dict(atol=5e-5, rtol=1e-4)
BASE = {
    "representation_nets": {"HamGNN_pre": {
        "irreps_node_features": "8x0e+4x1o+2x2e", "irreps_edge_sh": "0e+1o+2e",
        "num_layers": 2, "num_radial": 8, "cutoff": 4.0, "radial_MLP": [8],
        "num_types": 16}},
    "output_nets": {"HamGNN_out": {"nao_max": 14}},
}
LOSSES = [{"metric": "mae", "prediction": "hamiltonian", "target": "hamiltonian",
           "loss_weight": 27.211},
          {"metric": "mse", "prediction": "hamiltonian", "target": "hamiltonian"}]
METRICS = [{"metric": m, "prediction": "hamiltonian", "target": "hamiltonian"}
           for m in ("mae", "mse", "rmse")]
VARIANTS = {
    "base": {},
    "lite_gaussian_pol_noshift": {
        "representation_nets": {"HamGNN_pre": {
            "lite_mode": True, "rbf_func": "gaussian", "cutoff_func": "pol"}},
        "output_nets": {"HamGNN_out": {"zero_point_shift": False, "add_H0": False}}},
    "overlap_nosym_doping_norm": {
        "representation_nets": {"HamGNN_pre": {"apply_charge_doping": True}},
        "output_nets": {"HamGNN_out": {"ham_only": False, "symmetrize": False,
                                       "nonlinearity_type": "norm"}}},
}


def _merge(a, b):
    out = dict(a)
    for k, v in b.items():
        out[k] = _merge(a[k], v) if isinstance(v, dict) and k in a else v
    return out


def _crystals(n=2, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        c = add_random_hamiltonian_targets(
            rng, make_crystal(rng, n_atoms=4 + i, cutoff=4.0), nao_max=14)
        c["doping_charge"] = np.array([0.3 * (i + 1)])
        out.append(c)
    return out


def _flat(params):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(params["params"]).items()}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_model_forward_losses_metrics(variant):
    cfg = load_config(None, overrides=_merge(BASE, VARIANTS[variant]))
    crystals = _crystals()
    jm = j_build(cfg)
    jg = j_pad(crystals)
    params = init_params_on_cpu(jm, jg, 0)
    jp = jax.jit(jm.apply)(params, jg)
    tm = t_cli.build_model(cfg)
    load_flax_params(tm, _flat(params))
    tg = t_pad(crystals)
    with torch.inference_mode():
        tp = tm(tg)
        tl, tlogs = t_losses(tp, tg, LOSSES)
        tmet = t_metrics(tp, tg, METRICS)
    keys = ["hamiltonian_on", "hamiltonian_off", "mask_on", "mask_off", "sparsity_ratio"]
    if "overlap_on" in jp:
        keys += ["overlap_on", "overlap_off"]
    assert set(keys) <= set(tp)
    for k in keys:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), err_msg=k, **TOL)
    jl, jlogs = j_losses(jp, jg, LOSSES)
    jmet = j_metrics(jp, jg, METRICS)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    for k in jlogs:
        np.testing.assert_allclose(float(tlogs[k]), float(jlogs[k]), err_msg=k, **TOL)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), err_msg=k, **TOL)


def test_load_flax_params_rejects_mismatch():
    cfg = load_config(None, overrides=BASE)
    tm = t_cli.build_model(cfg)
    flat = {k.replace(".", "/"): v.numpy() for k, v in tm.state_dict().items()}
    load_flax_params(tm, flat)
    missing = dict(flat)
    missing.pop(sorted(missing)[0])
    with pytest.raises(KeyError):
        load_flax_params(tm, missing)
    with pytest.raises(KeyError):
        load_flax_params(tm, {**flat, "representation/extra/w": np.zeros(3)})
    k = "representation/chemical_embedding/w"
    with pytest.raises(ValueError):
        load_flax_params(tm, {**flat, k: np.zeros(flat[k].size + 1, np.float32)})
    prefixed = {"params/" + k: v for k, v in flat.items()}
    load_flax_params(tm, prefixed)
