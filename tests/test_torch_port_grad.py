"""Gradients of the PyTorch port against ``jax.grad`` of the JAX package.

Each layer and block, and the whole model on the three variants of
tests/test_torch_port_model.py, gets the same weights (flax init ->
``load_flax_params``) and the same numpy inputs on both sides.  A layer's
loss is sum(out * R) for a fixed random R; the model's is the training loss
(masked MAE x 27.211 + MSE on the Hamiltonian).  f32 on both sides.

Tolerance, per parameter tensor and per float input: max|d| <= 1e-4 *
max|ref| for single layers and 5e-4 * max|ref| for blocks and the model,
tighter than the 2e-3 that ROADMAP.md allows, and it holds (the sums run
in another order on the two sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from util_fixtures import add_random_hamiltonian_targets, make_crystal

from hamgnn_tpu.cli import build_model as j_build
from hamgnn_tpu.data.graph import pad_and_batch as j_pad
from hamgnn_tpu.e3 import gate as j_gate
from hamgnn_tpu.e3 import linear as j_linear
from hamgnn_tpu.e3.irreps import Irreps as JIrreps
from hamgnn_tpu.models.model import compute_losses as j_losses
from hamgnn_tpu.nn import blocks as j_blocks
from hamgnn_tpu.nn import mlp as j_mlp
from hamgnn_tpu.nn import radial as j_radial
from hamgnn_tpu.train.config import load_config
from hamgnn_tpu.train.trainer import init_params_on_cpu
from hamgnn_tpu_torch import cli as t_cli
from hamgnn_tpu_torch.data.graph import pad_and_batch as t_pad
from hamgnn_tpu_torch.e3 import gate as t_gate
from hamgnn_tpu_torch.e3 import linear as t_linear
from hamgnn_tpu_torch.e3.irreps import Irreps
from hamgnn_tpu_torch.interfaces.jax_params import load_flax_params
from hamgnn_tpu_torch.models.model import compute_losses as t_losses
from hamgnn_tpu_torch.nn import blocks as t_blocks
from hamgnn_tpu_torch.nn import mlp as t_mlp
from hamgnn_tpu_torch.nn import radial as t_radial

FEAT = "8x0e+4x1o+2x2e"
SH = "0e+1o+2e"
N, E, NRAD = 10, 40, 8
LAYER_TOL = 1e-4
BLOCK_TOL = 5e-4


def _f32(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _flat(params):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(params).items()}


def assert_grads_close(got: dict, ref: dict, tol: float):
    """Per tensor: max|got - ref| <= tol * max|ref| (exact zeros stay zero)."""
    assert set(got) == set(ref), (sorted(got), sorted(ref))
    for k in sorted(ref):
        a, b = np.asarray(got[k], np.float64), np.asarray(ref[k], np.float64)
        assert a.shape == b.shape, k
        assert np.isfinite(a).all(), k
        scale = np.abs(b).max()
        assert np.abs(a - b).max() <= tol * scale, (
            f"{k}: max|d| {np.abs(a - b).max():.3e} > {tol} * {scale:.3e}")


def _grad(t):
    """A tensor the output does not depend on has no torch gradient; JAX
    gives zeros (as the trainer's zeroed flat gradient does)."""
    return np.zeros(tuple(t.shape), np.float32) if t.grad is None else t.grad.numpy()


def grads_both(jmod, tmod, args, jargs=None, method=None, seed=0):
    """Init ``jmod``, copy its parameters into ``tmod``; gradients of
    sum(out * R) with respect to every parameter and every float input, on
    both sides.  Returns (torch grads, jax grads) keyed by parameter name
    ("p:a/b/w") and input position ("x:i")."""
    jargs = args if jargs is None else jargs
    jin = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in jargs]
    params = jmod.init(jax.random.PRNGKey(1), *jin, method=method)
    out = jmod.apply(params, *jin, method=method)
    R = _f32(np.random.default_rng(seed + 100), *out.shape)
    fl = [i for i, a in enumerate(jargs)
          if isinstance(a, np.ndarray) and a.dtype == np.float32]

    def loss(p, *xs):
        full = list(jin)
        for i, x in zip(fl, xs):
            full[i] = x
        return jnp.sum(jmod.apply(p, *full, method=method) * R)

    jg = jax.jit(jax.grad(loss, argnums=tuple(range(1 + len(fl)))))(
        params, *[jin[i] for i in fl])
    ref = {f"p:{k}": v for k, v in _flat(jg[0].get("params", {})).items()}
    ref.update({f"x:{i}": np.asarray(g) for i, g in zip(fl, jg[1:])})

    load_flax_params(tmod, _flat(params.get("params", {})))
    targs = [torch.tensor(a) if isinstance(a, np.ndarray) else a for a in args]
    tfl = [i for i, a in enumerate(args) if isinstance(a, np.ndarray) and a.dtype == np.float32]
    for i in tfl:
        targs[i].requires_grad_(True)
    (tmod(*targs) * torch.as_tensor(R)).sum().backward()
    got = {f"p:{n.replace('.', '/')}": _grad(p) for n, p in tmod.named_parameters()}
    got.update({f"x:{i}": _grad(targs[i]) for i in tfl if jargs is args})
    if jargs is not args:  # inputs differ in form: compare parameters only
        ref = {k: v for k, v in ref.items() if k.startswith("p:")}
    return got, ref


@pytest.mark.parametrize("irreps_in,irreps_out", [
    (FEAT, FEAT), ("4x0e+2x0e+3x1o", "5x0e+2x1o+1x2e"), ("96x0e", FEAT)])
def test_linear_grad(irreps_in, irreps_out):
    x = _f32(np.random.default_rng(0), E, Irreps(irreps_in).dim)
    assert_grads_close(*grads_both(j_linear.Linear(irreps_in, irreps_out),
                                   t_linear.Linear(irreps_in, irreps_out), [x]), LAYER_TOL)


def test_elementwise_channel_scale_grad():
    rng = np.random.default_rng(1)
    x, w = _f32(rng, E, Irreps(FEAT).dim), _f32(rng, E, Irreps(FEAT).num_irreps)
    assert_grads_close(*grads_both(j_linear.ElementwiseChannelScale(FEAT, "3x0e+2x1o"),
                                   t_linear.ElementwiseChannelScale(FEAT, "3x0e+2x1o"),
                                   [x, w]), LAYER_TOL)


@pytest.mark.parametrize("irreps", [FEAT, "4x0e+2x0o+3x1o+2x1e+1x2e+1x3o"])
def test_gate_grad(irreps):
    jg, _ = j_gate.make_gate(JIrreps(irreps))
    tg, tin = t_gate.make_gate(Irreps(irreps))
    x = _f32(np.random.default_rng(2), E, tin.dim)
    assert_grads_close(*grads_both(jg, tg, [x]), LAYER_TOL)


@pytest.mark.parametrize("with_perm", [False, True])
def test_mlp_grad(with_perm):
    perm = np.random.default_rng(3).permutation(12) if with_perm else None
    x = _f32(np.random.default_rng(4), E, NRAD)
    assert_grads_close(*grads_both(j_mlp.make_weight_generator(NRAD, (16,), 12, out_perm=perm),
                                   t_mlp.make_weight_generator(NRAD, (16,), 12, out_perm=perm),
                                   [x]), LAYER_TOL)


@pytest.mark.parametrize("name", ["bessel", "exp-gaussian", "exp-bernstein"])
def test_radial_basis_grad(name):
    """The radial bases with trainable parameters."""
    r = np.abs(_f32(np.random.default_rng(5), 30)) * 3.0 + 0.1
    assert_grads_close(*grads_both(j_radial.RBF_REGISTRY[name](NRAD, 4.0),
                                   t_radial.RBF_REGISTRY[name](NRAD, 4.0), [r]), LAYER_TOL)


@pytest.mark.parametrize("nonlinearity", ["gate", "norm"])
def test_residual_block_grad(nonlinearity):
    x = _f32(np.random.default_rng(6), E, Irreps(FEAT).dim)
    assert_grads_close(*grads_both(
        j_blocks.ResidualBlock(FEAT, FEAT, nonlinearity_type=nonlinearity),
        t_blocks.ResidualBlock(FEAT, FEAT, nonlinearity_type=nonlinearity), [x]), BLOCK_TOL)


def _edge_inputs(seed):
    from hamgnn_tpu.e3 import spherical as j_sph

    rng = np.random.default_rng(seed)
    d = Irreps(FEAT).dim
    node, edge = _f32(rng, N, d), _f32(rng, E, d)
    sh = np.asarray(j_sph.spherical_harmonics([0, 1, 2], jnp.asarray(_f32(rng, E, 3))))
    scal = _f32(rng, E, NRAD)
    ei = rng.integers(0, N, size=(2, E)).astype(np.int64)
    mask = np.ones(E, bool)
    mask[-5:] = False
    return node, edge, sh, scal, ei, mask


@pytest.mark.parametrize("lite", [False, True])
def test_conv_block_grad(lite):
    node, edge, sh, scal, ei, mask = _edge_inputs(7)
    kw = dict(radial_mlp=(16,), lite_mode=lite)
    assert_grads_close(*grads_both(j_blocks.ConvBlockE3(FEAT, FEAT, SH, NRAD, **kw),
                                   t_blocks.ConvBlockE3(FEAT, FEAT, SH, NRAD, **kw),
                                   [node, edge, sh, scal, ei, mask]), BLOCK_TOL)


@pytest.mark.parametrize("skip,legacy", [(True, False), (False, True)])
def test_pair_interaction_block_grad(skip, legacy):
    node, edge, sh, scal, ei, _ = _edge_inputs(8)
    kw = dict(radial_mlp=(16,), use_skip_connections=skip, legacy_edge_update=legacy)
    assert_grads_close(*grads_both(j_blocks.PairInteractionBlock(FEAT, FEAT, SH, NRAD, **kw),
                                   t_blocks.PairInteractionBlock(FEAT, FEAT, SH, NRAD, **kw),
                                   [node, edge, sh, scal, ei]), BLOCK_TOL)


def test_pair_embedding_block_grad():
    _, _, sh, scal, ei, _ = _edge_inputs(9)
    onehot = np.eye(16, dtype=np.float32)[np.random.default_rng(10).integers(0, 16, size=N)]
    src, dst = onehot[ei[0]], onehot[ei[1]]
    assert_grads_close(*grads_both(
        j_blocks.PairInteractionEmbeddingBlock("16x0e", FEAT, SH, NRAD, radial_mlp=(16,)),
        t_blocks.PairInteractionEmbeddingBlock("16x0e", FEAT, SH, NRAD, radial_mlp=(16,)),
        [src, dst, sh, scal],
        jargs=((jnp.asarray(src), jnp.asarray(dst)), sh, scal, None)), BLOCK_TOL)


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------

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


def _model_case(variant):
    cfg = load_config(None, overrides=_merge(BASE, VARIANTS[variant]))
    crystals = _crystals()
    jm, jg = j_build(cfg), j_pad(crystals)
    return cfg, crystals, jm, jg, init_params_on_cpu(jm, jg, 0)


def torch_model_grads(cfg, crystals, params, checkpointing=False):
    if checkpointing:
        cfg.setup.use_gradient_checkpointing = True
    tm = t_cli.build_model(cfg)
    assert tm.representation.use_gradient_checkpointing == checkpointing
    load_flax_params(tm, _flat(params["params"]))
    tg = t_pad(crystals)
    t_losses(tm(tg), tg, LOSSES)[0].backward()
    return {n.replace(".", "/"): _grad(p) for n, p in tm.named_parameters()}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_model_parameter_grads(variant):
    cfg, crystals, jm, jg, params = _model_case(variant)
    ref = _flat(jax.jit(jax.grad(
        lambda p: j_losses(jm.apply(p, jg), jg, LOSSES)[0]))(params)["params"])
    assert_grads_close(torch_model_grads(cfg, crystals, params), ref, BLOCK_TOL)


def test_gradient_checkpointing_gives_the_same_grads():
    """``use_gradient_checkpointing`` recomputes the layers in the backward:
    the gradients are those of the model without it, bit for bit."""
    cfg, crystals, _jm, _jg, params = _model_case("base")
    plain = torch_model_grads(cfg, crystals, params)
    remat = torch_model_grads(cfg, crystals, params, checkpointing=True)
    for k in plain:
        np.testing.assert_array_equal(remat[k], plain[k], err_msg=k)
