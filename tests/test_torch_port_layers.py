"""Layers and blocks of the PyTorch port against the JAX package, on the same
weights (flax init -> ``load_flax_params``) and the same numpy inputs.

f32 on both sides.  Tolerance: atol 2e-5 / rtol 2e-5 for single layers (as
the packed-TP tests), atol 1e-4 / rtol 1e-4 for the blocks, which chain a
radial MLP, two packed pipelines, linears and a gate (sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from hamgnn_tpu.e3 import gate as j_gate
from hamgnn_tpu.e3 import linear as j_linear
from hamgnn_tpu.e3 import spherical as j_sph
from hamgnn_tpu.nn import blocks as j_blocks
from hamgnn_tpu.nn import mlp as j_mlp
from hamgnn_tpu.nn import radial as j_radial
from hamgnn_tpu_torch.e3 import gate as t_gate
from hamgnn_tpu_torch.e3 import linear as t_linear
from hamgnn_tpu_torch.e3 import spherical as t_sph
from hamgnn_tpu_torch.e3.packed_tp import get_plan
from hamgnn_tpu_torch.interfaces.jax_params import load_flax_params
from hamgnn_tpu_torch.nn import blocks as t_blocks
from hamgnn_tpu_torch.nn import mlp as t_mlp
from hamgnn_tpu_torch.nn import radial as t_radial

FEAT = "8x0e+4x1o+2x2e"
SH = "0e+1o+2e"
N, E, NRAD = 10, 40, 8
LAYER_TOL = dict(atol=2e-5, rtol=2e-5)
BLOCK_TOL = dict(atol=1e-4, rtol=1e-4)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _f32(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def run_both(jmod, tmod, *args, method=None, jargs=None):
    """Init ``jmod`` with flax, copy its parameters into ``tmod``, apply both
    to the same numpy inputs; returns (jax output, torch output) as numpy."""
    jargs = args if jargs is None else jargs
    jin = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in jargs]
    params = jmod.init(jax.random.PRNGKey(1), *jin, method=method)
    jout = jmod.apply(params, *jin, method=method)
    flat = {"/".join(k): np.asarray(v)
            for k, v in flatten_dict(params.get("params", {})).items()}
    load_flax_params(tmod, flat)
    with torch.inference_mode():
        tout = tmod(*[torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                      for a in args])
    if isinstance(tout, tuple):
        return [np.asarray(a) for a in jout], [b.numpy() for b in tout]
    return np.asarray(jout), tout.numpy()


@pytest.mark.parametrize("ls", [[0, 1, 2], [0, 1, 2, 3, 4], [1, 3], [0, 1, 2, 3, 4, 5]])
def test_spherical_harmonics(ls):
    v = _f32(_rng(), 50, 3)
    a = np.asarray(j_sph.spherical_harmonics(ls, jnp.asarray(v), normalize=True))
    b = t_sph.spherical_harmonics(ls, torch.as_tensor(v), normalize=True).numpy()
    np.testing.assert_allclose(b, a, **LAYER_TOL)


@pytest.mark.parametrize("name", sorted(j_radial.RBF_REGISTRY))
def test_radial_basis(name):
    r = np.abs(_f32(_rng(), 30)) * 3.0 + 0.1
    a, b = run_both(j_radial.RBF_REGISTRY[name](NRAD, 4.0),
                    t_radial.RBF_REGISTRY[name](NRAD, 4.0), r)
    np.testing.assert_allclose(b, a, **LAYER_TOL)


@pytest.mark.parametrize("fn", ["cosine_cutoff", "polynomial_envelope", "smooth_cutoff"])
def test_cutoffs(fn):
    r = np.linspace(0.05, 5.0, 40).astype(np.float32)
    a = np.asarray(getattr(j_radial, fn)(jnp.asarray(r), 4.0))
    b = getattr(t_radial, fn)(torch.as_tensor(r), 4.0).numpy()
    np.testing.assert_allclose(b, a, **LAYER_TOL)


@pytest.mark.parametrize("with_perm", [False, True])
def test_mlp_out_perm(with_perm):
    perm = _rng(3).permutation(12) if with_perm else None
    x = _f32(_rng(), E, NRAD)
    a, b = run_both(j_mlp.make_weight_generator(NRAD, (16,), 12, out_perm=perm),
                    t_mlp.make_weight_generator(NRAD, (16,), 12, out_perm=perm), x)
    np.testing.assert_allclose(b, a, **LAYER_TOL)


@pytest.mark.parametrize("irreps_in,irreps_out", [
    (FEAT, FEAT), ("4x0e+2x0e+3x1o", "5x0e+2x1o+1x2e"), ("96x0e", FEAT)])
def test_linear(irreps_in, irreps_out):
    from hamgnn_tpu_torch.e3.irreps import Irreps

    x = _f32(_rng(), E, Irreps(irreps_in).dim)
    a, b = run_both(j_linear.Linear(irreps_in, irreps_out),
                    t_linear.Linear(irreps_in, irreps_out), x)
    np.testing.assert_allclose(b, a, **LAYER_TOL)


def test_elementwise_channel_scale():
    from hamgnn_tpu_torch.e3.irreps import Irreps

    rng = _rng()
    x = _f32(rng, E, Irreps(FEAT).dim)
    w = _f32(rng, E, Irreps(FEAT).num_irreps)
    a, b = run_both(j_linear.ElementwiseChannelScale(FEAT, "3x0e+2x1o"),
                    t_linear.ElementwiseChannelScale(FEAT, "3x0e+2x1o"), x, w)
    np.testing.assert_allclose(b, a, **LAYER_TOL)


@pytest.mark.parametrize("weight_packed", [False, True])
def test_channel_scale_packed_tp_call(weight_packed):
    """ElementwiseChannelScale.packed_tp_call and Linear.packed_tp_call."""
    from hamgnn_tpu.e3.fused_tp import SHTensorProductExpansion
    from hamgnn_tpu_torch.e3.irreps import Irreps

    mid = SHTensorProductExpansion.mid_irreps(FEAT, SH, FEAT).simplify()
    rng = _rng(4)
    x, sh = _f32(rng, E, Irreps(FEAT).dim), _f32(rng, E, Irreps(SH).dim)
    w = _f32(rng, E, mid.num_irreps)
    jm = j_linear.ElementwiseChannelScale(mid, FEAT)
    tm = t_linear.ElementwiseChannelScale(repr(mid), FEAT)
    jx = [jnp.asarray(a) for a in (x, sh, w)]
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((E, mid.dim)), jx[2])
    a = jm.apply(params, FEAT, SH, *jx, weight_packed=weight_packed,
                 method=jm.packed_tp_call)
    load_flax_params(tm, {"/".join(k): np.asarray(v)
                          for k, v in flatten_dict(params["params"]).items()})
    b = tm.packed_tp_call(FEAT, SH, *[torch.as_tensor(v) for v in (x, sh, w)],
                          weight_packed=weight_packed)
    np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), **LAYER_TOL)

    jl, tl = j_linear.Linear(mid, FEAT), t_linear.Linear(repr(mid), FEAT)
    p2 = jl.init(jax.random.PRNGKey(2), jnp.zeros((E, mid.dim)))
    a2 = jl.apply(p2, FEAT, SH, jx[0], jx[1], method=jl.packed_tp_call)
    load_flax_params(tl, {"w": np.asarray(p2["params"]["w"])})
    b2 = tl.packed_tp_call(FEAT, SH, torch.as_tensor(x), torch.as_tensor(sh))
    np.testing.assert_allclose(b2.detach().numpy(), np.asarray(a2), **LAYER_TOL)
    plan = get_plan(repr(Irreps(FEAT)), repr(Irreps(SH)), FEAT, FEAT)
    assert plan.linear_numel == tl.weight_size


@pytest.mark.parametrize("irreps", [FEAT, "4x0e+2x0o+3x1o+2x1e+1x2e+1x3o", "6x0e"])
def test_gate(irreps):
    from hamgnn_tpu_torch.e3.irreps import Irreps

    from hamgnn_tpu.e3.irreps import Irreps as JIrreps

    jg, jin = j_gate.make_gate(JIrreps(irreps))
    tg, tin = t_gate.make_gate(Irreps(irreps))
    assert repr(jin) == repr(tin)
    x = _f32(_rng(), E, tin.dim)
    a, b = run_both(jg, tg, x)
    np.testing.assert_allclose(b, a, **LAYER_TOL)


@pytest.mark.parametrize("name", ["ssp", "tanh", "abs", "silu"])
def test_normalised_activations(name):
    x = np.linspace(-4, 4, 101).astype(np.float32)
    a = np.asarray(j_gate.act(name)(jnp.asarray(x)))
    b = t_gate.act(name)(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(b, a, **LAYER_TOL)


@pytest.mark.parametrize("nonlinearity", ["gate", "norm"])
def test_residual_block(nonlinearity):
    from hamgnn_tpu_torch.e3.irreps import Irreps

    x = _f32(_rng(), E, Irreps(FEAT).dim)
    a, b = run_both(j_blocks.ResidualBlock(FEAT, FEAT, nonlinearity_type=nonlinearity),
                    t_blocks.ResidualBlock(FEAT, FEAT, nonlinearity_type=nonlinearity), x)
    np.testing.assert_allclose(b, a, **BLOCK_TOL)


def _edge_inputs(seed=0):
    from hamgnn_tpu_torch.e3.irreps import Irreps

    rng = _rng(seed)
    d = Irreps(FEAT).dim
    node = _f32(rng, N, d)
    edge = _f32(rng, E, d)
    vec = _f32(rng, E, 3)
    sh = np.asarray(j_sph.spherical_harmonics([0, 1, 2], jnp.asarray(vec)))
    scal = _f32(rng, E, NRAD)
    edge_index = rng.integers(0, N, size=(2, E)).astype(np.int64)
    mask = np.ones(E, bool)
    mask[-5:] = False
    return node, edge, sh, scal, edge_index, mask


@pytest.mark.parametrize("lite", [False, True])
def test_message_pack_block(lite):
    node, edge, sh, scal, ei, _ = _edge_inputs()
    src, dst = node[ei[0]], node[ei[1]]
    kw = dict(radial_mlp=(16,), lite_mode=lite)
    a, b = run_both(j_blocks.MessagePackBlock(FEAT, FEAT, SH, FEAT, NRAD, **kw),
                    t_blocks.MessagePackBlock(FEAT, FEAT, SH, FEAT, NRAD, **kw),
                    src, dst, edge, sh, scal)
    np.testing.assert_allclose(b, a, **BLOCK_TOL)


@pytest.mark.parametrize("lite", [False, True])
def test_conv_block(lite):
    node, edge, sh, scal, ei, mask = _edge_inputs(1)
    kw = dict(radial_mlp=(16,), lite_mode=lite)
    a, b = run_both(j_blocks.ConvBlockE3(FEAT, FEAT, SH, NRAD, **kw),
                    t_blocks.ConvBlockE3(FEAT, FEAT, SH, NRAD, **kw),
                    node, edge, sh, scal, ei, mask)
    np.testing.assert_allclose(b, a, **BLOCK_TOL)


@pytest.mark.parametrize("skip,legacy", [(True, False), (False, False), (False, True)])
def test_pair_interaction_block(skip, legacy):
    node, edge, sh, scal, ei, _ = _edge_inputs(2)
    kw = dict(radial_mlp=(16,), use_skip_connections=skip, legacy_edge_update=legacy)
    a, b = run_both(j_blocks.PairInteractionBlock(FEAT, FEAT, SH, NRAD, **kw),
                    t_blocks.PairInteractionBlock(FEAT, FEAT, SH, NRAD, **kw),
                    node, edge, sh, scal, ei)
    np.testing.assert_allclose(b, a, **BLOCK_TOL)


def test_pair_embedding_block():
    _, _, sh, scal, ei, _ = _edge_inputs(3)
    rng = _rng(9)
    z = rng.integers(0, 16, size=N)
    onehot = np.eye(16, dtype=np.float32)[z]
    src, dst = onehot[ei[0]], onehot[ei[1]]
    jm = j_blocks.PairInteractionEmbeddingBlock("16x0e", FEAT, SH, NRAD, radial_mlp=(16,))
    tm = t_blocks.PairInteractionEmbeddingBlock("16x0e", FEAT, SH, NRAD, radial_mlp=(16,))
    a, b = run_both(jm, tm, src, dst, sh, scal,
                    jargs=((jnp.asarray(src), jnp.asarray(dst)), sh, scal, None))
    np.testing.assert_allclose(b, a, **BLOCK_TOL)


def test_segment_sum_and_fuse():
    rng = _rng()
    msg = _f32(rng, E, 7)
    recv = rng.integers(0, N, size=E)
    a = np.asarray(j_blocks.segment_sum(jnp.asarray(msg), jnp.asarray(recv), N))
    b = t_blocks.segment_sum(torch.as_tensor(msg), torch.as_tensor(recv), N).numpy()
    np.testing.assert_allclose(b, a, **LAYER_TOL)
    s, d = _f32(rng, E, 34), _f32(rng, E, 34)
    np.testing.assert_array_equal(
        t_blocks.fuse_src_dst(FEAT, torch.as_tensor(s), torch.as_tensor(d)).numpy(),
        np.asarray(j_blocks.fuse_src_dst(FEAT, jnp.asarray(s), jnp.asarray(d))))
