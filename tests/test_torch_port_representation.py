"""The port's other representation networks against the JAX package's.

* the host tables, element-exact: ``u_matrix_real`` for correlation 1-3 on two
  coupling sets, the electron configuration table, the instruction lists of
  ``tp_out_irreps_with_instructions`` in both modes;
* ``edge_softmax`` (masked edges, a node without edges), ``split_heads`` /
  ``merge_heads`` and the refusal of a head count that does not divide a
  multiplicity, on both sides;
* ``SoftUnitStepCutoff`` with finite gradients at padded edges, ``KANLinear``
  with and without ``out_perm``, ``SymmetricContraction`` with and without
  charge doping, ``CorrProductBlock``, ``TensorProduct``,
  ``FullyConnectedTensorProduct``, ``NodePairTensorProduct``,
  ``MessagePackBlockV2``, ``E3LayerNorm``, ``ElectronConfigurationEmbedding``
  and ``AttentionBlockE3``: the same weights (flax init -> ``load_flax_params``)
  and the same numpy inputs, outputs at atol 5e-5 / rtol 1e-4 and gradients
  of sum(out * R) per tensor within 5e-4 * max|ref|;
* the three representations through ``HamGNNModel`` (the Transformer, ConvE3
  with ``use_corr_prod``, ConvE3 with ``use_kan``): every flax key filled, the
  forward at atol 5e-5 / rtol 1e-4, the parameter gradients of the training
  loss per tensor within 5e-4 * max|ref|; the Transformer under the zonal
  engine within 2e-5 * max|ref| of the packed one; ConvE3 with corr and
  gradient checkpointing bit for bit as without;
* ``init_weights``: the layer norm keeps its ones, the KAN weights are
  uniform within their bound, and a model without new modules draws what it
  drew before;
* the CLI: ``stage: test`` through both CLIs on the same weights for the
  three representations; for each, ``stage: fit`` then ``stage: test`` from
  ``<train_dir>/best``;
* the trainer: the steps of the three take nothing from the host after a
  first run (what a CUDA graph captures), the Transformer under both engines.

f32 on both sides; small widths (features ``8x0e+8x0o+4x1o+4x1e+4x2e``, the
blocks at half of it or less, SH to 2e, one layer, two where a second one
matters, 4-5 atom crystals), one torch thread.
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
from hamgnn_tpu.e3 import normalization as j_norm
from hamgnn_tpu.e3 import tensor_product as j_tp
from hamgnn_tpu.models import representation as j_rep
from hamgnn_tpu.models.model import compute_losses as j_losses
from hamgnn_tpu.nn import attention as j_att
from hamgnn_tpu.nn import blocks as j_blocks
from hamgnn_tpu.nn import electron_configurations as j_ec
from hamgnn_tpu.nn import mlp as j_mlp
from hamgnn_tpu.nn import radial as j_radial
from hamgnn_tpu.nn import symmetric_contraction as j_sc
from hamgnn_tpu.train.config import load_config as j_load_config
from hamgnn_tpu_torch import cli as t_cli
from hamgnn_tpu_torch.data.dataset import save_graph_npz
from hamgnn_tpu_torch.data.graph import pad_and_batch as t_pad
from hamgnn_tpu_torch.e3 import normalization as t_norm
from hamgnn_tpu_torch.e3 import tensor_product as t_tp
from hamgnn_tpu_torch.e3.irreps import Irreps
from hamgnn_tpu_torch.interfaces.jax_params import load_flax_params
from hamgnn_tpu_torch.models import representation as t_rep
from hamgnn_tpu_torch.models.model import compute_losses as t_losses
from hamgnn_tpu_torch.models.model import init_weights
from hamgnn_tpu_torch.nn import attention as t_att
from hamgnn_tpu_torch.nn import blocks as t_blocks
from hamgnn_tpu_torch.nn import electron_configurations as t_ec
from hamgnn_tpu_torch.nn import mlp as t_mlp
from hamgnn_tpu_torch.nn import radial as t_radial
from hamgnn_tpu_torch.nn import symmetric_contraction as t_sc
from hamgnn_tpu_torch.train import trainer as t_trainer
from hamgnn_tpu_torch.train.config import load_config

FEAT = "8x0e+8x0o+4x1o+4x1e+4x2e"
SH = "0e+1o+2e"
SMALL = "4x0e+2x0o+2x1o+2x1e+2x2e"  # the tensor products: both parities of each l
NATURAL = "4x0e+2x1o+2x2e"  # the blocks around the packed TP: fewer paths to compile
N, E, NRAD, TYPES = 10, 40, 8, 16
TOL = dict(atol=5e-5, rtol=1e-4)
GRAD_TOL = 5e-4
# fp32 rounding relative to the largest gradient of a loss: a gradient below
# it is zero in exact arithmetic (e.g. of a pseudo-scalar channel that the
# edge-parallel vector features leave at rounding level)
NOISE = 1e-6
ENGINE_TOL = 2e-5
HAM = [{"metric": "mae", "prediction": "hamiltonian", "target": "hamiltonian",
        "loss_weight": 27.211}]
CLI_BASE = {
    "representation_nets": {"HamGNN_pre": {
        "irreps_node_features": FEAT, "irreps_edge_sh": SH, "num_layers": 1,
        "num_radial": NRAD, "cutoff": 4.0, "radial_MLP": [8], "num_types": TYPES}},
    "output_nets": {"HamGNN_out": {"nao_max": 14}},
}
# (a) the Transformer, (b) ConvE3 with the correlation block, (c) ConvE3 with
# KAN generators
REPS = {
    "transformer": {"setup": {"GNN_Net": "HamGNNTransformer"},
                    "representation_nets": {"HamGNN_pre": {
                        "num_heads": 2, "correlation": 2, "num_hidden_features": 4}}},
    "corr": {"representation_nets": {"HamGNN_pre": {
        "use_corr_prod": True, "correlation": 2, "num_hidden_features": 4}}},
    "kan": {"representation_nets": {"HamGNN_pre": {"use_kan": True}}},
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


def _f32(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _write(path, cfg):
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def _crystals(n=2, seed=0, doping=False):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        c = add_random_hamiltonian_targets(
            rng, make_crystal(rng, n_atoms=4 + i % 2, cutoff=4.0), nao_max=14)
        if doping:
            c["doping_charge"] = np.array([0.3 * (i + 1)])
        out.append(c)
    return out


def assert_grads_close(got: dict, ref: dict, tol: float = GRAD_TOL):
    """Per tensor: max|got - ref| <= tol * max|ref|.  A tensor whose
    gradient is zero in exact arithmetic holds only rounding on both sides:
    where max|ref| is below NOISE times the largest reference gradient, both
    sides must stay below that floor."""
    assert set(got) == set(ref), (sorted(set(got) ^ set(ref)))
    floor = NOISE * max(float(np.abs(np.asarray(v)).max(initial=0.0)) for v in ref.values())
    for k in sorted(ref):
        a, b = np.asarray(got[k], np.float64), np.asarray(ref[k], np.float64)
        assert a.shape == b.shape, k
        assert np.isfinite(a).all(), k
        scale = np.abs(b).max(initial=0.0)
        if scale < floor:
            assert np.abs(a).max(initial=0.0) < floor, (
                f"{k}: max|got| {np.abs(a).max():.3e}, reference at the rounding floor "
                f"{floor:.3e}")
            continue
        assert np.abs(a - b).max() <= tol * scale, (
            f"{k}: max|d| {np.abs(a - b).max():.3e} > {tol} * {scale:.3e}")


def _grad(t):
    return np.zeros(tuple(t.shape), np.float32) if t.grad is None else t.grad.numpy()


def check_both(jmod, tmod, args, jargs=None, seed=0):
    """Init ``jmod``, load its parameters into ``tmod`` (every key filled);
    the outputs at atol 5e-5 / rtol 1e-4 and the gradients of sum(out * R)
    with respect to every parameter and float input within 5e-4 * max|ref|
    (one jitted value-and-gradient on the JAX side)."""
    jargs = args if jargs is None else jargs
    jin = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in jargs]
    params = jmod.init(jax.random.PRNGKey(1), *jin)
    shape = jax.eval_shape(jmod.apply, params, *jin).shape
    R = _f32(np.random.default_rng(seed + 100), *shape)
    fl = [i for i, a in enumerate(jargs) if isinstance(a, np.ndarray) and a.dtype == np.float32]

    def loss(p, *xs):
        full = list(jin)
        for i, x in zip(fl, xs):
            full[i] = x
        out = jmod.apply(p, *full)
        return jnp.sum(out * R), out

    (_, jout), jg = jax.jit(jax.value_and_grad(loss, argnums=tuple(range(1 + len(fl))),
                                               has_aux=True))(params, *[jin[i] for i in fl])
    ref = {f"p:{k}": v for k, v in _flat(jg[0].get("params", {})).items()}
    ref.update({f"x:{i}": np.asarray(g) for i, g in zip(fl, jg[1:])})

    load_flax_params(tmod, _flat(params.get("params", {})))
    targs = [torch.tensor(a) if isinstance(a, np.ndarray) else a for a in args]
    for i in fl:
        targs[i].requires_grad_(True)
    tout = tmod(*targs)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **TOL)
    (tout * torch.as_tensor(R)).sum().backward()
    got = {f"p:{n.replace('.', '/')}": _grad(p) for n, p in tmod.named_parameters()}
    got.update({f"x:{i}": _grad(targs[i]) for i in fl})
    assert_grads_close(got, ref)
    return tout


# ----------------------------------------------------------------------
# host tables
# ----------------------------------------------------------------------

@pytest.mark.parametrize("coupling", ["1x0e+1x1o+1x2e", "1x0e+1x0o+1x1o+1x1e"])
@pytest.mark.parametrize("correlation", [1, 2, 3])
def test_u_matrices_equal_the_jax_packages(coupling, correlation):
    for ir_out in ("0e", "0o", "1o", "1e", "2e", "2o", "3o"):
        got = t_sc.u_matrix_real(coupling, ir_out, correlation)
        want = j_sc.u_matrix_real(coupling, ir_out, correlation)
        assert got.shape == want.shape and got.dtype == want.dtype, ir_out
        np.testing.assert_array_equal(got, want, err_msg=ir_out)


def test_electron_table_equals_the_jax_packages():
    got = np.asarray(t_ec.electron_configurations)
    want = np.asarray(j_ec.electron_configurations)
    assert got.shape == want.shape == (87, 16)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["uvw", "uvu"])
@pytest.mark.parametrize("irreps", [(FEAT, FEAT, FEAT), ("4x0e+2x1o", SH, "3x0e+2x1o+1x2e+1x3o")])
def test_tp_instructions_equal_the_jax_packages(mode, irreps):
    got_irreps, got = t_tp.tp_out_irreps_with_instructions(*irreps, mode=mode)
    want_irreps, want = j_tp.tp_out_irreps_with_instructions(*irreps, mode=mode)
    assert repr(got_irreps) == repr(want_irreps)
    assert [tuple(i) for i in got] == [tuple(i) for i in want]
    t_plan = t_tp.TensorProductPlan(irreps[0], irreps[1], got_irreps, got)
    j_plan = j_tp.TensorProductPlan(irreps[0], irreps[1], want_irreps, want)
    assert t_plan.weight_shapes == j_plan.weight_shapes
    assert [i.path_weight for i in t_plan.instructions] == [
        i.path_weight for i in j_plan.instructions]


# ----------------------------------------------------------------------
# attention pieces
# ----------------------------------------------------------------------

@pytest.mark.parametrize("heads", [None, 3])
def test_edge_softmax_matches_jax(heads):
    """Masked edges and a node (9) that no edge reaches."""
    rng = np.random.default_rng(1)
    shape = (E,) if heads is None else (E, heads)
    logits = (5.0 * rng.normal(size=shape)).astype(np.float32)
    dst = rng.integers(0, N - 1, size=E).astype(np.int64)
    mask = rng.random(E) > 0.2
    mask[dst == 3] = False  # node 3: only masked edges
    got = t_att.edge_softmax(torch.tensor(logits), torch.tensor(dst), N, torch.tensor(mask))
    want = j_att.edge_softmax(jnp.asarray(logits), jnp.asarray(dst), N, jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)
    assert float(got[torch.tensor(~mask)].abs().max()) == 0.0
    sums = np.zeros((N,) + shape[1:])
    np.add.at(sums, dst, got.numpy())
    live = np.unique(dst[mask])
    np.testing.assert_allclose(sums[live], 1.0, atol=1e-6)


def test_split_and_merge_heads_match_jax():
    x = _f32(np.random.default_rng(2), N, Irreps(FEAT).dim)
    for heads in (1, 2, 4):
        got = t_att.split_heads(torch.tensor(x), Irreps(FEAT), heads)
        want = j_att.split_heads(jnp.asarray(x), j_att.Irreps(FEAT), heads)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        h_irreps = t_att.heads_irreps(FEAT, heads)
        assert repr(h_irreps) == repr(j_att.heads_irreps(j_att.Irreps(FEAT), heads))
        back = t_att.merge_heads(got, h_irreps)
        np.testing.assert_array_equal(back.numpy(), x)
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(j_att.merge_heads(want, j_att.Irreps(repr(h_irreps)))))


def test_a_head_count_that_does_not_divide_is_refused_on_both_sides():
    x = _f32(np.random.default_rng(3), N, Irreps(FEAT).dim)
    with pytest.raises(ValueError, match="4x1o"):
        t_att.split_heads(torch.tensor(x), Irreps(FEAT), 8)
    with pytest.raises(TypeError):
        j_att.split_heads(jnp.asarray(x), j_att.Irreps(FEAT), 8)
    cfg = _merge(_merge(CLI_BASE, REPS["transformer"]), {
        "representation_nets": {"HamGNN_pre": {"num_heads": 3}}})
    g = t_pad(_crystals())
    with pytest.raises(ValueError, match="heads do not divide"):
        t_cli.build_model(load_config(None, overrides=cfg))(g)


def test_soft_unit_step_cutoff_matches_jax_with_finite_gradients():
    """Lengths past the cutoff (x <= 0) and the padded edges' length 1 at a
    cutoff below 1: value 0 and a finite gradient, as JAX's."""
    r = np.concatenate([np.linspace(0.1, 4.5, 30), [1.0, 1.0]]).astype(np.float32)
    check_both(j_radial.SoftUnitStepCutoff(cutoff=4.0), t_radial.SoftUnitStepCutoff(4.0), [r])
    cut = t_radial.SoftUnitStepCutoff(0.5)
    rt = torch.tensor(r, requires_grad=True)
    out = cut(rt)
    out.sum().backward()
    assert float(out[-2:].abs().max()) == 0.0
    assert torch.isfinite(rt.grad).all() and torch.isfinite(cut.cut_param.grad)


# ----------------------------------------------------------------------
# layers and blocks
# ----------------------------------------------------------------------

@pytest.mark.parametrize("with_perm", [False, True])
def test_kan_linear_matches_jax(with_perm):
    """Inputs inside and outside the grid's [-1, 1]."""
    perm = tuple(int(i) for i in np.random.default_rng(4).permutation(12)) if with_perm \
        else None
    x = (1.5 * _f32(np.random.default_rng(5), E, NRAD)).clip(-2.5, 2.5)
    check_both(j_mlp.KANLinear(NRAD, 12, out_perm=perm), t_mlp.KANLinear(NRAD, 12, out_perm=perm),
               [x])


def test_kan_generator_matches_jax():
    perm = np.random.default_rng(6).permutation(12)
    x = _f32(np.random.default_rng(7), E, NRAD)
    tmod = t_mlp.make_weight_generator(NRAD, (16,), 12, use_kan=True, out_perm=perm)
    assert [n for n, _ in tmod.named_children()] == ["KANLinear_0", "KANLinear_1"]
    check_both(j_mlp.make_weight_generator(NRAD, (16,), 12, use_kan=True, out_perm=perm), tmod,
               [x])


def _contraction_inputs(seed, doping):
    rng = np.random.default_rng(seed)
    x = _f32(rng, N, 4, Irreps("1x0e+1x0o+1x1o+1x1e+1x2e").dim)
    y = np.eye(TYPES, dtype=np.float32)[rng.integers(0, TYPES, size=N)]
    if doping:  # a charge-doped embedding: no longer one-hot
        y = y + 0.1 * _f32(rng, N, TYPES)
    return x, y


@pytest.mark.parametrize("doping", [False, True])
@pytest.mark.parametrize("correlation", [2, 3])
def test_symmetric_contraction_matches_jax(doping, correlation):
    coupling = "1x0e+1x0o+1x1o+1x1e+1x2e"
    hidden = "4x0e+4x0o+4x1o+4x1e+4x2e"
    x, y = _contraction_inputs(8, doping)
    tmod = t_sc.SymmetricContraction(coupling, hidden, correlation, 4, TYPES)
    out = check_both(j_sc.SymmetricContraction(coupling, hidden, correlation, 4, TYPES),
                        tmod, [x, y])
    assert out.shape == (N, Irreps(hidden).dim)


def _edge_inputs(seed, feat=FEAT):
    from hamgnn_tpu.e3 import spherical as j_sph

    rng = np.random.default_rng(seed)
    d = Irreps(feat).dim
    node, edge = _f32(rng, N, d), _f32(rng, E, d)
    sh = np.asarray(j_sph.spherical_harmonics([0, 1, 2], jnp.asarray(_f32(rng, E, 3))))
    scal = _f32(rng, E, NRAD)
    ei = rng.integers(0, N, size=(2, E)).astype(np.int64)
    mask = np.ones(E, bool)
    mask[-5:] = False
    length = (rng.random(E) * 3.5 + 0.5).astype(np.float32)
    length[~mask] = 1.0
    return node, edge, sh, scal, ei, mask, length


def test_corr_product_block_matches_jax():
    node = _edge_inputs(9)[0]
    attrs = np.eye(TYPES, dtype=np.float32)[np.random.default_rng(10).integers(0, TYPES, N)]
    check_both(j_blocks.CorrProductBlock(FEAT, 4, 2, TYPES),
               t_blocks.CorrProductBlock(FEAT, 4, 2, TYPES), [node, attrs])


@pytest.mark.parametrize("mode", ["uvu", "uvw"])
def test_tensor_product_matches_jax(mode):
    rng = np.random.default_rng(11)
    x1, x2 = _f32(rng, E, Irreps(SMALL).dim), _f32(rng, E, Irreps(SMALL).dim)
    mid, ins = t_tp.tp_out_irreps_with_instructions(SMALL, SMALL, "4x0e+2x1o+2x2e", mode=mode)
    tmod = t_tp.TensorProduct(SMALL, SMALL, mid, tuple(ins))
    assert {n for n, _ in tmod.named_parameters()} == {f"w{i}" for i in range(len(ins))}
    check_both(j_tp.TensorProduct(j_tp.Irreps(SMALL), j_tp.Irreps(SMALL),
                                  j_tp.Irreps(repr(mid)), tuple(ins)), tmod, [x1, x2])


def test_fully_connected_tensor_product_matches_jax():
    rng = np.random.default_rng(12)
    x1, x2 = _f32(rng, E, Irreps(SMALL).dim), _f32(rng, E, Irreps(SH).dim)
    check_both(j_tp.FullyConnectedTensorProduct(SMALL, SH, "4x0e+2x1o+2x2e+1x1e"),
               t_tp.FullyConnectedTensorProduct(SMALL, SH, "4x0e+2x1o+2x2e+1x1e"), [x1, x2])


@pytest.mark.parametrize("use_kan", [False, True])
def test_node_pair_tensor_product_matches_jax(use_kan):
    node, edge, _sh, scal, _ei, _m, _l = _edge_inputs(13, SMALL)
    kw = dict(radial_mlp=(16,), use_kan=use_kan)
    check_both(j_blocks.NodePairTensorProduct(SMALL, SMALL, NRAD, **kw),
               t_blocks.NodePairTensorProduct(SMALL, SMALL, NRAD, **kw),
               [node[:4].repeat(10, 0), edge, scal])


def test_message_pack_block_v2_matches_jax():
    node, edge, sh, scal, ei, _m, _l = _edge_inputs(14, NATURAL)
    src, dst = node[ei[0]], node[ei[1]]
    kw = dict(radial_mlp=(16,))
    check_both(j_blocks.MessagePackBlockV2(NATURAL, NATURAL, SH, NATURAL, NRAD, **kw),
               t_blocks.MessagePackBlockV2(NATURAL, NATURAL, SH, NATURAL, NRAD, **kw),
               [src, dst, edge, sh, scal])


@pytest.mark.parametrize("kw", [{}, {"affine": False, "divide_norm": True},
                                {"subtract_mean": False, "normalization": "norm"}])
def test_layer_norm_matches_jax(kw):
    """Against JAX at the initial values, then at other values of the
    affine parameters."""
    x = 3.0 * _f32(np.random.default_rng(15), E, Irreps(FEAT).dim) + 1.0
    tmod = init_weights(t_norm.E3LayerNorm(FEAT, **kw), 0)
    jmod = j_norm.E3LayerNorm(j_norm.Irreps(FEAT), **kw)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    flat = _flat(params.get("params", {}))
    assert set(flat) == {n for n, _ in tmod.named_parameters()}
    for n, p in tmod.named_parameters():  # the initial values: ones and zeros
        np.testing.assert_array_equal(p.detach().numpy(), flat[n])
    np.testing.assert_allclose(tmod(torch.tensor(x)).detach().numpy(),
                               np.asarray(jmod.apply(params, jnp.asarray(x))), **TOL)
    if kw.get("affine", True):
        params = jax.tree_util.tree_map(
            lambda v: v + 0.1 * jnp.asarray(_f32(np.random.default_rng(0), *v.shape)), params)
        check_both(_Fixed(jmod, params), t_norm.E3LayerNorm(FEAT, **kw), [x])
    else:
        check_both(jmod, t_norm.E3LayerNorm(FEAT, **kw), [x])


class _Fixed:
    """A flax module whose ``init`` returns the given parameters."""

    def __init__(self, module, params):
        self.module, self.params = module, params

    def init(self, _key, *_args):
        return self.params

    def apply(self, params, *args):
        return self.module.apply(params, *args)


def test_electron_configuration_embedding_matches_jax():
    z = np.random.default_rng(16).integers(1, 87, size=N).astype(np.int64)
    tmod = t_rep.ElectronConfigurationEmbedding(12)
    check_both(j_rep.ElectronConfigurationEmbedding(12), tmod, [z])
    init_weights(tmod, 0)
    lin = tmod.config_linear.detach()
    np.testing.assert_allclose((lin.T @ lin).numpy(), np.eye(12), atol=1e-5)
    assert float(tmod.element_embedding.min()) >= 0.0
    assert float(tmod.element_embedding.max()) <= 2 * 3 ** 0.5


def test_attention_block_matches_jax():
    node, edge, sh, scal, ei, mask, length = _edge_inputs(17, NATURAL)
    kw = dict(num_heads=2, max_radius=4.0, radial_mlp=(16,))
    check_both(j_att.AttentionBlockE3(NATURAL, NATURAL, SH, NRAD, **kw),
               t_att.AttentionBlockE3(NATURAL, NATURAL, SH, NRAD, **kw),
               [node, edge, sh, scal, length, ei, mask])


# ----------------------------------------------------------------------
# the three representations: the JAX CLI's stage test, the model, the port CLI
# ----------------------------------------------------------------------

def _rep_cfg(rep, **pre):
    return _merge(_merge(CLI_BASE, REPS[rep]), {"representation_nets": {"HamGNN_pre": pre}})


@pytest.fixture(scope="module")
def rep_cases(tmp_path_factory):
    """rep -> (config dict, crystals, the JAX CLI's run directory, its
    initial parameters, the JAX model's predictions and parameter gradients
    of the loss on those parameters).  The JAX CLI runs ``stage: test`` with
    no checkpoint on two crystals (one batch), the corr case with charge
    doping (its element embedding then is not one-hot)."""
    from hamgnn_tpu.train.trainer import Trainer as JTrainer

    out = {}
    real_init = JTrainer.init_params
    for rep in REPS:
        root = tmp_path_factory.mktemp(rep)
        crystals = _crystals(seed=1, doping=True)
        save_graph_npz(str(root / "graph_data.npz"), crystals)
        cfg = _merge(_rep_cfg(rep, **({"apply_charge_doping": True} if rep == "corr" else {})),
                     {"dataset_params": {"graph_data_path": str(root), "batch_size": 2}})
        made = []

        def init_params(self, *a, **k):
            made.append(real_init(self, *a, **k))
            return made[-1]

        JTrainer.init_params = init_params
        try:
            j_cli.main(["--config", _write(root / "jax.yaml", _merge(cfg, {
                "setup": {"stage": "test", "checkpoint_path": str(root / "missing")},
                "profiler_params": {"train_dir": str(root / "jax")}}))])
        finally:
            JTrainer.init_params = real_init
        params = made[0]
        jm, jg = j_cli.build_model(j_load_config(None, overrides=cfg)), j_pad(crystals)

        def loss(p):
            preds = jm.apply(p, jg)
            return j_losses(preds, jg, HAM)[0], {k: preds[k] for k in (
                "hamiltonian_on", "hamiltonian_off")}

        (_, preds), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        out[rep] = (cfg, crystals, root, params,
                    {k: np.asarray(v) for k, v in preds.items()}, _flat(grads["params"]))
    return out


def _port(cfg, params):
    tm = t_cli.build_model(load_config(None, overrides=cfg))
    flat = _flat(params["params"])
    assert set(flat) == {n.replace(".", "/") for n, _ in tm.named_parameters()}
    return load_flax_params(tm, flat)


@pytest.mark.parametrize("rep", sorted(REPS))
def test_representation_forward_matches_jax(rep_cases, rep):
    cfg, crystals, _root, params, want, _grads = rep_cases[rep]
    tm = _port(cfg, params)
    kind = {"transformer": t_rep.HamGNNTransformer}.get(rep, t_rep.HamGNNConvE3)
    assert type(tm.representation) is kind
    with torch.no_grad():
        got = tm(t_pad(crystals))
    for key in ("hamiltonian_on", "hamiltonian_off"):
        assert np.isfinite(got[key].numpy()).all()
        np.testing.assert_allclose(got[key].numpy(), want[key], err_msg=key, **TOL)


@pytest.mark.parametrize("rep", sorted(REPS))
def test_representation_gradients_match_jax(rep_cases, rep):
    cfg, crystals, _root, params, _preds, ref = rep_cases[rep]
    tm = _port(cfg, params)
    tg = t_pad(crystals)
    t_losses(tm(tg), tg, HAM)[0].backward()
    assert_grads_close({n.replace(".", "/"): _grad(p) for n, p in tm.named_parameters()}, ref)


@pytest.mark.parametrize("rep", sorted(REPS))
def test_cli_stage_test_matches_jax(rep_cases, rep, tmp_path):
    """``stage: test`` through the port's CLI from the JAX CLI's initial
    parameters (their flax .npz): the JAX CLI's prediction and target files,
    within the output tolerance."""
    cfg, _crystals_, root, params, _preds, _grads = rep_cases[rep]
    np.savez(tmp_path / "params.npz", **_flat(params["params"]))
    t_cli.main(["--config", _write(tmp_path / "port.yaml", _merge(cfg, {
        "setup": {"stage": "test", "checkpoint_path": str(tmp_path / "params.npz")},
        "profiler_params": {"train_dir": str(tmp_path / "port")}})), "--device", "cpu"])
    for name in ("prediction_hamiltonian", "target_hamiltonian"):
        got = np.load(tmp_path / "port" / f"{name}.npy")
        want = np.load(root / "jax" / f"{name}.npy")
        assert got.shape == want.shape and np.isfinite(got).all(), name
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)


def test_transformer_zonal_engine_matches_packed(rep_cases, monkeypatch):
    cfg, crystals, _root, params, _preds, _grads = rep_cases["transformer"]
    tm = _port(cfg, params)
    g = t_pad(crystals)
    with torch.no_grad():
        ref = tm(g)
        monkeypatch.setenv("HAMGNN_TP_ENGINE", "zonal")
        got = tm(g)
    for key in ("hamiltonian_on", "hamiltonian_off"):
        scale = float(ref[key].abs().max())
        assert float((got[key] - ref[key]).abs().max()) <= ENGINE_TOL * scale, key


def test_corr_checkpointing_gives_the_same_gradients():
    cfg = _rep_cfg("corr", num_layers=2)
    g = t_pad(_crystals(seed=2))
    grads = []
    for ckpt in (False, True):
        tm = init_weights(t_cli.build_model(load_config(None, overrides=_merge(cfg, {
            "setup": {"use_gradient_checkpointing": ckpt}}))), 0)
        assert tm.representation.use_gradient_checkpointing == ckpt
        t_losses(tm(g), g, HAM)[0].backward()
        grads.append({n: p.grad.clone() for n, p in tm.named_parameters()
                      if p.grad is not None})
    assert grads[0].keys() == grads[1].keys() and any("corr_1" in n for n in grads[0])
    for n in grads[0]:
        assert torch.equal(grads[0][n], grads[1][n]), n


def test_init_weights_keys_on_the_module():
    """KAN weights uniform within 1/sqrt(fan_in), the cutoff's sharpness
    10, and a model without the new modules draws what the rule of drawing
    every ``w`` / ``w<i>`` N(0, 1) in parameter order draws."""
    tm = init_weights(t_cli.build_model(load_config(None, overrides=_rep_cfg("kan"))), 3)
    kans = [(n, p) for n, p in tm.named_parameters() if n.endswith(("base_weight",
                                                                     "spline_weight"))]
    assert kans
    for n, p in kans:
        bound = 1.0 / np.sqrt(p.shape[0])
        assert 0.0 < float(p.abs().max()) <= bound, n
    tm = init_weights(t_cli.build_model(load_config(None, overrides=_rep_cfg("transformer"))), 3)
    assert all(float(p) == 10.0 for n, p in tm.named_parameters() if n.endswith("cut_param"))

    plain = t_cli.build_model(load_config(None, overrides=CLI_BASE))
    init_weights(plain, 5)
    gen = torch.Generator().manual_seed(5)
    for name, p in plain.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "w" or (leaf[0] == "w" and leaf[1:].isdigit()):
            assert torch.equal(p, torch.randn(p.shape, generator=gen)), name


@pytest.mark.parametrize("rep", sorted(REPS))
def test_cli_fit_then_test_from_best(tmp_path, rep):
    """``stage: fit`` through the port's CLI writes ``best.pt``; ``stage:
    test`` with ``checkpoint_path: <train_dir>/best`` predicts with the
    trained weights."""
    save_graph_npz(str(tmp_path / "graph_data.npz"), _crystals(3, seed=5))
    split = {"graph_data_path": str(tmp_path), "batch_size": 1, "train_ratio": 1 / 3,
             "val_ratio": 1 / 3, "test_ratio": 1 / 3}
    fit = _merge(_rep_cfg(rep), {
        "setup": {"stage": "fit"}, "dataset_params": split,
        "optim_params": {"lr": 1e-2, "min_epochs": 0, "max_epochs": 1},
        "profiler_params": {"train_dir": str(tmp_path / "fit")}})
    t_cli.main(["--config", _write(tmp_path / "fit.yaml", fit), "--device", "cpu"])
    assert (tmp_path / "fit" / "best.pt").exists()
    preds = {}
    for tag, ckpt in (("best", "fit/best"), ("none", "missing")):
        cfg = _merge(fit, {"setup": {"stage": "test", "checkpoint_path": str(tmp_path / ckpt)},
                           "profiler_params": {"train_dir": str(tmp_path / tag)}})
        t_cli.main(["--config", _write(tmp_path / f"{tag}.yaml", cfg), "--device", "cpu"])
        preds[tag] = np.load(tmp_path / tag / "prediction_hamiltonian.npy")
    assert np.isfinite(preds["best"]).all()
    assert np.abs(preds["best"] - preds["none"]).max() > 1e-3


@pytest.mark.parametrize("rep,engine", [("transformer", "auto"), ("transformer", "zonal"),
                                        ("corr", "auto"), ("kan", "auto")])
def test_steps_take_nothing_from_the_host_after_warm_up(tmp_path, monkeypatch, rep, engine):
    """After a first training and eval step, neither builds a tensor from
    host data nor reads a device value on the host: the trainer captures
    them on the card."""
    from test_torch_port_train import _HostTraffic, _port_line

    if engine != "auto":
        monkeypatch.setenv("HAMGNN_TP_ENGINE", engine)
    tm = init_weights(t_cli.build_model(load_config(None, overrides=_rep_cfg(rep))), 0)
    tr = t_trainer.Trainer(tm, losses=HAM, metrics=HAM, lr=1e-3, train_dir=str(tmp_path),
                           device="cpu")
    g = t_pad(_crystals(seed=6), bucket_multiple=8)

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
    assert calls == [] and mode.seen == []


def test_profile_summary_sums_device_time_by_kind(tmp_path):
    """``tools_dev.profile_summary`` on a profile file in ``chip_smoke.py``'s
    layout: each kernel row counted once, under the first kind it matches."""
    from hamgnn_tpu_torch.tools_dev import profile_summary

    rows = [("2.5000", 13, "(anonymous namespace)::packed_tp_bwd_reduce(float const*)"),
            ("1.0000", 10, "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8"),
            ("0.5000", 7, "void cublasLt::splitKreduce_kernel<32, 16, int, float>"),
            ("0.2500", 4, "void at::native::vectorized_elementwise_kernel<4, "
                          "at::native::FillFunctor<float>>"),
            ("0.1250", 2, "void at::native::reduce_kernel<512, 1>"),
            ("0.0625", 1, "void some_other_kernel")]
    path = tmp_path / "profile.txt"
    path.write_text("wall 5.000 ms/step, device busy 4.4375 ms/step\n" + "".join(
        f"{ms:>10} ms {n:6d} launches  {key}\n" for ms, n, key in rows))
    with open(path) as f:
        got = profile_summary.summarize(f)
    assert got == {"tp_kernels": (2.5, 13), "products": (1.5, 17), "fills": (0.25, 4),
                   "reductions": (0.125, 2), "other": (0.0625, 1), "all": (4.4375, 37)}
    profile_summary.main([str(path)])
