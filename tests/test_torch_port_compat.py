"""The port's checkpoint readers, reference-checkpoint import and Uni-HamGNN
predictor against the JAX package's.

* orbax (``interfaces/orbax_reader.py``): a JAX ``Trainer`` takes one step
  and writes ``save_checkpoint``; the port's ``Trainer.load_checkpoint``
  reads it, with and without ``gradient_clip_val`` (the amsgrad state's
  place in the optax chain): the parameters, ``count``, ``mu``, ``nu``,
  ``nu_max`` (mapped by parameter name through jax's unravel, not through
  the reader's index) and ``lr`` element for element; the update of one
  gradient at rtol 1e-6 against optax's from the restored state; the next
  two steps' losses at rtol 1e-4 against the JAX trainer's.  A missing
  ``tensorstore`` raises ``ImportError`` at every entry that reads orbax;
  ``stage: test`` from a JAX ``<train_dir>/best`` directory writes the JAX
  CLI's prediction files;
* ``interfaces/torch_ckpt.py``: every function against the JAX one,
  element-exact, over ``tests/test_torch_ckpt.py``'s irreps pairs;
* ``interfaces/e3nn_compat.py``: ``map_reference_state`` on the synthetic
  reference state dicts of ``tests/test_e3nn_compat.py`` /
  ``tests/test_uni_pickle.py`` (plain; corr + charge doping + overlap
  heads; su2; so3 with and without ``add_H_nonsoc``) gives the JAX keys and
  arrays exactly and covers the port's model both ways; the forward of
  ``HamGNNConvE3Compat`` + the head equals the JAX forward (plain, corr +
  doping, su2, so3) at atol 5e-5 / rtol 1e-4;
* ``interfaces/uni_pickle.py``: a pickle and a ``torch.save`` container of a
  reference predictor under unimportable module paths give the JAX side's
  state dicts exactly; the converted port package predicts both stages as
  the JAX package's converted package, and so does the JAX package read by
  the port;
* ``tools/uni_hamgnn.py``: the JAX predictor's orbax package, loaded by the
  port, predicts both stages as JAX does; the port's own package survives a
  round trip bit for bit; the CLI on a pair of npz sets writes the JAX CLI's
  ``prediction_hamiltonian.npy`` and MAE.

f32 on both sides, small widths (features at most
``tests/test_e3nn_compat.py``'s, one or two layers), one torch thread.
"""

import os
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax.traverse_util import flatten_dict
from jax.flatten_util import ravel_pytree
from test_torch_ckpt import e3nn_linear_forward
from util_fixtures import add_random_hamiltonian_targets, make_crystal

import test_e3nn_compat as ref
import test_uni_pickle as ref_pickle
from hamgnn_tpu import cli as j_cli
from hamgnn_tpu.data.dataset import GraphDataModule as JDataModule
from hamgnn_tpu.data.graph import pad_and_batch as j_pad
from hamgnn_tpu.e3.irreps import Irreps as JIrreps
from hamgnn_tpu.interfaces import e3nn_compat as j_compat
from hamgnn_tpu.interfaces import torch_ckpt as j_ckpt
from hamgnn_tpu.interfaces import uni_pickle as j_pickle
from hamgnn_tpu.models import soc as j_soc
from hamgnn_tpu.models.basis import get_basis_set as j_basis
from hamgnn_tpu.models.basis import hamiltonian_irreps as j_ham_irreps
from hamgnn_tpu.models.output import HamGNNPlusPlusOut as JHead
from hamgnn_tpu.nn.mlp import FullyConnectedNet as JFCN
from hamgnn_tpu.tools import uni_hamgnn as j_uni
from hamgnn_tpu.train import trainer as j_trainer
from hamgnn_tpu.train.config import load_config as j_load_config
from hamgnn_tpu_torch import cli as t_cli
from hamgnn_tpu_torch.data.dataset import GraphDataModule as TDataModule
from hamgnn_tpu_torch.data.dataset import save_graph_npz
from hamgnn_tpu_torch.data.graph import pad_and_batch as t_pad
from hamgnn_tpu_torch.data.synthetic import add_random_soc_targets
from hamgnn_tpu_torch.e3.linear import Linear
from hamgnn_tpu_torch.interfaces import e3nn_compat as t_compat
from hamgnn_tpu_torch.interfaces import orbax_reader
from hamgnn_tpu_torch.interfaces import torch_ckpt as t_ckpt
from hamgnn_tpu_torch.interfaces import uni_pickle as t_pickle
from hamgnn_tpu_torch.interfaces.jax_params import load_flax_params
from hamgnn_tpu_torch.models import soc as t_soc
from hamgnn_tpu_torch.models.basis import get_basis_set as t_basis
from hamgnn_tpu_torch.models.basis import hamiltonian_irreps as t_ham_irreps
from hamgnn_tpu_torch.models.model import HamGNNModel
from hamgnn_tpu_torch.models.output import HamGNNPlusPlusOut as THead
from hamgnn_tpu_torch.nn.mlp import FullyConnectedNet as TFCN
from hamgnn_tpu_torch.tools import uni_hamgnn as t_uni
from hamgnn_tpu_torch.train import trainer as t_trainer
from hamgnn_tpu_torch.train.config import load_config as t_load_config

TOL = dict(atol=5e-5, rtol=1e-4)
SMALL = "4x0e+2x0o+2x1o+2x1e+2x2e"  # forward tests: both parities of l <= 2
SMALL_SH = "0e+1o+2e"
HAM_KEYS = ("hamiltonian_on", "hamiltonian_off")
SOC_KEYS = ("hamiltonian_real_on", "hamiltonian_real_off", "hamiltonian_imag_on",
            "hamiltonian_imag_off")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _merge(a, b):
    out = dict(a)
    for k, v in b.items():
        out[k] = _merge(a[k], v) if isinstance(v, dict) and k in a else v
    return out


def _write(path, cfg):
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def _jflat(params):
    return {"/".join(k): (v if isinstance(v, jax.ShapeDtypeStruct) else np.asarray(v))
            for k, v in flatten_dict(params).items()}


def _assert_same_assignments(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _assert_outputs(t_out, j_out, keys):
    for k in keys:
        want = np.asarray(j_out[k])
        got = t_out[k].detach().numpy()
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got, want, err_msg=k, **TOL)


@pytest.fixture
def small_widths(monkeypatch):
    """The reference-state builders of ``tests/test_e3nn_compat.py`` and
    ``tests/test_uni_pickle.py`` at the forward tests' widths."""
    for mod in (ref, ref_pickle):
        monkeypatch.setattr(mod, "FEAT", SMALL)
        monkeypatch.setattr(mod, "SH", SMALL_SH)
        monkeypatch.setattr(mod, "NUM_LAYERS", 1)


# ---------------------------------------------------------------------------
# torch_ckpt
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("irr_in,irr_out", [
    ("8x0e+4x1o+2x2e", "6x0e+4x1o+2x2e"),
    ("4x0e+4x0e+2x1o", "3x0e+5x1o+1x2e"),
    ("2x1o+2x1e", "2x1e+2x1o"),
])
def test_o3_linear_conversion_matches_jax(irr_in, irr_out):
    assert t_ckpt.e3nn_linear_instructions(irr_in, irr_out) == \
        j_ckpt.e3nn_linear_instructions(irr_in, irr_out)
    ji, jo = JIrreps(irr_in), JIrreps(irr_out)
    n_w = sum(ji[i].mul * jo[j].mul for i, j in j_ckpt.e3nn_linear_instructions(ji, jo))
    rng = np.random.default_rng(0)
    flat_w = rng.standard_normal(n_w).astype(np.float32)
    got = t_ckpt.convert_o3_linear_weight(flat_w, irr_in, irr_out)
    np.testing.assert_array_equal(got, j_ckpt.convert_o3_linear_weight(flat_w, ji, jo))
    # the converted weight in the port's Linear is e3nn's o3.Linear
    lin = Linear(irr_in, irr_out)
    t_ckpt.assign_params(lin, {"w": got})
    x = rng.standard_normal((5, ji.dim)).astype(np.float32)
    with torch.no_grad():
        y = lin(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(y, e3nn_linear_forward(x, flat_w, ji, jo), atol=1e-5)
    with pytest.raises(ValueError):
        t_ckpt.convert_o3_linear_weight(flat_w[:-1], irr_in, irr_out)


def test_fcn_flatten_assign_and_suggest_match_jax():
    rng = np.random.default_rng(1)
    state = {"radial.layers.0.weight": rng.standard_normal((16, 32)).astype(np.float32),
             "radial.layers.1.weight": rng.standard_normal((32, 8)).astype(np.float32),
             "lin.weight": np.zeros(16, np.float32), "other": np.zeros((3, 3))}
    conv = t_ckpt.convert_fcn_weights(state, "radial.")
    _assert_same_assignments(conv, j_ckpt.convert_fcn_weights(state, "radial."))
    with pytest.raises(KeyError):
        t_ckpt.convert_fcn_weights(state, "nope.")

    jnet = JFCN(hs=(16, 32, 8))
    x = rng.standard_normal((3, 16)).astype(np.float32)
    jparams = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    tree = {"a": {"w0": np.ones((2, 3)), "b": {"w": np.zeros(4)}}, "c": np.arange(3)}
    _assert_same_assignments(t_ckpt.flatten_params(tree), j_ckpt.flatten_params(tree))
    flat = j_ckpt.flatten_params(tree)
    assert t_ckpt.unflatten_params(flat).keys() == j_ckpt.unflatten_params(flat).keys()
    _assert_same_assignments(t_ckpt.flatten_params(t_ckpt.unflatten_params(flat)), flat)

    # a nested dict and a module of the port: the same assignment, the same result
    j_new, j_untouched = j_ckpt.assign_params(jparams, {"w0": conv["w0"]})
    t_new, t_untouched = t_ckpt.assign_params(jparams, {"w0": conv["w0"]})
    assert t_untouched == j_untouched == ["w1"]
    _assert_same_assignments(t_ckpt.flatten_params(t_new), j_ckpt.flatten_params(j_new))
    tnet = TFCN((16, 32, 8))
    load_flax_params(tnet, _jflat(jparams))
    _, m_untouched = t_ckpt.assign_params(tnet, conv)
    assert m_untouched == []
    with torch.no_grad():
        got = tnet(torch.as_tensor(x)).numpy()
    want = jnet.apply({"params": {"w0": jnp.asarray(conv["w0"]),
                                  "w1": jnp.asarray(conv["w1"])}}, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    for params in (jparams, tnet):
        with pytest.raises(KeyError):
            t_ckpt.assign_params(params, {"nope": conv["w0"]})
        with pytest.raises(ValueError):
            t_ckpt.assign_params(params, {"w0": np.zeros((2, 2))})
    assert t_ckpt.suggest_shape_matches(tnet, state) == \
        j_ckpt.suggest_shape_matches(jparams, state)
    lin = Linear("4x0e", "4x0e")
    assert t_ckpt.suggest_shape_matches(lin, state) == {"w": ["lin.weight"]}


def test_load_torch_checkpoint_matches_jax(tmp_path):
    sd = {"model.head.weight": torch.arange(6, dtype=torch.float32).reshape(2, 3),
          "model.rep.bias": torch.ones(4, dtype=torch.float64),
          "other.x": torch.zeros(2), "model.epoch_count": 7}
    path = str(tmp_path / "ref.ckpt")
    torch.save({"state_dict": sd, "hyper_parameters": {"lr": 1e-3}}, path)
    got, want = t_ckpt.load_torch_checkpoint(path), j_ckpt.load_torch_checkpoint(path)
    assert list(got) == list(want) == ["head.weight", "rep.bias", "other.x"]
    _assert_same_assignments(got, want)
    torch.save(sd, str(tmp_path / "plain.pt"))
    plain = t_ckpt.load_torch_checkpoint(str(tmp_path / "plain.pt"), ("model.", "other."))
    assert list(plain) == ["head.weight", "rep.bias", "x"]


# ---------------------------------------------------------------------------
# e3nn_compat: the mapping
# ---------------------------------------------------------------------------

def _soc_head_state(rng, feat, irreps_out, heads=("onsite_hamiltonian", "offsite_hamiltonian")):
    from hamgnn_tpu.e3.gate import make_gate

    gate, gate_in = make_gate(JIrreps(feat))
    state, O = {}, "output_module."

    def lin(key, ir_in, ir_out):
        state[key] = rng.normal(size=(ref._e3nn_linear_numel(ir_in, ir_out),))

    for head in heads:
        lin(O + f"{head}_network.residual_block.linear1.weight", JIrreps(feat), gate_in)
        lin(O + f"{head}_network.residual_block.linear2.weight",
            JIrreps(gate.irreps_out), JIrreps(feat))
        lin(O + f"{head}_network.linear_transform.weight", JIrreps(feat), irreps_out)
    return state


def _case(name, rng):
    """(reference state, map_reference_state kwargs, port model) of a case,
    at the reference builders' current widths."""
    feat, sh, layers = ref.FEAT, ref.SH, ref.NUM_LAYERS
    basis = j_basis("openmx", 14)
    ham = j_ham_irreps(basis)
    kw = dict(num_types=ref.NUM_TYPES, irreps_node_features=feat, irreps_edge_sh=sh,
              num_layers=layers, irreps_ham=ham)
    rep_kw = dict(num_types=ref.NUM_TYPES, irreps_edge_sh=sh, irreps_node_features=feat,
                  num_layers=layers, num_radial=ref.NUM_RADIAL, cutoff=4.0,
                  radial_mlp=ref.RADIAL_MLP)
    head_kw = dict(irreps_in_node=feat, irreps_in_edge=feat, nao_max=14, ham_type="openmx",
                   add_H0=False, zero_point_shift=False)
    if name == "plain":
        state = ref._build_reference_state(rng)
        head = THead(ham_only=True, **head_kw)
    elif name == "corr_doping_overlap":
        state = ref._add_corr_doping_overlap_state(rng, ref._build_reference_state(rng))
        kw.update(use_corr_prod=True, correlation=2, num_hidden_features=4,
                  apply_charge_doping=True, ham_only=False)
        rep_kw.update(use_corr_prod=True, correlation=2, num_hidden_features=4,
                      apply_charge_doping=True, num_charge_attr_feas=4)
        head = THead(ham_only=False, **head_kw)
    elif name == "su2":
        su2 = j_soc.su2_base_irreps(basis)
        state = {k: v for k, v in ref._build_reference_state(rng).items()
                 if k.startswith("representation.")}
        state.update(_soc_head_state(rng, feat, su2 + su2))
        kw.update(soc_basis="su2", irreps_ham_su2=su2)
        head = t_soc.HamGNNSOCOut(soc_basis="su2", symmetrize=True, **head_kw)
    else:  # so3, so3_nonsoc
        nonsoc = name == "so3_nonsoc"
        state = ref_pickle._build_soc_reference_state(rng)
        kw.update(soc_basis="so3", nao_max=14, add_H_nonsoc=nonsoc)
        head = t_soc.HamGNNSOCOut(soc_basis="so3", symmetrize=True, add_H_nonsoc=nonsoc,
                                  **head_kw)
    model = HamGNNModel(t_compat.HamGNNConvE3Compat(**rep_kw), head)
    return state, kw, model


def _port_kw(kw):
    """map_reference_state kwargs with the irreps as strings for the port."""
    return {k: (repr(v) if isinstance(v, JIrreps) else v) for k, v in kw.items()}


@pytest.mark.parametrize("name", ["plain", "corr_doping_overlap", "su2", "so3",
                                  "so3_nonsoc"])
def test_map_reference_state_matches_jax(name):
    """At ``tests/test_e3nn_compat.py``'s widths (two layers, SH to 4e): the
    same assignments as JAX, and full coverage of the port's model both
    ways."""
    state, kw, model = _case(name, np.random.default_rng(0))
    got = t_compat.map_reference_state(state, **_port_kw(kw))
    _assert_same_assignments(got, j_compat.map_reference_state(state, **kw))
    _, untouched = t_ckpt.assign_params(model, got)
    assert untouched == []
    assert set(got) == set(t_ckpt.flatten_params(model))
    bad = dict(state, **{"representation.nowhere.weight": np.zeros(3)})
    with pytest.raises(KeyError):
        t_compat.map_reference_state(bad, **_port_kw(kw))


def test_reference_state_shapes_are_the_reference_builders():
    """``reference_state_shapes`` (what ``chip_smoke.py`` fills a synthetic
    checkpoint from) names the keys and shapes of
    ``tests/test_e3nn_compat.py``'s reference state dict."""
    state = ref._build_reference_state(np.random.default_rng(0))
    shapes = t_compat.reference_state_shapes(
        num_types=ref.NUM_TYPES, irreps_node_features=ref.FEAT, irreps_edge_sh=ref.SH,
        num_layers=ref.NUM_LAYERS, irreps_ham=repr(t_ham_irreps(t_basis("openmx", 14))),
        num_radial=ref.NUM_RADIAL, radial_mlp=ref.RADIAL_MLP)
    assert shapes == {k: v.shape for k, v in state.items()}


def test_split_e3nn_tp_weight_matches_jax():
    feat, sh = JIrreps(ref.FEAT), JIrreps(ref.SH)
    mid, ins = j_compat.tp_out_irreps_with_instructions(feat, sh, feat)
    numel = ref._tp_numel(feat, sh, mid, ins)
    flat = np.random.default_rng(0).normal(size=numel)
    got = t_compat.split_e3nn_tp_weight(flat, ref.FEAT, ref.SH, repr(mid), ins)
    _assert_same_assignments(got, j_compat.split_e3nn_tp_weight(flat, feat, sh, mid, ins))
    with pytest.raises(ValueError):
        t_compat.split_e3nn_tp_weight(flat[:-1], ref.FEAT, ref.SH, repr(mid), ins)


# ---------------------------------------------------------------------------
# e3nn_compat: the forward
# ---------------------------------------------------------------------------

def _graph_pair(rng, soc=False, doping=None):
    c = add_random_hamiltonian_targets(rng, make_crystal(rng, n_atoms=4, species=(6, 14)),
                                       nao_max=14)
    if soc:
        n, e = c["z"].shape[0], c["edge_index"].shape[1]
        c["Lon"] = 0.1 * rng.normal(size=(n, 196, 3))
        c["Loff"] = 0.1 * rng.normal(size=(e, 196, 3))
    if doping is not None:
        c["doping_charge"] = np.asarray([doping], np.float32)
    return j_pad([c], bucket_multiple=8), t_pad([c], bucket_multiple=8, device="cpu")


def _jax_compat(model):
    """The JAX compat representation matching the port ``model``'s."""
    rep = model.representation
    return j_compat.HamGNNConvE3Compat(
        num_types=rep.num_types, irreps_edge_sh=ref.SH, irreps_node_features=ref.FEAT,
        num_layers=rep.num_layers, num_radial=ref.NUM_RADIAL, cutoff=4.0,
        radial_mlp=ref.RADIAL_MLP, use_corr_prod=rep.use_corr_prod, correlation=2,
        num_hidden_features=4, apply_charge_doping=rep.apply_charge_doping,
        num_charge_attr_feas=4)


@pytest.mark.parametrize("name", ["plain", "corr_doping_overlap", "su2", "so3_nonsoc"])
def test_compat_forward_matches_jax(small_widths, name):
    """The imported model's forward through the port against the JAX compat
    model on the same parameters."""
    rng = np.random.default_rng(1)
    state, kw, model = _case(name, rng)
    t_ckpt.assign_params(model, t_compat.map_reference_state(state, **_port_kw(kw)))
    tree = t_ckpt.unflatten_params(t_ckpt.flatten_params(model))
    jg, tg = _graph_pair(rng, soc=name.startswith("so3"),
                         doping=0.3 if name == "corr_doping_overlap" else None)
    jrep = _jax_compat(model)
    feats = jax.jit(lambda p, g: jrep.apply({"params": p}, g))(tree["representation"], jg)
    head_kw = dict(irreps_in_node=ref.FEAT, irreps_in_edge=ref.FEAT, nao_max=14,
                   ham_type="openmx", add_H0=False, zero_point_shift=False)
    kwargs, t_kwargs = {}, {}
    if name in ("plain", "corr_doping_overlap"):
        jhead = JHead(ham_only=name == "plain", **head_kw)
        keys = HAM_KEYS + (() if name == "plain" else ("overlap_on", "overlap_off"))
    else:
        jhead = j_soc.HamGNNSOCOut(soc_basis=kw["soc_basis"], symmetrize=True,
                                   add_H_nonsoc=name == "so3_nonsoc", **head_kw)
        keys = SOC_KEYS
        if name == "so3_nonsoc":
            h = (rng.normal(size=(jg.num_nodes, 196)).astype(np.float32),
                 rng.normal(size=(jg.num_edges, 196)).astype(np.float32))
            kwargs = {"h_nonsoc": tuple(jnp.asarray(a) for a in h)}
            t_kwargs = {"h_nonsoc": tuple(torch.as_tensor(a) for a in h)}
    want = jax.jit(lambda p, g, f, kw: jhead.apply({"params": p}, g, f, **kw))(
        tree["output"], jg, feats, kwargs)
    with torch.no_grad():
        t_feats = model.representation(tg)
        got = model.output(tg, t_feats, **t_kwargs)
    _assert_outputs(t_feats, feats, ("node_attr", "edge_attr"))
    _assert_outputs(got, want, keys)


def test_legacy_edge_update_keeps_the_parameter_tree():
    """``legacy_edge_update``: the first pair block keeps the edge features,
    its parameters exist as in the flax tree."""
    rep = t_compat.HamGNNConvE3Compat(num_types=8, irreps_edge_sh=SMALL_SH,
                                      irreps_node_features=SMALL, num_layers=2,
                                      num_radial=4, cutoff=4.0, radial_mlp=(4,),
                                      legacy_edge_update=True)
    jrep = j_compat.HamGNNConvE3Compat(num_types=8, irreps_edge_sh=SMALL_SH,
                                       irreps_node_features=SMALL, num_layers=2,
                                       num_radial=4, cutoff=4.0, radial_mlp=(4,),
                                       legacy_edge_update=True)
    rng = np.random.default_rng(2)
    c = make_crystal(rng, n_atoms=3, species=(1, 6))
    shapes = jax.eval_shape(jrep.init, jax.random.PRNGKey(0),
                            j_pad([c], bucket_multiple=8))["params"]
    want = {k: v.shape for k, v in _jflat(shapes).items()}
    got = {k: tuple(v.shape) for k, v in t_ckpt.flatten_params(rep).items()}
    assert got == want
    assert rep.pair_interactions_0.skip_linear is None
    assert rep.pair_interactions_1.skip_linear is not None


# ---------------------------------------------------------------------------
# uni_pickle
# ---------------------------------------------------------------------------

def _predictor_pickle(path, states, zip_container):
    """A reference predictor under unimportable module paths, pickled or
    ``torch.save``d, as ``tests/test_uni_pickle.py`` builds it."""
    legacy, legacy_models = types.ModuleType("HamGNN_v_2_1"), \
        types.ModuleType("HamGNN_v_2_1.models")

    class Model(torch.nn.Module):
        pass

    Model.__module__, Model.__qualname__ = "HamGNN_v_2_1.models", "Model"
    legacy_models.Model = Model

    class HP:
        pass

    pred_mod = types.ModuleType("Uni_HamiltonianPredictor")
    HP.__module__, HP.__qualname__ = "Uni_HamiltonianPredictor", "HamiltonianPredictor"
    pred_mod.HamiltonianPredictor = HP
    names = {"HamGNN_v_2_1": legacy, "HamGNN_v_2_1.models": legacy_models,
             "Uni_HamiltonianPredictor": pred_mod}
    sys.modules.update(names)
    try:
        def as_model(state):
            inner = ref_pickle._torch_module_from_state(state)
            m = Model()
            m.representation, m.output_module = inner.representation, inner.output_module
            return m

        pred = HP()
        pred.non_soc_model = as_model(states["non_soc"])
        pred.soc_model = as_model(states["soc"]) if "soc" in states else None
        pred.device = "cpu"
        if zip_container:
            torch.save(pred, str(path))
        else:
            with open(path, "wb") as f:
                pickle.dump(pred, f)
    finally:
        for name in names:
            sys.modules.pop(name, None)
    return str(path)


@pytest.mark.parametrize("zip_container", [False, True], ids=["pickle", "torch_save"])
def test_stub_unpickle_matches_jax(tmp_path, zip_container):
    rng = np.random.default_rng(0)
    states = {"non_soc": ref._build_reference_state(rng),
              "soc": ref_pickle._build_soc_reference_state(rng)}
    path = _predictor_pickle(tmp_path / "pred.pkl", states, zip_container)
    pred = t_pickle.stub_unpickle(path)
    assert type(pred).__name__.startswith("Stub_") and isinstance(pred, t_pickle.StubBase)
    got, want = t_pickle.predictor_state_dicts(pred), \
        j_pickle.predictor_state_dicts(j_pickle.stub_unpickle(path))
    assert set(got) == set(want) == {"non_soc", "soc"}
    for stage in want:
        assert set(got[stage]) == set(states[stage])
        _assert_same_assignments(got[stage], want[stage])
    with open(path, "rb") as f:
        again = t_pickle.predictor_state_dicts(t_pickle.stub_unpickle(f.read()))
    _assert_same_assignments(again["soc"], got["soc"])
    with pytest.raises(ValueError):
        t_pickle.predictor_state_dicts(object())


def _uni_overrides(soc):
    out = {"nao_max": 14, "ham_type": "openmx", "add_H0": False, "zero_point_shift": False}
    if soc:
        out.update(soc_switch=True, soc_basis="so3")
    return {"representation_nets": {"HamGNN_pre": {
        "num_types": ref.NUM_TYPES, "irreps_edge_sh": ref.SH, "irreps_node_features": ref.FEAT,
        "num_layers": ref.NUM_LAYERS, "num_radial": ref.NUM_RADIAL, "cutoff": 4.0,
        "radial_MLP": list(ref.RADIAL_MLP)}},
        "output_nets": {"HamGNN_out": out}}


def test_converted_predictor_pickle_predicts_as_jax(tmp_path, small_widths):
    """A two-stage ``torch.save`` predictor converted by both packages: the
    port's package (npz), and the JAX package's (orbax) read by the port,
    predict both stages as the JAX package's."""
    rng = np.random.default_rng(3)
    states = {"non_soc": ref._build_reference_state(rng),
              "soc": ref_pickle._build_soc_reference_state(rng)}
    path = _predictor_pickle(tmp_path / "uni.pkl", states, zip_container=True)
    jg, tg = _graph_pair(rng, soc=True)
    j_counts = j_pickle.convert_predictor_pickle(
        path, j_load_config(None, _uni_overrides(False)), str(tmp_path / "jax"),
        example_graph=jg, soc_config=j_load_config(None, _uni_overrides(True)))
    t_counts = t_pickle.convert_predictor_pickle(
        path, t_load_config(None, _uni_overrides(False)), str(tmp_path / "port"),
        soc_config=t_load_config(None, _uni_overrides(True)))
    assert t_counts == j_counts and t_counts["soc"] > 50
    assert sorted(os.listdir(tmp_path / "port")) == [
        "compat.yaml", "nonsoc.yaml", "nonsoc_params.npz", "soc.yaml", "soc_params.npz"]

    jp = j_uni.HamiltonianPredictor.load(str(tmp_path / "jax"))
    j1 = jp.predict_nonsoc(jg)
    j2 = jp.predict_soc(jg, j1["hamiltonian_on"], j1["hamiltonian_off"])
    for pkg in ("port", "jax"):
        tp = t_uni.HamiltonianPredictor.load(str(tmp_path / pkg), device="cpu")
        assert tp.compat and tp.soc_enabled
        t1 = tp.predict_nonsoc(tg)
        t2 = tp.predict_soc(tg, t1["hamiltonian_on"], t1["hamiltonian_off"])
        _assert_outputs(t1, j1, HAM_KEYS)
        _assert_outputs(t2, j2, SOC_KEYS)


# ---------------------------------------------------------------------------
# uni_hamgnn
# ---------------------------------------------------------------------------

UNI_PRE = {"irreps_node_features": SMALL, "irreps_edge_sh": SMALL_SH, "num_layers": 1,
           "num_radial": 8, "cutoff": 4.0, "radial_MLP": [8], "num_types": 20}


def _uni_cfg(soc):
    return {"setup": {"GNN_Net": "HamGNNpre"},
            "representation_nets": {"HamGNN_pre": dict(UNI_PRE)},
            "output_nets": {"HamGNN_out": {
                "nao_max": 14, "ham_type": "openmx", "soc_switch": soc, "soc_basis": "so3",
                "add_H0": False, "zero_point_shift": False}}}


@pytest.fixture(scope="module")
def uni_jax(tmp_path_factory):
    """The JAX two-stage predictor (seeded init), its orbax package, a pair of
    graph sets of the same two structures, its non-SOC prediction of the
    first and the JAX CLI's output (the SOC stage's real rows)."""
    root = tmp_path_factory.mktemp("uni")
    _write(root / "nonsoc.yaml", _uni_cfg(False))
    _write(root / "soc.yaml", _uni_cfg(True))
    rng = np.random.default_rng(0)
    plain, spinor = [], []
    for _ in range(2):
        c = add_random_hamiltonian_targets(
            rng, make_crystal(rng, n_atoms=3, species=(6, 14)), nao_max=14)
        plain.append(c)
        spinor.append(add_random_soc_targets(rng, dict(c)))
    save_graph_npz(str(root / "nonsoc.npz"), plain)
    save_graph_npz(str(root / "soc.npz"), spinor)

    pred = j_uni.HamiltonianPredictor(str(root / "nonsoc.yaml"), str(root / "soc.yaml"),
                                      soc_switch=True)
    jg = j_pad([plain[0]], bucket_multiple=8)
    jg_soc = j_pad([spinor[0]], bucket_multiple=8)
    pred.params_nonsoc = j_trainer.init_params_on_cpu(pred.model_nonsoc, jg, 0)
    zeros = (np.zeros((jg_soc.num_nodes, 196), np.float32),
             np.zeros((jg_soc.num_edges, 196), np.float32))
    pred.params_soc = j_trainer.init_params_on_cpu(
        pred.model_soc, jg_soc, 1,
        method=lambda m, g: m.output(g, m.representation(g), h_nonsoc=zeros))
    pred.save(str(root / "pkg"))
    cli = {"model_pkl_path": str(root / "pkg"), "non_soc_data_dir": str(root / "nonsoc.npz"),
           "soc_data_dir": str(root / "soc.npz"), "calculate_mae": True}
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        j_uni.main(["--config", _write(root / "jax_input.yaml",
                                       dict(cli, output_dir=str(root / "jax_out")))])
    return {"root": root, "plain": plain, "spinor": spinor, "cli": cli,
            "p1": pred.predict_nonsoc(jg), "mae": buf.getvalue(),
            "rows": np.load(root / "jax_out" / "prediction_hamiltonian.npy")}


def test_port_loads_the_jax_package_and_predicts_both_stages(uni_jax):
    """The JAX package (orbax) read by the port: the non-SOC stage's
    prediction, and the SOC stage's real rows of each structure as the JAX
    CLI wrote them."""
    pred = t_uni.HamiltonianPredictor.load(str(uni_jax["root"] / "pkg"), device="cpu")
    assert pred.soc_enabled and not pred.compat
    rows = []
    for c, c_soc in zip(uni_jax["plain"], uni_jax["spinor"]):
        tg = t_pad([c], bucket_multiple=8, device="cpu")
        tg_soc = t_pad([c_soc], bucket_multiple=8, device="cpu")
        t1 = pred.predict_nonsoc(tg)
        t2 = pred.predict_soc(tg_soc, t1["hamiltonian_on"], t1["hamiltonian_off"])
        if not rows:
            _assert_outputs(t1, uni_jax["p1"], HAM_KEYS + ("mask_on", "mask_off"))
            mae = t_uni.masked_mae(t1["hamiltonian_on"], tg.Hon, t1["mask_on"])
            assert mae == pytest.approx(j_uni.masked_mae(
                uni_jax["p1"]["hamiltonian_on"], np.asarray(tg.Hon),
                uni_jax["p1"]["mask_on"]), rel=1e-4)
        n, e = c["z"].shape[0], c["edge_index"].shape[1]
        rows += [t2["hamiltonian_real_on"][:n].numpy(), t2["hamiltonian_real_off"][:e].numpy()]
    np.testing.assert_allclose(np.concatenate(rows), uni_jax["rows"], **TOL)


def test_port_package_round_trip(uni_jax, tmp_path):
    pred = t_uni.HamiltonianPredictor.load(str(uni_jax["root"] / "pkg"), device="cpu")
    pred.save(str(tmp_path / "port_pkg"))
    assert sorted(os.listdir(tmp_path / "port_pkg")) == [
        "nonsoc.yaml", "nonsoc_params.npz", "soc.yaml", "soc_params.npz"]
    again = t_uni.HamiltonianPredictor.load(str(tmp_path / "port_pkg"), device="cpu")
    for a, b in ((pred.model_nonsoc, again.model_nonsoc), (pred.model_soc, again.model_soc)):
        sa, sb = a.state_dict(), b.state_dict()
        assert set(sa) == set(sb)
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    assert again.config_soc.output_nets.HamGNN_out.add_H_nonsoc


def test_uni_hamgnn_cli_matches_jax_cli(uni_jax, tmp_path, capsys):
    """The port's CLI, on the port's own package converted from the JAX one,
    writes the JAX CLI's predictions and prints its MAE."""
    t_uni.HamiltonianPredictor.load(str(uni_jax["root"] / "pkg"), device="cpu").save(
        str(tmp_path / "pkg"))
    cfg = dict(uni_jax["cli"], model_pkl_path=str(tmp_path / "pkg"),
               output_dir=str(tmp_path / "out"))
    t_uni.main(["--config", _write(tmp_path / "input.yaml", cfg), "--device", "cpu"])
    got = np.load(tmp_path / "out" / "prediction_hamiltonian.npy")
    want = np.load(uni_jax["root"] / "jax_out" / "prediction_hamiltonian.npy")
    assert got.shape == want.shape == (sum(c["z"].shape[0] + c["edge_index"].shape[1]
                                           for c in uni_jax["spinor"]), 28 * 28)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, **TOL)
    t_mae = float(capsys.readouterr().out.split("masked MAE:")[1].split()[0])
    j_mae = float(uni_jax["mae"].split("masked MAE:")[1].split()[0])
    assert t_mae == pytest.approx(j_mae, rel=2e-3)  # printed to 4 digits


# ---------------------------------------------------------------------------
# orbax: the JAX trainer's checkpoints
# ---------------------------------------------------------------------------

TRAIN_BASE = {
    "representation_nets": {"HamGNN_pre": {
        "irreps_node_features": "8x0e+4x1o+2x2e", "irreps_edge_sh": "0e+1o+2e",
        "num_layers": 1, "num_radial": 8, "cutoff": 4.0, "radial_MLP": [8],
        "num_types": 16}},
    "output_nets": {"HamGNN_out": {"nao_max": 14}},
}
LOSSES = [{"metric": "mae", "prediction": "hamiltonian", "target": "hamiltonian",
           "loss_weight": 27.211}]


def _crystals(n, seed):
    rng = np.random.default_rng(seed)
    return [add_random_hamiltonian_targets(
        rng, make_crystal(rng, n_atoms=3 + i % 2, cutoff=4.0), nao_max=14)
        for i in range(n)]


_JAX_CKPTS = {}


def _jax_ckpt(clip, tmp_path_factory):
    """A JAX trainer after one step, its checkpoint in ``<train_dir>/best``,
    and the batches both trainers step on; one per clip setting."""
    if clip in _JAX_CKPTS:
        return _JAX_CKPTS[clip]
    root = tmp_path_factory.mktemp("orbax")
    crystals = _crystals(4, seed=4)
    kw = dict(losses=LOSSES, metrics=[], lr=1e-3, gradient_clip_val=clip, min_epochs=0,
              max_epochs=2)
    jd = JDataModule(crystals, batch_size=2, train_ratio=1.0, val_ratio=0.0, test_ratio=0.0)
    jb = list(jd.train_batches(np.random.default_rng(1)))
    jt = j_trainer.Trainer(j_cli.build_model(j_load_config(None, overrides=TRAIN_BASE)),
                           train_dir=str(root / "train"), **kw)
    jt.init_params(jb[0])
    jt.train_epoch([jb[0]])
    jt.sched.lr = 7e-4  # a learning rate the port must read back
    jt.save_checkpoint(str(root / "train" / "best"))
    td = TDataModule(crystals, batch_size=2, train_ratio=1.0, val_ratio=0.0,
                     test_ratio=0.0, device="cpu")
    tb = list(td.train_batches(np.random.default_rng(1)))
    _JAX_CKPTS[clip] = {"clip": clip, "root": root, "jt": jt, "jb": jb, "tb": tb, "kw": kw,
                        "crystals": crystals}
    return _JAX_CKPTS[clip]


@pytest.fixture(scope="module", params=[0.0, 1.0], ids=["noclip", "clip"])
def jax_ckpt(request, tmp_path_factory):
    return _jax_ckpt(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def jax_ckpt_noclip(tmp_path_factory):
    return _jax_ckpt(0.0, tmp_path_factory)


def _per_param(jt, flat_vec):
    """A raveled vector of the JAX trainer as {flax key: array}, through
    jax's own unravel."""
    _, unravel = ravel_pytree(jt.params)
    return _jflat(unravel(jnp.asarray(flat_vec))["params"])


def _port_views(tr, vec):
    out, ofs = {}, 0
    for name, p in tr.model.named_parameters():
        out[name.replace(".", "/")] = vec[ofs : ofs + p.numel()].reshape(p.shape).numpy()
        ofs += p.numel()
    return out


def test_trainer_resumes_a_jax_checkpoint(jax_ckpt):
    jt = jax_ckpt["jt"]
    tm = t_cli.build_model(t_load_config(None, overrides=TRAIN_BASE))
    tt = t_trainer.Trainer(tm, train_dir=str(jax_ckpt["root"] / "port"), device="cpu",
                           **jax_ckpt["kw"])
    tt.load_checkpoint(str(jax_ckpt["root"] / "train" / "best"))
    assert tt.sched.lr == 7e-4
    want = _jflat(jt.params["params"])
    got = _port_views(tt, tt.flat.detach())
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    ams = jt.opt_state[-1][0]
    assert int(tt.opt.count) == int(ams.count) == 1
    for key in ("mu", "nu", "nu_max"):
        want_k = _per_param(jt, getattr(ams, key))
        got_k = _port_views(tt, getattr(tt.opt, key))
        for k in want_k:
            np.testing.assert_array_equal(got_k[k], want_k[k], err_msg=f"{key} {k}")

    # one gradient through both optimizers from the restored state
    pflat, _ = ravel_pytree(jt.params)
    g = np.random.default_rng(0).normal(size=pflat.shape).astype(np.float32)
    upd, _ = jax.jit(jt.tx.update)(jnp.asarray(g), jt.opt_state, pflat)
    g_port = torch.cat([torch.as_tensor(v).reshape(-1) for v in
                        (_per_param(jt, g)[n.replace(".", "/")]
                         for n, _ in tt.model.named_parameters())])
    t_upd, _ = tt.opt.update(g_port)
    got_u, want_u = _port_views(tt, t_upd), _per_param(jt, upd)
    for k in want_u:
        np.testing.assert_allclose(got_u[k], want_u[k], rtol=1e-6, atol=0, err_msg=k)

    # the next two steps
    j_losses = [jt.train_epoch([jax_ckpt["jb"][i]]) for i in (1, 0)]
    t_losses = [float(tt.train_step(jax_ckpt["tb"][i])[0]) for i in (1, 0)]
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4, atol=0)
    assert int(tt.opt.count) == 3


def test_orbax_entries_raise_without_tensorstore(jax_ckpt_noclip, monkeypatch):
    jax_ckpt = jax_ckpt_noclip
    best = str(jax_ckpt["root"] / "train" / "best")
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    tm = t_cli.build_model(t_load_config(None, overrides=TRAIN_BASE))
    tt = t_trainer.Trainer(tm, train_dir=str(jax_ckpt["root"] / "nots"), device="cpu",
                           **jax_ckpt["kw"])
    for call in (lambda: orbax_reader.read_orbax(best),
                 lambda: t_cli.load_weights(tm, best),
                 lambda: tt.load_checkpoint(best),
                 lambda: orbax_reader.checkpoint_params(best)):
        with pytest.raises(ImportError, match="tensorstore") as err:
            call()
        assert ".npz" in str(err.value)
    with pytest.raises(FileNotFoundError):
        orbax_reader.read_orbax(str(jax_ckpt["root"]))


def test_cli_stage_test_from_a_jax_best_directory(jax_ckpt_noclip, tmp_path):
    """``stage: test`` with ``checkpoint_path: <train_dir>/best`` (the JAX
    trainer's orbax directory) through both CLIs: the same prediction files."""
    jax_ckpt = jax_ckpt_noclip
    save_graph_npz(str(tmp_path / "graph_data.npz"), jax_ckpt["crystals"])
    cfg = _merge(TRAIN_BASE, {
        "setup": {"stage": "test", "checkpoint_path": str(jax_ckpt["root"] / "train" / "best")},
        "dataset_params": {"graph_data_path": str(tmp_path), "batch_size": 2},
        "optim_params": {"gradient_clip_val": jax_ckpt["clip"]}})
    j_cli.main(["--config", _write(tmp_path / "jax.yaml", _merge(cfg, {
        "profiler_params": {"train_dir": str(tmp_path / "jax")}}))])
    t_cli.main(["--config", _write(tmp_path / "port.yaml", _merge(cfg, {
        "profiler_params": {"train_dir": str(tmp_path / "port")}})), "--device", "cpu"])
    for name in ("prediction_hamiltonian", "target_hamiltonian"):
        got = np.load(tmp_path / "port" / f"{name}.npy")
        want = np.load(tmp_path / "jax" / f"{name}.npy")
        assert got.shape == want.shape and np.isfinite(got).all(), name
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)
