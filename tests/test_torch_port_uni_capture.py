"""The Uni-HamGNN predictor's stages as the port captures them
(``tools/uni_hamgnn.py`` on ``train/captured.py``), held against the JAX
tool's jitted stages (``hamgnn_tpu/tools/uni_hamgnn.py``).

On the CPU the stages run eagerly; what a replay does is checked through its
data path:

* the static-buffer path: crystal B copied into the static buffers made
  from crystal A of the same bucket (``static_copy`` / ``copy_inputs``, as
  a replay fills them), then the stage body run on those buffers, equals
  the JAX predictor's ``predict_nonsoc`` / ``predict_soc`` on B, for the
  native models and for the reference-parametrization (compat) models
  (atol 5e-5 / rtol 1e-4, ``tests/test_torch_parity.py``'s limits);
* after a first run, neither stage body builds a tensor from host data,
  reads the device or copies to the CPU (what a CUDA graph cannot record),
  the compat one-hot and the ``add_H_nonsoc`` branch included;
* the keys: over a seeded test set, the capture keys of each stage are the
  bucket shapes JAX's ``GraphDataModule(test_mode=True)`` yields, one
  program a bucket and stage on both sides;
* the errors: the CPU runs eagerly by default, and ``capture=True`` there
  raises.

Marked ``cuda`` (skipped where no GPU is present; they import no JAX, so
``python -m pytest --noconftest tests/test_torch_port_uni_capture.py -m cuda``
runs them on the card): both native stages and the compat stage replayed
against the eager predictor, bit for bit under deterministic algorithms;
predictions over two buckets, all kept and read at the end, the same (each
is fresh tensors, not a graph's buffers).
"""

import weakref

import numpy as np
import pytest
import torch
import yaml

from hamgnn_tpu_torch.data import synthetic
from hamgnn_tpu_torch.data.dataset import GraphDataModule as TDataModule
from hamgnn_tpu_torch.interfaces.jax_params import load_flax_params
from hamgnn_tpu_torch.models.model import init_weights
from hamgnn_tpu_torch.tools import uni_hamgnn as t_uni
from hamgnn_tpu_torch.train import captured

TOL = dict(atol=5e-5, rtol=1e-4)
PRE = {"irreps_node_features": "4x0e+2x0o+2x1o+2x1e+2x2e", "irreps_edge_sh": "0e+1o+2e",
       "num_layers": 1, "num_radial": 8, "cutoff": 4.0, "radial_MLP": [8], "num_types": 20}
HAM_KEYS = ("hamiltonian_on", "hamiltonian_off")
SOC_KEYS = ("hamiltonian_real_on", "hamiltonian_real_off", "hamiltonian_imag_on",
            "hamiltonian_imag_off")
NAO = 14


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(soc):
    return {"setup": {"GNN_Net": "HamGNNpre"},
            "representation_nets": {"HamGNN_pre": dict(PRE)},
            "output_nets": {"HamGNN_out": {
                "nao_max": NAO, "ham_type": "openmx", "soc_switch": soc, "soc_basis": "so3",
                "add_H0": False, "zero_point_shift": False}}}


def _write(path, cfg):
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def _crystals(seed, n, n_atoms=3, cutoff=4.0):
    """``n`` seeded (non-SOC, SOC) crystal pairs of one structure each."""
    rng = np.random.default_rng(seed)
    plain, spinor = [], []
    for i in range(n):
        c = synthetic.add_random_hamiltonian_targets(
            rng, synthetic.make_crystal(rng, n_atoms=n_atoms if np.isscalar(n_atoms)
                                        else n_atoms[i], cutoff=cutoff), nao_max=NAO)
        plain.append(c)
        spinor.append(synthetic.add_random_soc_targets(rng, dict(c)))
    return plain, spinor


def _port_predictor(tmp_path, compat, **kw):
    return t_uni.HamiltonianPredictor(_write(tmp_path / "nonsoc.yaml", _cfg(False)),
                                      _write(tmp_path / "soc.yaml", _cfg(True)),
                                      soc_switch=True, compat=compat, **kw)


# ---------------------------------------------------------------------------
# against the JAX tool
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[False, True], ids=["native", "compat"])
def pair(request, tmp_path_factory):
    """The JAX predictor (seeded init) and the port's predictor holding its
    parameters, on the CPU, with two crystals A and B of one bucket
    (non-SOC and SOC sets), batched by each package's
    ``GraphDataModule(test_mode=True)``."""
    from flax.traverse_util import flatten_dict

    from hamgnn_tpu.data.dataset import GraphDataModule as JDataModule
    from hamgnn_tpu.tools import uni_hamgnn as j_uni
    from hamgnn_tpu.train import trainer as j_trainer

    compat = request.param
    root = tmp_path_factory.mktemp("compat" if compat else "native")
    jp = j_uni.HamiltonianPredictor(_write(root / "nonsoc.yaml", _cfg(False)),
                                    _write(root / "soc.yaml", _cfg(True)), soc_switch=True,
                                    compat=compat)
    plain, spinor = _crystals(4, 2)
    jb = {name: list(JDataModule(s, batch_size=1, test_mode=True).test_batches())
          for name, s in (("nonsoc", plain), ("soc", spinor))}
    tb = {name: list(TDataModule(s, batch_size=1, test_mode=True, device="cpu").test_batches())
          for name, s in (("nonsoc", plain), ("soc", spinor))}
    zeros = (np.zeros((jb["soc"][0].num_nodes, NAO * NAO), np.float32),
             np.zeros((jb["soc"][0].num_edges, NAO * NAO), np.float32))
    jp.params_nonsoc = j_trainer.init_params_on_cpu(jp.model_nonsoc, jb["nonsoc"][0], 0)
    jp.params_soc = j_trainer.init_params_on_cpu(
        jp.model_soc, jb["soc"][0], 1,
        method=lambda m, g: m.output(g, m.representation(g), h_nonsoc=zeros))
    tp = _port_predictor(root, compat, device="cpu")

    def flat(params):
        return {"/".join(k): np.asarray(v) for k, v in flatten_dict(params).items()}

    load_flax_params(tp.model_nonsoc, flat(jp.params_nonsoc))
    load_flax_params(tp.model_soc, flat(jp.params_soc))
    return {"jax": jp, "port": tp, "jb": jb, "tb": tb, "compat": compat}


def _assert_outputs(got, want, keys):
    for k in keys:
        w = np.asarray(want[k])
        g = got[k].detach().numpy()
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, err_msg=k, **TOL)


def test_static_buffer_path_of_the_non_soc_stage_matches_jax(pair):
    """Crystal B through static buffers made from crystal A, then the
    non-SOC stage body: JAX's ``predict_nonsoc`` on B."""
    a, b = pair["tb"]["nonsoc"]
    assert captured.shape_key(a) == captured.shape_key(b)
    static = captured.static_copy(a)
    captured.copy_inputs(static, b)
    assert not torch.equal(static.pos, a.pos) and torch.equal(static.pos, b.pos)
    with torch.no_grad():
        got = pair["port"].nonsoc_stage(static)
    want = pair["jax"].predict_nonsoc(pair["jb"]["nonsoc"][1])
    _assert_outputs(got, want, HAM_KEYS + ("mask_on", "mask_off"))
    assert np.abs(np.asarray(want["hamiltonian_on"])).max() > 0


def test_static_buffer_path_of_the_soc_stage_matches_jax(pair):
    """Crystal B and its upstream rows through the SOC stage's static buffers
    and inputs made from crystal A's, then the SOC stage body (the
    ``add_H_nonsoc`` branch): JAX's ``predict_soc`` on B with the same
    upstream rows."""
    jp, jb = pair["jax"], pair["jb"]
    ups = [jp.predict_nonsoc(g) for g in jb["nonsoc"]]
    h = [{"h_nonsoc_on": torch.as_tensor(np.asarray(u["hamiltonian_on"])),
          "h_nonsoc_off": torch.as_tensor(np.asarray(u["hamiltonian_off"]))} for u in ups]
    a, b = pair["tb"]["soc"]
    assert captured.step_key(a, h[0]) == captured.step_key(b, h[1]) == captured.shape_key(a)
    static = captured.static_copy({"batch": a, **h[0]})
    captured.copy_inputs(static, {"batch": b, **h[1]})
    assert torch.equal(static["h_nonsoc_on"], h[1]["h_nonsoc_on"])
    with torch.no_grad():
        got = pair["port"].soc_stage(static["batch"], static["h_nonsoc_on"],
                                     static["h_nonsoc_off"])
    want = jp.predict_soc(jb["soc"][1], ups[1]["hamiltonian_on"], ups[1]["hamiltonian_off"])
    _assert_outputs(got, want, SOC_KEYS + ("mask_on", "mask_off"))


@pytest.mark.parametrize("stage", ["nonsoc", "soc"])
def test_stage_bodies_take_nothing_from_the_host_after_a_first_run(pair, monkeypatch, stage):
    """After a first run (a capture's warm-up), a stage body builds no tensor
    from host data, reads no device value and copies nothing to the CPU:
    what a CUDA graph can record (the compat one-hot and the
    ``add_H_nonsoc`` branch included).  Run under ``no_grad``: under
    ``inference_mode`` a dispatch mode sees a composite op (``one_hot``,
    ``item``) whole and misses the reads inside it."""
    from test_torch_port_train import band_step_traffic

    tp, tb = pair["port"], pair["tb"]
    g, g_soc = tb["nonsoc"][0], tb["soc"][0]
    with torch.no_grad():
        up = tp.nonsoc_stage(g)

    def steps():
        with torch.no_grad():
            if stage == "nonsoc":
                tp.nonsoc_stage(g)
            else:
                tp.soc_stage(g_soc, up["hamiltonian_on"], up["hamiltonian_off"])

    assert band_step_traffic(monkeypatch, steps) == []


def test_capture_keys_are_the_jax_buckets(tmp_path):
    """Over a seeded test set of crystals of 3 to 24 atoms, each stage's
    capture keys (``step_key`` of its batch and inputs, as ``CapturedSteps``
    takes them) are the bucket shapes (nodes, edges, graphs) of JAX's
    ``GraphDataModule(test_mode=True)``: one captured program a bucket and
    stage, as JAX compiles one a bucket."""
    from hamgnn_tpu.data.dataset import GraphDataModule as JDataModule

    plain, spinor = _crystals(11, 12, n_atoms=[3, 4, 18, 4, 20, 3, 5, 17, 3, 6, 24, 4])
    for name, crystals in (("nonsoc", plain), ("soc", spinor)):
        jax_keys = {(g.num_nodes, g.num_edges, g.num_graphs)
                    for g in JDataModule(crystals, batch_size=1, test_mode=True).test_batches()}
        keys = set()
        for g in TDataModule(crystals, batch_size=1, test_mode=True,
                             device="cpu").test_batches():
            inputs = {} if name == "nonsoc" else {
                "h_nonsoc_on": torch.zeros(g.num_nodes, NAO * NAO),
                "h_nonsoc_off": torch.zeros(g.num_edges, NAO * NAO)}
            keys.add(captured.step_key(g, inputs))
        assert keys == jax_keys, name
        assert 1 < len(keys) < len(crystals), name


def test_cpu_predictor_runs_eagerly_and_capture_true_raises(tmp_path):
    pred = _port_predictor(tmp_path, False, device="cpu")
    assert pred.captured_nonsoc is None and pred.captured_soc is None
    with pytest.raises(ValueError, match="needs the card"):
        _port_predictor(tmp_path, False, device="cpu", capture=True)
    with pytest.raises(ValueError, match="needs the card"):
        _port_predictor(tmp_path, True, device="cpu", capture=True)
    pred.save(str(tmp_path / "pkg"))
    assert t_uni.HamiltonianPredictor.load(str(tmp_path / "pkg"), device="cpu",
                                           capture=False).captured_soc is None
    with pytest.raises(ValueError, match="needs the card"):
        t_uni.HamiltonianPredictor.load(str(tmp_path / "pkg"), device="cpu", capture=True)
    with pytest.raises(ValueError, match="runs on the card"):
        captured.CapturedSteps("cpu", None, pred.nonsoc_stage)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card_pair(tmp_path, compat, crystals=None):
    """A captured and an eager predictor of one seeded package on the card,
    and seeded crystals (by default three of one bucket; two data sets),
    batched there."""
    pred = _port_predictor(tmp_path, compat, device="cuda", capture=False)
    init_weights(pred.model_nonsoc, 0)
    init_weights(pred.model_soc, 1)
    pred.save(str(tmp_path / "pkg"))
    cap = t_uni.HamiltonianPredictor.load(str(tmp_path / "pkg"), device="cuda")
    eager = t_uni.HamiltonianPredictor.load(str(tmp_path / "pkg"), device="cuda", capture=False)
    plain, spinor = _crystals(4, 3) if crystals is None else crystals
    data = [list(TDataModule(s, batch_size=1, test_mode=True, device="cuda").test_batches())
            for s in (plain, spinor)]
    if crystals is None:
        assert len({captured.shape_key(g) for g in data[0]}) == 1
    return cap, eager, data


@pytest.mark.cuda
@pytest.mark.parametrize("compat", [False, True], ids=["native", "compat"])
def test_cuda_captured_stages_match_eager(tmp_path, compat):
    """Both stages replayed from their graphs (one key, three crystals: the
    second and third through the static buffers) against the eager
    predictor, bit for bit under deterministic algorithms; one graph a
    stage."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.use_deterministic_algorithms(True)
    try:
        cap, eager, (plain, spinor) = _card_pair(tmp_path, compat)
        assert cap.captured_nonsoc is not None and eager.captured_nonsoc is None
        for g, g_soc in zip(plain, spinor):
            c1, e1 = cap.predict_nonsoc(g), eager.predict_nonsoc(g)
            for k in HAM_KEYS:
                assert torch.equal(c1[k], e1[k]), k
            c2 = cap.predict_soc(g_soc, c1["hamiltonian_on"], c1["hamiltonian_off"])
            e2 = eager.predict_soc(g_soc, e1["hamiltonian_on"], e1["hamiltonian_off"])
            for k in SOC_KEYS:
                assert torch.equal(c2[k], e2[k]), k
        assert len(cap.captured_nonsoc.eval_graphs) == len(cap.captured_soc.eval_graphs) == 1
        assert cap.captured_nonsoc.captures == cap.captured_soc.captures == 1
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.cuda
def test_cuda_captured_predictions_are_fresh_tensors(tmp_path):
    """Every prediction of both stages over crystals of two buckets, all
    kept and read only at the end, equals the eager predictor's: a
    prediction is no view of a graph buffer that a later replay (of the
    other stage or key, in the pool they share) overwrites.  A dropped
    captured predictor is freed without a garbage collection."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.use_deterministic_algorithms(True)
    try:
        cap, eager, (plain, spinor) = _card_pair(
            tmp_path, False, _crystals(5, 4, n_atoms=[3, 18, 3, 18]))
        assert len({captured.shape_key(g) for g in plain}) == 2
        kept, want = [], []
        for g, g_soc in zip(plain, spinor):
            c1, e1 = cap.predict_nonsoc(g), eager.predict_nonsoc(g)
            kept.append((c1, cap.predict_soc(g_soc, c1["hamiltonian_on"],
                                              c1["hamiltonian_off"])))
            want.append((e1, eager.predict_soc(g_soc, e1["hamiltonian_on"],
                                               e1["hamiltonian_off"])))
        for (c1, c2), (e1, e2) in zip(kept, want):
            for k in HAM_KEYS:
                assert torch.equal(c1[k], e1[k]), k
            for k in SOC_KEYS:
                assert torch.equal(c2[k], e2[k]), k
        gone = weakref.ref(cap)
        del cap
        assert gone() is None
    finally:
        torch.use_deterministic_algorithms(False)
