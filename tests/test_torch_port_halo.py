"""The port's halo edge partition against the JAX package's one-device step.

One spawn of four gloo processes (``torch.distributed`` on the CPU) computes
every case and writes one JSON; the tests read it through a module fixture.
The workers import torch and the port, never JAX (they say so in the JSON);
the JAX references are computed in this process while they run.

Cases (the tiny model of tests/test_halo_fast.py): the plain head with H0,
symmetrisation, the zero-point shift and the overlap heads under two ConvE3
layers, split 2 ways on a 2 x 2 mesh (both data rows hold the crystal, so the
data-parallel reduction runs too), 4 ways on a 1 x 4 mesh, 2 ways with
gradient checkpointing and 2 ways under the zonal engine (float32 only); the
Transformer under the band loss (4 ways, one
crystal a step); the SOC head, su2 under ConvE3 with the correlation block and
charge doping, and so3.
For each: the halo loss and every parameter's gradient in float32 against the
JAX step (loss atol 5e-5 / rtol 1e-4; gradients max|d| <= 5e-4 * max|ref|
per tensor, PERF.md section 2), and the halo step in float64 against the
port's own one-device float64 step (1e-10 relative).  Then a HaloTrainer
epoch whose eval equals the one-device eval, the CLI under ``mode: halo`` and
``mode: dp`` (its best.pt tested under ``mode: none``), and, without the
workers, the interior pass of the overlap split against NaN halo rows.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
FEAT = "4x0e+2x0o+2x1o+1x1e+1x2e"
TFEAT = "4x0e+2x0o+2x1o+2x1e+2x2e"
SH = "0e + 1o + 2e"
WORLD = 4
LOSS_TOL = dict(atol=5e-5, rtol=1e-4)
GRAD_TOL = 5e-4
# a loss with a band term: the limit of the fp32 eigensolvers (PERF.md
# section 2, tests/test_torch_port_band.py::test_band_model_gradients)
GRAD_TOL_BAND = 2e-2
F64_TOL = 1e-10
# rounding relative to a loss's largest gradient, float32 and float64: a
# gradient below it is zero in exact arithmetic (a pseudo-scalar channel of
# the correlation block, say) and holds rounding alone on both sides
NOISE32, NOISE64 = 1e-6, 1e-13

REP = dict(num_types=20, irreps_edge_sh=SH, irreps_node_features=FEAT, num_layers=2,
           num_radial=6, rbf_func="bessel", cutoff=4.0, radial_mlp=(8,))
HEAD = dict(irreps_in_node=FEAT, irreps_in_edge=FEAT, nao_max=14, ham_type="openmx")
HAM = [{"metric": "mae", "prediction": "hamiltonian", "target": "hamiltonian",
        "loss_weight": 27.211}]
SOC_LOSSES = [{"metric": "mae", "prediction": p, "target": p, "loss_weight": 27.211}
              for p in ("hamiltonian_real", "hamiltonian_imag")]
REP1 = dict(REP, num_layers=1)
PLAIN = dict(rep=("conv", REP), out=("plain", dict(
    HEAD, ham_only=False, symmetrize=True, add_H0=True, zero_point_shift=True)),
    losses=HAM + [{"metric": "mse", "prediction": "overlap", "target": "overlap",
                   "loss_weight": 3.0}], crystal="8", shards=2, seed=0)
CASES = {
    "plain_overlap": PLAIN,
    "plain_overlap_4shards": dict(PLAIN, shards=4),
    "plain_overlap_checkpointed": dict(
        PLAIN, rep=("conv", dict(REP, use_gradient_checkpointing=True))),
    # the edge-frame engine (its plain version here): the interior and boundary
    # passes run on two edge sets, whose frames the memo must not mix up
    "plain_overlap_zonal": dict(PLAIN, engine="zonal"),
    "transformer_band": dict(
        rep=("transformer", dict(REP1, irreps_node_features=TFEAT, num_heads=2,
                                 num_hidden_features=4, correlation=2)),
        out=("plain", dict(HEAD, irreps_in_node=TFEAT, irreps_in_edge=TFEAT, ham_only=True,
                           symmetrize=True, add_H0=True, zero_point_shift=False,
                           calculate_band_energy=True, num_k=2, band_num_control=2)),
        losses=HAM + [{"metric": "mae", "prediction": "band_energy",
                       "target": "band_energy", "loss_weight": 0.01}],
        crystal="8", shards=4, seed=2),
    "soc_su2_corr_doping": dict(
        rep=("conv", dict(REP1, use_corr_prod=True, num_hidden_features=4, correlation=2,
                          apply_charge_doping=True)),
        out=("soc", dict(HEAD, soc_basis="su2", add_H0=True, symmetrize=True,
                         zero_point_shift=True)),
        losses=SOC_LOSSES, crystal="4_soc_doped", shards=2, seed=3),
    "soc_so3": dict(rep=("conv", REP1), out=("soc", dict(
        HEAD, soc_basis="so3", add_H0=True, symmetrize=True, zero_point_shift=True)),
        losses=SOC_LOSSES, crystal="4_soc", shards=2, seed=4),
}
# JAX compiles one program per model and graph (tens of seconds here): the
# features share models, and cases that differ only in the split or in
# checkpointing share their reference
JAX_REF = {"plain_overlap_4shards": "plain_overlap",
           "plain_overlap_checkpointed": "plain_overlap",
           "plain_overlap_zonal": "plain_overlap"}
BAND_CASES = {"transformer_band"}


# --- the crystals and the port's models (both sides) -------------------------

def case_crystals(kind):
    from hamgnn_tpu_torch.data.synthetic import (add_random_hamiltonian_targets,
                                                 add_random_soc_targets, make_crystal)

    rng = np.random.default_rng({"8": 10, "4_soc_doped": 12, "4_soc": 13}[kind])
    n = 8 if kind == "8" else 4
    c = add_random_hamiltonian_targets(
        rng, make_crystal(rng, n_atoms=n, species=(6, 14), cell_size=5.0, cutoff=4.0),
        nao_max=14)
    if kind.startswith("4_soc"):
        c = add_random_soc_targets(rng, c)
    if kind.endswith("doped"):
        c["doping_charge"] = np.array([0.7])
    return [c]


def case_k(case):
    """The band case's k-points, (1, 2, 3) Cartesian."""
    from hamgnn_tpu_torch.physics.kpoints import random_k_cartesian

    cell = np.asarray(case_crystals(case["crystal"])[0]["cell"], np.float64).reshape(3, 3)
    return np.asarray(random_k_cartesian(np.random.default_rng(5), 2, cell), np.float32)[None]


def port_model(case):
    from hamgnn_tpu_torch.models.model import HamGNNModel, init_weights
    from hamgnn_tpu_torch.models.output import HamGNNPlusPlusOut
    from hamgnn_tpu_torch.models.representation import HamGNNConvE3, HamGNNTransformer
    from hamgnn_tpu_torch.models.soc import HamGNNSOCOut

    rep_cls = {"conv": HamGNNConvE3, "transformer": HamGNNTransformer}[case["rep"][0]]
    out_cls = {"plain": HamGNNPlusPlusOut, "soc": HamGNNSOCOut}[case["out"][0]]
    return init_weights(HamGNNModel(rep_cls(**case["rep"][1]), out_cls(**case["out"][1])),
                        case["seed"])


def graph_as(graph, dtype):
    return dataclasses.replace(graph, **{
        f.name: getattr(graph, f.name).to(dtype) for f in dataclasses.fields(graph)
        if getattr(graph, f.name) is not None and getattr(graph, f.name).is_floating_point()})


def pad(crystals):
    from hamgnn_tpu_torch.data.graph import pad_and_batch

    return pad_and_batch(crystals, node_bucket=8, edge_bucket=256)


# --- the workers -----------------------------------------------------------

def _grads(model):
    return [torch.zeros_like(p) if p.grad is None else p.grad for p in model.parameters()]


def _run_case(case, mesh):
    band = case["out"][1].get("calculate_band_energy", False)
    out = {}
    if "engine" in case:  # float32 only: the zonal tables are float32
        os.environ["HAMGNN_TP_ENGINE"] = case["engine"]
        try:
            _halo_steps(case, mesh, band, ((torch.float32, "halo32"),), out)
        finally:
            os.environ.pop("HAMGNN_TP_ENGINE")
        return out
    _halo_steps(case, mesh, band, ((torch.float32, "halo32"), (torch.float64, "halo64")), out)
    _dense64(case, band, out)
    return out


def _halo_steps(case, mesh, band, dtypes, out):
    from hamgnn_tpu_torch.parallel.halo_model import (build_halo_inputs, edge_unperm_for_plan,
                                                      local_inputs, make_halo_loss_fn,
                                                      plan_for_graph)
    from hamgnn_tpu_torch.parallel.sharding import reduce_gradient

    for dtype, tag in dtypes:
        model = port_model(case).to(dtype)
        g = graph_as(pad(case_crystals(case["crystal"])), dtype)
        plan = plan_for_graph(g, mesh.n_graph)
        inp = {k: (v.astype(np.float64) if dtype == torch.float64 and v.dtype.kind == "f"
                   else v) for k, v in build_halo_inputs(g, plan).items()}
        loc = local_inputs(inp, mesh.n_graph, mesh.graph_rank, "cpu")
        extra = ()
        if band:
            extra = (g, torch.as_tensor(case_k(case), dtype=dtype),
                     torch.as_tensor(edge_unperm_for_plan(plan, g.num_edges)))
        total, logs, _ = make_halo_loss_fn(model, mesh, case["losses"], with_band=band)(
            loc, *extra)
        (total / mesh.n_graph).backward()
        flat = torch.cat([t.reshape(-1) for t in _grads(model)])
        reduce_gradient(mesh, flat)
        names = [n for n, _ in model.named_parameters()]
        parts = flat.split([p.numel() for p in model.parameters()])
        out[tag] = {"loss": float(total), "logs": {k: float(v) for k, v in logs.items()},
                    "grads": {n: t.tolist() for n, t in zip(names, parts)}}


def _dense64(case, band, out):
    """Every rank's reduced float64 gradient is rank 0's; rank 0 adds the
    one-device float64 step."""
    import torch.distributed as dist

    from hamgnn_tpu_torch.models.model import compute_losses

    # every rank of the world holds the same reduced gradient
    check = torch.tensor([sum(abs(v) for g in out["halo64"]["grads"].values() for v in g)],
                         dtype=torch.float64)
    ref = check.clone()
    dist.broadcast(ref, 0)
    out["same_on_every_rank"] = bool(torch.equal(check, ref))
    if dist.get_rank() == 0:
        model = port_model(case).double()
        g = graph_as(pad(case_crystals(case["crystal"])), torch.float64)
        kw = {"k_vecs": torch.as_tensor(case_k(case), dtype=torch.float64)} if band else {}
        total, _ = compute_losses(model(g, **kw), g, case["losses"])
        total.backward()
        out["dense64"] = {"loss": float(total), "grads": {
            n: t.reshape(-1).tolist() for (n, _), t in zip(model.named_parameters(),
                                                           _grads(model))}}


HAM_ONLY = dict(PLAIN, out=("plain", dict(PLAIN["out"][1], ham_only=True)), losses=HAM)


def _trainer_dataset():
    from hamgnn_tpu_torch.data.synthetic import add_random_hamiltonian_targets, make_crystal

    rng = np.random.default_rng(20)
    return [add_random_hamiltonian_targets(
        rng, make_crystal(rng, n_atoms=3 + i % 2, species=(6, 14), cell_size=5.0,
                          cutoff=4.0), nao_max=14) for i in range(6)]


TRAINER_KW = dict(losses=HAM, metrics=[{"metric": m, "prediction": "hamiltonian",
                                        "target": "hamiltonian"} for m in ("mae", "rmse")],
                  lr=0.005, device="cpu")


def _trainer_epoch(work):
    """One halo epoch on a 2 x 2 mesh, then the halo eval of the validation
    crystals; rank 0 evaluates them on one device with the same parameters."""
    import torch.distributed as dist

    from hamgnn_tpu_torch.data.dataset import GraphDataModule
    from hamgnn_tpu_torch.parallel.halo_trainer import HaloDataAdapter, HaloTrainer
    from hamgnn_tpu_torch.train.trainer import Trainer

    dm = GraphDataModule(_trainer_dataset(), batch_size=1, train_ratio=0.34,
                         val_ratio=0.33, test_ratio=0.33)
    trainer = HaloTrainer(port_model(HAM_ONLY), n_data=2, n_graph=2,
                          train_dir=os.path.join(work, "trainer"), **TRAINER_KW)
    data = HaloDataAdapter(dm, n_data=2, n_graph=2)
    train_loss = trainer.train_epoch(data.train_batches(np.random.default_rng(0)))
    loss, logs = trainer.eval_epoch(data.val_batches())
    total = trainer.flat.double().sum().reshape(1)
    ref = total.clone()
    dist.broadcast(ref, 0)
    out = {"train_loss": train_loss, "halo": [loss, logs],
           "params_same_on_every_rank": bool(torch.equal(total, ref)),
           "steps": int(trainer.opt.count)}
    if dist.get_rank() == 0:
        one = Trainer(port_model(HAM_ONLY), train_dir=os.path.join(work, "one"), **TRAINER_KW)
        one.flat.copy_(trainer.flat)
        out["one_device"] = list(one.eval_epoch(dm.val_batches()))
    return out


def cli_config(work, mode, stage="fit", **setup):
    return {
        "setup": {"stage": stage, **({"parallel": {
            "mode": mode, "edge_quantum": 32, "n_data": 2 if mode == "halo" else 0}}
            if mode != "none" else {}), **setup},
        "dataset_params": {"graph_data_path": os.path.join(work, "graph_data.npz"),
                           "batch_size": 1, "train_ratio": 0.34, "val_ratio": 0.33,
                           "test_ratio": 0.33},
        "optim_params": {"min_epochs": 0, "max_epochs": 1},
        "profiler_params": {"train_dir": os.path.join(work, f"{mode}_{stage}")},
        "representation_nets": {"HamGNN_pre": {
            "irreps_node_features": FEAT, "irreps_edge_sh": SH, "num_layers": 1,
            "num_radial": 6, "cutoff": 4.0, "radial_MLP": [8], "num_types": 20}},
        "output_nets": {"HamGNN_out": {"nao_max": 14}},
    }


def _cli(work):
    import torch.distributed as dist

    from hamgnn_tpu_torch import cli
    from hamgnn_tpu_torch.data.dataset import save_graph_npz
    from hamgnn_tpu_torch.train.config import load_config

    if dist.get_rank() == 0:
        save_graph_npz(os.path.join(work, "graph_data.npz"), _trainer_dataset())
    dist.barrier()
    return {mode: cli.train_and_evaluate(load_config(None, overrides=cli_config(work, mode)),
                                         device="cpu")
            for mode in ("halo", "dp")}


def _worker(rank, world, port, work):
    import torch.distributed as dist

    from hamgnn_tpu_torch.parallel.sharding import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    meshes = {2: make_mesh(2, 2), 4: make_mesh(1, 4)}
    res = {name: _run_case(case, meshes[case["shards"]]) for name, case in CASES.items()}
    res["trainer"] = _trainer_epoch(work)
    res["cli"] = _cli(work)
    res["jax_imported"] = any(m == "jax" or m.startswith(("jax.", "hamgnn_tpu."))
                              for m in sys.modules)
    flags = [None] * world
    dist.all_gather_object(flags, res["jax_imported"])
    res["jax_imported"] = any(flags)
    if rank == 0:
        with open(os.path.join(work, "halo.json"), "w") as f:
            json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


# --- the JAX references (this process) and the fixtures -----------------------

def _jax_ref(case):
    import jax
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict, unflatten_dict

    from hamgnn_tpu.data.graph import pad_and_batch as j_pad
    from hamgnn_tpu.models.model import HamGNNModel, compute_losses
    from hamgnn_tpu.models.output import HamGNNPlusPlusOut
    from hamgnn_tpu.models.representation import HamGNNConvE3, HamGNNTransformer
    from hamgnn_tpu.models.soc import HamGNNSOCOut

    rep_kw = {k: v for k, v in case["rep"][1].items() if k != "use_gradient_checkpointing"}
    rep = {"conv": HamGNNConvE3, "transformer": HamGNNTransformer}[case["rep"][0]](**rep_kw)
    out = {"plain": HamGNNPlusPlusOut, "soc": HamGNNSOCOut}[case["out"][0]](**case["out"][1])
    model = HamGNNModel(representation=rep, output=out)
    params = {"params": unflatten_dict({
        tuple(n.split(".")): jnp.asarray(p.detach().numpy())
        for n, p in port_model(case).named_parameters()})}
    graph = j_pad(case_crystals(case["crystal"]), node_bucket=8, edge_bucket=256)
    kw = ({"k_vecs": jnp.asarray(case_k(case))}
          if case["out"][1].get("calculate_band_energy") else {})

    def loss(p):
        return compute_losses(model.apply(p, graph, **kw), graph, case["losses"])[0]

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return float(value), {"/".join(k).replace("/", "."): np.asarray(v)
                          for k, v in flatten_dict(grads["params"]).items()}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    work = tmp_path_factory.mktemp("halo")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, TESTS, os.environ.get("PYTHONPATH", "")]))
    env.pop("HAMGNN_TP_ENGINE", None)
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), str(work)], cwd=REPO,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    yield proc, work
    if proc.poll() is None:
        proc.kill()


@pytest.fixture(scope="module")
def jax_refs(spawned):
    """The JAX steps, compiled without most of XLA's optimizations (a fifth
    less compile time; the tolerances hold the same)."""
    import jax

    prev = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        return {name: _jax_ref(case) for name, case in CASES.items() if name not in JAX_REF}
    finally:
        jax.config.update("jax_disable_most_optimizations", prev)


@pytest.fixture(scope="module")
def results(spawned, jax_refs):
    proc, work = spawned
    log, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, log.decode(errors="replace")[-4000:]
    with open(os.path.join(work, "halo.json")) as f:
        return json.load(f)


def _shapes(case):
    return {n: tuple(p.shape) for n, p in port_model(case).named_parameters()}


def assert_grads_close(got: dict, ref: dict, tol: float, noise: float):
    """Per tensor: max|got - ref| <= tol * max|ref|; where max|ref| is below
    ``noise`` times the largest reference gradient, both sides stay below
    that floor (the rule of tests/test_torch_port_representation.py)."""
    assert set(got) == set(ref)
    floor = noise * max(float(np.abs(v).max(initial=0.0)) for v in ref.values())
    for n in sorted(ref):
        a, b = np.asarray(got[n], np.float64), np.asarray(ref[n], np.float64)
        assert a.shape == b.shape and np.isfinite(a).all(), n
        scale = np.abs(b).max(initial=0.0)
        if scale < floor:
            assert np.abs(a).max(initial=0.0) < floor, (n, float(np.abs(a).max()), floor)
            continue
        assert np.abs(a - b).max() <= tol * scale, (n, float(np.abs(a - b).max()),
                                                     float(scale))


def test_workers_import_no_jax(results):
    assert results["jax_imported"] is False


@pytest.mark.parametrize("name", sorted(CASES))
def test_halo_step_matches_jax(results, jax_refs, name):
    got = results[name]["halo32"]
    ref_loss, ref_grads = jax_refs[JAX_REF.get(name, name)]
    np.testing.assert_allclose(got["loss"], ref_loss, **LOSS_TOL)
    shapes = _shapes(CASES[name])
    assert set(got["grads"]) == set(shapes)
    assert_grads_close({n: np.reshape(v, shapes[n]) for n, v in got["grads"].items()},
                       ref_grads, GRAD_TOL_BAND if name in BAND_CASES else GRAD_TOL, NOISE32)


@pytest.mark.parametrize("name", sorted(n for n, c in CASES.items() if "engine" not in c))
def test_halo_float64_equals_one_device(results, name):
    got, ref = results[name]["halo64"], results[name]["dense64"]
    assert results[name]["same_on_every_rank"]
    assert abs(got["loss"] - ref["loss"]) <= F64_TOL * abs(ref["loss"])
    assert_grads_close(got["grads"], ref["grads"], F64_TOL, NOISE64)


def test_halo_trainer_eval_equals_one_device_eval(results):
    r = results["trainer"]
    assert r["params_same_on_every_rank"] and r["steps"] == 1 and np.isfinite(r["train_loss"])
    (loss, logs), (one_loss, one_logs) = r["halo"], r["one_device"]
    np.testing.assert_allclose(loss, one_loss, rtol=1e-5)
    assert set(logs) == set(one_logs) == {"mae_hamiltonian", "rmse_hamiltonian"}
    for k in logs:
        np.testing.assert_allclose(logs[k], one_logs[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("mode", ["halo", "dp"])
def test_cli_parallel_fit_then_one_device_test(results, spawned, mode):
    """``mode: halo`` (2 x 2) and ``dp`` (4 x 1) fit one epoch on four ranks;
    rank 0 wrote the files; the run's best.pt, tested under ``mode: none``
    on the test split, gives the fit's final test predictions."""
    from hamgnn_tpu_torch import cli
    from hamgnn_tpu_torch.data.dataset import load_graph_npz, reference_split, save_graph_npz
    from hamgnn_tpu_torch.train.config import load_config

    _, work = spawned
    work = str(work)
    fit = os.path.join(work, f"{mode}_fit")
    with open(os.path.join(fit, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert len(records) == 1 and np.isfinite(records[0]["val_loss"])
    graphs = load_graph_npz(os.path.join(work, "graph_data.npz"))
    _, _, test_idx = reference_split(len(graphs), 0.34, 0.33, 0.33)
    sub = os.path.join(work, f"{mode}_sub")
    os.makedirs(sub, exist_ok=True)
    save_graph_npz(os.path.join(sub, "graph_data.npz"), [graphs[i] for i in test_idx])
    cfg = cli_config(work, "none", "test", checkpoint_path=os.path.join(fit, "best.pt"))
    cfg["dataset_params"]["graph_data_path"] = sub
    cfg["profiler_params"]["train_dir"] = os.path.join(work, f"{mode}_none_test")
    logs = cli.train_and_evaluate(load_config(None, overrides=cfg), device="cpu")
    got = np.load(os.path.join(cfg["profiler_params"]["train_dir"],
                               "prediction_hamiltonian.npy"))
    want = np.load(os.path.join(fit, "prediction_hamiltonian.npy"))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(logs["mae_hamiltonian"],
                               results["cli"][mode]["mae_hamiltonian"], rtol=1e-5)


@pytest.mark.parametrize("block", ["conv", "pair"])
def test_interior_pass_reads_no_halo_row(block):
    """The overlap split: with the received halo rows NaN, every node (conv)
    or edge (pair) that no boundary edge touches comes out finite and equal to
    the run with the true halo rows; the exchange feeds the boundary pass
    alone (the counterpart of tests/test_halo_overlap.py)."""
    from hamgnn_tpu_torch.e3.irreps import Irreps
    from hamgnn_tpu_torch.models.model import init_weights
    from hamgnn_tpu_torch.nn.blocks import ConvBlockE3, PairInteractionBlock
    from hamgnn_tpu_torch.parallel.halo_model import plan_for_graph

    from hamgnn_tpu_torch.data.graph import pad_and_batch
    from hamgnn_tpu_torch.data.neighborlist import inverse_edge_index, neighbor_list_pbc

    # a rod of 16 atoms along x (cutoff 2.5 A, 1 A apart): the shards are
    # slabs, and the atoms in a slab's middle have no remote neighbour
    rng = np.random.default_rng(7)
    cell = np.diag([16.0, 4.0, 4.0])
    pos = np.stack([np.arange(16) + 0.5, rng.uniform(1.5, 2.5, 16),
                    rng.uniform(1.5, 2.5, 16)], 1)
    ei, cs, ns = neighbor_list_pbc(pos, cell, 2.5)
    g = pad_and_batch([{"z": rng.choice([6, 14], 16), "pos": pos, "cell": cell[None],
                        "edge_index": ei, "cell_shift": cs, "nbr_shift": ns,
                        "inv_edge_idx": inverse_edge_index(ei, cs)}],
                      node_bucket=16, edge_bucket=128)
    S = 2
    plan = plan_for_graph(g, S)
    n_loc = plan.n_nodes_local
    d = Irreps(FEAT).dim
    feats = torch.as_tensor(rng.normal(size=(g.num_nodes, d)), dtype=torch.float32)
    edge_feats = torch.as_tensor(rng.normal(size=(g.num_edges, d)), dtype=torch.float32)
    sh = torch.as_tensor(rng.normal(size=(g.num_edges, 9)), dtype=torch.float32)
    scal = torch.as_tensor(rng.normal(size=(g.num_edges, 6)), dtype=torch.float32)
    mod = (ConvBlockE3(FEAT, FEAT, SH, 6, radial_mlp=(8,)) if block == "conv"
           else PairInteractionBlock(FEAT, FEAT, SH, 6, radial_mlp=(8,)))
    init_weights(mod, 0)
    s = 0
    own = feats[s * n_loc:(s + 1) * n_loc]
    # the rows the exchange brings: block p holds what s asked of p
    halo = torch.cat([feats[p * n_loc + torch.as_tensor(plan.send_idx[p, s], dtype=torch.long)]
                      for p in range(S)])
    eid = torch.as_tensor(plan.edge_id[s], dtype=torch.long)
    src_pos = torch.as_tensor(plan.src_pos[s], dtype=torch.long)
    dst = torch.as_tensor(plan.dst_local[s], dtype=torch.long)
    mask = torch.as_tensor(plan.edge_mask[s])
    b_pos = torch.as_tensor(plan.boundary_pos[s], dtype=torch.long)
    b_mask = torch.as_tensor(plan.boundary_mask[s])
    interior = mask & (src_pos < n_loc)
    src_int = torch.where(src_pos < n_loc, src_pos, torch.zeros_like(src_pos))
    halo_pos = torch.clamp(src_pos[b_pos] - n_loc, min=0)
    ef, es, esc = edge_feats[eid], sh[eid], scal[eid]

    def run(h):
        with torch.no_grad():
            if block == "conv":
                bnd = (h[halo_pos], own[dst][b_pos], ef[b_pos], es[b_pos], esc[b_pos],
                       dst[b_pos], b_mask)
                return mod.gathered_call(own, own[src_int], own[dst], ef, es, esc, dst,
                                         interior, bnd)
            up_src, up_dst = mod.lift(own)
            h_up = mod.lift(h)[0]
            bnd = (h_up[halo_pos], up_dst[dst][b_pos], ef[b_pos], es[b_pos], esc[b_pos],
                   b_pos, b_mask)
            return mod.gathered_call(up_src[src_int], up_dst[dst], ef, es, esc, bnd)

    good, bad = run(halo), run(torch.full_like(halo, float("nan")))
    touched = torch.zeros(good.shape[0], dtype=torch.bool)
    touched[(dst if block == "conv" else torch.arange(len(dst)))[b_pos[b_mask]]] = True
    assert bool(touched.any()) and not bool(touched.all())
    assert torch.isfinite(bad[~touched]).all()
    assert torch.equal(bad[~touched], good[~touched])
    assert torch.isnan(bad[touched]).any(dim=-1).all()


if __name__ == "__main__":
    import torch.multiprocessing as mp

    from hamgnn_tpu_torch.parallel.multihost import free_port

    mp.spawn(_worker, args=(WORLD, free_port(), sys.argv[1]), nprocs=WORLD)
