"""The port's multi-device layer against the JAX package: the halo plan and
the packed inputs element for element (host numpy, this process), then one
spawn of two gloo processes (``torch.distributed`` on the CPU) that computes
the rest and writes one JSON, read through a module fixture:

* the multihost helpers across two processes (``is_primary``,
  ``process_count``, ``allgather_metrics``), as tests/test_parallel.py checks
  the JAX ones;
* the data-parallel step of ``ParallelTrainer`` (two crystals, one a rank)
  against the JAX ``make_parallel_train_step`` on the same weights: the loss
  (atol 5e-5 / rtol 1e-4) and amsgrad's first moment, 0.1 x the gradient,
  per tensor within 5e-4 x max|ref|;
* the one-layer halo forward (``make_halo_conv_forward``, conv and pair
  blocks, 2 shards) against the one-device blocks (2e-5 x max|ref|);
* ``band_cal_parallel`` with the k batch split over the two ranks against
  one process, and its CLI under the process group (rank 0 writes).

The workers import torch and the port, never JAX.
"""

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
SH = "0e + 1o + 2e"
LOSS_TOL = dict(atol=5e-5, rtol=1e-4)
GRAD_TOL = 5e-4
NOISE = 1e-6   # fp32 rounding relative to the largest gradient
REP = dict(num_types=20, irreps_edge_sh=SH, irreps_node_features=FEAT, num_layers=1,
           num_radial=6, rbf_func="bessel", cutoff=4.0, radial_mlp=(8,))
HEAD = dict(irreps_in_node=FEAT, irreps_in_edge=FEAT, nao_max=14, ham_type="openmx",
            ham_only=True, symmetrize=True, add_H0=True, zero_point_shift=True)
HAM = [{"metric": "mae", "prediction": "hamiltonian", "target": "hamiltonian",
        "loss_weight": 27.211}]
LR = 0.01


def dp_crystals():
    from hamgnn_tpu_torch.data.synthetic import add_random_hamiltonian_targets, make_crystal

    rng = np.random.default_rng(3)
    return [add_random_hamiltonian_targets(
        rng, make_crystal(rng, n_atoms=n, species=(6, 14), cell_size=5.0, cutoff=4.0),
        nao_max=14) for n in (4, 5)]


def port_model():
    from hamgnn_tpu_torch.models.model import HamGNNModel, init_weights
    from hamgnn_tpu_torch.models.output import HamGNNPlusPlusOut
    from hamgnn_tpu_torch.models.representation import HamGNNConvE3

    return init_weights(HamGNNModel(HamGNNConvE3(**REP), HamGNNPlusPlusOut(**HEAD)), 0)


def plan_crystal():
    """A 24-atom crystal over 32 padded nodes (tests/test_parallel.py's)."""
    from hamgnn_tpu_torch.data.synthetic import make_crystal

    return make_crystal(np.random.default_rng(7), n_atoms=24, species=(1, 6),
                        cell_size=7.0, cutoff=3.5)


def pencils(nk=7, n=6):
    rng = np.random.default_rng(4)
    a = rng.normal(size=(nk, n, n)) + 1j * rng.normal(size=(nk, n, n))
    b = rng.normal(size=(nk, n, n)) + 1j * rng.normal(size=(nk, n, n))
    return a + a.conj().transpose(0, 2, 1), b @ b.conj().transpose(0, 2, 1) + n * np.eye(n)


# --- the workers -----------------------------------------------------------

def _multihost(rank):
    from hamgnn_tpu_torch.parallel.multihost import (allgather_metrics, is_primary,
                                                     maybe_initialize_distributed,
                                                     process_count)

    g = allgather_metrics({"v": np.float32(rank + 1.5), "a": np.full((2,), rank, np.float32)})
    return {"ok": maybe_initialize_distributed(), "count": process_count(),
            "primary": is_primary(), "v": g["v"].tolist(), "a": g["a"].tolist()}


def _dp_step(work):
    from hamgnn_tpu_torch.parallel.trainer import ParallelTrainer

    trainer = ParallelTrainer(port_model(), losses=HAM, metrics=[], lr=LR, device="cpu",
                              n_data=2, n_graph=1, train_dir=os.path.join(work, "dp"))
    loss, _ = trainer.train_step(trainer._stack(dp_crystals()))
    names = [n for n, _ in trainer.model.named_parameters()]
    mu = trainer.opt.mu.split([p.numel() for p in trainer.model.parameters()])
    return {"loss": float(loss), "count": int(trainer.opt.count),
            "mu": {n: m.tolist() for n, m in zip(names, mu)},
            "eval": trainer.eval_epoch_crystals(dp_crystals())}


def _halo_conv(mesh):
    import torch.distributed as dist

    from hamgnn_tpu_torch.data.graph import pad_and_batch
    from hamgnn_tpu_torch.e3.irreps import Irreps
    from hamgnn_tpu_torch.models.model import init_weights
    from hamgnn_tpu_torch.nn.blocks import ConvBlockE3, PairInteractionBlock
    from hamgnn_tpu_torch.parallel.halo import (gather_edge_arrays, make_halo_conv_forward,
                                                make_plan, scatter_back_edges,
                                                scatter_back_nodes)
    from hamgnn_tpu_torch.parallel.multihost import allgather_metrics

    g = pad_and_batch([plan_crystal()], node_bucket=32, edge_bucket=512)
    rng = np.random.default_rng(8)
    d = Irreps(FEAT).dim
    t = lambda *shape: torch.as_tensor(rng.normal(size=shape), dtype=torch.float32)  # noqa
    nodes, edges = t(g.num_nodes, d), t(g.num_edges, d)
    sh, scal = t(g.num_edges, 9), t(g.num_edges, 6)
    conv = init_weights(ConvBlockE3(FEAT, FEAT, SH, 6, radial_mlp=(8,)), 1)
    pair = init_weights(PairInteractionBlock(FEAT, FEAT, SH, 6, radial_mlp=(8,)), 2)
    S, s = mesh.n_graph, mesh.graph_rank
    plan = make_plan(g.edge_index.numpy(), g.edge_mask.numpy(), g.num_nodes, S)
    ef, esh, esc = gather_edge_arrays(plan, edges, sh, scal)
    n_loc = plan.n_nodes_local
    loc = lambda a: torch.as_tensor(a[s], dtype=torch.long)  # noqa: E731
    with torch.no_grad():
        new_nodes, new_edges = make_halo_conv_forward(conv, mesh.graph_group, pair)(
            nodes[s * n_loc:(s + 1) * n_loc], ef[s], esh[s], esc[s], loc(plan.src_pos),
            loc(plan.dst_local), torch.as_tensor(plan.edge_mask[s]), loc(plan.send_idx))
        got = allgather_metrics({"n": new_nodes.numpy(), "e": new_edges.numpy()})
        ref_nodes = conv(nodes, edges, sh, scal, g.edge_index, g.edge_mask)
        ref_edges = pair(ref_nodes, edges, sh, scal, g.edge_index)
    got_nodes = scatter_back_nodes(plan, torch.as_tensor(got["n"]).reshape(-1, d), g.num_nodes)
    got_edges = scatter_back_edges(plan, torch.as_tensor(got["e"]), g.num_edges)
    live = g.edge_mask
    err = lambda a, b: float((a - b).abs().max() / b.abs().max())  # noqa: E731
    return {"nodes": err(got_nodes, ref_nodes), "edges": err(got_edges[live], ref_edges[live]),
            "rank": dist.get_rank()}


def _band_cal(work):
    import torch.distributed as dist
    import yaml

    from hamgnn_tpu_torch.data.dataset import save_graph_npz
    from hamgnn_tpu_torch.tools import band_cal_parallel as bcp

    HK, SK = pencils()
    split = bcp.solve_bands_batched(HK, SK, k_batch=5, group=dist.group.WORLD, device="cpu")
    one = bcp.solve_bands_batched(HK, SK, k_batch=5, device="cpu")
    if dist.get_rank() == 0:
        save_graph_npz(os.path.join(work, "bcp.npz"), dp_crystals())
        with open(os.path.join(work, "bcp.yaml"), "w") as f:
            yaml.safe_dump({"nao_max": 14, "graph_data_path": os.path.join(work, "bcp.npz"),
                            "nk": 7, "k_batch": 4, "save_dir": os.path.join(work, "bands")}, f)
    dist.barrier()
    bcp.main(["--config", os.path.join(work, "bcp.yaml"), "--device", "cpu"])
    return {"max_diff": float(np.abs(split - one).max()), "shape": list(split.shape)}


def _worker(rank, world, port, work):
    import torch.distributed as dist

    from hamgnn_tpu_torch.parallel.multihost import maybe_initialize_distributed
    from hamgnn_tpu_torch.parallel.sharding import make_mesh

    torch.set_num_threads(1)
    maybe_initialize_distributed(f"tcp://localhost:{port}", world, rank, device="cpu")
    res = {"multihost": _multihost(rank), "dp": _dp_step(work),
           "halo_conv": _halo_conv(make_mesh(1, 2)), "band_cal": _band_cal(work)}
    res["jax_imported"] = any(m == "jax" or m.startswith(("jax.", "hamgnn_tpu."))
                              for m in sys.modules)
    every = [None] * world
    dist.all_gather_object(every, res)
    if rank == 0:
        with open(os.path.join(work, "parallel.json"), "w") as f:
            json.dump(every, f)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    work = tmp_path_factory.mktemp("parallel")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, TESTS, os.environ.get("PYTHONPATH", "")]))
    env.pop("HAMGNN_TP_ENGINE", None)
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), str(work)], cwd=REPO,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    yield proc, work
    if proc.poll() is None:
        proc.kill()


@pytest.fixture(scope="module")
def jax_dp(spawned):
    """The JAX data-parallel step on the port's weights: (loss, gradient by
    parameter name)."""
    import jax
    import jax.numpy as jnp
    import optax
    from flax.traverse_util import flatten_dict, unflatten_dict
    from jax.flatten_util import ravel_pytree

    from hamgnn_tpu.data.graph import pad_and_batch as j_pad
    from hamgnn_tpu.models.model import HamGNNModel
    from hamgnn_tpu.models.output import HamGNNPlusPlusOut
    from hamgnn_tpu.models.representation import HamGNNConvE3
    from hamgnn_tpu.parallel.sharding import (init_flat_opt_state, make_mesh,
                                              make_parallel_train_step, shard_stacked_graph,
                                              stack_graphs)

    model = HamGNNModel(representation=HamGNNConvE3(**REP), output=HamGNNPlusPlusOut(**HEAD))
    params = {"params": unflatten_dict({tuple(n.split(".")): jnp.asarray(p.detach().numpy())
                                        for n, p in port_model().named_parameters()})}
    crystals = dp_crystals()
    n_b = max(16, -(-max(c["z"].shape[0] for c in crystals) // 16) * 16)
    e_b = max(512, -(-max(c["edge_index"].shape[1] for c in crystals) // 512) * 512)
    mesh = make_mesh(2, 1)
    stacked = shard_stacked_graph(mesh, stack_graphs(
        [j_pad([c], node_bucket=n_b, edge_bucket=e_b) for c in crystals]))
    tx = optax.chain(optax.amsgrad(learning_rate=1.0))
    step = make_parallel_train_step(model, tx, HAM, mesh, stacked)
    _, state, loss, _ = step(params, init_flat_opt_state(tx, params), stacked,
                             jnp.asarray(LR, jnp.float32))
    mu = [s for s in jax.tree_util.tree_leaves(state, is_leaf=lambda x: hasattr(x, "mu"))
          if hasattr(s, "mu")][0].mu
    _, unravel = ravel_pytree(params)
    grads = flatten_dict(unravel(np.asarray(mu) / 0.1)["params"])
    return float(loss), {".".join(k): np.asarray(v) for k, v in grads.items()}


@pytest.fixture(scope="module")
def results(spawned, jax_dp):
    proc, work = spawned
    log, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, log.decode(errors="replace")[-4000:]
    with open(os.path.join(work, "parallel.json")) as f:
        return json.load(f)


# --- the plan and the packed inputs, element for element ----------------------

def _graphs():
    from hamgnn_tpu.data.graph import pad_and_batch as j_pad
    from hamgnn_tpu_torch.data.graph import pad_and_batch as t_pad
    from hamgnn_tpu_torch.data.synthetic import add_random_hamiltonian_targets

    c = add_random_hamiltonian_targets(np.random.default_rng(9), plan_crystal(), nao_max=14)
    c["doping_charge"] = np.array([0.4])
    return (j_pad([c], node_bucket=32, edge_bucket=512),
            t_pad([c], node_bucket=32, edge_bucket=512))


def _assert_plans_equal(a, b):
    import dataclasses

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("inv", [False, True])
@pytest.mark.parametrize("force", [False, True])
def test_make_plan_matches_jax(S, inv, force):
    from hamgnn_tpu.parallel import halo as j_halo
    from hamgnn_tpu_torch.parallel import halo as t_halo

    _, g = _graphs()
    args = (g.edge_index.numpy(), g.edge_mask.numpy(), g.num_nodes, S)
    kw = {"inv_edge_idx": g.inv_edge_idx.numpy()} if inv else {}
    if force:
        nat = t_halo.make_plan(*args, **kw)
        kw.update(force_edge_loc=nat.edge_id.shape[1] + 64, force_halo=nat.halo_bucket + 8,
                  force_boundary=nat.boundary_bucket + 8)
        if inv:
            kw["force_edge_halo"] = nat.edge_halo_bucket + 8
    got, want = t_halo.make_plan(*args, **kw), j_halo.make_plan(*args, **kw)
    _assert_plans_equal(got, want)
    assert got.table_size == want.table_size


def test_make_plan_refuses_a_small_forced_size():
    from hamgnn_tpu_torch.parallel.halo import make_plan

    _, g = _graphs()
    with pytest.raises(ValueError, match="force_halo"):
        make_plan(g.edge_index.numpy(), g.edge_mask.numpy(), g.num_nodes, 2, force_halo=1)


@pytest.mark.parametrize("S", [2, 4])
def test_halo_inputs_and_edge_unperm_match_jax(S):
    from hamgnn_tpu.parallel import halo_model as j_hm
    from hamgnn_tpu_torch.parallel import halo_model as t_hm

    jg, tg = _graphs()
    jplan, tplan = j_hm.plan_for_graph(jg, S), t_hm.plan_for_graph(tg, S)
    _assert_plans_equal(tplan, jplan)
    got, want = t_hm.build_halo_inputs(tg, tplan), j_hm.build_halo_inputs(jg, jplan)
    assert set(got) == set(want)
    for k in want:
        a, b = got[k], np.asarray(want[k])
        assert a.shape == b.shape and np.array_equal(a, b), k
    np.testing.assert_array_equal(t_hm.edge_unperm_for_plan(tplan, tg.num_edges),
                                  j_hm.edge_unperm_for_plan(jplan, jg.num_edges))


def test_stack_halo_inputs_and_bucket_sizes_match_jax():
    from hamgnn_tpu.data.graph import pad_and_batch as j_pad
    from hamgnn_tpu.parallel import halo_model as j_hm
    from hamgnn_tpu_torch.data.graph import pad_and_batch as t_pad
    from hamgnn_tpu_torch.parallel import halo_model as t_hm

    crystals = dp_crystals()
    jg = [j_pad([c], node_bucket=16, edge_bucket=256) for c in crystals]
    tg = [t_pad([c], node_bucket=16, edge_bucket=256) for c in crystals]
    sizes = t_hm.halo_bucket_sizes(tg, 2, 32)
    assert sizes == j_hm.halo_bucket_sizes(jg, 2, 32)
    for force in (None, tuple(s + 8 for s in sizes)):
        got = t_hm.stack_halo_inputs(tg, 2, 32, force_sizes=force)
        want = j_hm.stack_halo_inputs(jg, 2, 32, force_sizes=force)
        assert set(got) == set(want)
        for k in want:
            assert np.array_equal(got[k], np.asarray(want[k])), k


def test_edge_arrays_gather_and_scatter_back_match_jax():
    from hamgnn_tpu.parallel import halo as j_halo
    from hamgnn_tpu_torch.parallel import halo as t_halo

    _, g = _graphs()
    plan = t_halo.make_plan(g.edge_index.numpy(), g.edge_mask.numpy(), g.num_nodes, 4)
    rows = np.random.default_rng(1).normal(size=(g.num_edges, 5)).astype(np.float32)
    (got,), (want,) = t_halo.gather_edge_arrays(plan, rows), j_halo.gather_edge_arrays(plan, rows)
    np.testing.assert_array_equal(got, want)
    (got_t,) = t_halo.gather_edge_arrays(plan, torch.as_tensor(rows))
    np.testing.assert_array_equal(got_t.numpy(), want)
    back = t_halo.scatter_back_edges(plan, torch.as_tensor(got), g.num_edges).numpy()
    np.testing.assert_array_equal(back, np.asarray(j_halo.scatter_back_edges(plan, want,
                                                                           g.num_edges)))
    live = g.edge_mask.numpy()
    np.testing.assert_array_equal(back[live], rows[live])


def test_mesh_needs_the_world_it_names():
    """``make_mesh`` lays out the initialised world; without one it says how
    to bring it up."""
    import torch.distributed as dist

    from hamgnn_tpu_torch.parallel.sharding import make_mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="maybe_initialize_distributed"):
        make_mesh(1, 2)


# --- the workers' results ----------------------------------------------------

def test_workers_import_no_jax(results):
    assert not any(r["jax_imported"] for r in results)


def test_multihost_two_processes(results):
    r0, r1 = (r["multihost"] for r in results)
    for r in (r0, r1):
        assert r["ok"] and r["count"] == 2
        assert r["v"] == [1.5, 2.5]
        assert r["a"] == [[0.0, 0.0], [1.0, 1.0]]
    assert r0["primary"] and not r1["primary"]


def test_parallel_trainer_step_matches_jax(results, jax_dp):
    ref_loss, ref = jax_dp
    shapes = {n: tuple(p.shape) for n, p in port_model().named_parameters()}
    for r in results:
        got = r["dp"]
        assert got["count"] == 1
        np.testing.assert_allclose(got["loss"], ref_loss, **LOSS_TOL)
        assert set(got["mu"]) == set(ref) == set(shapes)
        floor = NOISE * max(float(np.abs(v).max()) for v in ref.values())
        for n, want in ref.items():
            a = np.reshape(got["mu"][n], shapes[n]) / 0.1
            scale = float(np.abs(want).max(initial=0.0))
            if scale < floor:
                assert np.abs(a).max(initial=0.0) < floor, n
                continue
            assert np.abs(a - want).max() <= GRAD_TOL * scale, (n, float(np.abs(a - want).max()),
                                                                scale)
    assert results[0]["dp"]["mu"] == results[1]["dp"]["mu"]
    # the eval of the updated weights: the same mean on both ranks
    assert np.isfinite(results[0]["dp"]["eval"])
    assert results[0]["dp"]["eval"] == results[1]["dp"]["eval"]


def test_stack_graphs_and_flat_opt_state():
    from hamgnn_tpu.data.graph import pad_and_batch as j_pad
    from hamgnn_tpu.parallel.sharding import stack_graphs as j_stack
    from hamgnn_tpu_torch.data.graph import pad_and_batch as t_pad
    from hamgnn_tpu_torch.parallel.sharding import init_flat_opt_state, stack_graphs

    crystals = dp_crystals()
    got = stack_graphs([t_pad([c], node_bucket=16, edge_bucket=256) for c in crystals])
    want = j_stack([j_pad([c], node_bucket=16, edge_bucket=256) for c in crystals])
    for f in ("z", "pos", "edge_index", "edge_mask", "inv_edge_idx", "Hon", "Hoff", "cell"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    flat = torch.ones(7)
    opt = init_flat_opt_state(flat, gradient_clip_val=0.5)
    assert opt.clip == 0.5 and int(opt.count) == 0
    assert all(t.shape == (7,) and not t.any() for t in (opt.mu, opt.nu, opt.nu_max))


def test_halo_conv_forward_matches_one_device(results):
    for r in results:
        assert r["halo_conv"]["nodes"] <= 2e-5 and r["halo_conv"]["edges"] <= 2e-5


def test_band_cal_parallel_over_a_process_group(results, spawned, tmp_path):
    import yaml

    from hamgnn_tpu_torch.tools import band_cal_parallel as bcp

    for r in results:
        assert r["band_cal"]["shape"] == [7, 6] and r["band_cal"]["max_diff"] <= 1e-6
    _, work = spawned
    with open(os.path.join(work, "bcp.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["save_dir"] = str(tmp_path / "one")
    with open(tmp_path / "one.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    bcp.main(["--config", str(tmp_path / "one.yaml"), "--device", "cpu"])
    for i in range(2):
        got = np.load(os.path.join(work, "bands", f"bands_{i}.npz"))["bands"]
        want = np.load(tmp_path / "one" / f"bands_{i}.npz")["bands"]
        # complex64 solves in processes with other thread counts: fp32 rounding
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


if __name__ == "__main__":
    import torch.multiprocessing as mp

    from hamgnn_tpu_torch.parallel.multihost import free_port

    mp.spawn(_worker, args=(2, free_port(), sys.argv[1]), nprocs=2)
