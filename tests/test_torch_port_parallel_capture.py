"""The multi-device steps as the trainers capture them, on the CPU.

On the card under NCCL, ``HaloTrainer`` and ``ParallelTrainer`` replay their
steps from CUDA graphs (``train/captured.py``); here, where there are no
graphs, the steps run eagerly, and what the capture rests on is checked:

* the default ``capture`` (False on the CPU, and over gloo by the stated
  rule of ``sharding.capture_default``; ``capture=True`` raises there);
* ``step_key``, the key of a step whose batch is a dict of packed halo
  inputs: the same for equal signatures, a new one for another shape, and
  ``copy_inputs`` refuses other names or types under the same key;
* ``copy_inputs`` of host tensors into a step's static buffers, and the
  capture error mode (``global`` without an NCCL group);
* the restructured steps (the learning rate as the trainer's device tensor
  ``lr_t``, the inputs copied from the host into static buffers) against
  the eager step as it was called before (a float learning
  rate, the inputs moved straight to the device), bit for bit, in one gloo
  process (halo, band-mode halo, data parallel) and in two (halo split 2
  ways, data parallel over 2 crystals), with a change of learning rate
  between two steps;
* the two-process halo step against the JAX package's
  ``make_halo_train_step`` on the same weights: the loss (atol 5e-5 / rtol
  1e-4) and amsgrad's first moment, 0.1 x the gradient, per tensor within
  5e-4 x max|ref| (PERF.md section 2); the data-parallel step's JAX
  reference is tests/test_torch_port_parallel.py's, which runs the same
  ``ParallelTrainer.train_step``;
* ``ParallelTrainer.train_epoch_crystals``, which reads the device once an
  epoch, returns the value of the per-step reads it replaced.

One subprocess runs the one-process group, then spawns the two-process one;
it writes one JSON, read through a module fixture.  The workers import torch
and the port, never JAX; the JAX references are computed in this process
while they run.
"""

import json
import os
import subprocess
import sys

import traceback

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
FEAT = "2x0e+1x1o+1x2e"
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
BAND = [{"metric": "mae", "prediction": "band_energy", "target": "band_energy",
         "loss_weight": 0.01}]
LRS = (0.01, 0.004)   # the learning rate of the first and of the second step


def crystals(n):
    from hamgnn_tpu_torch.data.synthetic import add_random_hamiltonian_targets, make_crystal

    rng = np.random.default_rng(3)
    return [add_random_hamiltonian_targets(
        rng, make_crystal(rng, n_atoms=a, species=(6, 14), cell_size=5.0, cutoff=4.0),
        nao_max=14) for a in (6, 5)[:n]]


def port_model(band=False):
    from hamgnn_tpu_torch.models.model import HamGNNModel, init_weights
    from hamgnn_tpu_torch.models.output import HamGNNPlusPlusOut
    from hamgnn_tpu_torch.models.representation import HamGNNConvE3

    head = dict(HEAD, calculate_band_energy=True, num_k=2, band_num_control=2) if band else HEAD
    return init_weights(HamGNNModel(HamGNNConvE3(**REP), HamGNNPlusPlusOut(**head)), 0)


def halo_graph():
    from hamgnn_tpu_torch.data.graph import pad_and_batch

    return pad_and_batch(crystals(1), node_bucket=8, edge_bucket=256)


# --- the workers -----------------------------------------------------------

def _state(tr):
    return [tr.flat, *tr.opt.state_dict().values()]


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(_state(a), _state(b)))


def _steps(make, before, after, static):
    """Two steps, at LRS[0] then LRS[1], of three trainers on the same
    weights: ``before(tr, lr)`` the step as it was called before the steps
    were made capturable, ``after(tr)`` the trainer's step, ``static(tr,
    cache)`` the step on static buffers filled by ``copy_inputs``.
    Returns whether every loss, log, parameter and optimizer state agreed
    bit for bit, and the first step's loss and first moment by name."""
    trs = [make() for _ in range(3)]
    cache, agree, first = {}, True, None
    for lr in LRS:
        for tr in trs:
            tr.sched.lr = lr
        outs = [before(trs[0], lr), after(trs[1]), static(trs[2], cache)]
        (l0, g0), *rest = outs
        agree &= all(torch.equal(l0, l) and g0.keys() == g.keys()
                     and all(torch.equal(g0[k], g[k]) for k in g0) for l, g in rest)
        agree &= _same(trs[0], trs[1]) and _same(trs[0], trs[2])
        if first is None:
            names = [n for n, _ in trs[1].model.named_parameters()]
            mu = trs[1].opt.mu.split([p.numel() for p in trs[1].model.parameters()])
            first = {"loss": float(l0), "mu": {n: m.tolist() for n, m in zip(names, mu)}}
    lr_t = float(trs[1].lr_t)
    return {"bit_for_bit": bool(agree), "lr_t": lr_t, **first}


def _through_static(cache, batch, inputs):
    """The static buffers of a step (one set per ``step_key``), filled from
    host ``batch`` and ``inputs`` by ``copy_inputs``, as ``CapturedSteps``
    fills them before a replay."""
    from hamgnn_tpu_torch.train.captured import copy_inputs, static_copy, step_key

    key = step_key(batch, inputs)
    if key not in cache:
        cache[key] = (static_copy(batch), {n: static_copy(v) for n, v in inputs.items()})
    static, static_inputs = cache[key]
    copy_inputs({"batch": static, **static_inputs}, {"batch": batch, **inputs})
    return static, static_inputs


class _HostTraffic(TorchDispatchMode):
    """Records, by the port's source line, every op that builds a tensor from
    host data, waits for the device (a scalar read, ``nonzero``, a boolean
    index, ``unique``) or copies to the CPU: none can sit in a CUDA graph."""

    SYNCS = (torch.ops.aten._local_scalar_dense.default, torch.ops.aten.nonzero.default,
             torch.ops.aten.masked_select.default)

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        bool_index = func is torch.ops.aten.index.Tensor and any(
            i is not None and i.dtype == torch.bool for i in args[1])
        to_cpu = func is torch.ops.aten._to_copy.default and \
            str((kwargs or {}).get("device", "")).startswith("cpu")
        if func is torch.ops.aten.lift_fresh.default or func in self.SYNCS or bool_index \
                or "unique" in func.name() or to_cpu:
            self.seen.append((func.name(), _port_line()))
        return func(*args, **(kwargs or {}))


def _port_line():
    frames = [f for f in traceback.extract_stack() if "hamgnn_tpu_torch" in f.filename]
    return f"{frames[-1].filename.split('hamgnn_tpu_torch')[-1]}:{frames[-1].lineno}" \
        if frames else "?"


def _step_traffic(step):
    """What ``step()`` does, after a first run of it (a capture's warm-up),
    that a CUDA graph cannot record: ``_HostTraffic``'s ops, and calls of
    ``torch.tensor`` / ``as_tensor`` / ``from_numpy`` and of a tensor's
    ``cpu`` / ``numpy`` / ``tolist``, by the port's source line."""
    step()
    calls, mode = [], _HostTraffic()
    with pytest.MonkeyPatch.context() as m:
        for owner, names in ((torch, ("tensor", "as_tensor", "from_numpy")),
                             (torch.Tensor, ("cpu", "numpy", "tolist"))):
            for name in names:
                real = getattr(owner, name)
                m.setattr(owner, name, lambda *a, _real=real, _n=name, **k: (
                    calls.append((_n, _port_line())), _real(*a, **k))[1])
        with mode:
            step()
    return [list(c) for c in calls + mode.seen]


def _halo_case(mesh, work, band=False):
    from hamgnn_tpu_torch.parallel.halo_model import (local_inputs, make_halo_train_step,
                                                      stack_halo_inputs)
    from hamgnn_tpu_torch.parallel.halo_trainer import HaloTrainer

    S = mesh.n_graph
    g = halo_graph()
    item = stack_halo_inputs([g], S)
    if band:
        item = (item, g)
    losses = HAM + BAND if band else HAM

    def make():
        return HaloTrainer(port_model(band), losses=losses, metrics=[], lr=LRS[0],
                           device="cpu", n_data=1, n_graph=S,
                           train_dir=os.path.join(work, f"halo_{S}_{band}"))

    def before(tr, lr):
        # the trainer's eager step before: lr a float, inputs moved by local_inputs
        inp, band_args = tr._args(item, tr.device)
        return make_halo_train_step(tr.model, tr.opt, tr.losses, tr.mesh, tr.flat, tr.grad,
                                    with_band=band)(inp, lr, **band_args)

    def static(tr, cache):
        tr.model.train()
        tr.fill_lr()
        inp, band_args = _through_static(cache, *tr._args(item, "cpu"))
        return tr._halo_step()(inp, tr.lr_t, **band_args)

    tr = make()
    inp = local_inputs(item[0] if band else item, S, mesh.graph_rank, "cpu", data_row=0)
    out = _steps(make, before, lambda t: t.train_step(item), static)
    out.update(parallel_steps=tr.parallel_steps is None, captured=tr.captured is None,
               input_names=sorted(inp))
    if not band:
        # the bodies a capture records, on static inputs
        inp = {k: v.clone() for k, v in inp.items()}
        out["traffic"] = _step_traffic(lambda: tr._halo_step()(inp, tr.lr_t)) + \
            _step_traffic(lambda: tr._halo_eval_step(inp))
    return out


def _dp_case(mesh, work):
    from hamgnn_tpu_torch.parallel.sharding import make_parallel_train_step
    from hamgnn_tpu_torch.parallel.trainer import ParallelTrainer

    cs = crystals(mesh.n_data)

    def make():
        return ParallelTrainer(port_model(), losses=HAM, metrics=[], lr=LRS[0], device="cpu",
                               n_data=mesh.n_data, n_graph=1,
                               train_dir=os.path.join(work, f"dp_{mesh.n_data}"))

    def before(tr, lr):
        return make_parallel_train_step(tr.model, tr.opt, tr.losses, tr.mesh, tr.flat,
                                        tr.grad)(tr._stack(cs), lr)

    def static(tr, cache):
        tr.model.train()
        tr.fill_lr()
        graph, _ = _through_static(cache, tr._stack(cs, "cpu"), {})
        return tr._pstep(graph, tr.lr_t)

    out = _steps(make, before, lambda t: t.train_step(t._stack(cs)), static)
    tr, graph = make(), make()._stack(cs)
    out["traffic"] = _step_traffic(lambda: tr._pstep(graph, tr.lr_t)) + \
        _step_traffic(lambda: tr._pev(graph))
    # an epoch's mean, read once, against the per-step reads it replaced
    a, b = make(), make()
    many = cs * 3
    got = a.train_epoch_crystals(many, rng=np.random.default_rng(4))
    want = float(np.mean([float(b.train_step(g)[0])
                          for g in b._iter_stacked(many, True, np.random.default_rng(4))]))
    out.update(epoch_mean=got, epoch_mean_per_step=want, epoch_same=_same(a, b),
               eval_same=a.eval_epoch_crystals(cs) == b.eval_epoch_crystals(cs),
               parallel_steps=a.parallel_steps is None)
    return out


def _defaults(work):
    """The default capture over gloo on the CPU, and what raises."""
    from hamgnn_tpu_torch.parallel.halo_trainer import HaloTrainer
    from hamgnn_tpu_torch.parallel.sharding import capture_default
    from hamgnn_tpu_torch.parallel.trainer import ParallelTrainer
    from hamgnn_tpu_torch.utils.cuda_graphs import capture_mode

    out = {"capture_mode": capture_mode(),
           "card_over_gloo": capture_default(None, torch.device("cuda", 0)),
           "cpu": capture_default(None, torch.device("cpu")),
           "cpu_false": capture_default(False, torch.device("cpu"))}
    for name, call in (
            ("halo_true", lambda: HaloTrainer(port_model(), losses=HAM, metrics=[],
                                              device="cpu", capture=True,
                                              train_dir=os.path.join(work, "d0"))),
            ("dp_true", lambda: ParallelTrainer(port_model(), losses=HAM, metrics=[],
                                                device="cpu", capture=True,
                                                train_dir=os.path.join(work, "d1"))),
            ("gloo_true", lambda: capture_default(True, torch.device("cuda", 0)))):
        try:
            call()
            out[name] = "no error"
        except ValueError as exc:
            out[name] = str(exc)
    return out


def _run(world, rank, port, work):
    import torch.distributed as dist

    from hamgnn_tpu_torch.parallel.sharding import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        res = {"halo": _halo_case(make_mesh(1, world), work),
               "dp": _dp_case(make_mesh(world, 1), work)}
        if world == 1:
            res["band"] = _halo_case(make_mesh(1, 1), work, band=True)
            res["defaults"] = _defaults(work)
        res["jax_imported"] = any(m == "jax" or m.startswith(("jax.", "hamgnn_tpu."))
                                  for m in sys.modules)
        every = [None] * world
        dist.all_gather_object(every, res)
        if rank == 0:
            with open(os.path.join(work, f"world{world}.json"), "w") as f:
                json.dump(every, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _worker(rank, world, port, work):
    _run(world, rank, port, work)


# --- the JAX references (this process) and the fixtures -----------------------

@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    work = tmp_path_factory.mktemp("parallel_capture")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, TESTS, os.environ.get("PYTHONPATH", "")]))
    env.pop("HAMGNN_TP_ENGINE", None)
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), str(work)], cwd=REPO,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    yield proc, work
    if proc.poll() is None:
        proc.kill()


def _jax_params():
    import jax.numpy as jnp
    from flax.traverse_util import unflatten_dict

    return {"params": unflatten_dict({tuple(n.split(".")): jnp.asarray(p.detach().numpy())
                                      for n, p in port_model().named_parameters()})}


def _jax_mu(state):
    import jax
    from flax.traverse_util import flatten_dict
    from jax.flatten_util import ravel_pytree

    mu = [s for s in jax.tree_util.tree_leaves(state, is_leaf=lambda x: hasattr(x, "mu"))
          if hasattr(s, "mu")][0].mu
    _, unravel = ravel_pytree(_jax_params())
    return {".".join(k): np.asarray(v)
            for k, v in flatten_dict(unravel(np.asarray(mu) / 0.1)["params"]).items()}


@pytest.fixture(scope="module")
def jax_halo(spawned):
    """The JAX halo step (one crystal split 2 ways, a 1 x 2 mesh) on the
    port's weights at LRS[0]: (loss, first moment / 0.1 by name); compiled
    without most of XLA's optimizations."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from hamgnn_tpu.data.graph import pad_and_batch as j_pad
    from hamgnn_tpu.models.model import HamGNNModel
    from hamgnn_tpu.models.output import HamGNNPlusPlusOut
    from hamgnn_tpu.models.representation import HamGNNConvE3
    from hamgnn_tpu.parallel.halo_model import make_halo_train_step, stack_halo_inputs
    from hamgnn_tpu.parallel.sharding import init_flat_opt_state

    prev = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        model = HamGNNModel(representation=HamGNNConvE3(**REP),
                            output=HamGNNPlusPlusOut(**HEAD))
        tx = optax.chain(optax.amsgrad(learning_rate=1.0))
        mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "graph"))
        inputs = stack_halo_inputs([j_pad(crystals(1), node_bucket=8, edge_bucket=256)], 2)
        sh = NamedSharding(mesh, P("data", "graph"))
        inputs = {k: jax.device_put(jnp.asarray(v), sh) for k, v in inputs.items()}
        # the step donates its parameters and state: fresh ones for the call
        _, state, loss, _ = make_halo_train_step(model, tx, HAM, mesh, data_axis="data")(
            _jax_params(), init_flat_opt_state(tx, _jax_params()), inputs,
            jnp.asarray(LRS[0], jnp.float32))
        return float(loss), _jax_mu(state)
    finally:
        jax.config.update("jax_disable_most_optimizations", prev)


@pytest.fixture(scope="module")
def results(spawned, jax_halo):
    proc, work = spawned
    log, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, log.decode(errors="replace")[-4000:]
    out = {}
    for world in (1, 2):
        with open(os.path.join(work, f"world{world}.json")) as f:
            out[world] = json.load(f)
    return out


# --- in this process ----------------------------------------------------------

def _inputs(n_edges=24, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    return {"src_pos": torch.randint(0, 8, (n_edges,), generator=g),
            "edge_vec": torch.randn(n_edges, 3, generator=g, dtype=dtype),
            "z": torch.randint(1, 9, (4,), generator=g)}


def test_step_key_of_packed_inputs():
    """The key of a step on a dict batch is the shapes of its tensors by
    name, the batch's and the other inputs'; under one key, other names or
    types are refused."""
    from hamgnn_tpu_torch.train.captured import copy_inputs, static_copy, step_key

    a, b = _inputs(), _inputs()
    k_vecs = {"k_vecs": torch.zeros(1, 2, 3)}
    assert step_key(a, k_vecs) == step_key(b, k_vecs) == step_key(a, dict(k_vecs))
    assert step_key(a, {}) != step_key(a, k_vecs)
    assert step_key(_inputs(32), k_vecs) != step_key(a, k_vecs)
    static = static_copy(a)
    assert all(static[n].data_ptr() != a[n].data_ptr() for n in a)
    ptrs = {n: t.data_ptr() for n, t in static.items()}
    copy_inputs(static, b)
    assert all(torch.equal(static[n], b[n]) and static[n].data_ptr() == ptrs[n] for n in b)
    renamed = dict(b)
    renamed["src_pos2"] = renamed.pop("src_pos")   # the same shapes in the same order
    assert step_key(renamed, {}) == step_key(a, {})
    for other in (renamed, _inputs(dtype=torch.float64)):
        assert step_key(other, {}) == step_key(a, {})
        with pytest.raises(ValueError, match="other fields"):
            copy_inputs(static, other)
    # a Graph among the inputs (a band-mode halo step's whole crystal)
    graph = halo_graph()
    key = step_key(a, {"band_graph": graph})
    assert key != step_key(a, {})
    assert key == step_key(b, {"band_graph": halo_graph()})


def test_copy_inputs_fills_the_buffers_in_place_from_the_host():
    """Host tensors fill the static buffers in place, at their addresses; a
    tensor on another device than its buffer's and the host is refused;
    without an NCCL group the capture error mode is ``global``."""
    from hamgnn_tpu_torch.train.captured import copy_inputs, static_copy
    from hamgnn_tpu_torch.utils.cuda_graphs import capture_mode

    static = static_copy(_inputs())
    ptrs = {n: t.data_ptr() for n, t in static.items()}
    for seed in range(2):
        src = {n: t + seed for n, t in _inputs().items()}
        copy_inputs(static, src)
        assert all(torch.equal(static[n], src[n]) and static[n].data_ptr() == ptrs[n]
                   for n in src)
    with pytest.raises(ValueError, match="other fields"):
        copy_inputs(static, {n: t.to("meta") for n, t in _inputs().items()})
    assert capture_mode() == "global"


# --- from the workers -----------------------------------------------------------

def test_workers_import_no_jax(results):
    assert not any(r["jax_imported"] for world in results.values() for r in world)


def test_default_capture_is_off_on_the_cpu_and_over_gloo(results):
    d = results[1][0]["defaults"]
    assert d["capture_mode"] == "global"
    assert d["card_over_gloo"] is False and d["cpu"] is False and d["cpu_false"] is False
    assert "needs the card" in d["halo_true"] and "needs the card" in d["dp_true"]
    assert "needs an NCCL process group, not gloo" in d["gloo_true"]
    for world in results.values():
        for r in world:
            assert r["halo"]["parallel_steps"] and r["halo"]["captured"]
            assert r["dp"]["parallel_steps"]


@pytest.mark.parametrize("world,case", [(1, "halo"), (1, "band"), (1, "dp"), (2, "halo"),
                                        (2, "dp")])
def test_restructured_steps_equal_the_eager_step_bit_for_bit(results, world, case):
    """Two steps with the learning rate changed between them: the trainer's
    step and the step on static buffers filled from the host against the eager step as it
    was called before (a float learning rate), loss, logs, parameters and
    optimizer state bit for bit; the second learning rate reached ``lr_t``."""
    for r in results[world]:
        assert r[case]["bit_for_bit"], (world, case)
        assert r[case]["lr_t"] == float(np.float32(LRS[1]))


@pytest.mark.parametrize("world,case", [(1, "halo"), (1, "dp"), (2, "halo"), (2, "dp")])
def test_steps_take_nothing_from_the_host_after_warm_up(results, world, case):
    """After a first run, the training and eval bodies that a capture
    records build no tensor from host data, read nothing from the device and
    copy nothing to the CPU (the learning rate is ``lr_t``; the collectives'
    tables are device tensors)."""
    for r in results[world]:
        assert r[case]["traffic"] == [], r[case]["traffic"]


def test_halo_input_names_are_the_packed_inputs(results):
    want = {"z", "node_mask", "Hon", "Hon0", "Son", "edge_vec", "z_src", "z_dst", "Hoff",
            "Hoff0", "Soff", "src_pos", "dst_local", "edge_mask_sh", "send_idx", "inv_pos",
            "edge_send_idx", "boundary_pos", "boundary_mask"}
    assert want <= set(results[2][0]["halo"]["input_names"])


def _assert_close_to_jax(got, ref):
    ref_loss, ref_mu = ref
    np.testing.assert_allclose(got["loss"], ref_loss, **LOSS_TOL)
    assert set(got["mu"]) == set(ref_mu)
    floor = NOISE * max(float(np.abs(v).max()) for v in ref_mu.values())
    for n, want in ref_mu.items():
        a = np.reshape(got["mu"][n], want.shape) / 0.1
        scale = float(np.abs(want).max(initial=0.0))
        if scale < floor:
            assert np.abs(a).max(initial=0.0) < floor, n
            continue
        assert np.abs(a - want).max() <= GRAD_TOL * scale, (n, float(np.abs(a - want).max()),
                                                            scale)


def test_halo_step_matches_the_jax_halo_step(results, jax_halo):
    """The two-process halo step (one crystal split 2 ways) against JAX's
    ``make_halo_train_step`` on every rank.  The data-parallel step is held
    to JAX's ``make_parallel_train_step`` by
    tests/test_torch_port_parallel.py::test_parallel_trainer_step_matches_jax,
    through the same ``ParallelTrainer.train_step``."""
    for r in results[2]:
        _assert_close_to_jax(r["halo"], jax_halo)
    assert results[2][0]["halo"]["mu"] == results[2][1]["halo"]["mu"]


@pytest.mark.parametrize("world", [1, 2])
def test_train_epoch_crystals_reads_once_and_keeps_its_value(results, world):
    for r in results[world]:
        dp = r["dp"]
        assert dp["epoch_mean"] == dp["epoch_mean_per_step"] and np.isfinite(dp["epoch_mean"])
        assert dp["epoch_same"] and dp["eval_same"]


if __name__ == "__main__":
    import torch.multiprocessing as mp

    from hamgnn_tpu_torch.parallel.multihost import free_port

    _run(1, 0, free_port(), sys.argv[1])
    mp.spawn(_worker, args=(2, free_port(), sys.argv[1]), nprocs=2)
