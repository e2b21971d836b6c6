"""The halo exchange in flight (``parallel/halo.py`` ``halo_recv_start`` /
``halo_recv_finish``), on the CPU over gloo.

One spawn of two gloo processes computes every case and writes one JSON;
the tests read it through a module fixture.  The workers import torch and
the port, never JAX; the JAX reference is computed in this process while
they run.  The model: two ConvE3 layers at narrow widths, the plain head,
one crystal split 2 ways (a 1 x 2 mesh), inputs made from a numpy seed.

* the in-flight path (``exchange="async"``) against the exchange done before
  the interior pass (``exchange="sync"``, the path before the overlap was
  scheduled): the Hamiltonian, the loss and the reduced flat gradient equal
  bit for bit (``torch.equal``), with and without gradient checkpointing,
  and with the split forced on graph groups of one rank (a 2 x 1 mesh);
* the order of the calls: every in-flight all-to-all of the forward is
  issued before its layer's interior pass and waited on after it, and every
  reverse all-to-all of the backward is issued before the interior pass's
  backward and waited on after it (``all_to_all_single`` wrapped so that
  its handle records ``wait()``; module hooks record the interior pass);
* ``HaloTrainer``'s step under both exchanges bit for bit, and against the
  JAX package's ``make_halo_train_step`` (``hamgnn_tpu/parallel/halo_model.py``)
  on the same weights: the loss (atol 5e-5 / rtol 1e-4) and amsgrad's first
  moment, 0.1 x the gradient, per tensor within 5e-4 x max|ref| (PERF.md
  section 2; inside tests/test_torch_parity.py's atol 5e-4 / rtol 1e-3);
* no fallback: an all-to-all that cannot be issued fails the step.
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
FEAT = "2x0e+1x1o+1x2e"
SH = "0e + 1o + 2e"
LOSS_TOL = dict(atol=5e-5, rtol=1e-4)
GRAD_TOL = 5e-4
NOISE = 1e-6   # fp32 rounding relative to the largest gradient
LAYERS = 2
REP = dict(num_types=20, irreps_edge_sh=SH, irreps_node_features=FEAT, num_layers=LAYERS,
           num_radial=6, rbf_func="bessel", cutoff=4.0, radial_mlp=(8,))
HEAD = dict(irreps_in_node=FEAT, irreps_in_edge=FEAT, nao_max=14, ham_type="openmx",
            ham_only=True, symmetrize=True, add_H0=True, zero_point_shift=True)
HAM = [{"metric": "mae", "prediction": "hamiltonian", "target": "hamiltonian",
        "loss_weight": 27.211}]
LR = 0.01


def crystals(n):
    from hamgnn_tpu_torch.data.synthetic import add_random_hamiltonian_targets, make_crystal

    rng = np.random.default_rng(3)
    return [add_random_hamiltonian_targets(
        rng, make_crystal(rng, n_atoms=a, species=(6, 14), cell_size=5.0, cutoff=4.0),
        nao_max=14) for a in (6, 5)[:n]]


def port_model(checkpointed=False):
    from hamgnn_tpu_torch.models.model import HamGNNModel, init_weights
    from hamgnn_tpu_torch.models.output import HamGNNPlusPlusOut
    from hamgnn_tpu_torch.models.representation import HamGNNConvE3

    rep = HamGNNConvE3(**REP, use_gradient_checkpointing=checkpointed)
    return init_weights(HamGNNModel(rep, HamGNNPlusPlusOut(**HEAD)), 0)


def packed(n):
    """Halo inputs of the first ``n`` crystals, each split 2 / n ways."""
    from hamgnn_tpu_torch.data.graph import pad_and_batch
    from hamgnn_tpu_torch.parallel.halo_model import stack_halo_inputs

    return stack_halo_inputs([pad_and_batch([c], node_bucket=8, edge_bucket=256)
                              for c in crystals(n)], 2 // n)


# --- the workers -----------------------------------------------------------

def _step(mesh, exchange, checkpointed=False, split=None):
    """The halo forward, loss and backward of this rank's crystal: (the
    Hamiltonian rows, the loss, the reduced flat gradient)."""
    from hamgnn_tpu_torch.models.model import compute_losses
    from hamgnn_tpu_torch.parallel.halo_model import halo_view, local_inputs
    from hamgnn_tpu_torch.parallel.sharding import reduce_gradient

    model = port_model(checkpointed)
    loc = local_inputs(packed(mesh.n_data), mesh.n_graph, mesh.graph_rank, "cpu",
                       data_row=mesh.data_rank)
    view = halo_view(loc, mesh.graph_group, split=split, exchange=exchange)
    preds = model.forward_view(view)
    total, _ = compute_losses(preds, view, HAM, psum=view.psum)
    (total / mesh.n_graph).backward()
    flat = torch.cat([p.grad.reshape(-1) for p in model.parameters()])
    reduce_gradient(mesh, flat)
    ham = torch.cat([preds["hamiltonian_on"].reshape(-1), preds["hamiltonian_off"].reshape(-1)])
    return ham.detach(), total.detach(), flat


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


class _Recorded:
    """A collective's handle whose ``wait()`` is written to the log."""

    def __init__(self, work, k, log):
        self.work, self.k, self.log = work, k, log

    def wait(self):
        self.log.append(["wait", self.k])
        return self.work.wait()


def _order(mesh, exchange, monkeypatch):
    """The log of one forward and backward: ``issue k`` / ``wait k`` of the
    in-flight all-to-alls, ``sync`` for a blocking one, ``interior`` when a
    layer's interior message pass has run and ``interior_grad`` when its
    backward has reached the pass's source rows (``conv_tp`` of
    ``conv_i`` / ``pair_i`` called on rows of ``gather_src_interior``; the
    boundary pass's come from the exchange), ``backward`` where the backward
    starts."""
    import re

    import torch.distributed as dist

    from hamgnn_tpu_torch.models.model import compute_losses
    from hamgnn_tpu_torch.parallel.halo_model import halo_view, local_inputs

    log, real = [], dist.all_to_all_single

    def recorded(out, x, *args, async_op=False, **kw):
        work = real(out, x, *args, async_op=async_op, **kw)
        if not async_op:
            log.append(["sync", None])
            return work
        k = sum(e[0] == "issue" for e in log)
        log.append(["issue", k])
        return _Recorded(work, k, log)

    model = port_model()
    view = halo_view(local_inputs(packed(1), 2, mesh.graph_rank, "cpu", data_row=0),
                     mesh.graph_group, exchange=exchange)
    interior, gather = [], view.gather_src_interior
    view.gather_src_interior = lambda rows: interior.append(gather(rows)) or interior[-1]

    def hook(name):
        def fwd(mod, args, out):
            if any(args[0] is t for t in interior):
                log.append(["interior", name])
                args[0].register_hook(lambda g: log.append(["interior_grad", name]))
        return fwd

    for name, mod in model.named_modules():
        if re.fullmatch(r"representation\.(conv|pair)_\d+\.conv_tp", name):
            mod.register_forward_hook(hook(name.split(".")[1]))
    monkeypatch.setattr(dist, "all_to_all_single", recorded)
    total, _ = compute_losses(model.forward_view(view), view, HAM, psum=view.psum)
    log.append(["backward", None])
    (total / 2).backward()
    monkeypatch.undo()
    return log


def _fails(mesh, monkeypatch):
    """The in-flight step with an all-to-all that cannot be issued: what it
    raised (it must not take the blocking path)."""
    import torch.distributed as dist

    def refused(out, x, *args, async_op=False, **kw):
        if async_op:
            raise RuntimeError("the collective was refused")
        raise AssertionError("the blocking all-to-all was called")

    monkeypatch.setattr(dist, "all_to_all_single", refused)
    try:
        _step(mesh, "async")
        return "no error"
    except Exception as exc:
        return f"{type(exc).__name__}: {exc}"
    finally:
        monkeypatch.undo()


def _trainer(mesh, exchange, work):
    """``HaloTrainer.train_step`` at LR: (loss, first moment by name, state)."""
    from hamgnn_tpu_torch.parallel.halo_trainer import HaloTrainer

    tr = HaloTrainer(port_model(), losses=HAM, metrics=[], lr=LR, device="cpu", n_data=1,
                     n_graph=2, exchange=exchange,
                     train_dir=os.path.join(work, f"trainer_{exchange}"))
    loss, logs = tr.train_step(packed(1))
    names = [n for n, _ in tr.model.named_parameters()]
    mu = tr.opt.mu.split([p.numel() for p in tr.model.parameters()])
    return loss, logs, [tr.flat, *tr.opt.state_dict().values()], {
        "loss": float(loss), "mu": {n: m.tolist() for n, m in zip(names, mu)}}


def _run(rank, world, port, work):
    import torch.distributed as dist

    from hamgnn_tpu_torch.parallel.sharding import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        split2, split1 = make_mesh(1, 2), make_mesh(2, 1)
        res = {"equal": {}}
        for tag, mesh, kw in (("plain", split2, {}),
                              ("checkpointed", split2, {"checkpointed": True}),
                              ("world1_split", split1, {"split": True})):
            a, s = _step(mesh, "async", **kw), _step(mesh, "sync", **kw)
            res["equal"][tag] = {"hamiltonian": torch.equal(a[0], s[0]),
                                 "loss": torch.equal(a[1], s[1]),
                                 "gradient": torch.equal(a[2], s[2]),
                                 "finite": bool(torch.isfinite(a[2]).all())}
        with pytest.MonkeyPatch.context() as m:
            res["order"] = {ex: _order(split2, ex, m) for ex in ("async", "sync")}
            res["refused"] = _fails(split2, m)
        la, ga, sa, res["trainer_async"] = _trainer(split2, "async", work)
        ls, gs, ss, _ = _trainer(split2, "sync", work)
        res["trainer_equal"] = bool(torch.equal(la, ls) and ga.keys() == gs.keys()
                                    and all(torch.equal(ga[k], gs[k]) for k in ga)
                                    and _same(sa, ss))
        res["jax_imported"] = any(m == "jax" or m.startswith(("jax.", "hamgnn_tpu."))
                                  for m in sys.modules)
        every = [None] * world
        dist.all_gather_object(every, res)
        if rank == 0:
            with open(os.path.join(work, "async.json"), "w") as f:
                json.dump(every, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


# --- the JAX reference (this process) and the fixtures -------------------------

@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    work = tmp_path_factory.mktemp("halo_async")
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


@pytest.fixture(scope="module")
def jax_halo(spawned):
    """The JAX halo step (the crystal split 2 ways, a 1 x 2 mesh of the
    virtual CPU devices) on the port's weights at LR: (loss, first moment /
    0.1 by name); compiled without most of XLA's optimizations."""
    import jax
    import jax.numpy as jnp
    import optax
    from flax.traverse_util import flatten_dict
    from jax.flatten_util import ravel_pytree
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
        _, state, loss, _ = make_halo_train_step(model, tx, HAM, mesh, data_axis="data")(
            _jax_params(), init_flat_opt_state(tx, _jax_params()), inputs,
            jnp.asarray(LR, jnp.float32))
        mu = [s for s in jax.tree_util.tree_leaves(state, is_leaf=lambda x: hasattr(x, "mu"))
              if hasattr(s, "mu")][0].mu
        _, unravel = ravel_pytree(_jax_params())
        return float(loss), {".".join(k): np.asarray(v) for k, v in
                             flatten_dict(unravel(np.asarray(mu) / 0.1)["params"]).items()}
    finally:
        jax.config.update("jax_disable_most_optimizations", prev)


@pytest.fixture(scope="module")
def results(spawned, jax_halo):
    proc, work = spawned
    log, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, log.decode(errors="replace")[-4000:]
    with open(os.path.join(work, "async.json")) as f:
        return json.load(f)


# --- the tests -----------------------------------------------------------------

def test_workers_import_no_jax(results):
    assert not any(r["jax_imported"] for r in results)


@pytest.mark.parametrize("case", ["plain", "checkpointed", "world1_split"])
def test_in_flight_exchange_equals_the_blocking_one_bit_for_bit(results, case):
    for r in results:
        assert r["equal"][case] == {"hamiltonian": True, "loss": True, "gradient": True,
                                    "finite": True}


def _spans(log):
    """(issue index, wait index, the events between) of each in-flight
    exchange k, in the order of issue."""
    at = {(kind, k): i for i, (kind, k) in enumerate(log)}
    ks = [k for kind, k in log if kind == "issue"]
    return [(at[("issue", k)], at[("wait", k)], log[at[("issue", k)] + 1: at[("wait", k)]])
            for k in ks]


@pytest.mark.parametrize("rank", [0, 1])
def test_exchange_is_in_flight_while_the_interior_pass_runs(results, rank):
    """Forward: each of the 2 x LAYERS exchanges is issued, then its layer's
    interior pass runs, then it is waited on, one in flight at a time.
    Backward: each reverse exchange is issued, then the interior pass's
    backward reaches its source rows, then it is waited on.  The blocking
    path issues no in-flight collective."""
    log = [tuple(e) for e in results[rank]["order"]["async"]]
    start = log.index(("backward", None))
    spans = _spans(log)
    assert len(spans) == 4 * LAYERS
    fwd = [s for s in spans if s[1] < start]
    bwd = [s for s in spans if s[0] > start]
    assert len(fwd) == len(bwd) == 2 * LAYERS
    blocks = [f"{b}_{i}" for i in range(LAYERS) for b in ("conv", "pair")]
    for (i, j, between), block in zip(fwd, blocks):
        assert i < j and [e for e in between if e[0] != "sync"] == [("interior", block)]
    for (i, j, between), block in zip(bwd, blocks[::-1]):
        assert i < j and [e for e in between if e[0] != "sync"] == [("interior_grad", block)]
    sync = [tuple(e) for e in results[rank]["order"]["sync"]]
    assert not any(kind in ("issue", "wait") for kind, _ in sync)
    # the blocking path runs the same passes
    assert [e for e in sync if e[0].startswith("interior")] == \
        [e for e in log if e[0].startswith("interior")]


def test_refused_collective_fails_the_step(results):
    for r in results:
        assert r["refused"] == "RuntimeError: the collective was refused"


def test_trainer_step_equals_blocking_and_matches_the_jax_halo_step(results, jax_halo):
    ref_loss, ref_mu = jax_halo
    for r in results:
        assert r["trainer_equal"]
        got = r["trainer_async"]
        np.testing.assert_allclose(got["loss"], ref_loss, **LOSS_TOL)
        assert set(got["mu"]) == set(ref_mu)
        floor = NOISE * max(float(np.abs(v).max()) for v in ref_mu.values())
        for n, want in ref_mu.items():
            a = np.reshape(got["mu"][n], want.shape) / 0.1
            scale = float(np.abs(want).max(initial=0.0))
            if scale < floor:
                assert np.abs(a).max(initial=0.0) < floor, n
                continue
            assert np.abs(a - want).max() <= GRAD_TOL * scale, (
                n, float(np.abs(a - want).max()), scale)
    assert results[0]["trainer_async"]["mu"] == results[1]["trainer_async"]["mu"]


# --- in this process ----------------------------------------------------------

def test_start_without_a_handle_raises(monkeypatch):
    """A rank outside the group gets no handle from ``all_to_all_single``:
    the start raises instead of going on without the rows."""
    import torch.distributed as dist

    from hamgnn_tpu_torch.parallel.halo import halo_recv_start

    monkeypatch.setattr(dist, "all_to_all_single", lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="no handle"):
        halo_recv_start(torch.zeros(4, 3), torch.zeros(1, 2, dtype=torch.long), None)


def test_exchange_name_is_checked():
    from hamgnn_tpu_torch.parallel.halo_model import halo_view

    with pytest.raises(ValueError, match="exchange 'overlap'"):
        halo_view({}, None, exchange="overlap")


if __name__ == "__main__":
    import torch.multiprocessing as mp

    from hamgnn_tpu_torch.parallel.multihost import free_port

    mp.spawn(_run, args=(2, free_port(), sys.argv[1]), nprocs=2)
