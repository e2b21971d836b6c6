"""The port's training path against the JAX package's.

* ``train.optim.Amsgrad`` against optax's ``clip_by_global_norm`` +
  ``amsgrad(learning_rate=1.0)`` (jitted, as the JAX trainer runs it) over
  5 steps on identical gradients, with and without clipping: the update
  and every state tensor at rtol 1e-6, the parameters at rtol 1e-6 with
  atol 1e-6 * lr (a parameter near zero keeps the rounding of its update);
* ``PlateauScheduler`` and ``EarlyStopping`` against the JAX classes on one
  metric sequence, exactly;
* the train batch order for ``default_rng(666)``, exactly;
* 3 trainer steps against the JAX ``Trainer`` on the same weights and
  batches: the step losses at rtol 1e-4 (the first is a forward at the
  model test's tolerance; amsgrad's first updates are ~lr * sign(g), so
  entries of g near zero that round differently move weights by ~2 lr, and
  lr is 1e-3 here);
* the non-finite guard, a checkpoint round trip, and ``stage: fit`` through
  the CLI on the CPU (metrics.jsonl, best.pt, predictions, warm start and
  resume, then ``stage: test`` from best.pt);
* what the captured step (``train/captured.py``) rests on, on the CPU: the
  learning rate as a device tensor (bit for bit the float form), the shape
  key (JAX's ``_shape_key``), static buffers that round-trip a batch, a
  step that builds nothing from host data and never waits for the device
  after its first run (under both engines), and the trainers that stay
  eager (CPU, band heads).  The captures themselves run on the card
  (``tests/test_torch_port_cuda.py``).
"""

import dataclasses
import json
import os
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from torch.utils._python_dispatch import TorchDispatchMode
from flax.traverse_util import flatten_dict
from util_fixtures import add_random_hamiltonian_targets, make_crystal

from hamgnn_tpu.cli import build_model as j_build
from hamgnn_tpu.data.dataset import GraphDataModule as JDataModule
from hamgnn_tpu.train import trainer as j_trainer
from hamgnn_tpu.train.config import load_config as j_load_config
from hamgnn_tpu_torch import cli as t_cli
from hamgnn_tpu_torch.data.dataset import GraphDataModule as TDataModule
from hamgnn_tpu_torch.data.dataset import reference_split, save_graph_npz
from hamgnn_tpu_torch.interfaces.jax_params import load_flax_params
from hamgnn_tpu_torch.train import captured
from hamgnn_tpu_torch.train import trainer as t_trainer
from hamgnn_tpu_torch.train.config import load_config
from hamgnn_tpu_torch.train.optim import Amsgrad, flatten_parameters

BASE = {
    "representation_nets": {"HamGNN_pre": {
        "irreps_node_features": "8x0e+4x1o+2x2e", "irreps_edge_sh": "0e+1o+2e",
        "num_layers": 1, "num_radial": 8, "cutoff": 4.0, "radial_MLP": [8],
        "num_types": 16}},
    "output_nets": {"HamGNN_out": {"nao_max": 14}},
}
LOSSES = [{"metric": "mae", "prediction": "hamiltonian", "target": "hamiltonian",
           "loss_weight": 27.211}]
METRICS = [{"metric": "mae", "prediction": "hamiltonian", "target": "hamiltonian"}]


def _merge(a, b):
    out = dict(a)
    for k, v in b.items():
        out[k] = _merge(a[k], v) if isinstance(v, dict) and k in a else v
    return out


def _crystals(n, seed):
    rng = np.random.default_rng(seed)
    return [add_random_hamiltonian_targets(
        rng, make_crystal(rng, n_atoms=3 + i % 2, cutoff=4.0), nao_max=14)
        for i in range(n)]


# ---------------------------------------------------------------------------
# optimizer, scheduler, early stop, batch order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clip", [0.0, 30.0])
def test_amsgrad_matches_optax(clip):
    rng = np.random.default_rng(0)
    n, lr = 1000, 3e-3
    p0 = rng.normal(size=n).astype(np.float32)
    grads = [(rng.normal(size=n) * rng.uniform(0.5, 2.0)).astype(np.float32)
             for _ in range(5)]
    if clip > 0:
        # the global norm is a sum taken in another order than XLA's (1-2 ulp
        # apart): keep each entry's sign across steps so the moments do not
        # cancel and that ulp stays an ulp
        sign = np.sign(rng.normal(size=n)).astype(np.float32)
        grads = [np.abs(g) * sign for g in grads]
    for g in grads:
        g[:7] = 0.0
        g[7:20] *= 1e-6
    base = [optax.clip_by_global_norm(clip)] if clip > 0 else []
    tx = optax.chain(*base, optax.amsgrad(learning_rate=1.0))
    update = jax.jit(tx.update)
    state, p = tx.init(jnp.asarray(p0)), jnp.asarray(p0)
    flat = torch.tensor(p0)
    opt = Amsgrad(n, "cpu", gradient_clip_val=clip)
    norms = []
    for g in grads:
        norms.append(float(np.linalg.norm(g)))
        upd, state = update(jnp.asarray(g), state, p)
        p = p + upd * lr
        np.testing.assert_allclose(opt.update(torch.tensor(g))[0].numpy(), np.asarray(upd),
                                   rtol=1e-6, atol=0, err_msg="update")
        assert bool(opt.step(flat, torch.tensor(g), lr))
        ams = state[-1][0]
        assert int(opt.count) == int(ams.count)
        for key in ("mu", "nu", "nu_max"):
            np.testing.assert_allclose(getattr(opt, key).numpy(), np.asarray(getattr(ams, key)),
                                       rtol=1e-6, atol=0, err_msg=key)
        # p + update * lr: a parameter near zero keeps the update's rounding
        # (XLA divides and takes roots to within an ulp, not bit for bit),
        # so its error is relative to the update there
        np.testing.assert_allclose(flat.numpy(), np.asarray(p), rtol=1e-6, atol=1e-6 * lr)
    if clip > 0:  # the clip both triggered and stood aside
        assert min(norms) < clip < max(norms)


def test_amsgrad_is_not_torch_amsgrad():
    """optax takes the max of the bias-corrected second moment; torch's
    AdamW(amsgrad=True) before the correction: they part at step 2."""
    g = [torch.tensor([1.0, 1.0]), torch.tensor([0.1, 3.0])]
    ours = torch.zeros(2)
    opt = Amsgrad(2, "cpu")
    theirs = torch.zeros(2, requires_grad=True)
    topt = torch.optim.AdamW([theirs], lr=1.0, weight_decay=0.0, amsgrad=True)
    for gi in g:
        opt.step(ours, gi, 1.0)
        theirs.grad = gi.clone()
        topt.step()
    assert not torch.allclose(ours, theirs.detach(), rtol=1e-3, atol=0)


def test_scheduler_and_early_stop_match_jax():
    seq = [1.0, 0.9, 0.9, 0.95, 0.9, 0.91, 0.92, 0.93, 0.94, 0.5, 0.5, 0.6, 0.7,
           0.8, 0.9, 1.0, 0.49, 0.49, 0.49, 0.49]
    js = j_trainer.PlateauScheduler(lr=0.01, factor=0.5, patience=2, cooldown=1)
    ts = t_trainer.PlateauScheduler(lr=0.01, factor=0.5, patience=2, cooldown=1)
    je, te = j_trainer.EarlyStopping(patience=3), t_trainer.EarlyStopping(patience=3)
    lrs = []
    for m in seq:
        lrs.append(ts.step(m))
        assert lrs[-1] == js.step(m)
        assert te.step(m) == je.step(m)
        assert (ts.best, ts.num_bad, ts.cooldown_counter) == \
            (js.best, js.num_bad, js.cooldown_counter)
    assert len(set(lrs)) > 2


def test_train_batch_order_matches_jax():
    crystals = _crystals(10, seed=3)
    jd = JDataModule(crystals, batch_size=2)
    td = TDataModule(crystals, batch_size=2, device="cpu")
    j_rng, t_rng = np.random.default_rng(666), np.random.default_rng(666)
    for _epoch in range(3):
        jb = list(jd.train_batches(j_rng))
        tb = list(td.train_batches(t_rng))
        assert len(jb) == len(tb) == 3
        for a, b in zip(jb, tb):
            np.testing.assert_array_equal(b.z.numpy(), np.asarray(a.z))
            np.testing.assert_array_equal(b.Hon.numpy(), np.asarray(a.Hon))


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

def _trainer_pair(tmp_path, clip=0.0):
    """The JAX trainer (flax init, seed 666) and the port's on the same
    weights; returns (jax trainer, port trainer, port data, jax data)."""
    cfg = j_load_config(None, overrides=BASE)
    crystals = _crystals(4, seed=4)
    kw = dict(losses=LOSSES, metrics=METRICS, lr=1e-3, gradient_clip_val=clip,
              min_epochs=0, max_epochs=2)
    jd = JDataModule(crystals, batch_size=2, train_ratio=1.0, val_ratio=0.0, test_ratio=0.0)
    jt = j_trainer.Trainer(j_build(cfg), train_dir=str(tmp_path / "jax"), **kw)
    jt.init_params(next(iter(jd.train_batches(np.random.default_rng(0)))))
    tm = t_cli.build_model(load_config(None, overrides=BASE))
    load_flax_params(tm, {"/".join(k): np.asarray(v)
                          for k, v in flatten_dict(jt.params["params"]).items()})
    tt = t_trainer.Trainer(tm, train_dir=str(tmp_path / "torch"), device="cpu", **kw)
    td = TDataModule(crystals, batch_size=2, train_ratio=1.0, val_ratio=0.0,
                     test_ratio=0.0, device="cpu")
    return jt, tt, jd, td


@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_trainer_steps_match_jax(tmp_path, clip):
    jt, tt, jd, td = _trainer_pair(tmp_path, clip)
    jb = list(jd.train_batches(np.random.default_rng(1)))
    tb = list(td.train_batches(np.random.default_rng(1)))
    j_losses, t_losses = [], []
    for step in range(3):
        j_losses.append(jt.train_epoch([jb[step % 2]]))
        loss, logs = tt.train_step(tb[step % 2])
        t_losses.append(float(loss))
        assert float(logs["nonfinite_step"]) == 0.0
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4, atol=0)
    assert j_losses[2] < j_losses[0]  # the steps moved the weights
    assert int(tt.opt.count) == 3


def _port_trainer(tmp_path, name, seed=0):
    tm = t_cli.build_model(load_config(None, overrides=BASE))
    from hamgnn_tpu_torch.models.model import init_weights

    init_weights(tm, seed)
    return t_trainer.Trainer(tm, losses=LOSSES, metrics=METRICS, lr=1e-3,
                             train_dir=str(tmp_path / name), device="cpu")


def _state(tr):
    return [tr.flat.clone()] + [t.clone() for t in tr.opt.state_dict().values()]


def test_nonfinite_step_is_dropped(tmp_path):
    tr = _port_trainer(tmp_path, "guard")
    td = TDataModule(_crystals(2, seed=5), batch_size=1, train_ratio=1.0,
                     val_ratio=0.0, test_ratio=0.0, device="cpu")
    good, bad = list(td.train_batches(np.random.default_rng(0)))
    tr.train_step(good)
    before = _state(tr)
    bad.Hon = torch.full_like(bad.Hon, float("nan"))
    loss, logs = tr.train_step(bad)
    assert not torch.isfinite(loss) and float(logs["nonfinite_step"]) == 1.0
    for a, b in zip(_state(tr), before):
        assert torch.equal(a, b)
    assert int(tr.opt.count) == 1
    # the epoch mean skips the dropped step and the count is reported
    assert np.isfinite(tr.train_epoch([good, bad])) and tr.nonfinite_steps == 1
    assert int(tr.opt.count) == 2


def test_nonfinite_gradient_is_dropped_by_the_optimizer():
    flat = torch.ones(4)
    opt = Amsgrad(4, "cpu")
    assert not bool(opt.step(flat, torch.tensor([1.0, float("inf"), 0.0, 1.0]), 0.1))
    assert torch.equal(flat, torch.ones(4)) and int(opt.count) == 0
    assert not bool(opt.step(flat, torch.ones(4), 0.1, loss=torch.tensor(float("nan"))))
    assert torch.equal(flat, torch.ones(4)) and float(opt.mu.abs().sum()) == 0.0


def test_flat_parameters_are_views(tmp_path):
    tr = _port_trainer(tmp_path, "views")
    params = list(tr.model.parameters())
    assert sum(p.numel() for p in params) == tr.flat.numel()
    with torch.no_grad():
        tr.flat.fill_(0.5)
    assert all(bool((p == 0.5).all()) for p in params)
    assert all(p.grad.data_ptr() >= tr.grad.data_ptr() for p in params)
    with pytest.raises(ValueError):
        flatten_parameters(torch.nn.Linear(2, 2).double())


def test_checkpoint_round_trip(tmp_path):
    td = TDataModule(_crystals(2, seed=6), batch_size=1, train_ratio=1.0,
                     val_ratio=0.0, test_ratio=0.0, device="cpu")
    batches = list(td.train_batches(np.random.default_rng(0)))
    a = _port_trainer(tmp_path, "a", seed=1)
    a.train_step(batches[0])
    a.sched.lr = 3e-4
    a.save_checkpoint(str(tmp_path / "ck.pt"))
    b = _port_trainer(tmp_path, "b", seed=2)
    b.load_checkpoint(str(tmp_path / "ck.pt"))
    assert b.sched.lr == 3e-4
    for x, y in zip(_state(a), _state(b)):
        assert torch.equal(x, y)
    la, _ = a.train_step(batches[1])
    lb, _ = b.train_step(batches[1])
    assert float(la) == float(lb)
    for x, y in zip(_state(a), _state(b)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# what the captured step rests on
# ---------------------------------------------------------------------------

def test_amsgrad_takes_a_device_learning_rate():
    """``Amsgrad.step`` with the learning rate as a 0-dim float32 tensor
    equals the float form bit for bit, the dropped step included; any other
    tensor is refused."""
    rng = np.random.default_rng(4)
    flat = {form: torch.as_tensor(rng.normal(size=64).astype(np.float32))
            for form in ("float", "tensor")}
    flat["tensor"] = flat["float"].clone()
    opts = {form: Amsgrad(64, "cpu", 1.0) for form in flat}
    lr_t = torch.tensor(0.0, dtype=torch.float32)
    for lr in (1e-3, 1e-3, 3.7e-4, 1e-3):
        g = torch.as_tensor(rng.normal(size=64).astype(np.float32))
        lr_t.fill_(lr)
        ok_f = opts["float"].step(flat["float"], g, lr)
        ok_t = opts["tensor"].step(flat["tensor"], g, lr_t)
        assert bool(ok_f) and bool(ok_t)
        assert torch.equal(flat["float"], flat["tensor"])
        for a, b in zip(opts["float"].state_dict().values(), opts["tensor"].state_dict().values()):
            assert torch.equal(a, b)
    bad = torch.full((64,), float("nan"))
    assert not bool(opts["tensor"].step(flat["tensor"], bad, lr_t))
    assert torch.equal(flat["float"], flat["tensor"])
    for wrong in (torch.tensor([1e-3]), torch.tensor(1e-3, dtype=torch.float64)):
        with pytest.raises(ValueError, match="0-dim float32"):
            opts["tensor"].step(flat["tensor"], bad, wrong)


def test_shape_key_is_the_jax_trainers():
    """One captured graph per (nodes, edges, graphs), as the JAX trainer
    caches one program per ``_shape_key``, on the same batches."""
    crystals = _crystals(5, seed=11)
    jd = JDataModule(crystals, batch_size=2)
    td = TDataModule(crystals, batch_size=2, device="cpu")
    keys = []
    for a, b in zip(jd.train_batches(np.random.default_rng(1)),
                    td.train_batches(np.random.default_rng(1))):
        keys.append(captured.shape_key(b))
        assert keys[-1] == j_trainer.Trainer._shape_key(None, a)
        assert all(isinstance(v, int) for v in keys[-1])
    assert len(keys) == 2


def test_static_buffers_round_trip_a_batch():
    """``static_graph`` holds its own copy of every tensor field (the fields
    that are None stay None); ``copy_into`` moves another batch of the same
    shapes into it whole, and refuses one of other shapes or fields."""
    td = TDataModule(_crystals(4, seed=12), batch_size=1, train_ratio=1.0, val_ratio=0.0,
                     test_ratio=0.0, edge_quantum=512, node_quantum=16, device="cpu")
    batches = list(td.train_batches(np.random.default_rng(2)))
    same = [g for g in batches if captured.shape_key(g) == captured.shape_key(batches[0])]
    assert len(same) >= 2
    first, second = same[0], same[1]
    static = captured.static_graph(first)
    fields = captured.tensor_fields(first)
    assert set(captured.tensor_fields(static)) == set(fields) and "Hon" in fields
    assert static.spin_vec is None and first.spin_vec is None
    for name, t in fields.items():
        s_ = getattr(static, name)
        assert torch.equal(s_, t) and s_.data_ptr() != t.data_ptr() and s_.is_contiguous()
    ptrs = {n: t.data_ptr() for n, t in captured.tensor_fields(static).items()}
    captured.copy_into(static, second)
    for name, t in captured.tensor_fields(second).items():
        assert torch.equal(getattr(static, name), t)
        assert getattr(static, name).data_ptr() == ptrs[name]
    other = [g for g in batches if captured.shape_key(g) != captured.shape_key(first)]
    wider = other[0] if other else dataclasses.replace(first, z=torch.cat([first.z, first.z]))
    with pytest.raises(ValueError, match="other fields"):
        captured.copy_into(static, wider)
    with pytest.raises(ValueError, match="other fields"):
        captured.copy_into(static, dataclasses.replace(second, Hon=None))


def test_cpu_trainer_does_not_capture(tmp_path):
    tr = _port_trainer(tmp_path, "cpu")
    assert tr.captured is None and tr.lr_t.device.type == "cpu"
    tm = t_cli.build_model(load_config(None, overrides=BASE))
    with pytest.raises(ValueError, match="needs the card"):
        t_trainer.Trainer(tm, losses=LOSSES, metrics=METRICS, train_dir=str(tmp_path / "c"),
                          device="cpu", capture=True)


def test_band_trainer_stays_eager(tmp_path):
    """A head that computes bands reads counts and draws k-points on the
    host: its trainer never captures, and asking for it raises."""
    cfg = _merge(BASE, {"output_nets": {"HamGNN_out": {
        "calculate_band_energy": True, "num_k": 2, "band_num_control": 4}}})
    tm = t_cli.build_model(load_config(None, overrides=cfg))
    assert tm.output.calculate_band_energy
    tr = t_trainer.Trainer(tm, losses=LOSSES, metrics=[], train_dir=str(tmp_path / "b"),
                           device="cpu")
    assert tr.captured is None
    with pytest.raises(ValueError, match="band"):
        t_trainer.Trainer(tm, losses=LOSSES, metrics=[], train_dir=str(tmp_path / "b2"),
                          device="cpu", capture=True)


class _HostTraffic(TorchDispatchMode):
    """Records, by the port's source line, every op of a step that builds a
    tensor from host data (``lift_fresh``: ``torch.tensor``, a list index) or
    waits for the device (a scalar read, ``nonzero``, a boolean index,
    ``unique``): none of them can be captured in a CUDA graph."""

    SYNCS = (torch.ops.aten._local_scalar_dense.default, torch.ops.aten.nonzero.default,
             torch.ops.aten.masked_select.default)

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        bool_index = func is torch.ops.aten.index.Tensor and any(
            i is not None and i.dtype == torch.bool for i in args[1])
        if func is torch.ops.aten.lift_fresh.default or func in self.SYNCS or bool_index \
                or "unique" in func.name():
            self.seen.append((func.name(), _port_line()))
        return func(*args, **(kwargs or {}))


def _port_line():
    frames = [f for f in traceback.extract_stack() if "hamgnn_tpu_torch" in f.filename]
    return f"{frames[-1].filename.split('hamgnn_tpu_torch')[-1]}:{frames[-1].lineno}" \
        if frames else "?"


@pytest.mark.parametrize("engine", ["auto", "zonal"])
def test_steps_take_nothing_from_the_host_after_warm_up(tmp_path, monkeypatch, engine):
    """After a first training and eval step (the warm-up of a capture),
    neither step builds a tensor from host data (``torch.tensor``,
    ``as_tensor``, ``from_numpy``, a list index) nor reads a device value on
    the host: what a CUDA graph can capture.  SH up to l = 4, both
    engines."""
    if engine != "auto":
        monkeypatch.setenv("HAMGNN_TP_ENGINE", engine)
    cfg = _merge(BASE, {"representation_nets": {"HamGNN_pre": {
        "irreps_edge_sh": "0e+1o+2e+3o+4e"}}})
    tm = t_cli.build_model(load_config(None, overrides=cfg))
    from hamgnn_tpu_torch.models.model import init_weights

    init_weights(tm, 0)
    tr = t_trainer.Trainer(tm, losses=LOSSES, metrics=METRICS, lr=1e-3,
                           train_dir=str(tmp_path / engine), device="cpu")
    td = TDataModule(_crystals(2, seed=13), batch_size=2, train_ratio=1.0, val_ratio=0.0,
                     test_ratio=0.0, device="cpu")
    g = next(iter(td.train_batches(np.random.default_rng(0))))

    def steps():  # the bodies a capture records: the step at the device rate, the eval
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


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _write_config(path, cfg):
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def test_cli_fit_then_test(tmp_path):
    crystals = _crystals(3, seed=7)
    save_graph_npz(str(tmp_path / "graph_data.npz"), crystals)
    out = tmp_path / "out"
    split = {"graph_data_path": str(tmp_path), "batch_size": 1, "train_ratio": 1 / 3,
             "val_ratio": 1 / 3, "test_ratio": 1 / 3}
    optim = {"lr": 1e-3, "min_epochs": 0, "max_epochs": 2}
    fit = _merge(BASE, {"setup": {"stage": "fit", "use_gradient_checkpointing": True},
                        "dataset_params": split, "optim_params": optim,
                        "profiler_params": {"train_dir": str(out)}})
    t_cli.main(["--config", _write_config(tmp_path / "fit.yaml", fit), "--device", "cpu"])
    records = [json.loads(l) for l in open(out / "metrics.jsonl")]
    assert [r["epoch"] for r in records] == [0, 1]
    assert set(records[0]) == {"epoch", "train_loss", "val_loss", "lr", "sec",
                               "val/mae_hamiltonian"}
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"]) for r in records)
    pred = np.load(out / "prediction_hamiltonian.npy")
    assert pred.shape[1] == 196 and np.isfinite(pred).all()
    assert os.path.exists(out / "best.pt")

    # stage test from best.pt: the predictions of the best weights
    test = _merge(fit, {"setup": {"stage": "test", "checkpoint_path": str(out / "best.pt")},
                        "profiler_params": {"train_dir": str(tmp_path / "test")}})
    t_cli.main(["--config", _write_config(tmp_path / "test.yaml", test), "--device", "cpu"])
    best = min(records, key=lambda r: r["val_loss"])["epoch"]
    again = np.load(tmp_path / "test" / "prediction_hamiltonian.npy")
    rows = [c["z"].shape[0] + c["edge_index"].shape[1] for c in crystals]
    assert again.shape == (sum(rows), 196) and np.isfinite(again).all()
    if best == 1:  # the final weights were the best: the fit's test crystal
        k = reference_split(3, 1 / 3, 1 / 3, 1 / 3)[2][0]
        np.testing.assert_array_equal(again[sum(rows[:k]) : sum(rows[: k + 1])], pred)

    # warm start resets the LR to optim_params.lr; resume keeps the checkpoint's
    ck = torch.load(out / "best.pt")
    ck["lr"] = 0.123
    torch.save(ck, tmp_path / "resume.pt")
    for resume, lr in ((False, 1e-3), (True, 0.123)):
        d = tmp_path / f"resume_{resume}"
        cfg = _merge(fit, {"setup": {"load_from_checkpoint": True, "resume": resume,
                                     "checkpoint_path": str(tmp_path / "resume.pt")},
                           "optim_params": {"max_epochs": 1},
                           "profiler_params": {"train_dir": str(d)}})
        t_cli.main(["--config", _write_config(tmp_path / f"r{resume}.yaml", cfg),
                    "--device", "cpu"])
        rec = json.loads(open(d / "metrics.jsonl").readline())
        assert rec["lr"] == lr
