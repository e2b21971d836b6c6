#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``hamgnn_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the result lines are printed):
  1. build every kernel of the port from ``hamgnn_tpu_torch/csrc`` (one nvcc
     per source, all started together) and print the card's name and power
     limit as nvidia-smi reports them;
  2. hold each kernel against its plain PyTorch version at the shapes the
     main path gives it (bench widths, E = 19,968 padded edges), with
     max|kernel - plain| <= 1e-4 * max|plain| in fp32 (only the summation
     order differs), and time both with CUDA events: the forward kernel
     (B1) against ``plain_apply``; the backward kernel (B2) against
     ``plain_backward`` (dx, dw, d(flat_w) at the pair, node and edge plans,
     dsh at the pair plan), and a second launch bit-identical to the first;
  3. drive the prediction path: one ``HamGNNModel`` forward at the
     ``bench.py`` width on the ``bench.py`` 512-atom crystal, random weights
     from a seeded ``torch.Generator``; B1 must launch 13 times at 3 layers,
     the outputs must be finite and agree with the same model run through
     the plain version, within the tolerance of phase 2; the forward is
     timed, and a torch.profiler pass writes device time by kernel per
     forward to chiprun_out/profile_forward.txt;
  4. drive the training path (the ``bench.py`` step: masked MAE x 27.211 on
     ``hamiltonian``, amsgrad at lr 1e-3, no gradient checkpointing) through
     ``train.trainer.Trainer``: one step must launch B1 and B2 13 times each;
     the parameter gradients must agree with the same model's through the
     plain TP, per tensor within 1e-3 * max|ref|; 5 steps are timed
     (edges/s, median) and a torch.profiler pass writes device time by
     kernel per step to chiprun_out/profile_train_step.txt;
  5. run the CLI end to end: ``stage: test`` on a few small crystals
     (``prediction_hamiltonian.npy`` / ``target_hamiltonian.npy``), then
     ``stage: fit`` for two epochs (``metrics.jsonl``, ``best.pt``,
     predictions) and ``stage: test`` from its ``best.pt``;
  6. print one JSON line describing each kernel, then the result line
     ``{"ok": true, "device": {...}}`` last.

It needs one card, imports nothing of JAX or of the JAX package, writes only
under ``build/`` in the checkout, and exits non-zero without a result when
``torch.cuda.is_available()`` is false.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
TOL = 1e-4        # max|kernel - plain| <= TOL * max|plain|, fp32
GRAD_TOL = 1e-3   # model gradients, kernel path vs plain-TP path, per tensor
E_BENCH = 19_968  # bench.py crystal: 19,672 edges padded to a multiple of 512
BENCH_CFG = {
    "representation_nets": {"HamGNN_pre": {
        "irreps_node_features": "64x0e+32x0o+24x1o+12x1e+12x2e+6x2o+4x3o+4x3e+2x4e",
        "irreps_edge_sh": "0e + 1o + 2e + 3o + 4e",
        "num_layers": 3, "num_radial": 64, "cutoff": 7.0,
        "radial_MLP": [64, 64], "num_types": 96,
    }},
    "output_nets": {"HamGNN_out": {"nao_max": 19, "zero_point_shift": False}},
}
BENCH_LOSSES = [{"metric": "mae", "prediction": "hamiltonian", "target": "hamiltonian",
                 "loss_weight": 27.211}]
KERNEL_SOURCES = {
    "packed_tp_fwd": ("hamgnn_tpu_torch/csrc/packed_tp_fwd.cu",
                      "hamgnn_tpu/e3/pallas_tp.py:582"),
    "packed_tp_bwd": ("hamgnn_tpu_torch/csrc/packed_tp_bwd.cu",
                      "hamgnn_tpu/e3/pallas_tp.py:637"),
}


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def rel_err(out, ref):
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    return err, scale


def phase_build(tp_kernel):
    t0 = time.perf_counter()
    built = tp_kernel.build_kernels(list(tp_kernel.KERNELS))
    for name, (path, log) in built.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    print(f"[build] {len(built)} kernel(s) in {time.perf_counter() - t0:.1f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    return card


def bench_plans():
    from hamgnn_tpu_torch.e3.irreps import Irreps
    from hamgnn_tpu_torch.e3.packed_tp import get_plan

    cfg = BENCH_CFG["representation_nets"]["HamGNN_pre"]
    feat = Irreps(cfg["irreps_node_features"])
    sh = Irreps(cfg["irreps_edge_sh"])
    comb = Irreps([(2 * m, ir) for m, ir in feat])
    mk = lambda xin: get_plan(repr(Irreps(xin)), repr(sh), repr(feat), repr(feat))  # noqa: E731
    # (name, plan, radial weights present, launches per forward at 3 layers)
    return [("pair", mk(f"{cfg['num_types']}x0e"), True, 1),
            ("pair_lite", mk(f"{cfg['num_types']}x0e"), False, 0),
            ("node", mk(comb), True, 6),
            ("edge", mk(feat), True, 6)]


def phase_kernels(tp_kernel, dev):
    import numpy as np
    import torch

    from hamgnn_tpu_torch.e3.packed_tp import plain_apply

    rows = []
    for name, plan, has_w, per_fwd in bench_plans():
        spec = tp_kernel.get_spec(plan)
        rng = np.random.default_rng(7)
        E = E_BENCH

        def t(*shape):
            return torch.as_tensor(rng.normal(size=shape).astype(np.float32), device=dev)

        x, sh = t(E, spec.d_in), t(E, spec.S)
        w = t(E, spec.n_ch) if has_w else None
        fw = t(plan.linear_numel)
        with torch.inference_mode():
            ref = plain_apply(plan, x, sh, w, fw)
            out = tp_kernel.packed_tp_forward(plan, x, sh, w, fw)
            torch.cuda.synchronize()
            err, scale = rel_err(out, ref)
            if not math.isfinite(err) or err > TOL * scale:
                fail(f"packed_tp_fwd[{name}]: max|d| {err:.3e} > {TOL} * {scale:.3e}")
            ms = cuda_time_ms(lambda: tp_kernel.packed_tp_forward(plan, x, sh, w, fw), 20)
            plain_ms = cuda_time_ms(lambda: plain_apply(plan, x, sh, w, fw), 5)
        bound, bound_by = spec.bound_ms(E, has_w)
        flops, nbytes = spec.work(E, has_w)
        rows.append(dict(plan=name, E=E, has_w=has_w, launches_per_forward=per_fwd,
                         max_abs_err=err, max_abs_ref=scale, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound, bound_by=bound_by, gflop=flops / 1e9,
                         mbytes=nbytes / 1e6,
                         achieved_tflops=flops / (ms * 1e-3) / 1e12))
        print(f"[kernel] packed_tp_fwd {name:9s} E={E} max|d|={err:.3e} "
              f"(max|ref| {scale:.3e}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"bound {bound:.4f} ms ({bound_by})", flush=True)
        del x, sh, w, fw, ref, out
    torch.cuda.empty_cache()
    return rows


def phase_bwd_kernels(tp_kernel, dev):
    """B2 against ``plain_backward`` at the bench plans, a repeat
    bit-identical, CUDA-event times and bounds."""
    import numpy as np
    import torch

    from hamgnn_tpu_torch.e3.packed_tp import plain_backward

    rows = []
    for name, plan, has_w, per_step in bench_plans():
        if not has_w:  # lite mode is not on the bench training path
            continue
        spec = tp_kernel.get_spec(plan)
        need_dsh = name == "pair"
        rng = np.random.default_rng(8)
        E = E_BENCH

        def t(*shape):
            return torch.as_tensor(rng.normal(size=shape).astype(np.float32), device=dev)

        x, sh, w, fw, gy = (t(E, spec.d_in), t(E, spec.S), t(E, spec.n_ch),
                            t(plan.linear_numel), t(E, spec.d_out))
        args = (plan, x, sh, w, fw, gy, need_dsh)
        got = tp_kernel.packed_tp_backward(*args)
        again = tp_kernel.packed_tp_backward(*args)
        ref = plain_backward(*args)
        torch.cuda.synchronize()
        errs = {}
        for key, a, b, c in zip(("dx", "dsh", "dw", "dflat_w"), got, again, ref):
            if c is None:
                if a is not None:
                    fail(f"packed_tp_bwd[{name}]: {key} returned where none was asked")
                continue
            if not torch.equal(a, b):
                fail(f"packed_tp_bwd[{name}]: {key} differs between two launches")
            err, scale = rel_err(a, c)
            if not math.isfinite(err) or err > TOL * scale:
                fail(f"packed_tp_bwd[{name}] {key}: max|d| {err:.3e} > {TOL} * {scale:.3e}")
            errs[key] = (err, scale)
        del got, again, ref
        timed = (plan, x, sh, w, fw, gy, False)
        ms = cuda_time_ms(lambda: tp_kernel.packed_tp_backward(*timed), 10)
        plain_ms = cuda_time_ms(lambda: plain_backward(*timed), 3)
        bound, bound_by = spec.bound_bwd_ms(E, True)
        flops, nbytes = spec.work_bwd(E, True)
        rows.append(dict(plan=name, E=E, launches_per_step=per_step,
                         max_abs_err=max(e for e, _ in errs.values()),
                         errors={k: list(v) for k, v in errs.items()},
                         ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                         gflop=flops / 1e9, mbytes=nbytes / 1e6,
                         achieved_tflops=flops / (ms * 1e-3) / 1e12))
        print(f"[kernel] packed_tp_bwd {name:9s} E={E} "
              + ", ".join(f"{k} max|d|={e:.3e} (max|ref| {s_:.3e})" for k, (e, s_) in errs.items())
              + f"; bit-identical repeat; kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"bound {bound:.4f} ms ({bound_by})", flush=True)
        del x, sh, w, fw, gy
    torch.cuda.empty_cache()
    return rows


def phase_model(tp_kernel, dev, card):
    import numpy as np
    import torch

    from hamgnn_tpu_torch.cli import build_model
    from hamgnn_tpu_torch.e3.packed_tp import plain_apply
    from hamgnn_tpu_torch.models.model import init_weights
    from hamgnn_tpu_torch.train.config import load_config

    graph, n_edges = bench_graph(dev)
    model = build_model(load_config(None, overrides=BENCH_CFG))
    init_weights(model, 0).to(dev).eval()
    layers = BENCH_CFG["representation_nets"]["HamGNN_pre"]["num_layers"]
    expect = {"packed_tp_fwd": 4 * layers + 1}

    with torch.inference_mode():
        for k in tp_kernel.KERNELS.values():
            k.launches = 0
        out = model(graph)
        torch.cuda.synchronize()
        launches = {n: k.launches for n, k in tp_kernel.KERNELS.items()}
        # the prediction path runs the forward kernel only
        for n, c in launches.items():
            if c != expect.get(n, 0):
                fail(f"kernel {n}: {c} launches in one forward, expected {expect.get(n, 0)}")
        for key in ("hamiltonian_on", "hamiltonian_off"):
            if not bool(torch.isfinite(out[key]).all()):
                fail(f"{key} is not finite")
        if tuple(out["hamiltonian_on"].shape) != (512, 361) or \
                tuple(out["hamiltonian_off"].shape) != (graph.num_edges, 361):
            fail(f"unexpected output shapes {out['hamiltonian_on'].shape}, "
                 f"{out['hamiltonian_off'].shape}")

        # the same model with the plain TP in place of the kernel
        def plain(plan, x, sh, w, flat_w):
            return plain_apply(plan, x, sh, w, flat_w)

        with mock.patch.object(tp_kernel, "packed_tp_forward", plain):
            ref = model(graph)
            torch.cuda.synchronize()
            plain_fwd_ms = 1e3 * min(_host_time(lambda: model(graph)) for _ in range(2))
        errs = {}
        for key in ("hamiltonian_on", "hamiltonian_off"):
            err, scale = rel_err(out[key], ref[key])
            errs[key] = (err, scale)
            if not math.isfinite(err) or err > TOL * scale:
                fail(f"model {key}: kernel vs plain max|d| {err:.3e} > {TOL} * {scale:.3e}")

        model(graph)
        times = [_host_time(lambda: model(graph)) for _ in range(5)]
    fwd_ms = 1e3 * float(np.median(times))
    device_ms = profile_forward(model, graph)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"[model] forward {fwd_ms:.3f} ms (median of 5) = "
          f"{n_edges / (fwd_ms * 1e-3):.1f} edges/s ({n_edges} edges, "
          f"{graph.num_edges} padded), plain-TP forward {plain_fwd_ms:.3f} ms, "
          f"launches {launches}, kernel vs plain max|d| "
          + ", ".join(f"{k} {e:.3e} of {s:.3e}" for k, (e, s) in errs.items())
          + f", peak memory {peak_gb:.2f} GB, card {card}", flush=True)
    return dict(forward_ms=fwd_ms, edges_per_s=n_edges / (fwd_ms * 1e-3),
                n_edges=n_edges, padded_edges=graph.num_edges,
                plain_forward_ms=plain_fwd_ms, launches=launches,
                errors={k: list(v) for k, v in errs.items()}, peak_gb=peak_gb,
                device_ms_by_kernel=device_ms)


def bench_graph(dev):
    from hamgnn_tpu_torch.data.graph import pad_and_batch
    from hamgnn_tpu_torch.data.synthetic import bench_crystal

    crystal = bench_crystal()
    n_edges = int(crystal["edge_index"].shape[1])
    graph = pad_and_batch([crystal], node_bucket=512,
                          edge_bucket=((n_edges + 511) // 512) * 512, device=dev)
    return graph, n_edges


def phase_train(tp_kernel, dev, card):
    """The bench.py train step through the port's Trainer."""
    import numpy as np
    import torch

    from hamgnn_tpu_torch.cli import build_model
    from hamgnn_tpu_torch.e3.packed_tp import plain_apply
    from hamgnn_tpu_torch.models.model import compute_losses, init_weights
    from hamgnn_tpu_torch.train.config import load_config
    from hamgnn_tpu_torch.train.trainer import Trainer

    graph, n_edges = bench_graph(dev)
    model = init_weights(build_model(load_config(None, overrides=BENCH_CFG)), 0)
    if model.representation.use_gradient_checkpointing:
        fail("the bench training phase runs without gradient checkpointing")
    WORK.mkdir(parents=True, exist_ok=True)
    tr = Trainer(model, losses=BENCH_LOSSES, metrics=[], lr=1e-3,
                 train_dir=str(WORK / "train"), device=dev)
    layers = BENCH_CFG["representation_nets"]["HamGNN_pre"]["num_layers"]
    expect = {"packed_tp_fwd": 4 * layers + 1, "packed_tp_bwd": 4 * layers + 1}

    torch.cuda.reset_peak_memory_stats(dev)
    for k in tp_kernel.KERNELS.values():
        k.launches = 0
    loss, logs = tr.train_step(graph)
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in tp_kernel.KERNELS.items()}
    for n, c in launches.items():
        if c != expect.get(n, 0):
            fail(f"kernel {n}: {c} launches in one train step, expected {expect.get(n, 0)}")
    if not math.isfinite(float(loss)) or float(logs["nonfinite_step"]) != 0.0:
        fail(f"train step loss {float(loss)} is not finite")

    # one step's parameter gradients, kernel path vs plain-TP path
    def grads():
        tr.grad.zero_()
        preds = tr.model(graph)
        compute_losses(preds, graph, BENCH_LOSSES)[0].backward()
        torch.cuda.synchronize()
        return tr.grad.clone()

    g_kernel = grads()
    with mock.patch.object(tp_kernel, "packed_tp_forward", plain_apply):
        g_plain = grads()
    worst, ofs = (0.0, ""), 0
    for name, p in tr.model.named_parameters():
        a, b = g_kernel[ofs : ofs + p.numel()], g_plain[ofs : ofs + p.numel()]
        ofs += p.numel()
        err, scale = rel_err(a, b)
        if not math.isfinite(err) or err > GRAD_TOL * scale:
            fail(f"gradient {name}: kernel vs plain max|d| {err:.3e} > {GRAD_TOL} * {scale:.3e}")
        if scale > 0 and err / scale > worst[0]:
            worst = (err / scale, name)

    losses = [float(tr.train_step(graph)[0])]
    times = []
    for _ in range(5):
        times.append(_host_time(lambda: tr.train_step(graph)))
    step_ms = 1e3 * float(np.median(times))
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    device_ms = profile_train_step(tr, graph)
    print(f"[train] step {step_ms:.3f} ms (median of 5: "
          + ", ".join(f"{1e3 * t:.3f}" for t in times)
          + f") = {n_edges / (step_ms * 1e-3):.1f} edges/s ({n_edges} edges, "
          f"{graph.num_edges} padded), launches per step {launches}, loss "
          f"{float(loss):.6f} -> {losses[-1]:.6f}, worst gradient kernel vs plain "
          f"{worst[0]:.3e} of max|ref| ({worst[1]}), peak memory {peak_gb:.2f} GB, "
          f"card {card}", flush=True)
    return dict(step_ms=step_ms, step_times_ms=[1e3 * t for t in times],
                edges_per_s=n_edges / (step_ms * 1e-3), n_edges=n_edges,
                padded_edges=graph.num_edges, launches=launches,
                worst_grad_rel_err=list(worst), peak_gb=peak_gb,
                loss_first=float(loss), device_ms_by_kernel=device_ms)


def profile_train_step(tr, graph):
    """Device time by kernel name over 3 train steps, written to
    chiprun_out/profile_train_step.txt."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            tr.train_step(graph)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 3
    return _write_profile(prof, wall, 3, "profile_train_step.txt", "step")


def _write_profile(prof, wall, n, fname, unit):
    import torch

    rows = []
    for ev in prof.key_averages():
        # device kernels only: CPU-side ops carry their kernels' time too
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us / (1e3 * n), ev.count // n, ev.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / fname, "w") as f:
        f.write(f"wall {wall * 1e3:.3f} ms/{unit}, device busy {total:.3f} ms/{unit}\n")
        for ms, cnt, key in rows:
            f.write(f"{ms:10.4f} ms {cnt:6d} launches  {key}\n")
    print(f"[profile] wall {wall * 1e3:.3f} ms/{unit}, device kernels {total:.3f} "
          f"ms/{unit} in {sum(r[1] for r in rows)} launches; top: "
          + "; ".join(f"{key[:40]} {ms:.3f} ms" for ms, cnt, key in rows[:5]), flush=True)
    return {"__all__": total, "__wall__": wall * 1e3,
            **{key[:80]: ms for ms, cnt, key in rows[:15]}}


def profile_forward(model, graph):
    """Device time by kernel name over 3 forwards (torch.profiler), written to
    chiprun_out/profile_forward.txt; returns {name: ms per forward} of the top
    kernels and the total under "__all__"."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU,
                                                     ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            model(graph)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 3
    return _write_profile(prof, wall, 3, "profile_forward.txt", "forward")


def _host_time(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_cli(tp_kernel, dev):
    import numpy as np
    import torch
    import yaml

    from hamgnn_tpu_torch import cli
    from hamgnn_tpu_torch.data.dataset import save_graph_npz
    from hamgnn_tpu_torch.data.synthetic import add_random_hamiltonian_targets, make_crystal
    from hamgnn_tpu_torch.models.model import init_weights
    from hamgnn_tpu_torch.train.config import load_config

    WORK.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(1)
    crystals = [add_random_hamiltonian_targets(
        rng, make_crystal(rng, n_atoms=8, cell_size=6.0, cutoff=5.0), nao_max=19)
        for _ in range(3)]
    save_graph_npz(str(WORK / "graph_data.npz"), crystals)
    cfg = json.loads(json.dumps(BENCH_CFG))
    cfg["setup"] = {"stage": "test", "checkpoint_path": str(WORK / "weights.pt")}
    cfg["dataset_params"] = {"graph_data_path": str(WORK), "batch_size": 2}
    cfg["profiler_params"] = {"train_dir": str(WORK / "out")}
    model = cli.build_model(load_config(None, overrides=cfg))
    torch.save(init_weights(model, 3).state_dict(), WORK / "weights.pt")
    with open(WORK / "config.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    for k in tp_kernel.KERNELS.values():
        k.launches = 0
    cli.main(["--config", str(WORK / "config.yaml")])
    if tp_kernel.PACKED_TP_FWD.launches == 0:
        fail("the CLI run did not launch the packed-TP kernel")
    rows = sum(c["z"].shape[0] + c["edge_index"].shape[1] for c in crystals)
    for fname in ("prediction_hamiltonian.npy", "target_hamiltonian.npy"):
        path = WORK / "out" / fname
        if not path.exists():
            fail(f"CLI wrote no {fname}")
        arr = np.load(path)
        if arr.shape != (rows, 361) or not np.isfinite(arr).all():
            fail(f"{fname}: shape {arr.shape}, expected ({rows}, 361), finite")
    print(f"[cli] stage test: {len(crystals)} crystals, {rows} rows x 361 "
          f"written; {tp_kernel.PACKED_TP_FWD.launches} kernel launches", flush=True)
    return cfg, rows


def phase_cli_fit(tp_kernel, cfg, rows):
    """``stage: fit`` for two epochs on the phase-5 crystals (one each for
    train, val and test), then ``stage: test`` from its best.pt."""
    import numpy as np
    import yaml

    from hamgnn_tpu_torch import cli

    fit = json.loads(json.dumps(cfg))
    fit["setup"] = {"stage": "fit"}
    fit["dataset_params"].update(batch_size=1, train_ratio=1 / 3, val_ratio=1 / 3,
                                 test_ratio=1 / 3)
    fit["optim_params"] = {"lr": 1e-3, "min_epochs": 0, "max_epochs": 2}
    fit["profiler_params"] = {"train_dir": str(WORK / "fit")}
    with open(WORK / "fit.yaml", "w") as f:
        yaml.safe_dump(fit, f)
    for k in tp_kernel.KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    cli.main(["--config", str(WORK / "fit.yaml")])
    fit_s = time.perf_counter() - t0
    launches = {n: k.launches for n, k in tp_kernel.KERNELS.items()}
    if min(launches.values()) == 0:
        fail(f"the fit run did not launch every kernel: {launches}")
    records = [json.loads(line) for line in open(WORK / "fit" / "metrics.jsonl")]
    if [r["epoch"] for r in records] != [0, 1] or not all(
            math.isfinite(r["train_loss"]) and math.isfinite(r["val_loss"]) for r in records):
        fail(f"fit metrics.jsonl: {records}")
    for fname in ("best.pt", "prediction_hamiltonian.npy"):
        if not (WORK / "fit" / fname).exists():
            fail(f"the fit run wrote no {fname}")

    test = json.loads(json.dumps(cfg))
    test["setup"] = {"stage": "test", "checkpoint_path": str(WORK / "fit" / "best.pt")}
    test["profiler_params"] = {"train_dir": str(WORK / "fit_test")}
    with open(WORK / "fit_test.yaml", "w") as f:
        yaml.safe_dump(test, f)
    cli.main(["--config", str(WORK / "fit_test.yaml")])
    arr = np.load(WORK / "fit_test" / "prediction_hamiltonian.npy")
    if arr.shape != (rows, 361) or not np.isfinite(arr).all():
        fail(f"test from best.pt: shape {arr.shape}, expected ({rows}, 361), finite")
    print(f"[cli] stage fit: 2 epochs in {fit_s:.1f} s, launches {launches}, "
          f"train_loss {[round(r['train_loss'], 6) for r in records]}, val_loss "
          f"{[round(r['val_loss'], 6) for r in records]}; stage test from best.pt: "
          f"{rows} rows x 361 written", flush=True)
    return dict(fit_s=fit_s, launches=launches, records=records)


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    try:
        from hamgnn_tpu_torch.e3 import tp_kernel
    except ImportError as exc:
        fail(f"cannot import the port next to this script: {exc}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}", flush=True)

    card = phase_build(tp_kernel)
    rows = {"packed_tp_fwd": phase_kernels(tp_kernel, dev),
            "packed_tp_bwd": phase_bwd_kernels(tp_kernel, dev)}
    model = phase_model(tp_kernel, dev, card)
    train = phase_train(tp_kernel, dev, card)
    cfg, n_rows = phase_cli(tp_kernel, dev)
    fit = phase_cli_fit(tp_kernel, cfg, n_rows)

    report = {"card": card, "kernel_rows": rows, "model": model, "train": train,
              "fit": fit}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    kernels = []
    for name in tp_kernel.KERNELS:
        # per training step: each kernel's 13 launches at their plans' shapes
        per = "launches_per_forward" if name == "packed_tp_fwd" else "launches_per_step"
        path_rows = [r for r in rows[name] if r[per] > 0]
        per_step = lambda key: sum(r[key] * r[per] for r in path_rows)  # noqa: E731
        ops_ms = per_step("gflop") * 1e9 / tp_kernel.H100_FP32_FLOPS * 1e3
        bytes_ms = per_step("mbytes") * 1e6 / tp_kernel.H100_HBM_BYTES_PER_S * 1e3
        src, replaces = KERNEL_SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": train["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "ms": per_step("ms"), "plain_ms": per_step("plain_ms"),
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None,
            "per_plan": {r["plan"]: {k: r[k] for k in
                                     ("ms", "plain_ms", "bound_ms", "bound_by",
                                      "max_abs_err")} for r in rows[name]},
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
