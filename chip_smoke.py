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
     order differs), and time both with CUDA events;
  3. drive the main path: one ``HamGNNModel`` forward at the ``bench.py``
     width on the ``bench.py`` 512-atom crystal, random weights from a seeded
     ``torch.Generator``; every kernel of the path must have launched (13
     launches of the packed-TP kernel at 3 layers), the outputs must be finite
     and agree with the same model run through the plain version, within the
     tolerance of phase 2; the forward is timed, and a torch.profiler pass
     writes device time by kernel per forward to chiprun_out/profile_forward.txt;
  4. run the CLI end to end (``stage: test``) on a few small crystals and
     check ``prediction_hamiltonian.npy`` / ``target_hamiltonian.npy``;
  5. print one JSON line describing each kernel, then the result line
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
KERNEL_SOURCES = {
    "packed_tp_fwd": ("hamgnn_tpu_torch/csrc/packed_tp_fwd.cu",
                      "hamgnn_tpu/e3/pallas_tp.py:582"),
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


def phase_model(tp_kernel, dev, card):
    import numpy as np
    import torch

    from hamgnn_tpu_torch.cli import build_model
    from hamgnn_tpu_torch.data.graph import pad_and_batch
    from hamgnn_tpu_torch.data.synthetic import bench_crystal
    from hamgnn_tpu_torch.e3.packed_tp import plain_apply
    from hamgnn_tpu_torch.models.model import init_weights
    from hamgnn_tpu_torch.train.config import load_config

    crystal = bench_crystal()
    n_edges = int(crystal["edge_index"].shape[1])
    graph = pad_and_batch([crystal], node_bucket=512,
                          edge_bucket=((n_edges + 511) // 512) * 512, device=dev)
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
        for n, c in launches.items():
            if c == 0:
                fail(f"kernel {n} was not launched on the main path")
            if n in expect and c != expect[n]:
                fail(f"kernel {n}: {c} launches in one forward, expected {expect[n]}")
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
    rows = []
    for ev in prof.key_averages():
        # device kernels only: CPU-side ops carry their kernels' time too
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us / 3e3, ev.count // 3, ev.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / "profile_forward.txt", "w") as f:
        f.write(f"wall {wall * 1e3:.3f} ms/forward, device busy {total:.3f} ms/forward\n")
        for ms, n, key in rows:
            f.write(f"{ms:10.4f} ms {n:6d} launches  {key}\n")
    print(f"[profile] wall {wall * 1e3:.3f} ms/forward, device kernels {total:.3f} "
          f"ms/forward in {sum(r[1] for r in rows)} launches; top: "
          + "; ".join(f"{key[:40]} {ms:.3f} ms" for ms, n, key in rows[:5]), flush=True)
    return {"__all__": total, "__wall__": wall * 1e3,
            **{key[:80]: ms for ms, n, key in rows[:15]}}


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
    rows = phase_kernels(tp_kernel, dev)
    model = phase_model(tp_kernel, dev, card)
    phase_cli(tp_kernel, dev)

    report = {"card": card, "kernel_rows": rows, "model": model}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    kernels = []
    for name in tp_kernel.KERNELS:
        path_rows = [r for r in rows if r["launches_per_forward"] > 0]
        per_fwd = lambda key: sum(r[key] * r["launches_per_forward"] for r in path_rows)  # noqa: E731
        ops_ms = sum(r["launches_per_forward"] * r["gflop"] * 1e9 for r in path_rows) \
            / tp_kernel.H100_FP32_FLOPS * 1e3
        bytes_ms = sum(r["launches_per_forward"] * r["mbytes"] * 1e6 for r in path_rows) \
            / tp_kernel.H100_HBM_BYTES_PER_S * 1e3
        src, replaces = KERNEL_SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": model["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            # per forward: the 13 launches at their plans' shapes
            "ms": per_fwd("ms"), "plain_ms": per_fwd("plain_ms"),
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None,
            "per_plan": {r["plan"]: {k: r[k] for k in
                                     ("ms", "plain_ms", "bound_ms", "bound_by",
                                      "max_abs_err")} for r in rows},
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
