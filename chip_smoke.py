#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``hamgnn_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the result lines are printed):
  1. build every kernel of the port from ``hamgnn_tpu_torch/csrc`` (six
     sources, one nvcc each, all started together) and print the card's name
     and power limit as nvidia-smi reports them;
  2. hold each kernel against its plain PyTorch version at the shapes the
     main paths give it (bench widths, E = 19,968 padded edges), with
     max|kernel - plain| <= 1e-4 * max|plain| in fp32 (only the summation
     order differs), and time both with CUDA events: the lab-frame forward
     kernel (B1) against ``plain_apply``; its backward (B2) against
     ``plain_backward`` (dx, dw, d(flat_w) at the pair, node and edge plans,
     dsh at the pair plan; d(flat_w) within 1e-5), with B2's edge pass and
     weight pass (with its reduce) also timed apart; B1 and B2 at a plan
     whose output chunks take several work items (128x0e, 57x4e); the
     edge-frame forward kernel (B3) against
     ``plain_zonal_core`` and its backward (B4) against
     ``plain_zonal_core_backward`` (dx_rot, dw, d(flat_w) within 1e-5) at
     the pair, pair_lite (no radial weights), node and edge plans, on x
     rotated into the frames of directions that include +z, -z and near -z,
     with B4's edge pass and weight pass (with its reduce) also timed apart,
     and both at the wide plan with and without radial weights; a second
     launch of B2 and of B4 bit-identical to the first; and the whole zonal
     engine (rotation, B3, rotation back) against ``plain_apply`` at the node
     plan within 2e-5 * max|ref| (engine against engine: the rounding of two
     rotations besides the summation order), with the rotations timed alone;
  3. drive the prediction path under both engines: one ``HamGNNModel``
     forward at the ``bench.py`` width on the ``bench.py`` 512-atom crystal,
     random weights from a seeded ``torch.Generator``.  With
     ``HAMGNN_TP_ENGINE`` unset B1 must launch 13 times at 3 layers and no
     other kernel; with ``zonal`` B3 13 times and no other, the Wigner-D
     matrices built once.  The outputs must be finite, the default engine's
     agree with the same model run through the plain version within the
     tolerance of phase 2, and the zonal engine's with the default engine's
     within the engine limit; the forwards are timed in turns, and a
     torch.profiler pass writes device time by kernel per forward to
     chiprun_out/profile_forward.txt and profile_forward_zonal.txt;
  4. drive the training path under both engines (the ``bench.py`` step:
     masked MAE x 27.211 on ``hamiltonian``, amsgrad at lr 1e-3, no gradient
     checkpointing) through ``train.trainer.Trainer`` with ``capture=False``:
     one eager step must launch B1 and B2 (default) or B3 and B4 (``zonal``)
     13 times each and no other kernel; the parameter gradients must agree
     with the same model's through the plain TP, per tensor within 1e-3 *
     max|ref|; then the step and the eval step as the trainer runs them by
     default, captured as CUDA graphs (``train/captured.py``), against the
     eager ones from the same weights (``phase_captured``: losses, gradients,
     two shape keys, a NaN batch, a halved learning rate, the eval step's
     predictions, and one replay's launches counted in a profiler trace, 13
     of each of the engine's device kernels); both forms of the step and of
     the eval step are timed in turns (wall, median of 5, edges/s, peak
     memory) and torch.profiler passes write device time by kernel to
     chiprun_out/profile_{train_step,eval}[_captured][_zonal].txt;
  5. run the CLI end to end under both engines: ``stage: test`` on a few
     small crystals (``prediction_hamiltonian.npy`` /
     ``target_hamiltonian.npy``), then ``stage: fit`` for two epochs
     (``metrics.jsonl``, ``best.pt``, predictions) and ``stage: test`` from
     its ``best.pt``, each step replayed from a graph captured per batch
     shape (the launch counts there are of the warm-ups and captures);
  6. the probes: hold every probe kernel of ``tools_dev`` (``op_probe``,
     ``op_probe2``, ``throughput_probe``) against its plain version (fp32
     within 1e-4, the bf16 sweep 2e-2, the tf32 product 2e-3, all *
     max|plain|): P1/P2 at the TPU probes' 128 rows (``k_acc`` 512), at the
     bench rows (E = 19,968) and at 1,001 rows, P3 at its full size (E =
     19,968, slab 4,800), ``p1``, ``p3``, ``p6``, ``p7`` and ``p7_tf32``
     also at 1,088 rows; ``k_acc``, ``p1``, ``p3``, ``p6``, ``p7`` and
     ``p7_tf32`` bit-identical on a repeat, ``p7``'s scratch as sized in
     Python equal to the library's count; time kernel, plain version and
     library call at each timed size (``p7_tf32``'s a ``torch.matmul`` with
     TF32 allowed for that call alone, printed beside the full-fp32 one),
     and fail where a
     kernel reads above 1.05 of its bound; then run the three entry points on
     the card with every count at 0 before: each probe kernel must have
     launched, and no kernel of the model;
  7. the band path: ``HamGNNModel`` at the bench width with
     ``calculate_band_energy`` (6 k-points, a window of 2 x 8 bands) on a batch
     of 4 synthetic 16-atom crystals (H(k), S(k) of 1,216 x 1,216, complex64):
     a forward with finite outputs whose ``band_energy_ref`` agrees with a
     float64 ``scipy.linalg.eigh`` of the same H(k), S(k) on the host within
     5e-4; one ``Trainer.train_step`` with the bench loss plus ``band_energy``
     at 0.27211 (13 B1 and 13 B2 launches, finite loss and gradients; a head
     with bands stays eager: it reads counts on the host); timed
     steps and, by torch.profiler, the share of Cholesky and ``eigh``
     (chiprun_out/profile_band_step.txt); then the CLI: ``stage: fit`` two
     epochs with the band loss, ``stage: test`` from its ``best.pt`` and
     ``tools.band_cal`` on the prediction;
  8. print one JSON line describing each kernel, then the result line
     ``{"ok": true, "device": {...}}`` last.

It needs one card, imports nothing of JAX or of the JAX package, writes only
under ``build/`` in the checkout, and exits non-zero without a result when
``torch.cuda.is_available()`` is false.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
BAND_TOL = 5e-4   # fp32 reference bands on the card vs a float64 host solve
TOL = 1e-4        # max|kernel - plain| <= TOL * max|plain|, fp32
# B2's and B4's d(flat_w) (sums over all edges): within 1e-5 * max|plain|, which a
# sound 3xTF32 sum meets (~8e-7) and one kept long in the tensor cores'
# truncating accumulator does not (~6e-5)
DFLAT_TOL = 1e-5
ENGINE_TOL = 2e-5  # zonal engine vs lab-frame engine: two rotations' rounding too
GRAD_TOL = 1e-3   # model gradients, kernel path vs plain-TP path, per tensor
SHARE_MAX = 1.05  # a probe's bound / time: above it the bound or the timing is wrong
E_BENCH = None  # the bench rows (probe.BENCH_ROWS, 19,968 edges); set in main
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
    "zonal_tp_fwd": ("hamgnn_tpu_torch/csrc/zonal_tp_fwd.cu",
                     "hamgnn_tpu/e3/pallas_zonal.py:295"),
    "zonal_tp_bwd": ("hamgnn_tpu_torch/csrc/zonal_tp_bwd.cu",
                     "hamgnn_tpu/e3/pallas_zonal.py:336"),
}
# outputs wider than one work item of B1, B3 and both weight passes
WIDE_OUT = "128x0e+2x1o+57x4e"
# value of HAMGNN_TP_ENGINE -> its forward and backward kernel
ENGINES = {"auto": ("packed_tp_fwd", "packed_tp_bwd"),
           "zonal": ("zonal_tp_fwd", "zonal_tp_bwd")}


@contextlib.contextmanager
def engine(name: str):
    """Run the body under ``HAMGNN_TP_ENGINE=name`` (``auto``: unset)."""
    old = os.environ.pop("HAMGNN_TP_ENGINE", None)
    if name != "auto":
        os.environ["HAMGNN_TP_ENGINE"] = name
    try:
        yield
    finally:
        os.environ.pop("HAMGNN_TP_ENGINE", None)
        if old is not None:
            os.environ["HAMGNN_TP_ENGINE"] = old


def all_kernels(tp_kernel) -> dict:
    """Every kernel of the port by name: the model's and the probes'."""
    from hamgnn_tpu_torch.tools_dev import op_probe, op_probe2, throughput_probe  # noqa: F401
    from hamgnn_tpu_torch.tools_dev.probe import PROBE_KERNELS

    return {**tp_kernel.KERNELS, **PROBE_KERNELS}


def reset_launches(tp_kernel):
    for k in all_kernels(tp_kernel).values():
        k.launches = 0


def check_launches(tp_kernel, expect: dict, what: str) -> dict:
    """The counts of the model's kernels; fails unless each kernel of the
    port equals ``expect`` (0 where a kernel is not named)."""
    for n, k in all_kernels(tp_kernel).items():
        if k.launches != expect.get(n, 0):
            fail(f"kernel {n}: {k.launches} launches in {what}, expected {expect.get(n, 0)}")
    return {n: k.launches for n, k in tp_kernel.KERNELS.items()}


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median of ``iters`` CUDA-event times after ``warmup`` runs."""
    from hamgnn_tpu_torch.utils.profiling import device_time_ms

    return device_time_ms(fn, n=iters, warmup=warmup, device="cuda")


def rel_err(out, ref):
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    return err, scale


def phase_build(tp_kernel):
    t0 = time.perf_counter()
    built = tp_kernel.build_kernels(
        sorted({k.source for k in all_kernels(tp_kernel).values()}))
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
            tol = DFLAT_TOL if key == "dflat_w" else TOL
            if not math.isfinite(err) or err > tol * scale:
                fail(f"packed_tp_bwd[{name}] {key}: max|d| {err:.3e} > {tol} * {scale:.3e}")
            errs[key] = (err, scale)
        del got, again, ref
        timed = (plan, x, sh, w, fw, gy, False)
        ms = cuda_time_ms(lambda: tp_kernel.packed_tp_backward(*timed), 10)
        plain_ms = cuda_time_ms(lambda: plain_backward(*timed), 3)
        passes = bwd_pass_ms(tp_kernel.PACKED_TP_BWD,
                             tp_kernel.bwd_call(spec, x, sh, w, fw, gy, False))
        bound, bound_by = spec.bound_bwd_ms(E, True)
        flops, nbytes = spec.work_bwd(E, True)
        rows.append(dict(plan=name, E=E, launches_per_step=per_step,
                         max_abs_err=max(e for e, _ in errs.values()),
                         errors={k: list(v) for k, v in errs.items()},
                         ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                         gflop=flops / 1e9, mbytes=nbytes / 1e6,
                         achieved_tflops=flops / (ms * 1e-3) / 1e12, **passes))
        print(f"[kernel] packed_tp_bwd {name:9s} E={E} "
              + ", ".join(f"{k} max|d|={e:.3e} (max|ref| {s_:.3e})" for k, (e, s_) in errs.items())
              + f"; bit-identical repeat; kernel {ms:.4f} ms (edge pass {passes['edge_ms']:.4f}, "
              f"weight pass + reduce {passes['wcat_ms']:.4f}) plain {plain_ms:.4f} ms "
              f"bound {bound:.4f} ms ({bound_by})", flush=True)
        del x, sh, w, fw, gy
    torch.cuda.empty_cache()
    return rows


def phase_wide_kernels(tp_kernel, dev):
    """B1 and B2, then B3 and B4 (with and without radial weights), against
    their plain versions at a plan whose output chunks take several work
    items: 128x0e (V > 64: two items of B1 and of B3, four of each weight
    pass) and 57x4e (9 x 8 (m3, n8) tiles: two items of B1, two of B2's
    weight pass; 5 x 8 (|m3|, n8) tiles: two items of B3)."""
    import numpy as np
    import torch

    from hamgnn_tpu_torch.e3.irreps import Irreps
    from hamgnn_tpu_torch.e3.packed_tp import get_plan, plain_apply, plain_backward

    plan = get_plan(*(repr(Irreps(s)) for s in
                      ("16x0e+4x1o+2x2e", "0e+1o+2e", WIDE_OUT, WIDE_OUT)))
    spec = tp_kernel.get_spec(plan)
    rng = np.random.default_rng(9)
    E = 333
    x, sh, w, fw, gy = (torch.as_tensor(rng.normal(size=s_).astype(np.float32), device=dev)
                        for s_ in ((E, spec.d_in), (E, spec.S), (E, spec.n_ch),
                                   (plan.linear_numel,), (E, spec.d_out)))
    with torch.inference_mode():
        out = tp_kernel.packed_tp_forward(plan, x, sh, w, fw)
        ref = plain_apply(plan, x, sh, w, fw)
    got = tp_kernel.packed_tp_backward(plan, x, sh, w, fw, gy, True)
    refb = plain_backward(plan, x, sh, w, fw, gy, True)
    torch.cuda.synchronize()
    errs = {"out": rel_err(out, ref)}
    errs.update({k: rel_err(a, b) for k, a, b in zip(("dx", "dsh", "dw", "dflat_w"), got, refb)})
    for key, (err, scale) in errs.items():
        tol = DFLAT_TOL if key == "dflat_w" else TOL
        if not math.isfinite(err) or err > tol * scale:
            fail(f"packed_tp_fwd/bwd[wide] {key}: max|d| {err:.3e} > {tol} * {scale:.3e}")
    print(f"[kernel] packed_tp_fwd/bwd wide ({WIDE_OUT}; {len(spec.fitems)} B1 items, "
          f"{len(spec.witems)} weight-pass items on {len(spec.slabs)} slabs) E={E} "
          + ", ".join(f"{k} max|d|={e:.3e} (max|ref| {s_:.3e})" for k, (e, s_) in errs.items()),
          flush=True)
    out = {k: list(v) for k, v in errs.items()}

    # B3 and B4 at the same outputs, with and without radial weights
    from hamgnn_tpu_torch.e3 import zonal_kernel, zonal_tp

    zspec = zonal_kernel.get_zonal_kernel_spec(plan)
    for has_w in (True, False):
        wz = w if has_w else None
        with torch.inference_mode():
            zout = zonal_kernel.zonal_core_forward(plan, x, wz, fw)
            zref = zonal_tp.plain_zonal_core(plan, x, wz, fw)
        got = zonal_kernel.zonal_core_backward(plan, x, wz, fw, gy)
        again = zonal_kernel.zonal_core_backward(plan, x, wz, fw, gy)
        refb = zonal_tp.plain_zonal_core_backward(plan, x, wz, fw, gy)
        torch.cuda.synchronize()
        zerrs = {"out_rot": rel_err(zout, zref)}
        for k, a, b, c in zip(("dx_rot", "dw", "dflat_w"), got, again, refb):
            if c is None:
                continue
            if not torch.equal(a, b):
                fail(f"zonal_tp_bwd[wide] {k}: differs between two launches")
            zerrs[k] = rel_err(a, c)
        for key, (err, scale) in zerrs.items():
            tol = DFLAT_TOL if key == "dflat_w" else TOL
            if not math.isfinite(err) or err > tol * scale:
                fail(f"zonal_tp_fwd/bwd[wide, w={has_w}] {key}: max|d| {err:.3e} > "
                     f"{tol} * {scale:.3e}")
        print(f"[kernel] zonal_tp_fwd/bwd wide ({WIDE_OUT}, w={has_w}; {len(zspec.fitems)} B3 "
              f"items, {len(zspec.witems)} weight-pass items on {len(zspec.stages)} stages) "
              f"E={E} " + ", ".join(f"{k} max|d|={e:.3e} (max|ref| {s_:.3e})"
                                    for k, (e, s_) in zerrs.items()) + "; bit-identical repeat",
              flush=True)
        out.update({f"zonal{'' if has_w else '_no_w'}:{k}": list(v) for k, v in zerrs.items()})
    return out


def bwd_pass_ms(kernel, call) -> dict:
    """A backward's two passes timed apart through their own C entries (not
    counted as launches): the edge pass, and the weight pass with its
    reduce.  ``call`` is the wrapper's ``bwd_call`` result, (outputs, (C
    arguments, scratch tensors)), held while the passes run."""
    import torch

    lib = kernel.library()
    args = call[1][0]
    out = {}
    for key in ("edge", "wcat"):
        fn = getattr(lib, f"{kernel.name}_{key}")
        rc = fn(*args)
        torch.cuda.synchronize()
        if rc != 0:
            fail(f"{fn.__name__}: {getattr(lib, f'{kernel.name}_error_string')(rc).decode()} "
                 f"({rc})")
        out[f"{key}_ms"] = cuda_time_ms(lambda: fn(*args), 10)
    return out


def zonal_inputs(plan, has_w, seed, dev, with_gout=False):
    """Seeded inputs of the zonal kernels at E_BENCH edges: x rotated into
    the frames of random directions that include +z, -z and near -z."""
    import numpy as np
    import torch

    from hamgnn_tpu_torch.e3 import zonal_tp
    from hamgnn_tpu_torch.e3.spherical import spherical_harmonics

    rng = np.random.default_rng(seed)
    E = E_BENCH

    def t(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32), device=dev)

    vec = rng.normal(size=(E, 3)).astype(np.float32)
    vec[:3] = [[0, 0, 1], [0, 0, -1], [1e-7, -1e-7, -1]]
    ls = [ir.l for _, ir in plan.irreps_sh]
    x = t(E, plan.irreps_in.dim)
    with torch.no_grad():
        sh = spherical_harmonics(ls, torch.as_tensor(vec, device=dev), normalize=True)
        Ds = zonal_tp.edge_frames(zonal_tp.get_zonal_spec(plan), sh)
        x_rot = zonal_tp.rotate_in(plan, x, Ds).contiguous()
    w = t(E, plan.weight_numel) if has_w else None
    fw = t(plan.linear_numel)
    gy = t(E, plan.irreps_out.dim) if with_gout else None
    return x, sh, x_rot, w, fw, gy


def phase_zonal_kernels(dev):
    """B3 against ``plain_zonal_core`` at the bench plans, CUDA-event times
    and bounds."""
    import torch

    from hamgnn_tpu_torch.e3 import zonal_kernel, zonal_tp

    rows = []
    for name, plan, has_w, per_fwd in bench_plans():
        spec = zonal_kernel.get_zonal_kernel_spec(plan)
        E = E_BENCH
        _x, _sh, x_rot, w, fw, _gy = zonal_inputs(plan, has_w, 17, dev)
        with torch.inference_mode():
            ref = zonal_tp.plain_zonal_core(plan, x_rot, w, fw)
            out = zonal_kernel.zonal_core_forward(plan, x_rot, w, fw)
            torch.cuda.synchronize()
            err, scale = rel_err(out, ref)
            if not math.isfinite(err) or err > TOL * scale:
                fail(f"zonal_tp_fwd[{name}]: max|d| {err:.3e} > {TOL} * {scale:.3e}")
            ms = cuda_time_ms(lambda: zonal_kernel.zonal_core_forward(plan, x_rot, w, fw), 20)
            plain_ms = cuda_time_ms(lambda: zonal_tp.plain_zonal_core(plan, x_rot, w, fw), 5)
        bound, bound_by = spec.bound_ms(E, has_w)
        flops, nbytes = spec.work(E, has_w)
        rows.append(dict(plan=name, E=E, has_w=has_w, launches_per_forward=per_fwd,
                         max_abs_err=err, max_abs_ref=scale, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound, bound_by=bound_by, gflop=flops / 1e9,
                         mbytes=nbytes / 1e6,
                         achieved_tflops=flops / (ms * 1e-3) / 1e12,
                         achieved_gbytes_per_s=nbytes / (ms * 1e-3) / 1e9))
        print(f"[kernel] zonal_tp_fwd  {name:9s} E={E} max|d|={err:.3e} "
              f"(max|ref| {scale:.3e}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"bound {bound:.4f} ms ({bound_by})", flush=True)
        del x_rot, w, fw, ref, out
    torch.cuda.empty_cache()
    return rows


def phase_zonal_bwd_kernels(dev):
    """B4 against ``plain_zonal_core_backward`` at the bench plans, a repeat
    bit-identical, CUDA-event times and bounds."""
    import torch

    from hamgnn_tpu_torch.e3 import tp_kernel, zonal_kernel, zonal_tp

    rows = []
    for name, plan, has_w, per_step in bench_plans():
        spec = zonal_kernel.get_zonal_kernel_spec(plan)
        E = E_BENCH
        _x, _sh, x_rot, w, fw, gy = zonal_inputs(plan, has_w, 18, dev, with_gout=True)
        args = (plan, x_rot, w, fw, gy)
        got = zonal_kernel.zonal_core_backward(*args)
        again = zonal_kernel.zonal_core_backward(*args)
        ref = zonal_tp.plain_zonal_core_backward(*args)
        torch.cuda.synchronize()
        errs = {}
        for key, a, b, c in zip(("dx_rot", "dw", "dflat_w"), got, again, ref):
            if c is None:
                if a is not None:
                    fail(f"zonal_tp_bwd[{name}]: {key} returned where none was asked")
                continue
            if not torch.equal(a, b):
                fail(f"zonal_tp_bwd[{name}]: {key} differs between two launches")
            err, scale = rel_err(a, c)
            tol = DFLAT_TOL if key == "dflat_w" else TOL
            if not math.isfinite(err) or err > tol * scale:
                fail(f"zonal_tp_bwd[{name}] {key}: max|d| {err:.3e} > {tol} * {scale:.3e}")
            errs[key] = (err, scale)
        del got, again, ref
        ms = cuda_time_ms(lambda: zonal_kernel.zonal_core_backward(*args), 10)
        plain_ms = cuda_time_ms(lambda: zonal_tp.plain_zonal_core_backward(*args), 3)
        passes = bwd_pass_ms(tp_kernel.ZONAL_TP_BWD, zonal_kernel.bwd_call(spec, x_rot, w, fw, gy))
        bound, bound_by = spec.bound_bwd_ms(E, has_w)
        flops, nbytes = spec.work_bwd(E, has_w)
        rows.append(dict(plan=name, E=E, has_w=has_w, launches_per_step=per_step,
                         max_abs_err=max(e for e, _ in errs.values()),
                         errors={k: list(v) for k, v in errs.items()},
                         ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                         gflop=flops / 1e9, mbytes=nbytes / 1e6,
                         achieved_tflops=flops / (ms * 1e-3) / 1e12,
                         achieved_gbytes_per_s=nbytes / (ms * 1e-3) / 1e9, **passes))
        print(f"[kernel] zonal_tp_bwd  {name:9s} E={E} "
              + ", ".join(f"{k} max|d|={e:.3e} (max|ref| {s_:.3e})" for k, (e, s_) in errs.items())
              + f"; bit-identical repeat; kernel {ms:.4f} ms (edge pass {passes['edge_ms']:.4f}, "
              f"weight pass + reduce {passes['wcat_ms']:.4f}) plain {plain_ms:.4f} ms "
              f"bound {bound:.4f} ms ({bound_by})", flush=True)
        del x_rot, w, fw, gy, args
    torch.cuda.empty_cache()
    return rows


def phase_zonal_engine(tp_kernel, dev):
    """The whole zonal engine (frames, rotation in, B3, rotation back)
    against ``plain_apply`` at the node plan, and the time of its parts that
    are not the kernel: the Wigner-D build and the two rotations."""
    import torch

    from hamgnn_tpu_torch.e3 import zonal_kernel, zonal_tp
    from hamgnn_tpu_torch.e3.packed_tp import plain_apply

    name, plan, has_w, _n = next(p for p in bench_plans() if p[0] == "node")
    zspec = zonal_tp.get_zonal_spec(plan)
    x, sh, x_rot, w, fw, _gy = zonal_inputs(plan, has_w, 19, dev)
    with torch.inference_mode():
        reset_launches(tp_kernel)
        out = zonal_kernel.zonal_forward(plan, x, sh, w, fw)
        torch.cuda.synchronize()
        check_launches(tp_kernel, {"zonal_tp_fwd": 1}, "one zonal_forward")
        ref = plain_apply(plan, x, sh, w, fw)
        err, scale = rel_err(out, ref)
        if not math.isfinite(err) or err > ENGINE_TOL * scale:
            fail(f"zonal_forward[{name}] vs plain_apply: max|d| {err:.3e} > "
                 f"{ENGINE_TOL} * {scale:.3e}")
        Ds = zonal_tp.edge_frames(zspec, sh)
        out_rot = zonal_kernel.zonal_core_forward(plan, x_rot, w, fw)
        engine_ms = cuda_time_ms(lambda: zonal_kernel.zonal_forward(plan, x, sh, w, fw), 10)
        rot_in_ms = cuda_time_ms(lambda: zonal_tp.rotate_in(plan, x, Ds).contiguous(), 10)
        rot_out_ms = cuda_time_ms(lambda: zonal_tp.rotate_out(plan, out_rot, Ds), 10)

        def frames():
            zonal_tp.FRAME_MEMO.clear()
            zonal_tp.edge_frames(zspec, sh)

        frames_ms = cuda_time_ms(frames, 10)
    print(f"[engine] zonal_forward {name} E={E_BENCH} vs plain_apply max|d|={err:.3e} "
          f"(max|ref| {scale:.3e}, limit {ENGINE_TOL}); engine {engine_ms:.4f} ms per call "
          f"with the frames from the memo; rotation in {rot_in_ms:.4f} ms, rotation back "
          f"{rot_out_ms:.4f} ms, Wigner-D build (l <= {zspec.max_l_feat}) {frames_ms:.4f} ms",
          flush=True)
    zonal_tp.FRAME_MEMO.clear()
    torch.cuda.empty_cache()
    return dict(plan=name, max_abs_err=err, max_abs_ref=scale, engine_ms=engine_ms,
                rotate_in_ms=rot_in_ms, rotate_out_ms=rot_out_ms, frames_ms=frames_ms)


def phase_model(tp_kernel, dev, card):
    import numpy as np
    import torch

    from hamgnn_tpu_torch.cli import build_model
    from hamgnn_tpu_torch.e3 import zonal_tp
    from hamgnn_tpu_torch.models.model import init_weights
    from hamgnn_tpu_torch.train.config import load_config

    graph, n_edges = bench_graph(dev)
    model = build_model(load_config(None, overrides=BENCH_CFG))
    init_weights(model, 0).to(dev).eval()
    layers = BENCH_CFG["representation_nets"]["HamGNN_pre"]["num_layers"]
    keys = ("hamiltonian_on", "hamiltonian_off")

    outs, launches, builds = {}, {}, {}
    with torch.inference_mode():
        for eng, (fwd, _bwd) in ENGINES.items():
            with engine(eng):
                reset_launches(tp_kernel)
                zonal_tp.FRAME_MEMO.clear()
                builds0 = zonal_tp.FRAME_MEMO.builds
                out = model(graph)
                torch.cuda.synchronize()
                # the prediction path runs its engine's forward kernel only
                launches[eng] = check_launches(tp_kernel, {fwd: 4 * layers + 1},
                                               f"one forward ({eng})")
                builds[eng] = zonal_tp.FRAME_MEMO.builds - builds0
            for key in keys:
                if not bool(torch.isfinite(out[key]).all()):
                    fail(f"{key} is not finite ({eng})")
            if tuple(out["hamiltonian_on"].shape) != (512, 361) or \
                    tuple(out["hamiltonian_off"].shape) != (graph.num_edges, 361):
                fail(f"unexpected output shapes {out['hamiltonian_on'].shape}, "
                     f"{out['hamiltonian_off'].shape} ({eng})")
            outs[eng] = out
        if builds != {"auto": 0, "zonal": 1}:
            fail(f"Wigner-D builds per forward {builds}, expected none (auto), one (zonal)")

        # the same model with the plain TP in place of the kernels
        with engine("xla"):
            ref = model(graph)
            torch.cuda.synchronize()
            plain_fwd_ms = 1e3 * min(_host_time(lambda: model(graph)) for _ in range(2))
        errs = {}
        for eng, base, limit in (("auto", ref, TOL), ("zonal", outs["auto"], ENGINE_TOL)):
            for key in keys:
                err, scale = rel_err(outs[eng][key], base[key])
                errs[f"{eng}:{key}"] = (err, scale)
                if not math.isfinite(err) or err > limit * scale:
                    fail(f"model {key} ({eng}): max|d| {err:.3e} > {limit} * {scale:.3e}")

        # timed in turns, so that both engines see the same host
        times = {eng: [] for eng in ENGINES}
        for eng in ENGINES:
            with engine(eng):
                model(graph)
        for _ in range(5):
            for eng in ENGINES:
                with engine(eng):
                    times[eng].append(_host_time(lambda: model(graph)))
    result = {}
    for eng in ENGINES:
        fwd_ms = 1e3 * float(np.median(times[eng]))
        with engine(eng):
            device_ms = profile_forward(
                model, graph, "profile_forward.txt" if eng == "auto"
                else f"profile_forward_{eng}.txt")
        print(f"[model] engine {eng}: forward {fwd_ms:.3f} ms (median of 5: "
              + ", ".join(f"{1e3 * t:.3f}" for t in times[eng])
              + f") = {n_edges / (fwd_ms * 1e-3):.1f} edges/s ({n_edges} edges, "
              f"{graph.num_edges} padded), launches {launches[eng]}, Wigner-D builds "
              f"{builds[eng]}, card {card}", flush=True)
        result[eng] = dict(forward_ms=fwd_ms, forward_times_ms=[1e3 * t for t in times[eng]],
                           edges_per_s=n_edges / (fwd_ms * 1e-3), launches=launches[eng],
                           wigner_builds=builds[eng], device_ms_by_kernel=device_ms)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"[model] plain-TP forward {plain_fwd_ms:.3f} ms; max|d| "
          + ", ".join(f"{k} {e:.3e} of {s:.3e}" for k, (e, s) in errs.items())
          + f" (auto vs plain TP, limit {TOL}; zonal vs auto, limit {ENGINE_TOL}); "
          f"peak memory {peak_gb:.2f} GB", flush=True)
    return dict(engines=result, n_edges=n_edges, padded_edges=graph.num_edges,
                plain_forward_ms=plain_fwd_ms,
                errors={k: list(v) for k, v in errs.items()}, peak_gb=peak_gb)


def bench_graph(dev):
    from hamgnn_tpu_torch.data.graph import pad_and_batch
    from hamgnn_tpu_torch.data.synthetic import bench_crystal

    crystal = bench_crystal()
    n_edges = int(crystal["edge_index"].shape[1])
    graph = pad_and_batch([crystal], node_bucket=512,
                          edge_bucket=((n_edges + 511) // 512) * 512, device=dev)
    return graph, n_edges


def phase_train(tp_kernel, dev, card, eng):
    """The bench.py train step through the port's Trainer, eager
    (``capture=False``), under engine ``eng``: its launches, and its
    gradients against the plain-TP model's."""
    import torch

    from hamgnn_tpu_torch.cli import build_model
    from hamgnn_tpu_torch.models.model import compute_losses, init_weights
    from hamgnn_tpu_torch.train.config import load_config
    from hamgnn_tpu_torch.train.trainer import Trainer

    graph, n_edges = bench_graph(dev)
    model = init_weights(build_model(load_config(None, overrides=BENCH_CFG)), 0)
    if model.representation.use_gradient_checkpointing:
        fail("the bench training phase runs without gradient checkpointing")
    WORK.mkdir(parents=True, exist_ok=True)
    tr = Trainer(model, losses=BENCH_LOSSES, metrics=[], lr=1e-3,
                 train_dir=str(WORK / f"train_{eng}"), device=dev, capture=False)
    layers = BENCH_CFG["representation_nets"]["HamGNN_pre"]["num_layers"]
    expect = {k: 4 * layers + 1 for k in ENGINES[eng]}

    # one step's parameter gradients, kernel path vs plain-TP path
    def grads():
        tr.grad.zero_()
        preds = tr.model(graph)
        compute_losses(preds, graph, BENCH_LOSSES)[0].backward()
        torch.cuda.synchronize()
        return tr.grad.clone()

    torch.cuda.reset_peak_memory_stats(dev)
    with engine(eng):
        reset_launches(tp_kernel)
        loss, logs = tr.train_step(graph)
        torch.cuda.synchronize()
        launches = check_launches(tp_kernel, expect, f"one train step ({eng})")
        if not math.isfinite(float(loss)) or float(logs["nonfinite_step"]) != 0.0:
            fail(f"train step loss {float(loss)} is not finite ({eng})")
        g_kernel = grads()
    with engine("xla"):
        g_plain = grads()
    worst, ofs = (0.0, ""), 0
    for name, p in tr.model.named_parameters():
        a, b = g_kernel[ofs : ofs + p.numel()], g_plain[ofs : ofs + p.numel()]
        ofs += p.numel()
        err, scale = rel_err(a, b)
        if not math.isfinite(err) or err > GRAD_TOL * scale:
            fail(f"gradient {name} ({eng}): kernel vs plain max|d| {err:.3e} > "
                 f"{GRAD_TOL} * {scale:.3e}")
        if scale > 0 and err / scale > worst[0]:
            worst = (err / scale, name)
    del g_kernel, g_plain

    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"[train] engine {eng}: eager step ({n_edges} edges, {graph.num_edges} padded), "
          f"launches per step {launches}, loss {float(loss):.6f}, worst gradient kernel vs "
          f"plain {worst[0]:.3e} of max|ref| ({worst[1]}), peak memory {peak_gb:.2f} GB, "
          f"card {card}", flush=True)
    del tr, model
    torch.cuda.empty_cache()
    return dict(n_edges=n_edges, padded_edges=graph.num_edges, launches=launches,
                worst_grad_rel_err=list(worst), peak_gb=peak_gb, loss_first=float(loss))


def phase_captured(tp_kernel, dev, card, eng):
    """The training step and the eval step captured as CUDA graphs
    (``train/captured.py``) against the eager ones, under engine ``eng``, at
    the bench width: two trainers on the same weights (``capture=False`` and
    the default), the bench crystal and a 256-atom one (a second shape key).
    Checks: the first step's loss within 1e-6 relative, its gradient per
    parameter tensor within 1e-5 * max|ref| (``segment_sum`` adds with
    atomics: no bit identity), the step counts equal; five steps alternating
    the two shapes, losses within 1e-4; a NaN batch dropped by the replay
    with the state unchanged; after the learning rate halves, the next
    replay's loss within 1e-6 and its update's norm within 1e-3 of the eager
    step's; the eval step's loss within 1e-6 and predictions within 1e-5 *
    max|ref|; one replay of the step launches each of the engine's device
    kernels 13 times (a profiler trace) and moves no host counter.  Then both
    forms of the step and of the eval step are timed in turns (wall, median
    of 5; device time by kernel over 3, by torch.profiler; peak memory;
    edges/s)."""
    import dataclasses

    import numpy as np
    import torch

    from hamgnn_tpu_torch.cli import build_model
    from hamgnn_tpu_torch.data.graph import pad_and_batch
    from hamgnn_tpu_torch.data.synthetic import bench_crystal
    from hamgnn_tpu_torch.models.model import init_weights
    from hamgnn_tpu_torch.train.config import load_config
    from hamgnn_tpu_torch.train.trainer import Trainer
    from hamgnn_tpu_torch.utils.profiling import device_launches

    graph, n_edges = bench_graph(dev)
    small = bench_crystal(n_atoms=256)
    e_small = int(small["edge_index"].shape[1])
    graph2 = pad_and_batch([small], node_bucket=256, edge_bucket=-(-e_small // 512) * 512,
                           device=dev)
    layers = BENCH_CFG["representation_nets"]["HamGNN_pre"]["num_layers"]
    suffix = "" if eng == "auto" else f"_{eng}"
    WORK.mkdir(parents=True, exist_ok=True)
    trs = {}
    peaks = {}
    with engine(eng):
        for form, capture in (("captured", None), ("eager", False)):
            model = init_weights(build_model(load_config(None, overrides=BENCH_CFG)), 0)
            trs[form] = Trainer(model, losses=BENCH_LOSSES, metrics=BENCH_LOSSES, lr=1e-3,
                                train_dir=str(WORK / f"{form}_{eng}"), device=dev,
                                capture=capture)
        eager, cap = trs["eager"], trs["captured"]
        if eager.captured is not None or cap.captured is None:
            fail(f"capture=False must run eagerly, and the default capture on the card ({eng})")
        state = lambda tr: [tr.flat, *tr.opt.state_dict().values()]  # noqa: E731

        def copy_state(dst, src):
            with torch.no_grad():
                for a, b in zip(state(dst), state(src)):
                    a.copy_(b)

        # the first step of each (the captured one: warm-up, capture, replay)
        for form in ("captured", "eager"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            loss = trs[form].train_step(graph)[0]
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            peaks[form] = torch.cuda.max_memory_allocated(dev) / 1e9
            if form == "captured":
                capture_s, lb = first_s, float(loss)
            else:
                la = float(loss)
        if not abs(lb - la) <= 1e-6 * abs(la):
            fail(f"captured step loss {lb!r} vs eager {la!r} ({eng}): above 1e-6 relative")
        ofs, worst = 0, 0.0
        for name, p in eager.model.named_parameters():
            a, b = eager.grad[ofs:ofs + p.numel()], cap.grad[ofs:ofs + p.numel()]
            ofs += p.numel()
            err, scale = rel_err(b, a)
            if not err <= 1e-5 * scale:
                fail(f"captured step gradient {name} ({eng}): max|d| {err:.3e} > "
                     f"1e-5 * {scale:.3e}")
            worst = max(worst, err / scale if scale else 0.0)
        if int(eager.opt.count) != int(cap.opt.count):
            fail(f"step counts {int(eager.opt.count)} (eager) and {int(cap.opt.count)} "
                 f"(captured) differ ({eng})")

        # five steps alternating two shape keys
        alt = []
        for g in (graph2, graph, graph2, graph, graph2):
            la, lb = float(eager.train_step(g)[0]), float(cap.train_step(g)[0])
            alt.append((la, lb))
            if not abs(lb - la) <= 1e-4 * abs(la):
                fail(f"alternating shapes ({eng}): captured loss {lb!r} vs eager {la!r}")
        if cap.captured.captures != 2:
            fail(f"{cap.captured.captures} training graphs captured for two shape keys ({eng})")

        # a NaN batch is dropped by the replay
        before = [t.clone() for t in state(cap)]
        bad = dataclasses.replace(graph, Hon=torch.full_like(graph.Hon, float("nan")))
        loss, logs = cap.train_step(bad)
        if bool(torch.isfinite(loss)) or float(logs["nonfinite_step"]) != 1.0 or not all(
                torch.equal(a, b) for a, b in zip(state(cap), before)):
            fail(f"the replay did not drop a NaN batch with the state unchanged ({eng})")
        del before, bad

        # the learning rate halves: the next replay at the new rate
        copy_state(eager, cap)
        for tr in (eager, cap):
            tr.sched.lr = tr.sched.lr / 2
        start = cap.flat.clone()
        la, lb = float(eager.train_step(graph)[0]), float(cap.train_step(graph)[0])
        ratio = float((cap.flat - start).norm() / (eager.flat - start).norm())
        if not (abs(lb - la) <= 1e-6 * abs(la) and abs(ratio - 1.0) <= 1e-3):
            fail(f"after the learning rate halved ({eng}): loss {lb!r} vs {la!r}, update "
                 f"norm ratio {ratio!r}")
        del start

        # one replay's launches, from a profiler trace
        names = [n for k in ENGINES[eng] for n in tp_kernel.KERNELS[k].device_kernels]
        host = {n: k.launches for n, k in tp_kernel.KERNELS.items()}
        replay_launches = device_launches(lambda: cap.train_step(graph), names)
        if replay_launches != {n: 4 * layers + 1 for n in names} or host != {
                n: k.launches for n, k in tp_kernel.KERNELS.items()}:
            fail(f"one replay of the step ({eng}) launched {replay_launches}, expected "
                 f"{4 * layers + 1} of each, and moved the host counters")

        # the eval step from the same state
        copy_state(eager, cap)
        ta, _l, _m, pa = eager.eval_step(graph)
        tb, _l, _m, pb = cap.eval_step(graph)
        eval_err = {k: rel_err(pb[k], pa[k]) for k in ("hamiltonian_on", "hamiltonian_off")}
        if not abs(float(tb) - float(ta)) <= 1e-6 * abs(float(ta)) or not all(
                e <= 1e-5 * sc for e, sc in eval_err.values()):
            fail(f"captured eval ({eng}): loss {float(tb)!r} vs {float(ta)!r}, predictions "
                 f"{eval_err}")
        del pa, pb
        eval_launches = device_launches(lambda: cap.eval_step(graph), names)

        # timed in turns
        times = {k: [] for k in ("eager", "captured", "eager_eval", "captured_eval")}
        for _ in range(5):
            for form in ("eager", "captured"):
                times[form].append(_host_time(lambda: trs[form].train_step(graph)))
                times[f"{form}_eval"].append(_host_time(lambda: trs[form].eval_step(graph)))
        device = {}
        for form in ("eager", "captured"):
            tag = "" if form == "eager" else "_captured"
            device[form] = profile_train_step(trs[form], graph,
                                              f"profile_train_step{tag}{suffix}.txt")
            device[f"{form}_eval"] = profile_eval(trs[form], graph,
                                                  f"profile_eval{tag}{suffix}.txt")
    result = {}
    for key, ts in times.items():
        ms = 1e3 * float(np.median(ts))
        result[key] = dict(ms=ms, times_ms=[1e3 * t for t in ts],
                           edges_per_s=n_edges / (ms * 1e-3),
                           device_ms=device[key]["__all__"],
                           device_ms_by_kernel=device[key])
        print(f"[captured] engine {eng}: {key.replace('_', ' ')} step {ms:.3f} ms (median of "
              f"5: " + ", ".join(f"{1e3 * t:.3f}" for t in ts) + f") = "
              f"{n_edges / (ms * 1e-3):.1f} edges/s, device kernels "
              f"{device[key]['__all__']:.3f} ms, card {card}", flush=True)
    print(f"[captured] engine {eng}: first captured step (warm-up, capture, replay) "
          f"{capture_s:.2f} s; peak memory of the first step: captured {peaks['captured']:.2f} "
          f"GB, eager {peaks['eager']:.2f} GB; captured vs eager: first loss {lb!r} vs "
          f"{la!r}, worst gradient {worst:.3e} of max|ref|, alternating shapes "
          f"{[round(b / a - 1, 9) for a, b in alt]}, NaN batch dropped, halved rate "
          f"update norm ratio {ratio:.6f}, eval predictions {eval_err}; one replay launched "
          f"{replay_launches} (eval {eval_launches})", flush=True)
    del trs, eager, cap
    torch.cuda.empty_cache()
    return dict(timings=result, capture_s=capture_s, peak_gb=peaks, worst_grad_rel_err=worst,
                alternating_losses=alt, lr_halved_update_norm_ratio=ratio,
                eval_errors={k: list(v) for k, v in eval_err.items()},
                replay_launches=replay_launches, eval_replay_launches=eval_launches,
                n_edges=n_edges, second_shape_edges=e_small)


def profile_train_step(tr, graph, fname):
    """Device time by kernel name over 3 train steps, written to
    chiprun_out/<fname>."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            tr.train_step(graph)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 3
    return _write_profile(prof, wall, 3, fname, "step")


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
    print(f"[profile] {fname}: wall {wall * 1e3:.3f} ms/{unit}, device kernels {total:.3f} "
          f"ms/{unit} in {sum(r[1] for r in rows)} launches; top: "
          + "; ".join(f"{key[:40]} {ms:.3f} ms" for ms, cnt, key in rows[:5]), flush=True)
    return {"__all__": total, "__wall__": wall * 1e3,
            **{key[:80]: ms for ms, cnt, key in rows[:15]}}


def profile_eval(tr, graph, fname):
    """Device time by kernel name over 3 eval steps (forward, losses,
    metrics), written to chiprun_out/<fname>."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            tr.eval_step(graph)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 3
    return _write_profile(prof, wall, 3, fname, "eval step")


def profile_forward(model, graph, fname):
    """Device time by kernel name over 3 forwards (torch.profiler), written to
    chiprun_out/<fname>; returns {name: ms per forward} of the top kernels and
    the total under "__all__"."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU,
                                                     ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            model(graph)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 3
    return _write_profile(prof, wall, 3, fname, "forward")


def _host_time(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_cli(tp_kernel, eng):
    """``stage: test`` through the CLI under engine ``eng``."""
    import numpy as np
    import torch
    import yaml

    from hamgnn_tpu_torch import cli
    from hamgnn_tpu_torch.data.dataset import save_graph_npz
    from hamgnn_tpu_torch.data.synthetic import add_random_hamiltonian_targets, make_crystal
    from hamgnn_tpu_torch.models.model import init_weights
    from hamgnn_tpu_torch.train.config import load_config

    work = WORK / f"cli_{eng}"
    work.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(1)
    crystals = [add_random_hamiltonian_targets(
        rng, make_crystal(rng, n_atoms=8, cell_size=6.0, cutoff=5.0), nao_max=19)
        for _ in range(3)]
    save_graph_npz(str(work / "graph_data.npz"), crystals)
    cfg = json.loads(json.dumps(BENCH_CFG))
    cfg["setup"] = {"stage": "test", "checkpoint_path": str(work / "weights.pt")}
    cfg["dataset_params"] = {"graph_data_path": str(work), "batch_size": 2}
    cfg["profiler_params"] = {"train_dir": str(work / "out")}
    model = cli.build_model(load_config(None, overrides=cfg))
    torch.save(init_weights(model, 3).state_dict(), work / "weights.pt")
    with open(work / "config.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    fwd, bwd = ENGINES[eng]
    reset_launches(tp_kernel)
    with engine(eng):
        cli.main(["--config", str(work / "config.yaml")])
    launches = {n: k.launches for n, k in tp_kernel.KERNELS.items()}
    if launches[fwd] == 0 or any(c for n, c in launches.items() if n != fwd):
        fail(f"the CLI test run ({eng}) should launch {fwd} only: {launches}")
    rows = sum(c["z"].shape[0] + c["edge_index"].shape[1] for c in crystals)
    for fname in ("prediction_hamiltonian.npy", "target_hamiltonian.npy"):
        path = work / "out" / fname
        if not path.exists():
            fail(f"CLI wrote no {fname} ({eng})")
        arr = np.load(path)
        if arr.shape != (rows, 361) or not np.isfinite(arr).all():
            fail(f"{fname} ({eng}): shape {arr.shape}, expected ({rows}, 361), finite")
    print(f"[cli] engine {eng}: stage test: {len(crystals)} crystals, {rows} rows x 361 "
          f"written; {launches[fwd]} {fwd} launches", flush=True)
    return cfg, rows


def phase_cli_fit(tp_kernel, eng, cfg, rows):
    """``stage: fit`` for two epochs on the ``phase_cli`` crystals (one each
    for train, val and test), then ``stage: test`` from its best.pt, under
    engine ``eng``."""
    import numpy as np
    import yaml

    from hamgnn_tpu_torch import cli

    work = WORK / f"cli_{eng}"
    fit = json.loads(json.dumps(cfg))
    fit["setup"] = {"stage": "fit"}
    fit["dataset_params"].update(batch_size=1, train_ratio=1 / 3, val_ratio=1 / 3,
                                 test_ratio=1 / 3)
    fit["optim_params"] = {"lr": 1e-3, "min_epochs": 0, "max_epochs": 2}
    fit["profiler_params"] = {"train_dir": str(work / "fit")}
    with open(work / "fit.yaml", "w") as f:
        yaml.safe_dump(fit, f)
    reset_launches(tp_kernel)
    t0 = time.perf_counter()
    with engine(eng):
        cli.main(["--config", str(work / "fit.yaml")])
    fit_s = time.perf_counter() - t0
    launches = {n: k.launches for n, k in tp_kernel.KERNELS.items()}
    if any((c == 0) == (n in ENGINES[eng]) for n, c in launches.items()):
        fail(f"the fit run ({eng}) should launch {ENGINES[eng]} and no other: {launches}")
    records = [json.loads(line) for line in open(work / "fit" / "metrics.jsonl")]
    if [r["epoch"] for r in records] != [0, 1] or not all(
            math.isfinite(r["train_loss"]) and math.isfinite(r["val_loss"]) for r in records):
        fail(f"fit metrics.jsonl ({eng}): {records}")
    for fname in ("best.pt", "prediction_hamiltonian.npy"):
        if not (work / "fit" / fname).exists():
            fail(f"the fit run ({eng}) wrote no {fname}")

    test = json.loads(json.dumps(cfg))
    test["setup"] = {"stage": "test", "checkpoint_path": str(work / "fit" / "best.pt")}
    test["profiler_params"] = {"train_dir": str(work / "fit_test")}
    with open(work / "fit_test.yaml", "w") as f:
        yaml.safe_dump(test, f)
    with engine(eng):
        cli.main(["--config", str(work / "fit_test.yaml")])
    arr = np.load(work / "fit_test" / "prediction_hamiltonian.npy")
    if arr.shape != (rows, 361) or not np.isfinite(arr).all():
        fail(f"test from best.pt ({eng}): shape {arr.shape}, expected ({rows}, 361), finite")
    print(f"[cli] engine {eng}: stage fit: 2 epochs in {fit_s:.1f} s, launches {launches}, "
          f"train_loss {[round(r['train_loss'], 6) for r in records]}, val_loss "
          f"{[round(r['val_loss'], 6) for r in records]}; stage test from best.pt: "
          f"{rows} rows x 361 written", flush=True)
    return dict(fit_s=fit_s, launches=launches, records=records)


# probes whose sums cross blocks and meet in a fixed-order second kernel, p1,
# p3 and p6, whose warps share shared-memory buffers from item to item, and
# p7_tf32, whose stages are reused through mbarriers: a second launch must
# repeat the first bit for bit
REPEATS = ("k_acc", "p1", "p3", "p6", "p7", "p7_tf32")


def phase_probes(tp_kernel, dev):
    """Every probe kernel against its plain version: P1/P2 at each of their
    sizes (128 rows, ``k_acc`` 512; the bench rows; 1,001 rows), P3 at its
    full size (``p1``, ``p3``, ``p6``, ``p7``, ``p7_tf32`` also at 1,088 rows), with times, library
    times, bounds and the share of the bound reached at each timed size (above ``SHARE_MAX`` fails: no kernel beats
    its true bound); then the three entry points on the card, which must
    launch every probe kernel and no kernel of the model."""
    import numpy as np
    import torch

    from hamgnn_tpu_torch.tools_dev import op_probe, op_probe2, probe, throughput_probe
    from hamgnn_tpu_torch.utils.profiling import device_time_ms

    modules = (op_probe, op_probe2, throughput_probe)
    # p7's scratch as Python sizes it holds what the kernel writes
    for n in throughput_probe.PROBES["p7"].checked_rows:
        have, want = throughput_probe.p7_scratch(n)[0], throughput_probe.p7_scratch_of_library(n)
        if have != want:
            fail(f"p7 scratch at {n} rows: {have} floats, the library counts {want}")
    rows = {}
    for mod in modules:
        rng = np.random.default_rng(23)
        for name, p in mod.PROBES.items():
            at_rows, err = {}, 0.0
            for n in p.checked_rows:
                tensors = p.inputs(rng, dev, n)
                row = probe.check(p, tensors)
                out = row.pop("out")
                if not row["ok"]:
                    fail(f"probe {name} at {n} rows: max|d| {row['max_abs_err']:.3e} > "
                         f"{p.tol} * {row['max_abs_ref']:.3e} (shape {row['shape']})")
                if name in REPEATS and not torch.equal(out, p(*tensors)):
                    fail(f"probe {name} differs between two launches at {n} rows")
                del out
                err = max(err, row["max_abs_err"])
                if n in p.timed_rows:
                    m = probe.measure(p, tensors, n=8, warmup=2)
                    if m["share"] > SHARE_MAX:
                        fail(f"probe {name} at {n} rows: {m['ms']:.5f} ms is "
                             f"{m['share']:.2f} of its bound {m['bound_ms']:.5f} ms")
                    at_rows[n] = {**m, "max_abs_err": row["max_abs_err"]}
                    lib = "none" if m["library_ms"] is None else f"{m['library_ms']:.4f} ms"
                    print(f"[probe] {name:11s} rows={n} max|d|={row['max_abs_err']:.3e} "
                          f"(max|ref| {row['max_abs_ref']:.3e}, limit {p.tol:g}) kernel "
                          f"{m['ms']:.4f} ms plain {m['plain_ms']:.4f} ms library {lib} bound "
                          f"{m['bound_ms']:.5f} ms ({m['bound_by']}, {100 * m['share']:.1f}%)",
                          flush=True)
                    if name == "p7_tf32":
                        fp32_ms = device_time_ms(torch.matmul, tensors, n=8, warmup=2)
                        if torch.backends.cuda.matmul.allow_tf32:
                            fail("p7_tf32's library call left TF32 on for the process")
                        print(f"[probe] p7_tf32 library call (torch.matmul, TF32 for that call "
                              f"alone) {m['library_ms']:.4f} ms; full-fp32 torch.matmul "
                              f"{fp32_ms:.4f} ms", flush=True)
                else:
                    print(f"[probe] {name:11s} rows={n} max|d|={row['max_abs_err']:.3e} "
                          f"(max|ref| {row['max_abs_ref']:.3e}, limit {p.tol:g}) checked",
                          flush=True)
                del tensors
            # the headline numbers: the largest timed size
            rows[f"probe_{name}"] = {
                **at_rows[p.timed_rows[-1]], "max_abs_err": err, "tol": p.tol,
                "source": f"hamgnn_tpu_torch/csrc/{p.source}.cu", "replaces": p.replaces,
                "checked_rows": list(p.checked_rows), "at_rows": at_rows}
        torch.cuda.empty_cache()

    # path 1: the entry points as a user calls them, on the card by default
    reset_launches(tp_kernel)
    for mod in modules:
        mod.main([])
    torch.cuda.synchronize()
    for name, k in all_kernels(tp_kernel).items():
        if (k.launches > 0) != (name in rows):
            fail(f"kernel {name}: {k.launches} launches in the probes' run")
        if name in rows:
            rows[name]["launches"] = k.launches
    torch.cuda.empty_cache()
    print(f"[probe] entry points ran: {len(rows)} probe kernels launched, "
          f"{sum(r['launches'] for r in rows.values())} launches", flush=True)
    return rows


BAND_OUT = {"calculate_band_energy": True, "num_k": 6, "band_num_control": 8}
BAND_LOSSES = BENCH_LOSSES + [{"metric": "mae", "prediction": "band_energy",
                               "target": "band_energy", "loss_weight": 0.27211}]


def band_config():
    cfg = json.loads(json.dumps(BENCH_CFG))
    cfg["output_nets"]["HamGNN_out"].update(BAND_OUT)
    return cfg


def host_bands(crystal, k_cart, basis, nao, width):
    """float64 bands of one crystal's stored H and S on the host, in the
    head's window of ``2 * width`` around half filling: (nk, 2 * width)."""
    import numpy as np
    import scipy.linalg

    from hamgnn_tpu_torch.tools.band_cal import assemble_k_matrices_numpy

    z = crystal["z"]
    n = len(z)
    valid = np.concatenate([basis.orbital_mask_table[zi] > 0 for zi in z])
    mats = [assemble_k_matrices_numpy(
        np.concatenate([crystal[on], crystal[off]]), n, crystal["edge_index"],
        crystal["nbr_shift"], k_cart, nao, valid) for on, off in (("Hon", "Hoff"), ("Son", "Soff"))]
    half = int(np.ceil(sum(basis.num_valence[int(zi)] for zi in z) / 2))
    start = min(max(half - width, 0), max(int(valid.sum()) - 2 * width, 0))
    return np.stack([scipy.linalg.eigh(h, s_, eigvals_only=True)[start : start + 2 * width]
                     for h, s_ in zip(*mats)])


def phase_band(tp_kernel, dev, card):
    """The band branch at the bench width on 4 crystals of 16 atoms."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hamgnn_tpu_torch.cli import build_model
    from hamgnn_tpu_torch.data.graph import pad_and_batch
    from hamgnn_tpu_torch.data.synthetic import add_random_hamiltonian_targets, make_crystal
    from hamgnn_tpu_torch.models.basis import get_basis_set
    from hamgnn_tpu_torch.models.model import init_weights
    from hamgnn_tpu_torch.physics.kpoints import k_vecs_for_graph
    from hamgnn_tpu_torch.train.config import load_config
    from hamgnn_tpu_torch.train.trainer import Trainer

    nao, width, nk = 19, BAND_OUT["band_num_control"], BAND_OUT["num_k"]
    rng = np.random.default_rng(5)
    crystals = [add_random_hamiltonian_targets(
        rng, make_crystal(rng, n_atoms=16, cell_size=8.0, cutoff=5.0), nao_max=nao)
        for _ in range(4)]
    n_edges = sum(c["edge_index"].shape[1] for c in crystals)
    graph = pad_and_batch(crystals, node_bucket=64,
                          edge_bucket=((n_edges + 255) // 256) * 256, device=dev)
    norb = graph.num_nodes * nao
    model = init_weights(build_model(load_config(None, overrides=band_config())), 0)
    WORK.mkdir(parents=True, exist_ok=True)
    tr = Trainer(model, losses=BAND_LOSSES, metrics=[], lr=1e-3,
                 train_dir=str(WORK / "train_band"), device=dev)
    layers = BENCH_CFG["representation_nets"]["HamGNN_pre"]["num_layers"]

    # forward: shapes, finiteness, the reference bands against the host
    k_np = k_vecs_for_graph(graph, nk, None, rng=np.random.default_rng(6))
    k_vecs = torch.as_tensor(k_np, device=dev)
    tr.model.eval()
    with torch.inference_mode():
        reset_launches(tp_kernel)
        out = tr.model(graph, k_vecs=k_vecs)
        torch.cuda.synchronize()
        check_launches(tp_kernel, {"packed_tp_fwd": 4 * layers + 1}, "one band forward")
    shapes = {"band_energy": (4, nk, 2 * width), "band_energy_ref": (4, nk, 2 * width),
              "band_gap": (4,), "wavefunction": (4, nk, 2 * width, norb),
              "H_sym": (4, nk, norb, norb)}
    for key, shape in shapes.items():
        if tuple(out[key].shape) != shape or not bool(torch.isfinite(out[key].abs()).all()):
            fail(f"band forward: {key} has shape {tuple(out[key].shape)}, expected {shape}, finite")
    basis = get_basis_set("openmx", nao)
    ref = out["band_energy_ref"].cpu().numpy()
    worst = 0.0
    for b, c in enumerate(crystals):
        host = host_bands(c, k_np[b].astype(np.float64), basis, nao, width)
        worst = max(worst, float(np.abs(ref[b] - host).max()))
    if not worst <= BAND_TOL:
        fail(f"band_energy_ref vs the float64 host solve: max|d| {worst:.3e} > {BAND_TOL}")
    del out

    # one training step with the band loss
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(tp_kernel)
    loss, logs = tr.train_step(graph)
    torch.cuda.synchronize()
    launches = check_launches(tp_kernel, {k: 4 * layers + 1 for k in ENGINES["auto"]},
                              "one band train step")
    if not math.isfinite(float(loss)) or float(logs["nonfinite_step"]) != 0.0 \
            or not math.isfinite(float(logs["mae_band_energy"])):
        fail(f"band train step: loss {float(loss)}, logs {logs}")
    if not bool(torch.isfinite(tr.grad).all()) or float(tr.grad.abs().max()) == 0.0:
        fail("band train step: gradients are not finite, or all zero")

    times = [_host_time(lambda: tr.train_step(graph)) for _ in range(3)]
    step_ms = 1e3 * float(np.median(times))
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            tr.train_step(graph)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 2
    device_ms = _write_profile(prof, wall, 2, "profile_band_step.txt", "step")
    # host time inside the solver ops (they wait for the card), per step
    solver = {}
    for ev in prof.key_averages():
        if ev.key in ("aten::linalg_eigh", "aten::linalg_cholesky", "aten::linalg_cholesky_ex",
                      "aten::linalg_solve_triangular"):
            solver[ev.key] = ev.cpu_time_total / 2e3
    solver_ms = solver.get("aten::linalg_eigh", 0.0) + max(
        solver.get("aten::linalg_cholesky", 0.0), solver.get("aten::linalg_cholesky_ex", 0.0))

    # Cholesky and eigh alone on matrices of the step's size, host clock
    g = torch.Generator(device="cpu").manual_seed(1)
    a = torch.randn((4, nk, norb, norb), dtype=torch.complex64, generator=g).to(dev)
    spd = a @ a.mH / norb + torch.eye(norb, device=dev)
    chol_ms = 1e3 * min(_host_time(lambda: torch.linalg.cholesky(spd)) for _ in range(2))
    eigh_ms = 1e3 * min(_host_time(lambda: torch.linalg.eigh(spd)) for _ in range(2))
    del a, spd
    print(f"[band] 4 crystals x 16 atoms ({n_edges} edges, {graph.num_edges} padded), "
          f"{nk} k, H(k) {norb} x {norb} complex64: band_energy_ref vs float64 host solve "
          f"max|d| {worst:.3e} (limit {BAND_TOL}); train step {step_ms:.3f} ms (median of 3: "
          + ", ".join(f"{1e3 * t:.3f}" for t in times)
          + f"), launches {launches}, loss {float(loss):.6f}, mae_band_energy "
          f"{float(logs['mae_band_energy']):.6f}; profiler: wall {1e3 * wall:.3f} ms/step, "
          f"device kernels {device_ms['__all__']:.3f} ms/step, host time inside eigh + Cholesky "
          f"{solver_ms:.3f} ms/step = {solver_ms / (1e3 * wall):.1%} of the step ({solver}); "
          f"alone, one batch of 24: Cholesky {chol_ms:.3f} ms, eigh {eigh_ms:.3f} ms; "
          f"peak memory {peak_gb:.2f} GB, card {card}", flush=True)
    del tr, model
    torch.cuda.empty_cache()
    return dict(step_ms=step_ms, step_times_ms=[1e3 * t for t in times], launches=launches,
                n_edges=n_edges, padded_edges=graph.num_edges, norb=norb, nk=nk,
                ref_vs_host_max_abs_err=worst, profile_wall_ms=1e3 * wall,
                device_ms_by_kernel=device_ms, solver_host_ms=solver,
                solver_share_of_step=solver_ms / (1e3 * wall), cholesky_alone_ms=chol_ms,
                eigh_alone_ms=eigh_ms, peak_gb=peak_gb, loss=float(loss))


def phase_band_cli(tp_kernel):
    """``stage: fit`` two epochs with the band loss, ``stage: test`` from its
    best.pt, then ``tools.band_cal`` on the prediction."""
    import numpy as np
    import yaml

    from hamgnn_tpu_torch import cli
    from hamgnn_tpu_torch.data.dataset import save_graph_npz
    from hamgnn_tpu_torch.data.synthetic import add_random_hamiltonian_targets, make_crystal
    from hamgnn_tpu_torch.tools import band_cal

    work = WORK / "cli_band"
    work.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(2)
    crystals = [add_random_hamiltonian_targets(
        rng, make_crystal(rng, n_atoms=8, cell_size=6.0, cutoff=5.0), nao_max=19)
        for _ in range(3)]
    save_graph_npz(str(work / "graph_data.npz"), crystals)
    cfg = band_config()
    cfg["output_nets"]["HamGNN_out"]["k_path"] = "auto"
    cfg["setup"] = {"stage": "fit"}
    cfg["dataset_params"] = {"graph_data_path": str(work), "batch_size": 1,
                             "train_ratio": 1 / 3, "val_ratio": 1 / 3, "test_ratio": 1 / 3}
    cfg["optim_params"] = {"lr": 1e-3, "min_epochs": 0, "max_epochs": 2}
    cfg["losses_metrics"] = {"losses": BAND_LOSSES, "metrics": [
        {"metric": "mae", "prediction": "band_energy", "target": "band_energy"},
        {"metric": "mae", "prediction": "band_gap", "target": "band_gap"}]}
    cfg["profiler_params"] = {"train_dir": str(work / "fit")}
    with open(work / "fit.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    reset_launches(tp_kernel)
    t0 = time.perf_counter()
    cli.main(["--config", str(work / "fit.yaml")])
    fit_s = time.perf_counter() - t0
    launches = {n: k.launches for n, k in all_kernels(tp_kernel).items() if k.launches}
    if set(launches) != set(ENGINES["auto"]):
        fail(f"the band fit run should launch {ENGINES['auto']} and no other: {launches}")
    records = [json.loads(line) for line in open(work / "fit" / "metrics.jsonl")]
    if [r["epoch"] for r in records] != [0, 1] or not all(
            math.isfinite(r[key]) for r in records
            for key in ("train_loss", "val_loss", "val/mae_band_energy", "val/mae_band_gap")):
        fail(f"band fit metrics.jsonl: {records}")

    cfg["setup"] = {"stage": "test", "checkpoint_path": str(work / "fit" / "best.pt")}
    cfg["dataset_params"]["batch_size"] = 2
    cfg["profiler_params"] = {"train_dir": str(work / "test")}
    with open(work / "test.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    cli.main(["--config", str(work / "test.yaml")])
    rows = sum(c["z"].shape[0] + c["edge_index"].shape[1] for c in crystals)
    pred = np.load(work / "test" / "prediction_hamiltonian.npy")
    if pred.shape != (rows, 361) or not np.isfinite(pred).all():
        fail(f"band test run: prediction shape {pred.shape}, expected ({rows}, 361), finite")

    with open(work / "band_cal.yaml", "w") as f:
        yaml.safe_dump({"nao_max": 19, "graph_data_path": str(work / "graph_data.npz"),
                        "hamiltonian_path": str(work / "test" / "prediction_hamiltonian.npy"),
                        "nk": 12, "save_dir": str(work / "bands"), "strcture_name": "smoke",
                        "auto_mode": True}, f)
    band_cal.main(["--config", str(work / "band_cal.yaml")])
    gaps = []
    for i in range(len(crystals)):
        res = np.load(work / "bands" / f"smoke_{i}_bands.npz")
        if res["bands"].shape[0] != 12 or not np.isfinite(res["bands"]).all():
            fail(f"band_cal: crystal {i} bands {res['bands'].shape}, expected 12 k, finite")
        gaps.append(float(res["gap"]))
    print(f"[cli] band: stage fit 2 epochs in {fit_s:.1f} s, launches {launches}, val "
          f"mae_band_energy {[round(r['val/mae_band_energy'], 6) for r in records]}; stage "
          f"test from best.pt: {rows} rows x 361; band_cal: {len(gaps)} band structures, "
          f"gaps {[round(g_, 4) for g_ in gaps]} eV", flush=True)
    return dict(fit_s=fit_s, launches=launches, records=records, band_cal_gaps_ev=gaps)


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    global E_BENCH
    try:
        from hamgnn_tpu_torch.e3 import tp_kernel
        from hamgnn_tpu_torch.tools_dev.probe import BENCH_ROWS as E_BENCH
    except ImportError as exc:
        fail(f"cannot import the port next to this script: {exc}")
    os.environ.pop("HAMGNN_TP_ENGINE", None)  # each phase names its engine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}", flush=True)

    card = phase_build(tp_kernel)
    rows = {"packed_tp_fwd": phase_kernels(tp_kernel, dev),
            "packed_tp_bwd": phase_bwd_kernels(tp_kernel, dev),
            "zonal_tp_fwd": phase_zonal_kernels(dev),
            "zonal_tp_bwd": phase_zonal_bwd_kernels(dev)}
    wide = phase_wide_kernels(tp_kernel, dev)
    zonal_engine = phase_zonal_engine(tp_kernel, dev)
    model = phase_model(tp_kernel, dev, card)
    train = {eng: phase_train(tp_kernel, dev, card, eng) for eng in ENGINES}
    captured = {eng: phase_captured(tp_kernel, dev, card, eng) for eng in ENGINES}
    fit = {}
    for eng in ENGINES:
        cfg, n_rows = phase_cli(tp_kernel, eng)
        fit[eng] = phase_cli_fit(tp_kernel, eng, cfg, n_rows)

    probes = phase_probes(tp_kernel, dev)
    band = phase_band(tp_kernel, dev, card)
    band_fit = phase_band_cli(tp_kernel)

    report = {"card": card, "kernel_rows": rows, "wide": wide, "zonal_engine": zonal_engine,
              "model": model, "train": train, "captured": captured, "fit": fit,
              "probes": probes,
              "band": band, "band_fit": band_fit}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    kernels = []
    for eng, names in ENGINES.items():
        for name, per in zip(names, ("launches_per_forward", "launches_per_step")):
            # per training step of the kernel's engine: its 13 launches at
            # their plans' shapes
            path_rows = [r for r in rows[name] if r[per] > 0]
            per_step = lambda key: sum(r[key] * r[per] for r in path_rows)  # noqa: E731
            ops_ms = per_step("gflop") * 1e9 / tp_kernel.H100_FP32_FLOPS * 1e3
            bytes_ms = per_step("mbytes") * 1e6 / tp_kernel.H100_HBM_BYTES_PER_S * 1e3
            src, replaces = KERNEL_SOURCES[name]
            kernels.append({
                "name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": train[eng]["launches"][name],
                "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
                "ms": per_step("ms"), "plain_ms": per_step("plain_ms"),
                "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "library_ms": None,
                "per_plan": {r["plan"]: {k: r[k] for k in
                                         ("ms", "plain_ms", "bound_ms", "bound_by",
                                          "max_abs_err", "edge_ms", "wcat_ms") if k in r}
                             for r in rows[name]},
            })
    for name, r in probes.items():
        kernels.append({
            "name": name, "route": "cuda", "source": r["source"], "replaces": r["replaces"],
            "launches": r["launches"], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "rows": r["rows"]})
        if len(r["at_rows"]) > 1:  # P1/P2: the smaller size too
            kernels[-1]["at_rows"] = {n: {k: m[k] for k in ("ms", "library_ms", "bound_ms")}
                                      for n, m in r["at_rows"].items()}
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
