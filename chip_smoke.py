#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``hamgnn_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the result lines are printed):
  1. build every kernel of the port from ``hamgnn_tpu_torch/csrc`` (six
     sources, one nvcc each, all started together) and print the card's name and
     power limit as nvidia-smi reports them;
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
     5e-4; one eager ``Trainer.train_step`` with the bench loss plus
     ``band_energy`` at 0.27211 (13 B1 and 13 B2 launches, finite loss and
     gradients); before it, the band branch's eigensolve against
     ``torch.linalg.eigh`` at the three band steps' sizes and the capture of
     ``torch.linalg.eigh`` alone, which cuSOLVER refuses (``phase_eigh``, in
     a process of its own); then the step and the eval step as the trainer runs them by
     default, captured in segments around the eigensolve, against the eager
     ones (``band_captured_vs_eager``: bit for bit under deterministic
     algorithms; in the default mode loss 1e-6 relative and the gradient
     within 2e-2 * max|g| on two shape keys, a batch whose overlap is
     negative definite dropped by the replay with NaN reference bands, the eval
     bands within 1e-5 of the spectrum's extent, one
     replay's launches by the profiler on 2 crystals, 13 of each device
     kernel, and its 2 eigensolve calls; on 4 crystals the kernel nodes of
     the captured graphs, 13 of each, against the profiler's count of the
     graphs replayed alone and of a whole replay (``replay_nodes``);
     both forms timed in turns, wall and device ms,
     chiprun_out/profile_band_step_{eager,captured}.txt), and one replay of
     the zonal engine's captured band step (13 B3 and 13 B4 kernel nodes on
     4 crystals, and by the profiler on 2 and 4); then the CLI:
     ``stage: fit`` two epochs with the band loss captured and eager under
     deterministic algorithms (the same losses bit for bit), ``stage: test``
     from its ``best.pt`` and ``tools.band_cal`` on the prediction;
  8. the SOC slice (``phase_soc``): ``examples/sk_soc/config.yaml``'s model
     (2 layers, features up to ``4x4e+2x4o``, nao 14; the graph's 6 A cutoff
     in place of the config's 9 A, random weights from seed 0) on the bench
     crystal with SOC fields (spinor targets, ``Lon``/``Loff``): B1-B4 against
     their plain versions at its plans (E = 19,968, the limits of phase 2);
     the forward, so3 (the config's head) and su2, under both engines, 9
     launches of the engine's forward kernel and no other, against the same
     model through the plain TP within 1e-4 * max|ref|, the real part
     Hermitian and the imaginary part anti-Hermitian through the inverse edge
     within 1e-6 * max|ref| (su2 the whole spinor block, so3 its spin-diagonal
     blocks); the training step on the config's losses (MAE x 27.211 on the
     real and the imaginary rows; so3 under both engines, su2 under the
     default one) eager (9 + 9 launches) and captured, loss
     within 1e-6 relative and gradients within 1e-5 * max|ref| per tensor
     (both under deterministic algorithms, where the two agree bit for bit),
     timed in turns in the default mode with device time by torch.profiler
     (chiprun_out/profile_soc_step_*.txt); the same step with gradient
     checkpointing; the spinor band step (4 crystals x 16 atoms, 6 k, 2 x 8
     bands, H(k) of the batch's 64 padded atoms x 28 orbitals): reference bands
     within 5e-4 of a float64 host solve, one eager training step with the band
     loss, then ``band_captured_vs_eager``; the CLI: ``stage: fit`` two epochs,
     then ``stage: test`` from
     ``<train_dir>/best``, whose predictions must differ from the untrained
     model's;
  9. the magnetic slice (``phase_magnetic``): ``examples/sk_collinear``,
     ``sk_ncl`` and ``sk_spinsoc``'s model (3 layers at ``sk_soc``'s features,
     nao 14, unit weights; the graph's 6 A cutoff in place of the configs' 9 A)
     on the bench crystal with synthetic spin fields (seed 1, one atom in
     eight below ``minMagneticMoment``), per branch under both engines (and
     once with ``use_learned_weight`` under the default one): the forward
     against the plain TP within 1e-4 * max|ref| with 13 launches of the
     engine's forward kernel and no other, the non-collinear blocks Hermitian
     through the inverse edge within 1e-6 * max|ref|, the training step eager
     (13 + 13 launches) and captured under deterministic algorithms (loss
     within 1e-6 relative, gradients within 1e-5 * max|ref| per tensor), both
     timed in turns, one replay's device time by kernel and its launches by
     device kernel name (13 of each), the first step's peak memory; the
     collinear band step (4 crystals x 16 atoms, 6 k, 2 x 8 bands a spin
     channel): each channel's reference bands within 5e-4 of a float64 host
     solve, one eager training step with the band loss, then
     ``band_captured_vs_eager`` (4 eigensolve calls a step); then the shipped
     configs through the CLI, only the epoch counts
     changed, in a scratch directory holding their relative paths:
     sk_collinear fit, ``config_band_test.yaml`` from ``<train_dir>/best``,
     ``tools.band_cal`` on ``band_cal.yaml`` (``band_spin{0,1}_*``), sk_ncl
     and sk_spinsoc fit then test from ``<train_dir>/best``;
 10. the LMDB store (``phase_lmdb``): an npz of 6 crystals converted by
     ``tools.npz_to_lmdb``, the store's batches on the card bit-identical to
     the npz's in every split, ``examples/sk_lmdb/config.yaml`` 2 epochs on it;
 11. the other representation networks (``phase_representation``):
     ``examples/sk/config.yaml``'s model with only its representation keys
     changed, on the bench crystal at 6 A (the config's 9 A cut as in phase
     8): (a) ``GNN_Net: HamGNNTransformer`` with 2 heads under both engines,
     (b) ConvE3 with ``use_corr_prod`` and (c) ConvE3 with ``use_kan`` under
     the default one; per case the forward against the plain TP within 1e-4 *
     max|ref| with 13 launches of the engine's forward kernel and no other,
     the training step eager (13 + 13 launches) and captured, bit for bit
     under deterministic algorithms (the default mode's spread reported),
     both timed in turns (wall, median of 3, edges/s), one replay's launches
     by device kernel name (13 of each) and its device time by kernel
     (``profile_rep_<case>_<engine>.txt`` in the report directory), the first step's peak
     memory and the memory held before and after the case; the new dense
     ops (a correlation block, the edge softmax, the attention's segment sum,
     a KAN generator beside the MLP one) timed forward and backward;
     ``MessagePackBlockV2`` at the sk width on 1,024 edges against its
     plain-TP form (output 1e-4, gradients 1e-3 * max|ref|); the Transformer
     config through the CLI, ``stage: fit`` 2 epochs then ``stage: test``
     from ``<train_dir>/best``;
 12. the data-preparation layer through the port alone (``phase_datagen``,
     under build/chip_smoke/datagen): the native readers built from source with
     g++; seeded SK sets made by ``tools.sk_dataset`` (OpenMX: 4 Si, 4 C and
     4 SiC with the pristine band set; OpenMX ``--soc``, SIESTA and ABACUS: 3
     each; collinear, non-collinear and spinsoc: 3 each), each timed; every
     container read back against the teacher's blocks bit for bit after the
     container's own rounding (scfout doubles; HSX float32 in Ry; CSR text of
     13 digits), and the spin sets' first crystal against the npz; each
     container set packed by ``tools.graph_data_gen*`` through the Python
     parsers and through the native readers, the two npz bit for bit; then
     on the card ``examples/sk/config.yaml``'s model ``stage: fit`` 2 epochs on
     the OpenMX set (finite losses, a captured step built, one replay of it
     launching 13 B1 and 13 B2 by the profiler), ``stage: test`` from
     ``<train_dir>/best`` on the pristine set and ``tools.band_cal`` on its
     prediction (finite bands, H(k) Hermitian within 1e-6 relative), and
     ``stage: test`` with random weights at ``examples/sk_siesta`` and
     ``sk_abacus``'s widths on the SIESTA and ABACUS sets (finite); the
     containers are removed at the end;
 13. the Uni-HamGNN predictor, the reference-parametrization model and the
     batched band solver (``phase_uni``, under build/chip_smoke/uni): a pair
     of graph sets of one structure list (``tools.sk_dataset`` with and
     without ``--soc``, seed 7, one Si, one C, one SiC, packed by
     ``tools.graph_data_gen``); the native predictor of
     ``examples/sk/config.yaml`` (3 layers) and ``examples/sk_soc/config.yaml``
     (2 layers, ``add_H_nonsoc`` forced), seeded weights, saved in the port's
     package form and read back equal, then ``tools.uni_hamgnn``'s CLI with
     ``calculate_mae`` under the plain TP, the default and the zonal engine:
     13 + 9 launches of the engine's forward kernel a crystal and no other
     (none under the plain TP), the default engine within 1e-4 * max|ref| of
     the plain TP and the zonal within the engine limit of the default, the
     SOC rows Hermitian within 1e-6 * max|ref| per crystal, each stage timed
     warm per crystal with its peak memory; ``HamGNNConvE3Compat`` at its own
     default widths (96 types, SH to 5o, ``64x0e+32x1o+16x2e``, 3 layers, 64
     radial) with the openmx nao-14 head, filled from a synthetic
     reference-format state dict through ``map_reference_state`` (full
     coverage both ways), one forward on the bench crystal at 6 A (the
     default cutoff is 26 A) launching no kernel of the port, within 1e-4 *
     max|ref| of the same model in float64 on the CPU, timed, its peak memory
     and its device time by kind (``profile_uni_compat.txt``); and
     ``tools.band_cal_parallel.solve_bands_batched`` on the band phase's
     crystals, 60 k along a path, 32 k a solve, within the band phase's 5e-4
     Ha of scipy's float64 ``eigh``, timed with the host assembly beside it;
 14. multi-device training (``phase_parallel``, under build/chip_smoke/parallel):
     (a) a one-process NCCL group on a free localhost port; per engine, the
     one-device eager step at the bench width, then an eager halo step
     (``HaloTrainer``, n_graph 1) and a data-parallel step
     (``ParallelTrainer``) from the same seeded weights: loss within 1e-6
     relative, flat gradient within 1e-5 * max|g|, 13 + 13 launches of the
     engine's kernels by the host counters and by the profiler, wall and
     device ms a step, peak memory, the plan's sizes; (b) two processes on the
     one card over gloo, the bench crystal split 2 ways, against (a)'s step
     (loss 1e-6, gradient 1e-4 * max|g|), halo rows a layer and the boundary
     share, left out and reported where this build's gloo carries no CUDA
     tensor; (c) one so3 halo step at phase 8's cell against the one-device
     step under deterministic algorithms (phase 8's limits) and one band-mode
     halo step (a 16-atom crystal of phase 7, 6 k) against the one-device band
     step (loss 1e-5 relative, band MAE 5e-4, gradient 2e-2 * max|g|, the band
     term's limit); (d)
     ``torch.distributed.run --standalone --nproc_per_node 1 -m
     hamgnn_tpu_torch.cli`` with ``setup.parallel.mode: halo``, then ``dp``,
     2 epochs on phase 5's set; each run's ``best.pt`` tested under ``mode:
     none`` on the validation crystal gives the MAE its halo evaluation logged
     at the best epoch within 1e-5 relative; the magnetic head under ``mode:
     halo`` raises the JAX package's NotImplementedError;
 15. the precision and schedule switches (``phase_variants``, run after
     phase 4): at the bench width and the pair, pair_lite, node and edge plans,
     each of B1-B4 in its bf16 instantiation (``HAMGNN_TP_BF16``) against its
     plain bf16 version within 1e-3 * max|plain|, a second launch
     bit-identical, the 3xTF32 kernel at least 10x farther (the mode rounds),
     bf16 and 3xTF32 timed in turns; the stored-mid pair
     (``HAMGNN_TP_STOREMID``: B1 writing its mids, B2 reading them) bit for bit
     against the recompute path, both timed, the mids' bytes; then the
     captured bench step under BF16=bwd, BF16=all, STOREMID=1 and zonal with
     BF16=all, each against the fp32 captured step of its engine from the same
     weights (first step under deterministic algorithms: under ``bwd`` and
     STOREMID the loss bit for bit, under STOREMID the gradient too, bf16
     gradients within 5e-2 * max|ref| per tensor), 13 + 13 launches of the
     mode's kernels (host counters of an eager pass; a replay by the
     profiler), wall and device ms, edges/s, peak memory;
 16. the shipped examples' accuracy chains (``phase_examples``, under
     build/chip_smoke/examples): ``tools_dev/sk_accuracy.py --example`` for
     sk_siesta, sk_abacus, sk_lmdb, sk_collinear, sk_ncl and sk_spinsoc at
     their configs' widths on 2 structures a species (the spin sets 6), 1
     epoch, on the card: teacher, packing (SIESTA and ABACUS through the
     native readers, LMDB through ``tools.npz_to_lmdb``), fit, the
     acceptance step from ``<train_dir>/best`` (bands, per-spin bands and the
     spatial / splitting MAE); each result with every key and finite MAEs
     and acceptance numbers, the run through B1 and B2 and no other kernel
     (host counters), one replay of each chain's captured training step
     (the profiler) at 4 * layers + 1 launches of each;
 17. print one JSON line ``{"uni": {...}}`` (launches a prediction, times,
     errors, peak memory), one ``{"parallel": {...}}``, one describing each
     kernel (the variants as entries of their own), then the result line
     ``{"ok": true, "device": {...}}`` last.

It needs one card, imports nothing of JAX or of the JAX package, writes only
under ``build/`` and ``chiprun_out/`` in the checkout, and exits non-zero
without a result when ``torch.cuda.is_available()`` is false.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import shutil
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

    return {**tp_kernel.KERNELS, **tp_kernel.VARIANTS, **PROBE_KERNELS}


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
    built = tp_kernel.build_kernels(sorted({k.source for k in all_kernels(tp_kernel).values()}))
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


def bench_plans(cfg=None):
    """The TP plans of a model config (default the bench one): (name, plan,
    radial weights present, launches per forward)."""
    from hamgnn_tpu_torch.e3.irreps import Irreps
    from hamgnn_tpu_torch.e3.packed_tp import get_plan

    cfg = (cfg or BENCH_CFG)["representation_nets"]["HamGNN_pre"]
    num_types = cfg.get("num_types", 96)
    feat = Irreps(cfg["irreps_node_features"])
    sh = Irreps(cfg["irreps_edge_sh"])
    comb = Irreps([(2 * m, ir) for m, ir in feat])
    mk = lambda xin: get_plan(repr(Irreps(xin)), repr(sh), repr(feat), repr(feat))  # noqa: E731
    per_layer = 2 * cfg["num_layers"]
    return [("pair", mk(f"{num_types}x0e"), True, 1),
            ("pair_lite", mk(f"{num_types}x0e"), False, 0),
            ("node", mk(comb), True, per_layer),
            ("edge", mk(feat), True, per_layer)]


def phase_kernels(tp_kernel, dev, cfg=None, width="bench"):
    import numpy as np
    import torch

    from hamgnn_tpu_torch.e3.packed_tp import plain_apply
    from hamgnn_tpu_torch.tools_dev.probe import device_normal

    rows = []
    for name, plan, has_w, per_fwd in bench_plans(cfg):
        spec = tp_kernel.get_spec(plan)
        rng = np.random.default_rng(7)
        E = E_BENCH

        t = device_normal(rng, dev)

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
        print(f"[kernel] packed_tp_fwd {width} {name:9s} E={E} max|d|={err:.3e} "
              f"(max|ref| {scale:.3e}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"bound {bound:.4f} ms ({bound_by})", flush=True)
        del x, sh, w, fw, ref, out
    torch.cuda.empty_cache()
    return rows


def phase_bwd_kernels(tp_kernel, dev, cfg=None, width="bench"):
    """B2 against ``plain_backward`` at the plans of ``cfg`` (default the
    bench ones), a repeat bit-identical, CUDA-event times and bounds."""
    import numpy as np
    import torch

    from hamgnn_tpu_torch.e3.packed_tp import plain_backward
    from hamgnn_tpu_torch.tools_dev.probe import device_normal

    rows = []
    for name, plan, has_w, per_step in bench_plans(cfg):
        if not has_w:  # lite mode is not on the bench training path
            continue
        spec = tp_kernel.get_spec(plan)
        need_dsh = name == "pair"
        rng = np.random.default_rng(8)
        E = E_BENCH

        t = device_normal(rng, dev)

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
        print(f"[kernel] packed_tp_bwd {width} {name:9s} E={E} "
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
    from hamgnn_tpu_torch.tools_dev.probe import device_normal

    plan = get_plan(*(repr(Irreps(s)) for s in
                      ("16x0e+4x1o+2x2e", "0e+1o+2e", WIDE_OUT, WIDE_OUT)))
    spec = tp_kernel.get_spec(plan)
    rng = np.random.default_rng(9)
    E = 333
    t = device_normal(rng, dev)
    x, sh, w, fw, gy = (t(*s_) for s_ in ((E, spec.d_in), (E, spec.S), (E, spec.n_ch),
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
    from hamgnn_tpu_torch.tools_dev.probe import device_normal

    rng = np.random.default_rng(seed)
    E = E_BENCH

    t = device_normal(rng, dev)

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


def phase_zonal_kernels(dev, cfg=None, width="bench"):
    """B3 against ``plain_zonal_core`` at the plans of ``cfg`` (default the
    bench ones), CUDA-event times and bounds."""
    import torch

    from hamgnn_tpu_torch.e3 import zonal_kernel, zonal_tp

    rows = []
    for name, plan, has_w, per_fwd in bench_plans(cfg):
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
        print(f"[kernel] zonal_tp_fwd  {width} {name:9s} E={E} max|d|={err:.3e} "
              f"(max|ref| {scale:.3e}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"bound {bound:.4f} ms ({bound_by})", flush=True)
        del x_rot, w, fw, ref, out
    torch.cuda.empty_cache()
    return rows


def phase_zonal_bwd_kernels(dev, cfg=None, width="bench"):
    """B4 against ``plain_zonal_core_backward`` at the plans of ``cfg``
    (default the bench ones), a repeat bit-identical, CUDA-event times and
    bounds."""
    import torch

    from hamgnn_tpu_torch.e3 import tp_kernel, zonal_kernel, zonal_tp

    rows = []
    for name, plan, has_w, per_step in bench_plans(cfg):
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
        print(f"[kernel] zonal_tp_bwd  {width} {name:9s} E={E} "
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
    of 5; device time by kernel of one step, by torch.profiler; peak memory;
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
        reads = profiled_launches(lambda: cap.train_step(graph), names, 4 * layers + 1)
        replay_launches = reads[-1]
        if replay_launches != {n: 4 * layers + 1 for n in names} or host != {
                n: k.launches for n, k in tp_kernel.KERNELS.items()}:
            fail(f"one replay of the step ({eng}) launched {reads} (profiler traces), expected "
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


def profile_train_step(tr, graph, fname, steps=1):
    """Device time by kernel name over ``steps`` train steps (one: a step's
    device time repeats within 0.1%), written to chiprun_out/<fname>."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hamgnn_tpu_torch.utils.profiling import PROFILER_LEAD_S

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_LEAD_S)  # no kernel of the step before the session's start
        t0 = time.perf_counter()
        for _ in range(steps):
            tr.train_step(graph)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps
    return _write_profile(prof, wall, steps, fname, "step")


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
    """Device time by kernel name of one eval step (forward, losses,
    metrics), written to chiprun_out/<fname>."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.eval_step(graph)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return _write_profile(prof, wall, 1, fname, "eval step")


def profile_forward(model, graph, fname):
    """Device time by kernel name of one forward (torch.profiler), written to
    chiprun_out/<fname>; returns {name: ms per forward} of the top kernels and
    the total under "__all__"."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model(graph)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return _write_profile(prof, wall, 1, fname, "forward")


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


def phase_eigh():
    """The band branch's eigensolve (``physics.eigh.hermitian_eigh``) against
    ``torch.linalg.eigh`` at the three band steps' sizes (896, 1,216, 1,792;
    24 matrices a call, as a step's solve): eigenvalues within 1e-5 *
    max|lambda|, residual within 1e-4 * max|A|, times in turns; and the
    capture of ``torch.linalg.eigh`` alone, which cuSOLVER refuses, in a
    process of its own (``tools_dev/eigh_probe.py``): a failed capture can
    leave a process's CUDA state unusable."""
    proc = subprocess.run([sys.executable, "-m", "hamgnn_tpu_torch.tools_dev.eigh_probe"],
                          capture_output=True, text=True, cwd=str(ROOT), timeout=300)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"eigh_probe"')]
    if proc.returncode != 0 or not lines:
        fail(f"eigh probe: rc {proc.returncode}\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    result = json.loads(lines[-1])["eigh_probe"]
    for r in result["sizes"]:
        print(f"[eigh] n {r['n']} x {r['batch']}: eigenvalues vs torch.linalg.eigh "
              f"{r['eig_rel_err']:.3e} of max|lambda| (limit {result['eig_tol']}), residual "
              f"{r['residual_rel']:.3e} of max|A| (limit {result['residual_tol']}); ms a call: "
              f"hermitian_eigh {r['ms']['hermitian_eigh']:.3f}, torch.linalg.eigh "
              f"{r['ms']['torch_linalg_eigh']:.3f}", flush=True)
    cap = result["capture_alone"]
    print(f"[eigh] the solve captured alone in a CUDA graph: {cap['captured']}"
          + ("" if cap["captured"] else f" ({cap['error']}): a captured band step runs it "
             f"between its graphs"), flush=True)
    return result


@contextlib.contextmanager
def graphs_kept():
    """Every graph of a segmented capture begun in the body keeps its CUDA
    graph (``keep_graph``; instantiated at its first replay), for
    ``graph_kernel_nodes``."""
    import torch

    from hamgnn_tpu_torch.utils import cuda_graphs

    begin = cuda_graphs.Segments.begin

    def kept(self):
        g = torch.cuda.CUDAGraph(keep_graph=True)
        self.graphs.append(g)
        g.capture_begin(pool=self.pool)

    cuda_graphs.Segments.begin = kept
    try:
        yield
    finally:
        cuda_graphs.Segments.begin = begin


def graph_kernel_nodes(segments, names, stem):
    """(kernel nodes by each of ``names``, all kernel nodes) of the graphs of
    a segmented capture made under ``graphs_kept``: each graph is written as
    DOT (``cudaGraphDebugDotPrint``) to build/chip_smoke/<stem>_<i>.dot, and
    its node statements are read; a kernel node's label starts with KERNEL
    and names its function (mangled)."""
    import re

    counts, total = {n: 0 for n in names}, 0
    WORK.mkdir(parents=True, exist_ok=True)
    for i, g in enumerate(segments.graphs):
        path = WORK / f"{stem}_{i}.dot"
        g.debug_dump(str(path))
        text = path.read_text(errors="replace")
        if i == 0:
            (ROOT / "chiprun_out").mkdir(exist_ok=True)
            (ROOT / "chiprun_out" / f"{stem}_0_head.dot").write_text(text[:6000])
        for node in re.split(r'\n(?=\s*"?\w*node_?\d+"?\s*\[)', text)[1:]:
            if 'label="{KERNEL' not in node:
                continue
            total += 1
            for n in names:
                counts[n] += n in node
    return counts, total


def kernel_events(fn, names):
    """(kernel launches by each of ``names``, all kernel launches) in a
    torch.profiler trace of one ``fn()``, memory copies and sets left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hamgnn_tpu_torch.utils.profiling import PROFILER_LEAD_S

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_LEAD_S)
        fn()
        torch.cuda.synchronize()
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and not ev.key.startswith(("Memcpy", "Memset"))]
    return ({n: sum(ev.count for ev in kernels if n in ev.key) for n in names},
            sum(ev.count for ev in kernels))


def profiled_launches(fn, names, expected, tries=3):
    """Launches of each of ``names`` in one ``fn()`` (a replay) by the
    profiler, read in up to ``tries`` traces until one reads ``expected`` of
    each; returns every reading.  A long trace can drop a kernel's record
    (``replay_nodes`` shows it against the graphs' nodes) but never adds
    one, so a reading above ``expected`` ends the tries and one below it is
    taken again."""
    from hamgnn_tpu_torch.utils.profiling import device_launches

    reads = []
    for _ in range(tries):
        read = device_launches(fn, names)
        reads.append(read)
        if any(read[n] > expected for n in names) or all(read[n] == expected for n in names):
            break
    return reads


def replay_nodes(trainer, graph, names, stem):
    """What one replay of ``trainer``'s captured training step on ``graph``
    (captured under ``graphs_kept``) runs, read against the profiler: the
    kernel nodes of its graphs, by name and in all, against a trace of the
    graphs replayed alone (the same kernels every time: a trace that counts
    fewer dropped them); and the nodes plus the kernels of the eigensolves
    between them (profiled apart; their count moves with the matrices)
    against a trace of a whole replay.  The replays update the trainer's
    state."""
    from hamgnn_tpu_torch.train.captured import shape_key

    seg = trainer.captured.train_graphs[shape_key(graph)].graph
    trainer.train_step(graph)
    nodes, node_total = graph_kernel_nodes(seg, names, f"{stem}_graph")
    graphs_alone = kernel_events(lambda: [g.replay() for g in seg.graphs], names)
    solver_total = kernel_events(lambda: [fn() for fn in seg.host], names)[1]
    replay, replay_total = kernel_events(seg.replay, names)
    return dict(nodes=nodes, node_kernels=node_total, graphs_alone=graphs_alone[0],
                graphs_alone_kernels=graphs_alone[1], solve_kernels=solver_total,
                profiler=replay, profiler_kernels=replay_total)


def nodes_line(r):
    return (f"graph kernel nodes {r['nodes']} of {r['node_kernels']}, the profiler on the "
            f"graphs alone {r['graphs_alone']} of {r['graphs_alone_kernels']}; with "
            f"{r['solve_kernels']} eigensolve kernels "
            f"{r['node_kernels'] + r['solve_kernels']}, the profiler on a replay "
            f"{r['profiler']} of {r['profiler_kernels']}")


# captured vs eager band step in the default mode, where both sum with
# atomics: the flat gradient within 2e-2 * max|g| (the band-loss term's limit,
# PERF.md 2), and the eval step's bands within 1e-5 of the spectrum's extent
# (the larger of the pad energy, 1e3, and max|band|): an fp32 eigenvalue moves
# by ~eps * ||A|| when A's sums change order, and the random-weight
# predictions' spectra reach far beyond the stored Hamiltonians'
BAND_GRAD_TOL = 2e-2
BAND_EVAL_TOL = 1e-5


def band_captured_vs_eager(tp_kernel, dev, card, tag, build, graph, graph2, solves,
                           tp_launches=13, count_nodes=False):
    """A band step and its eval step as the trainer runs them by default
    (captured in segments around the eigensolve, ``train/captured.py``)
    against the eager ones (``capture=False``) from the same weights.
    ``build(capture)`` makes a trainer on a fresh model of seed 0; ``graph``
    and ``graph2`` are two shape keys; ``solves`` the eigensolves a step
    hands to the host between its graphs, ``tp_launches`` its launches of
    each TP device kernel.  Under deterministic algorithms:
    the first step's loss, gradient and parameters and the eval step's
    bands bit for bit.  In the default mode: per step from the same state,
    the loss within 1e-6 relative and the flat gradient within 2e-2 *
    max|g|, on both shape keys (two graphs captured); a batch whose
    overlap is negative definite dropped by the replay, parameters and
    optimizer state unchanged, and NaN reference bands from the eval
    replay; one replay's TP launches on ``graph2`` by the profiler (``tp_launches`` of each
    of the default engine's device kernels) and its eigensolve calls (the
    host counter ``physics.eigh.CARD_SOLVES``); with ``count_nodes`` the
    kernel nodes of the captured graphs of ``graph`` (``replay_nodes``),
    ``tp_launches`` of each; the eval step's bands within
    ``BAND_EVAL_TOL`` of the spectrum's extent; then both
    forms timed in turns (wall, device ms by the profiler)."""
    import dataclasses

    import numpy as np
    import torch

    from hamgnn_tpu_torch.physics.band import _PAD_ENERGY
    from hamgnn_tpu_torch.physics.eigh import CARD_SOLVES

    state = lambda tr: [tr.flat, *tr.opt.state_dict().values()]  # noqa: E731

    def copy_state(dst, src):
        with torch.no_grad():
            for a, b in zip(state(dst), state(src)):
                a.copy_(b)

    def grad_err(eager, cap):
        """max|d g| / max|g| over the flat gradient (checked), and the worst
        of the same per parameter tensor (reported)."""
        err, scale = rel_err(cap.grad, eager.grad)
        if not err <= BAND_GRAD_TOL * scale:
            fail(f"{tag}: captured band step gradient: max|d| {err:.3e} > {BAND_GRAD_TOL} * "
                 f"max|g| {scale:.3e}")
        ofs, per_tensor = 0, 0.0
        for p in eager.model.parameters():
            e_, s_ = rel_err(cap.grad[ofs:ofs + p.numel()], eager.grad[ofs:ofs + p.numel()])
            ofs += p.numel()
            per_tensor = max(per_tensor, e_ / s_ if s_ else 0.0)
        return err / scale, per_tensor

    # deterministic algorithms: bit for bit
    torch.use_deterministic_algorithms(True)
    try:
        cap, eager = build(None), build(False)
        if cap.captured is None or eager.captured is not None:
            fail(f"{tag}: a band head must capture by default on the card, and capture=False "
                 f"run eagerly")
        la, lb = eager.train_step(graph)[0], cap.train_step(graph)[0]
        ea, eb = eager.eval_step(graph)[3]["band_energy"], cap.eval_step(graph)[3]["band_energy"]
        bitwise = bool(torch.equal(la, lb) and torch.equal(eager.grad, cap.grad)
                       and torch.equal(eager.flat, cap.flat) and torch.equal(ea, eb))
        if not bitwise:
            fail(f"{tag}: under deterministic algorithms the captured band step differs from "
                 f"the eager one: loss {float(lb)!r} vs {float(la)!r}, max|d grad| "
                 f"{float((eager.grad - cap.grad).abs().max()):.3e}, bands "
                 f"{float((ea - eb).abs().max()):.3e}")
        segments = len(cap.captured.train_graphs[next(iter(cap.captured.train_graphs))]
                       .graph.graphs)
    finally:
        torch.use_deterministic_algorithms(False)
    del cap, eager, ea, eb
    torch.cuda.empty_cache()

    # the default mode; the captured graphs kept for their kernel nodes
    kept = graphs_kept if count_nodes else contextlib.nullcontext
    with kept():
        cap = build(None)
    eager = build(False)
    losses, worst, per_tensor = [], 0.0, 0.0
    for g in (graph, graph2, graph):
        copy_state(eager, cap)
        with kept():
            la, lb = float(eager.train_step(g)[0]), float(cap.train_step(g)[0])
        losses.append((la, lb))
        if not abs(lb - la) <= 1e-6 * abs(la):
            fail(f"{tag}: captured band step loss {lb!r} vs eager {la!r}: above 1e-6 relative")
        flat_err, tensor_err = grad_err(eager, cap)
        worst, per_tensor = max(worst, flat_err), max(per_tensor, tensor_err)
    if cap.captured.captures != 2:
        fail(f"{tag}: {cap.captured.captures} band training graphs captured for two shape keys")

    # a batch whose overlap is negative definite: dropped, NaN bands
    bad = dataclasses.replace(graph, Son=-graph.Son, Soff=-graph.Soff)
    before = [t.clone() for t in state(cap)]
    loss, logs = cap.train_step(bad)
    if bool(torch.isfinite(loss)) or float(logs["nonfinite_step"]) != 1.0 or not all(
            torch.equal(a, b) for a, b in zip(state(cap), before)):
        fail(f"{tag}: the replay did not drop a batch with an indefinite overlap "
             f"(loss {float(loss)}, nonfinite_step {float(logs['nonfinite_step'])})")
    bad_ref = cap.eval_step(bad)[3]["band_energy_ref"]
    if not bool(torch.isnan(bad_ref).all()):
        fail(f"{tag}: an indefinite overlap must give NaN reference bands")
    del before, bad, bad_ref

    # one replay's launches: on the smaller batch by the profiler and its
    # eigensolve calls; on the larger one the captured graphs' kernel nodes
    # (``replay_nodes``), against what the profiler sees of one replay
    names = [n for k in ENGINES["auto"] for n in tp_kernel.KERNELS[k].device_kernels]
    solves0 = CARD_SOLVES["calls"]
    cap.train_step(graph2)
    replay_solves = CARD_SOLVES["calls"] - solves0
    reads = profiled_launches(lambda: cap.train_step(graph2), names, tp_launches)
    replay = reads[-1]
    if replay != {n: tp_launches for n in names} or replay_solves != solves:
        fail(f"{tag}: one replay launched {reads} (profiler traces) and {replay_solves} "
             f"eigensolve calls, expected {tp_launches} of each and {solves}")
    nodes = replay_nodes(cap, graph, names, tag) if count_nodes else None
    if nodes and nodes["nodes"] != {n: tp_launches for n in names}:
        fail(f"{tag}: the captured graphs of the larger batch hold {nodes['nodes']} TP kernel "
             f"nodes, expected {tp_launches} of each")

    # the eval step from the same state
    copy_state(eager, cap)
    pa, pb = eager.eval_step(graph)[3], cap.eval_step(graph)[3]
    eval_err = float((pa["band_energy"] - pb["band_energy"]).abs().max())
    extent = max(_PAD_ENERGY, float(pa["band_energy"].abs().max()))
    del pa, pb
    if not eval_err <= BAND_EVAL_TOL * extent:
        fail(f"{tag}: captured eval bands vs eager max|d| {eval_err:.3e} > {BAND_EVAL_TOL} * "
             f"{extent:.3e}")

    times = {"eager": [], "captured": []}
    for _ in range(2):
        for form, tr in (("eager", eager), ("captured", cap)):
            times[form].append(1e3 * _host_time(lambda: tr.train_step(graph)))
    device = {form: profile_train_step(tr, graph, f"profile_{tag}_step_{form}.txt")
              for form, tr in (("eager", eager), ("captured", cap))}
    ms = {form: float(np.median(t)) for form, t in times.items()}
    print(f"[{tag}] captured in {segments} segments around {solves} eigensolve calls: "
          f"deterministic bit for bit; default mode losses "
          f"{[round(b / a - 1, 9) for a, b in losses]} (rel), gradient max|d| {worst:.3e} of "
          f"max|g| (worst tensor {per_tensor:.3e} of its own max), two shape keys, "
          f"indefinite overlap dropped with NaN bands, one replay (2 crystals) {replay} "
          f"({len(reads)} trace(s)) + {replay_solves} eigensolve calls"
          + (f"; 4 crystals: {nodes_line(nodes)}" if nodes else "")
          + f"; eval bands max|d| {eval_err:.3e} (spectrum extent {extent:.3e}); step wall ms "
          f"eager {ms['eager']:.3f} captured {ms['captured']:.3f} (in turns: "
          f"{times}), device ms eager {device['eager']['__all__']:.3f} captured "
          f"{device['captured']['__all__']:.3f}, card {card}", flush=True)
    del cap, eager
    torch.cuda.empty_cache()
    return dict(segments=segments, bitwise_deterministic=True, losses=losses,
                worst_grad_rel_err=worst, worst_tensor_grad_rel_err=per_tensor,
                replay_launches=replay, replay_traces=reads, replay_solves=replay_solves,
                replay_nodes=nodes,
                eval_band_max_abs_err=eval_err, eval_band_extent=extent, wall_ms=ms,
                wall_times_ms=times,
                device_ms={f: d["__all__"] for f, d in device.items()},
                device_ms_by_kernel=device)


def phase_band(tp_kernel, dev, card):
    """The band branch at the bench width on 4 crystals of 16 atoms: the
    forward against a float64 host solve, one eager step's launches, then
    the step and eval step as the trainer runs them by default, captured,
    against the eager ones (``band_captured_vs_eager``; a second shape key of
    2 crystals)."""
    import numpy as np
    import torch

    from hamgnn_tpu_torch.cli import build_model
    from hamgnn_tpu_torch.data.graph import pad_and_batch
    from hamgnn_tpu_torch.data.synthetic import add_random_hamiltonian_targets, make_crystal
    from hamgnn_tpu_torch.models.basis import get_basis_set
    from hamgnn_tpu_torch.models.model import init_weights
    from hamgnn_tpu_torch.physics.kpoints import k_vecs_for_graph
    from hamgnn_tpu_torch.train.config import load_config
    from hamgnn_tpu_torch.train.trainer import Trainer

    nao, width, nk = 19, BAND_OUT["band_num_control"], BAND_OUT["num_k"]

    def batch(seed, n):
        rng = np.random.default_rng(seed)
        crystals = [add_random_hamiltonian_targets(
            rng, make_crystal(rng, n_atoms=16, cell_size=8.0, cutoff=5.0), nao_max=nao)
            for _ in range(n)]
        n_edges = sum(c["edge_index"].shape[1] for c in crystals)
        return crystals, n_edges, pad_and_batch(
            crystals, node_bucket=16 * n, edge_bucket=((n_edges + 255) // 256) * 256,
            device=dev)

    crystals, n_edges, graph = batch(5, 4)
    graph2 = batch(7, 2)[2]
    norb = graph.num_nodes * nao
    WORK.mkdir(parents=True, exist_ok=True)

    def build(capture):
        model = init_weights(build_model(load_config(None, overrides=band_config())), 0)
        return Trainer(model, losses=BAND_LOSSES, metrics=[], lr=1e-3,
                       train_dir=str(WORK / "train_band"), device=dev, capture=capture)

    tr = build(False)
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

    # one eager training step with the band loss
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(tp_kernel)
    loss, logs = tr.train_step(graph)
    torch.cuda.synchronize()
    launches = check_launches(tp_kernel, {k: 4 * layers + 1 for k in ENGINES["auto"]},
                              "one eager band train step")
    if not math.isfinite(float(loss)) or float(logs["nonfinite_step"]) != 0.0 \
            or not math.isfinite(float(logs["mae_band_energy"])):
        fail(f"band train step: loss {float(loss)}, logs {logs}")
    if not bool(torch.isfinite(tr.grad).all()) or float(tr.grad.abs().max()) == 0.0:
        fail("band train step: gradients are not finite, or all zero")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    del tr
    torch.cuda.empty_cache()
    print(f"[band] 4 crystals x 16 atoms ({n_edges} edges, {graph.num_edges} padded), "
          f"{nk} k, H(k) {norb} x {norb} complex64: band_energy_ref vs float64 host solve "
          f"max|d| {worst:.3e} (limit {BAND_TOL}); eager step launches {launches}, loss "
          f"{float(loss):.6f}, mae_band_energy {float(logs['mae_band_energy']):.6f}, peak "
          f"memory {peak_gb:.2f} GB, card {card}", flush=True)
    cmp = band_captured_vs_eager(tp_kernel, dev, card, "band", build, graph, graph2, solves=2,
                                 count_nodes=True)

    # the zonal engine's captured band step: one replay's launches by the
    # profiler on the smaller batch, the kernel nodes of the larger one's graphs
    names = [n for k in ENGINES["zonal"] for n in tp_kernel.KERNELS[k].device_kernels]
    with engine("zonal"):
        with graphs_kept():
            tr = build(None)
            zl, _ = tr.train_step(graph2)
            tr.train_step(graph)
        zonal_reads = profiled_launches(lambda: tr.train_step(graph2), names, 13)
        zonal = zonal_reads[-1]
        zonal_nodes = replay_nodes(tr, graph, names, "band_zonal")
    if zonal != {n: 13 for n in names} or zonal_nodes["nodes"] != {n: 13 for n in names} \
            or not math.isfinite(float(zl)):
        fail(f"one replay of the zonal band step launched {zonal_reads} (2 crystals), its graphs "
             f"hold {zonal_nodes['nodes']} (4 crystals), expected 13 of each, loss {float(zl)}")
    print(f"[band] zonal engine: one replay of the captured band step (2 crystals) launched "
          f"{zonal} ({len(zonal_reads)} trace(s)); 4 crystals: {nodes_line(zonal_nodes)}",
          flush=True)
    del tr
    torch.cuda.empty_cache()
    return dict(launches=launches, n_edges=n_edges, padded_edges=graph.num_edges, norb=norb,
                nk=nk, ref_vs_host_max_abs_err=worst, peak_gb=peak_gb, loss=float(loss),
                captured_vs_eager=cmp, step_ms=cmp["wall_ms"], zonal_replay_launches=zonal,
                zonal_replay_nodes=zonal_nodes)


@contextlib.contextmanager
def trainers_capture(capture):
    """Every ``Trainer`` made in the body is given ``capture`` (False: the
    eager steps) unless its caller names one; yields a list that collects
    each captured graph's (shape key, train or eval)."""
    from hamgnn_tpu_torch.train import captured, trainer

    init, cap = trainer.Trainer.__init__, captured.CapturedSteps._capture
    graphs = []

    def patched_init(self, *args, **kwargs):
        kwargs.setdefault("capture", capture)
        init(self, *args, **kwargs)

    def counted(self, body, static, inputs, inference):
        graphs.append((captured.shape_key(static), "eval" if inference else "train"))
        return cap(self, body, static, inputs, inference)

    trainer.Trainer.__init__, captured.CapturedSteps._capture = patched_init, counted
    try:
        yield graphs
    finally:
        trainer.Trainer.__init__, captured.CapturedSteps._capture = init, cap


def phase_band_cli(tp_kernel):
    """``stage: fit`` two epochs with the band loss, as the trainer runs it by
    default (captured) and eagerly, both under deterministic algorithms: the
    same metrics.jsonl losses bit for bit; ``stage: test`` from its best.pt,
    then ``tools.band_cal`` on the prediction."""
    import numpy as np
    import torch
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
    runs, fit_s, captures = {}, {}, {}
    torch.use_deterministic_algorithms(True)
    try:
        for form, capture in (("captured", None), ("eager", False)):
            shutil.rmtree(work / f"fit_{form}", ignore_errors=True)
            cfg["profiler_params"] = {"train_dir": str(work / f"fit_{form}")}
            with open(work / f"fit_{form}.yaml", "w") as f:
                yaml.safe_dump(cfg, f)
            reset_launches(tp_kernel)
            t0 = time.perf_counter()
            with trainers_capture(capture) as graphs:
                cli.main(["--config", str(work / f"fit_{form}.yaml")])
            fit_s[form] = time.perf_counter() - t0
            captures[form] = graphs
            launches = {n: k.launches for n, k in all_kernels(tp_kernel).items() if k.launches}
            if set(launches) != set(ENGINES["auto"]):
                fail(f"the band fit run ({form}) should launch {ENGINES['auto']} and no "
                     f"other: {launches}")
            runs[form] = [json.loads(line) for line in open(work / f"fit_{form}" / "metrics.jsonl")]
    finally:
        torch.use_deterministic_algorithms(False)
    records = runs["captured"]
    keys = ("train_loss", "val_loss", "val/mae_band_energy", "val/mae_band_gap")
    if [r["epoch"] for r in records] != [0, 1] or not all(
            math.isfinite(r[key]) for r in records for key in keys):
        fail(f"band fit metrics.jsonl: {records}")
    if not captures["captured"] or captures["eager"]:
        fail(f"the band fit should capture its steps by default and not with capture=False: "
             f"{captures}")
    if [[r[k] for k in keys] for r in records] != [[r[k] for k in keys] for r in runs["eager"]]:
        fail(f"band fit under deterministic algorithms: captured {records} vs eager "
             f"{runs['eager']}")
    shutil.rmtree(work / "fit", ignore_errors=True)
    os.replace(work / "fit_captured", work / "fit")

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
    print(f"[cli] band: stage fit 2 epochs, captured {fit_s['captured']:.1f} s "
          f"({len(captures['captured'])} graphs: {captures['captured']}), eager "
          f"{fit_s['eager']:.1f} s, losses and metrics bit for bit under deterministic "
          f"algorithms; launches {launches}, val mae_band_energy "
          f"{[round(r['val/mae_band_energy'], 6) for r in records]}; stage test from best.pt: "
          f"{rows} rows x 361; band_cal: {len(gaps)} band structures, gaps "
          f"{[round(g_, 4) for g_ in gaps]} eV", flush=True)
    return dict(fit_s=fit_s, launches=launches, records=records, band_cal_gaps_ev=gaps,
                captured_graphs=captures["captured"])


# the SOC slice: examples/sk_soc/config.yaml's model (2 layers, features up
# to 4x4e+2x4o, nao 14, so3 head) on the bench crystal's graph, whose 6 A
# cutoff replaces the config's 9 A (~3.4x the edges) so that the step stays
# comparable with the bench step and inside the run's time limit
SOC_CONFIG = ROOT / "examples" / "sk_soc" / "config.yaml"
SOC_CUTOFF = 6.0
SOC_NAO = 14


def soc_config(basis="so3", **out):
    """(model config, its losses) of ``examples/sk_soc/config.yaml`` with the
    graph's cutoff, ``soc_basis`` set to ``basis`` and ``out`` over the
    head's keys."""
    import yaml

    with open(SOC_CONFIG) as f:
        src = yaml.safe_load(f)
    cfg = {"representation_nets": src["representation_nets"],
           "output_nets": src["output_nets"]}
    cfg["representation_nets"]["HamGNN_pre"]["cutoff"] = SOC_CUTOFF
    cfg["output_nets"]["HamGNN_out"].update(soc_basis=basis, **out)
    return cfg, src["losses_metrics"]["losses"]


def soc_crystals(rng, n, n_atoms, cell_size, cutoff):
    from hamgnn_tpu_torch.data.synthetic import (add_random_hamiltonian_targets,
                                                 add_random_soc_targets, make_crystal)

    return [add_random_soc_targets(rng, add_random_hamiltonian_targets(
        rng, make_crystal(rng, n_atoms=n_atoms, cell_size=cell_size, cutoff=cutoff),
        nao_max=SOC_NAO), nao_max=SOC_NAO) for _ in range(n)]


def soc_bench_graph(dev):
    """The bench crystal (512 atoms, 6 A, 19,672 edges padded to 19,968) with
    the SOC fields at nao 14."""
    import numpy as np

    from hamgnn_tpu_torch.data.graph import pad_and_batch
    from hamgnn_tpu_torch.data.synthetic import add_random_soc_targets, bench_crystal

    crystal = add_random_soc_targets(np.random.default_rng(1), bench_crystal(nao_max=SOC_NAO),
                                     nao_max=SOC_NAO)
    n_edges = int(crystal["edge_index"].shape[1])
    graph = pad_and_batch([crystal], node_bucket=512,
                          edge_bucket=((n_edges + 511) // 512) * 512, device=dev)
    return graph, n_edges


def soc_hermiticity(out, graph, basis) -> float:
    """max over rows of |H(e) - H(inv e)^dagger| (the real part symmetric,
    the imaginary part antisymmetric through the inverse edge; on site
    through itself): the whole spinor block for su2, the spin-diagonal
    blocks for so3, whose spin-coupling entries hold the antisymmetrised
    ksi * L of the reference's convention."""
    import torch

    nao = SOC_NAO
    worst = 0.0
    for where, mate, mask in (("on", None, graph.node_mask), ("off", graph.inv_edge_idx,
                                                              graph.edge_mask)):
        for part, sign in (("real", 1.0), ("imag", -1.0)):
            h = out[f"hamiltonian_{part}_{where}"].reshape(-1, 2 * nao, 2 * nao)
            hm = h if mate is None else h[mate]
            d = (h - sign * hm.mT)[mask]
            if basis == "so3":
                d = d.reshape(-1, 2, nao, 2, nao)
                d = torch.stack([d[:, 0, :, 0, :], d[:, 1, :, 1, :]], 1)
            worst = max(worst, float(d.abs().max()))
    return worst


def phase_soc_kernels(tp_kernel, dev):
    """B1-B4 against their plain versions at the sk_soc plans (E = 19,968),
    as phase 2 holds them at the bench plans."""
    cfg, _losses = soc_config()
    return {"packed_tp_fwd": phase_kernels(tp_kernel, dev, cfg, "sk_soc"),
            "packed_tp_bwd": phase_bwd_kernels(tp_kernel, dev, cfg, "sk_soc"),
            "zonal_tp_fwd": phase_zonal_kernels(dev, cfg, "sk_soc"),
            "zonal_tp_bwd": phase_zonal_bwd_kernels(dev, cfg, "sk_soc")}


def phase_soc_forward(tp_kernel, dev, card, graph, n_edges):
    """The SOC model's forward, so3 and su2, under both engines: 9 launches
    of the engine's forward kernel and no other, the outputs against the
    same model through the plain TP, the Hermitian structure."""
    import numpy as np
    import torch

    from hamgnn_tpu_torch.cli import build_model
    from hamgnn_tpu_torch.models.model import init_weights
    from hamgnn_tpu_torch.train.config import load_config

    keys = ("hamiltonian_real_on", "hamiltonian_real_off", "hamiltonian_imag_on",
            "hamiltonian_imag_off")
    result = {}
    for basis in ("so3", "su2"):
        cfg, _losses = soc_config(basis)
        layers = cfg["representation_nets"]["HamGNN_pre"]["num_layers"]
        model = init_weights(build_model(load_config(None, overrides=cfg)), 0).to(dev).eval()
        with torch.inference_mode():
            with engine("xla"):
                ref = model(graph)
                torch.cuda.synchronize()
            for eng, (fwd, _bwd) in ENGINES.items():
                with engine(eng):
                    reset_launches(tp_kernel)
                    out = model(graph)
                    torch.cuda.synchronize()
                    check_launches(tp_kernel, {fwd: 4 * layers + 1},
                                   f"one SOC forward ({basis}, {eng})")
                    times = [_host_time(lambda: model(graph)) for _ in range(3)]
                errs = {}
                for key in keys:
                    if tuple(out[key].shape) != (graph.num_nodes if key.endswith("_on")
                                                 else graph.num_edges, (2 * SOC_NAO) ** 2):
                        fail(f"SOC {key} ({basis}, {eng}) has shape {tuple(out[key].shape)}")
                    err, scale = rel_err(out[key], ref[key])
                    errs[key] = (err, scale)
                    if not math.isfinite(err) or err > TOL * scale:
                        fail(f"SOC forward {key} ({basis}, {eng}) vs plain TP: max|d| "
                             f"{err:.3e} > {TOL} * {scale:.3e}")
                scale = max(s_ for _e, s_ in errs.values())
                herm = soc_hermiticity(out, graph, basis)
                if not herm <= 1e-6 * scale:
                    fail(f"SOC forward ({basis}, {eng}): Hermitian structure off by {herm:.3e} "
                         f"> 1e-6 * {scale:.3e}")
                ms = 1e3 * float(np.median(times))
                result[f"{basis}:{eng}"] = dict(
                    forward_ms=ms, forward_times_ms=[1e3 * t for t in times],
                    edges_per_s=n_edges / (ms * 1e-3), hermiticity=herm,
                    errors={k: list(v) for k, v in errs.items()})
                print(f"[soc] forward {basis} {eng}: {4 * layers + 1} {fwd} launches; vs plain "
                      f"TP " + ", ".join(f"{k[12:]} {e:.3e} of {s_:.3e}"
                                         for k, (e, s_) in errs.items())
                      + f" (limit {TOL}); Hermitian to {herm:.3e}; forward {ms:.3f} ms (median "
                      f"of 3) = {n_edges / (ms * 1e-3):.1f} edges/s, card {card}", flush=True)
        del model, ref, out
        torch.cuda.empty_cache()
    return result


def phase_soc_step(tp_kernel, dev, card, graph, n_edges, basis, eng, checkpointing):
    """The SOC training step (the config's MAE x 27.211 on the real and the
    imaginary rows, amsgrad at lr 1e-3) eager and captured from the same
    weights under engine ``eng``.  First, with deterministic algorithms on
    in both, the captured step against the eager one: loss within 1e-6
    relative, gradients within 1e-5 * max|ref| per tensor: deterministic,
    the two forms agree bit for bit, while in the default mode the atomic
    sums of ``index_add_`` and of the gathers' backward add in another order
    at every step, which moves tensors whose gradients are tiny (su2's, ~1e-6)
    by more than 1e-5 of their size; that spread is reported.  Then, in the
    default mode, a trainer of each form as the trainer runs: the eager
    step's launches (9 forward, 9 backward; with
    checkpointing the 8 TP calls of the layers run forward again), both forms
    timed in turns (wall, median), device time by the profiler."""
    import numpy as np
    import torch

    from hamgnn_tpu_torch.cli import build_model
    from hamgnn_tpu_torch.models.model import init_weights
    from hamgnn_tpu_torch.train.config import load_config
    from hamgnn_tpu_torch.train.trainer import Trainer

    cfg, losses = soc_config(basis)
    cfg["representation_nets"]["HamGNN_pre"]["use_gradient_checkpointing"] = checkpointing
    layers = cfg["representation_nets"]["HamGNN_pre"]["num_layers"]
    tag = f"{basis}_{eng}" + ("_ckpt" if checkpointing else "")
    WORK.mkdir(parents=True, exist_ok=True)
    fwd, bwd = ENGINES[eng]

    def trainers(kind):
        out = {}
        for form, capture in (("eager", False), ("captured", None)):
            model = init_weights(build_model(load_config(None, overrides=cfg)), 0)
            if model.representation.use_gradient_checkpointing != checkpointing:
                fail(f"SOC step ({tag}): checkpointing not {checkpointing}")
            out[form] = Trainer(model, losses=losses, metrics=[], lr=1e-3,
                                train_dir=str(WORK / f"soc_{kind}_{form}_{tag}"), device=dev,
                                capture=capture)
        if out["eager"].captured is not None or out["captured"].captured is None:
            fail(f"SOC step ({tag}): the default trainer must capture, capture=False not")
        return out

    with engine(eng):
        torch.use_deterministic_algorithms(True)
        trs = trainers("det")
        la, lb = (float(trs[form].train_step(graph)[0]) for form in ("eager", "captured"))
        torch.cuda.synchronize()
        torch.use_deterministic_algorithms(False)
        eager, cap = trs["eager"], trs["captured"]
        if not abs(lb - la) <= 1e-6 * abs(la):
            fail(f"SOC captured step ({tag}) loss {lb!r} vs eager {la!r}: above 1e-6 relative")
        ofs, worst = 0, 0.0
        for name, p in eager.model.named_parameters():
            a, b = eager.grad[ofs:ofs + p.numel()], cap.grad[ofs:ofs + p.numel()]
            ofs += p.numel()
            err, scale = rel_err(b, a)
            if not err <= 1e-5 * scale:
                fail(f"SOC captured step ({tag}) gradient {name}: max|d| {err:.3e} > "
                     f"1e-5 * {scale:.3e}")
            worst = max(worst, err / scale if scale else 0.0)
        del trs, eager, cap
        torch.cuda.empty_cache()

        trs, peaks, firsts = trainers("default"), {}, {}
        for form in ("eager", "captured"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_launches(tp_kernel)
            t0 = time.perf_counter()
            loss, logs = trs[form].train_step(graph)
            torch.cuda.synchronize()
            firsts[form] = (float(loss), time.perf_counter() - t0)
            peaks[form] = torch.cuda.max_memory_allocated(dev) / 1e9
            if form == "eager":
                per = 4 * layers + 1
                launches = check_launches(
                    tp_kernel, {fwd: per + (4 * layers if checkpointing else 0), bwd: per},
                    f"one eager SOC step ({tag})")
            if not math.isfinite(float(loss)) or float(logs["nonfinite_step"]) != 0.0:
                fail(f"SOC step ({tag}, {form}): loss {float(loss)}")
        # the same comparison in the default mode, reported: its spread is the
        # atomic sums', which two eager steps show as well
        ofs, worst_default = 0, 0.0
        for name, p in trs["eager"].model.named_parameters():
            err, scale = rel_err(trs["captured"].grad[ofs:ofs + p.numel()],
                                 trs["eager"].grad[ofs:ofs + p.numel()])
            ofs += p.numel()
            worst_default = max(worst_default, err / scale if scale else 0.0)
        n_turns = 2 if checkpointing else 3
        times = {"eager": [], "captured": []}
        for _ in range(n_turns):
            for form in ("eager", "captured"):
                times[form].append(_host_time(lambda: trs[form].train_step(graph)))
        device = {}
        if not checkpointing:  # the replay's device time (the eager step's is the same)
            device["captured"] = profile_train_step(
                trs["captured"], graph, f"profile_soc_step_{tag}.txt")["__all__"]
    result = dict(first_loss=[la, lb], worst_grad_rel_err=worst, peak_gb=peaks,
                  first_step_s={k: v[1] for k, v in firsts.items()}, launches=launches,
                  default_mode_first_loss=[firsts["eager"][0], firsts["captured"][0]],
                  default_mode_worst_grad_rel_err=worst_default)
    for form, ts in times.items():
        ms = 1e3 * float(np.median(ts))
        result[form] = dict(ms=ms, times_ms=[1e3 * t for t in ts],
                            edges_per_s=n_edges / (ms * 1e-3), device_ms=device.get(form))
    print(f"[soc] step {tag}: eager launches {launches}; deterministic, captured vs eager "
          f"loss {lb!r} vs {la!r}, worst gradient {worst:.3e} of max|ref|; default mode: "
          f"loss {firsts['captured'][0]!r} vs {firsts['eager'][0]!r}, worst gradient "
          f"{worst_default:.3e} (atomic sums, not held to a limit); "
          + "; ".join(f"{form} {r['ms']:.3f} ms (median of {n_turns}) = "
                      f"{r['edges_per_s']:.1f} edges/s"
                      + (f", device kernels {r['device_ms']:.3f} ms" if r["device_ms"] else "")
                      for form, r in ((f, result[f]) for f in ("eager", "captured")))
          + f"; first step: eager {firsts['eager'][1]:.2f} s, captured (warm-up, capture, "
          f"replay) {firsts['captured'][1]:.2f} s; peak memory eager {peaks['eager']:.2f} GB, "
          f"captured {peaks['captured']:.2f} GB; card {card}", flush=True)
    del trs
    torch.cuda.empty_cache()
    return result


def host_soc_bands(crystal, k_cart, basis, width):
    """float64 spinor bands of one crystal's stored SOC Hamiltonian on the
    host, in the head's window of ``2 * width`` around the valence count:
    (nk, 2 * width)."""
    import numpy as np
    import scipy.linalg

    from hamgnn_tpu_torch.tools.band_cal import _assemble_soc, assemble_k_matrices_numpy

    nao = SOC_NAO
    z = crystal["z"]
    n = len(z)
    ei, shift = crystal["edge_index"], crystal["nbr_shift"]
    valid = np.concatenate([basis.orbital_mask_table[zi] > 0 for zi in z])
    HK = sum(c * _assemble_soc(np.concatenate([crystal[on], crystal[off]]), n, ei, shift,
                               k_cart, 2 * nao, valid)
             for c, on, off in ((1.0, "Hon", "Hoff"), (1j, "iHon", "iHoff")))
    S = assemble_k_matrices_numpy(np.concatenate([crystal["Son"], crystal["Soff"]]), n, ei,
                                  shift, k_cart, nao, valid)
    nv = S.shape[1]
    SK = np.zeros((S.shape[0], 2 * nv, 2 * nv), complex)
    SK[:, :nv, :nv] = S
    SK[:, nv:, nv:] = S
    occ = int(round(sum(basis.num_valence[int(zi)] for zi in z)))
    start = min(max(occ - width, 0), max(2 * nv - 2 * width, 0))
    return np.stack([scipy.linalg.eigh(0.5 * (h + h.conj().T), 0.5 * (s_ + s_.conj().T),
                                       eigvals_only=True)[start : start + 2 * width]
                     for h, s_ in zip(HK, SK)])


def phase_soc_band(tp_kernel, dev, card):
    """The SOC head's spinor band branch at the sk_soc width on the band
    smoke's 4 crystals of 16 atoms (6 k, 2 x 8 bands): shapes, the reference
    bands against a float64 host solve within 5e-4, one eager training step
    with the band loss (9 + 9 launches), then the step and eval step as the
    trainer runs them by default, captured, against the eager ones
    (``band_captured_vs_eager``; a second shape key of 2 crystals)."""
    import numpy as np
    import torch

    from hamgnn_tpu_torch.cli import build_model
    from hamgnn_tpu_torch.data.graph import pad_and_batch
    from hamgnn_tpu_torch.models.basis import get_basis_set
    from hamgnn_tpu_torch.models.model import init_weights
    from hamgnn_tpu_torch.physics.kpoints import k_vecs_for_graph
    from hamgnn_tpu_torch.train.config import load_config
    from hamgnn_tpu_torch.train.trainer import Trainer

    width, nk = BAND_OUT["band_num_control"], BAND_OUT["num_k"]

    def batch(seed, n):
        crystals = soc_crystals(np.random.default_rng(seed), n, 16, 8.0, 5.0)
        n_edges = sum(c["edge_index"].shape[1] for c in crystals)
        return crystals, n_edges, pad_and_batch(
            crystals, node_bucket=16 * n, edge_bucket=((n_edges + 255) // 256) * 256,
            device=dev)

    crystals, n_edges, graph = batch(5, 4)
    graph2 = batch(7, 2)[2]
    norb = graph.num_nodes * 2 * SOC_NAO
    cfg, losses = soc_config("so3", **BAND_OUT)
    layers = cfg["representation_nets"]["HamGNN_pre"]["num_layers"]
    losses = losses + [{"metric": "mae", "prediction": "band_energy", "target": "band_energy",
                        "loss_weight": 0.27211}]
    WORK.mkdir(parents=True, exist_ok=True)

    def build(capture):
        model = init_weights(build_model(load_config(None, overrides=cfg)), 0)
        return Trainer(model, losses=losses, metrics=[], lr=1e-3,
                       train_dir=str(WORK / "soc_band"), device=dev, capture=capture)

    tr = build(False)
    k_np = k_vecs_for_graph(graph, nk, None, rng=np.random.default_rng(6))
    tr.model.eval()
    with torch.inference_mode():
        reset_launches(tp_kernel)
        out = tr.model(graph, k_vecs=torch.as_tensor(k_np, device=dev))
        torch.cuda.synchronize()
        check_launches(tp_kernel, {"packed_tp_fwd": 4 * layers + 1}, "one SOC band forward")
    shapes = {"band_energy": (4, nk, 2 * width), "band_energy_ref": (4, nk, 2 * width),
              "band_gap": (4,), "wavefunction": (4, nk, 2 * width, norb)}
    for key, shape in shapes.items():
        if tuple(out[key].shape) != shape or not bool(torch.isfinite(out[key].abs()).all()):
            fail(f"SOC band forward: {key} has shape {tuple(out[key].shape)}, expected "
                 f"{shape}, finite")
    basis = get_basis_set("openmx", SOC_NAO)
    ref = out["band_energy_ref"].cpu().numpy()
    worst = 0.0
    for b, c in enumerate(crystals):
        host = host_soc_bands(c, k_np[b].astype(np.float64), basis, width)
        worst = max(worst, float(np.abs(ref[b] - host).max()))
    if not worst <= BAND_TOL:
        fail(f"SOC band_energy_ref vs the float64 host solve: max|d| {worst:.3e} > {BAND_TOL}")
    del out

    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(tp_kernel)
    loss, logs = tr.train_step(graph)
    torch.cuda.synchronize()
    launches = check_launches(tp_kernel, {k: 4 * layers + 1 for k in ENGINES["auto"]},
                              "one eager SOC band train step")
    if not math.isfinite(float(loss)) or float(logs["nonfinite_step"]) != 0.0 \
            or not math.isfinite(float(logs["mae_band_energy"])):
        fail(f"SOC band train step: loss {float(loss)}, logs {logs}")
    if not bool(torch.isfinite(tr.grad).all()) or float(tr.grad.abs().max()) == 0.0:
        fail("SOC band train step: gradients are not finite, or all zero")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    del tr
    torch.cuda.empty_cache()
    print(f"[soc] band: 4 crystals x 16 atoms ({n_edges} edges, {graph.num_edges} padded), "
          f"{nk} k, H(k) {norb} x {norb} complex64: band_energy_ref vs float64 host solve "
          f"max|d| {worst:.3e} (limit {BAND_TOL}); eager step launches {launches}, loss "
          f"{float(loss):.6f}, mae_band_energy {float(logs['mae_band_energy']):.6f}; peak "
          f"memory {peak_gb:.2f} GB, card {card}", flush=True)
    cmp = band_captured_vs_eager(tp_kernel, dev, card, "soc_band", build, graph, graph2,
                                 solves=2, tp_launches=4 * layers + 1)
    return dict(launches=launches, n_edges=n_edges, padded_edges=graph.num_edges, norb=norb,
                nk=nk, ref_vs_host_max_abs_err=worst, peak_gb=peak_gb, loss=float(loss),
                captured_vs_eager=cmp, step_ms=cmp["wall_ms"])


def phase_soc_cli(tp_kernel):
    """``stage: fit`` of the so3 SOC model for two epochs on 3 SOC crystals,
    then ``stage: test`` with ``checkpoint_path: <train_dir>/best`` (the
    reference's name; the trainer writes best.pt), against ``stage: test``
    with no checkpoint (the untrained model)."""
    import numpy as np
    import yaml

    from hamgnn_tpu_torch import cli
    from hamgnn_tpu_torch.data.dataset import save_graph_npz

    work = WORK / "cli_soc"
    work.mkdir(parents=True, exist_ok=True)
    crystals = soc_crystals(np.random.default_rng(3), 3, 8, 6.0, 5.0)
    save_graph_npz(str(work / "graph_data.npz"), crystals)
    cfg, losses = soc_config("so3")
    cfg["setup"] = {"stage": "fit"}
    cfg["dataset_params"] = {"graph_data_path": str(work), "batch_size": 1,
                             "train_ratio": 1 / 3, "val_ratio": 1 / 3, "test_ratio": 1 / 3}
    cfg["optim_params"] = {"lr": 1e-3, "min_epochs": 0, "max_epochs": 2}
    cfg["losses_metrics"] = {"losses": losses, "metrics": losses}
    cfg["profiler_params"] = {"train_dir": str(work / "fit")}
    with open(work / "fit.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    reset_launches(tp_kernel)
    t0 = time.perf_counter()
    cli.main(["--config", str(work / "fit.yaml")])
    fit_s = time.perf_counter() - t0
    launches = {n: k.launches for n, k in all_kernels(tp_kernel).items() if k.launches}
    if set(launches) != set(ENGINES["auto"]):
        fail(f"the SOC fit run should launch {ENGINES['auto']} and no other: {launches}")
    records = [json.loads(line) for line in open(work / "fit" / "metrics.jsonl")]
    if [r["epoch"] for r in records] != [0, 1] or not all(
            math.isfinite(r["train_loss"]) and math.isfinite(r["val_loss"]) for r in records):
        fail(f"SOC fit metrics.jsonl: {records}")
    if not (work / "fit" / "best.pt").exists():
        fail("the SOC fit run wrote no best.pt")

    rows = sum(c["z"].shape[0] + c["edge_index"].shape[1] for c in crystals)
    preds = {}
    for name, ckpt in (("best", str(work / "fit" / "best")), ("untrained", str(work / "none"))):
        cfg["setup"] = {"stage": "test", "checkpoint_path": ckpt}
        cfg["dataset_params"]["batch_size"] = 2
        cfg["profiler_params"] = {"train_dir": str(work / f"test_{name}")}
        with open(work / f"test_{name}.yaml", "w") as f:
            yaml.safe_dump(cfg, f)
        cli.main(["--config", str(work / f"test_{name}.yaml")])
        for part in ("real", "imag"):
            path = work / f"test_{name}" / f"prediction_hamiltonian_{part}.npy"
            if not path.exists():
                fail(f"SOC test run ({name}) wrote no {path.name}")
            arr = np.load(path)
            if arr.shape != (rows, (2 * SOC_NAO) ** 2) or not np.isfinite(arr).all():
                fail(f"SOC test run ({name}): {path.name} shape {arr.shape}, expected "
                     f"({rows}, {(2 * SOC_NAO) ** 2}), finite")
            preds[name, part] = arr
    moved = max(float(np.abs(preds["best", p] - preds["untrained", p]).max())
                for p in ("real", "imag"))
    if not moved > 0.0:
        fail("stage test from <train_dir>/best predicts as the untrained model")
    print(f"[soc] cli: stage fit 2 epochs in {fit_s:.1f} s, launches {launches}, train_loss "
          f"{[round(r['train_loss'], 6) for r in records]}, val_loss "
          f"{[round(r['val_loss'], 6) for r in records]}; stage test from <train_dir>/best: "
          f"{rows} rows x {(2 * SOC_NAO) ** 2} real and imag written, max|d| {moved:.3e} from "
          f"the untrained model's", flush=True)
    return dict(fit_s=fit_s, launches=launches, records=records, best_vs_untrained=moved)


def phase_soc(tp_kernel, dev, card):
    """Phase 8: the SOC slice on the card (see the module docstring); each
    part's seconds printed."""
    seconds = {}

    def part(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = time.perf_counter() - t0
        print(f"[soc] {name} done in {seconds[name]:.1f} s", flush=True)
        return out

    kernels = part("kernels", phase_soc_kernels, tp_kernel, dev)
    graph, n_edges = part("graph", soc_bench_graph, dev)
    forward = part("forward", phase_soc_forward, tp_kernel, dev, card, graph, n_edges)
    # the step of the config's so3 head under both engines, su2's under the default one
    steps = {f"{basis}:{eng}": part(f"step_{basis}_{eng}", phase_soc_step, tp_kernel, dev,
                                    card, graph, n_edges, basis, eng, False)
             for basis, eng in (("so3", "auto"), ("so3", "zonal"), ("su2", "auto"))}
    ckpt = {eng: part(f"step_so3_{eng}_ckpt", phase_soc_step, tp_kernel, dev, card, graph,
                      n_edges, "so3", eng, True)
            for eng in ENGINES}
    del graph
    band = part("band", phase_soc_band, tp_kernel, dev, card)
    cli_run = part("cli", phase_soc_cli, tp_kernel)
    return dict(kernels=kernels, n_edges=n_edges, forward=forward, steps=steps,
                checkpointed_steps=ckpt, band=band, cli=cli_run, seconds=seconds)


# the magnetic slice: examples/sk_collinear, sk_ncl and sk_spinsoc's model
# (3 layers, sk_soc's features, nao 14) on the bench crystal's graph, whose
# 6 A cutoff replaces the configs' 9 A (~3.4x the edges), with synthetic spin
# fields from seed 1 (the configs' datasets are made by a JAX tool)
MAG_CONFIGS = {"collinear": ROOT / "examples" / "sk_collinear" / "config.yaml",
               "noncollinear": ROOT / "examples" / "sk_ncl" / "config.yaml",
               "spinsoc": ROOT / "examples" / "sk_spinsoc" / "config.yaml"}
MAG_NAO = 14


def mag_config(mode, **out):
    """(model config, its losses) of the mode's shipped config with the
    graph's cutoff and ``out`` over the head's keys; the collinear config
    names no losses and takes the default MAE x 27.211 on ``hamiltonian``."""
    import yaml

    with open(MAG_CONFIGS[mode]) as f:
        src = yaml.safe_load(f)
    cfg = {"representation_nets": src["representation_nets"],
           "output_nets": src["output_nets"]}
    cfg["representation_nets"]["HamGNN_pre"]["cutoff"] = SOC_CUTOFF
    cfg["output_nets"]["HamGNN_out"].update(out)
    losses = src.get("losses_metrics", {}).get("losses", BENCH_LOSSES)
    return cfg, losses


def mag_crystals(rng, mode, n, n_atoms, cell_size, cutoff):
    from hamgnn_tpu_torch.data.synthetic import (add_random_hamiltonian_targets,
                                                 add_random_spin_targets, make_crystal)

    return [add_random_spin_targets(rng, add_random_hamiltonian_targets(
        rng, make_crystal(rng, n_atoms=n_atoms, cell_size=cell_size, cutoff=cutoff),
        nao_max=MAG_NAO), mode, nao_max=MAG_NAO) for _ in range(n)]


def mag_bench_graph(dev, mode):
    """The bench crystal (512 atoms, 6 A, 19,672 edges padded to 19,968)
    with the mode's spin fields at nao 14, seed 1."""
    import numpy as np

    from hamgnn_tpu_torch.data.graph import pad_and_batch
    from hamgnn_tpu_torch.data.synthetic import add_random_spin_targets, bench_crystal

    crystal = add_random_spin_targets(np.random.default_rng(1), bench_crystal(nao_max=MAG_NAO),
                                      mode, nao_max=MAG_NAO)
    n_edges = int(crystal["edge_index"].shape[1])
    graph = pad_and_batch([crystal], node_bucket=512,
                          edge_bucket=((n_edges + 511) // 512) * 512, device=dev)
    return graph, n_edges


def phase_mag_case(tp_kernel, dev, card, graph, n_edges, mode, eng, learned=False):
    """One magnetic branch under engine ``eng`` at the configs' width: the
    forward against the same model through the plain TP (13 launches of the
    engine's forward kernel, within 1e-4 * max|ref|; non-collinear: the real
    part Hermitian and the imaginary part anti-Hermitian through the inverse
    edge within 1e-6 * max|ref|); the training step eager (13 + 13
    launches) and captured from the same weights under deterministic
    algorithms (loss within 1e-6 relative, gradients within 1e-5 * max|ref|
    per tensor); then in the default mode both forms timed in turns (wall,
    median of 3), one replay's device time by kernel and its launches by
    device kernel name (13 of each of the engine's), and the first step's
    peak memory."""
    import numpy as np
    import torch

    from hamgnn_tpu_torch.cli import build_model
    from hamgnn_tpu_torch.models.model import init_weights
    from hamgnn_tpu_torch.train.config import load_config
    from hamgnn_tpu_torch.train.trainer import Trainer

    cfg, losses = mag_config(mode, use_learned_weight=learned)
    layers = cfg["representation_nets"]["HamGNN_pre"]["num_layers"]
    per = 4 * layers + 1
    tag = f"{mode}_{eng}" + ("_learned" if learned else "")
    fwd, bwd = ENGINES[eng]
    WORK.mkdir(parents=True, exist_ok=True)
    # a trainer and its captured steps form a reference cycle: collect the
    # earlier ones, so that the peak below is this case's
    gc.collect()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated(dev) / 1e9
    keys = ("hamiltonian_on", "hamiltonian_off") if mode == "collinear" else (
        "hamiltonian_real_on", "hamiltonian_real_off", "hamiltonian_imag_on",
        "hamiltonian_imag_off")
    with engine(eng):
        trs, peaks = {}, {}
        for form, capture in (("eager", False), ("captured", None)):
            model = init_weights(build_model(load_config(None, overrides=cfg)), 0)
            trs[form] = Trainer(model, losses=losses, metrics=[], lr=1e-3,
                                train_dir=str(WORK / f"mag_{form}_{tag}"), device=dev,
                                capture=capture)
        eager, cap = trs["eager"], trs["captured"]
        if eager.captured is not None or cap.captured is None:
            fail(f"magnetic step ({tag}): the default trainer must capture, capture=False not")

        # the forward against the plain TP
        model = eager.model.eval()
        with torch.inference_mode():
            with engine("xla"):
                ref = model(graph)
            reset_launches(tp_kernel)
            out = model(graph)
            torch.cuda.synchronize()
            check_launches(tp_kernel, {fwd: per}, f"one magnetic forward ({tag})")
        errs = {}
        for key in keys:
            err, scale = rel_err(out[key], ref[key])
            errs[key] = (err, scale)
            if not math.isfinite(err) or err > TOL * scale:
                fail(f"magnetic forward {key} ({tag}) vs plain TP: max|d| {err:.3e} > "
                     f"{TOL} * {scale:.3e}")
        herm = None
        if mode != "collinear":
            scale = max(s_ for _e, s_ in errs.values())
            herm = soc_hermiticity(out, graph, "su2")
            if not herm <= 1e-6 * scale:
                fail(f"magnetic forward ({tag}): Hermitian structure off by {herm:.3e} > "
                     f"1e-6 * {scale:.3e}")
        del ref, out

        # captured against eager, deterministic
        torch.use_deterministic_algorithms(True)
        try:
            for form in ("eager", "captured"):
                # the first step's peak: the captured form's warm-up, capture
                # and replay (a replay allocates nothing)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                reset_launches(tp_kernel)
                loss, logs = trs[form].train_step(graph)
                torch.cuda.synchronize()
                peaks[form] = torch.cuda.max_memory_allocated(dev) / 1e9
                if form == "eager":
                    launches = check_launches(tp_kernel, {fwd: per, bwd: per},
                                              f"one eager magnetic step ({tag})")
                    la = float(loss)
                else:
                    lb = float(loss)
                if not math.isfinite(float(loss)) or float(logs["nonfinite_step"]) != 0.0:
                    fail(f"magnetic step ({tag}, {form}): loss {float(loss)}")
        finally:
            torch.use_deterministic_algorithms(False)
        if not abs(lb - la) <= 1e-6 * abs(la):
            fail(f"magnetic captured step ({tag}) loss {lb!r} vs eager {la!r}: above 1e-6 "
                 "relative")
        ofs, worst = 0, 0.0
        for name, p in eager.model.named_parameters():
            err, scale = rel_err(cap.grad[ofs:ofs + p.numel()], eager.grad[ofs:ofs + p.numel()])
            ofs += p.numel()
            if not err <= 1e-5 * scale:
                fail(f"magnetic captured step ({tag}) gradient {name}: max|d| {err:.3e} > "
                     f"1e-5 * {scale:.3e}")
            worst = max(worst, err / scale if scale else 0.0)

        # the default mode: both forms timed in turns, one replay profiled
        times = {"eager": [], "captured": []}
        for _ in range(3):
            for form in ("eager", "captured"):
                times[form].append(_host_time(lambda: trs[form].train_step(graph)))
        names = [n for k in ENGINES[eng] for n in tp_kernel.KERNELS[k].device_kernels]
        reads = profiled_launches(lambda: cap.train_step(graph), names, per)
        replay = reads[-1]
        if replay != {n: per for n in names}:
            fail(f"one replay of the magnetic step ({tag}) launched {reads} (profiler traces), "
                 f"expected {per} of each")
        device = profile_train_step(cap, graph, f"profile_mag_step_{tag}.txt")
    result = dict(first_loss=[la, lb], worst_grad_rel_err=worst, peak_gb=peaks,
                  held_before_gb=held_gb, launches=launches, replay_launches=replay,
                  hermiticity=herm,
                  errors={k: list(v) for k, v in errs.items()},
                  device_ms=device["__all__"], device_ms_by_kernel=device)
    for form, ts in times.items():
        ms = 1e3 * float(np.median(ts))
        result[form] = dict(ms=ms, times_ms=[1e3 * t for t in ts],
                            edges_per_s=n_edges / (ms * 1e-3))
    print(f"[magnetic] {tag}: forward vs plain TP " + ", ".join(
        f"{k[12:]} {e:.3e} of {s_:.3e}" for k, (e, s_) in errs.items())
        + (f", Hermitian to {herm:.3e}" if herm is not None else "")
        + f"; eager launches {launches}; deterministic, captured vs eager loss {lb!r} vs "
        f"{la!r}, worst gradient {worst:.3e} of max|ref|; eager {result['eager']['ms']:.3f} ms, "
        f"captured {result['captured']['ms']:.3f} ms (median of 3) = "
        f"{result['captured']['edges_per_s']:.1f} edges/s; one replay: device kernels "
        f"{device['__all__']:.3f} ms, launches {replay}; peak memory eager "
        f"{peaks['eager']:.2f} GB, captured {peaks['captured']:.2f} GB ({held_gb:.2f} GB "
        f"held before the case); card {card}",
        flush=True)
    del trs, eager, cap, model
    gc.collect()
    torch.cuda.empty_cache()
    return result


def phase_mag_band(tp_kernel, dev, card):
    """The collinear head's band branch at the configs' width on 4 crystals
    of 16 atoms (6 k, 2 x 8 bands per spin channel): shapes, each channel's
    reference bands against a float64 host solve within 5e-4, one eager
    training step with the band loss (13 + 13 launches), then the step and
    eval step as the trainer runs them by default, captured, against the
    eager ones (``band_captured_vs_eager``; a second shape key of 2
    crystals)."""
    import numpy as np
    import torch

    from hamgnn_tpu_torch.cli import build_model
    from hamgnn_tpu_torch.data.graph import pad_and_batch
    from hamgnn_tpu_torch.models.basis import get_basis_set
    from hamgnn_tpu_torch.models.model import init_weights
    from hamgnn_tpu_torch.physics.kpoints import k_vecs_for_graph
    from hamgnn_tpu_torch.train.config import load_config
    from hamgnn_tpu_torch.train.trainer import Trainer

    width, nk = BAND_OUT["band_num_control"], BAND_OUT["num_k"]

    def batch(seed, n):
        crystals = mag_crystals(np.random.default_rng(seed), "collinear", n, 16, 8.0, 5.0)
        n_edges = sum(c["edge_index"].shape[1] for c in crystals)
        return crystals, n_edges, pad_and_batch(
            crystals, node_bucket=16 * n, edge_bucket=((n_edges + 255) // 256) * 256,
            device=dev)

    crystals, n_edges, graph = batch(5, 4)
    graph2 = batch(7, 2)[2]
    norb = graph.num_nodes * MAG_NAO
    cfg, losses = mag_config("collinear", **BAND_OUT)
    layers = cfg["representation_nets"]["HamGNN_pre"]["num_layers"]
    losses = losses + [{"metric": "mae", "prediction": "band_energy", "target": "band_energy",
                        "loss_weight": 0.27211}]
    WORK.mkdir(parents=True, exist_ok=True)

    def build(capture):
        model = init_weights(build_model(load_config(None, overrides=cfg)), 0)
        return Trainer(model, losses=losses, metrics=[], lr=1e-3,
                       train_dir=str(WORK / "mag_band"), device=dev, capture=capture)

    tr = build(False)
    k_np = k_vecs_for_graph(graph, nk, None, rng=np.random.default_rng(6))
    tr.model.eval()
    with torch.inference_mode():
        reset_launches(tp_kernel)
        out = tr.model(graph, k_vecs=torch.as_tensor(k_np, device=dev))
        torch.cuda.synchronize()
        check_launches(tp_kernel, {"packed_tp_fwd": 4 * layers + 1},
                       "one collinear band forward")
    shapes = {"band_energy": (8, nk, 2 * width), "band_energy_ref": (8, nk, 2 * width),
              "band_energy_up": (4, nk, 2 * width), "band_gap": (8,),
              "wavefunction": (8, nk, 2 * width, norb)}
    for key, shape in shapes.items():
        if tuple(out[key].shape) != shape or not bool(torch.isfinite(out[key].abs()).all()):
            fail(f"collinear band forward: {key} has shape {tuple(out[key].shape)}, expected "
                 f"{shape}, finite")
    basis = get_basis_set("openmx", MAG_NAO)
    ref = out["band_energy_ref"].cpu().numpy()
    worst = 0.0
    for ch in range(2):
        for b, c in enumerate(crystals):
            channel = dict(c, Hon=c["Hon"][:, ch], Hoff=c["Hoff"][:, ch])
            host = host_bands(channel, k_np[b].astype(np.float64), basis, MAG_NAO, width)
            worst = max(worst, float(np.abs(ref[4 * ch + b] - host).max()))
    if not worst <= BAND_TOL:
        fail(f"collinear band_energy_ref vs the float64 host solve: max|d| {worst:.3e} > "
             f"{BAND_TOL}")
    del out

    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(tp_kernel)
    loss, logs = tr.train_step(graph)
    torch.cuda.synchronize()
    launches = check_launches(tp_kernel, {k: 4 * layers + 1 for k in ENGINES["auto"]},
                              "one eager collinear band train step")
    if not math.isfinite(float(loss)) or float(logs["nonfinite_step"]) != 0.0 \
            or not math.isfinite(float(logs["mae_band_energy"])):
        fail(f"collinear band train step: loss {float(loss)}, logs {logs}")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    del tr
    torch.cuda.empty_cache()
    print(f"[magnetic] band: 4 crystals x 16 atoms ({n_edges} edges, {graph.num_edges} "
          f"padded), {nk} k, 2 spin channels, H(k) {norb} x {norb} complex64: band_energy_ref "
          f"vs float64 host solve max|d| {worst:.3e} (limit {BAND_TOL}); eager step launches "
          f"{launches}, loss {float(loss):.6f}; peak memory {peak_gb:.2f} GB, card {card}",
          flush=True)
    cmp = band_captured_vs_eager(tp_kernel, dev, card, "mag_band", build, graph, graph2,
                                 solves=4, tp_launches=4 * layers + 1)
    return dict(launches=launches, n_edges=n_edges, norb=norb, nk=nk,
                ref_vs_host_max_abs_err=worst, peak_gb=peak_gb, loss=float(loss),
                captured_vs_eager=cmp, step_ms=cmp["wall_ms"])


def _shipped(path, work, name, **over):
    """The shipped config at ``path`` with ``over`` merged into its
    sections, written to ``work/name``; returns the written path."""
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    for section, keys in over.items():
        cfg.setdefault(section, {}).update(keys)
    out = work / name
    with open(out, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(out)


def phase_mag_cli(tp_kernel):
    """The shipped magnetic configs through the CLI, run in a scratch
    directory that holds their relative paths (``./datasets/...``,
    ``./train_out/...``), with only the epoch counts overridden: sk_collinear
    ``config.yaml`` (``stage: fit``, 2 epochs), ``config_band_test.yaml``
    (``stage: test`` from ``<train_dir>/best``), ``tools.band_cal`` on
    ``band_cal.yaml`` (``band_spin{0,1}_*``); sk_ncl and sk_spinsoc
    ``config.yaml``: fit 2 epochs, then ``stage: test`` from
    ``<train_dir>/best`` (``prediction_hamiltonian_{real,imag}.npy``)."""
    import numpy as np

    from hamgnn_tpu_torch import cli
    from hamgnn_tpu_torch.data.dataset import save_graph_npz
    from hamgnn_tpu_torch.tools import band_cal

    work = WORK / "cli_magnetic"
    epochs = {"optim_params": {"min_epochs": 0, "max_epochs": 2}}
    result = {}
    rng = np.random.default_rng(7)
    for mode, path in MAG_CONFIGS.items():
        name = path.parent.name
        # 5 crystals: 3 train, 1 validation, 1 test at the configs' ratios
        crystals = mag_crystals(rng, mode, 5, 8, 6.0, 5.0)
        (work / "datasets" / name).mkdir(parents=True, exist_ok=True)
        save_graph_npz(str(work / "datasets" / name / "graph_data.npz"), crystals)
        with contextlib.chdir(work):
            reset_launches(tp_kernel)
            t0 = time.perf_counter()
            cli.main(["--config", _shipped(path, work, f"{name}_fit.yaml", **epochs)])
            fit_s = time.perf_counter() - t0
            launches = {n: k.launches for n, k in all_kernels(tp_kernel).items() if k.launches}
            if set(launches) != set(ENGINES["auto"]):
                fail(f"the {name} fit run should launch {ENGINES['auto']} and no other: "
                     f"{launches}")
            train_dir = work / "train_out" / name
            records = [json.loads(line) for line in open(train_dir / "metrics.jsonl")]
            if [r["epoch"] for r in records] != [0, 1] or not all(
                    math.isfinite(r["train_loss"]) and math.isfinite(r["val_loss"])
                    for r in records):
                fail(f"{name} fit metrics.jsonl: {records}")
            if mode == "collinear":
                band_set = work / "datasets" / "sk_collinear_band"
                band_set.mkdir(parents=True, exist_ok=True)
                save_graph_npz(str(band_set / "graph_data.npz"), crystals[:2])
                cli.main(["--config", str(path.parent / "config_band_test.yaml")])
                pred_path = work / "train_out" / "sk_collinear_band_pred" / \
                    "prediction_hamiltonian.npy"
                band_cal.main(["--config", str(path.parent / "band_cal.yaml")])
                gaps = []
                for i in range(2):
                    for spin in range(2):
                        res = np.load(work / "train_out" / "sk_collinear" / "bands"
                                      / f"band_spin{spin}_{i}.npz")
                        if not np.isfinite(res["bands"]).all():
                            fail(f"band_cal spin {spin} crystal {i}: bands not finite")
                        gaps.append(float(res["gap"]))
                pred = np.load(pred_path)
                rows = sum(c["z"].shape[0] + c["edge_index"].shape[1] for c in crystals[:2])
                if pred.shape != (rows, 2, MAG_NAO ** 2) or not np.isfinite(pred).all():
                    fail(f"sk_collinear band test: prediction {pred.shape}, expected "
                         f"({rows}, 2, {MAG_NAO ** 2}), finite")
                result[mode] = dict(fit_s=fit_s, launches=launches, records=records,
                                    band_cal_gaps_ev=gaps)
                print(f"[magnetic] cli {name}: fit 2 epochs in {fit_s:.1f} s, launches "
                      f"{launches}, val_loss {[round(r['val_loss'], 6) for r in records]}; "
                      f"config_band_test from <train_dir>/best: {pred.shape}; band_cal "
                      f"band_spin0/1 gaps {[round(g, 4) for g in gaps]} eV", flush=True)
                continue
            cli.main(["--config", _shipped(
                path, work, f"{name}_test.yaml", **epochs,
                setup={"stage": "test", "checkpoint_path": f"./train_out/{name}/best"},
                profiler_params={"train_dir": f"./train_out/{name}_test"})])
            shapes = {}
            for part in ("real", "imag"):
                arr = np.load(work / "train_out" / f"{name}_test"
                              / f"prediction_hamiltonian_{part}.npy")
                if arr.shape[1:] != ((2 * MAG_NAO) ** 2,) or not np.isfinite(arr).all():
                    fail(f"{name} test: prediction_hamiltonian_{part} {arr.shape}, finite")
                shapes[part] = arr.shape
            result[mode] = dict(fit_s=fit_s, launches=launches, records=records,
                                test_shapes=shapes)
            print(f"[magnetic] cli {name}: fit 2 epochs in {fit_s:.1f} s, launches {launches}, "
                  f"val_loss {[round(r['val_loss'], 6) for r in records]}; test from "
                  f"<train_dir>/best: {shapes}", flush=True)
    return result


def phase_magnetic(tp_kernel, dev, card):
    """Phase 9: the magnetic slice on the card (see the module docstring);
    each part's seconds printed."""
    import torch

    seconds, steps = {}, {}

    def part(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = time.perf_counter() - t0
        print(f"[magnetic] {name} done in {seconds[name]:.1f} s", flush=True)
        return out

    n_edges = None
    for mode in MAG_CONFIGS:
        graph, n_edges = part(f"graph_{mode}", mag_bench_graph, dev, mode)
        for eng in ENGINES:
            steps[f"{mode}:{eng}"] = part(f"{mode}_{eng}", phase_mag_case, tp_kernel, dev,
                                          card, graph, n_edges, mode, eng)
        if mode == "collinear":
            steps["collinear:auto:learned"] = part(
                "collinear_auto_learned", phase_mag_case, tp_kernel, dev, card, graph,
                n_edges, mode, "auto", learned=True)
        del graph
        torch.cuda.empty_cache()
    band = part("band", phase_mag_band, tp_kernel, dev, card)
    cli_runs = part("cli", phase_mag_cli, tp_kernel)
    return dict(n_edges=n_edges, steps=steps, band=band, cli=cli_runs, seconds=seconds)


def phase_lmdb(tp_kernel, dev):
    """Phase 10: an npz of 6 crystals converted to an lmdb-lite store by the
    port's ``tools.npz_to_lmdb``; ``examples/sk_lmdb/config.yaml`` run for
    2 epochs on it (in a scratch directory holding its relative path); the
    store's batches on the card bit-identical to the npz's, in every split."""
    import numpy as np
    import torch

    from hamgnn_tpu_torch import cli
    from hamgnn_tpu_torch.data.dataset import (GraphDataModule, LmdbGraphStore,
                                               load_graph_npz, save_graph_npz)
    from hamgnn_tpu_torch.data.synthetic import add_random_hamiltonian_targets, make_crystal
    from hamgnn_tpu_torch.train.captured import tensor_fields
    from hamgnn_tpu_torch.tools.npz_to_lmdb import convert

    work = WORK / "cli_lmdb"
    data_dir = work / "datasets" / "sk_small"
    data_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(8)
    crystals = [add_random_hamiltonian_targets(
        rng, make_crystal(rng, n_atoms=8, cell_size=6.0, cutoff=5.0), nao_max=14)
        for _ in range(6)]
    npz = str(data_dir / "graph_data.npz")
    save_graph_npz(npz, crystals)
    store_path = str(data_dir / "graph_data.lmdb")
    if convert(npz, store_path) != len(crystals):
        fail("npz_to_lmdb wrote another number of graphs")
    dms = [GraphDataModule(g, batch_size=4, device=dev)
           for g in (load_graph_npz(npz), LmdbGraphStore(store_path))]
    if not isinstance(dms[1].graphs, LmdbGraphStore):
        fail("the data module read the store into a list")
    n_batches = 0
    for split in ("train", "val", "test"):
        its = [getattr(dm, f"{split}_batches")(*([np.random.default_rng(0)]
                                                 if split == "train" else []))
               for dm in dms]
        for a, b in zip(*its, strict=True):
            fa, fb = tensor_fields(a), tensor_fields(b)
            if set(fa) != set(fb) or not all(torch.equal(fa[k], fb[k]) for k in fa):
                fail(f"lmdb {split} batch differs from the npz batch")
            n_batches += 1
    config = ROOT / "examples" / "sk_lmdb" / "config.yaml"
    with contextlib.chdir(work):
        reset_launches(tp_kernel)
        t0 = time.perf_counter()
        cli.main(["--config", _shipped(config, work, "sk_lmdb_fit.yaml",
                                       optim_params={"min_epochs": 0, "max_epochs": 2})])
        fit_s = time.perf_counter() - t0
    launches = {n: k.launches for n, k in all_kernels(tp_kernel).items() if k.launches}
    if set(launches) != set(ENGINES["auto"]):
        fail(f"the sk_lmdb fit run should launch {ENGINES['auto']} and no other: {launches}")
    records = [json.loads(line)
               for line in open(work / "train_out" / "sk_lmdb" / "metrics.jsonl")]
    if [r["epoch"] for r in records] != [0, 1] or not all(
            math.isfinite(r["train_loss"]) and math.isfinite(r["val_loss"]) for r in records):
        fail(f"sk_lmdb fit metrics.jsonl: {records}")
    print(f"[lmdb] {len(crystals)} crystals to an lmdb-lite store; {n_batches} batches on the "
          f"card bit-identical to the npz's; sk_lmdb fit 2 epochs in {fit_s:.1f} s, launches "
          f"{launches}, val_loss {[round(r['val_loss'], 6) for r in records]}", flush=True)
    return dict(n_batches=n_batches, fit_s=fit_s, launches=launches, records=records)


REP_CONFIG = ROOT / "examples" / "sk" / "config.yaml"
# case -> (setup keys, representation keys) over examples/sk/config.yaml: (a)
# the Transformer (2 heads: the most that divide every multiplicity of the sk
# features), (b) ConvE3 with the correlation block, (c) ConvE3 with KAN
REP_CASES = {"transformer": ({"GNN_Net": "HamGNNTransformer"},
                             {"num_heads": 2, "correlation": 2, "num_hidden_features": 16}),
             "corr": ({}, {"use_corr_prod": True, "correlation": 2,
                           "num_hidden_features": 16}),
             "kan": ({}, {"use_kan": True})}
REP_RUNS = (("transformer", "auto"), ("transformer", "zonal"), ("corr", "auto"),
            ("kan", "auto"))


def rep_config(case, cutoff=SOC_CUTOFF):
    """``examples/sk/config.yaml`` with the case's setup and representation
    keys and the representation's cutoff set to ``cutoff``."""
    import yaml

    with open(REP_CONFIG) as f:
        cfg = yaml.safe_load(f)
    setup, pre = REP_CASES[case]
    cfg["setup"].update(setup)
    cfg["representation_nets"]["HamGNN_pre"].update(cutoff=cutoff, **pre)
    return cfg


def rep_bench_graph(dev):
    """The bench crystal (512 atoms, 6 A, 19,672 edges padded to 19,968)
    with targets at nao 14."""
    from hamgnn_tpu_torch.data.graph import pad_and_batch
    from hamgnn_tpu_torch.data.synthetic import bench_crystal

    crystal = bench_crystal(nao_max=SOC_NAO)
    n_edges = int(crystal["edge_index"].shape[1])
    graph = pad_and_batch([crystal], node_bucket=512,
                          edge_bucket=((n_edges + 511) // 512) * 512, device=dev)
    return graph, n_edges


def _state(tr):
    return [tr.flat, *tr.opt.state_dict().values()]


def grad_spread(a, b) -> dict:
    """How far trainer ``b``'s flat gradient is from ``a``'s: the largest
    max|d| / max|ref| over parameter tensors, and the largest max|d| over the
    largest gradient of all (a tensor whose gradient is zero in exact
    arithmetic holds only rounding, so its own ratio can reach 1)."""
    worst, largest, top = 0.0, float(a.grad.abs().max()), 0.0
    ofs = 0
    for p in a.model.parameters():
        err, scale = rel_err(b.grad[ofs:ofs + p.numel()], a.grad[ofs:ofs + p.numel()])
        ofs += p.numel()
        worst = max(worst, err / scale if scale else 0.0)
        top = max(top, err)
    return dict(worst_grad_rel_err=worst, worst_of_largest=top / largest if largest else 0.0)


def phase_rep_case(tp_kernel, dev, card, graph, n_edges, case, eng):
    """One representation network at the sk width under engine ``eng``: the
    forward against the same model through the plain TP (13 launches of the
    engine's forward kernel and no other, within 1e-4 * max|ref|); the
    training step (MAE x 27.211 on ``hamiltonian``, amsgrad at lr 1e-3) eager
    (13 + 13 launches) and captured from the same weights under deterministic
    algorithms, bit for bit (loss, gradients, updated parameters); one more
    step of each in the default mode, its spread reported and not held to a
    limit; both forms timed in turns (wall, median of 3), one replay's
    launches by device kernel name (13 of each) and its device time by
    kernel (``profile_rep_<case>_<engine>.txt`` in the report directory); the first step's
    peak memory, and the memory held before the case and after it."""
    import numpy as np
    import torch

    from hamgnn_tpu_torch.cli import build_model
    from hamgnn_tpu_torch.models.model import init_weights
    from hamgnn_tpu_torch.train.config import load_config
    from hamgnn_tpu_torch.train.trainer import Trainer

    cfg = rep_config(case)
    per = 4 * cfg["representation_nets"]["HamGNN_pre"]["num_layers"] + 1
    tag = f"{case}_{eng}"
    fwd, bwd = ENGINES[eng]
    WORK.mkdir(parents=True, exist_ok=True)
    gc.collect()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated(dev) / 1e9
    keys = ("hamiltonian_on", "hamiltonian_off")
    with engine(eng):
        trs, peaks = {}, {}
        for form, capture in (("eager", False), ("captured", None)):
            model = init_weights(build_model(load_config(None, overrides=cfg)), 0)
            trs[form] = Trainer(model, losses=BENCH_LOSSES, metrics=[], lr=1e-3,
                                train_dir=str(WORK / f"rep_{form}_{tag}"), device=dev,
                                capture=capture)
        eager, cap = trs["eager"], trs["captured"]
        if eager.captured is not None or cap.captured is None:
            fail(f"{tag} step: the default trainer must capture, capture=False not")

        model = eager.model.eval()
        with torch.inference_mode():
            with engine("xla"):
                ref = model(graph)
            reset_launches(tp_kernel)
            out = model(graph)
            torch.cuda.synchronize()
            check_launches(tp_kernel, {fwd: per}, f"one {tag} forward")
        errs = {}
        for key in keys:
            err, scale = rel_err(out[key], ref[key])
            errs[key] = (err, scale)
            if not math.isfinite(err) or err > TOL * scale:
                fail(f"{tag} forward {key} vs plain TP: max|d| {err:.3e} > {TOL} * {scale:.3e}")
        del ref, out

        torch.use_deterministic_algorithms(True)
        try:
            losses = {}
            for form in ("eager", "captured"):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                reset_launches(tp_kernel)
                loss, logs = trs[form].train_step(graph)
                torch.cuda.synchronize()
                peaks[form] = torch.cuda.max_memory_allocated(dev) / 1e9
                losses[form] = float(loss)
                if form == "eager":
                    launches = check_launches(tp_kernel, {fwd: per, bwd: per},
                                              f"one eager {tag} step")
                if not math.isfinite(float(loss)) or float(logs["nonfinite_step"]) != 0.0:
                    fail(f"{tag} step ({form}): loss {float(loss)}")
        finally:
            torch.use_deterministic_algorithms(False)
        la, lb = losses["eager"], losses["captured"]
        if la != lb or not all(torch.equal(a, b) for a, b in zip(
                [eager.grad, *_state(eager)], [cap.grad, *_state(cap)])):
            fail(f"{tag}: the captured step differs from the eager one under deterministic "
                 f"algorithms (loss {lb!r} vs {la!r})")

        # the default mode from the same state: the atomic sums' spread
        la2, lb2 = (float(trs[form].train_step(graph)[0]) for form in ("eager", "captured"))
        spread = grad_spread(eager, cap)

        times = {"eager": [], "captured": []}
        for _ in range(3):
            for form in ("eager", "captured"):
                times[form].append(_host_time(lambda: trs[form].train_step(graph)))
        names = [n for k in ENGINES[eng] for n in tp_kernel.KERNELS[k].device_kernels]
        reads = profiled_launches(lambda: cap.train_step(graph), names, per)
        replay = reads[-1]
        if replay != {n: per for n in names}:
            fail(f"one replay of the {tag} step launched {reads} (profiler traces), expected "
                 f"{per} of each")
        device = profile_train_step(cap, graph, f"profile_rep_{tag}.txt")
    result = dict(first_loss=[la, lb], default_mode=dict(loss=[la2, lb2], **spread),
                  peak_gb=peaks, held_before_gb=held_gb, launches=launches,
                  replay_launches=replay, errors={k: list(v) for k, v in errs.items()},
                  device_ms=device["__all__"], device_ms_by_kernel=device)
    for form, ts in times.items():
        ms = 1e3 * float(np.median(ts))
        result[form] = dict(ms=ms, times_ms=[1e3 * t for t in ts],
                            edges_per_s=n_edges / (ms * 1e-3))
    del trs, eager, cap, model
    gc.collect()
    torch.cuda.empty_cache()
    result["held_after_gb"] = torch.cuda.memory_allocated(dev) / 1e9
    print(f"[representation] {tag}: forward vs plain TP " + ", ".join(
        f"{k[12:]} {e:.3e} of {s_:.3e}" for k, (e, s_) in errs.items())
        + f"; eager launches {launches}; deterministic: captured = eager bit for bit (loss "
        f"{la!r}); default mode: loss {lb2!r} vs {la2!r}, gradients apart by "
        f"{spread['worst_of_largest']:.3e} of the largest gradient, at most "
        f"{spread['worst_grad_rel_err']:.3e} of a tensor's own (atomic sums, not held to a "
        f"limit); eager {result['eager']['ms']:.3f} ms, "
        f"captured {result['captured']['ms']:.3f} ms (median of 3) = "
        f"{result['captured']['edges_per_s']:.1f} edges/s; one replay: device kernels "
        f"{device['__all__']:.3f} ms, launches {replay}; peak memory eager "
        f"{peaks['eager']:.2f} GB, captured {peaks['captured']:.2f} GB; held before "
        f"{held_gb:.3f} GB, after {result['held_after_gb']:.3f} GB; card {card}", flush=True)
    return result


def _device_ms(fn, n=3) -> tuple:
    """(device ms, kernel launches) per ``fn()`` summed over the device
    kernels of a torch.profiler trace of ``n`` runs after one warm-up: the
    device's time alone, which CUDA events around an eager call of many
    small ops would mix with the host's launch time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hamgnn_tpu_torch.utils.profiling import PROFILER_LEAD_S

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_LEAD_S)
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ms, count = 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dev_us = getattr(ev, "self_device_time_total", None)
            ms += (ev.self_cuda_time_total if dev_us is None else dev_us) / 1e3
            count += ev.count
    return ms / n, count // n


def phase_rep_dense(dev, graph):
    """Device time (torch.profiler, the mean of 3 runs) of the new dense ops
    at the sk width on the bench graph, forward and backward: one
    correlation block on the 512 nodes, the (E, 2) edge softmax with its
    segment sums, the attention's weighted (E, 2, 230) segment sum, and a KAN
    radial generator beside the MLP generator it replaces (64 -> 64 -> 64 ->
    the node plan's scale channels).  Also what a product on a stream not
    used before leaves held (cuBLAS's workspace for that stream)."""
    import torch

    from hamgnn_tpu_torch.e3.irreps import Irreps
    from hamgnn_tpu_torch.models.model import init_weights
    from hamgnn_tpu_torch.nn.attention import edge_softmax
    from hamgnn_tpu_torch.nn.blocks import CorrProductBlock, MessagePackBlock, segment_sum
    from hamgnn_tpu_torch.nn.mlp import make_weight_generator
    from hamgnn_tpu_torch.train.config import load_config

    pre = load_config(None, overrides=rep_config("corr")).representation_nets.HamGNN_pre
    feat = Irreps(pre.irreps_node_features)
    gen = torch.Generator(device="cpu").manual_seed(3)
    n, e = graph.num_nodes, graph.num_edges
    dst = graph.edge_index[1]

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev).requires_grad_(True)

    def fwd_bwd(fn, *args):
        def run():
            out = fn(*args)
            out.backward(torch.ones_like(out))
        return _device_ms(run)

    result = {}
    corr = init_weights(CorrProductBlock(feat, pre.num_hidden_features, pre.correlation,
                                         pre.num_types), 0).to(dev)
    attrs = torch.nn.functional.one_hot(graph.z, pre.num_types).to(torch.float32)
    result["corr_block"] = fwd_bwd(corr, randn(n, feat.dim), attrs)
    logits = randn(e, 2)
    result["edge_softmax"] = fwd_bwd(lambda x: edge_softmax(x, dst, n, graph.edge_mask), logits)
    w, v = randn(e, 2), randn(e, 2, feat.dim // 2)
    result["attention_segment_sum"] = fwd_bwd(
        lambda a, b: segment_sum(a[:, :, None] * b, dst, n), w, v)
    sh = Irreps(pre.irreps_edge_sh)
    width = MessagePackBlock(feat, feat, sh, feat, pre.num_radial).node_scaler.weight_numel
    scal = randn(e, pre.num_radial)
    for kan in (False, True):
        g = init_weights(make_weight_generator(pre.num_radial, pre.radial_MLP, width,
                                               use_kan=kan), 0).to(dev)
        result["kan_generator" if kan else "mlp_generator"] = fwd_bwd(g, scal)
    print("[representation] dense ops, forward + backward, device ms (launches): " + ", ".join(
        f"{k} {ms:.4f} ({c})" for k, (ms, c) in result.items())
        + f"; generator width {width}", flush=True)
    result = {k: dict(ms=ms, launches=c) for k, (ms, c) in result.items()}
    result["generator_width"] = width
    # what a product on a stream not used before leaves held: cuBLAS's
    # workspace for that stream, kept for the life of the process
    a = torch.randn(256, 256, device=dev)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    with torch.cuda.stream(torch.cuda.Stream(device=dev)):
        a @ a
    torch.cuda.synchronize()
    result["new_stream_held_mb"] = (torch.cuda.memory_allocated(dev) - before) / 1e6
    print(f"[representation] a product on a new stream left "
          f"{result['new_stream_held_mb']:.2f} MB held", flush=True)
    return result


def phase_rep_v2(tp_kernel, dev):
    """``MessagePackBlockV2`` at the sk width on 1,024 edges: forward and
    backward through the kernels (B1 twice, B2 twice) against the same block
    through the plain TP, the output within 1e-4 * max|ref| and every
    gradient (parameters and inputs) within 1e-3 * max|ref| per tensor."""
    import torch

    from hamgnn_tpu_torch.e3.irreps import Irreps
    from hamgnn_tpu_torch.e3.spherical import spherical_harmonics
    from hamgnn_tpu_torch.models.model import init_weights
    from hamgnn_tpu_torch.nn.blocks import MessagePackBlockV2

    pre = rep_config("corr")["representation_nets"]["HamGNN_pre"]
    feat, sh_irreps = Irreps(pre["irreps_node_features"]), Irreps(pre["irreps_edge_sh"])
    e = 1024
    gen = torch.Generator(device="cpu").manual_seed(4)
    block = init_weights(MessagePackBlockV2(feat, feat, sh_irreps, feat, pre["num_radial"],
                                            radial_mlp=tuple(pre["radial_MLP"])), 0).to(dev)
    # the edge SH take no gradient, as in the model
    sh = spherical_harmonics([ir.l for _, ir in sh_irreps], torch.randn(e, 3, generator=gen),
                             normalize=True).to(dev)
    src, dst, edge = (torch.randn(e, feat.dim, generator=gen).to(dev).requires_grad_(True)
                      for _ in range(3))
    scal = torch.randn(e, pre["num_radial"], generator=gen).to(dev).requires_grad_(True)
    R = torch.randn(e, feat.dim, generator=gen).to(dev)
    wrt = list(block.parameters()) + [src, dst, edge, scal]

    def run():
        out = block(src, dst, edge, sh, scal)
        return out, torch.autograd.grad((out * R).sum(), wrt)

    with engine("xla"):
        ref, ref_g = run()
    fwd, bwd = ENGINES["auto"]
    with engine("auto"):
        reset_launches(tp_kernel)
        out, got_g = run()
        torch.cuda.synchronize()
        launches = check_launches(tp_kernel, {fwd: 2, bwd: 2}, "one V2 forward and backward")
    err, scale = rel_err(out, ref)
    if not math.isfinite(err) or err > TOL * scale:
        fail(f"MessagePackBlockV2 vs plain TP: max|d| {err:.3e} > {TOL} * {scale:.3e}")
    worst = 0.0
    for i, (a, b) in enumerate(zip(got_g, ref_g)):
        gerr, gscale = rel_err(a, b)
        if not gerr <= GRAD_TOL * gscale:
            fail(f"MessagePackBlockV2 gradient {i}: max|d| {gerr:.3e} > {GRAD_TOL} * {gscale:.3e}")
        worst = max(worst, gerr / gscale if gscale else 0.0)
    print(f"[representation] MessagePackBlockV2, 1,024 edges: output {err:.3e} of {scale:.3e}, "
          f"worst gradient {worst:.3e} of max|ref| ({len(ref_g)} tensors), launches {launches}",
          flush=True)
    return dict(max_abs_err=err, scale=scale, worst_grad_rel_err=worst, launches=launches)


def phase_rep_cli(tp_kernel):
    """The Transformer config through the CLI in a scratch directory that
    holds ``examples/sk/config.yaml``'s relative paths: ``stage: fit`` for 2
    epochs on 5 crystals of 8 atoms (3 train, 1 validation, 1 test), then
    ``stage: test`` from ``<train_dir>/best``."""
    import numpy as np
    import yaml

    from hamgnn_tpu_torch import cli
    from hamgnn_tpu_torch.data.dataset import save_graph_npz
    from hamgnn_tpu_torch.data.synthetic import add_random_hamiltonian_targets, make_crystal

    work = WORK / "cli_representation"
    data_dir = work / "datasets" / "sk_v1_graph"
    data_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(9)
    crystals = [add_random_hamiltonian_targets(
        rng, make_crystal(rng, n_atoms=8, cell_size=6.0, cutoff=5.0), nao_max=SOC_NAO)
        for _ in range(5)]
    save_graph_npz(str(data_dir / "graph_data.npz"), crystals)
    cfg = rep_config("transformer", cutoff=9.0)  # the config's own cutoff
    cfg["optim_params"].update(min_epochs=0, max_epochs=2)
    fit_path = work / "transformer_fit.yaml"
    fit_path.write_text(yaml.safe_dump(cfg))
    cfg["setup"].update(stage="test", checkpoint_path="./train_out/sk_v2/best")
    cfg["profiler_params"]["train_dir"] = "./train_out/sk_v2_test"
    test_path = work / "transformer_test.yaml"
    test_path.write_text(yaml.safe_dump(cfg))
    with contextlib.chdir(work):
        reset_launches(tp_kernel)
        t0 = time.perf_counter()
        cli.main(["--config", str(fit_path)])
        fit_s = time.perf_counter() - t0
        launches = {n: k.launches for n, k in all_kernels(tp_kernel).items() if k.launches}
        if set(launches) != set(ENGINES["auto"]):
            fail(f"the Transformer fit run should launch {ENGINES['auto']} and no other: "
                 f"{launches}")
        records = [json.loads(line) for line in open(work / "train_out" / "sk_v2"
                                                     / "metrics.jsonl")]
        if [r["epoch"] for r in records] != [0, 1] or not all(
                math.isfinite(r["train_loss"]) and math.isfinite(r["val_loss"])
                for r in records):
            fail(f"Transformer fit metrics.jsonl: {records}")
        cli.main(["--config", str(test_path)])
    pred = np.load(work / "train_out" / "sk_v2_test" / "prediction_hamiltonian.npy")
    if pred.shape[1:] != (SOC_NAO ** 2,) or not np.isfinite(pred).all():
        fail(f"Transformer test from <train_dir>/best: prediction {pred.shape}, finite")
    print(f"[representation] cli Transformer: fit 2 epochs in {fit_s:.1f} s, launches "
          f"{launches}, val_loss {[round(r['val_loss'], 6) for r in records]}; test from "
          f"<train_dir>/best: {pred.shape}", flush=True)
    return dict(fit_s=fit_s, launches=launches, records=records, test_shape=list(pred.shape))


def phase_representation(tp_kernel, dev, card):
    """Phase 11: the other representation networks on the card (see the
    module docstring); each part's seconds printed."""
    import torch

    seconds, steps = {}, {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        print(f"[representation] {name} done in {seconds[name]:.1f} s", flush=True)
        return out

    graph, n_edges = part("graph", rep_bench_graph, dev)
    for case, eng in REP_RUNS:
        steps[f"{case}:{eng}"] = part(f"{case}_{eng}", phase_rep_case, tp_kernel, dev, card,
                                      graph, n_edges, case, eng)
    dense = part("dense", phase_rep_dense, dev, graph)
    del graph
    torch.cuda.empty_cache()
    v2 = part("v2", phase_rep_v2, tp_kernel, dev)
    cli_run = part("cli", phase_rep_cli, tp_kernel)
    return dict(n_edges=n_edges, steps=steps, dense_ms=dense, v2=v2, cli=cli_run,
                seconds=seconds)


# the sets, their packed npz and the run's checkpoints (~120 MB, too large for
# the run's report directory, so they stay under build/)
DATAGEN_WORK = WORK / "datagen"
_SMALL = ["--n-si", "1", "--n-c", "1", "--n-sic", "1"]
# set -> (sk_dataset command line after --out, graph_data_gen tool, nao, soc)
DATAGEN_SETS = {
    "openmx": (["--n-si", "4", "--n-c", "4", "--n-sic", "4", "--band-set"], "openmx", 14,
               False),
    "soc": (["--soc", *_SMALL], "openmx", 14, True),
    "siesta": (["--format", "siesta", "--nao-max", "19", *_SMALL], "siesta", 19, False),
    "abacus": (["--format", "abacus", "--nao-max", "27", *_SMALL], "abacus", 27, False),
}
SPIN_SETS = ("collinear", "noncollinear", "spinsoc")
# the containers' own rounding of a teacher block (the read-back must equal it
# bit for bit): scfout stores doubles; HSX float32 in Ry (S unscaled); the CSR
# text 13 significant digits in Ry (S unscaled)
RY2HA = 13.60580 / 27.21138506


def _hsx_stored(b, ham: bool):
    import numpy as np

    v = (np.asarray(b) / RY2HA) if ham else np.asarray(b)
    v = v.astype("<f4").astype(np.float64)
    return v * RY2HA if ham else v


def _csr_stored(b, ham: bool):
    import numpy as np

    v = np.asarray(b) * (1.0 / RY2HA) if ham else np.asarray(b)
    v = np.array([float(f"{x:.12e}") for x in v.ravel()]).reshape(v.shape)
    return v * RY2HA if ham else v


def _gdg_yaml(tool, soc, runs, out, nao):
    """A graph_data_gen* config for the run directories ``runs`` (a glob)."""
    if tool == "openmx":
        cfg = {"scfout_paths": runs, "soc_switch": soc}
    elif tool == "siesta":
        cfg = {"calc_paths": runs, "h0_hsx_file_name": "H0.HSX"}
    else:
        cfg = {"calc_paths": runs, "h0_file_name": "data-H0R-sparse_SPIN0.csr"}
    cfg.update(nao_max=nao, graph_data_save_path=str(out))
    return cfg


def _same_bits(a, b) -> bool:
    import numpy as np

    return len(a) == len(b) and all(
        sorted(ca) == sorted(cb) and all(
            np.asarray(ca[k]).dtype == np.asarray(cb[k]).dtype
            and np.asarray(ca[k]).shape == np.asarray(cb[k]).shape
            and np.asarray(ca[k]).tobytes() == np.asarray(cb[k]).tobytes() for k in ca)
        for ca, cb in zip(a, b))


def _read_back(name, d, teacher, z, pos, cell, soc_terms) -> int:
    """The teacher's blocks of the crystal in run directory ``d`` against what
    the port's reader gets from its containers, bit for bit after the
    container's own rounding; returns the number of blocks compared."""
    import numpy as np

    from hamgnn_tpu_torch.interfaces import abacus, openmx, siesta

    data = teacher.build(z, pos, cell)
    key = lambda s, t, cs: (int(s), int(t), tuple(int(v) for v in cs))  # noqa: E731
    want = {key(s, t, cs): e for e, (s, t, cs) in enumerate(
        zip(data["edge_src"], data["edge_dst"], data["cell_shift"]))}
    n = 0

    def check(got_on, got_off, src, dst, cs, field, store):
        nonlocal n
        for a, blk in enumerate(got_on):
            if np.asarray(blk).tobytes() != store(data[field + "on"][a]).tobytes():
                fail(f"datagen {name}: {field}on[{a}] read back from {d.name} differs")
        for e, blk in enumerate(got_off):
            ref = data[field + "off"][want[key(src[e], dst[e], cs[e])]]
            if np.asarray(blk).tobytes() != store(ref).tobytes():
                fail(f"datagen {name}: {field}off[{e}] read back from {d.name} differs")
        n += len(got_on) + len(got_off)

    if name == "openmx":
        same = lambda b: np.asarray(b, np.float64)  # noqa: E731
        for fname, field in (("openmx.scfout", "H"), ("overlap.scfout", "H0")):
            scf = openmx.parse_scfout(str(d / fname))
            args = (scf.edge_src, scf.edge_dst, scf.cell_shift)
            check(scf.Hon[0], scf.Hoff[0], *args, field, same)
            check(scf.Son, scf.Soff, *args, "S", same)
    elif name == "soc":
        scf = openmx.parse_scfout(str(d / "openmx.scfout"))
        if scf.spinp_switch != 3 or len(scf.Hon) != 4 or len(scf.iHon) != 3:
            fail(f"datagen soc: {d.name} is not a SpinP_switch 3 scfout")
        bd = teacher.basis.basis_def
        for a, zz in enumerate(z):  # the angular-momentum blocks, as written
            ref = soc_terms.L[np.ix_(bd[int(zz)], bd[int(zz)])]
            if scf.Lon[a].tobytes() != np.ascontiguousarray(ref).tobytes():
                fail(f"datagen soc: Lon[{a}] read back from {d.name} differs")
        args = (scf.edge_src, scf.edge_dst, scf.cell_shift)
        same = lambda b: np.asarray(b, np.float64)  # noqa: E731
        for spin in (0, 1):  # the up-up and down-down components: H itself
            check(scf.Hon[spin], scf.Hoff[spin], *args, "H", same)
        check(scf.Son, scf.Soff, *args, "S", same)
    elif name == "siesta":
        fdf = siesta.parse_fdf(str(d / "input.fdf"))
        for fname, field in (("siesta.HSX", "H"), ("H0.HSX", "H0")):
            g = siesta.hsx_to_graph(siesta.parse_hsx(str(d / fname)), fdf)
            args = (g["edge_src"], g["edge_dst"], g["cell_shift"])
            check(g["Hon"][0], g["Hoff"][0], *args, field, lambda b: _hsx_stored(b, True))
            check(g["Son"], g["Soff"], *args, "S", lambda b: _hsx_stored(b, False))
    else:
        stru = abacus.parse_stru(str(d / "STRU"))
        for fname, field in (("data-HR-sparse_SPIN0.csr", "H"),
                             ("data-H0R-sparse_SPIN0.csr", "H0")):
            g = abacus.build_graph_from_csr(stru, str(d / fname),
                                            str(d / "data-SR-sparse_SPIN0.csr"))
            args = (g["edge_src"], g["edge_dst"], g["cell_shift"])
            check(g["Hon"][0], g["Hoff"][0], *args, field, lambda b: _csr_stored(b, True))
            check(g["Son"], g["Soff"], *args, "S", lambda b: _csr_stored(b, False))
    return n


def _datagen_sets(sk):
    """Every set made by the port's sk_dataset under DATAGEN_WORK, timed."""
    seconds = {}
    for name, (argv, *_rest) in DATAGEN_SETS.items():
        t0 = time.perf_counter()
        sk.run(["--out", str(DATAGEN_WORK / name), *argv])
        seconds[name] = time.perf_counter() - t0
    for kind in SPIN_SETS:
        t0 = time.perf_counter()
        sk.run([kind, "--out", str(DATAGEN_WORK / kind), "--n", "3"])
        seconds[kind] = time.perf_counter() - t0
    print("[datagen] sets made in " + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items()),
          flush=True)
    return seconds


def _datagen_read_back(sk):
    """Every container of every set read back against a fresh teacher (the
    sets' geometry replayed from the seed as sk_dataset draws it), and the
    spin sets' first crystal against the npz."""
    import numpy as np

    from hamgnn_tpu_torch.data.dataset import load_graph_npz

    blocks = {}
    for name, (argv, _tool, nao, soc) in DATAGEN_SETS.items():
        ham_type = name if name in ("siesta", "abacus") else "openmx"
        teacher = sk.SKTeacher(ham_type=ham_type, nao_max=nao, seed=7)
        soc_terms = sk.SOCTerms(teacher.basis, seed=7) if soc else None
        protos = {"si": sk._fcc_primitive(sk.A_SI, 14, 14),
                  "c": sk._fcc_primitive(sk.A_C, 6, 6),
                  "sic": sk._fcc_primitive(sk.A_SIC, 14, 6)}
        counts = [int(argv[argv.index(f"--n-{p}") + 1]) for p in protos]
        rng = np.random.RandomState(7 + 1)
        idx, blocks[name] = 0, 0
        for p, count in zip(protos, counts):
            for _ in range(count):
                cell, pos, z = sk.rattled(rng, protos[p])
                blocks[name] += _read_back(name, DATAGEN_WORK / name / f"struct_{idx:04d}",
                                           teacher, z, pos, cell, soc_terms)
                idx += 1
    teacher = sk.SKTeacher(seed=7)
    terms = {"collinear": sk.CollinearTerms(teacher.basis, seed=7),
             "noncollinear": sk.NonCollinearTerms(teacher.basis, seed=7),
             "spinsoc": sk.NonCollinearTerms(teacher.basis, seed=7, soc=True)}
    for kind in SPIN_SETS:
        rng = np.random.RandomState(7 + 1)
        cell, pos, z = sk.rattled(rng, sk._fcc_primitive(sk.A_SI, 14, 14))
        ref = (sk.collinear_crystal(teacher, terms[kind], z, pos, cell, rng)
               if kind == "collinear" else
               sk.noncollinear_crystal(teacher, terms[kind], z, pos, cell, rng,
                                       soc=kind == "spinsoc"))
        got = load_graph_npz(str(DATAGEN_WORK / kind / "graph_data.npz"))
        if len(got) != 3 or not _same_bits([{k: got[0][k] for k in ref}], [ref]):
            fail(f"datagen {kind}: graph_data.npz does not hold the teacher's first crystal")
        blocks[kind] = len(ref)
    print(f"[datagen] read back bit for bit: {blocks} (blocks; spin sets: arrays)", flush=True)
    return blocks


def _datagen_pack(tools):
    """Each container set packed by the port's graph_data_gen* through the
    Python parser and through the native one: the two npz bit for bit."""
    import yaml

    from hamgnn_tpu_torch.data.dataset import load_graph_npz

    out = {}
    jobs = [(name, tool, nao, soc, DATAGEN_WORK / name / "struct_*")
            for name, (_a, tool, nao, soc) in DATAGEN_SETS.items()]
    jobs.append(("band", "openmx", 14, False, DATAGEN_WORK / "openmx_band" / "pristine_*"))
    for name, tool, nao, soc, runs in jobs:
        packed = {}
        for parser in ("python", "native"):
            dst = DATAGEN_WORK / f"graph_{name}_{parser}"
            dst.mkdir(parents=True, exist_ok=True)
            cfg = dst / "graph_data_gen.yaml"
            cfg.write_text(yaml.safe_dump(_gdg_yaml(tool, soc, str(runs), dst, nao)))
            t0 = time.perf_counter()
            tools[tool].main(["--config", str(cfg)] + (["--native"] if parser == "native"
                                                       else []))
            packed[parser] = (load_graph_npz(str(dst / "graph_data.npz")),
                              time.perf_counter() - t0)
        if not packed["python"][0] or not _same_bits(packed["python"][0],
                                                     packed["native"][0]):
            fail(f"datagen {name}: the native and Python parsers packed different npz")
        out[name] = {"crystals": len(packed["python"][0]),
                     "python_s": packed["python"][1], "native_s": packed["native"][1]}
    print(f"[datagen] packed, native == Python bit for bit: {out}", flush=True)
    return out


@contextlib.contextmanager
def recorded_trainers():
    """The trainers the CLI builds in the body, kept in a list."""
    from hamgnn_tpu_torch import cli

    made, base = [], cli.Trainer

    class Recorded(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    cli.Trainer = Recorded
    try:
        yield made
    finally:
        cli.Trainer = base


def _datagen_fit(tp_kernel):
    """``examples/sk/config.yaml``'s model on the OpenMX set, 2 epochs on the
    card; one replay of its captured step profiled (13 B1 + 13 B2); then
    ``stage: test`` from ``<train_dir>/best`` on the pristine set and
    ``tools.band_cal`` on its prediction."""
    import numpy as np
    import yaml

    from hamgnn_tpu_torch import cli
    from hamgnn_tpu_torch.data.dataset import load_graph_npz
    from hamgnn_tpu_torch.models.basis import get_basis_set
    from hamgnn_tpu_torch.physics.kpoints import k_path
    from hamgnn_tpu_torch.tools import band_cal

    work, train = DATAGEN_WORK / "run", DATAGEN_WORK / "run" / "train"
    work.mkdir(parents=True, exist_ok=True)
    fit_cfg = _shipped(REP_CONFIG, work, "sk_fit.yaml",
                       setup={"checkpoint_path": str(train / "ckpt")},
                       profiler_params={"train_dir": str(train)},
                       dataset_params={"graph_data_path":
                                       str(DATAGEN_WORK / "graph_openmx_python")},
                       optim_params={"max_epochs": 2})
    reset_launches(tp_kernel)
    t0 = time.perf_counter()
    with recorded_trainers() as made:
        cli.main(["--config", fit_cfg])
    fit_s = time.perf_counter() - t0
    fit_launches = {n: k.launches for n, k in all_kernels(tp_kernel).items() if k.launches}
    if set(fit_launches) != set(ENGINES["auto"]):
        fail(f"the datagen fit should launch {ENGINES['auto']} and no other: {fit_launches}")
    records = [json.loads(line) for line in open(train / "metrics.jsonl")]
    if [r["epoch"] for r in records] != [0, 1] or not all(
            math.isfinite(r["train_loss"]) and math.isfinite(r["val_loss"]) for r in records):
        fail(f"datagen fit metrics.jsonl: {records}")
    cap = made[0].captured if made else None
    if cap is None or not cap.train_graphs:
        fail("the datagen fit built no captured training step")
    names = [n for k in ENGINES["auto"] for n in tp_kernel.KERNELS[k].device_kernels]
    first = next(iter(cap.train_graphs.values()))
    reads = profiled_launches(first.graph.replay, names, 13)
    replay = reads[-1]
    if replay != {n: 13 for n in names}:
        fail(f"one replay of the datagen fit's step launched {reads} (profiler traces), "
             "expected 13 of each")

    test_cfg = _shipped(ROOT / "examples" / "sk" / "config_band_test.yaml", work,
                        "sk_band_test.yaml",
                        setup={"checkpoint_path": str(train / "best")},
                        profiler_params={"train_dir": str(work / "band_pred")},
                        dataset_params={"graph_data_path":
                                        str(DATAGEN_WORK / "graph_band_python")})
    cli.main(["--config", test_cfg])
    pred_path = work / "band_pred" / "prediction_hamiltonian.npy"
    pred = np.load(pred_path)
    band_yaml = work / "band_cal.yaml"
    band_yaml.write_text(yaml.safe_dump({
        "nao_max": 14, "graph_data_path": str(DATAGEN_WORK / "graph_band_python"
                                              / "graph_data.npz"),
        "hamiltonian_path": str(pred_path), "nk": 20, "save_dir": str(work / "bands"),
        "auto_mode": True}))
    band_cal.main(["--config", str(band_yaml)])
    graphs = load_graph_npz(str(DATAGEN_WORK / "graph_band_python" / "graph_data.npz"))
    basis = get_basis_set("openmx", 14)
    ofs, herm, gaps = 0, 0.0, []
    for i, c in enumerate(graphs):
        n, e = len(c["z"]), c["edge_index"].shape[1]
        bands = np.load(work / "bands" / f"structure_{i}_bands.npz")
        if not np.isfinite(bands["bands"]).all():
            fail(f"datagen band_cal: structure {i} has non-finite bands")
        gaps.append(float(bands["gap"]))
        valid = np.concatenate([basis.orbital_mask_table[zi] > 0 for zi in c["z"]])
        k_frac, _d, _n, lat_inv = k_path([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0.25, 0.75]], 7,
                                         np.asarray(c["cell"]).reshape(3, 3))
        hk = band_cal.assemble_k_matrices_numpy(
            pred[ofs:ofs + n + e].astype(np.float64), n, c["edge_index"],
            np.asarray(c["nbr_shift"], float), k_frac @ lat_inv, 14, valid)
        ofs += n + e
        herm = max(herm, float(np.abs(hk - np.conj(np.swapaxes(hk, 1, 2))).max()
                               / np.abs(hk).max()))
    if herm > 1e-6:
        fail(f"datagen band_cal: H(k) of the prediction not Hermitian ({herm:.3g})")
    print(f"[datagen] sk fit 2 epochs in {fit_s:.1f} s, launches {fit_launches}, "
          f"{len(cap.train_graphs)} captured shape key(s), one replay {replay}, "
          f"val_loss {[round(r['val_loss'], 6) for r in records]}; test from "
          f"<train_dir>/best {pred.shape}; band_cal gaps {gaps} eV, max|H(k) - H(k)^H| / "
          f"max|H(k)| {herm:.3g}", flush=True)
    return dict(fit_s=fit_s, launches=fit_launches, replay_launches=replay,
                shape_keys=len(cap.train_graphs), records=records, gaps_eV=gaps,
                hermitian_rel_err=herm)


def _datagen_predict(tp_kernel, name, config):
    """``stage: test`` with random weights (seed 0) on a packed set, at the
    width of the shipped ``config``."""
    import numpy as np
    import torch

    from hamgnn_tpu_torch import cli
    from hamgnn_tpu_torch.models.model import init_weights
    from hamgnn_tpu_torch.train.config import load_config

    work = DATAGEN_WORK / "run"
    path = _shipped(config, work, f"{name}_test.yaml",
                    setup={"stage": "test", "checkpoint_path": str(work / f"{name}.pt")},
                    profiler_params={"train_dir": str(work / f"{name}_pred")},
                    dataset_params={"graph_data_path":
                                    str(DATAGEN_WORK / f"graph_{name}_python")})
    torch.save(init_weights(cli.build_model(load_config(path)), 0).state_dict(),
               work / f"{name}.pt")
    reset_launches(tp_kernel)
    cli.main(["--config", path])
    launches = tp_kernel.KERNELS["packed_tp_fwd"].launches
    pred = np.load(work / f"{name}_pred" / "prediction_hamiltonian.npy")
    nao = {"siesta": 19, "abacus": 27}[name]
    if pred.shape[1] != nao * nao or not np.isfinite(pred).all() or launches == 0:
        fail(f"datagen {name} test: prediction {pred.shape}, finite "
             f"{bool(np.isfinite(pred).all())}, {launches} B1 launches")
    print(f"[datagen] {name} stage test, random weights: {pred.shape} finite, "
          f"{launches} B1 launches", flush=True)
    return dict(shape=list(pred.shape), launches=launches)


def phase_datagen(tp_kernel):
    """Phase 12: the data-preparation layer through the port alone (see the
    module docstring); the containers are removed at the end, the packed npz
    and the run's files kept."""
    from hamgnn_tpu_torch.interfaces.native import build_native
    from hamgnn_tpu_torch.tools import (graph_data_gen, graph_data_gen_abacus,
                                        graph_data_gen_siesta, sk_dataset)

    if DATAGEN_WORK.exists():
        shutil.rmtree(DATAGEN_WORK)
    DATAGEN_WORK.mkdir(parents=True)
    seconds = {}
    t0 = time.perf_counter()
    built = build_native()
    seconds["native_build"] = time.perf_counter() - t0
    print(f"[datagen] native readers built in {seconds['native_build']:.1f} s: "
          + ", ".join(f"{n} {s:.1f} s" for n, (_p, s) in built.items()), flush=True)
    tools = {"openmx": graph_data_gen, "siesta": graph_data_gen_siesta,
             "abacus": graph_data_gen_abacus}
    parts = (("sets", _datagen_sets, sk_dataset), ("read_back", _datagen_read_back, sk_dataset),
             ("pack", _datagen_pack, tools), ("fit", _datagen_fit, tp_kernel),
             ("siesta", _datagen_predict, tp_kernel, "siesta",
              ROOT / "examples" / "sk_siesta" / "config.yaml"),
             ("abacus", _datagen_predict, tp_kernel, "abacus",
              ROOT / "examples" / "sk_abacus" / "config.yaml"))
    out = {}
    for name, fn, *args in parts:
        t0 = time.perf_counter()
        out[name] = fn(*args)
        seconds[name] = time.perf_counter() - t0
    for name in (*DATAGEN_SETS, "openmx_band"):
        shutil.rmtree(DATAGEN_WORK / name)
    return dict(out, seconds=seconds)


# phase 13: the Uni-HamGNN two-stage predictor, the reference-parametrization
# model and the batched band solver (under build/chip_smoke/uni)
UNI_WORK = WORK / "uni"
UNI_NONSOC_CONFIG = ROOT / "examples" / "sk" / "config.yaml"
UNI_LAYERS = (3, 2)  # the sk and sk_soc models: 13 + 9 forward-kernel launches
UNI_COMPAT_CUTOFF = 6.0  # the bench crystal's graph; the compat default is 26 A
UNI_COMPAT_ATOMS = 512
UNI_BAND_NK, UNI_BAND_KBATCH = 60, 32
SOC_KEYS = ("hamiltonian_real_on", "hamiltonian_real_off", "hamiltonian_imag_on",
            "hamiltonian_imag_off")


def _uni_sets():
    """A pair of graph sets of one structure list: ``tools.sk_dataset`` with
    and without ``--soc`` (seed 7, one Si, one C, one SiC: the structures
    are drawn before the SOC terms), packed by ``tools.graph_data_gen``."""
    import numpy as np
    import yaml

    from hamgnn_tpu_torch.data.dataset import load_graph_npz
    from hamgnn_tpu_torch.tools import graph_data_gen, sk_dataset

    if UNI_WORK.exists():
        shutil.rmtree(UNI_WORK)
    sets = {}
    for name, extra, soc in (("nonsoc", [], False), ("soc", ["--soc"], True)):
        sk_dataset.run(["--out", str(UNI_WORK / name), *_SMALL, *extra])
        dst = UNI_WORK / f"graph_{name}"
        dst.mkdir(parents=True)
        cfg = dst / "graph_data_gen.yaml"
        cfg.write_text(yaml.safe_dump(_gdg_yaml("openmx", soc, str(UNI_WORK / name / "struct_*"),
                                                dst, 14)))
        graph_data_gen.main(["--config", str(cfg)])
        sets[name] = load_graph_npz(str(dst / "graph_data.npz"))
        shutil.rmtree(UNI_WORK / name)
    for a, b in zip(sets["nonsoc"], sets["soc"], strict=True):
        for key in ("z", "pos", "edge_index", "nbr_shift"):
            if not np.array_equal(a[key], b[key]):
                fail(f"uni: the SOC set's {key} differs from the non-SOC set's")
        if b["Hon"].shape[1] != 4 * a["Hon"].shape[1]:
            fail(f"uni: SOC rows {b['Hon'].shape}, non-SOC rows {a['Hon'].shape}")
    return sets


def _uni_native(tp_kernel, dev, card, sets):
    """The native predictor (sk + sk_soc models, seeded weights) saved in the
    port's package form, loaded back and run through its CLI under the plain
    TP, the default and the zonal engine; per crystal the stages timed warm
    and the SOC rows' Hermitian structure."""
    import io

    import numpy as np
    import torch
    import yaml

    from hamgnn_tpu_torch.data.dataset import GraphDataModule
    from hamgnn_tpu_torch.models.model import init_weights
    from hamgnn_tpu_torch.tools import uni_hamgnn

    pred = uni_hamgnn.HamiltonianPredictor(str(UNI_NONSOC_CONFIG), str(SOC_CONFIG),
                                           soc_switch=True, device=dev)
    init_weights(pred.model_nonsoc, 0)
    init_weights(pred.model_soc, 1)
    pkg = UNI_WORK / "package"
    pred.save(str(pkg))
    loaded = uni_hamgnn.HamiltonianPredictor.load(str(pkg), device=dev)
    for a, b in ((pred.model_nonsoc, loaded.model_nonsoc), (pred.model_soc, loaded.model_soc)):
        sa, sb = a.state_dict(), b.state_dict()
        if set(sa) != set(sb) or not all(torch.equal(sa[k], sb[k]) for k in sa):
            fail("uni: the package read back differs from the predictor saved")
    n_cryst = len(sets["nonsoc"])
    per_pred = 4 * UNI_LAYERS[0] + 1 + 4 * UNI_LAYERS[1] + 1
    preds, maes, launches = {}, {}, {}
    for eng in ("xla", "auto", "zonal"):
        out = UNI_WORK / f"out_{eng}"
        cfg = {"model_pkl_path": str(pkg),
               "non_soc_data_dir": str(UNI_WORK / "graph_nonsoc" / "graph_data.npz"),
               "soc_data_dir": str(UNI_WORK / "graph_soc" / "graph_data.npz"),
               "output_dir": str(out), "calculate_mae": True}
        (UNI_WORK / f"Input_{eng}.yaml").write_text(yaml.safe_dump(cfg))
        with engine(eng):
            reset_launches(tp_kernel)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                uni_hamgnn.main(["--config", str(UNI_WORK / f"Input_{eng}.yaml")])
            torch.cuda.synchronize()
            expect = {} if eng == "xla" else {ENGINES[eng][0]: n_cryst * per_pred}
            launches[eng] = check_launches(tp_kernel, expect, f"the uni_hamgnn CLI ({eng})")
        preds[eng] = np.load(out / "prediction_hamiltonian.npy")
        maes[eng] = float(buf.getvalue().split("masked MAE:")[1].split()[0])
        rows = sum(c["z"].shape[0] + c["edge_index"].shape[1] for c in sets["soc"])
        if preds[eng].shape != (rows, (2 * SOC_NAO) ** 2) or not np.isfinite(preds[eng]).all():
            fail(f"uni ({eng}): prediction {preds[eng].shape}, expected ({rows}, "
                 f"{(2 * SOC_NAO) ** 2}) finite")
    scale = float(np.abs(preds["xla"]).max())
    err_plain = float(np.abs(preds["auto"] - preds["xla"]).max())
    err_zonal = float(np.abs(preds["zonal"] - preds["auto"]).max())
    if not err_plain <= TOL * scale:
        fail(f"uni: default engine vs plain TP max|d| {err_plain:.3e} > {TOL} * {scale:.3e}")
    if not err_zonal <= ENGINE_TOL * scale:
        fail(f"uni: zonal vs default engine max|d| {err_zonal:.3e} > {ENGINE_TOL} * {scale:.3e}")

    # per crystal, warm: each stage's time, the SOC rows' Hermitian structure
    data = {name: list(GraphDataModule(sets[name], batch_size=1, test_mode=True,
                                       device=dev).test_batches()) for name in sets}
    times = {"nonsoc": [], "soc": []}
    herm = 0.0
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    for g, g_soc in zip(data["nonsoc"], data["soc"]):
        p1 = loaded.predict_nonsoc(g)
        p2 = loaded.predict_soc(g_soc, p1["hamiltonian_on"], p1["hamiltonian_off"])
        s2 = max(float(p2[k].abs().max()) for k in SOC_KEYS)
        h = soc_hermiticity(p2, g_soc, "so3")
        if not h <= 1e-6 * s2:
            fail(f"uni: SOC rows Hermitian to {h:.3e} > 1e-6 * {s2:.3e}")
        herm = max(herm, h / s2)
        for _ in range(3):
            times["nonsoc"].append(_host_time(lambda: loaded.predict_nonsoc(g)))
            times["soc"].append(_host_time(lambda: loaded.predict_soc(
                g_soc, p1["hamiltonian_on"], p1["hamiltonian_off"])))
    peak_mb = (torch.cuda.max_memory_allocated(dev) - base) / 2**20
    ms = {k: 1e3 * float(np.median(v)) for k, v in times.items()}
    print(f"[uni] native two-stage CLI on {n_cryst} crystals: {per_pred} forward-kernel "
          f"launches a prediction (B1 default, B3 zonal, none plain); vs plain TP max|d| "
          f"{err_plain:.3e}, zonal vs default {err_zonal:.3e} of {scale:.3e}; SOC rows Hermitian "
          f"to {herm:.3e} relative; masked MAE (random weights) {maes['auto']:.4e} Ha; per "
          f"crystal non-SOC {ms['nonsoc']:.3f} ms, SOC {ms['soc']:.3f} ms (median of "
          f"{len(times['soc'])}), peak {peak_mb:.1f} MiB over the models; card {card}", flush=True)
    del pred, loaded
    torch.cuda.empty_cache()
    return dict(crystals=n_cryst, launches_per_prediction=per_pred, launches=launches,
                err_vs_plain=err_plain, err_zonal=err_zonal, scale=scale,
                hermiticity=herm, mae=maes, ms_per_crystal=ms, peak_mb=peak_mb)


def _uni_compat(tp_kernel, dev, card):
    """``HamGNNConvE3Compat`` at its own default widths with the openmx
    nao-14 head, filled from a synthetic reference-format state dict, one
    forward on the bench crystal at 6 A against the same model in float64
    on the CPU."""
    import copy

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hamgnn_tpu_torch.data.graph import pad_and_batch
    from hamgnn_tpu_torch.data.synthetic import bench_crystal
    from hamgnn_tpu_torch.interfaces import e3nn_compat
    from hamgnn_tpu_torch.interfaces.torch_ckpt import assign_params, flatten_params
    from hamgnn_tpu_torch.models.basis import get_basis_set, hamiltonian_irreps
    from hamgnn_tpu_torch.models.model import HamGNNModel
    from hamgnn_tpu_torch.models.output import HamGNNPlusPlusOut
    from hamgnn_tpu_torch.tools_dev.profile_summary import summarize

    rep = e3nn_compat.HamGNNConvE3Compat()
    feat = "64x0e+32x1o+16x2e"
    kw = dict(num_types=96, irreps_node_features=feat,
              irreps_edge_sh="0e + 1o + 2e + 3o + 4e + 5o", num_layers=3,
              irreps_ham=repr(hamiltonian_irreps(get_basis_set("openmx", SOC_NAO))))
    shapes = e3nn_compat.reference_state_shapes(num_radial=64, radial_mlp=(64, 64), **kw)
    rng = np.random.default_rng(0)
    state = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    state["representation.radial_basis.basis.bessel_weights"] = (
        np.pi * np.arange(1, 65) * rng.uniform(0.9, 1.1, 64)).astype(np.float32)
    model = HamGNNModel(rep, HamGNNPlusPlusOut(feat, feat, nao_max=SOC_NAO, ham_type="openmx",
                                               ham_only=True))
    assignments = e3nn_compat.map_reference_state(state, **kw)
    _, untouched = assign_params(model, assignments)
    if untouched or set(assignments) != set(flatten_params(model)):
        fail(f"uni compat: the import does not cover the model both ways ({untouched[:5]})")
    crystal = bench_crystal(n_atoms=UNI_COMPAT_ATOMS, cutoff=UNI_COMPAT_CUTOFF, nao_max=SOC_NAO)
    n_edges = int(crystal["edge_index"].shape[1])
    buckets = dict(node_bucket=512, edge_bucket=((n_edges + 511) // 512) * 512)
    graph = pad_and_batch([crystal], device=dev, **buckets)
    model = model.to(dev).eval()
    keys = ("hamiltonian_on", "hamiltonian_off")
    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        reset_launches(tp_kernel)
        out = model(graph)
        torch.cuda.synchronize()
        check_launches(tp_kernel, {}, "the compat forward")  # plain einsums: no kernel
        peak_mb = (torch.cuda.max_memory_allocated(dev) - base) / 2**20
        times = [_host_time(lambda: model(graph)) for _ in range(3)]
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            model(graph)
            torch.cuda.synchronize()
        prof_rows = _write_profile(prof, time.perf_counter() - t0, 1, "profile_uni_compat.txt",
                                   "forward")
    with open(ROOT / "chiprun_out" / "profile_uni_compat.txt") as f:
        kinds = {k: {"ms": ms, "launches": n} for k, (ms, n) in summarize(f).items()}
    t0 = time.perf_counter()
    cpu64 = copy.deepcopy(model).cpu().double()
    with torch.no_grad():
        ref = cpu64(pad_and_batch([crystal], dtype=np.float64, device="cpu", **buckets))
    cpu_s = time.perf_counter() - t0
    scale = max(float(ref[k].abs().max()) for k in keys)
    errs = {k: float((out[k].double().cpu() - ref[k]).abs().max()) for k in keys}
    if not all(math.isfinite(e) and e <= TOL * scale for e in errs.values()):
        fail(f"uni compat vs float64 on the CPU: {errs} > {TOL} * {scale:.3e}")
    ms = 1e3 * float(np.median(times))
    print(f"[uni] compat HamGNNConvE3Compat defaults (96 types, SH to 5o, {feat}, 3 layers, "
          f"64 radial) + openmx head, {len(assignments)} reference tensors imported, bench "
          f"crystal at {UNI_COMPAT_CUTOFF} A ({n_edges} edges): no port kernel launched; vs "
          f"float64 CPU max|d| " + ", ".join(f"{k[12:]} {e:.3e}" for k, e in errs.items())
          + f" of {scale:.3e} (limit {TOL}); forward {ms:.3f} ms (median of 3), peak "
          f"{peak_mb:.1f} MiB; by kind " + ", ".join(f"{k} {v['ms']:.3f} ms"
                                                      for k, v in kinds.items())
          + f"; card {card}", flush=True)
    del model, cpu64, out
    torch.cuda.empty_cache()
    return dict(edges=n_edges, tensors=len(assignments), errors=errs, scale=scale,
                forward_ms=ms, forward_times_ms=[1e3 * t for t in times], peak_mb=peak_mb,
                cpu_float64_s=cpu_s, device_by_kind=kinds, profile=prof_rows)


def _uni_bands(tp_kernel, dev, card):
    """``tools.band_cal_parallel.solve_bands_batched`` on the band phase's
    crystals (bench width's nao 19), 60 k along a path, 32 k a solve,
    against scipy's float64 ``eigh`` on the host."""
    import numpy as np
    import scipy.linalg
    import torch

    from hamgnn_tpu_torch.data.synthetic import add_random_hamiltonian_targets, make_crystal
    from hamgnn_tpu_torch.models.basis import get_basis_set
    from hamgnn_tpu_torch.physics.kpoints import k_path
    from hamgnn_tpu_torch.tools.band_cal import assemble_k_matrices_numpy
    from hamgnn_tpu_torch.tools.band_cal_parallel import solve_bands_batched

    nao = band_config()["output_nets"]["HamGNN_out"]["nao_max"]
    basis = get_basis_set("openmx", nao)
    rng = np.random.default_rng(5)
    crystals = [add_random_hamiltonian_targets(
        rng, make_crystal(rng, n_atoms=16, cell_size=8.0, cutoff=5.0), nao_max=nao)
        for _ in range(4)]
    worst, asm_s, solve_ms, norbs = 0.0, [], [], []
    for c in crystals:
        t0 = time.perf_counter()
        cell = np.asarray(c["cell"]).reshape(3, 3)
        k_frac, _d, _n, lat_inv = k_path([[0, 0, 0], [0.5, 0, 0], [0.5, 0.5, 0], [0, 0, 0]],
                                         UNI_BAND_NK, cell)
        k_cart = k_frac @ lat_inv
        valid = np.concatenate([basis.orbital_mask_table[zi] > 0 for zi in c["z"]])
        HK, SK = (assemble_k_matrices_numpy(
            np.concatenate([c[on], c[off]]), len(c["z"]), c["edge_index"], c["nbr_shift"],
            k_cart, nao, valid) for on, off in (("Hon", "Hoff"), ("Son", "Soff")))
        asm_s.append(time.perf_counter() - t0)
        norbs.append(int(HK.shape[1]))
        reset_launches(tp_kernel)
        got = solve_bands_batched(HK, SK, k_batch=UNI_BAND_KBATCH, device=dev)
        check_launches(tp_kernel, {}, "solve_bands_batched")
        solve_ms.append(1e3 * float(np.median([_host_time(lambda: solve_bands_batched(
            HK, SK, k_batch=UNI_BAND_KBATCH, device=dev)) for _ in range(3)])))
        want = np.stack([scipy.linalg.eigh(h, s_, eigvals_only=True) for h, s_ in zip(HK, SK)])
        if got.shape != want.shape:
            fail(f"band_cal_parallel: {got.shape} bands, expected {want.shape}")
        worst = max(worst, float(np.abs(got - want).max()))
    if not worst <= BAND_TOL:
        fail(f"band_cal_parallel vs float64 scipy: max|d| {worst:.3e} Ha > {BAND_TOL}")
    torch.cuda.empty_cache()
    print(f"[uni] band_cal_parallel: 4 crystals x 16 atoms, H(k) {norbs} orbitals, "
          f"{UNI_BAND_NK} k, k_batch {UNI_BAND_KBATCH}, complex64 on the card vs float64 scipy "
          f"max|d| {worst:.3e} Ha (limit {BAND_TOL}); solve {np.mean(solve_ms):.3f} ms, host "
          f"assembly {1e3 * np.mean(asm_s):.1f} ms a crystal; no port kernel launched; card "
          f"{card}", flush=True)
    return dict(max_abs_err=worst, solve_ms=solve_ms, assembly_ms=[1e3 * t for t in asm_s],
                orbitals=norbs, nk=UNI_BAND_NK, k_batch=UNI_BAND_KBATCH)


def phase_uni(tp_kernel, dev, card):
    """Phase 13 (see the module docstring)."""
    seconds, out = {}, {}
    for name, fn, *args in (("sets", _uni_sets), ("native", _uni_native, tp_kernel, dev, card),
                            ("compat", _uni_compat, tp_kernel, dev, card),
                            ("bands", _uni_bands, tp_kernel, dev, card)):
        if name == "native":
            args.append(out["sets"])
        t0 = time.perf_counter()
        out[name] = fn(*args)
        seconds[name] = time.perf_counter() - t0
    out["sets"] = {name: len(v) for name, v in out["sets"].items()}
    return dict(out, seconds=seconds)


PAR_WORK = WORK / "parallel"
PAR_GRAD_TOL = 1e-5   # a halo / dp step's flat gradient vs the one-device step's, x max|g|
PAR_GRAD_TOL_2 = 1e-4  # the same at two ranks (the other summation order of the split)


def _local_batch(graph, n_shards, shard, dev, edge_quantum=64):
    """(plan, the rank's local halo inputs on ``dev``) of a padded Graph."""
    from hamgnn_tpu_torch.parallel.halo_model import (build_halo_inputs, local_inputs,
                                                      plan_for_graph)
    from hamgnn_tpu_torch.parallel.halo_trainer import graph_to

    host = graph_to(graph, "cpu")
    plan = plan_for_graph(host, n_shards, edge_quantum)
    return plan, local_inputs(build_halo_inputs(host, plan), n_shards, shard, dev)


def _plan_sizes(plan) -> dict:
    """E_loc, H, HE and E_b of a plan, and the real rows behind them."""
    real_b = int(plan.boundary_mask.sum())
    real_e = int(plan.edge_mask.sum())
    return {"E_loc": int(plan.edge_id.shape[1]), "H": plan.halo_bucket,
            "HE": plan.edge_halo_bucket, "E_b": plan.boundary_bucket,
            "edges_per_shard": [int(m.sum()) for m in plan.edge_mask],
            # rows an exchange brings each shard: its distinct remote sources
            "halo_rows_per_shard": [len(set(pos[pos >= plan.n_nodes_local].tolist()))
                                    for pos in (p[m] for p, m in zip(plan.src_pos,
                                                                     plan.edge_mask))],
            "boundary_share": real_b / max(real_e, 1)}


def _grad_check(what, got, ref, tol):
    """max|got - ref| over the flat gradient <= tol * max|ref|; returns the ratio."""
    err, scale = rel_err(got, ref)
    if not math.isfinite(err) or err > tol * scale:
        fail(f"{what}: flat gradient max|d| {err:.3e} > {tol} * {scale:.3e}")
    return err / scale


def _par_step_stats(tr, item, fname, names):
    """Wall ms (median of 3, host clock to a sync), peak memory, and from one
    profiled step its device ms and each named device kernel's launches
    (written to chiprun_out/<fname>)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hamgnn_tpu_torch.utils.profiling import PROFILER_LEAD_S

    times = [_host_time(lambda: tr.train_step(item)) for _ in range(3)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_LEAD_S)  # no kernel of the step before the session's start
        wall = _host_time(lambda: tr.train_step(item))
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    return {"wall_ms": 1e3 * float(np.median(times)),
            "device_ms": _write_profile(prof, wall, 1, fname, "step")["__all__"],
            "device_launches": {n: sum(ev.count for ev in kernels if n in ev.key)
                                for n in names},
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def _par_world1(tp_kernel, dev, card, eng):
    """(a) at world size 1 over NCCL: the one-device eager step, then a halo
    step (``HaloTrainer``, n_graph 1) and a data-parallel step
    (``ParallelTrainer``) from the same seeded weights, under ``eng``."""
    import torch

    from hamgnn_tpu_torch.cli import build_model
    from hamgnn_tpu_torch.models.model import init_weights
    from hamgnn_tpu_torch.parallel.halo_trainer import HaloTrainer
    from hamgnn_tpu_torch.parallel.trainer import ParallelTrainer
    from hamgnn_tpu_torch.train.config import load_config
    from hamgnn_tpu_torch.train.trainer import Trainer

    graph, n_edges = bench_graph(dev)
    layers = BENCH_CFG["representation_nets"]["HamGNN_pre"]["num_layers"]
    expect = {k: 4 * layers + 1 for k in ENGINES[eng]}
    names = [n for k in ENGINES[eng] for n in tp_kernel.KERNELS[k].device_kernels]

    def trainer(cls, tag, **kw):
        model = init_weights(build_model(load_config(None, overrides=BENCH_CFG)), 0)
        return cls(model, losses=BENCH_LOSSES, metrics=[], lr=1e-3, device=dev,
                   train_dir=str(PAR_WORK / f"{tag}_{eng}"), **kw)

    out = {}
    with engine(eng):
        one = trainer(Trainer, "one", capture=False)
        loss1 = float(one.train_step(graph)[0])
        g1 = one.grad.clone()
        del one
        plan, loc = _local_batch(graph, 1, 0, dev)
        for kind in ("halo", "dp"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            if kind == "halo":
                tr, item = trainer(HaloTrainer, kind, n_data=1, n_graph=1), None
                step = lambda: tr._halo_step()(loc, tr.sched.lr)  # noqa: E731
            else:
                tr, item = trainer(ParallelTrainer, kind, n_data=1, n_graph=1), graph
                step = lambda: tr.train_step(graph)  # noqa: E731
            reset_launches(tp_kernel)
            loss, logs = step()
            torch.cuda.synchronize()
            launches = check_launches(tp_kernel, expect, f"one {kind} step ({eng})")
            if not abs(float(loss) - loss1) <= 1e-6 * abs(loss1) \
                    or float(logs["nonfinite_step"]) != 0.0:
                fail(f"{kind} step ({eng}): loss {float(loss)!r} vs one-device {loss1!r}")
            ratio = _grad_check(f"{kind} step ({eng})", tr.grad, g1, PAR_GRAD_TOL)
            if kind == "halo":
                # the step as the trainer runs it: host inputs sliced and moved each time
                from hamgnn_tpu_torch.parallel.halo_model import build_halo_inputs
                from hamgnn_tpu_torch.parallel.halo_trainer import graph_to

                item = build_halo_inputs(graph_to(graph, "cpu"), plan)
                item = {k: v[None] for k, v in item.items()}
            stats = _par_step_stats(tr, item, f"profile_{kind}_step_{eng}.txt", names)
            if stats["device_launches"] != {n: 4 * layers + 1 for n in names}:
                fail(f"{kind} step ({eng}): device launches {stats['device_launches']}")
            out[kind] = dict(loss=float(loss), loss_one_device=loss1, grad_rel_err=ratio,
                             launches=launches, **stats)
            del tr
    out["plan"] = _plan_sizes(plan)
    out["ref"] = (loss1, g1.cpu())
    torch.cuda.empty_cache()
    print(f"[parallel] (a) world 1 over NCCL, engine {eng}: one-device loss {loss1!r}; "
          + "; ".join(f"{k} loss {r['loss']!r}, gradient {r['grad_rel_err']:.2e} of max|g|, "
                      f"launches {r['launches']}, wall {r['wall_ms']:.3f} ms, device "
                      f"{r['device_ms']:.3f} ms a step, peak {r['peak_gb']:.2f} GB"
                      for k, r in out.items() if k in ("halo", "dp"))
          + f"; plan (S=1) {out['plan']}; card {card}", flush=True)
    return out


def _par_rank(rank, world, port, work):
    """(b) one of two ranks on one card over gloo: the bench crystal split
    2 ways, one halo step; rank 0 saves the loss and the flat gradient."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    result = {"rank": rank}
    try:
        x = torch.full((4, 3), float(rank + 1), device=dev)
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x)
        dist.all_reduce(x)
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        torch.cuda.synchronize()
        result["gloo_cuda"] = "supported"
    except Exception as exc:  # reported, and (b) is left out
        result["gloo_cuda"] = f"unsupported: {type(exc).__name__}: {exc}"[:300]
    if result["gloo_cuda"] == "supported":
        sys.path.insert(0, str(ROOT))
        from hamgnn_tpu_torch.cli import build_model
        from hamgnn_tpu_torch.e3 import tp_kernel
        from hamgnn_tpu_torch.models.model import init_weights
        from hamgnn_tpu_torch.parallel.halo_trainer import HaloTrainer
        from hamgnn_tpu_torch.train.config import load_config

        graph, _ = bench_graph(dev)
        plan, loc = _local_batch(graph, world, rank, dev)
        tr = HaloTrainer(init_weights(build_model(load_config(None, overrides=BENCH_CFG)), 0),
                         losses=BENCH_LOSSES, metrics=[], lr=1e-3, device=dev,
                         train_dir=str(Path(work) / f"two_{rank}"), n_data=1, n_graph=world)
        reset_launches(tp_kernel)
        loss, _ = tr._halo_step()(loc, tr.sched.lr)
        torch.cuda.synchronize()
        result.update(loss=float(loss), plan=_plan_sizes(plan),
                      launches={n: k.launches for n, k in tp_kernel.KERNELS.items()})
        if rank == 0:  # the first step's gradient, before the timed steps overwrite it
            torch.save(tr.grad.cpu(), Path(work) / "two_rank_grad.pt")
        t0 = time.perf_counter()
        for _ in range(3):
            tr._halo_step()(loc, tr.sched.lr)
        torch.cuda.synchronize()
        result["wall_ms_shared_card"] = (time.perf_counter() - t0) / 3 * 1e3
    every = [None] * world
    dist.all_gather_object(every, result)
    if rank == 0:
        (Path(work) / "two_ranks.json").write_text(json.dumps(every))
    dist.barrier()
    dist.destroy_process_group()


def _par_two_ranks(card, ref):
    """(b) two processes on the one card over gloo against (a)'s one-device
    step; left out where this build's gloo carries no CUDA tensor."""
    import torch
    import torch.multiprocessing as mp

    from hamgnn_tpu_torch.parallel.multihost import free_port

    for f in ("two_ranks.json", "two_rank_grad.pt"):
        (PAR_WORK / f).unlink(missing_ok=True)
    mp.spawn(_par_rank, args=(2, free_port(), str(PAR_WORK)), nprocs=2)
    ranks = json.loads((PAR_WORK / "two_ranks.json").read_text())
    if ranks[0]["gloo_cuda"] != "supported":
        print(f"[parallel] (b) left out: gloo with CUDA tensors in this build: "
              f"{ranks[0]['gloo_cuda']}", flush=True)
        return {"ran": False, "gloo_cuda": ranks[0]["gloo_cuda"]}
    loss1, g1 = ref
    for r in ranks:
        if not abs(r["loss"] - loss1) <= 1e-6 * abs(loss1):
            fail(f"two ranks: rank {r['rank']} loss {r['loss']!r} vs one-device {loss1!r}")
    g2 = torch.load(PAR_WORK / "two_rank_grad.pt")
    ratio = _grad_check("two ranks on one card", g2, g1, PAR_GRAD_TOL_2)
    plan = ranks[0]["plan"]
    print(f"[parallel] (b) two ranks on one card over gloo: loss {ranks[0]['loss']!r} vs "
          f"{loss1!r}, gradient {ratio:.2e} of max|g|; plan (S=2) E_loc {plan['E_loc']}, "
          f"H {plan['H']}, HE {plan['HE']}, E_b {plan['E_b']}, halo rows a layer per rank "
          f"{plan['halo_rows_per_shard']}, boundary share {plan['boundary_share']:.4f}; "
          f"launches a rank {ranks[0]['launches']}; wall (both ranks on one card, not a "
          f"speed) {[round(r['wall_ms_shared_card'], 3) for r in ranks]} ms; card {card}",
          flush=True)
    return {"ran": True, "gloo_cuda": "supported", "grad_rel_err": ratio,
            "losses": [r["loss"] for r in ranks], "plan": plan,
            "launches": ranks[0]["launches"],
            "wall_ms_shared_card": [r["wall_ms_shared_card"] for r in ranks]}


def _par_soc(tp_kernel, dev, card):
    """(c) one so3 halo step at the SOC cell against the one-device eager
    step, deterministic algorithms on (phase_soc's limits)."""
    import torch

    from hamgnn_tpu_torch.cli import build_model
    from hamgnn_tpu_torch.models.model import init_weights
    from hamgnn_tpu_torch.parallel.halo_trainer import HaloTrainer
    from hamgnn_tpu_torch.train.config import load_config
    from hamgnn_tpu_torch.train.trainer import Trainer

    graph, _ = soc_bench_graph(dev)
    cfg, losses = soc_config("so3")
    layers = cfg["representation_nets"]["HamGNN_pre"]["num_layers"]
    _, loc = _local_batch(graph, 1, 0, dev)
    trs, res = {}, {}
    torch.use_deterministic_algorithms(True)
    try:
        for kind, cls, kw in (("one", Trainer, {"capture": False}),
                              ("halo", HaloTrainer, {"n_data": 1, "n_graph": 1})):
            model = init_weights(build_model(load_config(None, overrides=cfg)), 0)
            trs[kind] = cls(model, losses=losses, metrics=[], lr=1e-3, device=dev,
                            train_dir=str(PAR_WORK / f"soc_{kind}"), **kw)
            reset_launches(tp_kernel)
            loss, _ = (trs[kind].train_step(graph) if kind == "one"
                       else trs[kind]._halo_step()(loc, trs[kind].sched.lr))
            torch.cuda.synchronize()
            res[kind] = float(loss)
        launches = check_launches(tp_kernel, {k: 4 * layers + 1 for k in ENGINES["auto"]},
                                  "one so3 halo step")
    finally:
        torch.use_deterministic_algorithms(False)
    if not abs(res["halo"] - res["one"]) <= 1e-6 * abs(res["one"]):
        fail(f"so3 halo step loss {res['halo']!r} vs one-device {res['one']!r}")
    ofs, worst = 0, 0.0
    for name, p in trs["one"].model.named_parameters():
        err, scale = rel_err(trs["halo"].grad[ofs:ofs + p.numel()],
                             trs["one"].grad[ofs:ofs + p.numel()])
        ofs += p.numel()
        if not err <= 1e-5 * scale:
            fail(f"so3 halo step gradient {name}: max|d| {err:.3e} > 1e-5 * {scale:.3e}")
        worst = max(worst, err / scale if scale else 0.0)
    del trs
    torch.cuda.empty_cache()
    print(f"[parallel] (c) so3 halo step (world 1, deterministic): loss {res['halo']!r} vs "
          f"{res['one']!r}, worst gradient {worst:.2e} of max|ref| per tensor, launches "
          f"{launches}; card {card}", flush=True)
    return dict(losses=res, worst_grad_rel_err=worst, launches=launches)


def _par_band(tp_kernel, dev, card):
    """(c) one band-mode halo step (one 16-atom crystal of the band phase,
    6 k, n_data 1) against the one-device eager band step: loss within 1e-5
    relative, band MAE within 5e-4, the flat gradient within 2e-2 * max|g|."""
    import numpy as np
    import torch

    from hamgnn_tpu_torch.cli import build_model
    from hamgnn_tpu_torch.data.graph import pad_and_batch
    from hamgnn_tpu_torch.data.synthetic import add_random_hamiltonian_targets, make_crystal
    from hamgnn_tpu_torch.models.model import init_weights
    from hamgnn_tpu_torch.parallel.halo_model import build_halo_inputs, plan_for_graph
    from hamgnn_tpu_torch.parallel.halo_trainer import HaloTrainer, graph_to
    from hamgnn_tpu_torch.train.config import load_config
    from hamgnn_tpu_torch.train.trainer import Trainer

    rng = np.random.default_rng(5)
    crystal = add_random_hamiltonian_targets(
        rng, make_crystal(rng, n_atoms=16, cell_size=8.0, cutoff=5.0), nao_max=19)
    e = crystal["edge_index"].shape[1]
    graph = pad_and_batch([crystal], node_bucket=16, edge_bucket=((e + 255) // 256) * 256,
                          device=dev)
    host = graph_to(graph, "cpu")
    item = ({k: v[None] for k, v in build_halo_inputs(host, plan_for_graph(host, 1)).items()},
            host)
    layers = BENCH_CFG["representation_nets"]["HamGNN_pre"]["num_layers"]
    trs, res = {}, {}
    for kind, cls, kw in (("one", Trainer, {}), ("halo", HaloTrainer, {"n_data": 1,
                                                                     "n_graph": 1})):
        model = init_weights(build_model(load_config(None, overrides=band_config())), 0)
        trs[kind] = cls(model, losses=BAND_LOSSES, metrics=[], lr=1e-3, device=dev,
                        train_dir=str(PAR_WORK / f"band_{kind}"), **kw)
        reset_launches(tp_kernel)
        loss, logs = trs[kind].train_step(graph if kind == "one" else item)
        torch.cuda.synchronize()
        res[kind] = (float(loss), float(logs["mae_band_energy"]))
    launches = check_launches(tp_kernel, {k: 4 * layers + 1 for k in ENGINES["auto"]},
                              "one band-mode halo step")
    if not (abs(res["halo"][0] - res["one"][0]) <= 1e-5 * abs(res["one"][0])
            and abs(res["halo"][1] - res["one"][1]) <= BAND_TOL):
        fail(f"band-mode halo step (loss, band MAE) {res['halo']} vs one-device {res['one']}")
    # the band-loss term's limit (PERF.md section 2): fp32 eigenvectors beside the pad
    # states at 1e3 carry the rounding of the two paths' sums into the gradient
    ratio = _grad_check("band-mode halo step", trs["halo"].grad, trs["one"].grad, 2e-2)
    del trs
    torch.cuda.empty_cache()
    print(f"[parallel] (c) band-mode halo step (16 atoms, 6 k, world 1): (loss, band MAE) "
          f"{res['halo']} vs one-device {res['one']}, gradient {ratio:.2e} of max|g|, "
          f"launches {launches}; card {card}", flush=True)
    return dict(losses=res, grad_rel_err=ratio, launches=launches)


def _par_cli(dev, card):
    """(d) ``torchrun`` (one process) ``-m hamgnn_tpu_torch.cli`` with
    ``setup.parallel.mode: halo``, then ``dp``, 2 epochs on phase 5's set;
    each run's best.pt tested under ``mode: none`` on the validation crystal
    must give the MAE the run's halo evaluation logged at its best epoch;
    the magnetic head under ``mode: halo`` raises NotImplementedError."""
    import numpy as np
    import yaml

    from hamgnn_tpu_torch import cli
    from hamgnn_tpu_torch.data.dataset import load_graph_npz, reference_split, save_graph_npz
    from hamgnn_tpu_torch.train.config import load_config

    src = WORK / "cli_auto" / "graph_data.npz"
    graphs = load_graph_npz(str(src))
    _, val_idx, _ = reference_split(len(graphs), 1 / 3, 1 / 3, 1 / 3)
    val_dir = PAR_WORK / "cli_val"
    val_dir.mkdir(parents=True, exist_ok=True)
    save_graph_npz(str(val_dir / "graph_data.npz"), [graphs[i] for i in val_idx])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT),
                                                         os.environ.get("PYTHONPATH", "")]))
    env.pop("HAMGNN_TP_ENGINE", None)
    out = {}
    for mode in ("halo", "dp"):
        cfg = json.loads(json.dumps(BENCH_CFG))
        cfg["setup"] = {"stage": "fit", "parallel": {"mode": mode}}
        cfg["dataset_params"] = {"graph_data_path": str(src.parent), "batch_size": 1,
                                 "train_ratio": 1 / 3, "val_ratio": 1 / 3, "test_ratio": 1 / 3}
        cfg["optim_params"] = {"lr": 1e-3, "min_epochs": 0, "max_epochs": 2}
        cfg["profiler_params"] = {"train_dir": str(PAR_WORK / f"cli_{mode}")}
        path = PAR_WORK / f"cli_{mode}.yaml"
        path.write_text(yaml.safe_dump(cfg))
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                            "--nproc_per_node", "1", "-m", "hamgnn_tpu_torch.cli",
                            "--config", str(path)], cwd=str(ROOT), env=env,
                           capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            fail(f"torchrun mode {mode}: exit {r.returncode}\n{r.stdout[-2000:]}\n"
                 f"{r.stderr[-3000:]}")
        train_dir = PAR_WORK / f"cli_{mode}"
        records = [json.loads(line) for line in open(train_dir / "metrics.jsonl")]
        if [x["epoch"] for x in records] != [0, 1] or not all(
                math.isfinite(x["train_loss"]) and math.isfinite(x["val_loss"])
                for x in records):
            fail(f"torchrun mode {mode}: metrics.jsonl {records}")
        for fname in ("best.pt", "prediction_hamiltonian.npy", "config_resolved.yaml"):
            if not (train_dir / fname).exists():
                fail(f"torchrun mode {mode} wrote no {fname}")
        best = min(records, key=lambda x: x["val_loss"])
        test = json.loads(json.dumps(BENCH_CFG))
        test["setup"] = {"stage": "test", "checkpoint_path": str(train_dir / "best.pt")}
        test["dataset_params"] = {"graph_data_path": str(val_dir), "batch_size": 1}
        test["profiler_params"] = {"train_dir": str(PAR_WORK / f"cli_{mode}_test")}
        logs = cli.train_and_evaluate(load_config(None, overrides=test), device=dev)
        got, want = logs["mae_hamiltonian"], best["val/mae_hamiltonian"]
        if not abs(got - want) <= 1e-5 * abs(want):
            fail(f"mode {mode}: best.pt tested under mode none gives MAE {got!r}, the halo "
                 f"evaluation logged {want!r}")
        out[mode] = dict(wall_s=wall, records=records, test_mae=got, logged_mae=want)
        print(f"[parallel] (d) torchrun mode {mode}: 2 epochs in {wall:.1f} s (process "
              f"start included), val_loss {[round(x['val_loss'], 6) for x in records]}; "
              f"best.pt under mode none on the validation crystal: MAE {got!r} vs logged "
              f"{want!r}; card {card}", flush=True)

    # the magnetic head has no GraphView forward: the reference's error
    mag_cfg, _ = mag_config("collinear")
    mag_dir = PAR_WORK / "cli_magnetic"
    mag_dir.mkdir(parents=True, exist_ok=True)
    save_graph_npz(str(mag_dir / "graph_data.npz"), mag_crystals(
        np.random.default_rng(3), "collinear", 3, 4, 6.0, SOC_CUTOFF))
    mag_cfg.update(setup={"stage": "fit", "parallel": {"mode": "halo"}},
                   dataset_params={"graph_data_path": str(mag_dir), "batch_size": 1,
                                   "train_ratio": 1 / 3, "val_ratio": 1 / 3, "test_ratio": 1 / 3},
                   optim_params={"min_epochs": 0, "max_epochs": 1},
                   profiler_params={"train_dir": str(mag_dir / "out")})
    try:
        cli.train_and_evaluate(load_config(None, overrides=mag_cfg), device=dev)
    except NotImplementedError as exc:
        out["magnetic"] = str(exc)
    else:
        fail("mode halo with the magnetic head did not raise NotImplementedError")
    print(f"[parallel] (d) mode halo with the magnetic head: NotImplementedError "
          f"({out['magnetic']})", flush=True)
    return out


def phase_parallel(tp_kernel, dev, card):
    """Phase 14 (see the module docstring)."""
    import torch.distributed as dist

    from hamgnn_tpu_torch.parallel.multihost import free_port, maybe_initialize_distributed

    PAR_WORK.mkdir(parents=True, exist_ok=True)
    maybe_initialize_distributed(f"tcp://localhost:{free_port()}", 1, 0, device=dev)
    if dist.get_backend() != "nccl":
        fail(f"the world-1 group runs {dist.get_backend()}, not nccl")
    seconds, out = {}, {}
    try:
        for name, fn, *args in (
                ("world1_auto", _par_world1, tp_kernel, dev, card, "auto"),
                ("world1_zonal", _par_world1, tp_kernel, dev, card, "zonal"),
                ("two_ranks", _par_two_ranks, card),
                ("soc", _par_soc, tp_kernel, dev, card),
                ("band", _par_band, tp_kernel, dev, card),
                ("cli", _par_cli, dev, card)):
            if name == "two_ranks":
                args.append(out["world1_auto"].pop("ref"))
            t0 = time.perf_counter()
            out[name] = fn(*args)
            seconds[name] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    out["world1_zonal"].pop("ref", None)
    return dict(out, seconds=seconds)


# ----------------------------------------------------------------------
# the precision and schedule variants (HAMGNN_TP_BF16, HAMGNN_TP_STOREMID)
# ----------------------------------------------------------------------

# a bf16 instantiation against its plain bf16 version, of max|plain|: the
# kernel's fp32 operands differ from the plain version's in the last bit (FFMA
# against multiply and add, the order of sums), and one next to a bf16
# rounding boundary rounds to the other neighbour (one bf16 ulp of one term)
VARIANT_TOL = 1e-3
VARIANT_GAP = 10      # max|bf16 kernel - fp32 kernel| >= 10 x max|bf16 kernel - plain|
# a bf16 step's parameter gradients against the fp32 step's, per tensor, of
# max|fp32|: the rounding of the products' operands (2^-9 relative each)
# carried through three layers
VARIANT_GRAD_TOL = 5e-2
# the variants' entries in the kernels line: (kernel, the kernel they vary, mode)
VARIANT_KERNELS = {"packed_tp_fwd_bf16": ("packed_tp_fwd", "all"),
                   "packed_tp_bwd_bf16": ("packed_tp_bwd", "bwd"),
                   "zonal_tp_fwd_bf16": ("zonal_tp_fwd", "all"),
                   "zonal_tp_bwd_bf16": ("zonal_tp_bwd", "bwd"),
                   "packed_tp_fwd_storemid": ("packed_tp_fwd", "storemid"),
                   "packed_tp_bwd_storemid": ("packed_tp_bwd", "storemid")}
# the captured bench steps of phase_variants: (engine, HAMGNN_TP_BF16, HAMGNN_TP_STOREMID)
VARIANT_STEPS = {"fp32": ("auto", "", ""), "bf16_bwd": ("auto", "bwd", ""),
                 "bf16_all": ("auto", "all", ""), "storemid": ("auto", "", "1"),
                 "zonal_fp32": ("zonal", "", ""), "zonal_bf16_all": ("zonal", "all", "")}


@contextlib.contextmanager
def switches(eng: str, bf16: str, store: str):
    """The body under ``HAMGNN_TP_ENGINE`` (``engine``), ``HAMGNN_TP_BF16``
    and ``HAMGNN_TP_STOREMID`` (empty: unset)."""
    old = {k: os.environ.pop(k, None) for k in ("HAMGNN_TP_BF16", "HAMGNN_TP_STOREMID")}
    for k, v in (("HAMGNN_TP_BF16", bf16), ("HAMGNN_TP_STOREMID", store)):
        if v:
            os.environ[k] = v
    try:
        with engine(eng):
            yield
    finally:
        for k, v in old.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def in_turns(fns: dict, rounds: int = 3, iters: int = 5) -> dict:
    """CUDA-event medians of each function, timed in turns (``rounds`` of
    ``iters`` each), so that a clock drift touches all alike."""
    import numpy as np

    ts = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            ts[k].append(cuda_time_ms(fn, iters, warmup=1))
    return {k: float(np.median(v)) for k, v in ts.items()}


def _bound_parts(tp_kernel, spec, E, has_w, fwd, bf16=False, stored=False) -> dict:
    """A variant's least time on an H100, by side: the operations (the Wcat
    products of a bf16 instantiation at the dense bf16 tensor-core rate, the
    rest at the fp32 rate) and the bytes."""
    kw = {"stored": True} if stored else {}
    flops, nbytes = spec.work(E, has_w, **kw) if fwd else spec.work_bwd(E, has_w, **kw)
    tc = (1 if fwd else 2) * spec.wcat_flops(E) if bf16 else 0
    ops_ms = ((flops - tc) / tp_kernel.H100_FP32_FLOPS + tc / tp_kernel.H100_BF16_FLOPS) * 1e3
    bytes_ms = nbytes / tp_kernel.H100_HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms), ops_ms=ops_ms, bytes_ms=bytes_ms,
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def _variant_check(what, got, again, ref, fp32):
    """A bf16 kernel's output against its plain bf16 version (VARIANT_TOL),
    a second launch bit-identical, and the fp32 kernel's output at least
    VARIANT_GAP times farther.  Returns (err, scale, gap)."""
    import torch

    if not torch.equal(got, again):
        fail(f"{what}: differs between two launches")
    err, scale = rel_err(got, ref)
    gap = float((got - fp32).abs().max())
    if not math.isfinite(err) or err > VARIANT_TOL * scale:
        fail(f"{what}: max|d| {err:.3e} > {VARIANT_TOL} * {scale:.3e}")
    if not gap >= VARIANT_GAP * err:
        fail(f"{what}: the bf16 kernel is {gap:.3e} from the fp32 one, not {VARIANT_GAP} x "
             f"its {err:.3e} from the plain bf16 version: the mode does not round")
    return err, scale, gap


def _variant_lab(tp_kernel, dev, name, plan, has_w):
    """B1 and B2 in bf16, and the stored-mid pair, at one bench plan."""
    import numpy as np
    import torch

    from hamgnn_tpu_torch.e3.packed_tp import plain_apply, plain_backward
    from hamgnn_tpu_torch.tools_dev.probe import device_normal

    spec = tp_kernel.get_spec(plan)
    rng = np.random.default_rng(21)
    E = E_BENCH

    t = device_normal(rng, dev)

    x, sh, fw, gy = t(E, spec.d_in), t(E, spec.S), t(plan.linear_numel), t(E, spec.d_out)
    w = t(E, spec.n_ch) if has_w else None
    out = {}
    with torch.inference_mode():
        fwd = lambda bf: tp_kernel.packed_tp_forward(plan, x, sh, w, fw, bf)  # noqa: E731
        got, again, fp32 = fwd("all"), fwd("all"), fwd("")
        ref = plain_apply(plan, x, sh, w, fw, bf16=True)
        torch.cuda.synchronize()
        err, scale, gap = _variant_check(f"packed_tp_fwd_bf16[{name}]", got, again, ref, fp32)
        del got, again, ref
        ms = in_turns({"bf16": lambda: fwd("all"), "fp32": lambda: fwd("")})
        plain_ms = cuda_time_ms(lambda: plain_apply(plan, x, sh, w, fw, bf16=True), 3)
    out["packed_tp_fwd_bf16"] = dict(max_abs_err=err, max_abs_ref=scale, gap_to_fp32=gap,
                                     ms=ms["bf16"], fp32_ms=ms["fp32"], plain_ms=plain_ms,
                                     **_bound_parts(tp_kernel, spec, E, has_w, True, True))

    bwd = lambda bf, mids=None: tp_kernel.packed_tp_backward(  # noqa: E731
        plan, x, sh, w, fw, gy, False, bf, mids)
    got, again, fp32 = bwd(True), bwd(True), bwd(False)
    ref = plain_backward(plan, x, sh, w, fw, gy, False, True)
    torch.cuda.synchronize()
    errs = {}
    for key, a, b, c, d in zip(("dx", "dsh", "dw", "dflat_w"), got, again, ref, fp32):
        if c is not None:
            errs[key] = _variant_check(f"packed_tp_bwd_bf16[{name}] {key}", a, b, c, d)
    del got, again, ref, fp32
    ms = in_turns({"bf16": lambda: bwd(True), "fp32": lambda: bwd(False)})
    plain_ms = cuda_time_ms(lambda: plain_backward(plan, x, sh, w, fw, gy, False, True), 3)
    passes = bwd_pass_ms(tp_kernel.PACKED_TP_BWD,
                         tp_kernel.bwd_call(spec, x, sh, w, fw, gy, False, True))
    out["packed_tp_bwd_bf16"] = dict(
        max_abs_err=max(e for e, _s, _g in errs.values()),
        errors={k: list(v) for k, v in errs.items()}, ms=ms["bf16"], fp32_ms=ms["fp32"],
        plain_ms=plain_ms, **_bound_parts(tp_kernel, spec, E, has_w, False, True), **passes)

    # the stored-mid pair, fp32: bit-identical to the recompute path
    with torch.inference_mode():
        o_s, mids = tp_kernel.packed_tp_store_forward(plan, x, sh, w, fw)
        if not torch.equal(o_s, fwd("")):
            fail(f"packed_tp_fwd_storemid[{name}]: the output differs from the recompute path's")
    stored, recomputed = bwd(False, mids), bwd(False)
    torch.cuda.synchronize()
    for key, a, b in zip(("dx", "dsh", "dw", "dflat_w"), stored, recomputed):
        if (a is None) != (b is None) or (a is not None and not torch.equal(a, b)):
            fail(f"packed_tp_bwd_storemid[{name}] {key}: differs from the recompute path")
    del stored, recomputed
    with torch.inference_mode():
        ms_f = in_turns({"store": lambda: tp_kernel.packed_tp_store_forward(plan, x, sh, w, fw),
                         "fp32": lambda: fwd("")})
        plain_f = cuda_time_ms(lambda: plain_apply(plan, x, sh, w, fw), 3)
    ms_b = in_turns({"store": lambda: bwd(False, mids), "fp32": lambda: bwd(False)})
    plain_b = cuda_time_ms(lambda: plain_backward(plan, x, sh, w, fw, gy), 3)
    extra = 4 * E * spec.midw
    for key, m, pl_ms, fwd_ in (("packed_tp_fwd_storemid", ms_f, plain_f, True),
                                ("packed_tp_bwd_storemid", ms_b, plain_b, False)):
        out[key] = dict(max_abs_err=0.0, ms=m["store"], fp32_ms=m["fp32"], plain_ms=pl_ms,
                        mid_bytes=extra,
                        **_bound_parts(tp_kernel, spec, E, has_w, fwd_, stored=True))
    del x, sh, w, fw, gy, mids
    torch.cuda.empty_cache()
    return out


def _variant_zonal(tp_kernel, dev, name, plan, has_w):
    """B3 and B4 in bf16 at one bench plan."""
    import torch

    from hamgnn_tpu_torch.e3 import zonal_kernel, zonal_tp

    spec = zonal_kernel.get_zonal_kernel_spec(plan)
    E = E_BENCH
    _x, _sh, x_rot, w, fw, gy = zonal_inputs(plan, has_w, 22, dev, with_gout=True)
    out = {}
    with torch.inference_mode():
        fwd = lambda bf: zonal_kernel.zonal_core_forward(plan, x_rot, w, fw, bf)  # noqa: E731
        got, again, fp32 = fwd("all"), fwd("all"), fwd("")
        ref = zonal_tp.plain_zonal_core(plan, x_rot, w, fw, True)
        torch.cuda.synchronize()
        err, scale, gap = _variant_check(f"zonal_tp_fwd_bf16[{name}]", got, again, ref, fp32)
        del got, again, ref
        ms = in_turns({"bf16": lambda: fwd("all"), "fp32": lambda: fwd("")})
        plain_ms = cuda_time_ms(lambda: zonal_tp.plain_zonal_core(plan, x_rot, w, fw, True), 3)
    out["zonal_tp_fwd_bf16"] = dict(max_abs_err=err, max_abs_ref=scale, gap_to_fp32=gap,
                                    ms=ms["bf16"], fp32_ms=ms["fp32"], plain_ms=plain_ms,
                                    **_bound_parts(tp_kernel, spec, E, has_w, True, True))
    bwd = lambda bf: zonal_kernel.zonal_core_backward(plan, x_rot, w, fw, gy, bf)  # noqa: E731
    got, again, fp32 = bwd(True), bwd(True), bwd(False)
    ref = zonal_tp.plain_zonal_core_backward(plan, x_rot, w, fw, gy, True)
    torch.cuda.synchronize()
    errs = {}
    for key, a, b, c, d in zip(("dx_rot", "dw", "dflat_w"), got, again, ref, fp32):
        if c is not None:
            errs[key] = _variant_check(f"zonal_tp_bwd_bf16[{name}] {key}", a, b, c, d)
    del got, again, ref, fp32
    ms = in_turns({"bf16": lambda: bwd(True), "fp32": lambda: bwd(False)})
    plain_ms = cuda_time_ms(
        lambda: zonal_tp.plain_zonal_core_backward(plan, x_rot, w, fw, gy, True), 3)
    passes = bwd_pass_ms(tp_kernel.ZONAL_TP_BWD,
                         zonal_kernel.bwd_call(spec, x_rot, w, fw, gy, True))
    out["zonal_tp_bwd_bf16"] = dict(
        max_abs_err=max(e for e, _s, _g in errs.values()),
        errors={k: list(v) for k, v in errs.items()}, ms=ms["bf16"], fp32_ms=ms["fp32"],
        plain_ms=plain_ms, **_bound_parts(tp_kernel, spec, E, has_w, False, True), **passes)
    del x_rot, w, fw, gy
    torch.cuda.empty_cache()
    return out


def _variant_step(tp_kernel, dev, card, graph, n_edges, key, ref=None):
    """The bench training step under the switches of ``VARIANT_STEPS[key]``,
    captured as the trainer runs it by default, its first step under
    deterministic algorithms (so that two modes compare bit for bit): its
    loss and flat gradient; one replay's launches by the profiler (13 of
    each device kernel of the engine); an eager pass through the trainer's
    model, 13 + 13 host launches of the mode's kernels and no other; the
    captured step's wall (median of 5) and device time, edges/s, and the
    peak memory of its first step (warm-up, capture, replay)."""
    import numpy as np
    import torch

    from hamgnn_tpu_torch.cli import build_model
    from hamgnn_tpu_torch.models.model import compute_losses, init_weights
    from hamgnn_tpu_torch.train.config import load_config
    from hamgnn_tpu_torch.train.trainer import Trainer

    eng, bf16, store = VARIANT_STEPS[key]
    layers = BENCH_CFG["representation_nets"]["HamGNN_pre"]["num_layers"]
    per = 4 * layers + 1
    base_f, base_b = ENGINES[eng]
    fwd = f"{base_f}_storemid" if store else (f"{base_f}_bf16" if bf16 == "all" else base_f)
    bwd = f"{base_b}_storemid" if store else (f"{base_b}_bf16" if bf16 else base_b)
    with switches(eng, bf16, store):
        model = init_weights(build_model(load_config(None, overrides=BENCH_CFG)), 0)
        tr = Trainer(model, losses=BENCH_LOSSES, metrics=[], lr=1e-3,
                     train_dir=str(WORK / f"variant_{key}"), device=dev)
        if tr.captured is None:
            fail(f"variant step {key}: the default trainer must capture on the card")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        torch.use_deterministic_algorithms(True)
        try:
            reset_launches(tp_kernel)
            loss, logs = tr.train_step(graph)
            torch.cuda.synchronize()
            check_launches(tp_kernel, {fwd: 2 * per, bwd: 2 * per},
                           f"the first captured {key} step (warm-up and capture)")
        finally:
            torch.use_deterministic_algorithms(False)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        loss = float(loss)
        if not math.isfinite(loss) or float(logs["nonfinite_step"]) != 0.0:
            fail(f"variant step {key}: loss {loss}")
        grad = tr.grad.clone()
        names = [n for k in ENGINES[eng] for n in tp_kernel.KERNELS[k].device_kernels]
        reads = profiled_launches(lambda: tr.train_step(graph), names, per)
        replay = reads[-1]
        if replay != {n: per for n in names}:
            fail(f"one replay of the {key} step launched {reads} (profiler traces), expected "
                 f"{per} of each")
        times = [_host_time(lambda: tr.train_step(graph)) for _ in range(5)]
        device = profile_train_step(tr, graph, f"profile_variant_{key}.txt")
        # an eager pass through the same model: the mode's kernels, 13 + 13
        reset_launches(tp_kernel)
        compute_losses(tr.model(graph), graph, BENCH_LOSSES)[0].backward()
        torch.cuda.synchronize()
        launches = check_launches(tp_kernel, {fwd: per, bwd: per}, f"an eager {key} pass")
        launches = {n: k.launches for n, k in all_kernels(tp_kernel).items() if k.launches}
    ms = 1e3 * float(np.median(times))
    res = dict(engine=eng, bf16=bf16, storemid=bool(store), loss=loss, kernels=[fwd, bwd],
               launches=launches, replay_launches=replay, wall_ms=ms,
               times_ms=[1e3 * t for t in times], device_ms=device["__all__"],
               edges_per_s=n_edges / (ms * 1e-3), peak_gb=peak_gb)
    if ref is not None:
        res["loss_vs_fp32"] = [loss, ref["loss"]]
        worst, ofs = (0.0, ""), 0
        for name, p in tr.model.named_parameters():
            a, b = grad[ofs:ofs + p.numel()], ref["grad"][ofs:ofs + p.numel()]
            ofs += p.numel()
            err, scale = rel_err(a, b)
            if scale > 0 and err / scale > worst[0]:
                worst = (err / scale, name)
        res["worst_grad_vs_fp32"] = list(worst)
        res["grad_equal_fp32"] = bool(torch.equal(grad, ref["grad"]))
    print(f"[variants] step {key} ({eng}, BF16={bf16 or '-'}, STOREMID={store or '-'}): "
          f"loss {loss!r}" + (f" (fp32 {ref['loss']!r}), worst gradient vs fp32 "
                              f"{res['worst_grad_vs_fp32'][0]:.3e} of max|ref| "
                              f"({res['worst_grad_vs_fp32'][1]}), gradient bit-identical "
                              f"{res['grad_equal_fp32']}" if ref is not None else "")
          + f"; replay launched {replay}; eager pass {launches}; captured step {ms:.3f} ms "
          f"wall (median of 5), {device['__all__']:.3f} ms device, "
          f"{n_edges / (ms * 1e-3):.1f} edges/s, peak {peak_gb:.2f} GB, card {card}",
          flush=True)
    res["grad"] = grad
    del tr, model
    torch.cuda.empty_cache()
    return res


def phase_variants(tp_kernel, dev, card):
    """The TP kernels' precision and schedule variants at the bench width
    (E = 19,968; the pair, pair_lite, node and edge plans): each of B1-B4 in
    bf16 against its plain bf16 version (VARIANT_TOL), a second launch
    bit-identical, the fp32 kernel VARIANT_GAP times farther, bf16 and
    3xTF32 timed in turns (B2 and B4 have one bf16 instantiation, which
    ``bwd`` and ``all`` share); the stored-mid pair bit-identical to the
    recompute path, both timed, its bytes; then the captured bench step under
    each of VARIANT_STEPS against the fp32 step of its engine."""
    import torch

    rows = {k: [] for k in VARIANT_KERNELS}
    for name, plan, has_w, per in bench_plans():
        for part in (_variant_lab(tp_kernel, dev, name, plan, has_w),
                     _variant_zonal(tp_kernel, dev, name, plan, has_w)):
            for k, r in part.items():
                rows[k].append(dict(plan=name, launches_per_step=per, **r))
                print(f"[variants] {k:22s} {name:9s} E={E_BENCH} max|d|={r['max_abs_err']:.3e} "
                      f"kernel {r['ms']:.4f} ms (fp32 kernel {r['fp32_ms']:.4f} ms, in turns) "
                      f"plain {r['plain_ms']:.4f} ms bound {r['bound_ms']:.4f} ms "
                      f"({r['bound_by']})" + (f" stored mids {r['mid_bytes'] / 1e6:.1f} MB"
                                              if "mid_bytes" in r else ""), flush=True)
    graph, n_edges = bench_graph(dev)
    steps = {}
    for key in VARIANT_STEPS:
        base = "zonal_fp32" if VARIANT_STEPS[key][0] == "zonal" else "fp32"
        steps[key] = _variant_step(tp_kernel, dev, card, graph, n_edges, key,
                                   None if key == base else steps[base])
    for key, r in steps.items():
        if "loss_vs_fp32" not in r:
            continue
        la, lb = r["loss_vs_fp32"]
        if VARIANT_STEPS[key][1] == "all":
            if not abs(la - lb) <= 1e-2 * abs(lb) or r["worst_grad_vs_fp32"][0] == 0.0:
                fail(f"variant step {key}: loss {la!r} vs fp32 {lb!r}")
        elif la != lb:
            fail(f"variant step {key}: the forward is fp32, but the loss {la!r} is not the "
                 f"fp32 step's {lb!r}")
        if key == "storemid" and not r["grad_equal_fp32"]:
            fail("the stored-mid step's gradient differs from the fp32 step's")
        if VARIANT_STEPS[key][1] and not (
                0.0 < r["worst_grad_vs_fp32"][0] <= VARIANT_GRAD_TOL):
            fail(f"variant step {key}: worst gradient {r['worst_grad_vs_fp32']} of max|ref| "
                 f"against the fp32 step, expected in (0, {VARIANT_GRAD_TOL}]")
    for r in steps.values():
        del r["grad"]
    torch.cuda.empty_cache()
    return dict(rows=rows, steps=steps)


# phase 16: the shipped examples' accuracy chains at a tiny size, through the
# harness a user runs (under build/chip_smoke/examples)
EXAMPLES_WORK = WORK / "examples"
EXAMPLE_CHAINS = ("sk_siesta", "sk_abacus", "sk_lmdb", "sk_collinear", "sk_ncl", "sk_spinsoc")
EXAMPLE_KEYS = ("example", "test_mae_Ha", "test_metrics", "best_val_mae_Ha", "best_val_epoch",
                "val_mae_last_Ha", "test_mae_best_Ha",
                "epochs", "sec_per_epoch_median", "band_dev_max_meV", "band_dev_mean_meV",
                "bands", "seconds", "resumed", "seed", "init_seed", "tp_launches_run",
                "tp_launches_per_step", "jax", "marks", "card")


def phase_examples(tp_kernel):
    """Each example chain of ``tools_dev/sk_accuracy.py`` but ``sk`` and
    ``sk_soc`` (whose data phase 12 makes) at its config's width on 2
    structures a species, 1 epoch: the harness's result (and its
    ``result.json``) with every key, finite MAEs and acceptance numbers,
    the run through B1 and B2 and no other kernel, and one replay of its
    captured training step (from its ``best.pt``, read by the profiler) at
    4 * layers + 1 launches of each."""
    import yaml

    from hamgnn_tpu_torch.tools_dev import sk_accuracy
    from hamgnn_tpu_torch.tools_dev.sk_examples import EXAMPLES

    if EXAMPLES_WORK.exists():
        shutil.rmtree(EXAMPLES_WORK)
    out = {}
    for name in EXAMPLE_CHAINS:
        ex = EXAMPLES[name]
        sizes = (["--n", "6"] if ex.data != "container"
                 else ["--n-si", "2", "--n-c", "2", "--n-sic", "2"])
        t0 = time.perf_counter()
        r = sk_accuracy.main(["--example", name, "--out", str(EXAMPLES_WORK / name),
                              "--max-epochs", "1"] + sizes)
        seconds = time.perf_counter() - t0
        saved = json.loads((EXAMPLES_WORK / name / "result.json").read_text())
        missing = [k for k in EXAMPLE_KEYS if k not in saved]
        if missing or saved != json.loads(json.dumps(r)):
            fail(f"example {name}: result.json lacks {missing} or differs from the printed line")
        cfg = yaml.safe_load((ROOT / "examples" / name / "config.yaml").read_text())
        per = 4 * cfg["representation_nets"]["HamGNN_pre"]["num_layers"] + 1
        run = r["tp_launches_run"]
        if set(run) != set(ENGINES["auto"]) or min(run.values()) == 0 \
                or r["tp_launches_per_step"] != {k: per for k in ENGINES["auto"]}:
            fail(f"example {name}: launches over the run {run}, in one replay of its step "
                 f"{r['tp_launches_per_step']}, expected B1 and B2 only, {per} of each a step")
        numbers = [r["test_mae_Ha"], r["best_val_mae_Ha"], r["test_mae_best_Ha"],
                   *r["test_metrics"].values()]
        if ex.acceptance != "mae":
            numbers += [r["band_dev_max_meV"], r["band_dev_mean_meV"]]
        if ex.acceptance == "collinear":
            numbers += [*r["decomposition"].values(),
                        *(s["band_dev_mean_meV"] for s in r["spin_bands"].values())]
        if r["epochs"] != 1 or not all(v is not None and math.isfinite(v) for v in numbers):
            fail(f"example {name}: {r['epochs']} epochs, numbers {numbers}")
        print(f"[examples] {name}: {seconds:.1f} s, test MAE {r['test_mae_Ha']:.4e} Ha, "
              f"launches over the run {run}, one replay {r['tp_launches_per_step']}"
              + (f", bands mean {r['band_dev_mean_meV']:.1f} meV" if ex.acceptance != "mae"
                 else "") + (f", store {r['store']}" if "store" in r else ""), flush=True)
        out[name] = dict(seconds=seconds, launches_run=run,
                         launches_per_step=r["tp_launches_per_step"],
                         test_mae_Ha=r["test_mae_Ha"], store=r.get("store"))
    shutil.rmtree(EXAMPLES_WORK)
    return out


def rep_launches(representation, eng, name, tp_kernel) -> int:
    """A kernel's launches in one replay of the Transformer step under its
    engine (the profiler's count of each of its device kernels)."""
    counts = {representation["steps"][f"transformer:{eng}"]["replay_launches"][dk]
              for dk in tp_kernel.KERNELS[name].device_kernels}
    if len(counts) != 1:
        fail(f"{name}: the Transformer replay launched its device kernels {counts} times")
    return counts.pop()


def mag_launches(magnetic, eng, name, tp_kernel) -> int:
    """A kernel's launches in one replay of the magnetic step (the profiler's
    count of each of its device kernels), the same in every branch."""
    counts = {r["replay_launches"][dk] for key, r in magnetic["steps"].items()
              if key.split(":")[1] == eng for dk in tp_kernel.KERNELS[name].device_kernels}
    if len(counts) != 1:
        fail(f"{name}: the magnetic branches' replays launched it {counts} times")
    return counts.pop()


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

    seconds = {}

    def timed(name, fn, *args):
        """``fn(*args)``, its seconds printed and kept under ``name``."""
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        print(f"[time] {name}: {seconds[name]:.1f} s", flush=True)
        return out

    card = timed("build", phase_build, tp_kernel)
    rows = {"packed_tp_fwd": timed("b1", phase_kernels, tp_kernel, dev),
            "packed_tp_bwd": timed("b2", phase_bwd_kernels, tp_kernel, dev),
            "zonal_tp_fwd": timed("b3", phase_zonal_kernels, dev),
            "zonal_tp_bwd": timed("b4", phase_zonal_bwd_kernels, dev)}
    wide = timed("wide", phase_wide_kernels, tp_kernel, dev)
    zonal_engine = timed("zonal_engine", phase_zonal_engine, tp_kernel, dev)
    model = timed("model", phase_model, tp_kernel, dev, card)
    train = {eng: timed(f"train_{eng}", phase_train, tp_kernel, dev, card, eng)
             for eng in ENGINES}
    captured = {eng: timed(f"captured_{eng}", phase_captured, tp_kernel, dev, card, eng)
                for eng in ENGINES}
    variants = timed("variants", phase_variants, tp_kernel, dev, card)
    fit = {}
    for eng in ENGINES:
        cfg, n_rows = timed(f"cli_{eng}", phase_cli, tp_kernel, eng)
        fit[eng] = timed(f"cli_fit_{eng}", phase_cli_fit, tp_kernel, eng, cfg, n_rows)

    probes = timed("probes", phase_probes, tp_kernel, dev)
    eigh = timed("eigh", phase_eigh)
    band = timed("band", phase_band, tp_kernel, dev, card)
    band_fit = timed("band_cli", phase_band_cli, tp_kernel)
    soc = timed("soc", phase_soc, tp_kernel, dev, card)
    magnetic = timed("magnetic", phase_magnetic, tp_kernel, dev, card)
    lmdb = timed("lmdb", phase_lmdb, tp_kernel, dev)
    representation = timed("representation", phase_representation, tp_kernel, dev, card)
    datagen = timed("datagen", phase_datagen, tp_kernel)
    uni = timed("uni", phase_uni, tp_kernel, dev, card)
    parallel = timed("parallel", phase_parallel, tp_kernel, dev, card)
    examples = timed("examples", phase_examples, tp_kernel)

    report = {"card": card, "kernel_rows": rows, "wide": wide, "zonal_engine": zonal_engine,
              "model": model, "train": train, "captured": captured, "variants": variants,
              "fit": fit,
              "probes": probes,
              "eigh": eigh, "band": band, "band_fit": band_fit, "soc": soc,
              "magnetic": magnetic,
              "lmdb": lmdb, "representation": representation, "datagen": datagen,
              "uni": uni, "parallel": parallel, "examples": examples, "seconds": seconds}
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
                "sk_soc_per_plan": {r["plan"]: {k: r[k] for k in
                                                ("ms", "plain_ms", "bound_ms", "bound_by",
                                                 "max_abs_err", "edge_ms", "wcat_ms") if k in r}
                                    for r in soc["kernels"][name]},
                "sk_soc_launches_per_step": soc["steps"][f"so3:{eng}"]["launches"][name],
                "sk_magnetic_launches_per_step": mag_launches(magnetic, eng, name, tp_kernel),
                "transformer_launches_per_step": rep_launches(representation, eng, name,
                                                              tp_kernel),
                # per two-stage Uni-HamGNN prediction (sk + sk_soc models, no backward)
                "uni_launches_per_prediction": (
                    uni["native"]["launches"][eng][name] // uni["native"]["crystals"]),
                # one eager halo step (world 1, n_graph 1) at the bench width
                "halo_launches_per_step": parallel[f"world1_{eng}"]["halo"]["launches"][name],
                # one replay of each example chain's captured training step,
                # from its best.pt, by the profiler (phase 16)
                "examples_launches_per_step": (
                    {ex: r["launches_per_step"][name] for ex, r in examples.items()}
                    if eng == "auto" else {}),
                # one replay of the captured band steps, by device kernel
                "band_replay_launches": (
                    {tag: {dk: res["captured_vs_eager"]["replay_launches"][dk]
                           for dk in tp_kernel.KERNELS[name].device_kernels}
                     for tag, res in (("band", band), ("soc", soc["band"]),
                                      ("collinear", magnetic["band"]))}
                    if eng == "auto" else
                    {"band": {dk: band["zonal_replay_launches"][dk]
                              for dk in tp_kernel.KERNELS[name].device_kernels}}),
            })
            if eng == "auto":  # the step of the fit on the data the port made
                kernels[-1]["sk_datagen_launches_per_step"] = {
                    dk: datagen["fit"]["replay_launches"][dk]
                    for dk in tp_kernel.KERNELS[name].device_kernels}
    for vname, (name, mode) in VARIANT_KERNELS.items():
        # per training step: the 13 launches at their plans' shapes; launches:
        # a step of the mode's captured run (an eager pass through its model)
        path_rows = [r for r in variants["rows"][vname] if r["launches_per_step"] > 0]
        per_step = lambda key: sum(r[key] * r["launches_per_step"]  # noqa: E731
                                   for r in path_rows)
        step = {"all": "bf16_all", "bwd": "bf16_bwd", "storemid": "storemid"}[mode]
        if name.startswith("zonal"):
            step = "zonal_bf16_all"
        src, replaces = KERNEL_SOURCES[name]
        ops_ms, bytes_ms = per_step("ops_ms"), per_step("bytes_ms")
        kernels.append({
            "name": vname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": variants["steps"][step]["launches"].get(vname, 0),
            "max_abs_err": max(r["max_abs_err"] for r in variants["rows"][vname]),
            "ms": per_step("ms"), "plain_ms": per_step("plain_ms"),
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None, "fp32_ms": per_step("fp32_ms"), "mode": mode,
            "per_plan": {r["plan"]: {k: r[k] for k in
                                     ("ms", "fp32_ms", "plain_ms", "bound_ms", "bound_by",
                                      "max_abs_err", "edge_ms", "wcat_ms", "mid_bytes")
                                     if k in r} for r in variants["rows"][vname]}})
    for name, r in probes.items():
        kernels.append({
            "name": name, "route": "cuda", "source": r["source"], "replaces": r["replaces"],
            "launches": r["launches"], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "rows": r["rows"]})
        if len(r["at_rows"]) > 1:  # P1/P2: the smaller size too
            kernels[-1]["at_rows"] = {n: {k: m[k] for k in ("ms", "library_ms", "bound_ms")}
                                      for n, m in r["at_rows"].items()}
    print(json.dumps({"uni": {
        "launches_per_prediction": {ENGINES[eng][0]: uni["native"]["launches"][eng][
            ENGINES[eng][0]] // uni["native"]["crystals"] for eng in ENGINES},
        "ms": {"nonsoc_per_crystal": uni["native"]["ms_per_crystal"]["nonsoc"],
               "soc_per_crystal": uni["native"]["ms_per_crystal"]["soc"],
               "compat_forward": uni["compat"]["forward_ms"],
               "band_solve": float(sum(uni["bands"]["solve_ms"]) / len(uni["bands"]["solve_ms"]))},
        "errors": {"vs_plain_tp": uni["native"]["err_vs_plain"],
                   "zonal_vs_default": uni["native"]["err_zonal"],
                   "scale": uni["native"]["scale"],
                   "compat_vs_cpu_float64": max(uni["compat"]["errors"].values()),
                   "compat_scale": uni["compat"]["scale"],
                   "bands_vs_scipy_ha": uni["bands"]["max_abs_err"]},
        "peak_mb": {"predictor": uni["native"]["peak_mb"],
                    "compat_forward": uni["compat"]["peak_mb"]},
        "card": card}}))
    two = parallel["two_ranks"]
    print(json.dumps({"parallel": {
        "world1": {eng: {kind: {k: parallel[f"world1_{eng}"][kind][k] for k in
                                ("wall_ms", "device_ms", "peak_gb", "grad_rel_err")}
                         for kind in ("halo", "dp")} for eng in ENGINES},
        "plan_s1": parallel["world1_auto"]["plan"],
        "two_ranks": ({k: two[k] for k in ("grad_rel_err", "plan", "wall_ms_shared_card")}
                      if two["ran"] else {"left_out": two["gloo_cuda"]}),
        "soc_worst_grad": parallel["soc"]["worst_grad_rel_err"],
        "band_grad": parallel["band"]["grad_rel_err"],
        "cli_mae": {m: [parallel["cli"][m]["test_mae"], parallel["cli"][m]["logged_mae"]]
                    for m in ("halo", "dp")},
        "card": card}}))
    print(json.dumps({"eigh": {
        "hermitian_eigh_vs_torch": {r["n"]: {k: r[k] for k in ("batch", "eig_rel_err", "residual_rel",
                                                      "ms")} for r in eigh["sizes"]},
        "capture_alone": eigh["capture_alone"],
        "band_steps": {tag: {k: res["captured_vs_eager"][k] for k in
                             ("segments", "wall_ms", "device_ms", "replay_launches",
                              "replay_solves", "worst_grad_rel_err")}
                       for tag, res in (("band", band), ("soc", soc["band"]),
                                        ("collinear", magnetic["band"]))},
        "card": card}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
