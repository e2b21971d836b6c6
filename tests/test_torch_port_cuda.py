"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: skips where no GPU is present.  Imports no JAX, so it runs
on a machine with only the port installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

The bf16 instantiations of B1-B4 (``HAMGNN_TP_BF16``) against their plain
bf16 versions within 1e-3 * max|plain| (a kernel's fp32 operand that differs
from the plain version's in the last bit may round to the other bf16
neighbour), each at least 10x closer to it than to the fp32 kernel, B2's and
B4's repeats bit-identical, each launch counted on its own variant; the
stored-mid pair (``HAMGNN_TP_STOREMID``) bit for bit against the recompute
path in fp32 and bf16, its mids within 1e-5 of ``packed_tp.chunk_mids``; the
switches through ``PackedTPPlan.__call__`` pick the variants.

Tolerance: max|kernel - plain| <= 1e-4 * max|plain| in fp32 (only the
summation order differs), per output of the forward (B1) and of the
backward (B2: dx, dsh, dw, d(flat_w)), also at outputs wider than one work
item; a repeat of B2 is bit-identical; at the bench plans both fit the
blocks per SM their designs assume (the C entries' own shared-memory sizes).
The same holds for the zonal engine's kernels (B3 against
``plain_zonal_core``, B4 against ``plain_zonal_core_backward``, its
d(flat_w) within 1e-5 * max|plain|, also at outputs wider than one work
item; two blocks of each share an SM at the bench plans); the whole
zonal engine (two rotations around the kernels) is held to the lab-frame
plain version within 2e-5 * max|ref| (outputs) and 1e-4 * max|ref|
(gradients).  Every probe kernel (``tools_dev``) is held to its plain version
within its stated limit (fp32 1e-4, bf16 2e-2, tf32 operands 2e-3, all *
max|plain|) at its own size, the throughput probes at E = 256, the P1/P2
probes also at the bench rows (19,968) and at 1,001 rows, ``p1``, ``p3``,
``p6``, ``p7`` and ``p7_tf32`` also at 19,968 and 1,088 rows; ``k_acc``,
``p1``, ``p3``, ``p6``, ``p7`` and ``p7_tf32`` repeat bit for bit.  ``p7_tf32``'s library
call, a TF32 ``torch.matmul``, is within the same 2e-3 of the plain product.

The captured training step (``train/captured.py``) against the eager step
from the same state, under both engines: the loss within 1e-6 relative, the
gradient per parameter tensor within 1e-5 * max|ref| (no bit identity:
``segment_sum`` adds with atomics), the step count equal; five steps
alternating two batch shapes within 1e-4 of the eager losses; a NaN batch
dropped by the replay with the state unchanged; after the learning rate
halves, the next replay's loss within 1e-6 and its update's norm within
1e-3 of the eager step's; the captured eval within 1e-6 (loss) and 1e-5 *
max|ref| (predictions) of the eager one; a replay launches each of the
engine's device kernels once per TP call, counted in a profiler trace; a
capture that cannot be made raises.  The same captured step with gradient
checkpointing against the checkpointed eager step (loss 1e-6 relative,
gradients 1e-5 * max|ref| per tensor).

The SOC head at the ``sk_soc`` width (``examples/sk_soc/config.yaml``: 2
layers, ``...+4x4e+2x4o``), su2 and so3, under both engines: the kernel model
against the same model with the plain TP within 1e-4 * max|ref|, the real
part Hermitian and the imaginary part anti-Hermitian through the inverse edge
(su2), 9 forward launches; its captured step against the eager one at the
limits above.  The magnetic head (collinear, non-collinear, non-collinear
with SOC) at that width: its captured step against the eager one under
deterministic algorithms, at the same limits.  The Transformer (both
engines), ConvE3 with the correlation block and ConvE3 with KAN generators at
that width: the captured step equal to the eager one bit for bit under
deterministic algorithms.  Captured trainers made one after another leave the
memory held flat within 0.05 GB; a capture runs with the cyclic collector off,
on the device's one capture stream.
"""

import dataclasses

import numpy as np
import pytest
import torch

from hamgnn_tpu_torch.e3 import packed_tp, tp_kernel, zonal_kernel, zonal_tp
from hamgnn_tpu_torch.e3.irreps import Irreps
from hamgnn_tpu_torch.e3.packed_tp import get_plan, plain_apply, plain_backward
from hamgnn_tpu_torch.e3.spherical import spherical_harmonics
from hamgnn_tpu_torch.tools_dev import op_probe, op_probe2, probe, throughput_probe
from hamgnn_tpu_torch.train.captured import CapturedSteps, shape_key
from hamgnn_tpu_torch.utils.profiling import device_launches

PROBES = {**op_probe.PROBES, **op_probe2.PROBES, **throughput_probe.PROBES}

BENCH_FEAT = "64x0e+32x0o+24x1o+12x1e+12x2e+6x2o+4x3o+4x3e+2x4e"
BENCH_SH = "0e + 1o + 2e + 3o + 4e"
BENCH_IN = ["96x0e", repr(Irreps([(2 * m, ir) for m, ir in Irreps(BENCH_FEAT)])),
            BENCH_FEAT, "8x0e+4x0o+3x1o+2x1e+2x2e+1x2o+1x3o"]
WIDE = ("16x0e+4x1o+2x2e", "0e+1o+2e", "128x0e+2x1o+57x4e")
# d(flat_w) of the zonal backward (a sum over all edges): a sound 3xTF32 sum
# meets 1e-5 * max|plain|, one kept long in the tensor cores' truncating
# accumulator does not
DFLAT_TOL = 1e-5
# the bf16 instantiations against their plain bf16 versions, of max|plain|:
# the kernel's fp32 operands differ from the plain version's in the last bit
# (FFMA against multiply and add, the order of sums), and one next to a bf16
# rounding boundary rounds to the other neighbour: one bf16 ulp of one term
BF16_TOL = 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("irreps_in", BENCH_IN, ids=["pair", "node", "edge", "small"])
@pytest.mark.parametrize("with_w", [True, False])
def test_cuda_kernel_matches_plain(irreps_in, with_w):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    f = repr(Irreps(BENCH_FEAT))
    plan = get_plan(repr(Irreps(irreps_in)), repr(Irreps(BENCH_SH)), f, f)
    rng = np.random.default_rng(5)
    E = 333  # 20 full 16-edge tiles and a ragged one
    x, sh, w, fw = (torch.as_tensor(rng.normal(size=shape).astype(np.float32), device="cuda")
                    for shape in ((E, plan.irreps_in.dim), (E, plan.irreps_sh.dim),
                                  (E, plan.weight_numel), (plan.linear_numel,)))
    w = w if with_w else None
    before = tp_kernel.PACKED_TP_FWD.launches
    with torch.inference_mode():
        out = tp_kernel.packed_tp_forward(plan, x, sh, w, fw)
        ref = plain_apply(plan, x, sh, w, fw)
    torch.cuda.synchronize()
    assert tp_kernel.PACKED_TP_FWD.launches == before + 1
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("irreps_in", BENCH_IN, ids=["pair", "node", "edge", "small"])
@pytest.mark.parametrize("with_w", [True, False])
def test_cuda_backward_matches_plain(irreps_in, with_w):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    f = repr(Irreps(BENCH_FEAT))
    plan = get_plan(repr(Irreps(irreps_in)), repr(Irreps(BENCH_SH)), f, f)
    rng = np.random.default_rng(6)
    E = 333
    x, sh, w, fw, gy = (torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                                        device="cuda")
                        for shape in ((E, plan.irreps_in.dim), (E, plan.irreps_sh.dim),
                                      (E, plan.weight_numel), (plan.linear_numel,),
                                      (E, plan.irreps_out.dim)))
    w = w if with_w else None
    before = tp_kernel.PACKED_TP_BWD.launches
    got = tp_kernel.packed_tp_backward(plan, x, sh, w, fw, gy, need_dsh=True)
    again = tp_kernel.packed_tp_backward(plan, x, sh, w, fw, gy, need_dsh=True)
    ref = plain_backward(plan, x, sh, w, fw, gy, need_dsh=True)
    torch.cuda.synchronize()
    assert tp_kernel.PACKED_TP_BWD.launches == before + 2
    for name, a, b, c in zip(("dx", "dsh", "dw", "dflat_w"), got, again, ref):
        if c is None:
            assert a is None and b is None
            continue
        assert torch.equal(a, b), name
        assert float((a - c).abs().max()) <= 1e-4 * float(c.abs().max()), name




@pytest.mark.cuda
@pytest.mark.parametrize("with_w", [True, False])
def test_cuda_kernels_take_wide_outputs(with_w):
    """128x0e (V > 64) and 57x4e (72 (m3, n8) tiles) take several work
    items of B1 and of B2's weight pass."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    plan = get_plan(*(repr(Irreps(s_)) for s_ in (WIDE[0], WIDE[1], WIDE[2], WIDE[2])))
    spec = tp_kernel.get_spec(plan)
    assert len(spec.fitems) > len(spec.grp) and len(spec.witems) > len(spec.slabs)
    rng = np.random.default_rng(14)
    E = 333
    x, sh, w, fw, gy = (torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                                        device="cuda")
                        for shape in ((E, plan.irreps_in.dim), (E, plan.irreps_sh.dim),
                                      (E, plan.weight_numel), (plan.linear_numel,),
                                      (E, plan.irreps_out.dim)))
    w = w if with_w else None
    with torch.inference_mode():
        out = tp_kernel.packed_tp_forward(plan, x, sh, w, fw)
        ref = plain_apply(plan, x, sh, w, fw)
    got = tp_kernel.packed_tp_backward(plan, x, sh, w, fw, gy, need_dsh=True)
    refb = plain_backward(plan, x, sh, w, fw, gy, need_dsh=True)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    for name, a, c in zip(("dx", "dsh", "dw", "dflat_w"), got, refb):
        if c is None:
            assert a is None
            continue
        assert float((a - c).abs().max()) <= 1e-4 * float(c.abs().max()), name


@pytest.mark.cuda
@pytest.mark.parametrize("irreps_in", BENCH_IN[:3], ids=["pair", "node", "edge"])
def test_cuda_kernels_fit_their_blocks_per_sm(irreps_in):
    """At the bench plans two B1 blocks (512 threads) and two blocks of each
    B2 pass (256 threads) share an SM, by the kernels' own shared-memory
    sizes and the occupancy the runtime reports."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    f = repr(Irreps(BENCH_FEAT))
    spec = tp_kernel.get_spec(get_plan(repr(Irreps(irreps_in)), repr(Irreps(BENCH_SH)), f, f))
    fwd, bwd = tp_kernel.PACKED_TP_FWD.library(), tp_kernel.PACKED_TP_BWD.library()
    grp = spec.grp.ctypes.data
    smem = fwd.packed_tp_fwd_smem_bytes(grp, len(spec.grp), spec.S)
    assert fwd.packed_tp_fwd_resident_blocks(smem) >= 2, smem
    for pass_ in (0, 1):
        smem = bwd.packed_tp_bwd_smem_bytes(grp, len(spec.grp), spec.S, spec.sq_max,
                                            spec.nx_max, 0, pass_)
        assert bwd.packed_tp_bwd_resident_blocks(pass_, smem) >= 2, (pass_, smem)


@pytest.mark.cuda
def test_cuda_autograd_runs_both_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    f = repr(Irreps(BENCH_FEAT))
    plan = get_plan(repr(Irreps(BENCH_IN[3])), repr(Irreps(BENCH_SH)), f, f)
    rng = np.random.default_rng(7)
    E = 100
    x, sh, w, fw = (torch.as_tensor(rng.normal(size=shape).astype(np.float32), device="cuda")
                    for shape in ((E, plan.irreps_in.dim), (E, plan.irreps_sh.dim),
                                  (E, plan.weight_numel), (plan.linear_numel,)))
    x.requires_grad_(True)
    w.requires_grad_(True)
    fw.requires_grad_(True)
    counts = (tp_kernel.PACKED_TP_FWD.launches, tp_kernel.PACKED_TP_BWD.launches)
    out = plan(x, sh, w, fw)
    got = torch.autograd.grad(out.square().sum(), (x, w, fw))
    torch.cuda.synchronize()
    assert (tp_kernel.PACKED_TP_FWD.launches, tp_kernel.PACKED_TP_BWD.launches) == \
        (counts[0] + 1, counts[1] + 1)
    ref = plain_backward(plan, x, sh, w, fw, 2 * out.detach())
    for a, b in zip(got, (ref[0], ref[2], ref[3])):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def _zonal_inputs(irreps_in, with_w, seed, E=333):
    f = repr(Irreps(BENCH_FEAT))
    plan = get_plan(repr(Irreps(irreps_in)), repr(Irreps(BENCH_SH)), f, f)
    rng = np.random.default_rng(seed)
    x, w, fw, gy = (torch.as_tensor(rng.normal(size=shape).astype(np.float32), device="cuda")
                    for shape in ((E, plan.irreps_in.dim), (E, plan.weight_numel),
                                  (plan.linear_numel,), (E, plan.irreps_out.dim)))
    return plan, x, (w if with_w else None), fw, gy


@pytest.mark.cuda
@pytest.mark.parametrize("irreps_in", BENCH_IN, ids=["pair", "node", "edge", "small"])
@pytest.mark.parametrize("with_w", [True, False])
def test_cuda_zonal_kernel_matches_plain(irreps_in, with_w):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    plan, x, w, fw, _gy = _zonal_inputs(irreps_in, with_w, 8)
    before = tp_kernel.ZONAL_TP_FWD.launches
    with torch.inference_mode():
        out = zonal_kernel.zonal_core_forward(plan, x, w, fw)
        ref = zonal_tp.plain_zonal_core(plan, x, w, fw)
    torch.cuda.synchronize()
    assert tp_kernel.ZONAL_TP_FWD.launches == before + 1
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("irreps_in", BENCH_IN, ids=["pair", "node", "edge", "small"])
@pytest.mark.parametrize("with_w", [True, False])
def test_cuda_zonal_backward_matches_plain(irreps_in, with_w):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    plan, x, w, fw, gy = _zonal_inputs(irreps_in, with_w, 9)
    before = tp_kernel.ZONAL_TP_BWD.launches
    got = zonal_kernel.zonal_core_backward(plan, x, w, fw, gy)
    again = zonal_kernel.zonal_core_backward(plan, x, w, fw, gy)
    ref = zonal_tp.plain_zonal_core_backward(plan, x, w, fw, gy)
    torch.cuda.synchronize()
    assert tp_kernel.ZONAL_TP_BWD.launches == before + 2
    for name, a, b, c in zip(("dx_rot", "dw", "dflat_w"), got, again, ref):
        if c is None:
            assert a is None and b is None
            continue
        assert torch.equal(a, b), name
        tol = DFLAT_TOL if name == "dflat_w" else 1e-4
        assert float((a - c).abs().max()) <= tol * float(c.abs().max()), name


@pytest.mark.cuda
@pytest.mark.parametrize("with_w", [True, False])
def test_cuda_zonal_kernels_take_wide_outputs(with_w):
    """128x0e (V > 64: two B3 items, four weight-pass items per segment, a
    shorter stage) and 57x4e (several B3 items) through B3 and B4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    plan = get_plan(*(repr(Irreps(s_)) for s_ in (WIDE[0], WIDE[1], WIDE[2], WIDE[2])))
    spec = zonal_kernel.get_zonal_kernel_spec(plan)
    assert len(spec.fitems) > len(spec.zgrp) and spec.v_max > 64
    rng = np.random.default_rng(15)
    E = 333
    x, w, fw, gy = (torch.as_tensor(rng.normal(size=shape).astype(np.float32), device="cuda")
                    for shape in ((E, plan.irreps_in.dim), (E, plan.weight_numel),
                                  (plan.linear_numel,), (E, plan.irreps_out.dim)))
    w = w if with_w else None
    with torch.inference_mode():
        out = zonal_kernel.zonal_core_forward(plan, x, w, fw)
        ref = zonal_tp.plain_zonal_core(plan, x, w, fw)
    got = zonal_kernel.zonal_core_backward(plan, x, w, fw, gy)
    again = zonal_kernel.zonal_core_backward(plan, x, w, fw, gy)
    refb = zonal_tp.plain_zonal_core_backward(plan, x, w, fw, gy)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    for name, a, b, c in zip(("dx_rot", "dw", "dflat_w"), got, again, refb):
        if c is None:
            assert a is None
            continue
        assert torch.equal(a, b), name
        tol = DFLAT_TOL if name == "dflat_w" else 1e-4
        assert float((a - c).abs().max()) <= tol * float(c.abs().max()), name


@pytest.mark.cuda
@pytest.mark.parametrize("irreps_in", BENCH_IN[:3], ids=["pair", "node", "edge"])
def test_cuda_zonal_kernels_fit_two_blocks_per_sm(irreps_in):
    """At the bench plans two blocks of B3 and of each B4 pass (256 threads)
    share an SM, by the kernels' own shared-memory sizes and the occupancy
    the runtime reports."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    f = repr(Irreps(BENCH_FEAT))
    spec = zonal_kernel.get_zonal_kernel_spec(
        get_plan(repr(Irreps(irreps_in)), repr(Irreps(BENCH_SH)), f, f))
    fwd, bwd = tp_kernel.ZONAL_TP_FWD.library(), tp_kernel.ZONAL_TP_BWD.library()
    smem = fwd.zonal_tp_fwd_smem_bytes(spec.d_in, spec.fan_max)
    assert fwd.zonal_tp_fwd_resident_blocks(smem) >= 2, smem
    for pass_ in (0, 1):
        smem = bwd.zonal_tp_bwd_smem_bytes(spec.d_in, spec.gmax, spec.tgrp_words, pass_)
        assert bwd.zonal_tp_bwd_resident_blocks(pass_, smem) >= 2, (pass_, smem)


@pytest.mark.cuda
def test_cuda_zonal_engine_runs_both_kernels(monkeypatch):
    """``HAMGNN_TP_ENGINE=zonal`` on CUDA tensors: B3 in the forward, B4 in
    the backward, none of the lab-frame kernels; outputs and gradients
    within the engine limit of the lab-frame plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv("HAMGNN_TP_ENGINE", "zonal")
    plan, x, w, fw, _gy = _zonal_inputs(BENCH_IN[3], True, 10, E=100)
    rng = np.random.default_rng(11)
    vec = rng.normal(size=(100, 3)).astype(np.float32)
    vec[:3] = [[0, 0, 1], [0, 0, -1], [1e-7, -1e-7, -1]]
    sh = spherical_harmonics([0, 1, 2, 3, 4], torch.as_tensor(vec, device="cuda"),
                             normalize=True)
    for t in (x, w, fw):
        t.requires_grad_(True)
    counts = {n: k.launches for n, k in tp_kernel.KERNELS.items()}
    out = plan(x, sh, w, fw)
    got = torch.autograd.grad(out.square().sum(), (x, w, fw))
    torch.cuda.synchronize()
    counts["zonal_tp_fwd"] += 1
    counts["zonal_tp_bwd"] += 1
    assert {n: k.launches for n, k in tp_kernel.KERNELS.items()} == counts
    ref_out = plain_apply(plan, x.detach(), sh, w.detach(), fw.detach())
    assert float((out.detach() - ref_out).abs().max()) <= 2e-5 * float(ref_out.abs().max())
    ref = plain_backward(plan, x, sh, w, fw, 2 * out.detach())
    for a, b in zip(got, (ref[0], ref[2], ref[3])):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def _all_counts():
    return {n: k.launches for n, k in {**tp_kernel.KERNELS, **tp_kernel.VARIANTS}.items()}


def _lab_inputs(irreps_in, seed, E=333):
    f = repr(Irreps(BENCH_FEAT))
    plan = get_plan(repr(Irreps(irreps_in)), repr(Irreps(BENCH_SH)), f, f)
    rng = np.random.default_rng(seed)
    return plan, [torch.as_tensor(rng.normal(size=shape).astype(np.float32), device="cuda")
                  for shape in ((E, plan.irreps_in.dim), (E, plan.irreps_sh.dim),
                                (E, plan.weight_numel), (plan.linear_numel,),
                                (E, plan.irreps_out.dim))]


def _bf16_close(name, got, ref, fp32):
    """A bf16 instantiation against its plain bf16 version: within
    BF16_TOL * max|plain|, and at least ten times farther from the fp32
    kernel's result (the mode really rounds)."""
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    assert err <= BF16_TOL * scale, (name, err, scale)
    assert float((got - fp32).abs().max()) >= 10 * err, name


@pytest.mark.cuda
@pytest.mark.parametrize("irreps_in", BENCH_IN, ids=["pair", "node", "edge", "small"])
def test_cuda_bf16_lab_kernels_match_plain(irreps_in):
    """B1 and B2 in bf16 against ``plain_apply`` / ``plain_backward`` with
    ``bf16``, counted on their own variants; B2 repeats bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    plan, (x, sh, w, fw, gy) = _lab_inputs(irreps_in, 16)
    before = _all_counts()
    with torch.inference_mode():
        out = tp_kernel.packed_tp_forward(plan, x, sh, w, fw, "all")
        out32 = tp_kernel.packed_tp_forward(plan, x, sh, w, fw)
        ref = plain_apply(plan, x, sh, w, fw, bf16=True)
    got = tp_kernel.packed_tp_backward(plan, x, sh, w, fw, gy, True, bf16=True)
    again = tp_kernel.packed_tp_backward(plan, x, sh, w, fw, gy, True, bf16=True)
    got32 = tp_kernel.packed_tp_backward(plan, x, sh, w, fw, gy, True)
    refb = plain_backward(plan, x, sh, w, fw, gy, True, bf16=True)
    torch.cuda.synchronize()
    want = dict(before)
    for n, k in (("packed_tp_fwd_bf16", 1), ("packed_tp_fwd", 1), ("packed_tp_bwd_bf16", 2),
                 ("packed_tp_bwd", 1)):
        want[n] += k
    assert _all_counts() == want
    _bf16_close("out", out, ref, out32)
    for name, a, b, c, d in zip(("dx", "dsh", "dw", "dflat_w"), got, again, refb, got32):
        assert torch.equal(a, b), name
        _bf16_close(name, a, c, d)


@pytest.mark.cuda
@pytest.mark.parametrize("irreps_in", BENCH_IN, ids=["pair", "node", "edge", "small"])
def test_cuda_bf16_zonal_kernels_match_plain(irreps_in):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    plan, x, w, fw, gy = _zonal_inputs(irreps_in, True, 17)
    before = _all_counts()
    with torch.inference_mode():
        out = zonal_kernel.zonal_core_forward(plan, x, w, fw, "all")
        out32 = zonal_kernel.zonal_core_forward(plan, x, w, fw)
        ref = zonal_tp.plain_zonal_core(plan, x, w, fw, True)
    got = zonal_kernel.zonal_core_backward(plan, x, w, fw, gy, bf16=True)
    again = zonal_kernel.zonal_core_backward(plan, x, w, fw, gy, bf16=True)
    got32 = zonal_kernel.zonal_core_backward(plan, x, w, fw, gy)
    refb = zonal_tp.plain_zonal_core_backward(plan, x, w, fw, gy, True)
    torch.cuda.synchronize()
    want = dict(before)
    for n, k in (("zonal_tp_fwd_bf16", 1), ("zonal_tp_fwd", 1), ("zonal_tp_bwd_bf16", 2),
                 ("zonal_tp_bwd", 1)):
        want[n] += k
    assert _all_counts() == want
    _bf16_close("out_rot", out, ref, out32)
    for name, a, b, c, d in zip(("dx_rot", "dw", "dflat_w"), got, again, refb, got32):
        assert torch.equal(a, b), name
        _bf16_close(name, a, c, d)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("irreps_in", BENCH_IN, ids=["pair", "node", "edge", "small"])
def test_cuda_stored_mids_are_bit_identical(irreps_in, bf16):
    """B1 writing its mids gives the same output, and B2 reading them the
    same gradients, bit for bit, as the recompute path; the mids are
    ``packed_tp.chunk_mids`` within 1e-5 * max|ref| (FFMA against the plain
    version's multiply and add)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    plan, (x, sh, w, fw, gy) = _lab_inputs(irreps_in, 18)
    before = _all_counts()
    out_s, mids = tp_kernel.packed_tp_store_forward(plan, x, sh, w, fw, bf16)
    with torch.inference_mode():
        out = tp_kernel.packed_tp_forward(plan, x, sh, w, fw, "all" if bf16 else "")
    for need_dsh in (False, True):
        stored = tp_kernel.packed_tp_backward(plan, x, sh, w, fw, gy, need_dsh, bf16, mids)
        again = tp_kernel.packed_tp_backward(plan, x, sh, w, fw, gy, need_dsh, bf16)
        for a, b in zip(stored, again):
            assert (a is None and b is None) or torch.equal(a, b)
    torch.cuda.synchronize()
    assert torch.equal(out_s, out)
    tag = "_bf16" if bf16 else ""
    want = dict(before)
    for n, k in (("packed_tp_fwd_storemid", 1), (f"packed_tp_fwd{tag}", 1),
                 ("packed_tp_bwd_storemid", 2), (f"packed_tp_bwd{tag}", 2)):
        want[n] += k
    assert _all_counts() == want
    ref = packed_tp.chunk_mids(plan, x, packed_tp.coupling(plan, sh, bf16))
    for m, r in zip(packed_tp.split_mids(plan, mids), ref):
        if r is not None:
            assert float((m - r).abs().max()) <= 1e-5 * float(r.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("mode,store", [("bwd", False), ("all", False), ("", True), ("all", True)])
def test_cuda_autograd_takes_the_switches(monkeypatch, mode, store):
    """Through ``PackedTPPlan.__call__``: the switches pick the variants B1
    and B2 launch, and the gradients are the wrappers' under those modes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv("HAMGNN_TP_BF16", mode)
    monkeypatch.setenv("HAMGNN_TP_STOREMID", "1" if store else "")
    plan, (x, sh, w, fw, gy) = _lab_inputs(BENCH_IN[3], 19, E=100)
    for t in (x, w, fw):
        t.requires_grad_(True)
    before = _all_counts()
    out = plan(x, sh, w, fw)
    got = torch.autograd.grad(out, (x, w, fw), gy)
    torch.cuda.synchronize()
    fwd = "packed_tp_fwd_storemid" if store else (
        "packed_tp_fwd_bf16" if mode == "all" else "packed_tp_fwd")
    bwd = "packed_tp_bwd_storemid" if store else (
        "packed_tp_bwd_bf16" if mode else "packed_tp_bwd")
    want = dict(before)
    want[fwd] += 1
    want[bwd] += 1
    assert _all_counts() == want
    with torch.inference_mode():
        ref_out = tp_kernel.packed_tp_forward(plan, x, sh, w, fw, mode)
    ref = tp_kernel.packed_tp_backward(plan, x.detach(), sh, w.detach(), fw.detach(), gy, False,
                                       mode in ("bwd", "all"))
    assert torch.equal(out.detach(), ref_out)
    for a, b in zip(got, (ref[0], ref[2], ref[3])):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PROBES))
def test_cuda_probe_matches_plain(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = PROBES[name]
    rows = 256 if p.source == "probe_throughput" else None
    tensors = p.inputs(np.random.default_rng(12), "cuda", rows)
    before = p.kernel.launches
    row = probe.check(p, tensors)
    assert p.kernel.launches == before + 1
    assert row["ok"], row
    if name == "k_acc":
        assert torch.equal(row["out"], p(*tensors))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted({**op_probe.PROBES, **op_probe2.PROBES}))
def test_cuda_op_probe_matches_plain_at_every_size(name):
    """P1/P2 at 128 rows (k_acc 512), at the bench rows and at the odd count,
    whose grids end in part-filled blocks; k_acc repeats bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = PROBES[name]
    rng = np.random.default_rng(14)
    for rows in p.checked_rows:
        tensors = p.inputs(rng, "cuda", rows)
        row = probe.check(p, tensors)
        assert row["ok"], (rows, row)
        if name == "k_acc":
            assert torch.equal(row["out"], p(*tensors)), rows
        if name in ("k_dot", "k_slice_dot", "k_dot_odd") and rows == p.bench_rows:
            # a few rows take one output a thread, bench rows 2 x 8 a thread:
            # the same sums in the same order
            few = [tensors[0][:p.rows].contiguous(), *tensors[1:]]
            assert torch.equal(p(*few), row["out"][:p.rows])
    if p.odd_rows:
        _check_guard_rows(p, rng)


def _check_guard_rows(p, rng):
    """No kernel uses inputs or writes outputs past its rows: a row-wise
    kernel on the first rows of larger buffers, NaN after the input rows,
    gives the plain result and leaves the guard after its output alone."""
    n = p.odd_rows
    tensors = []
    for t, grown in zip(p.inputs(rng, "cuda", n), p.shapes(n + 64)):
        if grown[0] == n + 64:  # a row input, not a weight
            buf = torch.full(grown, float("nan"), device="cuda")
            buf[:n] = t
            t = buf[:n]
        tensors.append(t)
    out = torch.full((n + 64, p.out_shape(1)[1]), 7.0, device="cuda")
    scratch = [] if p.scratch is None else [
        torch.full(p.scratch(n), float("nan"), device="cuda")]
    want = p.plain(*tensors)
    got = out[:n]
    p.kernel.launch(*(t.data_ptr() for t in tensors), got.data_ptr(),
                    *(t.data_ptr() for t in scratch), n,
                    torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= p.tol * float(want.abs().max())
    assert bool((out[n:] == 7.0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["p1", "p3", "p6", "p7", "p7_tf32"])
def test_cuda_throughput_product_matches_plain_at_every_size(name):
    """p1, p3, p6, p7 and p7_tf32 at E = 19,968 and at 17 tiles of 64 rows, which
    no split of their work divides evenly (p7's last tile of 128 rows is half
    past E, p7_tf32's shares of 8 or 9 rows end inside an m16 tile); each
    repeats bit for bit; rows past E are neither read nor written."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = PROBES[name]
    rng = np.random.default_rng(15)
    for rows in p.checked_rows:
        tensors = p.inputs(rng, "cuda", rows)
        row = probe.check(p, tensors)
        assert row["ok"], (rows, row)
        # p7 adds its blocks' sums in a second kernel, p1's, p3's and p6's warps
        # share buffers from item to item, p7_tf32's stages are reused
        # through mbarriers: each repeats bit for bit
        for _ in range(3):
            assert torch.equal(row["out"], p(*tensors)), rows
    _check_guard_rows(p, rng)


@pytest.mark.cuda
def test_cuda_throughput_products_fit_their_blocks_per_sm():
    """p1, p3 and p6 run two persistent blocks an SM, p7 three, so that its 396
    runs are all in flight at once on the H100's 132 SMs, and p7_tf32 one,
    its ring taking most of the shared memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lib = PROBES["p6"].kernel.library()
    assert lib.probe_p1_resident_per_sm() >= 2
    assert lib.probe_p3_resident_per_sm() >= 2
    assert lib.probe_p6_resident_per_sm() >= 2
    assert lib.probe_p7_resident_per_sm() >= 3
    assert lib.probe_p7_tf32_resident_per_sm() >= 1


@pytest.mark.cuda
def test_cuda_p7_tf32_takes_shares_of_two_passes():
    """At 26,432 rows a block's share is 200 or 201 rows, more than one pass
    of 160: two passes of chunks through the same ring, the second of 40 or
    41 rows in a box of 160 (the rows past the share are read, not
    written); bit for bit on a repeat."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = PROBES["p7_tf32"]
    a, b = p.inputs(np.random.default_rng(17), "cuda", 26_432)
    row = probe.check(p, (a, b))
    assert row["ok"], row
    assert torch.equal(row["out"], p(a, b))


@pytest.mark.cuda
def test_cuda_p7_tf32_library_is_a_tf32_product():
    """p7_tf32's yardstick is cuBLAS's TF32 product: within p7_tf32's 2e-3
    of the plain product, not the full fp32 product, and the process's own
    setting (full fp32) is the same after it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = PROBES["p7_tf32"]
    a, b = p.inputs(np.random.default_rng(16), "cuda", 1088)
    ref = a @ b
    got = p.library(a, b)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= p.tol * float(ref.abs().max())
    assert not torch.equal(got, ref)
    assert torch.equal(a @ b, ref)


@pytest.mark.cuda
def test_cuda_throughput_p7_scratch_is_the_librarys():
    """p7's scratch as ``throughput_probe.p7_scratch`` sizes it equals the
    library's count from its own constants, at sizes below, at and above
    P7_BLOCKS chunks: a split changed in the .cu file alone fails here, not
    by writing past the scratch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tp = throughput_probe
    for rows in (64, 128, 256, 1088, 19_968, 65_536):
        assert tp.p7_scratch(rows)[0] == tp.p7_scratch_of_library(rows), rows


@pytest.mark.cuda
def test_cuda_probe_wrapper_refuses_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(13)
    p = PROBES["p7"]
    a, b = p.inputs(rng, "cuda", 64)
    before = p.kernel.launches
    with pytest.raises(ValueError, match="multiple of 64"):
        p(a[:32].contiguous(), b)
    with pytest.raises(ValueError, match="shapes"):
        p(a, b[:, :32].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        p(a.double(), b.double())
    with pytest.raises(ValueError, match="at most 128"):
        PROBES["k_dot_t"](*PROBES["k_dot_t"].inputs(rng, "cuda", 256))
    assert p.kernel.launches == before
    # the P1/P2 kernels read and write 16 bytes at a time
    q = PROBES["k_merge64"]
    (x,) = q.inputs(rng, "cuda", 9)
    before = q.kernel.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        q(x.view(-1)[1:1 + 8 * 1024].view(8, 1024))
    assert q.kernel.launches == before


# ---- the captured training and eval steps ----------------------------------

SMALL_CFG = {
    "representation_nets": {"HamGNN_pre": {
        "irreps_node_features": "16x0e+8x1o+4x2e+2x3o", "irreps_edge_sh": BENCH_SH,
        "num_layers": 2, "num_radial": 16, "cutoff": 5.0, "radial_MLP": [16],
        "num_types": 16}},
    "output_nets": {"HamGNN_out": {"nao_max": 14}},
}
HAM = [{"metric": "mae", "prediction": "hamiltonian", "target": "hamiltonian",
        "loss_weight": 27.211}]
ENGINE_KERNELS = {"auto": ("packed_tp_fwd", "packed_tp_bwd"),
                  "zonal": ("zonal_tp_fwd", "zonal_tp_bwd")}


def _step_batches():
    """Two batches of two shapes on the card: 2 crystals of 8 atoms, 2 of 12."""
    from hamgnn_tpu_torch.data.graph import pad_and_batch
    from hamgnn_tpu_torch.data.synthetic import add_random_hamiltonian_targets, make_crystal

    rng = np.random.default_rng(21)
    out = []
    for n_atoms in (8, 12):
        cr = [add_random_hamiltonian_targets(
            rng, make_crystal(rng, n_atoms=n_atoms, cell_size=6.0, cutoff=5.0), nao_max=14)
            for _ in range(2)]
        e = sum(c["edge_index"].shape[1] for c in cr)
        out.append(pad_and_batch(cr, node_bucket=32, edge_bucket=-(-e // 256) * 256,
                                 device="cuda"))
    assert shape_key(out[0]) != shape_key(out[1])
    return out


def _step_trainers(tmp_path):
    """An eager and a capturing trainer on the same weights."""
    from hamgnn_tpu_torch.cli import build_model
    from hamgnn_tpu_torch.models.model import init_weights
    from hamgnn_tpu_torch.train.config import load_config
    from hamgnn_tpu_torch.train.trainer import Trainer

    return [Trainer(init_weights(build_model(load_config(None, overrides=SMALL_CFG)), 0),
                    losses=HAM, metrics=HAM, lr=1e-3, train_dir=str(tmp_path / str(capture)),
                    device="cuda", capture=capture) for capture in (False, True)]


def _state(tr):
    return [tr.flat, *tr.opt.state_dict().values()]


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["auto", "zonal"])
def test_cuda_captured_step_matches_eager(tmp_path, monkeypatch, engine):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if engine != "auto":
        monkeypatch.setenv("HAMGNN_TP_ENGINE", engine)
    g1, g2 = _step_batches()
    eager, cap = _step_trainers(tmp_path)
    assert eager.captured is None and cap.captured is not None
    la, _ = eager.train_step(g1)
    lb, logs = cap.train_step(g1)
    torch.cuda.synchronize()
    assert abs(float(lb) - float(la)) <= 1e-6 * abs(float(la))
    assert float(logs["nonfinite_step"]) == 0.0
    ofs = 0
    for name, p in eager.model.named_parameters():
        a, b = eager.grad[ofs:ofs + p.numel()], cap.grad[ofs:ofs + p.numel()]
        ofs += p.numel()
        assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max()), name
    assert int(eager.opt.count) == int(cap.opt.count) == 1

    # five steps alternating two shapes: one graph per shape key
    for g in (g2, g1, g2, g1, g2):
        la, lb = float(eager.train_step(g)[0]), float(cap.train_step(g)[0])
        assert abs(lb - la) <= 1e-4 * abs(la)
    assert cap.captured.captures == 2
    assert set(cap.captured.train_graphs) == {shape_key(g1), shape_key(g2)}

    # the eval step from the same state
    with torch.no_grad():
        for a, b in zip(_state(eager), _state(cap)):
            a.copy_(b)
    for g in (g1, g2):
        ta, _la, ma, pa = eager.eval_step(g)
        tb, _lb, mb, pb = cap.eval_step(g)
        assert abs(float(tb) - float(ta)) <= 1e-6 * abs(float(ta))
        assert set(ma) == set(mb) and set(pa) == set(pb)
        for key in ("hamiltonian_on", "hamiltonian_off"):
            assert float((pa[key] - pb[key]).abs().max()) <= 1e-5 * float(pa[key].abs().max())
    assert cap.captured.captures == 4

    # a NaN batch: the replay drops the step and leaves the state as it was
    before = [t.clone() for t in _state(cap)]
    bad = dataclasses.replace(g1, Hon=torch.full_like(g1.Hon, float("nan")))
    loss, logs = cap.train_step(bad)
    assert not bool(torch.isfinite(loss)) and float(logs["nonfinite_step"]) == 1.0
    for a, b in zip(_state(cap), before):
        assert torch.equal(a, b)

    # the learning rate halves: the next replay steps at the new rate
    with torch.no_grad():
        for a, b in zip(_state(eager), _state(cap)):
            a.copy_(b)
    for tr in (eager, cap):
        tr.sched.lr = tr.sched.lr / 2
    start = cap.flat.clone()
    la, lb = float(eager.train_step(g1)[0]), float(cap.train_step(g1)[0])
    assert abs(lb - la) <= 1e-6 * abs(la)
    assert float(cap.lr_t) == np.float32(5e-4)
    ua, ub = eager.flat - start, cap.flat - start
    assert abs(float(ub.norm() / ua.norm()) - 1.0) <= 1e-3
    assert int(eager.opt.count) == int(cap.opt.count)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["auto", "zonal"])
def test_cuda_replay_launches_each_kernel_once_per_call(tmp_path, monkeypatch, engine):
    """A replay runs the captured launches: each device kernel of the
    engine once per TP call (4 * 2 layers + 1), counted by name in a
    profiler trace; the host-side counters do not move."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if engine != "auto":
        monkeypatch.setenv("HAMGNN_TP_ENGINE", engine)
    g1, _g2 = _step_batches()
    _eager, cap = _step_trainers(tmp_path)
    cap.train_step(g1)
    names = [n for k in ENGINE_KERNELS[engine] for n in tp_kernel.KERNELS[k].device_kernels]
    host = {n: k.launches for n, k in tp_kernel.KERNELS.items()}
    got = device_launches(lambda: cap.train_step(g1), names)
    assert got == {n: 9 for n in names}
    assert {n: k.launches for n, k in tp_kernel.KERNELS.items()} == host
    fwd = tp_kernel.KERNELS[ENGINE_KERNELS[engine][0]].device_kernels
    cap.eval_step(g1)
    assert device_launches(lambda: cap.eval_step(g1), names) == {
        n: 9 if n in fwd else 0 for n in names}


@pytest.mark.cuda
def test_cuda_capture_that_fails_raises():
    """A step that reads a device value on the host cannot be captured: the
    capture raises, with no eager step in its place."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g1, _g2 = _step_batches()
    flat = torch.zeros(4, device="cuda")
    ran = []

    def body(g):
        ran.append(1)
        return flat.add_(float(g.pos.sum())), {}

    steps = CapturedSteps("cuda", body, body, lambda: (flat,))
    with pytest.raises(RuntimeError):
        steps.train_step(g1)
    torch.cuda.synchronize()
    assert steps.captures == 0 and not steps.train_graphs and len(ran) == 2
    assert float(flat.abs().max()) == 0.0  # the warm-up's update was put back


@pytest.mark.cuda
def test_cuda_capture_runs_without_the_collector_on_one_stream():
    """The cyclic collector is off while a step is captured and on again
    after it (also after a capture that fails); every capture on the card
    uses the one capture stream of the device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import gc

    g1, _g2 = _step_batches()
    flat = torch.zeros(4, device="cuda")
    seen = []

    def body(g):
        seen.append(gc.isenabled())
        return flat.add_(g.pos.sum()), {}

    steps = CapturedSteps("cuda", body, body, lambda: (flat,))
    steps.train_step(g1)
    assert seen == [True, False] and gc.isenabled()

    def failing(g):
        return flat.add_(float(g.pos.sum())), {}

    other = CapturedSteps("cuda", failing, failing, lambda: (flat,))
    with pytest.raises(RuntimeError):
        other.train_step(g1)
    assert gc.isenabled() and other.stream is steps.stream


def _trainer_pair(tmp_path, cfg, losses):
    """An eager and a capturing trainer on the same weights of ``cfg``'s model."""
    from hamgnn_tpu_torch.cli import build_model
    from hamgnn_tpu_torch.models.model import init_weights
    from hamgnn_tpu_torch.train.config import load_config
    from hamgnn_tpu_torch.train.trainer import Trainer

    return [Trainer(init_weights(build_model(load_config(None, overrides=cfg)), 0),
                    losses=losses, metrics=losses, lr=1e-3,
                    train_dir=str(tmp_path / str(capture)), device="cuda", capture=capture)
            for capture in (False, True)]


def _first_steps_agree(eager, cap, g):
    """One step of each trainer from the same weights: loss within 1e-6
    relative, gradient per parameter tensor within 1e-5 * max|ref|."""
    la, _ = eager.train_step(g)
    lb, logs = cap.train_step(g)
    torch.cuda.synchronize()
    assert abs(float(lb) - float(la)) <= 1e-6 * abs(float(la))
    assert float(logs["nonfinite_step"]) == 0.0
    ofs = 0
    for name, p in eager.model.named_parameters():
        a, b = eager.grad[ofs:ofs + p.numel()], cap.grad[ofs:ofs + p.numel()]
        ofs += p.numel()
        assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max()), name
    assert cap.captured.captures == 1


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["auto", "zonal"])
def test_cuda_captured_checkpointed_step_matches_eager(tmp_path, monkeypatch, engine):
    """With ``use_gradient_checkpointing`` (``checkpoint(...,
    preserve_rng_state=False)``: nothing reads or sets the RNG state inside
    the capture) the captured step equals the checkpointed eager step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if engine != "auto":
        monkeypatch.setenv("HAMGNN_TP_ENGINE", engine)
    cfg = dict(SMALL_CFG, setup={"use_gradient_checkpointing": True})
    g1, g2 = _step_batches()
    eager, cap = _trainer_pair(tmp_path, cfg, HAM)
    assert eager.model.representation.use_gradient_checkpointing
    _first_steps_agree(eager, cap, g1)
    for g in (g2, g1):
        la, lb = float(eager.train_step(g)[0]), float(cap.train_step(g)[0])
        assert abs(lb - la) <= 1e-4 * abs(la)


SK_SOC_CFG = {
    "representation_nets": {"HamGNN_pre": {
        "irreps_node_features": "64x0e+16x0o+24x1o+12x1e+16x2e+8x2o+8x3o+6x3e+4x4e+2x4o",
        "irreps_edge_sh": BENCH_SH, "num_layers": 2, "num_radial": 64, "cutoff": 5.0,
        "radial_MLP": [64, 64], "num_types": 96}},
    "output_nets": {"HamGNN_out": {"nao_max": 14, "soc_switch": True, "soc_basis": "so3",
                                   "zero_point_shift": False}},
}
SOC_HAM = [{"metric": "mae", "prediction": p, "target": p, "loss_weight": 27.211}
           for p in ("hamiltonian_real", "hamiltonian_imag")]


def _soc_batch():
    """2 SOC crystals of 8 atoms on the card."""
    from hamgnn_tpu_torch.data.graph import pad_and_batch
    from hamgnn_tpu_torch.data.synthetic import (add_random_hamiltonian_targets,
                                                 add_random_soc_targets, make_crystal)

    rng = np.random.default_rng(23)
    cr = [add_random_soc_targets(rng, add_random_hamiltonian_targets(
        rng, make_crystal(rng, n_atoms=8, cell_size=6.0, cutoff=5.0), nao_max=14))
        for _ in range(2)]
    e = sum(c["edge_index"].shape[1] for c in cr)
    return pad_and_batch(cr, node_bucket=16, edge_bucket=-(-e // 256) * 256, device="cuda")


def _soc_cfg(basis):
    cfg = {k: dict(v) for k, v in SK_SOC_CFG.items()}
    cfg["output_nets"] = {"HamGNN_out": dict(SK_SOC_CFG["output_nets"]["HamGNN_out"],
                                             soc_basis=basis)}
    return cfg


@pytest.mark.cuda
@pytest.mark.parametrize("basis", ["su2", "so3"])
@pytest.mark.parametrize("engine", ["auto", "zonal"])
def test_cuda_soc_forward_at_sk_soc_width(monkeypatch, engine, basis):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from hamgnn_tpu_torch.cli import build_model
    from hamgnn_tpu_torch.models.model import init_weights
    from hamgnn_tpu_torch.train.config import load_config

    g = _soc_batch()
    model = init_weights(build_model(load_config(None, overrides=_soc_cfg(basis))), 0)
    model = model.to("cuda").eval()
    fwd = tp_kernel.KERNELS[ENGINE_KERNELS[engine][0]]
    with torch.inference_mode():
        monkeypatch.setenv("HAMGNN_TP_ENGINE", "xla")
        ref = model(g)
        monkeypatch.setenv("HAMGNN_TP_ENGINE", engine)
        before = {n: k.launches for n, k in tp_kernel.KERNELS.items()}
        out = model(g)
        torch.cuda.synchronize()
    launched = {n: k.launches - before[n] for n, k in tp_kernel.KERNELS.items()}
    assert launched == {n: 9 if k is fwd else 0 for n, k in tp_kernel.KERNELS.items()}
    for key in ("hamiltonian_real_on", "hamiltonian_real_off", "hamiltonian_imag_on",
                "hamiltonian_imag_off"):
        assert bool(torch.isfinite(out[key]).all()), key
        scale = float(ref[key].abs().max())
        assert float((out[key] - ref[key]).abs().max()) <= 1e-4 * scale, key
    if basis == "su2":
        big = 28
        inv, mask = g.inv_edge_idx, g.edge_mask
        for part, sign in (("real", 1.0), ("imag", -1.0)):
            h = out[f"hamiltonian_{part}_off"].reshape(-1, big, big)
            h0 = getattr(g, "Hoff0" if part == "real" else "iHoff0").reshape(-1, big, big)
            d = (h - h0)[mask] - sign * (h - h0)[inv][mask].mT
            assert float(d.abs().max()) <= 1e-6 * float(ref[f"hamiltonian_{part}_off"].abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("basis", ["su2", "so3"])
def test_cuda_soc_captured_step_matches_eager(tmp_path, basis):
    """The SOC step on the real and imaginary MAE at the sk_soc width,
    replayed from a CUDA graph, against the eager step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = _soc_batch()
    eager, cap = _trainer_pair(tmp_path, _soc_cfg(basis), SOC_HAM)
    _first_steps_agree(eager, cap, g)
    with torch.no_grad():
        for a, b in zip(_state(eager), _state(cap)):
            a.copy_(b)
    ta, _l, _m, pa = eager.eval_step(g)
    tb, _l, _m, pb = cap.eval_step(g)
    assert abs(float(tb) - float(ta)) <= 1e-6 * abs(float(ta))
    for key in ("hamiltonian_real_off", "hamiltonian_imag_off"):
        assert float((pa[key] - pb[key]).abs().max()) <= 1e-5 * float(pa[key].abs().max())


SPIN_MODES = {"collinear": {"collinear_spin": True, "soc_switch": False},
              "noncollinear": {"collinear_spin": False, "soc_switch": False},
              "spinsoc": {"collinear_spin": False, "soc_switch": True}}


def _spin_batch(mode):
    """2 crystals of 8 atoms with the magnetic head's fields, on the card."""
    from hamgnn_tpu_torch.data.graph import pad_and_batch
    from hamgnn_tpu_torch.data.synthetic import (add_random_hamiltonian_targets,
                                                 add_random_spin_targets, make_crystal)

    rng = np.random.default_rng(25)
    cr = [add_random_spin_targets(rng, add_random_hamiltonian_targets(
        rng, make_crystal(rng, n_atoms=8, cell_size=6.0, cutoff=5.0), nao_max=14), mode)
        for _ in range(2)]
    e = sum(c["edge_index"].shape[1] for c in cr)
    return pad_and_batch(cr, node_bucket=16, edge_bucket=-(-e // 256) * 256, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(SPIN_MODES))
def test_cuda_magnetic_captured_step_matches_eager(tmp_path, mode):
    """The magnetic head at the sk_collinear / sk_ncl / sk_spinsoc width (2
    layers here), its training step replayed from a CUDA graph against the
    eager step under deterministic algorithms, then the eval step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = {k: dict(v) for k, v in SK_SOC_CFG.items()}
    cfg["output_nets"] = {"HamGNN_out": {"nao_max": 14, "spin_constrained": True,
                                         "use_learned_weight": False, **SPIN_MODES[mode]}}
    losses = HAM if mode == "collinear" else SOC_HAM
    g = _spin_batch(mode)
    eager, cap = _trainer_pair(tmp_path, cfg, losses)
    torch.use_deterministic_algorithms(True)
    try:
        _first_steps_agree(eager, cap, g)
    finally:
        torch.use_deterministic_algorithms(False)
    with torch.no_grad():
        for a, b in zip(_state(eager), _state(cap)):
            a.copy_(b)
    ta, _l, _m, pa = eager.eval_step(g)
    tb, _l, _m, pb = cap.eval_step(g)
    assert abs(float(tb) - float(ta)) <= 1e-6 * abs(float(ta))
    keys = ("hamiltonian_off",) if mode == "collinear" else ("hamiltonian_real_off",
                                                             "hamiltonian_imag_off")
    for key in keys:
        assert float((pa[key] - pb[key]).abs().max()) <= 1e-5 * float(pa[key].abs().max())


# the other representation networks at the sk width (2 layers here): (a) the
# Transformer, (b) ConvE3 with the correlation block, (c) ConvE3 with KAN
SK_REP = {"irreps_node_features": SK_SOC_CFG["representation_nets"]["HamGNN_pre"][
    "irreps_node_features"]}
REPS = {"transformer": ({"GNN_Net": "HamGNNTransformer"},
                        {"num_heads": 2, "correlation": 2, "num_hidden_features": 16}),
        "corr": ({}, {"use_corr_prod": True, "correlation": 2, "num_hidden_features": 16}),
        "kan": ({}, {"use_kan": True})}


def _rep_cfg(rep):
    setup, pre = REPS[rep]
    return {"setup": dict(setup),
            "representation_nets": {"HamGNN_pre": dict(
                SK_SOC_CFG["representation_nets"]["HamGNN_pre"], **pre)},
            "output_nets": {"HamGNN_out": {"nao_max": 14}}}


@pytest.mark.cuda
@pytest.mark.parametrize("rep,engine", [("transformer", "auto"), ("transformer", "zonal"),
                                        ("corr", "auto"), ("kan", "auto")])
def test_cuda_representation_captured_step_equals_eager(tmp_path, monkeypatch, rep, engine):
    """The step of each new representation, replayed from a CUDA graph,
    against the eager step from the same weights under deterministic
    algorithms: loss, every gradient and the updated parameters bit for bit;
    at 2 layers the eager step launches the engine's kernels 9 times each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if engine != "auto":
        monkeypatch.setenv("HAMGNN_TP_ENGINE", engine)
    g, _g2 = _step_batches()
    eager, cap = _trainer_pair(tmp_path, _rep_cfg(rep), HAM)
    fwd, bwd = (tp_kernel.KERNELS[n] for n in ENGINE_KERNELS[engine])
    torch.use_deterministic_algorithms(True)
    try:
        before = (fwd.launches, bwd.launches)
        la, _ = eager.train_step(g)
        torch.cuda.synchronize()
        assert (fwd.launches - before[0], bwd.launches - before[1]) == (9, 9)
        lb, logs = cap.train_step(g)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    assert float(logs["nonfinite_step"]) == 0.0 and cap.captured.captures == 1
    assert float(la) == float(lb)
    assert torch.equal(eager.grad, cap.grad)
    assert torch.equal(eager.flat, cap.flat)


@pytest.mark.cuda
def test_cuda_captured_trainers_leave_held_memory_flat(tmp_path):
    """Trainers that capture, made and dropped one after another: once the
    first has made the process's first uses, the memory held after each of
    the next two stays within 0.05 GB of that held after the first."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import gc

    g1, _g2 = _step_batches()
    held = []
    for i in range(3):
        _eager, cap = _trainer_pair(tmp_path / str(i), SMALL_CFG, HAM)
        cap.train_step(g1)
        cap.eval_step(g1)
        torch.cuda.synchronize()
        del _eager, cap
        gc.collect()
        torch.cuda.empty_cache()
        held.append(torch.cuda.memory_allocated())
    assert max(held[1:]) - held[0] <= 0.05e9, held
