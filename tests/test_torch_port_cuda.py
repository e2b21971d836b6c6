"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: skips where no GPU is present.  Imports no JAX, so it runs
on a machine with only the port installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Tolerance: max|kernel - plain| <= 1e-4 * max|plain| in fp32 (only the
summation order differs), per output of the forward (B1) and of the
backward (B2: dx, dsh, dw, d(flat_w)); a repeat of B2 is bit-identical.
The same holds for the zonal engine's kernels (B3 against
``plain_zonal_core``, B4 against ``plain_zonal_core_backward``); the whole
zonal engine (two rotations around the kernels) is held to the lab-frame
plain version within 2e-5 * max|ref| (outputs) and 1e-4 * max|ref|
(gradients).  Every probe kernel (``tools_dev``) is held to its plain version
within its stated limit (fp32 1e-4, bf16 2e-2, tf32 operands 2e-3, all *
max|plain|) at its own size, the throughput probes at E = 256; ``k_acc``
repeats bit for bit.
"""

import numpy as np
import pytest
import torch

from hamgnn_tpu_torch.e3 import tp_kernel, zonal_kernel, zonal_tp
from hamgnn_tpu_torch.e3.irreps import Irreps
from hamgnn_tpu_torch.e3.packed_tp import get_plan, plain_apply, plain_backward
from hamgnn_tpu_torch.e3.spherical import spherical_harmonics
from hamgnn_tpu_torch.tools_dev import op_probe, op_probe2, probe, throughput_probe

PROBES = {**op_probe.PROBES, **op_probe2.PROBES, **throughput_probe.PROBES}

BENCH_FEAT = "64x0e+32x0o+24x1o+12x1e+12x2e+6x2o+4x3o+4x3e+2x4e"
BENCH_SH = "0e + 1o + 2e + 3o + 4e"
BENCH_IN = ["96x0e", repr(Irreps([(2 * m, ir) for m, ir in Irreps(BENCH_FEAT)])),
            BENCH_FEAT, "8x0e+4x0o+3x1o+2x1e+2x2e+1x2o+1x3o"]


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
        assert float((a - c).abs().max()) <= 1e-4 * float(c.abs().max()), name


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
