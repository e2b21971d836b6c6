"""Packed TP pipeline of the PyTorch port against the JAX package.

* the plain PyTorch version against ``PackedTPPlan._apply`` and against the
  Pallas kernel in interpret mode, with and without radial weights, f32 at
  atol 2e-5 / rtol 2e-5 (as in tests/test_pallas_tp.py);
* the CUDA kernel's host schedule, run through a numpy emulation of the
  kernel's loop nest (coupling slots -> BLK columns -> Wcat product), against
  the plain version, at small and at bench widths;
* the wrapper's dispatch on the CPU;
* the plain backward (autograd through the plain version) against ``jax.vjp``
  of ``PackedTPPlan._apply`` and of the Pallas kernel pair in interpret mode,
  with and without radial weights and with dsh, f32 at atol 5e-5 / rtol 5e-5
  (the sums over edges and columns run in another order);
* the backward kernel's host schedule (slabs, x groups, slot groups), run
  through a numpy emulation of the kernel's loop nest, against the plain
  backward at the small cases, at a case whose output irreps repeat an irrep
  and at bench widths (E = 6): atol/rtol 2e-5, and 1e-4 * max|ref| at bench
  widths;
* (the CUDA kernels against the plain versions run in test_torch_port_cuda.py).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hamgnn_tpu.e3.packed_tp import get_plan as j_get_plan
from hamgnn_tpu.e3.pallas_tp import pallas_apply
from hamgnn_tpu_torch.e3 import tp_kernel
from hamgnn_tpu_torch.e3.irreps import Irreps
from hamgnn_tpu_torch.e3.packed_tp import get_plan, plain_apply, plain_backward

CASES = [
    ("8x0e+4x0o+3x1o+2x1e+2x2e+1x2o+1x3o", "0e+1o+2e+3o",
     "6x0e+2x0o+3x1o+1x1e+2x2e+1x2o+1x3o+1x3e"),
    ("4x0e+2x1o+1x2e", "0e+1o+2e", "4x0e+2x1o+2x2e"),
    ("4x0e+2x1o+1x2e+1x3o", "0e+1o+2e+3o+4e", "3x0e+1x1o"),
    ("8x0e", "0e+1o+2e", "4x0e+2x1o+1x2e"),
    ("16x0e+8x1o+4x2e", "0e+1o+2e+3o+4e", "8x0e+4x1o+2x2e"),
]
BENCH_FEAT = "64x0e+32x0o+24x1o+12x1e+12x2e+6x2o+4x3o+4x3e+2x4e"
BENCH_SH = "0e + 1o + 2e + 3o + 4e"
BENCH_IN = ["96x0e", repr(Irreps([(2 * m, ir) for m, ir in Irreps(BENCH_FEAT)])),
            BENCH_FEAT]


def _inputs(plan, seed=0, E=23):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(E, plan.irreps_in.dim)).astype(np.float32)
    sh = rng.normal(size=(E, plan.irreps_sh.dim)).astype(np.float32)
    w = rng.normal(size=(E, plan.weight_numel)).astype(np.float32)
    fw = rng.normal(size=(plan.linear_numel,)).astype(np.float32)
    return x, sh, w, fw


def _plain(plan, x, sh, w, fw):
    t = torch.as_tensor
    return plain_apply(plan, t(x), t(sh), None if w is None else t(w), t(fw)).numpy()


def emulate_kernel(spec, x, sh, w, wcat):
    """numpy model of packed_tp_fwd.cu: per output chunk, the coupling slots
    W[e, q] of all m3 from their nonzero coefficient ranges; per m3 the BLK
    columns sum_i W[e, m3*nq + qb + i] * x[e, xb + i] (* w[e, wc]) and their
    product with the chunk's Wcat block, written to out[e, b + v*d3 + m3]."""
    E = x.shape[0]
    out = np.zeros((E, spec.d_out))
    for (b, d3, V, wofs, fan_in, col_ofs, q_ofs, nq) in spec.grp:
        W = np.stack([sh[:, s0 : s0 + ns] @ spec.coef[co : co + ns]
                      for co, s0, ns in spec.qtab[q_ofs : q_ofs + d3 * nq]], axis=1)
        qb, d1, xb, wc = spec.cols[col_ofs : col_ofs + fan_in].T
        B = wcat[wofs : wofs + fan_in * V].reshape(fan_in, V)
        for m3 in range(d3):
            A = np.zeros((E, fan_in))
            for i in range(int(d1.max())):
                ok = d1 > i
                A[:, ok] += W[:, m3 * nq + qb[ok] + i] * x[:, xb[ok] + i]
            if w is not None:
                A = A * w[:, wc]
            out[:, b + np.arange(V) * d3 + m3] = A @ B
    return out


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("with_w", [True, False])
def test_plain_matches_packed_apply(case, with_w):
    plan = get_plan(*[repr(Irreps(s)) for s in (case[0], case[1], case[2], case[2])])
    jplan = j_get_plan(case[0], case[1], case[2], case[2])
    x, sh, w, fw = _inputs(plan)
    w = w if with_w else None
    a = np.asarray(jplan._apply(jnp.asarray(x), jnp.asarray(sh),
                                None if w is None else jnp.asarray(w), jnp.asarray(fw)))
    np.testing.assert_allclose(_plain(plan, x, sh, w, fw), a, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("case", CASES[:3])
@pytest.mark.parametrize("with_w", [True, False])
def test_plain_matches_pallas_interpret(case, with_w):
    plan = get_plan(*[repr(Irreps(s)) for s in (case[0], case[1], case[2], case[2])])
    jplan = j_get_plan(case[0], case[1], case[2], case[2])
    x, sh, w, fw = _inputs(plan, seed=1)
    w = w if with_w else None
    b = np.asarray(pallas_apply(jplan, jnp.asarray(x), jnp.asarray(sh),
                                None if w is None else jnp.asarray(w), jnp.asarray(fw),
                                interpret=True))
    np.testing.assert_allclose(_plain(plan, x, sh, w, fw), b, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("with_w", [True, False])
def test_kernel_schedule_matches_plain(case, with_w):
    plan = get_plan(*[repr(Irreps(s)) for s in (case[0], case[1], case[2], case[2])])
    spec = tp_kernel.get_spec(plan)
    x, sh, w, fw = _inputs(plan, seed=2, E=37)
    w = w if with_w else None
    wcat = spec.build_wcat(torch.as_tensor(fw)).numpy()
    np.testing.assert_allclose(emulate_kernel(spec, x, sh, w, wcat),
                               _plain(plan, x, sh, w, fw), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("irreps_in", BENCH_IN, ids=["pair", "node", "edge"])
def test_kernel_schedule_bench_width(irreps_in):
    f = repr(Irreps(BENCH_FEAT))
    plan = get_plan(repr(Irreps(irreps_in)), repr(Irreps(BENCH_SH)), f, f)
    spec = tp_kernel.get_spec(plan)
    x, sh, w, fw = _inputs(plan, seed=3, E=6)
    wcat = spec.build_wcat(torch.as_tensor(fw)).numpy()
    ref = _plain(plan, x, sh, w, fw)
    np.testing.assert_allclose(emulate_kernel(spec, x, sh, w, wcat), ref,
                               atol=1e-4 * np.abs(ref).max(), rtol=0)
    # the launch fits the kernel's limits (packed_tp_fwd.cu): shared memory
    # within an H100 block's 227 KB, rows per thread <= 32, d1 <= 13
    te, ks, nt = 16, 64, 512
    a_ofs = (te * (spec.S + (spec.nq_all_max | 1)) + 3) & ~3
    smem = 4 * (a_ofs + spec.d3_max * te * (ks + 4) + ks * spec.v_max)
    assert smem <= 232_448
    for (_b, d3, V, *_r) in spec.grp:
        assert -(-d3 * te // (nt // V)) <= 32
    assert spec.d1_max <= 13


def test_wrapper_takes_plain_version_on_cpu():
    plan = get_plan(*[repr(Irreps(s)) for s in (CASES[1][0], CASES[1][1], CASES[1][2], CASES[1][2])])
    x, sh, w, fw = (torch.as_tensor(a) for a in _inputs(plan, seed=4))
    before = tp_kernel.PACKED_TP_FWD.launches
    out = tp_kernel.packed_tp_forward(plan, x, sh, w, fw)
    assert tp_kernel.PACKED_TP_FWD.launches == before
    torch.testing.assert_close(out, plain_apply(plan, x, sh, w, fw), rtol=0, atol=0)
    torch.testing.assert_close(plan(x, sh, w, fw), out, rtol=0, atol=0)


def test_flops_and_bytes_count():
    plan = get_plan(*[repr(Irreps(s)) for s in (CASES[3][0], CASES[3][1], CASES[3][2], CASES[3][2])])
    spec = tp_kernel.get_spec(plan)
    flops, nbytes = spec.work(10, True)
    assert nbytes == 4 * (10 * (spec.d_in + spec.S + spec.n_ch + spec.d_out)
                          + plan.linear_numel)
    assert flops > 0 and spec.work(10, False)[0] < flops
    t, by = spec.bound_ms(10, True)
    assert t > 0 and by in ("bytes", "operations")


# a case whose output irreps repeat an irrep: dw then crosses output chunks
REPEAT = ("4x0e+2x1o+1x2e", "0e+1o+2e", "4x0e+2x1o", "3x0e+2x1o+2x0e")
BWD_TOL = dict(atol=5e-5, rtol=5e-5)


def _case_plan(case):
    target, out = case[2], case[3] if len(case) > 3 else case[2]
    return get_plan(*[repr(Irreps(s)) for s in (case[0], case[1], target, out)])


def _plain_bwd(plan, x, sh, w, fw, gy, need_dsh=True):
    t = torch.as_tensor
    return [None if a is None else a.numpy() for a in plain_backward(
        plan, t(x), t(sh), None if w is None else t(w), t(fw), t(gy), need_dsh)]


def emulate_backward(spec, x, sh, w, wcat, gy, need_dsh):
    """numpy model of packed_tp_bwd.cu: per output chunk the coupling slots
    W; per slab of columns the mids, dBLK = G @ Wcat^T, the dWcat partial,
    dw, dmid = dBLK * w; dx per x group and dW per slot group from the slab
    tables; dsh from dW through the coupling ranges; d(flat_w) scattered
    through the Wcat index."""
    E = x.shape[0]
    ks = tp_kernel.BWD_SLAB_COLS
    dx, dsh = np.zeros((E, spec.d_in)), np.zeros((E, spec.S))
    dw = np.zeros((E, spec.n_ch))
    dwcat = np.zeros(len(wcat))
    for k, (b, d3, V, wofs, fan_in, col_ofs, q_ofs, nq) in enumerate(spec.grp):
        W = np.stack([sh[:, s0 : s0 + ns] @ spec.coef[co : co + ns]
                      for co, s0, ns in spec.qtab[q_ofs : q_ofs + d3 * nq]], axis=1)
        dW = np.zeros_like(W)
        G = np.stack([gy[:, b + np.arange(V) * d3 + m3] for m3 in range(d3)], axis=1)
        B = wcat[wofs : wofs + fan_in * V].reshape(fan_in, V)
        for si, c0 in enumerate(range(0, fan_in, ks)):
            cs = np.arange(c0, min(c0 + ks, fan_in))
            qb, d1, xb, wc = spec.cols[col_ofs + cs].T
            A = np.zeros((E, d3, len(cs)))
            for m3 in range(d3):
                for i in range(int(d1.max())):
                    ok = d1 > i
                    A[:, m3, ok] += W[:, m3 * nq + qb[ok] + i] * x[:, xb[ok] + i]
            ws = w[:, wc] if w is not None else np.ones((E, len(cs)))
            D = np.einsum("emv,cv->emc", G, B[cs])
            dwcat[wofs + c0 * V : wofs + (c0 + len(cs)) * V] += np.einsum(
                "emc,ec,emv->cv", A, ws, G).reshape(-1)
            dw[:, wc] += (D * A).sum(1)
            D = D * ws[:, None, :]
            xg_ofs, n_xg, qg_ofs, n_qg = spec.slabs[spec.slab_base[k] + si]
            for (gxb, gd1, lo, n) in spec.xgrp[xg_ofs : xg_ofs + n_xg]:
                for c in spec.lst[lo : lo + n]:
                    q0 = spec.cols[col_ofs + c][0]
                    for m3 in range(d3):
                        dx[:, gxb : gxb + gd1] += (D[:, m3, c - c0, None]
                                                   * W[:, m3 * nq + q0 : m3 * nq + q0 + gd1])
            for (gqb, gd1, lo, n) in spec.qgrp[qg_ofs : qg_ofs + n_qg]:
                for c in spec.lst[lo : lo + n]:
                    xc = spec.cols[col_ofs + c][2]
                    for m3 in range(d3):
                        dW[:, m3 * nq + gqb : m3 * nq + gqb + gd1] += (
                            D[:, m3, c - c0, None] * x[:, xc : xc + gd1])
        for q, (co, s0, ns) in enumerate(spec.qtab[q_ofs : q_ofs + d3 * nq]):
            dsh[:, s0 : s0 + ns] += dW[:, q, None] * spec.coef[co : co + ns]
    dflat = np.zeros(len(wcat))
    dflat[spec.wcat_idx] = dwcat * spec.wcat_scale
    return dx, (dsh if need_dsh else None), (dw if w is not None else None), dflat


# the Pallas pair in interpret mode is slow on the CPU: its cases are the
# two smaller ones
VJP_CASES = [(c, "apply") for c in CASES[:3]] + [(c, "pallas") for c in CASES[1:3]]


@pytest.mark.parametrize("case,engine", VJP_CASES,
                         ids=[f"{e}-case{CASES.index(c)}" for c, e in VJP_CASES])
@pytest.mark.parametrize("with_w", [True, False])
def test_plain_backward_matches_jax_vjp(case, engine, with_w):
    """Against jax.vjp of PackedTPPlan._apply and of the Pallas pair."""
    plan = _case_plan(case)
    jplan = j_get_plan(case[0], case[1], case[2], case[2])
    x, sh, w, fw = _inputs(plan, seed=6)
    gy = np.random.default_rng(7).normal(size=(x.shape[0], plan.irreps_out.dim)
                                         ).astype(np.float32)
    w = w if with_w else None
    ours = _plain_bwd(plan, x, sh, w, fw, gy)
    args = [jnp.asarray(a) for a in (x, sh, fw)] + ([jnp.asarray(w)] if with_w else [])

    def ref(f):
        def g(xx, ss, ff, *ww):
            return f(xx, ss, ww[0] if ww else None, ff)
        grads = jax.jit(lambda *a: jax.vjp(g, *a)[1](jnp.asarray(gy)))(*args)
        dx, dsh, dfw, *dw = (np.asarray(a) for a in grads)
        return [dx, dsh, dw[0] if dw else None, dfw]

    f = (jplan._apply if engine == "apply" else
         lambda a, b, c, d: pallas_apply(jplan, a, b, c, d, interpret=True))
    for name, a, b in zip(("dx", "dsh", "dw", "dflat_w"), ours, ref(f)):
        if b is None:
            assert a is None
            continue
        np.testing.assert_allclose(a, b, err_msg=name, **BWD_TOL)


@pytest.mark.parametrize("case", CASES + [REPEAT],
                         ids=[f"case{i}" for i in range(len(CASES))] + ["repeat_out"])
@pytest.mark.parametrize("with_w", [True, False])
def test_backward_schedule_matches_plain(case, with_w):
    plan = _case_plan(case)
    spec = tp_kernel.get_spec(plan)
    x, sh, w, fw = _inputs(plan, seed=8, E=21)
    gy = np.random.default_rng(9).normal(size=(21, plan.irreps_out.dim)).astype(np.float32)
    w = w if with_w else None
    wcat = spec.build_wcat(torch.as_tensor(fw)).numpy()
    got = emulate_backward(spec, x, sh, w, wcat, gy, need_dsh=True)
    for name, a, b in zip(("dx", "dsh", "dw", "dflat_w"), got,
                          _plain_bwd(plan, x, sh, w, fw, gy)):
        if b is None:
            assert a is None
            continue
        np.testing.assert_allclose(a, b, err_msg=name, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("irreps_in", BENCH_IN, ids=["pair", "node", "edge"])
def test_backward_schedule_bench_width(irreps_in):
    f = repr(Irreps(BENCH_FEAT))
    plan = get_plan(repr(Irreps(irreps_in)), repr(Irreps(BENCH_SH)), f, f)
    spec = tp_kernel.get_spec(plan)
    x, sh, w, fw = _inputs(plan, seed=10, E=6)
    gy = np.random.default_rng(11).normal(size=(6, spec.d_out)).astype(np.float32)
    wcat = spec.build_wcat(torch.as_tensor(fw)).numpy()
    got = emulate_backward(spec, x, sh, w, wcat, gy, need_dsh=True)
    for name, a, b in zip(("dx", "dsh", "dw", "dflat_w"), got,
                          _plain_bwd(plan, x, sh, w, fw, gy)):
        np.testing.assert_allclose(a, b, err_msg=name, atol=1e-4 * np.abs(b).max(), rtol=0)
    # two blocks fit an H100 SM (packed_tp_bwd.cu smem layout, 8-edge
    # tiles), one with dsh
    te, ks = 8, tp_kernel.BWD_SLAB_COLS
    floats = (te * spec.S + 2 * te * (spec.nq_all_max | 1) + te * spec.gmax + te * ks
              + ks * (spec.v_max | 1) + 2 * spec.d3_max * te * (ks + 4))
    assert 4 * floats <= 232_448
    assert 2 * 4 * (floats - te * (spec.nq_all_max | 1)) <= 233_472
    assert spec.d1_max <= 13 and spec.v_max <= 512


@pytest.mark.parametrize("case", CASES + [REPEAT] + [(i, BENCH_SH, BENCH_FEAT) for i in BENCH_IN],
                         ids=[f"case{i}" for i in range(len(CASES))]
                         + ["repeat_out", "pair", "node", "edge"])
def test_wcat_index_is_a_permutation(case):
    """The scatter of dWcat back to d(flat_w) has no collisions."""
    spec = tp_kernel.get_spec(_case_plan(case))
    assert np.array_equal(np.sort(spec.wcat_idx), np.arange(spec.plan.linear_numel))


def test_autograd_on_cpu_takes_plain_version():
    """Gradients through ``packed_tp_forward`` on CPU tensors are those of
    the plain version, and no kernel launches."""
    plan = _case_plan(CASES[1])
    x, sh, w, fw = (torch.as_tensor(a).requires_grad_(True) for a in _inputs(plan, seed=12))
    gy = torch.as_tensor(np.random.default_rng(13).normal(size=(x.shape[0], plan.irreps_out.dim))
                         .astype(np.float32))
    before = (tp_kernel.PACKED_TP_FWD.launches, tp_kernel.PACKED_TP_BWD.launches)
    got = torch.autograd.grad(tp_kernel.packed_tp_forward(plan, x, sh, w, fw), (x, sh, w, fw), gy)
    assert (tp_kernel.PACKED_TP_FWD.launches, tp_kernel.PACKED_TP_BWD.launches) == before
    ref = tp_kernel.packed_tp_backward(plan, x, sh, w, fw, gy, need_dsh=True)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert tp_kernel.packed_tp_backward(plan, x, sh, None, fw, gy)[1:3] == (None, None)


def test_backward_flops_and_bytes_count():
    plan = _case_plan(CASES[3])
    spec = tp_kernel.get_spec(plan)
    flops, nbytes = spec.work_bwd(10, True)
    assert nbytes == 4 * (10 * (2 * spec.d_in + spec.S + 2 * spec.n_ch + spec.d_out)
                          + 2 * plan.linear_numel)
    assert flops > spec.work(10, True)[0]
    assert spec.work_bwd(10, True, need_dsh=True)[0] > flops
    t, by = spec.bound_bwd_ms(10, True)
    assert t > 0 and by in ("bytes", "operations")


def test_tables_made_in_inference_mode_serve_autograd():
    """A plan first used under ``torch.inference_mode`` (an eval pass) keeps
    tables that a later training step can save for backward."""
    from hamgnn_tpu_torch.e3.packed_tp import PackedTPPlan

    plan = PackedTPPlan(*[repr(Irreps(s)) for s in (CASES[1][0], CASES[1][1],
                                                     CASES[1][2], CASES[1][2])])
    x, sh, w, fw = (torch.as_tensor(a) for a in _inputs(plan, seed=14))
    with torch.inference_mode():
        plain_apply(plan, x, sh, w, fw)
        tp_kernel.KernelSpec(plan).build_wcat(fw)
    gy = torch.ones(x.shape[0], plan.irreps_out.dim)
    dx, _, dw, dfw = plain_backward(plan, x, sh, w, fw, gy)
    assert dx.shape == x.shape and dw.shape == w.shape and dfw.shape == fw.shape


def test_backward_kernel_has_no_float_atomics():
    """B2's cross-block sums are per-block partials and a fixed-order
    reduce, so a repeat is bit-identical: no atomics in its source."""
    src = (Path(tp_kernel.CSRC) / "packed_tp_bwd.cu").read_text()
    assert not re.search(r"atomic\w*\s*\(|cuda::atomic", src)
