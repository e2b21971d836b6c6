"""Packed TP pipeline of the PyTorch port against the JAX package.

* the plain PyTorch version against ``PackedTPPlan._apply`` and against the
  Pallas kernel in interpret mode, with and without radial weights, f32 at
  atol 2e-5 / rtol 2e-5 (as in tests/test_pallas_tp.py);
* the CUDA kernel's host schedule, run through a numpy emulation of the
  kernel's loop nest (per work item: the chunk's coupling entries, then per
  64-column slab its BLK columns -> the item's part of the Wcat product,
  accumulated over the slabs), against the plain version, at small and at
  bench widths and where a chunk takes several items, and its work items
  within the kernel's limits;
* the wrapper's dispatch on the CPU;
* the plain backward (autograd through the plain version) against ``jax.vjp``
  of ``PackedTPPlan._apply`` and of the Pallas kernel pair in interpret mode,
  with and without radial weights and with dsh, f32 at atol 5e-5 / rtol 5e-5
  (the sums over edges and columns run in another order);
* the backward kernel's host schedule, run through a numpy emulation of its
  two passes (the edge pass per slab: mids, dBLK, dw, dmid, dx by x group,
  dW by slot group, dsh; the weight pass per slab and edge split, partial
  rows summed in a fixed order), against the plain backward at the small
  cases, at a case whose output irreps repeat an irrep, at a case with V > 64
  (the weight pass's items cut V) and at bench widths: atol/rtol 2e-5, and
  1e-4 * max|ref| at bench widths;
* the slab tables (column, slot and group coverage), the work items of both
  kernels and the weight pass's edge splits;
* the 3xTF32 numerics of the kernels' products, by a numpy emulation of TF32
  rounding at the bench plans' product shapes, and why one pass is not
  enough;
* the kernel build's rebuild rule (a shared header newer than the library);
* (the CUDA kernels against the plain versions, and their shared memory and
  blocks per SM, run in test_torch_port_cuda.py).
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
# output chunks wider than one work item: 128x0e (V > 64) and 57x4e (9 x 8
# (m3, n8) output tiles > 64)
WIDE = ("8x0e+2x1o+1x2e", "0e+1o+2e", "128x0e+2x1o+57x4e")


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


def slab_slots(spec, sh, k_slab):
    """The coupling slots W[e, j] of one slab's list (packed_tp_mma.cuh
    stage_slots)."""
    _k, _c0, _nc, sq_ofs, n_sq, *_rest = spec.slabs[k_slab]
    return np.stack([sh[:, s0 : s0 + ns] @ spec.coef[co : co + ns]
                     for co, s0, ns in spec.sq[sq_ofs : sq_ofs + n_sq]]
                    + [np.zeros(sh.shape[0])], axis=1)[:, :n_sq]


def slab_x(spec, x, k_slab):
    """One slab's compact x rows (packed_tp_mma.cuh stage_slab)."""
    xm_ofs, nx = spec.slabs[k_slab][9:11]
    return x[:, spec.xmap[xm_ofs : xm_ofs + nx]]


def slab_mids(spec, x, Wsl, k_slab):
    """mid[e, m3, c] of one slab's columns (packed_tp_mma.cuh build_slab,
    unscaled) and the columns' radial-weight indices."""
    k, c0, nc, *_rest = spec.slabs[k_slab]
    d3, col_ofs = spec.grp[k][1], spec.grp[k][5]
    sb, d1, xo, wc = spec.cols[col_ofs + c0 : col_ofs + c0 + nc].T
    xs = slab_x(spec, x, k_slab)
    A = np.zeros((x.shape[0], d3, nc))
    for m3 in range(d3):
        for i in range(int(d1.max())):
            ok = d1 > i
            A[:, m3, ok] += Wsl[:, sb[ok] + m3 * d1[ok] + i] * xs[:, xo[ok] + i]
    return A, wc


def emulate_kernel(spec, x, sh, w, wcat):
    """numpy model of packed_tp_fwd.cu: per work item (chunk, first n8 tile,
    n8 tiles), the chunk's coupling entries W[e, m3*nq + q], then slab by
    slab (64 columns) its BLK columns sum_i W[e, m3*nq + qb + i] * x[e, xb +
    i] (* w[e, wc]) times the slab's Wcat rows at the item's V columns,
    accumulated over the slabs and written to out[e, b + v*d3 + m3]."""
    E = x.shape[0]
    out = np.zeros((E, spec.d_out))
    for k, t0, n8 in spec.fitems:
        b, d3, V, wofs, fan_in, col_ofs, q_ofs, nq = spec.grp[k]
        W = np.stack([sh[:, s0 : s0 + ns] @ spec.coef[co : co + ns]
                      for co, s0, ns in spec.qtab[q_ofs : q_ofs + d3 * nq]], axis=1)
        qb, d1, xb, wc = spec.fcols[col_ofs : col_ofs + fan_in].T
        vs = np.arange(8 * t0, min(V, 8 * (t0 + n8)))
        B = wcat[wofs : wofs + fan_in * V].reshape(fan_in, V)[:, vs]
        acc = np.zeros((E, d3, len(vs)))
        for c0 in range(0, fan_in, tp_kernel.BWD_SLAB_COLS):
            cs = slice(c0, min(fan_in, c0 + tp_kernel.BWD_SLAB_COLS))
            A = np.zeros((E, d3, cs.stop - c0))
            for m3 in range(d3):
                for i in range(int(d1[cs].max())):
                    ok = d1[cs] > i
                    A[:, m3, ok] += W[:, m3 * nq + qb[cs][ok] + i] * x[:, xb[cs][ok] + i]
            if w is not None:
                A = A * w[:, None, wc[cs]]
            acc += np.einsum("emc,cv->emv", A, B[cs])
        for m3 in range(d3):
            out[:, b + vs * d3 + m3] = acc[:, m3]
    return out


TE = tp_kernel.TILE_EDGES


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


@pytest.mark.parametrize("case", CASES + [WIDE])
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
    # the tables the kernel's launch depends on (packed_tp_fwd.cu; its shared
    # memory and blocks per SM are checked on the card): one work item per
    # chunk, at most 64 (m3, n8) tiles (16 warps, at most two tiles each, so
    # that two blocks share an SM), d1 <= 13, and the chunk's coupling
    # entries as at the bench plans
    assert len(spec.fitems) == len(spec.grp)
    assert spec.fwd_pairs <= 2 * 16 and spec.d1_max <= 13
    assert spec.nq_all_max <= 693


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


def emulate_backward(spec, x, sh, w, wcat, gy, need_dsh, resident=264):
    """numpy model of packed_tp_bwd.cu's two passes.

    Edge pass, per output chunk and slab: the slab's coupling slots and
    mids, dBLK = G @ Wcat^T, dw += sum_m3 dBLK * mid, dmid = dBLK * w; dx per
    x group and dW per slot group from the slab tables; dsh from dW through
    the slab's slots.  Weight pass: per work item (``witems``: a slab and 32
    of its chunk's V columns) and edge split, the BLK columns times G summed
    over the split's 16-edge tiles into its part of the partial row (every
    element of ``part`` written once); then the partial rows summed in split
    order, scaled and scattered through the Wcat index."""
    E = x.shape[0]
    dx, dsh = np.zeros((E, spec.d_in)), np.zeros((E, spec.S))
    dw = np.zeros((E, spec.n_ch))
    for k, (b, d3, V, wofs, fan_in, col_ofs, _q, _nq) in enumerate(spec.grp):
        G = np.stack([gy[:, b + np.arange(V) * d3 + m3] for m3 in range(d3)], axis=1)
        B = wcat[wofs : wofs + fan_in * V].reshape(fan_in, V)
        for si in range(spec.slab_base[k], spec.slab_base[k + 1]):
            _k, c0, nc, sq_ofs, n_sq, xg_ofs, n_xg, qg_ofs, n_qg, _xm, _nx = spec.slabs[si]
            Wsl = slab_slots(spec, sh, si)
            A, wc = slab_mids(spec, x, Wsl, si)
            ws = w[:, wc] if w is not None else np.ones((E, nc))
            D = np.einsum("emv,cv->emc", G, B[c0 : c0 + nc])
            dw[:, wc] += (D * A).sum(1)
            D = D * ws[:, None, :]
            scol = spec.cols[col_ofs : col_ofs + fan_in]
            xm = spec.xmap[spec.slabs[si][9]:]
            xs = slab_x(spec, x, si)
            for (gxo, gd1, lo, n) in spec.xgrp[xg_ofs : xg_ofs + n_xg]:
                for c in spec.lst[lo : lo + n]:
                    sb = scol[c][0]
                    for m3 in range(d3):
                        dx[:, xm[gxo : gxo + gd1]] += (D[:, m3, c - c0, None]
                                                       * Wsl[:, sb + m3 * gd1 : sb + (m3 + 1) * gd1])
            dWsl = np.zeros_like(Wsl)
            for (gsb, gd1, lo, n) in spec.qgrp[qg_ofs : qg_ofs + n_qg]:
                for c in spec.lst[lo : lo + n]:
                    xo = scol[c][2]
                    for m3 in range(d3):
                        dWsl[:, gsb + m3 * gd1 : gsb + (m3 + 1) * gd1] += (
                            D[:, m3, c - c0, None] * xs[:, xo : xo + gd1])
            for j, (co, s0, ns) in enumerate(spec.sq[sq_ofs : sq_ofs + n_sq]):
                dsh[:, s0 : s0 + ns] += dWsl[:, j, None] * spec.coef[co : co + ns]

    n_split = spec.wcat_splits(E, resident)
    n_tiles = -(-E // TE)
    per = -(-n_tiles // n_split)
    part = np.full((n_split, len(wcat)), np.nan)
    for si, v0 in spec.witems:
        k, c0, nc, *_r = spec.slabs[si]
        b, d3, V, wofs = spec.grp[k][:4]
        vs = np.arange(v0, min(V, v0 + 8 * tp_kernel.WCAT_ITEM_N8))
        for p in range(n_split):
            acc = np.zeros((nc, len(vs)))
            for tile in range(p * per, min(n_tiles, (p + 1) * per)):
                rows = slice(tile * TE, min(E, (tile + 1) * TE))
                A, wc = slab_mids(spec, x[rows], slab_slots(spec, sh[rows], si), si)
                if w is not None:
                    A = A * w[rows][:, None, wc]
                G = np.stack([gy[rows, b + vs * d3 + m3] for m3 in range(d3)], axis=1)
                acc += np.einsum("emc,emv->cv", A, G)
            at = wofs + (c0 + np.arange(nc))[:, None] * V + vs[None, :]
            part[p, at] = acc
    assert not np.isnan(part).any()
    dflat = np.zeros(len(wcat))
    dflat[spec.wcat_idx] = part.sum(0) * spec.wcat_scale
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


@pytest.mark.parametrize("case", CASES + [REPEAT, WIDE],
                         ids=[f"case{i}" for i in range(len(CASES))] + ["repeat_out", "wide_out"])
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
    x, sh, w, fw = _inputs(plan, seed=10, E=40)  # three tiles, the last ragged
    gy = np.random.default_rng(11).normal(size=(40, spec.d_out)).astype(np.float32)
    wcat = spec.build_wcat(torch.as_tensor(fw)).numpy()
    got = emulate_backward(spec, x, sh, w, wcat, gy, need_dsh=True)
    for name, a, b in zip(("dx", "dsh", "dw", "dflat_w"), got,
                          _plain_bwd(plan, x, sh, w, fw, gy)):
        np.testing.assert_allclose(a, b, err_msg=name, atol=1e-4 * np.abs(b).max(), rtol=0)
    # the tables the passes' shared memory depends on (packed_tp_bwd.cu
    # Layout; its size and blocks per SM are checked on the card): slabs of
    # at most SLAB_SLOTS coupling slots and the compact x rows and V columns
    # of the bench plans, one or two weight-pass items per slab
    assert spec.d1_max <= 13 and spec.sq_max <= tp_kernel.SLAB_SLOTS
    assert spec.nx_max <= 236 and spec.v_max <= 2 * 8 * tp_kernel.WCAT_ITEM_N8
    assert len(spec.slabs) <= len(spec.witems) <= 2 * len(spec.slabs)


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
    """B2's cross-block sums are per-split partials and a fixed-order
    reduce, so a repeat is bit-identical: no atomics in its source or in the
    header it shares with B1."""
    for name in ("packed_tp_bwd.cu", "packed_tp_mma.cuh"):
        src = (Path(tp_kernel.CSRC) / name).read_text()
        assert not re.search(r"atomic\w*\s*\(|cuda::atomic", src), name
    assert "packed_tp_mma.cuh" in {f.name for f in tp_kernel.source_files(
        Path(tp_kernel.CSRC) / "packed_tp_bwd.cu")}


TABLE_CASES = CASES + [REPEAT, WIDE] + [(i, BENCH_SH, BENCH_FEAT) for i in BENCH_IN]
TABLE_IDS = [f"case{i}" for i in range(len(CASES))] + ["repeat_out", "wide_out", "pair", "node",
                                                       "edge"]


@pytest.mark.parametrize("case", TABLE_CASES, ids=TABLE_IDS)
def test_slab_tables(case):
    """Each chunk's slabs cover its columns in order, at most 64 columns and
    SLAB_SLOTS slots each (unless one coupling group needs more); every
    column lies in exactly one x group and one slot group of its slab, its
    slot base inside the slab's list; the weight pass's items cover every
    slab's V columns once, in groups of 32, heaviest slab first."""
    spec = tp_kernel.get_spec(_case_plan(case))
    assert len(spec.slab_base) == len(spec.grp) + 1
    for k, (_b, d3, _V, _wofs, fan_in, col_ofs, q_ofs, nq) in enumerate(spec.grp):
        c = 0
        for si in range(spec.slab_base[k], spec.slab_base[k + 1]):
            kk, c0, nc, sq_ofs, n_sq, xg_ofs, n_xg, qg_ofs, n_qg, xm_ofs, nx = spec.slabs[si]
            assert kk == k and c0 == c and 0 < nc <= tp_kernel.BWD_SLAB_COLS
            c += nc
            sb, d1, xo = spec.cols[col_ofs + c0 : col_ofs + c0 + nc, :3].T
            assert n_sq <= tp_kernel.SLAB_SLOTS or len(set(sb.tolist())) == 1
            assert (sb + d3 * d1 <= n_sq).all() and (xo + d1 <= nx).all()
            chunk_slots = {tuple(r) for r in spec.qtab[q_ofs : q_ofs + d3 * nq]}
            assert {tuple(r) for r in spec.sq[sq_ofs : sq_ofs + n_sq]} <= chunk_slots
            xm = spec.xmap[xm_ofs : xm_ofs + nx]
            assert len(set(xm.tolist())) == nx and (xm < spec.d_in).all()
            for tab in (spec.xgrp[xg_ofs : xg_ofs + n_xg], spec.qgrp[qg_ofs : qg_ofs + n_qg]):
                members = np.concatenate([spec.lst[lo : lo + n] for (_o, _d, lo, n) in tab])
                assert sorted(members.tolist()) == list(range(c0, c0 + nc))
        assert c == fan_in
    want = sorted((si, v0) for si, (k, *_r) in enumerate(spec.slabs)
                  for v0 in range(0, int(spec.grp[k][2]), 8 * tp_kernel.WCAT_ITEM_N8))
    assert sorted(map(tuple, spec.witems.tolist())) == want
    firsts = [int(si) for si, v0 in spec.witems if v0 == 0]
    assert sorted(firsts) == list(range(len(spec.slabs)))


@pytest.mark.parametrize("case", TABLE_CASES, ids=TABLE_IDS)
def test_forward_items(case):
    """The forward's work items cover every (m3, n8) output tile of every
    chunk once, each item at most ITEM_N8 n8 tiles and ITEM_PAIRS tiles;
    its columns are the chunk's in BLK order, their slots inside the chunk's
    m3 block."""
    spec = tp_kernel.get_spec(_case_plan(case))
    seen = set()
    for k, t0, n8 in spec.fitems:
        d3, V = int(spec.grp[k][1]), int(spec.grp[k][2])
        assert 1 <= n8 <= tp_kernel.ITEM_N8 and d3 * n8 <= tp_kernel.ITEM_PAIRS
        assert 8 * (t0 + n8) < V + 8
        for t in range(t0, t0 + n8):
            for m3 in range(d3):
                assert (k, m3, t) not in seen
                seen.add((k, m3, t))
    assert seen == {(k, m3, t) for k, (_b, d3, V, *_r) in enumerate(spec.grp)
                    for m3 in range(d3) for t in range(-(-V // 8))}
    assert spec.fwd_pairs == max(int(spec.grp[k][1]) * n for k, _t, n in spec.fitems)
    for (_b, d3, _V, _w, fan_in, col_ofs, _q, nq) in spec.grp:
        qb, d1, xb, _wc = spec.fcols[col_ofs : col_ofs + fan_in].T
        assert (qb + d1 <= nq).all() and (xb + d1 <= spec.d_in).all()


@pytest.mark.parametrize("E,resident", [(19_968, 264), (19_968, 132), (333, 264), (5, 264)])
def test_wcat_splits(E, resident):
    """The weight pass's edge splits: at least WCAT_WAVES waves of resident
    blocks where the edges allow, never a split without a tile."""
    f = repr(Irreps(BENCH_FEAT))
    spec = tp_kernel.get_spec(get_plan(repr(Irreps(BENCH_IN[1])), repr(Irreps(BENCH_SH)), f, f))
    n_tiles = -(-E // TE)
    p = spec.wcat_splits(E, resident)
    assert 1 <= p <= n_tiles
    assert p == n_tiles or p * len(spec.witems) >= tp_kernel.WCAT_WAVES * resident
    per = -(-n_tiles // p)
    assert (p - 1) * per < n_tiles  # the last split has a tile


def tf32(a):
    """TF32 rounding as the kernels do it (packed_tp_mma.cuh tf32_round):
    10 mantissa bits, to nearest, ties away from zero."""
    b = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_product(a, b, passes):
    """a @ b with TF32 operands and fp32 sums: one pass (tf32(a) tf32(b)) or
    three (small*big + big*small + big*big, small = tf32(x - tf32(x)))."""
    ab, bb = tf32(a), tf32(b)
    if passes == 1:
        return ab @ bb
    a_s, b_s = tf32(a - ab), tf32(b - bb)
    return (a_s @ bb + ab @ b_s) + ab @ bb


def _product_shapes():
    """(M, K, N) of the Wcat-stage products at the node plan, at 2,048
    edges: per output chunk (d3, V, fan_in) the forward (rows e*m3, K =
    fan_in, N = V), dBLK (K = V, N = fan_in) and dWcat (rows fan_in, K =
    e*m3, N = V)."""
    f = repr(Irreps(BENCH_FEAT))
    spec = tp_kernel.get_spec(get_plan(repr(Irreps(BENCH_IN[1])), repr(Irreps(BENCH_SH)), f, f))
    E = 2048
    out = []
    for (_b, d3, V, _w, fan_in, *_r) in spec.grp:
        if (int(d3), int(V)) in ((1, 64), (9, 2)):
            rows = E * int(d3)
            out += [(f"fwd-d3{d3}V{V}", (rows, int(fan_in), int(V))),
                    (f"dblk-d3{d3}V{V}", (rows, int(V), int(fan_in))),
                    (f"dwcat-d3{d3}V{V}", (int(fan_in), rows, int(V)))]
    return out


@pytest.mark.parametrize("shape", [s_ for _n, s_ in _product_shapes()],
                         ids=[n for n, _s in _product_shapes()])
def test_3xtf32_products_hold_fp32_accuracy(shape):
    """Why the kernels take three TF32 products: at the bench plans' shapes
    one TF32 pass is off by more than the kernels' 1e-4 * max|ref| limit,
    three passes (fp32 sums) are well within it.  Reference: float64."""
    M, K, N = shape
    rng = np.random.default_rng(M + K + N)
    a = rng.normal(size=(M, K)).astype(np.float32)
    b = rng.normal(size=(K, N)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(ref).max()
    err3 = np.abs(tf32_product(a, b, 3) - ref).max()
    err1 = np.abs(tf32_product(a, b, 1) - ref).max()
    assert err3 <= 1e-4 * scale, (err3 / scale)
    assert err1 > 1e-4 * scale, (err1 / scale)


def test_tf32_rounding():
    """tf32() keeps 10 mantissa bits, rounds to nearest with ties away from
    zero, and the big/small split is exact to 2^-22."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    x = np.array([1 + ulp / 2, 1 + ulp / 4, -(1 + ulp / 2), 1 + ulp + ulp / 2], np.float32)
    np.testing.assert_array_equal(tf32(x), np.array([1 + ulp, one, -(1 + ulp), 1 + 2 * ulp],
                                                     np.float32))
    a = np.random.default_rng(0).normal(size=10_000).astype(np.float32)
    big = tf32(a)
    assert (big.view(np.uint32) & 0x1FFF == 0).all()
    rel = np.abs((big.astype(np.float64) + tf32(a - big)) - a) / np.abs(a)
    assert rel.max() <= 2.0 ** -21


def test_build_rebuilds_when_a_shared_header_changes(tmp_path):
    """A library is rebuilt when its .cu or a header the .cu includes (from
    its own directory, recursively) is newer than the library."""
    import os

    src, hdr, inner, lib = (tmp_path / n for n in ("k.cu", "shared.cuh", "inner.cuh", "libk.so"))
    src.write_text('#include <cuda_runtime.h>\n#include "shared.cuh"\nint f() { return 0; }\n')
    hdr.write_text('#pragma once\n#include "inner.cuh"\n')
    inner.write_text("#pragma once\n")
    assert tp_kernel.is_stale(lib, src)
    assert set(tp_kernel.source_files(src)) == {src, hdr, inner}
    lib.write_bytes(b"")
    for f in (src, hdr, inner):
        os.utime(f, (1_000, 1_000))
    os.utime(lib, (2_000, 2_000))
    assert not tp_kernel.is_stale(lib, src)
    for f in (inner, hdr, src):
        os.utime(f, (3_000, 3_000))
        assert tp_kernel.is_stale(lib, src), f.name
        os.utime(f, (1_000, 1_000))
    assert not tp_kernel.is_stale(lib, src)


def test_device_kernel_names_are_the_sources():
    """Each model kernel names the ``__global__`` functions its C entry
    launches (a replayed CUDA graph is counted by them in a profiler trace),
    and each is defined in the kernel's own source."""
    for name, k in tp_kernel.KERNELS.items():
        text = (tp_kernel.CSRC / f"{k.source}.cu").read_text()
        defined = set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
                                 text))
        launched = set(re.findall(r"(\w+)(?:<[\w\s,]+>)?<<<", text))
        assert k.device_kernels and set(k.device_kernels) == launched, name
        assert set(k.device_kernels) <= defined, (name, defined)
