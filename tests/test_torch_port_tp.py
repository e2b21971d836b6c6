"""Packed TP pipeline of the PyTorch port against the JAX package.

* the plain PyTorch version against ``PackedTPPlan._apply`` and against the
  Pallas kernel in interpret mode, with and without radial weights, f32 at
  atol 2e-5 / rtol 2e-5 (as in tests/test_pallas_tp.py);
* the CUDA kernel's host schedule, run through a numpy emulation of the
  kernel's loop nest (coupling slots -> BLK columns -> Wcat product), against
  the plain version, at small and at bench widths;
* the wrapper's dispatch on the CPU;
* (the CUDA kernel against the plain version runs in test_torch_port_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hamgnn_tpu.e3.packed_tp import get_plan as j_get_plan
from hamgnn_tpu.e3.pallas_tp import pallas_apply
from hamgnn_tpu_torch.e3 import tp_kernel
from hamgnn_tpu_torch.e3.irreps import Irreps
from hamgnn_tpu_torch.e3.packed_tp import get_plan, plain_apply

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
