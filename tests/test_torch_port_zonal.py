"""Zonal (edge-frame) TP engine of the PyTorch port against the JAX package.

Small widths (the irreps of tests/test_zonal_tp.py, E = 40), numpy-seeded
inputs whose edge directions include +z, -z and near -z.  f32 on both sides.

* ``align_to_z``, ``batched_wigner_D`` (also against the port's ``wigner_D``)
  and ``direction_from_sh`` against their JAX counterparts, atol 2e-5;
* ``ZonalSpec`` tables element-exact against the JAX ``ZonalSpec``;
* ``zonal_apply`` against the JAX ``zonal_apply`` and the Pallas kernels in
  interpret mode, with and without radial weights, atol 2e-5 / rtol 1e-4
  (the tolerance of tests/test_zonal_tp.py);
* the plain backward against ``jax.grad`` through the Pallas kernels in
  interpret mode: dx, dw, d(flat_w) within 1e-4 * max|ref|;
* the CUDA kernels' host schedule (``ZonalKernelSpec``: entries, stages,
  work items, edge splits), run through numpy emulations of the kernels'
  loop nests (B3's items over the stages' |m3| segments, B4's edge pass and
  its weight pass over (item, edge split) with the fixed-order reduce, the
  Wcat-stage products in emulated 3xTF32), against the plain core and its
  backward: small plans (atol/rtol 2e-5), a plan that repeats an output
  irrep, the bench plans (E = 6) and the wide plan 128x0e+2x1o+57x4e (1e-4 *
  max|ref|), and a table with two-term columns; the tables build every
  nonzero term once and no zero term (6,404 records at the node plan, 480
  at the pair plan), and the work items and splits cover their ranges once;
* the engine switch ``HAMGNN_TP_ENGINE`` of ``PackedTPPlan.__call__``; engine
  against engine (zonal against lab frame) max|d| <= 2e-5 * max|ref|;
* the whole small model under ``zonal`` against the JAX model under
  ``zonal-xla`` with the same weights: outputs atol 5e-5 / rtol 1e-4,
  parameter gradients 5e-4 * max|ref|;
* the Wigner-D memo: one build per forward, also under gradient
  checkpointing, after an in-place change of ``sh`` and after a first call
  under ``inference_mode``.
  (The CUDA kernels against the plain versions run in test_torch_port_cuda.py.)
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from util_fixtures import add_random_hamiltonian_targets, make_crystal

from hamgnn_tpu.cli import build_model as j_build
from hamgnn_tpu.data.graph import pad_and_batch as j_pad
from hamgnn_tpu.e3 import zonal_tp as j_zonal
from hamgnn_tpu.e3.packed_tp import get_plan as j_get_plan
from hamgnn_tpu.e3.pallas_zonal import zonal_pallas_apply
from hamgnn_tpu.e3.spherical import spherical_harmonics as j_sh
from hamgnn_tpu.e3.wigner import wigner_D as j_wigner_D
from hamgnn_tpu.models.model import compute_losses as j_losses
from hamgnn_tpu.train.config import load_config
from hamgnn_tpu.train.trainer import init_params_on_cpu
from hamgnn_tpu_torch import cli as t_cli
from hamgnn_tpu_torch.data.graph import pad_and_batch as t_pad
from hamgnn_tpu_torch.e3 import packed_tp, tp_kernel, zonal_kernel, zonal_tp
from hamgnn_tpu_torch.e3.irreps import Irreps
from hamgnn_tpu_torch.e3.packed_tp import get_plan, plain_apply
from hamgnn_tpu_torch.e3.wigner import wigner_D
from hamgnn_tpu_torch.interfaces.jax_params import load_flax_params
from hamgnn_tpu_torch.models.model import compute_losses as t_losses
from hamgnn_tpu_torch.models.model import init_weights
from test_torch_port_tp import tf32_product

FEAT = "8x0e+4x0o+6x1o+4x1e+4x2e+2x2o+2x3o+2x3e+2x4e"
SH = "0e + 1o + 2e + 3o + 4e"
SH_LS = [0, 1, 2, 3, 4]
TOL = dict(atol=2e-5, rtol=1e-4)
ENGINE_TOL = 2e-5   # engine against engine, of max|ref|: two rotations' rounding
BENCH_FEAT = "64x0e+32x0o+24x1o+12x1e+12x2e+6x2o+4x3o+4x3e+2x4e"
BENCH_IN = {"pair": "96x0e",
            "node": repr(Irreps([(2 * m, ir) for m, ir in Irreps(BENCH_FEAT)])),
            "edge": BENCH_FEAT}
# a plan whose output chunks take several work items of both kernels
WIDE_IN, WIDE_OUT = "16x0e+4x1o+2x2e", "128x0e+2x1o+57x4e"
# (irreps_in, irreps_sh, target, out); the last repeats an output irrep, so
# dw crosses output chunks
SMALL = {
    "mixed": ("8x0e+4x0o+3x1o+2x1e+2x2e+1x2o+1x3o", "0e+1o+2e+3o",
              "6x0e+2x0o+3x1o+1x1e+2x2e+1x2o+1x3o+1x3e"),
    "tiny": ("4x0e+2x1o+1x2e", "0e+1o+2e", "4x0e+2x1o+2x2e"),
    "uncovered": ("4x0e+2x1o+1x2e+1x3o", "0e+1o+2e+3o+4e", "3x0e+1x1o+1x6e"),
    "scalars_in": ("8x0e", "0e+1o+2e", "4x0e+2x1o+1x2e"),
    "test_zonal": (FEAT, SH, FEAT),
    "repeat_out": ("4x0e+2x1o+1x2e", "0e+1o+2e", "4x0e+2x1o", "3x0e+2x1o+2x0e"),
}


def _plan(case):
    target, out = case[2], case[3] if len(case) > 3 else case[2]
    return get_plan(*[repr(Irreps(s)) for s in (case[0], case[1], target, out)])


def _directions(rng, E):
    vec = rng.normal(size=(E, 3))
    vec[0] = [0, 0, 1]           # exactly zonal
    vec[1] = [0, 0, -1]          # antipodal branch
    vec[2] = [1e-7, -1e-7, -1]   # near-antipodal
    return vec.astype(np.float32)


def _case(seed=0, E=40, feat=FEAT):
    plan = get_plan(*[repr(Irreps(s)) for s in (feat, SH, feat, feat)])
    jplan = j_get_plan(feat, SH, feat, feat)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(E, plan.irreps_in.dim)).astype(np.float32)
    sh = np.array(j_sh(SH_LS, jnp.asarray(_directions(rng, E)), normalize=True))
    w = rng.normal(size=(E, plan.weight_numel)).astype(np.float32)
    fw = rng.normal(size=(plan.linear_numel,)).astype(np.float32)
    return plan, jplan, x, sh, w, fw


def _t(a):
    return None if a is None else torch.tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


# ----------------------------------------------------------------------
# frames
# ----------------------------------------------------------------------

def _unit_vectors():
    v = np.random.default_rng(2).normal(size=(64, 3))
    v[0] = [0, 0, 1]
    v[1] = [0, 0, -1]
    v[2] = [1e-8, 0, -1]
    v[3] = [1e-7, -1e-7, -1]
    v = v / np.linalg.norm(v, axis=-1, keepdims=True)
    return v.astype(np.float32)


def test_align_to_z_matches_jax():
    v = _unit_vectors()
    R = zonal_tp.align_to_z(torch.tensor(v)).numpy()
    np.testing.assert_allclose(R, np.asarray(j_zonal.align_to_z(jnp.asarray(v))), atol=2e-5)
    np.testing.assert_allclose(np.einsum("eij,ej->ei", R, v),
                               np.tile([0, 0, 1.0], (64, 1)), atol=2e-5)
    np.testing.assert_allclose(np.einsum("eij,ekj->eik", R, R),
                               np.tile(np.eye(3), (64, 1, 1)), atol=2e-5)
    assert np.all(np.linalg.det(R) > 0.99)


def test_align_to_z_of_a_zero_vector_is_the_identity():
    """A padded edge's zero sh row gives a zero direction: no NaN."""
    sh = torch.zeros(3, 9)
    r = zonal_tp.direction_from_sh(sh, slice(1, 4))
    assert torch.equal(r, torch.zeros(3, 3))
    R = zonal_tp.align_to_z(r)
    np.testing.assert_array_equal(R.numpy(), np.tile(np.eye(3, dtype=np.float32), (3, 1, 1)))
    np.testing.assert_array_equal(
        R.numpy(), np.asarray(j_zonal.align_to_z(jnp.zeros((3, 3), jnp.float32))))


def _rotations(n=5):
    rng = np.random.default_rng(1)
    Rs = []
    for m in rng.normal(size=(n, 3, 3)):
        q, _ = np.linalg.qr(m)
        if np.linalg.det(q) < 0:
            q[:, 0] = -q[:, 0]
        Rs.append(q)
    return np.stack(Rs)


def test_batched_wigner_D_matches_jax_and_wigner_D():
    Rs = _rotations()
    Ds = zonal_tp.batched_wigner_D(4, torch.tensor(Rs, dtype=torch.float32))
    ref = j_zonal.batched_wigner_D(4, jnp.asarray(Rs, jnp.float32))
    assert len(Ds) == 5
    for l in range(5):
        np.testing.assert_allclose(Ds[l].numpy(), np.asarray(ref[l]), atol=2e-5)
        for e in range(len(Rs)):
            np.testing.assert_allclose(Ds[l][e].numpy(), wigner_D(l, Rs[e]), atol=2e-5)


@pytest.mark.parametrize("l", range(6))
def test_wigner_D_matches_jax(l):
    for R in _rotations(3):
        np.testing.assert_allclose(wigner_D(l, R), j_wigner_D(l, R), atol=1e-12)


def test_direction_from_sh_matches_jax():
    rng = np.random.default_rng(3)
    vec = _directions(rng, 40)
    sh = np.array(j_sh(SH_LS, jnp.asarray(vec), normalize=True))
    got = zonal_tp.direction_from_sh(torch.tensor(sh), slice(1, 4)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(j_zonal.direction_from_sh(jnp.asarray(sh), slice(1, 4))), atol=2e-5)
    np.testing.assert_allclose(got, vec / np.linalg.norm(vec, axis=-1, keepdims=True),
                               atol=2e-5)


# ----------------------------------------------------------------------
# static tables
# ----------------------------------------------------------------------

SPEC_CASES = {"test_zonal": (FEAT, SH, FEAT),
              **{k: (v, SH, BENCH_FEAT) for k, v in BENCH_IN.items()},
              "mixed": SMALL["mixed"]}


@pytest.mark.parametrize("name", sorted(SPEC_CASES))
def test_zonal_spec_tables_match_jax(name):
    case = SPEC_CASES[name]
    spec = zonal_tp.get_zonal_spec(_plan(case))
    jspec = j_zonal._get_zonal_spec(j_get_plan(case[0], case[1], case[2], case[2]).key)
    assert spec.sh_l1_slice == jspec.sh_l1_slice
    assert spec.max_l_feat == jspec.max_l_feat
    assert len(spec.chunk_zonal) == len(jspec.chunk_zonal)
    for a, b in zip(spec.chunk_zonal, jspec.chunk_zonal):
        assert (a is None) == (b is None)
        if a is not None:
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)


def test_zonal_spec_needs_an_l1_block():
    with pytest.raises(ValueError):
        zonal_tp.ZonalSpec(_plan(("4x0e", "0e+2e", "4x0e+2x2e")))


def test_zonal_coupling_has_one_term_per_column():
    """Zonal CG sends m3 to m1 = m3 or to m1 = -m3, never both: over every
    (l1, l2, l3) up to l = 4 no column has a second term.  (The tables and
    the kernels still carry two; ``test_two_term_columns`` covers them.)"""
    every = "+".join(f"1x{l}{p}" for l in range(5) for p in "eo")
    spec = zonal_tp.get_zonal_spec(_plan((every, SH, every)))
    n = 0
    for cz in spec.chunk_zonal:
        assert not np.any(cz[3])
        n += len(cz[1])
    assert n > 500


# ----------------------------------------------------------------------
# plain version against the JAX package
# ----------------------------------------------------------------------

@pytest.mark.parametrize("with_w", [True, False])
def test_zonal_apply_matches_jax_zonal_apply(with_w):
    plan, jplan, x, sh, w, fw = _case()
    w = w if with_w else None
    got = zonal_tp.zonal_apply(plan, _t(x), _t(sh), _t(w), _t(fw)).numpy()
    ref = np.asarray(jax.jit(lambda *a: j_zonal.zonal_apply(jplan, *a))(
        _j(x), _j(sh), _j(w), _j(fw)))
    np.testing.assert_allclose(got, ref, **TOL)
    # and the lab-frame plain version (engine against engine)
    lab = plain_apply(plan, _t(x), _t(sh), _t(w), _t(fw)).numpy()
    assert np.abs(got - lab).max() <= ENGINE_TOL * np.abs(lab).max()


@pytest.mark.parametrize("with_w", [True, False])
def test_zonal_apply_matches_pallas_interpret(with_w):
    plan, jplan, x, sh, w, fw = _case(seed=3)
    w = w if with_w else None
    got = zonal_tp.zonal_apply(plan, _t(x), _t(sh), _t(w), _t(fw)).numpy()
    ref = np.asarray(zonal_pallas_apply(jplan, _j(x), _j(sh), _j(w), _j(fw), interpret=True))
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("with_w", [True, False])
def test_plain_backward_matches_jax_grad_of_pallas_interpret(with_w):
    """dx, dw, d(flat_w) of sum(out * G) through the whole engine (rotations
    and ``plain_zonal_core``) against jax.grad through the Pallas pair."""
    plan, jplan, x, sh, w, fw = _case(seed=5)
    G = np.random.default_rng(6).normal(size=(x.shape[0], plan.irreps_out.dim)
                                        ).astype(np.float32)
    w = w if with_w else None
    tin = [_t(a).requires_grad_(True) for a in (x, w, fw) if a is not None]
    tx, tw, tfw = (tin[0], tin[1], tin[2]) if with_w else (tin[0], None, tin[1])
    tsh = _t(sh).requires_grad_(True)
    (zonal_tp.zonal_apply(plan, tx, tsh, tw, tfw) * _t(G)).sum().backward()
    assert tsh.grad is None  # the frame is data

    def loss(xx, ff, *ww):
        return jnp.sum(zonal_pallas_apply(jplan, xx, _j(sh), ww[0] if ww else None, ff,
                                          interpret=True) * G)

    args = [_j(x), _j(fw)] + ([_j(w)] if with_w else [])
    ref = jax.jit(jax.grad(loss, argnums=tuple(range(len(args)))))(*args)
    pairs = [("dx", tx.grad, ref[0]), ("dflat_w", tfw.grad, ref[1])]
    if with_w:
        pairs.append(("dw", tw.grad, ref[2]))
    for name, a, b in pairs:
        a, b = a.numpy(), np.asarray(b)
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), name


def test_core_backward_is_the_gradient_of_the_core():
    plan, _jplan, x, _sh, w, fw = _case(seed=7, E=9)
    gy = np.random.default_rng(8).normal(size=(9, plan.irreps_out.dim)).astype(np.float32)
    tx, tw, tfw = (_t(a).requires_grad_(True) for a in (x, w, fw))
    (zonal_tp.plain_zonal_core(plan, tx, tw, tfw) * _t(gy)).sum().backward()
    dx, dw, dfw = zonal_tp.plain_zonal_core_backward(plan, _t(x), _t(w), _t(fw), _t(gy))
    for a, b in ((dx, tx.grad), (dw, tw.grad), (dfw, tfw.grad)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert zonal_tp.plain_zonal_core_backward(plan, _t(x), None, _t(fw), _t(gy))[1] is None


# ----------------------------------------------------------------------
# the kernels' host schedule, through numpy emulations of their loop nests
# ----------------------------------------------------------------------

def _stage_rows(spec, x, w, si):
    """A stage's BLK operand, as the kernels build it: per entry its +|m3|
    and -|m3| records c * x_rot[e, xo] * w[e, wc] (E, n) each."""
    k, e0, n, *_r = spec.stages[si]
    ei, ec = spec.ent_i[e0 : e0 + n], spec.ent_c[e0 : e0 + n]
    wc = spec.wcol[spec.zgrp[k][5] + ei[:, 2]]
    ws = w[:, wc] if w is not None else np.ones((x.shape[0], n), np.float32)
    return [(x[:, ei[:, s]] * ec[:, s] * ws).astype(np.float32) for s in (0, 1)], ws


def _went(spec, wcat_flat):
    """Wcat in entry order, as ``build_went`` gathers it."""
    return (wcat_flat[spec.went_idx] * spec.went_scale).astype(np.float32)


def emulate_forward(spec, x, w, flat_w):
    """numpy model of zonal_tp_fwd.cu: per work item (a chunk's n8 tiles of
    V) and stage of its chunk, per |m3| segment the (+|m3|, -|m3|) BLK rows
    times the segment's Wcat rows in 3xTF32, each 64-entry part of K summed
    apart and added into fp32 accumulators per (|m3|, n8) tile; then
    out_rot[e, b + v*d3 + L +- a]."""
    E = x.shape[0]
    went = _went(spec, flat_w)
    out = np.zeros((E, spec.d_out), np.float32)
    for k, t0, n8 in spec.fitems:
        b, d3, V, st0, st1 = (int(v) for v in spec.zgrp[k][:5])
        L = (d3 - 1) // 2
        vs = np.arange(8 * t0, min(V, 8 * (t0 + n8)))
        acc = np.zeros((L + 1, 2, E, len(vs)), np.float32)
        for si in range(st0, st1):
            _k, e0, n, seg_ofs, n_seg, *_r, went0 = spec.stages[si][:10]
            A, _ws = _stage_rows(spec, x, w, si)
            B = went[went0 : went0 + n * V].reshape(n, V)[:, vs]
            for (a, s0, ns) in spec.segs[seg_ofs : seg_ofs + n_seg]:
                for q0 in range(s0, s0 + ns, 64):
                    q = slice(q0, min(s0 + ns, q0 + 64))
                    for s in (0, 1):
                        acc[a, s] += tf32_product(A[s][:, q], B[q], 3)
        for a in range(L + 1):
            for s in ((0, 1) if a else (0,)):
                out[:, b + vs * d3 + L + (a if s == 0 else -a)] = acc[a, s]
    return out


def emulate_backward(spec, x, w, flat_w, gy, resident=396):
    """numpy model of zonal_tp_bwd.cu's two passes and reduce.

    Edge pass, per chunk and stage: dBLK = G Wcat^T in 3xTF32 per |m3|
    segment (rows L + a and L - a), per entry P = dBLK+ mid+ + dBLK- mid- and
    dmid = dBLK * w; dw per column group (stored, or added where an earlier
    chunk wrote that column); dx_rot per x group, summed per tile in shared
    memory.  Weight pass: per work item (a segment's <= 64 entries and 32 V
    columns) and edge split, per 16-edge step the +|m3| and -|m3| rows' BLK^T
    G in 3xTF32, each added into its own fp32 accumulator, the two summed
    at the end into the split's part of its partial row.  Reduce: per Wcat
    element the splits in order, each over the element's entries."""
    E = x.shape[0]
    TE = zonal_kernel.WCAT_TILE_EDGES
    cap = zonal_kernel.STAGE_ENTRIES
    went = _went(spec, flat_w)
    dx = np.zeros((E, spec.d_in), np.float32)
    dw = np.zeros((E, spec.n_ch), np.float32)
    for (b, d3, V, st0, st1, col, _fan_in) in spec.zgrp:
        L = (d3 - 1) // 2
        G = [gy[:, b + np.arange(V) * d3 + m3] for m3 in range(d3)]
        for si in range(st0, st1):
            _k, e0, n, seg_ofs, n_seg, cg_ofs, n_cg, xg_ofs, n_xg, went0 = spec.stages[si][:10]
            ei, ec = spec.ent_i[e0 : e0 + n], spec.ent_c[e0 : e0 + n]
            B = went[went0 : went0 + n * V].reshape(n, V)
            D = np.zeros((2, E, n), np.float32)
            for (a, s0, ns) in spec.segs[seg_ofs : seg_ofs + n_seg]:
                q = slice(s0, s0 + ns)
                for s, m3 in ((0, L + a), (1, L - a)):
                    D[s][:, q] = tf32_product(G[m3], B[q].T, 3)
            mid = [x[:, ei[:, s]] * ec[:, s] for s in (0, 1)]
            ws = w[:, spec.wcol[col + ei[:, 2]]] if w is not None else np.ones((E, n), np.float32)
            P = D[0] * mid[0] + D[1] * mid[1]
            dmid = np.concatenate([D[0] * ws, D[1] * ws], axis=1)
            for (wc, add, lo, cnt) in spec.cgrp[cg_ofs : cg_ofs + n_cg]:
                acc = np.zeros(E, np.float32)
                for kk in spec.clst[lo : lo + cnt]:
                    acc += P[:, kk]
                dw[:, wc] = dw[:, wc] + acc if add else acc
            for (xo, lo, cnt) in spec.xgrp[xg_ofs : xg_ofs + n_xg]:
                codes = spec.xlst[lo : lo + cnt]
                cols = (codes // cap) * n + codes % cap
                dx[:, xo] += dmid[:, cols] @ spec.xcoef[lo : lo + cnt]

    n_split = spec.wcat_splits(E, resident)
    n_tiles = -(-E // TE)
    per = -(-n_tiles // n_split)
    part = np.full((n_split, len(spec.went_idx)), np.nan, np.float32)
    for (si, q0, nq, v0) in spec.witems:
        k, e0, n, *_r, went0 = spec.stages[si][:10]
        b, d3, V = (int(v) for v in spec.zgrp[k][:3])
        L = (d3 - 1) // 2
        a = int(spec.ent_i[e0 + q0, 3])
        vs = np.arange(v0, min(V, v0 + 8 * tp_kernel.WCAT_ITEM_N8))
        q = slice(e0 + q0, e0 + q0 + nq)
        ei, ec = spec.ent_i[q], spec.ent_c[q]
        wc = spec.wcol[spec.zgrp[k][5] + ei[:, 2]]
        for p in range(n_split):
            acc = np.zeros((2, nq, len(vs)), np.float32)
            for tile in range(p * per, min(n_tiles, (p + 1) * per)):
                rows = slice(tile * TE, min(E, (tile + 1) * TE))
                ws = w[rows][:, wc] if w is not None else 1.0
                for s, m3 in ((0, L + a), (1, L - a)):
                    blk = x[rows][:, ei[:, s]] * ec[:, s] * ws
                    acc[s] += tf32_product(blk.T, gy[rows][:, b + vs * d3 + m3], 3)
            at = went0 + (q0 + np.arange(nq))[:, None] * V + vs[None, :]
            part[p, at] = acc[0] + acc[1]
    dwcat = np.zeros(len(spec.wcat_idx), np.float32)
    for p in range(n_split):
        for i in range(len(dwcat)):
            dwcat[i] += part[p, spec.red_lst[spec.red_ofs[i] : spec.red_ofs[i + 1]]].sum()
    assert not np.isnan(dwcat).any()
    dflat = np.zeros(len(dwcat), np.float32)
    dflat[spec.wcat_idx] = dwcat * spec.wcat_scale
    return dx, (dw if w is not None else None), dflat


def _core_inputs(plan, seed, E):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(E, plan.irreps_in.dim)).astype(np.float32),
            rng.normal(size=(E, plan.weight_numel)).astype(np.float32),
            rng.normal(size=(plan.linear_numel,)).astype(np.float32),
            rng.normal(size=(E, plan.irreps_out.dim)).astype(np.float32))


def _check_schedule(plan, spec, with_w, E, tol):
    x, w, fw, gy = _core_inputs(plan, 2, E)
    w = w if with_w else None
    ref = zonal_tp.plain_zonal_core(plan, _t(x), _t(w), _t(fw)).numpy()
    np.testing.assert_allclose(emulate_forward(spec, x, w, fw), ref, **tol(ref))
    got = emulate_backward(spec, x, w, fw, gy)
    refs = zonal_tp.plain_zonal_core_backward(plan, _t(x), _t(w), _t(fw), _t(gy))
    for name, a, b in zip(("dx", "dw", "dflat_w"), got, refs):
        if b is None:
            assert a is None
            continue
        np.testing.assert_allclose(a, b.numpy(), err_msg=name, **tol(b.numpy()))


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("with_w", [True, False])
def test_kernel_schedule_matches_plain_core(name, with_w):
    plan = _plan(SMALL[name])
    _check_schedule(plan, zonal_kernel.get_zonal_kernel_spec(plan), with_w, 21,
                    lambda ref: dict(atol=2e-5, rtol=2e-5))


@pytest.mark.parametrize("name", sorted(BENCH_IN) + ["wide_out"])
def test_kernel_schedule_bench_width(name):
    case = (WIDE_IN, "0e+1o+2e", WIDE_OUT) if name == "wide_out" else (BENCH_IN[name], SH,
                                                                        BENCH_FEAT)
    plan = _plan(case)
    spec = zonal_kernel.get_zonal_kernel_spec(plan)
    _check_schedule(plan, spec, True, 6 if name != "wide_out" else 21,
                    lambda ref: dict(atol=1e-4 * np.abs(ref).max(), rtol=0))
    if name == "wide_out":
        return
    # every column of the bench plans has at most one term
    assert not np.any(spec.zcoef[:, 1])
    # the launches fit the kernels' layouts (zonal_tp_fwd.cu, zonal_tp_bwd.cu;
    # their sizes and blocks per SM are checked on the card): two blocks of
    # each kernel and pass share an H100 SM's 228 KB
    TE, cap = zonal_kernel.ZONAL_TILE_EDGES, zonal_kernel.STAGE_ENTRIES
    x_rows = TE * (spec.d_in | 1)
    fwd = 4 * (x_rows + 2 * TE * (cap + 4))
    x_rows = TE * (-(-spec.d_in // 8) * 8 + 4)  # the edge pass's row stride
    edge = 4 * (2 * x_rows + spec.gmax * TE + 3 * TE * (cap + 4) + 2 * 6 * cap
                + spec.tgrp_words)
    WTE = zonal_kernel.WCAT_TILE_EDGES
    wcat = 4 * (2 * (2 * WTE * 40 + 2 * WTE * 72 + WTE * 72) + 3 * 64 + 2048)
    for nbytes in (fwd, edge, wcat):
        assert 2 * (nbytes + 1024) <= 233_472, nbytes
    assert spec.fwd_tiles <= zonal_kernel.FWD_ITEM_TILES
    assert spec.v_max <= 64 and len(spec.fitems) == len(spec.zgrp)


def test_two_term_columns():
    """The table format carries two terms per column.  No plan produces a
    second one (``test_zonal_coupling_has_one_term_per_column``), so split
    each term of a real table in two, c x[xo] = 0.25 c x[xo] + 0.75 c x[xo],
    rebuild the entry tables (a term becomes an entry of its own), and hold
    the emulations to the plain core."""
    plan = _plan(SMALL["mixed"])
    spec = zonal_kernel.ZonalKernelSpec(plan)
    spec.zsrc[:, 1] = spec.zsrc[:, 0]
    spec.zcoef[:, 1] = 0.75 * spec.zcoef[:, 0]
    spec.zcoef[:, 0] *= 0.25
    before = int(spec.xgrp[:, 2].sum())
    spec._build_stages()
    assert int(spec.xgrp[:, 2].sum()) == 2 * before
    _check_schedule(plan, spec, True, 13, lambda ref: dict(atol=2e-5, rtol=2e-5))


def _terms(spec):
    """The (record, x offset, coefficient) terms the entry tables build,
    one per (entry, sign) with a nonzero coefficient."""
    terms = []
    for (k, e0, n, *_r) in spec.stages:
        _b, d3, _V, _w, fan_in, rec, _col = spec.grp[k]
        L = (d3 - 1) // 2
        for j in range(e0, e0 + n):
            xp, xm, _wc, a = spec.ent_i[j]
            for s, (xo, cf) in enumerate(((xp, spec.ent_c[j, 0]), (xm, spec.ent_c[j, 1]))):
                if cf != 0.0:
                    m3 = L + a if s == 0 else L - a
                    terms.append((int(rec + m3 * fan_in + spec.ent_col[j]), int(xo), float(cf)))
    return terms


@pytest.mark.parametrize("name", sorted(SMALL) + sorted(BENCH_IN) + ["wide_out"])
def test_x_groups_cover_every_term_once(name):
    """The entry tables build every nonzero term of ``zcoef`` once and no
    zero term (at the bench plans 6,404 records at node, 3,202 at edge, 480
    at pair); each stage's x groups list its terms once, one x offset a
    group; its column groups list its real entries once; a column's entries
    lie in one stage; the reduce lists every went element of a real entry
    once."""
    case = SMALL.get(name) or ((WIDE_IN, "0e+1o+2e", WIDE_OUT) if name == "wide_out"
                               else (BENCH_IN[name], SH, BENCH_FEAT))
    spec = zonal_kernel.get_zonal_kernel_spec(_plan(case))
    want = sorted((int(r), int(spec.zsrc[r, t]), float(spec.zcoef[r, t]))
                  for r, t in zip(*np.nonzero(spec.zcoef)))
    assert sorted(_terms(spec)) == want
    if name in BENCH_IN:
        assert spec.records_built() == len(want) == {"node": 6404, "edge": 3202,
                                                     "pair": 480}[name]
        assert spec.records_built() == sum(n for n, _V in spec._live())
    assert int(spec.xgrp[:, 2].sum()) == len(want)
    assert np.array_equal(np.sort(spec.wcat_idx), np.arange(spec.plan.linear_numel))
    real = spec.ent_col >= 0
    assert np.all(spec.ent_c[~real] == 0)
    cap = zonal_kernel.STAGE_ENTRIES
    col_stage, n_went = {}, 0
    for si, (k, e0, n, seg_ofs, n_seg, cg_ofs, n_cg, xg_ofs, n_xg, _w0, cl_ofs, n_cl, xl_ofs,
             n_xl) in enumerate(spec.stages):
        assert 0 < n <= cap and n % 8 == 0
        # a stage's members are contiguous, bounded and start on a 16-byte
        # boundary (the edge pass copies them into shared memory in 16-byte
        # pieces)
        assert n_cl <= n and n_xl <= 2 * n and n_cg <= n and n_xg <= 2 * n
        assert cl_ofs % 4 == 0 and xl_ofs % 4 == 0 and (3 * xg_ofs) % 4 == 0 and e0 % 2 == 0
        assert cl_ofs + n_cl + 4 <= len(spec.clst) and xl_ofs + n_xl + 4 <= len(spec.xlst)
        cg, xg = spec.cgrp[cg_ofs : cg_ofs + n_cg], spec.xgrp[xg_ofs : xg_ofs + n_xg]
        assert n_cg == 0 or (cg[0, 2] == cl_ofs and cg[:, 3].sum() == n_cl)
        assert n_xg == 0 or (xg[0, 1] == xl_ofs and xg[:, 2].sum() == n_xl)
        segs = spec.segs[seg_ofs : seg_ofs + n_seg]
        assert segs[0][1] == 0 and all(s[1] + s[2] == t[1] for s, t in zip(segs, segs[1:]))
        assert segs[-1][1] + segs[-1][2] == n and (segs[:, 2] % 8 == 0).all()
        for (a, s0, ns) in segs:
            assert (spec.ent_i[e0 + s0 : e0 + s0 + ns, 3] == a).all()
        xo = spec.xgrp[xg_ofs : xg_ofs + n_xg, 0]
        assert len(set(xo.tolist())) == n_xg
        members = np.concatenate([spec.clst[lo : lo + c] for (_wc, _add, lo, c)
                                  in spec.cgrp[cg_ofs : cg_ofs + n_cg]] or [[]])
        assert sorted(members.tolist()) == np.nonzero(real[e0 : e0 + n])[0].tolist()
        for j in np.nonzero(real[e0 : e0 + n])[0]:
            assert col_stage.setdefault((int(k), int(spec.ent_col[e0 + j])), si) == si
        n_went += int(real[e0 : e0 + n].sum()) * int(spec.zgrp[k][2])
    assert len(set(spec.red_lst.tolist())) == len(spec.red_lst) == n_went


@pytest.mark.parametrize("name", sorted(BENCH_IN) + ["wide_out"])
def test_zonal_items_and_splits(name):
    """B3's work items cover every (|m3|, n8) output tile of every chunk
    once, each at most FWD_ITEM_N8 n8 tiles and FWD_ITEM_TILES tiles; the
    weight pass's items cover every entry of every stage segment once for
    every 32 V columns, at most 64 entries of one |m3| each, heaviest first;
    its edge splits give each the tiles of WCAT_WAVES waves where the edges
    allow, and no split is without a tile.  The wide plan (128x0e, 57x4e) takes several items of
    both kinds per chunk."""
    case = ((WIDE_IN, "0e+1o+2e", WIDE_OUT) if name == "wide_out"
            else (BENCH_IN[name], SH, BENCH_FEAT))
    spec = zonal_kernel.get_zonal_kernel_spec(_plan(case))
    seen = set()
    for k, t0, n8 in spec.fitems:
        d3, V = int(spec.zgrp[k][1]), int(spec.zgrp[k][2])
        na = (d3 + 1) // 2
        assert 1 <= n8 <= zonal_kernel.FWD_ITEM_N8 and na * n8 <= zonal_kernel.FWD_ITEM_TILES
        for t in range(t0, t0 + n8):
            for a in range(na):
                assert (k, a, t) not in seen
                seen.add((k, a, t))
    assert seen == {(k, a, t) for k, (_b, d3, V, *_r) in enumerate(spec.zgrp)
                    for a in range((d3 + 1) // 2) for t in range(-(-V // 8))}
    vb = 8 * tp_kernel.WCAT_ITEM_N8
    want = sorted((si, s0 + q, v0) for si, (k, _e0, _n, so, ns, *_r) in enumerate(spec.stages)
                  for (_a, s0, n) in spec.segs[so : so + ns]
                  for q in range(0, n, zonal_kernel.WCAT_ITEM_ENTRIES)
                  for v0 in range(0, int(spec.zgrp[k][2]), vb))
    assert sorted((int(si), int(q0), int(v0)) for si, q0, _n, v0 in spec.witems) == want
    for si, q0, nq, _v0 in spec.witems:
        e0 = spec.stages[si][1]
        assert 0 < nq <= zonal_kernel.WCAT_ITEM_ENTRIES
        assert len(set(spec.ent_i[e0 + q0 : e0 + q0 + nq, 3].tolist())) == 1
    cost = [nq * min(int(spec.zgrp[spec.stages[si][0]][2]) - v0, vb)
            for si, _q, nq, v0 in spec.witems]
    assert cost == sorted(cost, reverse=True)
    if name == "wide_out":
        assert len(spec.fitems) > len(spec.zgrp) and spec.v_max > vb
    for E, resident in ((19_968, 396), (19_968, 132), (333, 396), (5, 396)):
        n_tiles = -(-E // zonal_kernel.WCAT_TILE_EDGES)
        p = spec.wcat_splits(E, resident)
        assert 1 <= p <= n_tiles
        per = -(-n_tiles // p)
        assert p == -(-n_tiles // per)  # the last split has a tile
        # the tiles a split takes for WCAT_WAVES waves of resident blocks
        wanted = -(-tp_kernel.WCAT_WAVES * resident // len(spec.witems))
        assert per == -(-n_tiles // min(n_tiles, wanted))


def test_flops_and_bytes_count():
    plan = _plan((BENCH_IN["node"], SH, BENCH_FEAT))
    spec = zonal_kernel.get_zonal_kernel_spec(plan)
    lab = tp_kernel.get_spec(plan)
    flops, nbytes = spec.work(10, True)
    assert nbytes == 4 * (10 * (spec.d_in + spec.n_ch + spec.d_out) + plan.linear_numel)
    # 6,404 mid FMAs per edge in the edge frame: one term in each of the 6,404
    # (m3, column) records that are not structural zeros, of 12,628; the radial
    # scale and the Wcat product (209,536 FLOPs over all records) count those only
    assert spec._mid_terms() == 6404 and len(spec.zcoef) == 12628
    assert sum(n for n, _V in spec._live()) == 6404
    assert spec._wcat_flops() == 136288 < 209536 == sum(
        2 * d3 * fan_in * V for (_k, _b, d3, V, _w, fan_in) in spec.out_chunks)
    assert flops == 10 * (2 * 6404 + 6404 + 136288)
    assert spec.work(10, False)[0] == 10 * (2 * 6404 + 136288)
    assert flops < lab.work(10, True)[0] and spec.work(10, False)[0] < flops
    bflops, bbytes = spec.work_bwd(10, True)
    assert bbytes == 4 * (10 * (2 * spec.d_in + 2 * spec.n_ch + spec.d_out)
                          + 2 * plan.linear_numel)
    assert bflops == 10 * (4 * 6404 + 4 * 6404 + 2 * 136288)
    assert flops < bflops < lab.work_bwd(10, True)[0]
    for t, by in (spec.bound_ms(19968, True), spec.bound_bwd_ms(19968, True)):
        assert t > 0 and by == "bytes"
    # without radial weights the pair plan moves half the bytes and stays bytes-bound
    lite = zonal_kernel.get_zonal_kernel_spec(_plan((BENCH_IN["pair"], SH, BENCH_FEAT)))
    for (t, by), ms in ((lite.bound_ms(19968, False), 0.0111),
                        (lite.bound_bwd_ms(19968, False), 0.0134)):
        assert by == "bytes" and abs(t - ms) < 1e-4


@pytest.mark.parametrize("src", ["zonal_tp_fwd.cu", "zonal_tp_bwd.cu"])
def test_kernels_have_no_float_atomics(src):
    text = (Path(tp_kernel.CSRC) / src).read_text()
    assert not re.search(r"atomic\w*\s*\(|cuda::atomic", text)


def test_wrappers_take_plain_versions_on_cpu():
    plan = _plan(SMALL["tiny"])
    x, w, fw, gy = (_t(a) for a in _core_inputs(plan, 4, 7))
    before = {n: k.launches for n, k in tp_kernel.KERNELS.items()}
    out = zonal_kernel.zonal_core_forward(plan, x, w, fw)
    torch.testing.assert_close(out, zonal_tp.plain_zonal_core(plan, x, w, fw), rtol=0, atol=0)
    got = zonal_kernel.zonal_core_backward(plan, x, w, fw, gy)
    for a, b in zip(got, zonal_tp.plain_zonal_core_backward(plan, x, w, fw, gy)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert {n: k.launches for n, k in tp_kernel.KERNELS.items()} == before
    assert set(tp_kernel.KERNELS) == {"packed_tp_fwd", "packed_tp_bwd",
                                      "zonal_tp_fwd", "zonal_tp_bwd"}


# ----------------------------------------------------------------------
# engine switch
# ----------------------------------------------------------------------

def _tensors(seed=9, E=12):
    plan, _jplan, x, sh, w, fw = _case(seed=seed, E=E)
    return plan, _t(x), _t(sh), _t(w), _t(fw)


@pytest.mark.parametrize("engine,target", [
    (None, "tp_kernel.packed_tp_forward"), ("auto", "tp_kernel.packed_tp_forward"),
    ("pallas", "tp_kernel.packed_tp_forward"), ("zonal", "zonal_kernel.zonal_forward"),
    ("zonal-xla", "zonal_tp.zonal_apply"), ("xla", "packed_tp.plain_apply")])
def test_engine_switch_routes(monkeypatch, engine, target):
    plan, x, sh, w, fw = _tensors()
    if engine is None:
        monkeypatch.delenv("HAMGNN_TP_ENGINE", raising=False)
    else:
        monkeypatch.setenv("HAMGNN_TP_ENGINE", engine)
    mod, fn = target.split(".")
    module = {"tp_kernel": tp_kernel, "zonal_kernel": zonal_kernel,
              "zonal_tp": zonal_tp, "packed_tp": packed_tp}[mod]
    calls = []
    real = getattr(module, fn)
    monkeypatch.setattr(module, fn, lambda *a: calls.append(fn) or real(*a))
    out = plan(x, sh, w, fw)
    assert calls == [fn]
    ref = plain_apply(plan, x, sh, w, fw)
    assert float((out - ref).abs().max()) <= ENGINE_TOL * float(ref.abs().max())


def test_engine_switch_rejects_unknown_value(monkeypatch):
    plan, x, sh, w, fw = _tensors()
    monkeypatch.setenv("HAMGNN_TP_ENGINE", "zonal_pallas")
    with pytest.raises(ValueError, match="zonal-xla"):
        plan(x, sh, w, fw)


def test_zonal_on_cpu_equals_auto_on_cpu_within_the_engine_limit(monkeypatch):
    plan, x, sh, w, fw = _tensors(seed=10, E=40)
    outs = {}
    for eng in ("auto", "zonal"):
        monkeypatch.setenv("HAMGNN_TP_ENGINE", eng)
        outs[eng] = plan(x, sh, w, fw), plan(x, sh, None, fw)
    for a, b in zip(outs["zonal"], outs["auto"]):
        assert not torch.equal(a, b)
        assert float((a - b).abs().max()) <= ENGINE_TOL * float(b.abs().max())


# ----------------------------------------------------------------------
# whole model
# ----------------------------------------------------------------------

MODEL_CFG = {
    "representation_nets": {"HamGNN_pre": {
        "irreps_node_features": "8x0e+4x1o+2x2e", "irreps_edge_sh": "0e+1o+2e",
        "num_layers": 2, "num_radial": 8, "cutoff": 4.0, "radial_MLP": [8],
        "num_types": 16}},
    "output_nets": {"HamGNN_out": {"nao_max": 14}},
}
LOSSES = [{"metric": "mae", "prediction": "hamiltonian", "target": "hamiltonian",
           "loss_weight": 27.211},
          {"metric": "mse", "prediction": "hamiltonian", "target": "hamiltonian"}]
MODEL_GRAD_TOL = 5e-4


def _crystals(n=2, seed=0):
    rng = np.random.default_rng(seed)
    return [add_random_hamiltonian_targets(
        rng, make_crystal(rng, n_atoms=4 + i, cutoff=4.0), nao_max=14) for i in range(n)]


def _flat(params):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(params).items()}


def _torch_model(cfg, params):
    tm = t_cli.build_model(cfg)
    load_flax_params(tm, _flat(params["params"]))
    return tm


def _torch_grads(tm, tg):
    tm.zero_grad()
    t_losses(tm(tg), tg, LOSSES)[0].backward()
    return {n.replace(".", "/"): (np.zeros(tuple(p.shape), np.float32) if p.grad is None
                                  else p.grad.numpy().copy())
            for n, p in tm.named_parameters()}


def test_model_under_zonal_matches_jax_zonal_xla(monkeypatch):
    """One set of JAX parameters, carried across, gives the same outputs and
    parameter gradients under the zonal engine on both sides, and the same
    outputs as the default engine within the engine limit."""
    cfg = load_config(None, overrides=MODEL_CFG)
    crystals = _crystals()
    jm, jg = j_build(cfg), j_pad(crystals)
    params = init_params_on_cpu(jm, jg, 0)
    tm, tg = _torch_model(cfg, params), t_pad(crystals)
    keys = ["hamiltonian_on", "hamiltonian_off"]

    monkeypatch.setenv("HAMGNN_TP_ENGINE", "auto")
    with torch.inference_mode():
        t_auto = {k: tm(tg)[k].numpy() for k in keys}
    j_auto = jax.jit(jm.apply)(params, jg)

    monkeypatch.setenv("HAMGNN_TP_ENGINE", "zonal-xla")

    def loss_and_outputs(p):
        out = jm.apply(p, jg)
        return j_losses(out, jg, LOSSES)[0], {k: out[k] for k in keys}

    j_grads, j_out = jax.jit(jax.grad(loss_and_outputs, has_aux=True))(params)
    j_grads = _flat(j_grads["params"])

    monkeypatch.setenv("HAMGNN_TP_ENGINE", "zonal")
    before = {n: k.launches for n, k in tp_kernel.KERNELS.items()}
    with torch.inference_mode():
        t_out = {k: tm(tg)[k].numpy() for k in keys}
    grads = _torch_grads(tm, tg)
    assert {n: k.launches for n, k in tp_kernel.KERNELS.items()} == before

    for k in keys:
        np.testing.assert_allclose(t_out[k], np.asarray(j_out[k]), err_msg=k,
                                   atol=5e-5, rtol=1e-4)
        for a, b in ((t_out[k], t_auto[k]), (np.asarray(j_out[k]), np.asarray(j_auto[k]))):
            assert np.abs(a - b).max() <= ENGINE_TOL * np.abs(b).max(), k
        assert not np.array_equal(t_out[k], t_auto[k])  # the engine did change
    assert set(grads) == set(j_grads)
    for k in sorted(j_grads):
        a, b = grads[k].astype(np.float64), j_grads[k].astype(np.float64)
        assert np.isfinite(a).all(), k
        assert np.abs(a - b).max() <= MODEL_GRAD_TOL * np.abs(b).max(), k


# ----------------------------------------------------------------------
# the Wigner-D memo
# ----------------------------------------------------------------------

@pytest.fixture
def memo():
    zonal_tp.FRAME_MEMO.clear()
    start = zonal_tp.FRAME_MEMO.builds
    yield lambda: zonal_tp.FRAME_MEMO.builds - start
    zonal_tp.FRAME_MEMO.clear()


@pytest.mark.parametrize("checkpointing", [False, True])
def test_memo_builds_the_frames_once_per_forward(monkeypatch, memo, checkpointing):
    """The model's 2 * 4 + 1 pipelines share one edge set: one build for a
    forward, and none more for the backward's recompute under gradient
    checkpointing, whose gradients equal those without it."""
    monkeypatch.setenv("HAMGNN_TP_ENGINE", "zonal")
    cfg = load_config(None, overrides=MODEL_CFG)
    tg = t_pad(_crystals())

    def model(remat):
        cfg.setup.use_gradient_checkpointing = remat
        return init_weights(t_cli.build_model(cfg), 0)

    tm = model(checkpointing)
    assert tm.representation.use_gradient_checkpointing == checkpointing
    with torch.inference_mode():
        tm(tg)
    assert memo() == 1
    grads = _torch_grads(tm, tg)
    assert memo() == 2
    if checkpointing:
        plain = _torch_grads(model(False), tg)
        for k in plain:
            np.testing.assert_array_equal(grads[k], plain[k], err_msg=k)


def test_memo_follows_an_in_place_change_of_sh(memo):
    plan, x, sh, w, fw = _tensors(seed=11)
    a = zonal_tp.zonal_apply(plan, x, sh, w, fw)
    assert torch.equal(zonal_tp.zonal_apply(plan, x, sh, w, fw), a) and memo() == 1
    other = torch.tensor(np.array(j_sh(SH_LS, jnp.asarray(
        _directions(np.random.default_rng(12), sh.shape[0])[::-1].copy()), normalize=True)))
    sh.copy_(other)
    b = zonal_tp.zonal_apply(plan, x, sh, w, fw)
    assert memo() == 2
    zonal_tp.FRAME_MEMO.clear()
    torch.testing.assert_close(b, zonal_tp.zonal_apply(plan, x, other, w, fw), rtol=0, atol=0)
    ref = plain_apply(plan, x, other, w, fw)
    assert float((b - ref).abs().max()) <= ENGINE_TOL * float(ref.abs().max())


def test_memo_does_not_trust_an_inference_tensor_between_forwards(memo):
    """An ``sh`` made under ``inference_mode`` has no version counter, so an
    in-place change of it is invisible: its frames are reused only within
    ``one_forward()`` (where the model makes ``sh`` and leaves it alone) and
    never across two such spans or outside them."""
    plan, x, sh0, w, fw = _tensors(seed=16)
    other = torch.tensor(np.array(j_sh(SH_LS, jnp.asarray(
        _directions(np.random.default_rng(17), sh0.shape[0])[::-1].copy()), normalize=True)))
    with torch.inference_mode():
        sh = sh0.clone()
        assert sh.is_inference()
        a = zonal_tp.zonal_apply(plan, x, sh, w, fw)
        sh.copy_(other)
        b = zonal_tp.zonal_apply(plan, x, sh, w, fw)
        assert memo() == 2
        with zonal_tp.FRAME_MEMO.one_forward():
            c = zonal_tp.zonal_apply(plan, x, sh, w, fw)
            with zonal_tp.FRAME_MEMO.one_forward():  # spans nest
                zonal_tp.zonal_apply(plan, x, sh, w, fw)
            zonal_tp.zonal_apply(plan, x, sh, w, fw)
            assert memo() == 3
        assert zonal_tp.FRAME_MEMO.sh is None
        sh.copy_(sh0)
        with zonal_tp.FRAME_MEMO.one_forward():
            d = zonal_tp.zonal_apply(plan, x, sh, w, fw)
        assert memo() == 4
    torch.testing.assert_close(a, zonal_tp.zonal_apply(plan, x, sh0, w, fw), rtol=0, atol=0)
    torch.testing.assert_close(d, a, rtol=0, atol=0)
    torch.testing.assert_close(b, zonal_tp.zonal_apply(plan, x, other, w, fw), rtol=0, atol=0)
    torch.testing.assert_close(c, b, rtol=0, atol=0)
    assert not torch.equal(a, b)


def test_memo_span_keeps_the_frames_of_a_versioned_tensor(memo):
    """Leaving ``one_forward()`` drops only what cannot be checked later:
    the recompute of a checkpointed layer still finds its frames."""
    plan, x, sh, w, fw = _tensors(seed=18)
    with zonal_tp.FRAME_MEMO.one_forward():
        zonal_tp.zonal_apply(plan, x, sh, w, fw)
    assert zonal_tp.FRAME_MEMO.sh is sh
    zonal_tp.zonal_apply(plan, x, sh, w, fw)
    assert memo() == 1


def test_memo_filled_in_inference_mode_serves_a_later_backward(memo):
    """Frames built under ``inference_mode`` cannot be saved for a backward:
    an autograd call on the same ``sh`` builds its own."""
    plan, x, sh, w, fw = _tensors(seed=13)
    with torch.inference_mode():
        ref = zonal_tp.zonal_apply(plan, x, sh, w, fw)
        zonal_tp.zonal_apply(plan, x, sh, w, fw)
    assert memo() == 1
    x = x.clone().requires_grad_(True)
    out = zonal_tp.zonal_apply(plan, x, sh, w, fw)
    out.sum().backward()
    assert memo() == 2 and x.grad is not None
    torch.testing.assert_close(out.detach(), ref, rtol=0, atol=0)
    with torch.inference_mode():  # frames built outside serve inference mode
        zonal_tp.zonal_apply(plan, x, sh, w, fw)
    assert memo() == 2


def test_memo_serves_plans_of_lower_max_l(memo):
    plan, x, sh, w, fw = _tensors(seed=14)
    zonal_tp.zonal_apply(plan, x, sh, w, fw)
    low = get_plan(*[repr(Irreps(s)) for s in ("4x0e+2x1o", SH, "4x0e+2x1o", "4x0e+2x1o")])
    assert zonal_tp.get_zonal_spec(low).max_l_feat == 1
    rng = np.random.default_rng(15)
    xl = _t(rng.normal(size=(sh.shape[0], low.irreps_in.dim)).astype(np.float32))
    fwl = _t(rng.normal(size=(low.linear_numel,)).astype(np.float32))
    out = zonal_tp.zonal_apply(low, xl, sh, None, fwl)
    assert memo() == 1
    ref = plain_apply(low, xl, sh, None, fwl)
    assert float((out - ref).abs().max()) <= ENGINE_TOL * float(ref.abs().max())
