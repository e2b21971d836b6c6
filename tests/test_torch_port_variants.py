"""The TP engine's precision and schedule switches against the JAX package.

``HAMGNN_TP_BF16=bwd|all`` and ``HAMGNN_TP_STOREMID=1`` at the width of
tests/test_pallas_bwd_variants.py (FEAT ``8x0e+...+1x4e``, SH ``0e...4e``,
E = 200, inputs from ``numpy.default_rng(0)``), f32 on both sides; the JAX
kernels run in interpret mode, the port through its plain versions, each
switch set for both (JAX reads it at trace time: ``jax.clear_caches()``).

Tolerances, per output, of max|ref| (the JAX result):

* bf16 modes: every element within 1e-4, and all but 1% of them within
  1e-5 (fp32 order noise).  A bf16 product rounds its fp32 operands, and
  the JAX side's fp32 mids, built under jit, differ from the port's in the
  last bit now and then; an operand next to a bf16 rounding boundary then
  rounds to the other neighbour, one bf16 ulp (2^-8) of one product term.
  At this width 1 of 9,500 outputs (2.0e-5) and 0.3% of d(flat_w) (1.3e-5)
  differ so; dx, dsh and dw not at all (<= 5e-7).  Each mode must move the
  result from fp32: max|bf16 - fp32| of JAX's >= 100 x 1e-5 (measured
  2.6e-3 to 3.4e-3), and the port's own gap as large;
* ``bwd`` leaves the forward exact: the port's output under it equals its
  fp32 output bit for bit, as JAX's does;
* ``STOREMID=1``: within 1e-5 of JAX's run with the same switches, and the
  port's stored-mid backward bit-identical to its recompute (fp32 and
  ``all``);
* ``HAMGNN_TP_DX=merged`` (a TPU lane schedule, no kernel of its own on the
  card): the port's ``plain_backward`` within JAX's own 2e-5
  (tests/test_pallas_bwd_variants.py) of JAX's merged-dx gradients;
* a two-layer model (JAX weights carried by ``interfaces/jax_params.py``)
  under ``HAMGNN_TP_BF16=bwd``: the loss equal to JAX's under
  ``HAMGNN_TP_ENGINE=pallas`` within 1e-6 relative and to the port's fp32
  loss bit for bit, the parameter gradients within 1e-4 * max|ref| per
  tensor (measured below 4e-6).

The parsing of the switches and ``auto`` on CPU tensors (fp32, as JAX's
``auto`` off a TPU) are checked too.  The CUDA instantiations against these
plain versions run in test_torch_port_cuda.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hamgnn_tpu.cli import build_model as j_build
from hamgnn_tpu.data.graph import pad_and_batch as j_pad
from hamgnn_tpu.e3 import pallas_tp as ptp
from hamgnn_tpu.e3 import pallas_zonal as pz
from hamgnn_tpu.e3.packed_tp import get_plan as j_get_plan
from hamgnn_tpu.models.model import compute_losses as j_losses
from hamgnn_tpu.train.config import load_config
from hamgnn_tpu.train.trainer import init_params_on_cpu
from hamgnn_tpu_torch.data.graph import pad_and_batch as t_pad
from hamgnn_tpu_torch.e3 import packed_tp, tp_kernel, zonal_kernel, zonal_tp
from hamgnn_tpu_torch.e3.irreps import Irreps
from hamgnn_tpu_torch.e3.packed_tp import get_plan, plain_backward
from hamgnn_tpu_torch.models.model import compute_losses as t_losses
from test_torch_port_zonal import (LOSSES, MODEL_CFG, _crystals, _flat, _torch_grads,
                                   _torch_model)

FEAT = "8x0e+4x0o+6x1o+4x1e+4x2e+2x2o+1x3o+1x3e+1x4e"
SH = "0e + 1o + 2e + 3o + 4e"
E = 200
MAX_TOL = 1e-4      # every element, of max|ref|: fp32 noise and bf16 rounding-boundary flips
BULK_TOL = 1e-5     # all but BULK_SHARE of the elements, of max|ref|
BULK_SHARE = 0.01
GAP_MIN = 100 * BULK_TOL
STORE_TOL = 1e-5
MERGED_TOL = 2e-5
MODEL_LOSS_TOL = 1e-6
MODEL_GRAD_TOL = 1e-4
SWITCHES = ("HAMGNN_TP_BF16", "HAMGNN_TP_STOREMID", "HAMGNN_TP_DX", "HAMGNN_TP_ENGINE")
NAMES = ("out", "dx", "dsh", "dw", "dflat_w")
ZNAMES = ("out_rot", "dx_rot", "dw", "dflat_w")


def _set(**env):
    """Set the switches (the others unset) and drop JAX's traces, which
    read them at trace time."""
    for k in SWITCHES:
        os.environ.pop(k, None)
    for k, v in env.items():
        os.environ[k] = v
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _clean_switches():
    saved = {k: os.environ.get(k) for k in SWITCHES}
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    jax.clear_caches()


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    tplan = get_plan(*(repr(Irreps(s)) for s in (FEAT, SH, FEAT, FEAT)))
    jplan = j_get_plan(FEAT, SH, FEAT, FEAT)
    d = Irreps(FEAT).dim
    arrs = [rng.normal(size=s).astype(np.float32) for s in
            ((E, d), (E, 25), (E, tplan.weight_numel), (tplan.linear_numel,), (E, d))]
    return tplan, jplan, arrs


_JAX = {}


def _jax_pipeline(jplan, arrs, needs_dsh=True, **env):
    """JAX's interpret-mode B1/B2 under the switches, jitted: (out, dx, dsh,
    dw, d(flat_w)) of the output gradient (dsh None without ``needs_dsh``),
    cached per setting."""
    key = ("lab", needs_dsh) + tuple(sorted(env.items()))
    if key not in _JAX:
        _set(**env)
        x, sh, w, fw, gy = (jnp.asarray(a) for a in arrs)

        def run(x, sh, w, fw, gy):
            f = lambda x, sh, w, fw: ptp.pallas_apply(  # noqa: E731
                jplan, x, sh, w, fw, interpret=True, sh_needs_grad=needs_dsh)
            out, vjp = jax.vjp(f, x, sh, w, fw)
            return (out, *vjp(gy))

        res = [np.asarray(a) for a in jax.jit(run)(x, sh, w, fw, gy)]
        if not needs_dsh:
            res[2] = None
        _JAX[key] = res
    return _JAX[key]


def _jax_zonal_core(jplan, arrs, **env):
    """JAX's interpret-mode B3/B4 between the rotations (``_zpipeline`` on
    the rotated x, here the inputs themselves): (out_rot, dx_rot, dw,
    d(flat_w)), in the plans' u-major layouts."""
    key = ("zonal",) + tuple(sorted(env.items()))
    if key not in _JAX:
        _set(**env)
        spec = pz._get_zspec(jplan.key)
        x, _sh, w, fw, gy = (jnp.asarray(a) for a in arrs)

        def core(xr, ww, ff):
            x_m = jnp.take(xr, jnp.asarray(spec.x_perm), axis=-1)
            out = pz._zpipeline(jplan.key, True, True, x_m, ww, spec.build_wcat(ff))
            return jnp.take(out, jnp.asarray(spec.out_deint), axis=-1)

        def run(x, w, fw, gy):
            out, vjp = jax.vjp(core, x, w, fw)
            return (out, *vjp(gy))

        _JAX[key] = [np.asarray(a) for a in jax.jit(run)(x, w, fw, gy)]
    return _JAX[key]


def _port_pipeline(tplan, arrs, bf16="", storemid=False):
    """The port's lab-frame pipeline on CPU tensors through autograd (the
    plain versions of B1/B2 under the modes): (out, dx, dsh, dw, d(flat_w))."""
    x, sh, w, fw, gy = (torch.as_tensor(a).requires_grad_(i < 4) for i, a in enumerate(arrs))
    out = tp_kernel.packed_tp_forward(tplan, x, sh, w, fw, bf16, storemid)
    grads = torch.autograd.grad(out, (x, sh, w, fw), gy)
    return [out.detach().numpy()] + [g.numpy() for g in grads]


def _port_zonal_core(tplan, arrs, bf16=""):
    x, _sh, w, fw, gy = (torch.as_tensor(a) for a in arrs)
    x, w, fw = (t.requires_grad_(True) for t in (x, w, fw))
    out = zonal_kernel.zonal_core_forward(tplan, x, w, fw, bf16)
    grads = torch.autograd.grad(out, (x, w, fw), gy)
    return [out.detach().numpy()] + [g.numpy() for g in grads]


def _rel(a, b):
    return float(np.abs(np.asarray(a, np.float64) - b).max() / np.abs(b).max())


def _assert_bf16_close(got, ref, names):
    for name, a, b in zip(names, got, ref):
        d = np.abs(a.astype(np.float64) - b) / np.abs(b).max()
        assert d.max() <= MAX_TOL, (name, d.max())
        assert np.mean(d > BULK_TOL) <= BULK_SHARE, (name, np.mean(d > BULK_TOL))


# ----------------------------------------------------------------------
# switches
# ----------------------------------------------------------------------

@pytest.mark.parametrize("value,mode", [("", ""), ("bwd", "bwd"), ("ALL", "all"), ("All", "all"),
                                        ("fp32", ""), ("bf16", ""), ("1", "")])
def test_bf16_mode_parses_as_jax(value, mode):
    _set(HAMGNN_TP_BF16=value)
    assert packed_tp.bf16_mode() == mode == ptp._bf16_mode()


@pytest.mark.parametrize("value", ["", "1", "0", "true", "yes"])
def test_storemid_parses_as_jax(value):
    _set(HAMGNN_TP_STOREMID=value)
    assert packed_tp.storemid() is ptp._storemid() is (value == "1")


@pytest.mark.parametrize("engine,rounds", [("auto", False), ("xla", False), ("zonal-xla", False),
                                           ("pallas", True), ("zonal", True)])
def test_engines_on_cpu_take_the_modes_as_jax_does(case, engine, rounds):
    """``pallas`` and ``zonal`` round on CPU tensors, as JAX's interpret mode
    does; ``auto`` (JAX's ``auto`` off a TPU is its XLA path), ``xla`` and
    ``zonal-xla`` stay fp32."""
    tplan, _jplan, arrs = case
    x, sh, w, fw = (torch.as_tensor(a) for a in arrs[:4])
    _set(HAMGNN_TP_ENGINE=engine)
    ref = tplan(x, sh, w, fw)
    _set(HAMGNN_TP_ENGINE=engine, HAMGNN_TP_BF16="all", HAMGNN_TP_STOREMID="1")
    out = tplan(x, sh, w, fw)
    if rounds:
        assert _rel(out.numpy(), ref.numpy()) >= GAP_MIN
    else:
        assert torch.equal(out, ref)


# ----------------------------------------------------------------------
# the lab-frame pair (B1/B2) and the zonal core (B3/B4) under bf16
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["all", "bwd"])
def test_lab_frame_bf16_matches_jax_interpret(case, mode):
    tplan, jplan, arrs = case
    ref = _jax_pipeline(jplan, arrs, HAMGNN_TP_BF16=mode)
    got32 = _port_pipeline(tplan, arrs)   # JAX's fp32 result within 2e-6
    got = _port_pipeline(tplan, arrs, mode)
    _assert_bf16_close(got, ref, NAMES)
    for i, name in enumerate(NAMES):
        if name == "out" and mode == "bwd":   # the forward stays exact fp32
            assert np.array_equal(got[i], got32[i]) and _rel(ref[i], got32[i]) <= BULK_TOL
            continue
        assert _rel(ref[i], got32[i]) >= GAP_MIN, name
        assert _rel(got[i], got32[i]) >= GAP_MIN, name


@pytest.mark.parametrize("mode", ["all", "bwd"])
def test_zonal_core_bf16_matches_jax_interpret(case, mode):
    tplan, jplan, arrs = case
    ref = _jax_zonal_core(jplan, arrs, HAMGNN_TP_BF16=mode)
    got32 = _port_zonal_core(tplan, arrs)
    got = _port_zonal_core(tplan, arrs, mode)
    _assert_bf16_close(got, ref, ZNAMES)
    for i, name in enumerate(ZNAMES):
        if name == "out_rot" and mode == "bwd":
            assert np.array_equal(got[i], got32[i]) and _rel(ref[i], got32[i]) <= BULK_TOL
            continue
        assert _rel(ref[i], got32[i]) >= GAP_MIN, name
        assert _rel(got[i], got32[i]) >= GAP_MIN, name


def test_zonal_engine_on_cpu_rounds_only_the_core(case):
    """Under ``zonal`` the rotations stay fp32: the engine's output equals
    the rotations around the bf16 plain core."""
    tplan, _jplan, arrs = case
    x, sh, w, fw = (torch.as_tensor(a) for a in arrs[:4])
    _set(HAMGNN_TP_ENGINE="zonal", HAMGNN_TP_BF16="all")
    out = tplan(x, sh, w, fw)
    Ds = zonal_tp.edge_frames(zonal_tp.get_zonal_spec(tplan), sh)
    core = zonal_tp.plain_zonal_core(tplan, zonal_tp.rotate_in(tplan, x, Ds), w, fw, True)
    assert torch.equal(out, zonal_tp.rotate_out(tplan, core, Ds))


# ----------------------------------------------------------------------
# stored mids
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["", "bwd"])
def test_storemid_matches_jax(case, mode):
    tplan, jplan, arrs = case
    env = {"HAMGNN_TP_STOREMID": "1", **({"HAMGNN_TP_BF16": mode} if mode else {})}
    ref = _jax_pipeline(jplan, arrs, **env)
    got = _port_pipeline(tplan, arrs, mode, storemid=True)
    if mode:
        _assert_bf16_close(got, ref, NAMES)
    else:
        for name, a, b in zip(NAMES, got, ref):
            assert _rel(a, b) <= STORE_TOL, name
    if mode == "bwd":
        # the backward reads the forward's fp32 mids, where the recompute
        # takes bf16 coupling entries: a different dw and d(flat_w)
        recompute = _port_pipeline(tplan, arrs, mode)
        assert not np.array_equal(got[3], recompute[3])
        jrec = _jax_pipeline(jplan, arrs, HAMGNN_TP_BF16=mode)
        assert not np.array_equal(ref[3], jrec[3])


@pytest.mark.parametrize("bf16", [False, True])
def test_stored_mids_are_the_recomputed_ones_bit_for_bit(case, bf16):
    tplan, _jplan, arrs = case
    x, sh, w, fw, gy = (torch.as_tensor(a) for a in arrs)
    out, mids = tp_kernel.packed_tp_store_forward(tplan, x, sh, w, fw, bf16)
    ofs, midw = packed_tp.mid_offsets(tplan)
    assert mids.shape == (E, midw)
    assert torch.equal(out, packed_tp.plain_apply(tplan, x, sh, w, fw, bf16))
    for need_dsh in (False, True):
        stored = tp_kernel.packed_tp_backward(tplan, x, sh, w, fw, gy, need_dsh, bf16, mids)
        again = plain_backward(tplan, x, sh, w, fw, gy, need_dsh, bf16)
        for a, b in zip(stored, again):
            assert (a is None and b is None) or torch.equal(a, b)


def test_stored_mid_layout_is_jaxs(case):
    tplan, jplan, _arrs = case
    spec = ptp.PallasSpec(jplan)
    ofs, midw = packed_tp.mid_offsets(tplan)
    assert midw == spec.midw and [int(o) for o in spec.mid_ofs] == ofs
    kspec = tp_kernel.get_spec(tplan)
    assert kspec.midw == midw and len(kspec.mcols) == len(kspec.fcols)


# ----------------------------------------------------------------------
# DX=merged: a TPU schedule whose function the port's backward already is
# ----------------------------------------------------------------------

def test_plain_backward_matches_jax_merged_dx(case):
    """JAX takes the merged dx schedule only where no dsh is asked for."""
    tplan, jplan, arrs = case
    ref = _jax_pipeline(jplan, arrs, needs_dsh=False, HAMGNN_TP_DX="merged")
    x, sh, w, fw, gy = (torch.as_tensor(a) for a in arrs)
    got = plain_backward(tplan, x, sh, w, fw, gy, False)
    assert got[1] is None
    for name, a, b in zip(NAMES[1:], got, ref[1:]):
        if b is not None:
            assert _rel(a.numpy(), b) <= MERGED_TOL, name


# ----------------------------------------------------------------------
# a model step under HAMGNN_TP_BF16=bwd
# ----------------------------------------------------------------------

def test_model_step_under_bf16_bwd_matches_jax_pallas():
    cfg = load_config(None, overrides=MODEL_CFG)
    crystals = _crystals()
    jm, jg = j_build(cfg), j_pad(crystals)
    params = init_params_on_cpu(jm, jg, 0)
    tm, tg = _torch_model(cfg, params), t_pad(crystals)

    def loss(p):
        return j_losses(jm.apply(p, jg), jg, LOSSES)[0]

    _set(HAMGNN_TP_ENGINE="pallas", HAMGNN_TP_BF16="bwd")
    j_loss, j_grads = jax.jit(jax.value_and_grad(loss))(params)
    j_grads = _flat(j_grads["params"])

    _set(HAMGNN_TP_ENGINE="pallas")
    t_loss32 = t_losses(tm(tg), tg, LOSSES)[0].detach()
    grads32 = _torch_grads(tm, tg)
    _set(HAMGNN_TP_ENGINE="pallas", HAMGNN_TP_BF16="bwd")
    t_loss = t_losses(tm(tg), tg, LOSSES)[0].detach()
    grads = _torch_grads(tm, tg)

    assert torch.equal(t_loss, t_loss32)
    assert abs(float(t_loss) - float(j_loss)) <= MODEL_LOSS_TOL * abs(float(j_loss))
    assert set(grads) == set(j_grads)
    moved = 0.0
    for k in sorted(j_grads):
        a, b = grads[k].astype(np.float64), j_grads[k].astype(np.float64)
        assert np.isfinite(a).all(), k
        assert np.abs(a - b).max() <= MODEL_GRAD_TOL * np.abs(b).max(), k
        moved = max(moved, np.abs(a - grads32[k]).max() / np.abs(b).max())
    assert moved >= 10 * MODEL_GRAD_TOL
