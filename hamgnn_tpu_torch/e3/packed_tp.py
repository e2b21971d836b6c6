"""Packed TP -> radial-scale -> Linear pipeline: static plan and plain version.

Counterpart of ``hamgnn_tpu/e3/packed_tp.py``.  Per input chunk g =
(mul, l1, p1), with C_g the coupling tensor in m3-major column order:

    W    = sh @ C_g                         (E, d1, K)
    mid  = sum_i W[:, i, :, None] * x_g[:, None, :, i]      (E, K * mul)
    mid *= w[:, packed channel]             (skipped when w is None)
    out += (E * d3, n_cols * mul) @ perm(flat_w) / sqrt(fan_in)   per ir3

``PackedTPPlan`` holds the channel/row permutations as numpy index arrays,
identical to the reference's; ``plain_apply`` is the plain PyTorch version of
the pipeline and ``plain_backward`` of its backward, the oracles of the
Hopper kernels in ``tp_kernel.py``.  ``PackedTPPlan.__call__`` dispatches to
those, or to the edge-frame engine (``zonal_kernel.py``, ``zonal_tp.py``) on
request.
"""

from __future__ import annotations

import functools
import os
from typing import List, Tuple

import numpy as np
import torch

from .irreps import Irrep, Irreps
from .wigner import wigner_3j


# the values of HAMGNN_TP_ENGINE (see ``PackedTPPlan.__call__``)
TP_ENGINES = ("auto", "pallas", "zonal", "zonal-xla", "xla")


@functools.lru_cache(maxsize=None)
def _packed_coupling(l1: int, p1: int, sh_key: Tuple[Tuple[int, int], ...],
                     target_key: Tuple[Tuple[int, int], ...]):
    """Coupling tensor (S, d1, K) with m3-major column order per ir3 group:
    column k0 + m3 * n_cols + j holds path j.  Returns (C, groups) with groups
    of (ir3, n_cols, k0, k1)."""
    sh_irreps = [Irrep(l, p) for l, p in sh_key]
    target_set = set(Irrep(l, p) for l, p in target_key)

    S = sum(ir.dim for ir in sh_irreps)
    cols: List[Tuple[int, Irrep, int]] = []  # (sh offset j0, ir3, l2)
    j0 = 0
    for ir_sh in sh_irreps:
        for ir3 in Irrep(l1, p1) * ir_sh:
            if ir3 in target_set:
                cols.append((j0, ir3, ir_sh.l))
        j0 += ir_sh.dim
    cols.sort(key=lambda t: t[1])

    d1 = 2 * l1 + 1
    groups: List[Tuple[Irrep, List[Tuple[int, int]]]] = []
    for j0, ir3, l2 in cols:
        if groups and groups[-1][0] == ir3:
            groups[-1][1].append((j0, l2))
        else:
            groups.append((ir3, [(j0, l2)]))

    K = sum(ir3.dim * len(paths) for ir3, paths in groups)
    C = np.zeros((S, d1, K))
    out_groups = []
    k0 = 0
    for ir3, paths in groups:
        n_cols = len(paths)
        d3 = ir3.dim
        for j, (j0, l2) in enumerate(paths):
            w = wigner_3j(l1, l2, ir3.l) * np.sqrt(d3)  # (d1, 2l2+1, d3)
            for m3 in range(d3):
                C[j0 : j0 + 2 * l2 + 1, :, k0 + m3 * n_cols + j] = w[:, :, m3].T
        out_groups.append((ir3, n_cols, k0, k0 + n_cols * d3))
        k0 += n_cols * d3
    return np.ascontiguousarray(C), tuple(out_groups)


class PackedTPPlan:
    """Static plan for one TP -> scale -> Linear pipeline.

    ``per_chunk``: per input chunk (slice, mul, d1, C, groups);
    ``scale_perm``: packed radial-weight position -> chunked channel;
    ``out_plans``: per output chunk (fan_in, flat-weight offset);
    ``out_sources``: per output chunk [(g, group, flat-weight row perm)];
    ``_grp_w_base``: (g, group) -> offset of its span in the packed weights.
    """

    def __init__(self, irreps_in, irreps_sh, target_irreps, irreps_out):
        irreps_in = Irreps(irreps_in)
        irreps_sh_ = Irreps(irreps_sh)
        target = Irreps(target_irreps)
        irreps_out = Irreps(irreps_out)
        sh_key = tuple((mi.ir.l, mi.ir.p) for mi in irreps_sh_)
        t_key = tuple((mi.ir.l, mi.ir.p) for mi in target)

        self.irreps_in = irreps_in
        self.irreps_sh = irreps_sh_
        self.irreps_out = irreps_out
        self.key = (repr(irreps_in), repr(irreps_sh_), repr(target),
                    repr(irreps_out))

        # mid channels in chunk order: per (g, group), (mul_g * n_cols)
        # channels (u-major, path-minor)
        self.per_chunk = []
        n_ch = 0
        row_count: dict = {}
        chunk_meta = []  # (g, grp_idx, ir3, n_cols, mul, ch_base, row_base)
        for sl, mi in zip(irreps_in.slices(), irreps_in):
            C, groups = _packed_coupling(mi.ir.l, mi.ir.p, sh_key, t_key)
            self.per_chunk.append((sl, mi.mul, mi.ir.dim, C, groups))
            for gi, (ir3, n_cols, k0, k1) in enumerate(groups):
                rb = row_count.get(ir3, 0)
                chunk_meta.append((len(self.per_chunk) - 1, gi, ir3, n_cols,
                                   mi.mul, n_ch, rb))
                n_ch += mi.mul * n_cols
                row_count[ir3] = rb + mi.mul * n_cols
        self.weight_numel = n_ch

        # packed radial-weight order: groups out-chunk-major (first use),
        # (path-major, u-minor) inside; scale_perm[packed] = chunked channel
        packed_base = {}
        pos = 0
        for mio in irreps_out:
            for (g, gi, ir3, n_cols, mul, ch_base, rb) in chunk_meta:
                if ir3 != mio.ir or (g, gi) in packed_base:
                    continue
                packed_base[(g, gi)] = pos
                pos += n_cols * mul
        for (g, gi, ir3, n_cols, mul, ch_base, rb) in chunk_meta:
            if (g, gi) not in packed_base:
                packed_base[(g, gi)] = pos
                pos += n_cols * mul
        perm = np.zeros(n_ch, np.int32)
        for (g, gi, ir3, n_cols, mul, ch_base, rb) in chunk_meta:
            pb = packed_base[(g, gi)]
            j_idx = np.repeat(np.arange(n_cols), mul)
            u_idx = np.tile(np.arange(mul), n_cols)
            perm[pb : pb + n_cols * mul] = ch_base + u_idx * n_cols + j_idx
        self.scale_perm = perm
        self._grp_w_base = packed_base

        # equivariant Linear over mid.simplify(): per output chunk a
        # (fan_in, mul_out) block of one flat weight
        plans = []
        total = 0
        for mio in irreps_out:
            fan_in = row_count.get(mio.ir, 0)
            plans.append((fan_in, total))
            total += fan_in * mio.mul
        self.out_plans = plans
        self.linear_numel = total

        self.out_sources = []
        for mio in irreps_out:
            srcs = []
            for (g, gi, ir3, n_cols, mul, ch_base, rb) in chunk_meta:
                if ir3 != mio.ir:
                    continue
                j_idx = np.repeat(np.arange(n_cols), mul)
                u_idx = np.tile(np.arange(mul), n_cols)
                row_perm = rb + u_idx * n_cols + j_idx
                srcs.append((g, gi, row_perm.astype(np.int32)))
            self.out_sources.append(srcs)
        self._device_tables = {}

    def __call__(self, x, sh, weight, flat_w):
        """Apply the pipeline; ``weight`` is in packed order (``scale_perm``)
        or None.  The engine is read from ``HAMGNN_TP_ENGINE`` at call time,
        with the JAX package's values:

        * unset, ``auto`` or ``pallas``: the lab-frame Hopper kernels on CUDA
          tensors, ``plain_apply`` on CPU tensors;
        * ``zonal``: the edge-frame engine (``zonal_kernel.zonal_forward``:
          its Hopper kernels on CUDA tensors, ``zonal_apply`` on CPU tensors);
        * ``zonal-xla``: ``zonal_tp.zonal_apply``, plain PyTorch on any device;
        * ``xla``: ``plain_apply``, plain PyTorch on any device.
        """
        eng = os.environ.get("HAMGNN_TP_ENGINE", "auto")
        if eng in ("auto", "pallas"):
            from . import tp_kernel

            return tp_kernel.packed_tp_forward(self, x, sh, weight, flat_w)
        if eng == "zonal":
            from . import zonal_kernel

            return zonal_kernel.zonal_forward(self, x, sh, weight, flat_w)
        if eng == "zonal-xla":
            from . import zonal_tp

            return zonal_tp.zonal_apply(self, x, sh, weight, flat_w)
        if eng == "xla":
            return plain_apply(self, x, sh, weight, flat_w)
        raise ValueError(f"HAMGNN_TP_ENGINE={eng!r}: expected one of {TP_ENGINES}")

    def _tables(self, device, dtype=torch.float32):
        """Coupling matrices (in ``dtype``) and row permutations as tensors on
        ``device`` (made outside inference mode: the cache also serves
        autograd)."""
        key = (str(device), dtype)
        if key not in self._device_tables:
            with torch.inference_mode(False):
                coup = [None if C.shape[-1] == 0 else torch.as_tensor(
                            C.reshape(C.shape[0], -1), dtype=dtype, device=device)
                        for (_sl, _mul, _d1, C, _groups) in self.per_chunk]
                perms = [[torch.as_tensor(rp, dtype=torch.long, device=device)
                          for (_g, _gi, rp) in srcs] for srcs in self.out_sources]
            self._device_tables[key] = (coup, perms)
        return self._device_tables[key]


def plain_apply(plan: PackedTPPlan, x, sh, weight, flat_w):
    """Plain PyTorch version of the pipeline (``PackedTPPlan._apply``).

    x (E, d_in), sh (E, S), weight (E, n_ch) in packed order or None,
    flat_w (linear_numel,) -> (E, d_out), all float32 (or all float64).
    """
    E = x.shape[0]
    coup, perms = plan._tables(x.device, x.dtype)
    mids = []
    for g, (sl, mul, d1, C, groups) in enumerate(plan.per_chunk):
        K = C.shape[-1]
        if K == 0:
            mids.append(None)
            continue
        xc = x[:, sl].reshape(E, mul, d1)
        W = (sh @ coup[g]).reshape(E, d1, K)
        mid = None
        for i in range(d1):
            term = W[:, i, :, None] * xc[:, None, :, i]
            mid = term if mid is None else mid + term
        mids.append(mid.reshape(E, K * mul))

    out_chunks = []
    for k_out, mio in enumerate(plan.irreps_out):
        fan_in, ofs = plan.out_plans[k_out]
        if fan_in == 0:
            out_chunks.append(x.new_zeros((E, mio.dim)))
            continue
        wblk = flat_w[ofs : ofs + fan_in * mio.mul].reshape(fan_in, mio.mul)
        scale = 1.0 / np.sqrt(fan_in)
        d3 = mio.ir.dim
        acc = None
        for (g, gi, _rp), row_perm in zip(plan.out_sources[k_out], perms[k_out]):
            _, mul, _, _, groups = plan.per_chunk[g]
            ir3, n_cols, k0, k1 = groups[gi]
            ncm = n_cols * mul
            blk = mids[g][:, k0 * mul : k1 * mul].reshape(E, d3, ncm)
            if weight is not None:
                cb = plan._grp_w_base[(g, gi)]
                blk = blk * weight[:, None, cb : cb + ncm]
            y = blk.reshape(E * d3, ncm) @ (scale * wblk[row_perm])
            acc = y if acc is None else acc + y
        out_chunks.append(
            acc.reshape(E, d3, mio.mul).transpose(1, 2).reshape(E, mio.mul * d3))
    return torch.cat(out_chunks, dim=-1)


def plain_backward(plan: PackedTPPlan, x, sh, weight, flat_w, gout,
                   need_dsh: bool = False):
    """Plain version of the pipeline's backward (the custom VJP of
    ``pallas_tp._pipeline``): autograd through ``plain_apply``.

    Returns (dx, dsh or None, dw or None, d(flat_w)) for the output gradient
    ``gout`` (E, d_out); dsh only with ``need_dsh``, dw only with weights."""
    with torch.enable_grad():
        x_, sh_, fw_ = (t.detach().requires_grad_(True) for t in (x, sh, flat_w))
        w_ = None if weight is None else weight.detach().requires_grad_(True)
        inputs = [t for t in (x_, sh_, w_, fw_) if t is not None]
        grads = torch.autograd.grad(plain_apply(plan, x_, sh_, w_, fw_), inputs,
                                    gout, allow_unused=True, materialize_grads=True)
    dx, dsh = grads[0], grads[1]
    dw = grads[2] if weight is not None else None
    return dx, (dsh if need_dsh else None), dw, grads[-1]


@functools.lru_cache(maxsize=None)
def get_plan(irreps_in: str, irreps_sh: str, target_irreps: str,
             irreps_out: str) -> PackedTPPlan:
    return PackedTPPlan(irreps_in, irreps_sh, target_irreps, irreps_out)
