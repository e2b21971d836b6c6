"""Packed TP -> radial-scale -> Linear pipeline: static plan and plain version.

Frozen copy of ``hamgnn_tpu_torch/e3/packed_tp.py`` with its kernel dispatch
and precision modes taken out: the plan and the plain versions only, run in
blocks of edges.  Per input chunk g =
(mul, l1, p1), with C_g the coupling tensor in m3-major column order:

    W    = sh @ C_g                         (E, d1, K)
    mid  = sum_i W[:, i, :, None] * x_g[:, None, :, i]      (E, K * mul)
    mid *= w[:, packed channel]             (skipped when w is None)
    out += (E * d3, n_cols * mul) @ perm(flat_w) / sqrt(fan_in)   per ir3

``PackedTPPlan`` holds the channel/row permutations as numpy index arrays;
``plain_apply`` is the plain PyTorch version of the pipeline and
``plain_backward`` of its backward.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch

from .irreps import Irrep, Irreps
from .wigner import wigner_3j


# edges a block of the pipeline takes at a time, forward and backward: the
# plain version's intermediates of one block fit, those of a whole crystal
# at the published widths do not
EDGE_BLOCK = 2048


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
        """The pipeline in plain PyTorch, in blocks of ``EDGE_BLOCK`` edges,
        with the gradient of ``plain_backward``."""
        return BlockedPlainTP.apply(x, sh, weight, flat_w, self)

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


def coupling(plan: PackedTPPlan, sh):
    """Per input chunk its coupling entries W = sh @ C_g, (E, d1, K) (None
    for a chunk that couples to no target)."""
    coup, _perms = plan._tables(sh.device, sh.dtype)
    Ws = []
    for g, (_sl, _mul, d1, C, _groups) in enumerate(plan.per_chunk):
        if C.shape[-1] == 0:
            Ws.append(None)
            continue
        Ws.append((sh @ coup[g]).reshape(sh.shape[0], d1, C.shape[-1]))
    return Ws


def chunk_mids(plan: PackedTPPlan, x, Ws):
    """Per input chunk its mids, mid[e, k * mul + u] = sum_i W[e, i, k]
    x[e, g, u, i], (E, K * mul), from the coupling entries ``Ws``."""
    E = x.shape[0]
    mids = []
    for (sl, mul, d1, C, _groups), W in zip(plan.per_chunk, Ws):
        if W is None:
            mids.append(None)
            continue
        xc = x[:, sl].reshape(E, mul, d1)
        mid = None
        for i in range(d1):
            term = W[:, i, :, None] * xc[:, None, :, i]
            mid = term if mid is None else mid + term
        mids.append(mid.reshape(E, C.shape[-1] * mul))
    return mids


def _out_sources(plan: PackedTPPlan, k_out: int, like):
    """The sources of output chunk ``k_out``: (g, k0, k1, mul, ncm, radial-
    weight base, row permutation on the device of ``like``)."""
    _coup, perms = plan._tables(like.device, like.dtype)
    for (g, gi, _rp), row_perm in zip(plan.out_sources[k_out], perms[k_out]):
        _, mul, _, _, groups = plan.per_chunk[g]
        _ir3, n_cols, k0, k1 = groups[gi]
        yield g, k0, k1, mul, n_cols * mul, plan._grp_w_base[(g, gi)], row_perm


def out_stage(plan: PackedTPPlan, mids, weight, flat_w):
    """The radial scale and the Wcat product of the pipeline, from the
    chunks' mids: (E, d_out).  At least one chunk has mids."""
    E = next(m.shape[0] for m in mids if m is not None)
    out_chunks = []
    for k_out, mio in enumerate(plan.irreps_out):
        fan_in, ofs = plan.out_plans[k_out]
        if fan_in == 0:
            out_chunks.append(flat_w.new_zeros((E, mio.dim)))
            continue
        wblk = flat_w[ofs : ofs + fan_in * mio.mul].reshape(fan_in, mio.mul)
        scale = 1.0 / np.sqrt(fan_in)
        d3 = mio.ir.dim
        acc = None
        for g, k0, k1, mul, ncm, cb, row_perm in _out_sources(plan, k_out, flat_w):
            blk = mids[g][:, k0 * mul : k1 * mul].reshape(E, d3, ncm)
            if weight is not None:
                blk = blk * weight[:, None, cb : cb + ncm]
            y = blk.reshape(E * d3, ncm) @ (scale * wblk[row_perm])
            acc = y if acc is None else acc + y
        out_chunks.append(
            acc.reshape(E, d3, mio.mul).transpose(1, 2).reshape(E, mio.mul * d3))
    return torch.cat(out_chunks, dim=-1)


def out_stage_backward(plan: PackedTPPlan, mids, weight, flat_w, gout):
    """Backward of ``out_stage`` for the output gradient ``gout``: (d(mids)
    per chunk, dw or None, d(flat_w)): dWcat = BLKᵀ·gy and dBLK = gy·Wcatᵀ."""
    E = gout.shape[0]
    dmids = [None if m is None else torch.zeros_like(m) for m in mids]
    dw = None if weight is None else torch.zeros_like(weight)
    dflat = torch.zeros_like(flat_w)
    for k_out, (mio, sl) in enumerate(zip(plan.irreps_out, plan.irreps_out.slices())):
        fan_in, ofs = plan.out_plans[k_out]
        if fan_in == 0:
            continue
        V, d3 = mio.mul, mio.ir.dim
        wblk = flat_w[ofs : ofs + fan_in * V].reshape(fan_in, V)
        scale = 1.0 / np.sqrt(fan_in)
        gy = gout[:, sl].reshape(E, V, d3).transpose(1, 2).reshape(E * d3, V)
        dwblk = torch.zeros_like(wblk)
        for g, k0, k1, mul, ncm, cb, row_perm in _out_sources(plan, k_out, flat_w):
            blk = mids[g][:, k0 * mul : k1 * mul].reshape(E, d3, ncm)
            wsl = None if weight is None else weight[:, None, cb : cb + ncm]
            blk_s = blk if wsl is None else blk * wsl
            dwblk.index_add_(0, row_perm, (blk_s.reshape(E * d3, ncm).T @ gy) * scale)
            dblk = (gy @ (scale * wblk[row_perm]).T).reshape(E, d3, ncm)
            if wsl is not None:
                dw[:, cb : cb + ncm] += (dblk * blk).sum(dim=1)
                dblk = dblk * wsl
            dmids[g][:, k0 * mul : k1 * mul] += dblk.reshape(E, d3 * ncm)
        dflat[ofs : ofs + fan_in * V] = dwblk.reshape(-1)
    return dmids, dw, dflat


def plain_apply(plan: PackedTPPlan, x, sh, weight, flat_w):
    """The pipeline: x (E, d_in), sh (E, S), weight (E, n_ch) in packed
    order or None, flat_w (linear_numel,) -> (E, d_out)."""
    mids = chunk_mids(plan, x, coupling(plan, sh))
    if not any(m is not None for m in mids):
        return x.new_zeros((x.shape[0], plan.irreps_out.dim))
    return out_stage(plan, mids, weight, flat_w)


def plain_backward(plan: PackedTPPlan, x, sh, weight, flat_w, gout, need_dsh: bool = False):
    """The pipeline's backward for the output gradient ``gout`` (E, d_out),
    the mids recomputed from (x, sh): (dx, dsh or None, dw or None,
    d(flat_w))."""
    with torch.no_grad():
        E = x.shape[0]
        Ws = coupling(plan, sh)
        mids = chunk_mids(plan, x, Ws)
        dx = torch.zeros_like(x)
        dsh = torch.zeros_like(sh) if need_dsh else None
        if not any(m is not None for m in mids):
            return (dx, dsh, None if weight is None else torch.zeros_like(weight),
                    torch.zeros_like(flat_w))
        dmids, dw, dflat = out_stage_backward(plan, mids, weight, flat_w, gout)
        coup, _perms = plan._tables(x.device, x.dtype)
        for g, ((sl, mul, d1, C, _groups), W, dmid) in enumerate(
                zip(plan.per_chunk, Ws, dmids)):
            if W is None:
                continue
            K = C.shape[-1]
            xc = x[:, sl].reshape(E, mul, d1)
            dm = dmid.reshape(E, K, mul)
            dx[:, sl] = torch.einsum("eku,eik->eui", dm, W).reshape(E, mul * d1)
            if need_dsh:
                dsh += torch.einsum("eku,eui->eik", dm, xc).reshape(E, d1 * K) @ coup[g].T
    return dx, dsh, dw, dflat


class BlockedPlainTP(torch.autograd.Function):
    """``plain_apply`` forward and ``plain_backward`` backward, each over
    blocks of ``EDGE_BLOCK`` edges: only the inputs are kept for the
    backward, which recomputes a block's intermediates."""

    @staticmethod
    def forward(ctx, x, sh, w, flat_w, plan):
        ctx.plan = plan
        ctx.save_for_backward(x, sh, w, flat_w)
        return torch.cat([plain_apply(plan, x[a:a + EDGE_BLOCK], sh[a:a + EDGE_BLOCK],
                                      None if w is None else w[a:a + EDGE_BLOCK], flat_w)
                          for a in range(0, x.shape[0], EDGE_BLOCK)], dim=0)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        x, sh, w, flat_w = ctx.saved_tensors
        need_dsh = ctx.needs_input_grad[1]
        dx, dsh = torch.zeros_like(x), torch.zeros_like(sh) if need_dsh else None
        dw = None if w is None else torch.zeros_like(w)
        dflat = torch.zeros_like(flat_w)
        for a in range(0, x.shape[0], EDGE_BLOCK):
            b = slice(a, a + EDGE_BLOCK)
            bx, bsh, bw, bflat = plain_backward(ctx.plan, x[b], sh[b],
                                                None if w is None else w[b], flat_w,
                                                gout[b], need_dsh)
            dx[b] = bx
            if need_dsh:
                dsh[b] = bsh
            if dw is not None:
                dw[b] = bw
            dflat += bflat
        return dx, dsh, dw, dflat, None


@functools.lru_cache(maxsize=None)
def get_plan(irreps_in: str, irreps_sh: str, target_irreps: str,
             irreps_out: str) -> PackedTPPlan:
    return PackedTPPlan(irreps_in, irreps_sh, target_irreps, irreps_out)
