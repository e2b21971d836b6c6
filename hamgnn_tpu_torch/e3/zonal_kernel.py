"""Hopper kernels for the zonal (edge-frame) engine of the packed pipeline.

``zonal_core_forward`` is the wrapper of ``csrc/zonal_tp_fwd.cu``, the port
of the TPU kernel ``hamgnn_tpu/e3/pallas_zonal.py`` ``_zfwd_call``;
``zonal_core_backward`` the wrapper of ``csrc/zonal_tp_bwd.cu``, the port of
``_zbwd_call``.  ``ZonalTP`` ties them together as one
``torch.autograd.Function`` (the port of the custom VJP ``_zpipeline``), and
``zonal_forward`` is the engine (``zonal_pallas_apply``): the rotations into
and out of the edge frame as plain PyTorch products under autograd, the
kernels between them.  On CPU tensors the wrappers run the plain versions
(``zonal_tp.plain_zonal_core``, ``plain_zonal_core_backward``,
``zonal_apply``); on CUDA tensors they launch the kernels or raise.

``ZonalKernelSpec`` is the kernels' host-side schedule, rebuilt from the
reference's ``ZonalPallasSpec`` for the GPU.  In the edge frame about half
of a chunk's (m3, column) records are structural zeros, and a live record
has one term, a scaled gather ``c * x_rot[e, xo] * w[e, wc]``.  The live
set of row +|m3| is that of -|m3|, so the kernels work on *entries*: one
live column of one |m3| with its two records (+|m3| and -|m3|; one for
m3 = 0), which share the radial weight and the Wcat row.  An m16 row tile
of the products is (sign of m3, edge) over 8 edges.  Each chunk's entries
are cut into stages (a range of its columns, at most ``STAGE_ENTRIES``
entries, |m3|-major, each |m3| segment padded to 8), so that a column's
entries lie in one stage.  ``went`` is Wcat in entry order (row per entry),
gathered from the flat Linear weight, so a stage's Wcat rows are one
contiguous block.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import zonal_tp
from .packed_tp import PackedTPPlan, get_plan
from .tp_kernel import (WCAT_ITEM_N8, WCAT_WAVES, ZONAL_TP_BWD, ZONAL_TP_FWD, PipelineSpec,
                        _check, _device_kind, _modes, _smem_limit, append_groups, variant)

# edges per tile: an m16 row tile of the products is (sign of m3, edge)
ZONAL_TILE_EDGES = 8
# entries of a stage (zonal_tp_fwd.cu / zonal_tp_bwd.cu CAP)
STAGE_ENTRIES = 128
# (|m3|, n8) output tiles and n8 tiles of V of a forward work item (8 warps
# of at most 4 tiles each)
FWD_ITEM_TILES = 32
FWD_ITEM_N8 = 8
# entries of a weight-pass work item (4 m16 tiles); its V columns are
# 8 * WCAT_ITEM_N8, as in the lab-frame weight pass; edges of its steps
WCAT_ITEM_ENTRIES = 64
WCAT_TILE_EDGES = 16


def _round8(n: int) -> int:
    return -(-n // 8) * 8


class ZonalKernelSpec(PipelineSpec):
    """Tables of one plan for ``zonal_tp_fwd.cu`` and ``zonal_tp_bwd.cu``.

    ``grp``: one record per covered output chunk: out offset b, d3, V, Wcat
    offset, fan_in, record offset, column offset.  ``zsrc`` / ``zcoef``: per
    (chunk, m3, column), at record offset + m3 * fan_in + column, the two x
    offsets and the two coefficients of its mid (an unused term has
    coefficient 0 and a valid offset).  ``wcol``: per column of a chunk its
    radial-weight column.  The kernels read the entry tables of
    ``_build_stages`` only.
    """

    def __init__(self, plan: PackedTPPlan):
        super().__init__(plan)
        zspec = zonal_tp.get_zonal_spec(plan)
        grp, wcol, zsrc, zcoef = [], [], [], []
        for (k_out, b, d3, V, wofs, fan_in) in self.out_chunks:
            grp.append((b, d3, V, wofs, fan_in, len(zsrc), len(wcol)))
            for m3 in range(d3):
                for (g, sl, mul, d1, n_cols, k0, cb) in self.sources(k_out):
                    i1, c1, i2, c2 = zspec.chunk_zonal[g]
                    for j in range(n_cols):
                        k = k0 + m3 * n_cols + j
                        for u in range(mul):
                            base = sl.start + u * d1
                            zsrc.append((base + int(i1[k]), base + int(i2[k])))
                            zcoef.append((c1[k], c2[k]))
                            if m3 == 0:
                                wcol.append(cb + j * mul + u)
        self.grp = np.asarray(grp, np.int32).reshape(-1, 7)
        self.zsrc = np.asarray(zsrc, np.int32).reshape(-1, 2)
        self.zcoef = np.asarray(zcoef, np.float32).reshape(-1, 2)
        self.wcol = np.asarray(wcol, np.int32)
        self._build_stages()

    def _column_entries(self, k: int, c: int):
        """The entries of column ``c`` of chunk ``k``: per |m3| = a with a
        nonzero term, one entry per term (a, (x offset, coefficient) of row
        L + a, the same of row L - a), a missing term as (0, 0.0)."""
        _b, d3, _V, _wofs, fan_in, rec, _col = (int(v) for v in self.grp[k])
        L = (d3 - 1) // 2
        out = []
        for a in range(L + 1):
            terms = []
            for m3 in ((L + a, L - a) if a else (L,)):
                r = rec + m3 * fan_in + c
                terms.append([(int(xo), float(cf)) for xo, cf in zip(self.zsrc[r], self.zcoef[r])
                              if cf != 0.0])
            if len(terms) == 1:
                terms.append([])
            for t in range(max(len(terms[0]), len(terms[1]))):
                out.append((a, *(tm[t] if t < len(tm) else (0, 0.0) for tm in terms)))
        return out

    def _build_stages(self):
        """Entry tables of both kernels.

        ``zgrp``: per chunk b, d3, V, first stage, end stage, offset of its
        columns in ``wcol``, fan_in.  ``stages``: chunk, first entry, entries
        (a multiple of 8, at most ``STAGE_ENTRIES``), segment offset and count, column-group offset
        and count, x-group offset and count, went offset of the first entry,
        offset and length of its members in ``clst`` and in ``xlst``.
        ``segs``: per |m3| segment of a stage its a, first stage-local entry
        and entries (a multiple of 8; pad entries have coefficient 0).
        ``ent_i`` / ``ent_c``: per entry the x offsets of its +a and -a
        records, its column in the chunk (its radial-weight column is
        ``wcol[column offset + column]``) and a; their coefficients (0 for
        the -a record of a = 0).  Column groups (``cgrp``: radial-weight
        column, 1 where an earlier chunk has written that column of dw,
        offset into ``clst``, count): the stage-local entries of each column.
        x groups (``xgrp``: x offset, offset into ``xlst`` / ``xcoef``,
        count): per x offset its (sign * STAGE_ENTRIES + entry) records and
        coefficients, so that one thread owns an x offset.  ``went_idx`` /
        ``went_scale``: per entry its chunk's V columns of Wcat (zero for a
        pad entry).  ``red_ofs`` / ``red_lst``: per Wcat element (in
        ``wcat_idx`` order) the went elements that sum to it.  ``fitems``
        (chunk, first n8 tile, n8 tiles) and ``witems`` (stage, first
        stage-local entry, entries, first V column): the work items, the
        weight pass's heaviest first."""
        ent_i, ent_c, ent_col = [], [], []
        zgrp, stages, segs = [], [], []
        cgrp, clst, xgrp, xlst, xcoef = [], [], [], [], []
        went_idx, went_scale, red = [], [], [[] for _ in range(len(self.wcat_idx))]
        seen_wc = set()
        for k, (b, d3, V, wofs, fan_in, _rec, col) in enumerate(self.grp):
            b, d3, V, wofs, fan_in, col = (int(v) for v in (b, d3, V, wofs, fan_in, col))
            L = (d3 - 1) // 2
            first_stage = len(stages)
            c = 0
            while c < fan_in:
                buckets = [[] for _ in range(L + 1)]
                while c < fan_in:
                    ents = self._column_entries(k, c)
                    size = sum(_round8(len(bk) + sum(e[0] == a for e in ents))
                               for a, bk in enumerate(buckets))
                    if size > STAGE_ENTRIES and any(buckets):
                        break
                    for e in ents:
                        buckets[e[0]].append((c, *e[1:]))
                    c += 1
                if not any(buckets):  # columns without a live record
                    continue
                # each stage's lists start on a 16-byte boundary (the edge
                # pass copies them in 16-byte pieces)
                for lst_, w_ in ((clst, 1), (xgrp, 3), (xlst, 1), (xcoef, 1)):
                    while (len(lst_) * w_) % 4:
                        lst_.append((0, 0, 0) if w_ == 3 else 0)
                st_ent, seg_ofs = len(ent_i), len(segs)
                by_col, by_x = {}, {}
                for a, bk in enumerate(buckets):
                    if not bk:
                        continue
                    segs.append((a, len(ent_i) - st_ent, _round8(len(bk))))
                    for j in range(_round8(len(bk))):
                        kk = len(ent_i) - st_ent
                        if j < len(bk):
                            cc, (xp, cp), (xm, cm) = bk[j]
                            wc = int(self.wcol[col + cc])
                            by_col.setdefault((wc, int(wc in seen_wc)), []).append(kk)
                            for s, (xo, cf) in enumerate(((xp, cp), (xm, cm))):
                                if cf != 0.0:
                                    by_x.setdefault((xo,), []).append(
                                        (s * STAGE_ENTRIES + kk, cf))
                        else:
                            cc, xp, cp, xm, cm = -1, 0, 0.0, 0, 0.0
                        ent_i.append((xp, xm, max(cc, 0), a))
                        ent_c.append((cp, cm))
                        ent_col.append(cc)
                        row = wofs + cc * V + np.arange(V)
                        for v in range(V):
                            if cc >= 0:
                                red[row[v]].append(len(went_idx))
                            went_idx.append(self.wcat_idx[row[v]] if cc >= 0 else 0)
                            went_scale.append(self.wcat_scale[row[v]] if cc >= 0 else 0.0)
                went0 = len(went_idx) - (len(ent_i) - st_ent) * V
                stages.append((k, st_ent, len(ent_i) - st_ent, seg_ofs, len(segs) - seg_ofs,
                               len(cgrp), len(by_col), len(xgrp), len(by_x), went0,
                               len(clst), sum(map(len, by_col.values())), len(xlst),
                               sum(map(len, by_x.values()))))
                append_groups(by_col, cgrp, clst)
                append_groups(by_x, xgrp, xlst, xcoef)
                seen_wc.update(wc for wc, _add in by_col)
            zgrp.append((b, d3, V, first_stage, len(stages), col, fan_in))
        self.zgrp = np.asarray(zgrp, np.int32).reshape(-1, 7)
        self.stages = np.asarray(stages, np.int32).reshape(-1, 14)
        self.segs = np.asarray(segs, np.int32).reshape(-1, 3)
        self.ent_i = np.asarray(ent_i, np.int32).reshape(-1, 4)
        self.ent_c = np.asarray(ent_c, np.float32).reshape(-1, 2)
        self.ent_col = np.asarray(ent_col, np.int32)
        # and 16 bytes past the last one, so that its last piece stays inside
        pad = lambda a, w_: a + [0] * 4 * w_  # noqa: E731
        self.cgrp = np.asarray(cgrp, np.int32).reshape(-1, 4)
        self.clst = np.asarray(pad(clst, 1), np.int32)
        self.xgrp = np.asarray(xgrp + [(0, 0, 0)] * 4, np.int32).reshape(-1, 3)
        self.xlst = np.asarray(pad(xlst, 1), np.int32)
        self.xcoef = np.asarray(pad(xcoef, 1), np.float32)
        self.went_idx = np.asarray(went_idx, np.int64)
        self.went_scale = np.asarray(went_scale, np.float32)
        self.red_ofs = np.cumsum([0] + [len(r) for r in red]).astype(np.int32)
        self.red_lst = np.asarray([i for r in red for i in r], np.int32)
        items = []
        for k, (_b, d3, V, *_r) in enumerate(self.zgrp):
            n8, na = -(-int(V) // 8), (int(d3) + 1) // 2
            per = max(1, min(FWD_ITEM_N8, FWD_ITEM_TILES // na))
            items += [(k, t0, min(per, n8 - t0)) for t0 in range(0, n8, per)]
        self.fitems = np.asarray(items, np.int32).reshape(-1, 3)
        self.fwd_tiles = max((((int(self.zgrp[k][1]) + 1) // 2) * n for k, _t, n in items),
                             default=0)
        witems, cost = [], []
        for si, (k, _e0, _n, seg_ofs, n_seg, *_r) in enumerate(self.stages):
            V = int(self.zgrp[k][2])
            for (_a, s0, n) in self.segs[seg_ofs : seg_ofs + n_seg]:
                for e0 in range(s0, s0 + n, WCAT_ITEM_ENTRIES):
                    ne = min(WCAT_ITEM_ENTRIES, s0 + n - e0)
                    for v0 in range(0, V, 8 * WCAT_ITEM_N8):
                        witems.append((si, e0, ne, v0))
                        cost.append(ne * min(V - v0, 8 * WCAT_ITEM_N8))
        order = np.argsort(-np.asarray(cost), kind="stable")
        self.witems = np.asarray(witems, np.int32).reshape(-1, 4)[order]
        # per edge, the floats of a chunk's output gradient in the edge pass's
        # shared memory (row stride round8(V) + 4)
        self.gmax = max((int(d3) * (_round8(int(V)) + 4) for (_b, d3, V, *_r) in self.zgrp),
                        default=12)
        # the most columns of a chunk (B3 stages their radial weights per tile)
        self.fan_max = max((int(r[6]) for r in self.zgrp), default=1)
        # the most words of a stage's group tables, packed in 16-byte parts
        # (the edge pass keeps one stage's in shared memory)
        r4 = lambda n: -(-int(n) // 4) * 4  # noqa: E731
        self.tgrp_words = max((r4(4 * st[6]) + r4(st[11]) + r4(3 * st[8]) + 2 * r4(st[13])
                               for st in self.stages), default=4)

    def _host_tables(self) -> dict:
        return {**super()._host_tables(),
                "went_idx": (self.went_idx, torch.long),
                "went_scale": (self.went_scale, torch.float32),
                "ent_c": (self.ent_c, torch.float32),
                "xcoef": (self.xcoef, torch.float32),
                **{name: (getattr(self, name), torch.int32)
                   for name in ("zgrp", "stages", "segs", "ent_i", "wcol", "cgrp", "clst",
                                "xgrp", "xlst", "red_ofs", "red_lst", "fitems", "witems")}}

    def build_went(self, flat_w):
        """Flat Linear weight -> Wcat in entry order: per entry its chunk's
        V columns of its Wcat row, 1/sqrt(fan_in) folded, zero for a pad."""
        tb = self.tables(flat_w.device)
        return flat_w[tb["went_idx"]] * tb["went_scale"]

    def records_built(self) -> int:
        """(m3, column) records the kernels build and multiply per edge: two
        per entry of |m3| > 0, one per entry of m3 = 0, pads excluded."""
        real = self.ent_col >= 0
        return int(real.sum() + (real & (self.ent_i[:, 3] > 0)).sum())

    def wcat_splits(self, E: int, resident: int) -> int:
        """Edge splits of the backward's weight pass (as ``KernelSpec``'s):
        ``WCAT_WAVES`` waves of resident blocks, at most one per 16-edge step, and
        as few as give each split its share of tiles (none left empty)."""
        n_tiles = -(-E // WCAT_TILE_EDGES)
        p = max(1, min(n_tiles, -(-WCAT_WAVES * resident // max(1, len(self.witems)))))
        return -(-n_tiles // -(-n_tiles // p))

    def _live(self):
        """Per covered output chunk (n, V): its n (m3, column) records with a
        nonzero coefficient.  The others are structural zeros of the zonal
        coupling (m1 = +-m3 leaves about half of a bench plan's records
        empty): their BLK entries are zero for every edge, so the function
        needs neither their radial scale nor their rows of the products."""
        live = (self.zcoef != 0.0).any(axis=1)
        return [(int(live[rec : rec + d3 * fan_in].sum()), int(V))
                for (_b, d3, V, _wofs, fan_in, rec, _col) in self.grp]

    def _mid_terms(self) -> int:
        """Nonzero mid terms per edge, over every covered chunk, m3 and column."""
        return int(np.count_nonzero(self.zcoef))

    def _wcat_flops(self) -> int:
        return sum(2 * n * V for n, V in self._live())

    def _scaled(self, has_w: bool) -> int:
        return sum(n for n, _V in self._live()) if has_w else 0

    def wcat_flops(self, E: int) -> int:
        return E * self._wcat_flops()

    def work(self, E: int, has_w: bool):
        """(FLOPs, bytes) the forward kernel's function needs for E edges:
        one FMA per nonzero mid term, and over the records with a nonzero
        coefficient the radial scale and the Wcat product; x_rot, w and Wcat
        read once and out_rot written once.  No sh operand and no coupling
        product; the rotations are not the kernel's."""
        flops = 2 * self._mid_terms() + self._wcat_flops() + self._scaled(has_w)
        words = E * (self.d_in + (self.n_ch if has_w else 0) + self.d_out) \
            + len(self.wcat_idx)
        return flops * E, 4 * words

    def work_bwd(self, E: int, has_w: bool):
        """(FLOPs, bytes) of the backward for E edges, over the same
        records: the mids recomputed, the dBLK and dWcat products, dw, the
        two radial scales and the dx_rot FMAs; x_rot, w, gout_rot and Wcat
        read once, dx_rot, dw and d(flat_w) written once."""
        flops = 4 * self._mid_terms() + 2 * self._wcat_flops() + 4 * self._scaled(has_w)
        words = E * (2 * self.d_in + (2 * self.n_ch if has_w else 0) + self.d_out) \
            + 2 * len(self.wcat_idx)
        return flops * E, 4 * words


@functools.lru_cache(maxsize=None)
def _spec_for_key(key) -> ZonalKernelSpec:
    return ZonalKernelSpec(get_plan(*key))


def get_zonal_kernel_spec(plan: PackedTPPlan) -> ZonalKernelSpec:
    return _spec_for_key(plan.key)


# ----------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------

def _check_library(lib, name):
    if (getattr(lib, f"{name}_tile_edges")() != ZONAL_TILE_EDGES
            or getattr(lib, f"{name}_stage_entries")() != STAGE_ENTRIES):
        raise RuntimeError(f"{name}.cu and zonal_kernel.py disagree on the tile or the stage")


def _launch(spec: ZonalKernelSpec, x_rot, w, flat_w, bf16: bool = False):
    E = x_rot.shape[0]
    dev = x_rot.device
    _check("x_rot", x_rot, (E, spec.d_in), dev)
    if w is not None:
        _check("w", w, (E, spec.n_ch), dev)
    out = (torch.empty if spec.fully_covered else torch.zeros)(
        (E, spec.d_out), dtype=torch.float32, device=dev)
    if E == 0 or len(spec.zgrp) == 0:
        return out
    _check("flat_w", flat_w, (spec.plan.linear_numel,), dev)
    lib = ZONAL_TP_FWD.library()
    _check_library(lib, "zonal_tp_fwd")
    if (lib.zonal_tp_fwd_item_tiles() != FWD_ITEM_TILES
            or lib.zonal_tp_fwd_item_n8() != FWD_ITEM_N8):
        raise RuntimeError("zonal_tp_fwd.cu and zonal_kernel.py disagree on the work items")
    _smem_limit("zonal_tp_fwd", lib.zonal_tp_fwd_smem_bytes(spec.d_in, spec.fan_max), dev)
    tb = spec.tables(dev)
    went = spec.build_went(flat_w).contiguous()
    variant("zonal_tp_fwd", bf16).launch(
        x_rot.data_ptr(), 0 if w is None else w.data_ptr(), went.data_ptr(),
        *(tb[n].data_ptr() for n in ("zgrp", "stages", "segs", "ent_i", "ent_c", "wcol",
                                     "fitems")),
        out.data_ptr(), E, spec.d_in, spec.n_ch, spec.d_out, len(spec.fitems), spec.fan_max,
        0 if w is None else 1, int(bf16), torch.cuda.current_stream(dev).cuda_stream)
    return out


def bwd_call(spec: ZonalKernelSpec, x_rot, w, flat_w, gout, bf16: bool = False):
    """Checks the backward's inputs, allocates its outputs and returns
    ``(outputs, call)``: (dx_rot, dw or None, d(flat_w)) and ``(args,
    tensors)``, the argument list of the C entries (``zonal_tp_bwd`` and the
    passes alone) and the scratch tensors behind its pointers, which the
    caller keeps while it launches (``call`` is None where there is nothing
    to launch).  The edge pass writes dx_rot and dw; the weight pass writes
    one partial row of dWcat (in entry order) per edge split, which the
    reduce sums into d(flat_w).  ``bf16``: the bf16 instantiation."""
    E = x_rot.shape[0]
    dev = x_rot.device
    _check("x_rot", x_rot, (E, spec.d_in), dev)
    _check("gout_rot", gout, (E, spec.d_out), dev)
    if w is not None:
        _check("w", w, (E, spec.n_ch), dev)
    _check("flat_w", flat_w, (spec.plan.linear_numel,), dev)
    zeros = functools.partial(torch.zeros, dtype=torch.float32, device=dev)
    # the edge pass writes every element of dx_rot (the tile's rows, kept in
    # shared memory) and only the used columns of dw
    dx = torch.empty((E, spec.d_in), dtype=torch.float32, device=dev)
    dw = zeros((E, spec.n_ch)) if w is not None else None
    dflat = zeros((spec.plan.linear_numel,))
    outs = (dx, dw, dflat)
    if E == 0 or len(spec.zgrp) == 0:
        dx.zero_()
        return outs, None
    lib = ZONAL_TP_BWD.library()
    _check_library(lib, "zonal_tp_bwd")
    if (lib.zonal_tp_bwd_item_entries() != WCAT_ITEM_ENTRIES
            or lib.zonal_tp_bwd_item_n8() != WCAT_ITEM_N8
            or lib.zonal_tp_bwd_wcat_tile_edges() != WCAT_TILE_EDGES):
        raise RuntimeError("zonal_tp_bwd.cu and zonal_kernel.py disagree on the weight "
                           "pass's work items")
    smem = [lib.zonal_tp_bwd_smem_bytes(spec.d_in, spec.gmax, spec.tgrp_words, p)
            for p in (0, 1)]
    for nbytes in smem:
        _smem_limit("zonal_tp_bwd", nbytes, dev)
    per_sm = lib.zonal_tp_bwd_resident_blocks(1, smem[1])
    if per_sm < 1:
        raise RuntimeError("zonal_tp_bwd: no block of the weight pass fits on an SM")
    resident = per_sm * torch.cuda.get_device_properties(dev).multi_processor_count
    n_split = spec.wcat_splits(E, resident)
    part = torch.empty((n_split, len(spec.went_idx)), dtype=torch.float32, device=dev)
    tb = spec.tables(dev)
    went = spec.build_went(flat_w).contiguous()
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    args = (x_rot.data_ptr(), ptr(w), went.data_ptr(), gout.data_ptr(),
            *(tb[n].data_ptr() for n in ("zgrp", "stages", "ent_i", "ent_c", "wcol", "cgrp",
                                         "clst", "xgrp", "xlst", "xcoef", "witems", "red_ofs",
                                         "red_lst", "wcat_idx", "wcat_scale")),
            dx.data_ptr(), ptr(dw), part.data_ptr(), dflat.data_ptr(),
            E, spec.d_in, spec.n_ch, spec.d_out, len(spec.zgrp), len(spec.witems),
            len(spec.wcat_idx), len(spec.went_idx), spec.gmax, spec.tgrp_words, n_split,
            0 if w is None else 1, int(bf16), torch.cuda.current_stream(dev).cuda_stream)
    return outs, (args, (went, part))


def _launch_bwd(spec: ZonalKernelSpec, x_rot, w, flat_w, gout, bf16: bool = False):
    outs, call = bwd_call(spec, x_rot, w, flat_w, gout, bf16)
    if call is not None:
        variant("zonal_tp_bwd", bf16).launch(*call[0])
    return outs


class ZonalTP(torch.autograd.Function):
    """The edge-frame pipeline between the rotations, on the card: forward
    kernel B3, backward kernel B4, each in the precision of the bf16 mode.
    Saves only its inputs; B4 recomputes the mids."""

    @staticmethod
    def forward(ctx, x_rot, w, flat_w, spec, bf16=""):
        ctx.spec = spec
        fwd_bf16, ctx.bf16 = _modes(bf16)
        ctx.save_for_backward(x_rot, w, flat_w)
        return _launch(spec, x_rot, w, flat_w, fwd_bf16)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        x_rot, w, flat_w = ctx.saved_tensors
        dx, dw, dflat = _launch_bwd(ctx.spec, x_rot, w, flat_w, gout.contiguous(), ctx.bf16)
        return dx, dw, dflat, None, None


def zonal_core_forward(plan: PackedTPPlan, x_rot, w, flat_w, bf16: str = ""):
    """The edge-frame pipeline between the rotations: x_rot (E, d_in), w
    (E, n_ch) in packed order or None, flat_w (linear_numel,) -> out_rot
    (E, d_out) float32, both in the plan's u-major layouts.  ``bf16``: the
    mode of ``HAMGNN_TP_BF16`` (``""``, ``"bwd"`` or ``"all"``).

    CPU tensors take ``plain_zonal_core`` (under a bf16 mode
    ``zonal_tp.PlainZonalCore``); CUDA tensors launch the kernels (B3
    forward, B4 in the backward)."""
    if _device_kind(x_rot, "zonal_core_forward") == "cpu":
        if bf16:
            return zonal_tp.PlainZonalCore.apply(x_rot, w, flat_w, plan, bf16)
        return zonal_tp.plain_zonal_core(plan, x_rot, w, flat_w)
    return ZonalTP.apply(x_rot, w, flat_w, get_zonal_kernel_spec(plan), bf16)


def zonal_core_backward(plan: PackedTPPlan, x_rot, w, flat_w, gout_rot, bf16: bool = False):
    """Backward of ``zonal_core_forward`` for the output gradient
    ``gout_rot`` (E, d_out): (dx_rot, dw or None, d(flat_w)), in the bf16
    instantiation with ``bf16``.

    CPU tensors take ``plain_zonal_core_backward``; CUDA tensors launch
    kernel B4."""
    if _device_kind(x_rot, "zonal_core_backward") == "cpu":
        return zonal_tp.plain_zonal_core_backward(plan, x_rot, w, flat_w, gout_rot, bf16)
    return _launch_bwd(get_zonal_kernel_spec(plan), x_rot, w, flat_w, gout_rot.contiguous(),
                       bf16)


def zonal_forward(plan: PackedTPPlan, x, sh, w, flat_w, bf16: str = ""):
    """The packed pipeline of ``plan`` through the edge frame: x (E, d_in),
    sh (E, S), w (E, n_ch) in packed order or None, flat_w (linear_numel,)
    -> (E, d_out) float32, in the plan's normal layouts.  ``bf16``: the mode
    of ``HAMGNN_TP_BF16``.

    The edge direction is read from the l=1 block of ``sh``; each input
    chunk is rotated into the edge frame, the kernels run on the rotated x,
    and each output chunk is rotated back.  The frame is data: ``sh`` never
    receives a gradient from this engine, even if it requires one.

    CPU tensors take ``zonal_tp.zonal_apply``; CUDA tensors launch the
    kernels (B3 forward, B4 in the backward)."""
    if _device_kind(x, "zonal_forward") == "cpu":
        return zonal_tp.zonal_apply(plan, x, sh, w, flat_w, bf16)
    Ds = zonal_tp.edge_frames(zonal_tp.get_zonal_spec(plan), sh)
    x_rot = zonal_tp.rotate_in(plan, x, Ds).contiguous()
    out_rot = ZonalTP.apply(x_rot, w, flat_w, get_zonal_kernel_spec(plan), bf16)
    return zonal_tp.rotate_out(plan, out_rot, Ds)
