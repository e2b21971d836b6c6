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
reference's ``ZonalPallasSpec`` for the GPU: no lane layouts, but per
(output chunk, m3, BLK column) two x offsets in the rotated u-major row with
their coefficients, and per column its radial-weight column.  Unlike the
lab-frame schedule the sources depend on m3 (zonal CG couples m1 = +-m3).
The backward adds, per slab of 64 columns, the (m3, column, term) entries
grouped by x offset.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import zonal_tp
from .packed_tp import PackedTPPlan, get_plan
from .tp_kernel import (BWD_SLAB_COLS, ZONAL_TP_BWD, ZONAL_TP_FWD, PipelineSpec,
                        _check, _device_kind, append_groups)


class ZonalKernelSpec(PipelineSpec):
    """Tables of one plan for ``zonal_tp_fwd.cu`` and ``zonal_tp_bwd.cu``.

    ``grp``: one record per covered output chunk: out offset b, d3, V, Wcat
    offset, fan_in, record offset, column offset.  ``zsrc`` / ``zcoef``: per
    (chunk, m3, column), at record offset + m3 * fan_in + column, the two x
    offsets and the two coefficients of its mid (an unused term has
    coefficient 0 and a valid offset).  ``wcol``: per column of a chunk its
    radial-weight column.  The backward's slab tables: see ``_build_slabs``.
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
        self._build_slabs()

    def _build_slabs(self):
        """Backward tables: per output chunk the index of its first slab;
        per slab (BWD_SLAB_COLS columns, all m3) its x groups, each (x
        offset, offset into ``lst`` / ``lcoef``, count); per entry of a
        group, in (m3, column, term) order, ``lst`` = m3 * BWD_SLAB_COLS +
        slab column and ``lcoef`` its coefficient."""
        slab_base, slabs, xgrp, lst, lcoef = [], [], [], [], []
        for (_b, d3, _V, _wofs, fan_in, rec_ofs, _col) in self.grp:
            slab_base.append(len(slabs))
            for c0 in range(0, fan_in, BWD_SLAB_COLS):
                by_x = {}
                for m3 in range(d3):
                    for c in range(c0, min(c0 + BWD_SLAB_COLS, fan_in)):
                        rec = rec_ofs + m3 * fan_in + c
                        for xo, cf in zip(self.zsrc[rec], self.zcoef[rec]):
                            if cf != 0.0:
                                by_x.setdefault((int(xo),), []).append(
                                    (m3 * BWD_SLAB_COLS + c - c0, float(cf)))
                slabs.append((len(xgrp), len(by_x)))
                append_groups(by_x, xgrp, lst, lcoef)
        self.slab_base = np.asarray(slab_base, np.int32)
        self.slabs = np.asarray(slabs, np.int32).reshape(-1, 2)
        self.xgrp = np.asarray(xgrp, np.int32).reshape(-1, 3)
        self.lst = np.asarray(lst, np.int32)
        self.lcoef = np.asarray(lcoef, np.float32)

    def _host_tables(self) -> dict:
        return {**super()._host_tables(),
                "zcoef": (self.zcoef, torch.float32),
                "lcoef": (self.lcoef, torch.float32),
                **{name: (getattr(self, name), torch.int32)
                   for name in ("grp", "zsrc", "wcol", "slab_base", "slabs",
                                "xgrp", "lst")}}

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

def _shared_memory_limit(name, smem, dev):
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"{name} needs {smem} B of shared memory, "
                         f"the card allows {limit}")


def _launch(spec: ZonalKernelSpec, x_rot, w, flat_w):
    E = x_rot.shape[0]
    dev = x_rot.device
    _check("x_rot", x_rot, (E, spec.d_in), dev)
    if w is not None:
        _check("w", w, (E, spec.n_ch), dev)
    out = (torch.empty if spec.fully_covered else torch.zeros)(
        (E, spec.d_out), dtype=torch.float32, device=dev)
    if E == 0 or len(spec.grp) == 0:
        return out
    _check("flat_w", flat_w, (spec.plan.linear_numel,), dev)
    lib = ZONAL_TP_FWD.library()
    r_max = max(lib.zonal_tp_fwd_rows_per_thread(int(d3), int(V))
                for (_b, d3, V, *_rest) in spec.grp)
    if r_max < 1 or r_max > lib.zonal_tp_fwd_max_rows():
        raise ValueError(f"zonal_tp_fwd takes at most {lib.zonal_tp_fwd_max_rows()} "
                         f"rows per thread; this plan needs {r_max}")
    _shared_memory_limit("zonal_tp_fwd",
                         lib.zonal_tp_fwd_smem_bytes(spec.d3_max, spec.v_max), dev)
    tb = spec.tables(dev)
    wcat = spec.build_wcat(flat_w).contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ZONAL_TP_FWD.launch(
        x_rot.data_ptr(), 0 if w is None else w.data_ptr(), wcat.data_ptr(),
        tb["grp"].data_ptr(), tb["zsrc"].data_ptr(), tb["zcoef"].data_ptr(),
        tb["wcol"].data_ptr(), out.data_ptr(),
        E, spec.d_in, spec.n_ch, spec.d_out, len(spec.grp), spec.d3_max,
        spec.v_max, r_max, 0 if w is None else 1, stream)
    return out


def _launch_bwd(spec: ZonalKernelSpec, x_rot, w, flat_w, gout):
    E = x_rot.shape[0]
    dev = x_rot.device
    _check("x_rot", x_rot, (E, spec.d_in), dev)
    _check("gout_rot", gout, (E, spec.d_out), dev)
    if w is not None:
        _check("w", w, (E, spec.n_ch), dev)
    _check("flat_w", flat_w, (spec.plan.linear_numel,), dev)
    zeros = functools.partial(torch.zeros, dtype=torch.float32, device=dev)
    dx = zeros((E, spec.d_in))
    dw = zeros((E, spec.n_ch)) if w is not None else None
    dflat = zeros((spec.plan.linear_numel,))
    if E == 0 or len(spec.grp) == 0:
        return dx, dw, dflat
    lib = ZONAL_TP_BWD.library()
    if lib.zonal_tp_bwd_slab_cols() != BWD_SLAB_COLS:
        raise RuntimeError("zonal_tp_bwd.cu and tp_kernel.py disagree on the slab width")
    if spec.v_max > 512:
        raise ValueError(f"zonal_tp_bwd takes V <= 512; this plan needs {spec.v_max}")
    smem = lib.zonal_tp_bwd_smem_bytes(spec.gmax, spec.d3_max, spec.v_max)
    _shared_memory_limit("zonal_tp_bwd", smem, dev)
    resident = lib.zonal_tp_bwd_resident_blocks(smem)
    if resident < 1:
        raise RuntimeError(f"zonal_tp_bwd: no block of {smem} B fits on the card")
    # each block walks a contiguous range of edge tiles, so it alone writes
    # its rows of dx_rot/dw and its own partial row of dWcat
    n_tiles = -(-E // lib.zonal_tp_bwd_tile_edges())
    per_block = -(-n_tiles // min(n_tiles, resident))
    nblk = -(-n_tiles // per_block)
    part = torch.empty((nblk, spec.plan.linear_numel), dtype=torch.float32, device=dev)
    tb = spec.tables(dev)
    wcat = spec.build_wcat(flat_w).contiguous()
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream(dev).cuda_stream
    ZONAL_TP_BWD.launch(
        x_rot.data_ptr(), ptr(w), wcat.data_ptr(), gout.data_ptr(),
        tb["grp"].data_ptr(), tb["zsrc"].data_ptr(), tb["zcoef"].data_ptr(),
        tb["wcol"].data_ptr(), tb["slab_base"].data_ptr(), tb["slabs"].data_ptr(),
        tb["xgrp"].data_ptr(), tb["lst"].data_ptr(), tb["lcoef"].data_ptr(),
        tb["wcat_scale"].data_ptr(), tb["wcat_idx"].data_ptr(),
        dx.data_ptr(), ptr(dw), part.data_ptr(), dflat.data_ptr(),
        E, spec.d_in, spec.n_ch, spec.d_out, len(spec.grp),
        spec.plan.linear_numel, spec.gmax, spec.d3_max, spec.v_max, nblk,
        per_block, 0 if w is None else 1, stream)
    return dx, dw, dflat


class ZonalTP(torch.autograd.Function):
    """The edge-frame pipeline between the rotations, on the card: forward
    kernel B3, backward kernel B4.  Saves only its inputs; B4 recomputes the
    mids."""

    @staticmethod
    def forward(ctx, x_rot, w, flat_w, spec):
        ctx.spec = spec
        ctx.save_for_backward(x_rot, w, flat_w)
        return _launch(spec, x_rot, w, flat_w)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        x_rot, w, flat_w = ctx.saved_tensors
        dx, dw, dflat = _launch_bwd(ctx.spec, x_rot, w, flat_w, gout.contiguous())
        return dx, dw, dflat, None


def zonal_core_forward(plan: PackedTPPlan, x_rot, w, flat_w):
    """The edge-frame pipeline between the rotations: x_rot (E, d_in), w
    (E, n_ch) in packed order or None, flat_w (linear_numel,) -> out_rot
    (E, d_out) float32, both in the plan's u-major layouts.

    CPU tensors take ``plain_zonal_core``; CUDA tensors launch the kernels
    (B3 forward, B4 in the backward)."""
    if _device_kind(x_rot, "zonal_core_forward") == "cpu":
        return zonal_tp.plain_zonal_core(plan, x_rot, w, flat_w)
    return ZonalTP.apply(x_rot, w, flat_w, get_zonal_kernel_spec(plan))


def zonal_core_backward(plan: PackedTPPlan, x_rot, w, flat_w, gout_rot):
    """Backward of ``zonal_core_forward`` for the output gradient
    ``gout_rot`` (E, d_out): (dx_rot, dw or None, d(flat_w)).

    CPU tensors take ``plain_zonal_core_backward``; CUDA tensors launch
    kernel B4."""
    if _device_kind(x_rot, "zonal_core_backward") == "cpu":
        return zonal_tp.plain_zonal_core_backward(plan, x_rot, w, flat_w, gout_rot)
    return _launch_bwd(get_zonal_kernel_spec(plan), x_rot, w, flat_w,
                       gout_rot.contiguous())


def zonal_forward(plan: PackedTPPlan, x, sh, w, flat_w):
    """The packed pipeline of ``plan`` through the edge frame: x (E, d_in),
    sh (E, S), w (E, n_ch) in packed order or None, flat_w (linear_numel,)
    -> (E, d_out) float32, in the plan's normal layouts.

    The edge direction is read from the l=1 block of ``sh``; each input
    chunk is rotated into the edge frame, the kernels run on the rotated x,
    and each output chunk is rotated back.  The frame is data: ``sh`` never
    receives a gradient from this engine, even if it requires one.

    CPU tensors take ``zonal_tp.zonal_apply``; CUDA tensors launch the
    kernels (B3 forward, B4 in the backward)."""
    if _device_kind(x, "zonal_forward") == "cpu":
        return zonal_tp.zonal_apply(plan, x, sh, w, flat_w)
    Ds = zonal_tp.edge_frames(zonal_tp.get_zonal_spec(plan), sh)
    x_rot = zonal_tp.rotate_in(plan, x, Ds).contiguous()
    out_rot = ZonalTP.apply(x_rot, w, flat_w, get_zonal_kernel_spec(plan))
    return zonal_tp.rotate_out(plan, out_rot, Ds)
