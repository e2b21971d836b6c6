"""Hopper kernels for the packed TP -> radial scale -> Linear pipeline.

``packed_tp_forward`` is the wrapper of ``csrc/packed_tp_fwd.cu``, the port
of the TPU kernel ``hamgnn_tpu/e3/pallas_tp.py`` ``_fwd_call``;
``packed_tp_backward`` the wrapper of ``csrc/packed_tp_bwd.cu``, the port of
``_bwd_call``.  ``PackedTP`` ties them together as one
``torch.autograd.Function`` (the port of the custom VJP ``_pipeline``).  On
CPU tensors the wrappers run the plain versions (``packed_tp.plain_apply``,
``packed_tp.plain_backward``); on CUDA tensors they launch the kernels or
raise.

``KernelSpec`` is the kernel's host-side schedule, rebuilt from the
reference's ``PallasSpec`` for the GPU: instead of lane layouts (x_perm,
Crep, out_deint, 8-row-aligned Wcat blocks) it holds per-column int32 index
tables: one record per output chunk (a CUDA block per edge tile and chunk,
covering all its m3 components), per BLK column its coupling slot, d1, x
offset in the u-major layout and radial-weight column, and per coupling slot
the nonzero range of its coupling column.  The backward adds, per slab of
64 columns, the columns grouped by x offset and by coupling slot.

Each library is compiled with nvcc at first use into ``build/kernels/`` from
the sources in this checkout and loaded with ctypes.  The module also holds
what the zonal engine's kernels (``zonal_kernel.py``) share with these: the
build, the registry of every kernel with its count of launches (``KERNELS``)
and ``PipelineSpec``, the part of the host schedule common to both engines.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .packed_tp import PackedTPPlan, get_plan, plain_apply, plain_backward

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# H100 SXM peaks used for the bound of a launch (NVIDIA data sheet): fp32 on
# the CUDA cores (the kernel uses no tensor cores) and HBM3 bandwidth
H100_FP32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12


# ----------------------------------------------------------------------
# build and load
# ----------------------------------------------------------------------

def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def build_kernels(names) -> dict:
    """Compile the named ``csrc/<name>.cu`` sources into shared libraries,
    one nvcc per source, all started together.  Returns {name: (path,
    compiler log)}; a library newer than its source is reused."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    out = {}
    for name in names:
        src = CSRC / f"{name}.cu"
        lib = BUILD_DIR / f"lib{name}.so"
        if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
            out[name] = (lib, "")
            continue
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, lib)
        out[name] = (lib, log)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


class CudaKernel:
    """A kernel of a library built at first use, with a count of launches.

    ``symbols`` maps each exported C function to (argtypes, restype); the
    launch function is ``name`` and returns a CUDA error code, which
    ``<source>_error_string`` turns into text.  ``source`` names the
    ``csrc/<source>.cu`` that holds the kernel (default: ``name``); kernels
    of one source share its library.  ``launches`` rises by one each time
    ``launch`` starts the kernel and nowhere else, so a run can show that
    its path went through the kernel.
    """

    _libraries: dict = {}  # source -> loaded library, shared by its kernels

    def __init__(self, name: str, symbols: dict, source: Optional[str] = None):
        self.name = name
        self.source = source or name
        self.symbols = {name: symbols[name],
                        f"{self.source}_error_string": ([ctypes.c_int], ctypes.c_char_p),
                        **symbols}
        self.launches = 0
        self._lib = None

    def library(self):
        if self._lib is None:
            lib = self._libraries.get(self.source)
            if lib is None:
                path, _ = build_kernels([self.source])[self.source]
                lib = self._libraries[self.source] = ctypes.CDLL(str(path))
            for sym, (argtypes, restype) in self.symbols.items():
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = restype
            self._lib = lib
        return self._lib

    def launch(self, *args):
        lib = self.library()
        rc = getattr(lib, self.name)(*args)
        if rc != 0:
            msg = getattr(lib, f"{self.source}_error_string")(rc).decode()
            raise RuntimeError(f"{self.name} launch failed: {msg} ({rc})")
        self.launches += 1


_P = ctypes.c_void_p
_I = ctypes.c_int
PACKED_TP_FWD = CudaKernel("packed_tp_fwd", {
    "packed_tp_fwd": ([_P] * 9 + [_I] * 11 + [_P], _I),
    "packed_tp_fwd_smem_bytes": ([_I] * 4, ctypes.c_size_t),
    "packed_tp_fwd_rows_per_thread": ([_I] * 2, _I),
    "packed_tp_fwd_max_rows": ([], _I),
    "packed_tp_fwd_max_d1": ([], _I),
})

PACKED_TP_BWD = CudaKernel("packed_tp_bwd", {
    "packed_tp_bwd": ([_P] * 21 + [_I] * 15 + [_P], _I),
    "packed_tp_bwd_smem_bytes": ([_I] * 6, ctypes.c_size_t),
    "packed_tp_bwd_slab_cols": ([], _I),
    "packed_tp_bwd_max_d1": ([], _I),
    "packed_tp_bwd_tile_edges": ([], _I),
    "packed_tp_bwd_resident_blocks": ([ctypes.c_size_t], _I),
})

# the zonal engine's kernels (wrappers and host tables in zonal_kernel.py)
ZONAL_TP_FWD = CudaKernel("zonal_tp_fwd", {
    "zonal_tp_fwd": ([_P] * 8 + [_I] * 9 + [_P], _I),
    "zonal_tp_fwd_smem_bytes": ([_I] * 2, ctypes.c_size_t),
    "zonal_tp_fwd_rows_per_thread": ([_I] * 2, _I),
    "zonal_tp_fwd_max_rows": ([], _I),
})

ZONAL_TP_BWD = CudaKernel("zonal_tp_bwd", {
    "zonal_tp_bwd": ([_P] * 19 + [_I] * 12 + [_P], _I),
    "zonal_tp_bwd_smem_bytes": ([_I] * 3, ctypes.c_size_t),
    "zonal_tp_bwd_slab_cols": ([], _I),
    "zonal_tp_bwd_tile_edges": ([], _I),
    "zonal_tp_bwd_resident_blocks": ([ctypes.c_size_t], _I),
})

# every kernel of the port, by name (chip_smoke.py resets and reads the counts)
KERNELS = {"packed_tp_fwd": PACKED_TP_FWD, "packed_tp_bwd": PACKED_TP_BWD,
           "zonal_tp_fwd": ZONAL_TP_FWD, "zonal_tp_bwd": ZONAL_TP_BWD}

# columns per slab of the backward kernels (packed_tp_bwd.cu, zonal_tp_bwd.cu KS)
BWD_SLAB_COLS = 64


# ----------------------------------------------------------------------
# host-side schedule
# ----------------------------------------------------------------------

def append_groups(by_key: dict, records: list, *lists: list):
    """Append one (key..., offset, count) record per group of ``by_key`` to
    ``records``, in first-seen order, and the groups' members to ``lists``:
    a member is one value, or with several lists one value for each."""
    for key, members in by_key.items():
        records.append((*key, len(lists[0]), len(members)))
        for m in members:
            for out, v in zip(lists, m if len(lists) > 1 else (m,)):
                out.append(v)


class PipelineSpec:
    """What the schedules of both engines' kernels share: one record per
    covered output chunk (``out_chunks``: k_out, out offset b, d3, V, Wcat
    offset, fan_in; a CUDA block per edge tile and record), the Wcat layout
    (per chunk its (fan_in, V) block, rows in BLK column order, so
    ``wcat_idx`` / ``wcat_scale`` gather it from the flat Linear weight),
    the BLK column order of a chunk (``sources``) and the device copies of
    the tables."""

    def __init__(self, plan: PackedTPPlan):
        self.plan = plan
        self.d_in = plan.irreps_in.dim
        self.d_out = plan.irreps_out.dim
        self.n_ch = plan.weight_numel

        chunks, widx, wscale = [], [], []
        wofs = 0
        for k_out, mio in enumerate(plan.irreps_out):
            fan_in, ofs = plan.out_plans[k_out]
            if fan_in == 0:
                continue
            V, d3 = mio.mul, mio.ir.dim
            b = plan.irreps_out.slices()[k_out].start
            # Wcat block of this output chunk: source rows stacked in
            # out_sources order, 1/sqrt(fan_in) folded in
            perm = np.concatenate([rp for (_g, _gi, rp) in plan.out_sources[k_out]])
            widx.append(ofs + perm[:, None].astype(np.int64) * V + np.arange(V)[None, :])
            wscale.append(np.full(fan_in * V, 1.0 / np.sqrt(fan_in)))
            chunks.append((k_out, b, d3, V, wofs, fan_in))
            wofs += fan_in * V
        self.out_chunks = chunks
        self.wcat_idx = (np.concatenate([w.reshape(-1) for w in widx])
                         if widx else np.zeros(0, np.int64))
        self.wcat_scale = (np.concatenate(wscale).astype(np.float32)
                           if wscale else np.zeros(0, np.float32))
        self.d3_max = max((c[2] for c in chunks), default=1)
        self.v_max = max((c[3] for c in chunks), default=1)
        self.gmax = max((c[2] * c[3] for c in chunks), default=1)
        self.d1_max = max((d1 for (_sl, _m, d1, _C, _g) in plan.per_chunk), default=1)
        self.fully_covered = len(chunks) == len(plan.irreps_out)
        self._device_tables = {}

    def sources(self, k_out: int):
        """The sources of output chunk ``k_out`` in BLK column order: per
        source (g, x slice, mul, d1, n_cols, k0, radial-weight base); its
        columns run path-major, u-minor."""
        plan = self.plan
        for (g, gi, _rp) in plan.out_sources[k_out]:
            sl, mul, d1, _C, groups = plan.per_chunk[g]
            _ir3, n_cols, k0, _k1 = groups[gi]
            yield g, sl, mul, d1, n_cols, k0, plan._grp_w_base[(g, gi)]

    def _host_tables(self) -> dict:
        """name -> (numpy array, torch dtype) of every table a kernel reads."""
        return {"wcat_idx": (self.wcat_idx, torch.long),
                "wcat_scale": (self.wcat_scale, torch.float32)}

    def tables(self, device):
        """The index tables as tensors on ``device``, made outside inference
        mode (``build_wcat`` also runs under autograd).  An empty kernel
        table becomes one zero, so that it has an address; the Wcat gather
        of a plan that covers no output chunk stays empty."""
        key = str(device)
        if key not in self._device_tables:
            with torch.inference_mode(False):
                self._device_tables[key] = {
                    name: torch.as_tensor(
                        np.ascontiguousarray(arr if arr.size or name.startswith("wcat")
                                             else np.zeros(1)),
                        dtype=dt, device=device)
                    for name, (arr, dt) in self._host_tables().items()}
        return self._device_tables[key]

    def build_wcat(self, flat_w):
        """Flat Linear weight -> the kernel's Wcat: per output chunk its
        (fan_in, V) block, rows in BLK column order, 1/sqrt(fan_in) folded."""
        tb = self.tables(flat_w.device)
        return flat_w[tb["wcat_idx"]] * tb["wcat_scale"]

    @staticmethod
    def _bound(flops: int, nbytes: int) -> tuple:
        t_ops = flops / H100_FP32_FLOPS * 1e3
        t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

    def bound_ms(self, E: int, has_w: bool) -> tuple:
        """Least time on an H100 for E edges, and which side bounds it."""
        return self._bound(*self.work(E, has_w))

    def bound_bwd_ms(self, E: int, has_w: bool, **kw) -> tuple:
        """Least time on an H100 for the backward of E edges."""
        return self._bound(*self.work_bwd(E, has_w, **kw))


class KernelSpec(PipelineSpec):
    """Per-column index tables of one plan for ``packed_tp_fwd.cu`` and
    ``packed_tp_bwd.cu``.

    ``grp``: one record per covered output chunk (a CUDA block per edge tile
    and record): out offset b, d3, V, Wcat offset, fan_in, column offset,
    coupling-slot offset, slots per m3 (nq).  ``cols``: per BLK column its
    slot offset within an m3 block, d1, x offset, radial-weight column; the
    same for every m3.  ``qtab``: per slot (m3-major, then source, path, i)
    its coefficient offset, first SH component and count; ``coef`` the
    nonzero coupling values.  The backward's slab tables: see
    ``_build_slabs``.
    """

    def __init__(self, plan: PackedTPPlan):
        super().__init__(plan)
        self.S = plan.irreps_sh.dim

        grp, cols, qtab, coef = [], [], [], []
        for (k_out, b, d3, V, wofs, fan_in) in self.out_chunks:
            col_ofs, q_ofs = len(cols), len(qtab)
            for m3 in range(d3):
                q_src = 0
                for (g, sl, mul, d1, n_cols, k0, cb) in self.sources(k_out):
                    C = plan.per_chunk[g][3]
                    for j in range(n_cols):
                        k = k0 + m3 * n_cols + j
                        for i in range(d1):
                            cc = C[:, i, k]
                            nz = np.nonzero(cc)[0]
                            s0 = int(nz[0]) if len(nz) else 0
                            ns = int(nz[-1]) + 1 - s0 if len(nz) else 0
                            qtab.append((len(coef), s0, ns))
                            coef.extend(cc[s0 : s0 + ns].tolist())
                        if m3 == 0:
                            for u in range(mul):
                                cols.append((q_src + j * d1, d1, sl.start + u * d1,
                                             cb + j * mul + u))
                    q_src += n_cols * d1
            nq = (len(qtab) - q_ofs) // d3
            grp.append((b, d3, V, wofs, fan_in, col_ofs, q_ofs, nq))
        self.grp = np.asarray(grp, np.int32).reshape(-1, 8)
        self.cols = np.asarray(cols, np.int32).reshape(-1, 4)
        self.qtab = np.asarray(qtab, np.int32).reshape(-1, 3)
        self.coef = np.asarray(coef, np.float32)
        g = self.grp
        self.nq_all_max = int((g[:, 1] * g[:, 7]).max()) if len(g) else 0
        self._build_slabs()

    def _build_slabs(self):
        """Backward tables: per output chunk the index of its first slab;
        per slab (BWD_SLAB_COLS columns) its x groups and slot groups, each
        (x offset or slot, d1, offset into ``lst``, count), ``lst`` holding
        the chunk-relative columns of each group in column order."""
        slab_base, slabs, xgrp, qgrp, lst = [], [], [], [], []
        for (_b, _d3, _V, _wofs, fan_in, col_ofs, _q, _nq) in self.grp:
            slab_base.append(len(slabs))
            for c0 in range(0, fan_in, BWD_SLAB_COLS):
                by_x, by_q = {}, {}
                for c in range(c0, min(c0 + BWD_SLAB_COLS, fan_in)):
                    qb, d1, xb, _wc = (int(v) for v in self.cols[col_ofs + c])
                    by_x.setdefault((xb, d1), []).append(c)
                    by_q.setdefault((qb, d1), []).append(c)
                slabs.append((len(xgrp), len(by_x), len(qgrp), len(by_q)))
                append_groups(by_x, xgrp, lst)
                append_groups(by_q, qgrp, lst)
        self.slab_base = np.asarray(slab_base, np.int32)
        self.slabs = np.asarray(slabs, np.int32).reshape(-1, 4)
        self.xgrp = np.asarray(xgrp, np.int32).reshape(-1, 4)
        self.qgrp = np.asarray(qgrp, np.int32).reshape(-1, 4)
        self.lst = np.asarray(lst, np.int32)

    def _host_tables(self) -> dict:
        return {**super()._host_tables(),
                "coef": (self.coef, torch.float32),
                **{name: (getattr(self, name), torch.int32)
                   for name in ("grp", "cols", "qtab", "slab_base", "slabs",
                                "xgrp", "qgrp", "lst")}}

    def work(self, E: int, has_w: bool):
        """(FLOPs, bytes) the function needs for E edges: coupling products
        over the nonzero CG entries, mid FMAs, the radial scale and the Wcat
        product; each operand read once and the output written once."""
        plan = self.plan
        flops = 0
        for (sl, mul, d1, C, groups) in plan.per_chunk:
            K = C.shape[-1]
            flops += 2 * int(np.count_nonzero(C)) + 2 * d1 * K * mul
            if has_w:
                flops += K * mul
        for k_out, mio in enumerate(plan.irreps_out):
            fan_in, _ = plan.out_plans[k_out]
            flops += 2 * mio.ir.dim * fan_in * mio.mul
        words = E * (self.d_in + self.S + (self.n_ch if has_w else 0)
                     + self.d_out) + len(self.wcat_idx)
        return flops * E, 4 * words

    def work_bwd(self, E: int, has_w: bool, need_dsh: bool = False):
        """(FLOPs, bytes) of the backward for E edges: the mids recomputed
        as in ``work``, the dBLK and dWcat products, dw, the dmid scale, the
        dx FMAs and, with ``need_dsh``, dW and the coupling transpose; x, sh,
        w, gout and Wcat read once, dx, dw, d(flat_w) (and dsh) written once."""
        plan = self.plan
        flops = 0
        for (sl, mul, d1, C, groups) in plan.per_chunk:
            nnz, K = int(np.count_nonzero(C)), C.shape[-1]
            flops += 2 * nnz + 4 * d1 * K * mul
            if has_w:
                flops += 4 * K * mul
            if need_dsh:
                flops += 2 * nnz + 2 * d1 * K * mul
        for k_out, mio in enumerate(plan.irreps_out):
            fan_in, _ = plan.out_plans[k_out]
            flops += 4 * mio.ir.dim * fan_in * mio.mul
        words = E * (2 * self.d_in + self.S + (2 * self.n_ch if has_w else 0)
                     + self.d_out + (self.S if need_dsh else 0)) \
            + 2 * len(self.wcat_idx)
        return flops * E, 4 * words


@functools.lru_cache(maxsize=None)
def _spec_for_key(key) -> KernelSpec:
    return KernelSpec(get_plan(*key))


def get_spec(plan: PackedTPPlan) -> KernelSpec:
    return _spec_for_key(plan.key)


# ----------------------------------------------------------------------
# wrapper
# ----------------------------------------------------------------------

def _check(name, t, shape, device):
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(spec: KernelSpec, x, sh, w, flat_w):
    E = x.shape[0]
    dev = x.device
    _check("x", x, (E, spec.d_in), dev)
    _check("sh", sh, (E, spec.S), dev)
    if w is not None:
        _check("w", w, (E, spec.n_ch), dev)
    out = (torch.empty if spec.fully_covered else torch.zeros)(
        (E, spec.d_out), dtype=torch.float32, device=dev)
    if E == 0 or len(spec.grp) == 0:
        return out
    _check("flat_w", flat_w, (spec.plan.linear_numel,), dev)
    lib = PACKED_TP_FWD.library()
    r_max = max(lib.packed_tp_fwd_rows_per_thread(int(d3), int(V))
                for (_b, d3, V, *_rest) in spec.grp)
    if r_max < 1 or r_max > lib.packed_tp_fwd_max_rows() \
            or spec.d1_max > lib.packed_tp_fwd_max_d1():
        raise ValueError(f"packed_tp_fwd takes at most {lib.packed_tp_fwd_max_rows()} "
                         f"rows per thread and d1 <= {lib.packed_tp_fwd_max_d1()}; "
                         f"this plan needs {r_max} and {spec.d1_max}")
    smem = lib.packed_tp_fwd_smem_bytes(spec.S, spec.nq_all_max, spec.d3_max,
                                        spec.v_max)
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"packed_tp_fwd needs {smem} B of shared memory, "
                         f"the card allows {limit}")
    tb = spec.tables(dev)
    wcat = spec.build_wcat(flat_w).contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    PACKED_TP_FWD.launch(
        x.data_ptr(), sh.data_ptr(), 0 if w is None else w.data_ptr(),
        wcat.data_ptr(), tb["coef"].data_ptr(), tb["grp"].data_ptr(),
        tb["cols"].data_ptr(), tb["qtab"].data_ptr(), out.data_ptr(),
        E, spec.d_in, spec.S, spec.n_ch, spec.d_out, len(spec.grp),
        spec.nq_all_max, spec.d3_max, spec.v_max, r_max, 0 if w is None else 1,
        stream)
    return out


def _launch_bwd(spec: KernelSpec, x, sh, w, flat_w, gout, need_dsh: bool):
    E = x.shape[0]
    dev = x.device
    _check("x", x, (E, spec.d_in), dev)
    _check("sh", sh, (E, spec.S), dev)
    _check("gout", gout, (E, spec.d_out), dev)
    if w is not None:
        _check("w", w, (E, spec.n_ch), dev)
    _check("flat_w", flat_w, (spec.plan.linear_numel,), dev)
    zeros = functools.partial(torch.zeros, dtype=torch.float32, device=dev)
    dx = zeros((E, spec.d_in))
    dsh = zeros((E, spec.S)) if need_dsh else None
    dw = zeros((E, spec.n_ch)) if w is not None else None
    dflat = zeros((spec.plan.linear_numel,))
    if E == 0 or len(spec.grp) == 0:
        return dx, dsh, dw, dflat
    lib = PACKED_TP_BWD.library()
    if lib.packed_tp_bwd_slab_cols() != BWD_SLAB_COLS:
        raise RuntimeError("packed_tp_bwd.cu and tp_kernel.py disagree on the slab width")
    if spec.d1_max > lib.packed_tp_bwd_max_d1() or spec.v_max > 512:
        raise ValueError(f"packed_tp_bwd takes d1 <= {lib.packed_tp_bwd_max_d1()} "
                         f"and V <= 512; this plan needs {spec.d1_max}, {spec.v_max}")
    smem = lib.packed_tp_bwd_smem_bytes(spec.S, spec.nq_all_max, spec.gmax,
                                        spec.d3_max, spec.v_max, int(need_dsh))
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"packed_tp_bwd needs {smem} B of shared memory, "
                         f"the card allows {limit}")
    resident = lib.packed_tp_bwd_resident_blocks(smem)
    if resident < 1:
        raise RuntimeError(f"packed_tp_bwd: no block of {smem} B fits on the card")
    # each block walks a contiguous range of edge tiles, so it alone writes
    # its rows of dx/dw/dsh and its own partial row of dWcat
    n_tiles = -(-E // lib.packed_tp_bwd_tile_edges())
    per_block = -(-n_tiles // min(n_tiles, resident))
    nblk = -(-n_tiles // per_block)
    part = torch.empty((nblk, spec.plan.linear_numel), dtype=torch.float32, device=dev)
    tb = spec.tables(dev)
    wcat = spec.build_wcat(flat_w).contiguous()
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream(dev).cuda_stream
    PACKED_TP_BWD.launch(
        x.data_ptr(), sh.data_ptr(), ptr(w), wcat.data_ptr(), gout.data_ptr(),
        tb["coef"].data_ptr(), tb["grp"].data_ptr(), tb["cols"].data_ptr(),
        tb["qtab"].data_ptr(), tb["slab_base"].data_ptr(), tb["slabs"].data_ptr(),
        tb["xgrp"].data_ptr(), tb["qgrp"].data_ptr(), tb["lst"].data_ptr(),
        tb["wcat_scale"].data_ptr(), tb["wcat_idx"].data_ptr(),
        dx.data_ptr(), ptr(dsh), ptr(dw), part.data_ptr(), dflat.data_ptr(),
        E, spec.d_in, spec.S, spec.n_ch, spec.d_out, len(spec.grp),
        spec.plan.linear_numel, spec.nq_all_max, spec.gmax, spec.d3_max,
        spec.v_max, nblk, per_block, 0 if w is None else 1, int(need_dsh), stream)
    return dx, dsh, dw, dflat


class PackedTP(torch.autograd.Function):
    """The packed pipeline on the card: forward kernel B1, backward kernel
    B2.  Saves only its inputs; B2 recomputes the mids."""

    @staticmethod
    def forward(ctx, x, sh, w, flat_w, spec):
        ctx.spec = spec
        ctx.save_for_backward(x, sh, w, flat_w)
        return _launch(spec, x, sh, w, flat_w)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        x, sh, w, flat_w = ctx.saved_tensors
        dx, dsh, dw, dflat = _launch_bwd(ctx.spec, x, sh, w, flat_w,
                                         gout.contiguous(), ctx.needs_input_grad[1])
        return dx, dsh, dw, dflat, None


def _device_kind(x, name):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    return x.device.type


def packed_tp_forward(plan: PackedTPPlan, x, sh, w, flat_w):
    """The packed pipeline of ``plan``: x (E, d_in), sh (E, S), w (E, n_ch)
    in packed order or None, flat_w (linear_numel,) -> (E, d_out) float32.

    CPU tensors take ``plain_apply``; CUDA tensors launch the kernels (B1
    forward, B2 in the backward)."""
    if _device_kind(x, "packed_tp_forward") == "cpu":
        return plain_apply(plan, x, sh, w, flat_w)
    return PackedTP.apply(x, sh, w, flat_w, get_spec(plan))


def packed_tp_backward(plan: PackedTPPlan, x, sh, w, flat_w, gout,
                       need_dsh: bool = False):
    """Backward of the pipeline for the output gradient ``gout`` (E, d_out):
    (dx, dsh or None, dw or None, d(flat_w)).

    CPU tensors take ``plain_backward``; CUDA tensors launch kernel B2."""
    if _device_kind(x, "packed_tp_backward") == "cpu":
        return plain_backward(plan, x, sh, w, flat_w, gout, need_dsh)
    return _launch_bwd(get_spec(plan), x, sh, w, flat_w, gout.contiguous(), need_dsh)
