"""Hopper kernels for the packed TP -> radial scale -> Linear pipeline.

``packed_tp_forward`` is the wrapper of ``csrc/packed_tp_fwd.cu``, the port
of the TPU kernel ``hamgnn_tpu/e3/pallas_tp.py`` ``_fwd_call``;
``packed_tp_backward`` the wrapper of ``csrc/packed_tp_bwd.cu``, the port of
``_bwd_call``.  ``PackedTP`` ties them together as one
``torch.autograd.Function`` (the port of the custom VJP ``_pipeline``).  On
CPU tensors the wrappers run the plain versions (``packed_tp.plain_apply``,
``packed_tp.plain_backward``); on CUDA tensors they launch the kernels or
raise.

``KernelSpec`` is the kernels' host-side schedule, rebuilt from the
reference's ``PallasSpec`` for the GPU: instead of lane layouts (x_perm,
Crep, out_deint, 8-row-aligned Wcat blocks) it holds int32 index tables: one
record per output chunk, per coupling slot of a chunk the nonzero range of
its coupling column, and per BLK column its coupling slot, d1, x offset in
the u-major layout and radial-weight column.  The forward takes a CUDA block
per edge tile and work item (a chunk's (m3, n8) output tiles, at most 64 of
them and 64 of its V columns, ``fitems``).  The backward cuts each chunk's
columns into slabs of at most 64 columns and ``SLAB_SLOTS`` coupling slots:
per slab the coupling slots its columns use (so a block computes only
those), its columns grouped by x offset and by coupling slot (the edge
pass's gathers), and per column its slot base in the slab's list and its
offset in the slab's compact x row; its weight pass takes a block per edge
split and work item (a slab and 32 of its chunk's V columns, ``witems``).
``csrc/packed_tp_mma.cuh`` holds what the kernels share (the 3xTF32
``mma.sync`` product and the one-pass bf16 one, the cp.async copies, the
backward's slab build).

Each kernel has a bf16 instantiation (``HAMGNN_TP_BF16``: ``bwd`` for B2,
``all`` for B1 and B2), and B1/B2 a stored-mid form (``HAMGNN_TP_STOREMID``:
B1 writes the mids in the layout of ``packed_tp.mid_offsets``, B2 reads them);
``PackedTP`` takes both modes, ``PlainPackedTP`` is its plain twin on CPU
tensors, and each launch counts on the ``CudaKernel`` of its variant
(``variant``).

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
import re
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .packed_tp import (PackedTPPlan, chunk_mids, coupling, get_plan, mid_offsets,
                        out_stage, plain_apply, plain_backward, split_mids)

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# H100 SXM peaks used for the bound of a launch (NVIDIA data sheet): fp32 on
# the CUDA cores, dense bf16 on the tensor cores and HBM3 bandwidth.  The
# kernels run their Wcat products on the tensor cores in 3xTF32 (three TF32
# products per fp32 product); the bound of the fp32 kernels keeps counting
# fp32 FLOPs at the CUDA-core rate, so that it compares with earlier kernels
# of the same function.  The bf16 instantiations (HAMGNN_TP_BF16) count
# their Wcat products at the bf16 tensor-core rate and the rest at the fp32
# rate.
H100_FP32_FLOPS = 67e12
H100_BF16_FLOPS = 989e12
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


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def source_files(src: Path) -> list:
    """``src`` and every file it includes with quotes from its own directory,
    recursively (the ``csrc/*.cuh`` headers a ``.cu`` shares)."""
    seen, todo = [], [src]
    while todo:
        f = todo.pop()
        if f in seen or not f.exists():
            continue
        seen.append(f)
        todo += [f.parent / m for m in _INCLUDE.findall(f.read_text())]
    return seen


def is_stale(lib: Path, src: Path) -> bool:
    """True when ``lib`` is missing, or older than ``src`` or a header that
    ``src`` includes."""
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    return any(f.stat().st_mtime > built for f in source_files(src))


def build_kernels(names) -> dict:
    """Compile the named ``csrc/<name>.cu`` sources into shared libraries,
    one nvcc per source, all started together.  Returns {name: (path,
    compiler log)}; a library newer than its source and the headers the
    source includes is reused."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    out = {}
    for name in names:
        src = CSRC / f"{name}.cu"
        lib = BUILD_DIR / f"lib{name}.so"
        if not is_stale(lib, src):
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
    its path went through the kernel.  A variant of a kernel (its bf16
    instantiation, its stored-mid form) is a ``CudaKernel`` of its own with
    the same C entry (``symbol``) and a count of its own; a CUDA graph replays launches without
    passing here, so a replay is counted from a profiler trace by the names
    of the ``__global__`` functions a launch runs, ``device_kernels``.
    """

    _libraries: dict = {}  # source -> loaded library, shared by its kernels

    def __init__(self, name: str, symbols: dict, source: Optional[str] = None,
                 device_kernels: tuple = (), symbol: Optional[str] = None):
        self.name = name
        self.device_kernels = device_kernels
        self.source = source or name
        self.symbol = symbol or name
        self.symbols = {self.symbol: symbols[self.symbol],
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
        rc = getattr(lib, self.symbol)(*args)
        if rc != 0:
            msg = getattr(lib, f"{self.source}_error_string")(rc).decode()
            raise RuntimeError(f"{self.name} launch failed: {msg} ({rc})")
        self.launches += 1


_P = ctypes.c_void_p
_I = ctypes.c_int
PACKED_TP_FWD = CudaKernel("packed_tp_fwd", {
    "packed_tp_fwd": ([_P] * 14 + [_I] * 10 + [_P], _I),
    "packed_tp_fwd_smem_bytes": ([_P, _I, _I], ctypes.c_size_t),
    "packed_tp_fwd_slab_cols": ([], _I),
    "packed_tp_fwd_max_d1": ([], _I),
    "packed_tp_fwd_max_pairs": ([], _I),
    "packed_tp_fwd_item_n8": ([], _I),
    "packed_tp_fwd_resident_blocks": ([ctypes.c_size_t], _I),
}, device_kernels=("packed_tp_fwd_kernel",))

# the backward's C entries share one argument list: packed_tp_bwd runs the
# edge pass, the weight pass and the reduce; packed_tp_bwd_edge and
# packed_tp_bwd_wcat (the weight pass and the reduce) exist to time the
# passes apart and are not counted as launches
_BWD_ARGS = [_P] * 26 + [_I] * 15 + [_P]
PACKED_TP_BWD = CudaKernel("packed_tp_bwd", {
    "packed_tp_bwd": (_BWD_ARGS, _I),
    "packed_tp_bwd_edge": (_BWD_ARGS, _I),
    "packed_tp_bwd_wcat": (_BWD_ARGS, _I),
    "packed_tp_bwd_smem_bytes": ([_P] + [_I] * 6, ctypes.c_size_t),
    "packed_tp_bwd_slab_cols": ([], _I),
    "packed_tp_bwd_max_d1": ([], _I),
    "packed_tp_bwd_tile_edges": ([], _I),
    "packed_tp_bwd_item_n8": ([], _I),
    "packed_tp_bwd_resident_blocks": ([_I, ctypes.c_size_t], _I),
}, device_kernels=("packed_tp_bwd_edge_kernel", "packed_tp_bwd_wcat_kernel",
                   "packed_tp_bwd_reduce"))

# the zonal engine's kernels (wrappers and host tables in zonal_kernel.py);
# as for B2, zonal_tp_bwd runs both passes and the reduce, and the passes'
# own entries exist to time them apart and are not counted as launches
ZONAL_TP_FWD = CudaKernel("zonal_tp_fwd", {
    "zonal_tp_fwd": ([_P] * 11 + [_I] * 8 + [_P], _I),
    "zonal_tp_fwd_smem_bytes": ([_I] * 2, ctypes.c_size_t),
    "zonal_tp_fwd_tile_edges": ([], _I),
    "zonal_tp_fwd_stage_entries": ([], _I),
    "zonal_tp_fwd_item_tiles": ([], _I),
    "zonal_tp_fwd_item_n8": ([], _I),
    "zonal_tp_fwd_resident_blocks": ([ctypes.c_size_t], _I),
}, device_kernels=("zonal_tp_fwd_kernel",))

_ZBWD_ARGS = [_P] * 23 + [_I] * 13 + [_P]
ZONAL_TP_BWD = CudaKernel("zonal_tp_bwd", {
    "zonal_tp_bwd": (_ZBWD_ARGS, _I),
    "zonal_tp_bwd_edge": (_ZBWD_ARGS, _I),
    "zonal_tp_bwd_wcat": (_ZBWD_ARGS, _I),
    "zonal_tp_bwd_smem_bytes": ([_I] * 4, ctypes.c_size_t),
    "zonal_tp_bwd_tile_edges": ([], _I),
    "zonal_tp_bwd_stage_entries": ([], _I),
    "zonal_tp_bwd_item_entries": ([], _I),
    "zonal_tp_bwd_item_n8": ([], _I),
    "zonal_tp_bwd_wcat_tile_edges": ([], _I),
    "zonal_tp_bwd_resident_blocks": ([_I, ctypes.c_size_t], _I),
}, device_kernels=("zonal_tp_bwd_edge_kernel", "zonal_tp_bwd_wcat_kernel",
                   "zonal_tp_bwd_reduce"))

# every kernel of the port, by name (chip_smoke.py resets and reads the counts)
KERNELS = {"packed_tp_fwd": PACKED_TP_FWD, "packed_tp_bwd": PACKED_TP_BWD,
           "zonal_tp_fwd": ZONAL_TP_FWD, "zonal_tp_bwd": ZONAL_TP_BWD}


def _variant(base: CudaKernel, suffix: str) -> CudaKernel:
    return CudaKernel(f"{base.name}_{suffix}", {n: base.symbols[n] for n in base.symbols},
                      source=base.source, device_kernels=base.device_kernels,
                      symbol=base.symbol)


# the kernels' variants, each counted apart from its kernel: the bf16
# instantiations of B1-B4 (HAMGNN_TP_BF16; each C entry takes its precision
# as an argument and launches the instantiation of that precision), and the
# stored-mid pair (HAMGNN_TP_STOREMID: B1 writing its mids, B2 reading them,
# in either precision)
VARIANTS = {v.name: v for v in (
    *(_variant(k, "bf16") for k in KERNELS.values()),
    _variant(PACKED_TP_FWD, "storemid"), _variant(PACKED_TP_BWD, "storemid"))}


def variant(name: str, bf16: bool, stored: bool = False) -> CudaKernel:
    """The counted kernel of a launch of ``name``: its stored-mid form where
    the launch writes or reads the mids, else its bf16 or fp32 form."""
    if stored:
        return VARIANTS[f"{name}_storemid"]
    return VARIANTS[f"{name}_bf16"] if bf16 else KERNELS[name]

# columns per slab (packed_tp_fwd.cu, packed_tp_bwd.cu KS)
BWD_SLAB_COLS = 64
# coupling slots a slab of the backward may use (one group of a column's
# d1 x d3 slots may exceed it alone): it bounds its passes' shared memory
SLAB_SLOTS = 192
# edges per tile of the lab-frame kernels (packed_tp_mma.cuh TE)
TILE_EDGES = 16
# waves of resident blocks the backward's weight pass is cut into
WCAT_WAVES = 6
# (m3, n8) output tiles and n8 tiles of V a work item of the forward holds
# (packed_tp_fwd.cu: 16 warps of at most 4 tiles each), and the n8 tiles of V
# of a work item of the backward's weight pass (packed_tp_bwd.cu: 4 n8 tiles
# of accumulators a warp)
ITEM_PAIRS = 64
ITEM_N8 = 8
WCAT_ITEM_N8 = 4


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
    def _bound(flops: int, nbytes: int, bf16_flops: int = 0) -> tuple:
        t_ops = ((flops - bf16_flops) / H100_FP32_FLOPS + bf16_flops / H100_BF16_FLOPS) * 1e3
        t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

    def wcat_flops(self, E: int) -> int:
        """FLOPs of the forward's Wcat product for E edges (the backward has
        two products of this size)."""
        raise NotImplementedError

    def bound_ms(self, E: int, has_w: bool, bf16: bool = False, **kw) -> tuple:
        """Least time on an H100 for E edges, and which side bounds it; with
        ``bf16`` the Wcat product at the bf16 tensor-core rate."""
        return self._bound(*self.work(E, has_w, **kw), self.wcat_flops(E) if bf16 else 0)

    def bound_bwd_ms(self, E: int, has_w: bool, bf16: bool = False, **kw) -> tuple:
        """Least time on an H100 for the backward of E edges."""
        return self._bound(*self.work_bwd(E, has_w, **kw),
                           2 * self.wcat_flops(E) if bf16 else 0)


class KernelSpec(PipelineSpec):
    """Index tables of one plan for ``packed_tp_fwd.cu`` and
    ``packed_tp_bwd.cu``.

    ``grp``: one record per covered output chunk: out offset b, d3, V, Wcat
    offset, fan_in, column offset, coupling-slot offset, slots per m3 (nq).
    ``qtab``: per coupling slot (m3-major, then source, path, i) its
    coefficient offset, first SH component and count; ``coef`` the nonzero
    coupling values.  ``fcols`` (the forward's): per BLK column its slot
    offset qb within an m3 block, d1, x offset and radial-weight column; its
    slot for (m3, i) is ``qtab[q_ofs + m3 * nq + qb + i]``.  ``fitems`` (the
    forward's work items): chunk, first n8 tile, n8 tiles, each item at most
    ``ITEM_N8`` n8 tiles and ``ITEM_PAIRS`` (m3, n8) tiles.  The backward's
    slabs: ``_build_slabs``; ``slab_base[k] : slab_base[k + 1]`` are chunk
    k's; ``cols``: per BLK column its slot base in its slab's list ``sq``,
    d1, offset in the slab's compact x row and radial-weight column; its
    slot for (m3, i) is ``sq[sq_ofs + base + m3 * d1 + i]``.  ``mcols``: per
    BLK column (in ``fcols`` order) where the stored mids hold it
    (``HAMGNN_TP_STOREMID``): its column at m3 = 0 in the (E, ``midw``) layout
    of ``packed_tp.mid_offsets``, and the step from one m3 to the next.
    """

    def __init__(self, plan: PackedTPPlan):
        super().__init__(plan)
        self.S = plan.irreps_sh.dim

        grp, cols, qtab, coef, mcols = [], [], [], [], []
        mid_ofs, self.midw = mid_offsets(plan)
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
                                mcols.append((mid_ofs[g] + (k0 + j) * mul + u, n_cols * mul))
                    q_src += n_cols * d1
            nq = (len(qtab) - q_ofs) // d3
            grp.append((b, d3, V, wofs, fan_in, col_ofs, q_ofs, nq))
        self.grp = np.asarray(grp, np.int32).reshape(-1, 8)
        self.qtab = np.asarray(qtab, np.int32).reshape(-1, 3)
        self.coef = np.asarray(coef, np.float32)
        self.fcols = np.asarray(cols, np.int32).reshape(-1, 4)
        self.mcols = np.asarray(mcols, np.int32).reshape(-1, 2)
        g = self.grp
        self.nq_all_max = int((g[:, 1] * g[:, 7]).max()) if len(g) else 0
        items = []
        for k, (_b, d3, V, *_rest) in enumerate(self.grp):
            n8 = -(-int(V) // 8)
            per = max(1, min(ITEM_N8, ITEM_PAIRS // int(d3)))
            items += [(k, t0, min(per, n8 - t0)) for t0 in range(0, n8, per)]
        self.fitems = np.asarray(items, np.int32).reshape(-1, 3)
        self.fwd_pairs = max((int(self.grp[k][1]) * n for k, _t, n in items), default=0)
        self._build_slabs(self.fcols)

    def _build_slabs(self, cols):
        """Cut each chunk's columns (``cols``: slot offset qb within an m3
        block, d1, x offset, radial-weight column) into slabs of at most
        ``BWD_SLAB_COLS`` columns, ending a slab early where a new coupling
        group would take its slots past ``SLAB_SLOTS``.  A coupling group is
        the columns of one (qb, d1) (the u of one path); its slots are
        ``d3 * d1``, listed in ``sq`` group by group, m3-major, each as its
        qtab record (coefficient offset, first SH component, count).  An x
        group is the columns of one (x offset, d1); the slab's x values are
        gathered into a compact row, group by group, whose x offsets are
        ``xmap``.  Per slab (``slabs``): chunk, first column, columns, offset
        and count in ``sq``, offset and count of its x groups and of its slot
        groups, offset and length of its compact x row in ``xmap``.  Groups
        are (compact x offset or slot base, d1, offset into ``lst``, count),
        ``lst`` holding the chunk-relative columns of each group in column
        order.  ``cols`` keeps d1 and the radial-weight column, with qb
        replaced by the column's slot base and the x offset by its compact x
        offset in its slab.  ``witems``: the weight pass's work items, (slab,
        first V column) for every ``8 * WCAT_ITEM_N8`` columns of V of each
        slab, the slabs by work, largest first."""
        slab_base, slabs, sq, xmap, xgrp, qgrp, lst, cost = [], [], [], [], [], [], [], []
        cols = cols.copy()
        for k, (_b, d3, _V, _wofs, fan_in, col_ofs, q_ofs, nq) in enumerate(self.grp):
            slab_base.append(len(slabs))
            c = 0
            while c < fan_in:
                c0, groups, n_sq = c, {}, 0
                while c < fan_in and c - c0 < BWD_SLAB_COLS:
                    key = (int(cols[col_ofs + c][0]), int(cols[col_ofs + c][1]))
                    if key not in groups:
                        if groups and n_sq + key[1] * d3 > SLAB_SLOTS:
                            break
                        groups[key] = n_sq
                        n_sq += key[1] * d3
                    c += 1
                by_x, by_q, xbase = {}, {}, {}
                xm_ofs = len(xmap)
                for cc in range(c0, c):
                    qb, d1, xb, _wc = (int(v) for v in cols[col_ofs + cc])
                    if xb not in xbase:
                        xbase[xb] = len(xmap) - xm_ofs
                        xmap.extend(range(xb, xb + d1))
                    by_x.setdefault((xbase[xb], d1), []).append(cc)
                    by_q.setdefault((groups[(qb, d1)], d1), []).append(cc)
                    cols[col_ofs + cc][0] = groups[(qb, d1)]
                    cols[col_ofs + cc][2] = xbase[xb]
                slabs.append((k, c0, c - c0, len(sq), n_sq, len(xgrp), len(by_x),
                              len(qgrp), len(by_q), xm_ofs, len(xmap) - xm_ofs))
                cost.append(d3 * sum(int(cols[col_ofs + cc][1]) + 1 for cc in range(c0, c)))
                for (qb, d1) in groups:
                    sq.extend(self.qtab[q_ofs + m3 * nq + qb + i]
                              for m3 in range(d3) for i in range(d1))
                append_groups(by_x, xgrp, lst)
                append_groups(by_q, qgrp, lst)
        slab_base.append(len(slabs))
        self.cols = cols
        self.slab_base = np.asarray(slab_base, np.int32)
        self.slabs = np.asarray(slabs, np.int32).reshape(-1, 11)
        self.sq = np.asarray(sq, np.int32).reshape(-1, 3)
        self.xmap = np.asarray(xmap, np.int32)
        self.xgrp = np.asarray(xgrp, np.int32).reshape(-1, 4)
        self.qgrp = np.asarray(qgrp, np.int32).reshape(-1, 4)
        self.lst = np.asarray(lst, np.int32)
        vb = 8 * WCAT_ITEM_N8
        self.witems = np.asarray(
            [(si, v0) for si in np.argsort(-np.asarray(cost), kind="stable")
             for v0 in range(0, int(self.grp[slabs[si][0]][2]), vb)], np.int32).reshape(-1, 2)
        self.sq_max = int(self.slabs[:, 4].max()) if len(self.slabs) else 0
        self.nx_max = int(self.slabs[:, 10].max()) if len(self.slabs) else 0

    def _host_tables(self) -> dict:
        return {**super()._host_tables(),
                "coef": (self.coef, torch.float32),
                **{name: (getattr(self, name), torch.int32)
                   for name in ("grp", "qtab", "fcols", "fitems", "cols", "slab_base",
                                "slabs", "sq", "xmap", "xgrp", "qgrp", "lst", "witems",
                                "mcols")}}

    def wcat_splits(self, E: int, resident: int) -> int:
        """Edge splits of the backward's weight pass: enough (work item,
        split) blocks for ``WCAT_WAVES`` waves of ``resident`` blocks, so that
        the slabs' unequal work (d3 times the sum of their columns' d1) evens
        out across the card; at most one split per edge tile."""
        n_tiles = -(-E // TILE_EDGES)
        return max(1, min(n_tiles, -(-WCAT_WAVES * resident // max(1, len(self.witems)))))

    def wcat_flops(self, E: int) -> int:
        return E * sum(2 * int(d3) * int(fan_in) * int(V)
                       for (_b, d3, V, _wofs, fan_in, *_r) in self.grp)

    def work(self, E: int, has_w: bool, stored: bool = False):
        """(FLOPs, bytes) the function needs for E edges: coupling products
        over the nonzero CG entries, mid FMAs, the radial scale and the Wcat
        product; each operand read once and the output (and with ``stored``
        the mids) written once."""
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
                     + self.d_out + (self.midw if stored else 0)) + len(self.wcat_idx)
        return flops * E, 4 * words

    def work_bwd(self, E: int, has_w: bool, need_dsh: bool = False, stored: bool = False):
        """(FLOPs, bytes) of the backward for E edges: the mids recomputed
        as in ``work`` (read instead with ``stored``), the dBLK and dWcat
        products, dw, the dmid scale, the dx FMAs and, with ``need_dsh``, dW
        and the coupling transpose; x, sh, w, gout and Wcat read once, dx,
        dw, d(flat_w) (and dsh) written once."""
        plan = self.plan
        flops = 0
        for (sl, mul, d1, C, groups) in plan.per_chunk:
            nnz, K = int(np.count_nonzero(C)), C.shape[-1]
            flops += 2 * nnz + (2 if stored else 4) * d1 * K * mul
            if has_w:
                flops += 4 * K * mul
            if need_dsh:
                flops += 2 * nnz + 2 * d1 * K * mul
        for k_out, mio in enumerate(plan.irreps_out):
            fan_in, _ = plan.out_plans[k_out]
            flops += 4 * mio.ir.dim * fan_in * mio.mul
        words = E * (2 * self.d_in + self.S + (2 * self.n_ch if has_w else 0)
                     + self.d_out + (self.S if need_dsh else 0)
                     + (self.midw if stored else 0)) + 2 * len(self.wcat_idx)
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


def _smem_limit(name, smem, dev):
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"{name} needs {smem} B of shared memory, the card allows {limit}")


def _check_limits(lib, name, spec):
    slab_cols = getattr(lib, f"{name}_slab_cols")()
    max_d1 = getattr(lib, f"{name}_max_d1")()
    if slab_cols != BWD_SLAB_COLS:
        raise RuntimeError(f"{name}.cu and tp_kernel.py disagree on the slab width")
    if spec.d1_max > max_d1:
        raise ValueError(f"{name} takes d1 <= {max_d1}; this plan needs {spec.d1_max}")


def _check_mids(spec: KernelSpec, mids, E, dev):
    if mids is not None:
        _check("mids", mids, (E, spec.midw), dev)


def _launch(spec: KernelSpec, x, sh, w, flat_w, bf16: bool = False, mids=None):
    """One launch of B1, in bf16 with ``bf16``; with ``mids`` (an (E, midw)
    float32 buffer) it also writes its mids there."""
    E = x.shape[0]
    dev = x.device
    _check("x", x, (E, spec.d_in), dev)
    _check("sh", sh, (E, spec.S), dev)
    if w is not None:
        _check("w", w, (E, spec.n_ch), dev)
    _check_mids(spec, mids, E, dev)
    out = (torch.empty if spec.fully_covered else torch.zeros)(
        (E, spec.d_out), dtype=torch.float32, device=dev)
    if E == 0 or len(spec.grp) == 0:
        return out
    _check("flat_w", flat_w, (spec.plan.linear_numel,), dev)
    lib = PACKED_TP_FWD.library()
    _check_limits(lib, "packed_tp_fwd", spec)
    if (lib.packed_tp_fwd_max_pairs() != ITEM_PAIRS or lib.packed_tp_fwd_item_n8() != ITEM_N8):
        raise RuntimeError("packed_tp_fwd.cu and tp_kernel.py disagree on the work items")
    if spec.fwd_pairs > ITEM_PAIRS:
        raise ValueError(f"packed_tp_fwd takes at most {ITEM_PAIRS} (m3, n8) output tiles "
                         f"per work item; this plan needs {spec.fwd_pairs}")
    grp_host = spec.grp.ctypes.data
    _smem_limit("packed_tp_fwd", lib.packed_tp_fwd_smem_bytes(grp_host, len(spec.grp),
                                                              spec.S), dev)
    tb = spec.tables(dev)
    wcat = spec.build_wcat(flat_w).contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    variant("packed_tp_fwd", bf16, mids is not None).launch(
        x.data_ptr(), sh.data_ptr(), 0 if w is None else w.data_ptr(),
        wcat.data_ptr(), tb["coef"].data_ptr(), tb["grp"].data_ptr(),
        tb["fcols"].data_ptr(), tb["qtab"].data_ptr(), tb["fitems"].data_ptr(),
        out.data_ptr(), 0 if mids is None else mids.data_ptr(), tb["mcols"].data_ptr(),
        grp_host, spec.fitems.ctypes.data,
        E, spec.d_in, spec.S, spec.n_ch, spec.d_out, len(spec.grp), len(spec.fitems),
        0 if w is None else 1, spec.midw, int(bf16), stream)
    return out


def bwd_call(spec: KernelSpec, x, sh, w, flat_w, gout, need_dsh: bool, bf16: bool = False,
             mids=None):
    """Checks the backward's inputs, allocates its outputs and returns
    ``(outputs, call)``: (dx, dsh or None, dw or None, d(flat_w)) and
    ``(args, tensors)``, the argument list of the C entries (``packed_tp_bwd``
    and the passes alone) and the scratch tensors behind its pointers, which
    the caller keeps while it launches (``call`` is None where there is
    nothing to launch).  The edge pass writes dx, dw and dsh into the zeroed
    outputs; the weight pass writes one partial row of dWcat per edge split,
    which the reduce sums into d(flat_w).  ``bf16``: the bf16 instantiation;
    ``mids``: the forward's stored mids, read by both passes in place of the
    recompute."""
    E = x.shape[0]
    dev = x.device
    _check("x", x, (E, spec.d_in), dev)
    _check("sh", sh, (E, spec.S), dev)
    _check("gout", gout, (E, spec.d_out), dev)
    if w is not None:
        _check("w", w, (E, spec.n_ch), dev)
    _check("flat_w", flat_w, (spec.plan.linear_numel,), dev)
    _check_mids(spec, mids, E, dev)
    zeros = functools.partial(torch.zeros, dtype=torch.float32, device=dev)
    dx = zeros((E, spec.d_in))
    dsh = zeros((E, spec.S)) if need_dsh else None
    dw = zeros((E, spec.n_ch)) if w is not None else None
    dflat = zeros((spec.plan.linear_numel,))
    outs = (dx, dsh, dw, dflat)
    if E == 0 or len(spec.grp) == 0:
        return outs, None
    lib = PACKED_TP_BWD.library()
    _check_limits(lib, "packed_tp_bwd", spec)
    if (lib.packed_tp_bwd_tile_edges() != TILE_EDGES
            or lib.packed_tp_bwd_item_n8() != WCAT_ITEM_N8):
        raise RuntimeError("packed_tp_bwd.cu and tp_kernel.py disagree on the tile size "
                           "or the weight pass's work items")
    grp_host = spec.grp.ctypes.data
    smem = [lib.packed_tp_bwd_smem_bytes(grp_host, len(spec.grp), spec.S, spec.sq_max,
                                         spec.nx_max, int(need_dsh), pass_) for pass_ in (0, 1)]
    for nbytes in smem:
        _smem_limit("packed_tp_bwd", nbytes, dev)
    per_sm = lib.packed_tp_bwd_resident_blocks(1, smem[1])
    if per_sm < 1:
        raise RuntimeError("packed_tp_bwd: no block of the weight pass fits on an SM")
    resident = per_sm * torch.cuda.get_device_properties(dev).multi_processor_count
    n_split = spec.wcat_splits(E, resident)
    part = torch.empty((n_split, spec.plan.linear_numel), dtype=torch.float32, device=dev)
    tb = spec.tables(dev)
    wcat = spec.build_wcat(flat_w).contiguous()
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    args = (x.data_ptr(), sh.data_ptr(), ptr(w), wcat.data_ptr(), gout.data_ptr(),
            *(tb[n].data_ptr() for n in ("coef", "grp", "cols", "slab_base", "slabs", "sq",
                                         "xmap", "xgrp", "qgrp", "lst", "witems",
                                         "wcat_scale", "wcat_idx")),
            dx.data_ptr(), ptr(dsh), ptr(dw), part.data_ptr(), dflat.data_ptr(), grp_host,
            ptr(mids), tb["mcols"].data_ptr(),
            E, spec.d_in, spec.S, spec.n_ch, spec.d_out, len(spec.grp), len(spec.witems),
            spec.plan.linear_numel, spec.sq_max, spec.nx_max, n_split, 0 if w is None else 1,
            int(need_dsh), spec.midw, int(bf16), torch.cuda.current_stream(dev).cuda_stream)
    return outs, (args, (wcat, part))


def _launch_bwd(spec: KernelSpec, x, sh, w, flat_w, gout, need_dsh: bool, bf16: bool = False,
                mids=None):
    outs, call = bwd_call(spec, x, sh, w, flat_w, gout, need_dsh, bf16, mids)
    if call is not None:
        variant("packed_tp_bwd", bf16, mids is not None).launch(*call[0])
    return outs


def _modes(bf16: str):
    """The forward's and the backward's precision under ``HAMGNN_TP_BF16``
    (``packed_tp.bf16_mode``): bf16 products in both with ``all``, in the
    backward alone with ``bwd``."""
    if bf16 not in ("", "bwd", "all"):
        raise ValueError(f"bf16 mode {bf16!r}: expected '', 'bwd' or 'all'")
    return bf16 == "all", bf16 in ("bwd", "all")


class PackedTP(torch.autograd.Function):
    """The packed pipeline on the card: forward kernel B1, backward kernel
    B2, each in the precision of the bf16 mode.  Saves its inputs, and with
    ``storemid`` the mids B1 writes, which B2 then reads instead of
    recomputing them (``pallas_tp._pipeline_fwd``)."""

    @staticmethod
    def forward(ctx, x, sh, w, flat_w, spec, bf16="", storemid=False):
        ctx.spec = spec
        ctx.bf16 = _modes(bf16)[1]
        fwd_bf16 = _modes(bf16)[0]
        mids = torch.empty((x.shape[0], spec.midw), dtype=torch.float32,
                           device=x.device) if storemid else None
        ctx.save_for_backward(x, sh, w, flat_w, mids)
        return _launch(spec, x, sh, w, flat_w, fwd_bf16, mids)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        x, sh, w, flat_w, mids = ctx.saved_tensors
        dx, dsh, dw, dflat = _launch_bwd(ctx.spec, x, sh, w, flat_w, gout.contiguous(),
                                         ctx.needs_input_grad[1], ctx.bf16, mids)
        return dx, dsh, dw, dflat, None, None, None


class PlainPackedTP(torch.autograd.Function):
    """The same on CPU tensors, through the plain versions: ``plain_apply``
    forward, ``plain_backward`` backward, each in the precision of the bf16
    mode, the forward's mids kept for the backward with ``storemid``."""

    @staticmethod
    def forward(ctx, x, sh, w, flat_w, plan, bf16="", storemid=False):
        fwd_bf16, ctx.bf16 = _modes(bf16)
        ctx.plan = plan
        mids = chunk_mids(plan, x, coupling(plan, sh, fwd_bf16))
        ctx.mids = mids if storemid else None
        ctx.save_for_backward(x, sh, w, flat_w)
        if not any(m is not None for m in mids):
            return x.new_zeros((x.shape[0], plan.irreps_out.dim))
        return out_stage(plan, mids, w, flat_w, fwd_bf16)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        x, sh, w, flat_w = ctx.saved_tensors
        dx, dsh, dw, dflat = plain_backward(ctx.plan, x, sh, w, flat_w, gout,
                                            ctx.needs_input_grad[1], ctx.bf16, ctx.mids)
        return dx, dsh, dw, dflat, None, None, None


def _device_kind(x, name):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    return x.device.type


def packed_tp_forward(plan: PackedTPPlan, x, sh, w, flat_w, bf16: str = "",
                      storemid: bool = False):
    """The packed pipeline of ``plan``: x (E, d_in), sh (E, S), w (E, n_ch)
    in packed order or None, flat_w (linear_numel,) -> (E, d_out) float32.
    ``bf16``: the mode of ``HAMGNN_TP_BF16`` (``""``, ``"bwd"`` or ``"all"``);
    ``storemid``: that of ``HAMGNN_TP_STOREMID``.

    CPU tensors take the plain versions (``PlainPackedTP``); CUDA tensors
    launch the kernels (B1 forward, B2 in the backward)."""
    if _device_kind(x, "packed_tp_forward") == "cpu":
        return PlainPackedTP.apply(x, sh, w, flat_w, plan, bf16, storemid)
    return PackedTP.apply(x, sh, w, flat_w, get_spec(plan), bf16, storemid)


def packed_tp_store_forward(plan: PackedTPPlan, x, sh, w, flat_w, bf16: bool = False):
    """The pipeline's forward with its mids kept, outside autograd: (out,
    mids), the mids (E, midw) in the layout of ``packed_tp.mid_offsets``
    (``pallas_tp._fwd_call(store_mid=True)``).  CPU tensors take the plain
    versions; CUDA tensors launch B1, which writes the mids."""
    if _device_kind(x, "packed_tp_store_forward") == "cpu":
        mids = chunk_mids(plan, x, coupling(plan, sh, bf16))
        flat = torch.cat([m for m in mids if m is not None], dim=1) if any(
            m is not None for m in mids) else x.new_zeros((x.shape[0], 0))
        return plain_apply(plan, x, sh, w, flat_w, bf16), flat
    spec = get_spec(plan)
    mids = torch.empty((x.shape[0], spec.midw), dtype=torch.float32, device=x.device)
    return _launch(spec, x, sh, w, flat_w, bf16, mids), mids


def packed_tp_backward(plan: PackedTPPlan, x, sh, w, flat_w, gout,
                       need_dsh: bool = False, bf16: bool = False, mids=None):
    """Backward of the pipeline for the output gradient ``gout`` (E, d_out):
    (dx, dsh or None, dw or None, d(flat_w)); with ``bf16`` in the bf16
    instantiation, with ``mids`` (from ``packed_tp_store_forward``) reading
    the stored mids instead of recomputing them.

    CPU tensors take ``plain_backward``; CUDA tensors launch kernel B2."""
    if _device_kind(x, "packed_tp_backward") == "cpu":
        return plain_backward(plan, x, sh, w, flat_w, gout, need_dsh, bf16,
                              None if mids is None else split_mids(plan, mids))
    return _launch_bwd(get_spec(plan), x, sh, w, flat_w, gout.contiguous(), need_dsh, bf16,
                       mids)
