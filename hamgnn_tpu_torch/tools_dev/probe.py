"""What the probe modules share: a probe's wrapper, the registry of the probe
kernels, and the check and the measurement of one probe.

A ``Probe`` ties one ``__global__`` function of ``csrc/probe_ops.cu`` or
``csrc/probe_throughput.cu`` to its plain PyTorch version.  Calling it is the
kernel's wrapper: tensors on the CPU take the plain version, CUDA tensors
launch the kernel (and count the launch) or raise.  Every C launcher has the
shape ``probe_<name>(inputs..., out[, scratch], rows, stream)``.

The probes of ``probe_ops.cu`` run at two sizes: the TPU probes' (128 rows,
``k_acc`` 512) and the bench rows (``BENCH_ROWS``, the padded edges of the
``bench.py`` crystal, where B1-B4 use these primitives); the row-wise ones are
also checked at ``ODD_ROWS``, which ends no grid evenly.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import functools
import math
import sys
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..e3.tp_kernel import H100_FP32_FLOPS, H100_HBM_BYTES_PER_S, CudaKernel
from ..utils.profiling import device_time_ms

# H100 SXM dense tensor-core peak with tf32 operands (NVIDIA data sheet)
H100_TF32_FLOPS = 495e12

BENCH_ROWS = 19_968  # bench.py crystal: 19,672 edges padded to a multiple of 512
ODD_ROWS = 1_001     # a row count that fills no grid evenly
SECTOR = 32          # bytes the card moves at least per read of device memory

def device_normal(rng: np.random.Generator, device):
    """A maker of standard-normal fp32 tensors on ``device`` (``t(*shape)``),
    from a generator there seeded by ``rng``: drawing the bench-size inputs
    on the host and copying them takes seconds each."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(2**62)))
    return lambda *shape: torch.randn(shape, generator=gen, device=device, dtype=torch.float32)


# every probe kernel by name ("probe_<name>"), with its count of launches
PROBE_KERNELS: Dict[str, CudaKernel] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int


@dataclasses.dataclass
class Probe:
    """One primitive: its kernel's wrapper (``__call__``), plain version,
    shapes and work.

    ``shapes(rows)``: the input shapes for ``rows`` rows; ``out_shape(rows)``
    the output's.  ``work(rows)``: (FLOPs, bytes) the function needs, what it
    reads of each input read once and the output written once.  ``library``:
    one PyTorch call that computes the same function, timed as a yardstick
    only; ``library_part(out)`` the part of the plain output it computes
    (None: all of it).  ``rows`` is the size the probe runs at, ``bench_rows`` a second
    size it is timed at, ``odd_rows`` one it is only checked at (None: none);
    the kernel takes a multiple of ``row_quantum`` and at most ``max_rows``.
    ``tol``: max|kernel - plain| <= tol * max|plain| on the card.
    """

    name: str
    source: str
    replaces: str
    what: str
    rows: int
    shapes: Callable[[int], Sequence[Tuple[int, ...]]]
    out_shape: Callable[[int], Tuple[int, ...]]
    plain: Callable
    work: Callable[[int], Tuple[int, int]]
    library: Optional[Callable] = None
    library_part: Optional[Callable] = None
    dtype: torch.dtype = torch.float32
    tol: float = 1e-4
    peak_flops: float = H100_FP32_FLOPS
    row_quantum: int = 1
    max_rows: Optional[int] = None
    scratch: Optional[Callable[[int], Tuple[int, ...]]] = None
    bench_rows: Optional[int] = None
    odd_rows: Optional[int] = None

    @property
    def timed_rows(self) -> Tuple[int, ...]:
        """The sizes the probe is timed at: its own, then the bench rows."""
        return tuple(dict.fromkeys(r for r in (self.rows, self.bench_rows) if r))

    @property
    def checked_rows(self) -> Tuple[int, ...]:
        """The sizes the probe is checked at: the timed ones and the odd one."""
        return tuple(dict.fromkeys(r for r in (*self.timed_rows, self.odd_rows) if r))

    def __post_init__(self):
        symbol = f"probe_{self.name}"
        n_ptr = len(self.shapes(self.rows)) + 1 + (self.scratch is not None)
        self.kernel = CudaKernel(symbol, {symbol: ([_P] * n_ptr + [_I, _P], _I)},
                                 source=self.source)
        PROBE_KERNELS[symbol] = self.kernel

    def inputs(self, rng: np.random.Generator, device, rows: Optional[int] = None):
        """Standard-normal inputs at ``rows`` rows (default: the probe's
        size), drawn in fp32 on ``device`` (``device_normal``) and cast to the
        probe's type."""
        t = device_normal(rng, device)
        return [t(*shape).to(self.dtype)
                for shape in self.shapes(self.rows if rows is None else rows)]

    def __call__(self, *tensors):
        dev = tensors[0].device
        if dev.type == "cpu":
            return self.plain(*tensors)
        if dev.type != "cuda":
            raise ValueError(f"probe {self.name} runs on cpu or cuda, not {dev}")
        rows = tensors[0].shape[0]
        want = [tuple(s) for s in self.shapes(rows)]
        if [tuple(t.shape) for t in tensors] != want:
            raise ValueError(f"probe {self.name} takes shapes {want}, got "
                             f"{[tuple(t.shape) for t in tensors]}")
        if rows % self.row_quantum or (self.max_rows and rows > self.max_rows):
            raise ValueError(f"probe {self.name} takes a multiple of {self.row_quantum} "
                             f"rows, at most {self.max_rows}; got {rows}")
        for t in tensors:
            if t.dtype != self.dtype or t.device != dev or not t.is_contiguous() \
                    or t.data_ptr() % 16:
                raise ValueError(f"probe {self.name} takes contiguous, 16-byte aligned "
                                 f"{self.dtype} tensors on one device")
        out = torch.empty(self.out_shape(rows), dtype=self.dtype, device=dev)
        extra = [] if self.scratch is None else [
            torch.empty(self.scratch(rows), dtype=torch.float32, device=dev)]
        self.kernel.launch(*(t.data_ptr() for t in tensors), out.data_ptr(),
                      *(t.data_ptr() for t in extra), rows,
                      torch.cuda.current_stream(dev).cuda_stream)
        return out

    def bound_ms(self, rows: Optional[int] = None) -> Tuple[float, str]:
        """Least time on an H100 for the probe's work, and which side
        bounds it."""
        flops, nbytes = self.work(self.rows if rows is None else rows)
        t_ops = flops / self.peak_flops * 1e3
        t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def words(*shapes) -> int:
    """Elements of tensors of these shapes."""
    return sum(int(np.prod(s)) for s in shapes)


@functools.lru_cache(maxsize=None)
def sector_bytes(rows: int, width: int, cols: Tuple[int, ...]) -> int:
    """Bytes of the 32-byte sectors that hold columns ``cols`` of a (rows,
    width) fp32 row-major array starting on a sector: the least a read of
    just those columns moves.  The sectors repeat every ``period`` rows,
    whose bytes are a whole number of sectors."""
    period = SECTOR // math.gcd(4 * width, SECTOR)

    def sectors(n):
        addr = 4 * (np.arange(n)[:, None] * width + np.asarray(cols)[None, :])
        return len(np.unique(addr // SECTOR))

    full, rest = divmod(rows, period)
    return SECTOR * (full * sectors(period) + sectors(rest))


def rowwise(name, replaces, what, shapes, out_cols, plain, flops_per_row,
            library=None, rows=128, reads=None) -> Probe:
    """A ``probe_ops.cu`` probe whose output has one row of ``out_cols`` per
    input row, timed at ``rows`` and at ``BENCH_ROWS``, checked at
    ``ODD_ROWS`` too.  ``shapes``: the inputs', with None for the row count
    (a shape without None is a weight).  ``reads``: per input, the columns
    the function reads of it (None: all); a part is counted in sectors."""
    reads = reads or [None] * len(shapes)

    def full(n):
        return [tuple(n if d is None else d for d in s) for s in shapes]

    def nbytes(n):
        read = sum(4 * words(s) if cols is None else sector_bytes(s[0], s[1], tuple(cols))
                   for s, cols in zip(full(n), reads))
        return read + 4 * words((n, out_cols))

    return Probe(name=name, source="probe_ops", replaces=replaces, what=what, rows=rows,
                 shapes=full, out_shape=lambda n: (n, out_cols), plain=plain,
                 work=lambda n: (flops_per_row * n, nbytes(n)), library=library,
                 bench_rows=BENCH_ROWS, odd_rows=ODD_ROWS)


def check(probe: Probe, tensors) -> dict:
    """The wrapper against the plain version on ``tensors``: shape, max|d|,
    max|ref| and whether max|d| <= tol * max|ref|.  On CPU tensors the wrapper
    is the plain version, so this only shows that it runs."""
    out = probe(*tensors)
    ref = probe.plain(*tensors)
    if out.is_cuda:
        torch.cuda.synchronize(out.device)
    err = float((out.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    ok = tuple(out.shape) == tuple(ref.shape) and out.dtype == ref.dtype \
        and np.isfinite(err) and err <= probe.tol * scale
    return dict(name=probe.name, ok=bool(ok), shape=tuple(out.shape),
                max_abs_err=err, max_abs_ref=scale, out=out)


def measure(probe: Probe, tensors, n: int = 8, warmup: int = 2) -> dict:
    """Times of the wrapper, of the plain version and of the library call
    (None where there is none) on ``tensors``, the probe's bound and the
    share of it reached (bound / time)."""
    rows = tensors[0].shape[0]
    bound, bound_by = probe.bound_ms(rows)
    flops, nbytes = probe.work(rows)
    ms = device_time_ms(probe, tensors, n=n, warmup=warmup)
    return dict(
        rows=rows, ms=ms,
        plain_ms=device_time_ms(probe.plain, tensors, n=n, warmup=warmup),
        library_ms=None if probe.library is None else device_time_ms(
            probe.library, tensors, n=n, warmup=warmup),
        bound_ms=bound, bound_by=bound_by, share=bound / ms if ms > 0 else None,
        flops=flops, bytes=nbytes)


def run_checks(probes: Sequence[Probe], device, seed: int, rows: Optional[int] = None,
               every_size: bool = False):
    """Check every probe on seeded inputs (at ``rows``, or at each of its
    ``checked_rows`` with ``every_size``) and print ``name: OK shape max|d|``
    or ``FAIL``; yields (probe, tensors, row)."""
    rng = np.random.default_rng(seed)
    for probe in probes:
        for n in probe.checked_rows if every_size else (rows,):
            tensors = probe.inputs(rng, device, n)
            row = check(probe, tensors)
            print(f"{probe.name} [{probe.what}] ({probe.replaces}): "
                  f"{'OK' if row['ok'] else 'FAIL'} {row['shape']} "
                  f"max|d|={row['max_abs_err']:.3e} of max|ref| {row['max_abs_ref']:.3e} "
                  f"(limit {probe.tol:g})", flush=True)
            yield probe, tensors, row


def main_checks(argv, probes: Dict[str, Probe], title: str, doc: str) -> list:
    """The body of ``op_probe.main`` and ``op_probe2.main``: parse ``--device``
    and ``--seed``, check every probe at each of its sizes, show the tile
    semantics of the tiling probes and that ``k_acc`` repeats bit for bit;
    exits non-zero on a FAIL."""
    parser = argparse.ArgumentParser(description=doc.splitlines()[0])
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"{title}: {len(probes)} probes on {describe_device(dev)}")
    rows = []
    for probe, tensors, row in run_checks(list(probes.values()), dev, args.seed,
                                          every_size=True):
        out = row.pop("out")
        if probe.name in ("k_repeat", "k_tile"):
            times = out.shape[1] // tensors[0].shape[1]
            print(f"   tile semantics (a|a|...): {torch.equal(out, tensors[0].repeat(1, times))}")
        if probe.name == "k_acc":
            same = torch.equal(out, probe(*tensors))
            print(f"   a second launch is bit-identical: {same}")
            row["ok"] = row["ok"] and same
        rows.append(row)
    failed = [r["name"] for r in rows if not r["ok"]]
    if failed:
        print(f"{title}: FAILED: {', '.join(failed)}", file=sys.stderr)
        raise SystemExit(1)
    return rows


def describe_device(device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu (plain PyTorch versions; no kernel runs)"
