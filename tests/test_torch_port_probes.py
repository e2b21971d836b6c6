"""The port's probes (``hamgnn_tpu_torch/tools_dev``) against the primitives
of the TPU probes, on the CPU.

The Pallas closures of ``tools_dev/mosaic_probe.py`` / ``mosaic_probe2.py``
(the second runs at import) live inside functions and cannot be imported or
run in interpret mode, so each primitive is stated here in ``jax.numpy``
exactly as its closure states it (the file:line is quoted; ``pltpu.repeat``
is the tile that ``mosaic_probe2.py:37-41`` found it to be) and compared with
the port's ``plain_<name>`` on the same seeded inputs: rtol 1e-5 and atol
1e-5 * max(1, max|ref|) in fp32 (only the summation order differs; the sums
run over up to 2,048 terms of size one), 2e-2 of max|ref| for the bf16 form.  On CPU tensors a probe's wrapper is its plain version and counts no
launch.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hamgnn_tpu_torch.e3 import tp_kernel
from hamgnn_tpu_torch.tools_dev import op_probe, op_probe2, probe, throughput_probe
from hamgnn_tpu_torch.utils.profiling import device_time_ms

ALL = {**op_probe.PROBES, **op_probe2.PROBES, **throughput_probe.PROBES}
P3_ROWS = 128  # small E for the throughput probes here


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tensors here are tiny and the sweeps are thousands of small ops:
    intra-op threads only contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tile(a, n):
    return jnp.tile(a, (1, n))


def _p1(x, sh, crep):  # vpu_probe.py:73-83
    S, D1, MUL, K, KM = 25, 5, 24, 40, 960
    midf = None
    for i in range(D1):
        W = jnp.dot(sh, crep[:, i * KM:(i + 1) * KM], preferred_element_type=jnp.float32)
        term = W * _tile(x[:, i * MUL:(i + 1) * MUL], K)
        midf = term if midf is None else midf + term
    return midf


def _p3(x, sh, crep):  # vpu_probe.py:104-119
    D1, MUL, K, KM = 5, 24, 40, 960
    W = jnp.dot(sh, crep, preferred_element_type=jnp.float32)
    B = jnp.concatenate([_tile(x[:, i * MUL:(i + 1) * MUL], K) for i in range(D1)], axis=1)
    prod = W * B
    n = D1
    while n > 1:
        h = n // 2
        prod = prod[:, :h * KM] + prod[:, h * KM:2 * h * KM] if n % 2 == 0 \
            else jnp.concatenate([prod[:, :h * KM] + prod[:, h * KM:2 * h * KM],
                                  prod[:, 2 * h * KM:]], axis=1)
        n = n - h
    return prod[:, :KM]


def _p4(a, b):  # vpu_probe.py:136-140, in the inputs' type
    acc = a
    for _ in range(8):
        acc = acc * b
    return acc


def _p4c(a, b, ns=8):  # vpu_probe.py:176-180
    acc = a
    for _ in range(ns):
        acc = acc + a * b
    return acc


def _k_acc(a):  # mosaic_probe2.py:111-118 over its grid of 4 (:122-127)
    o = jnp.zeros((64, 32), jnp.float32)
    for i in range(a.shape[0] // 128):
        t = a[i * 128:(i + 1) * 128]
        o = o.at[3:3 + 48, :24].add(jax.lax.dot_general(
            t, t[:, :24], (((0,), (0,)), ((), ())), preferred_element_type=jnp.float32))
    return o


# name -> the closure's statement in jax.numpy (TE, K, MUL as in its file)
JAX_FORMS = {
    # tools_dev/mosaic_probe.py, TE=128, K=16, MUL=64
    "k_repeat": lambda a: _tile(a, 4),                                          # :38
    "k_squeeze": lambda a: a.reshape(-1, 16, 64)[:, 3:4, :].reshape(-1, 64),    # :49-50
    "k_merge128": lambda a: (a.reshape(-1, 8, 128) + 1.0).reshape(-1, 1024),    # :57-58
    "k_merge64": lambda a: (a.reshape(-1, 16, 64) + 1.0).reshape(-1, 1024),     # :65-66
    "k_outer": lambda a, b: jnp.sum(a[:, :, None] * b[:, None, :], axis=1),     # :72-73
    "k_lred": lambda a: jnp.sum(a.reshape(-1, 16, 64), axis=2),                 # :80-81
    "k_atadd": lambda a: jnp.zeros((a.shape[0], 1024), jnp.float32)
    .at[:, 64:64 + 128].add(a[:, :128]),                                        # :87-89
    "k_gather": lambda a: a[:, jnp.asarray(np.arange(0, 1024, 16, dtype=np.int32))],  # :95-96
    "k_dot": lambda a, b: jnp.dot(a, b, preferred_element_type=jnp.float32),    # :102
    "k_slice_dot": lambda a, b: jnp.dot(                                        # :111-114
        a.reshape(-1, 16, 64)[:, 2:4, :][:, 0:1, :].reshape(-1, 64)
        + a.reshape(-1, 16, 64)[:, 2:4, :][:, 1:2, :].reshape(-1, 64), b,
        preferred_element_type=jnp.float32),
    # tools_dev/mosaic_probe2.py, TE=128, K=25, MUL=48
    "k_tile": lambda a: _tile(a, 25),                                           # :34
    "k_erep": lambda a: jnp.repeat(a, 48, axis=1),                              # :45
    "k_split_sum": lambda a: jnp.sum(a.reshape(-1, 25, 48), axis=1),            # :56-57
    "k_bc_merge": lambda a: jnp.broadcast_to(a[:, :, None], (a.shape[0], 25, 48))
    .reshape(-1, 1200),                                                         # :68-70
    "k_rep_slice": lambda a: _tile(a[:, 3:3 + 7], 5),                           # :77
    "k_concat": lambda a: jnp.concatenate(
        [a[:, i * 48:(i + 1) * 48] * float(i) for i in range(25)], axis=1),     # :84-85
    "k_dot_odd": lambda a, b: jnp.dot(a[:, 7:7 + 120], b,
                                      preferred_element_type=jnp.float32),      # :92-93
    "k_dot_t": lambda a, b: jax.lax.dot_general(
        a, b, (((0,), (0,)), ((), ())), preferred_element_type=jnp.float32),    # :101-103
    "k_acc": _k_acc,
    # tools_dev/vpu_probe.py, S=25, D1=5, MUL=24, K=40
    "p1": _p1,
    "p3": _p3,
    "p4": _p4,
    "p4b": _p4,
    "p4c": _p4c,
    "p4c_ns256": lambda a, b: _p4c(a, b, 256),  # the same closure at 256 sweeps
    "p5": lambda x: jnp.concatenate(
        [_tile(x[:, i * 24:(i + 1) * 24], 40) for i in range(5)], axis=1),      # :196-199
    "p6": lambda a, b: jnp.dot(a, b, preferred_element_type=jnp.float32),       # :215-217
    "p7": lambda a, b: jnp.dot(a, b, preferred_element_type=jnp.float32),       # :238-240
    "p7_tf32": lambda a, b: jnp.dot(a, b, preferred_element_type=jnp.float32),
}


def _inputs(p, seed=3):
    rows = P3_ROWS if p.source == "probe_throughput" else None
    return p.inputs(np.random.default_rng(seed), "cpu", rows)


def test_every_closure_has_a_probe():
    assert set(JAX_FORMS) == set(ALL)
    assert len(op_probe.PROBES) == 10 and len(op_probe2.PROBES) == 9
    assert set(throughput_probe.PROBES) == {"p1", "p3", "p4", "p4b", "p4c", "p4c_ns256",
                                            "p5", "p6", "p7", "p7_tf32"}


@pytest.mark.parametrize("name", sorted(ALL))
def test_plain_matches_the_closure(name):
    p = ALL[name]
    tensors = _inputs(p)
    got = p.plain(*tensors)
    jargs = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) if t.dtype == torch.bfloat16
             else jnp.asarray(t.numpy()) for t in tensors]
    ref = np.asarray(JAX_FORMS[name](*jargs).astype(jnp.float32))
    assert tuple(got.shape) == ref.shape == tuple(p.out_shape(tensors[0].shape[0]))
    assert got.dtype == p.dtype
    if p.dtype == torch.bfloat16:
        assert np.abs(got.float().numpy() - ref).max() <= 2e-2 * np.abs(ref).max()
    else:
        # rtol against each element, atol scaled by the output's size
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("name", sorted(ALL))
def test_wrapper_takes_plain_on_cpu_and_counts_nothing(name):
    p = ALL[name]
    tensors = _inputs(p, seed=4)
    kernel = probe.PROBE_KERNELS[f"probe_{name}"]
    assert kernel is p.kernel and kernel.source == p.source
    before = kernel.launches
    out = p(*tensors)
    assert torch.equal(out, p.plain(*tensors))
    assert kernel.launches == before
    row = probe.check(p, tensors)
    assert row["ok"] and row["max_abs_err"] == 0.0


@pytest.mark.parametrize("name", sorted(n for n, p in ALL.items() if p.library is not None))
def test_library_call_computes_the_same_function(name):
    p = ALL[name]
    tensors = _inputs(p, seed=5)
    got, ref = p.library(*tensors).float(), p.plain(*tensors).float()
    tol = 2e-2 if p.dtype == torch.bfloat16 else 1e-5
    assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())


def test_throughput_work_counts():
    """FLOPs and bytes of every vpu_probe row at its sizes (E = 19,968)."""
    E, S, D1, MUL, K = 19968, 25, 5, 24, 40
    KM, W = K * MUL, D1 * K * MUL
    assert (throughput_probe.E, throughput_probe.KM, throughput_probe.W) == (E, 960, 4800)
    p13 = (E * (D1 * 2 * S * KM + D1 * KM + (D1 - 1) * KM),
           4 * (E * (D1 * MUL + S + KM) + S * W))
    want = {
        "p1": p13, "p3": p13,
        "p4": (8 * E * W, 3 * E * W * 4),
        "p4b": (8 * E * W, 3 * E * W * 2),
        "p4c": (16 * E * W, 3 * E * W * 4),
        "p4c_ns256": (512 * E * W, 3 * E * W * 4),
        "p5": (0, 4 * E * (D1 * MUL + W)),
        "p6": (2 * S * W * E, 4 * (E * S + S * W + E * W)),
        "p7": (2 * 2048 * 64 * E, 4 * (E * 2048 + 2048 * 64 + E * 64)),
        "p7_tf32": (2 * 2048 * 64 * E, 4 * (E * 2048 + 2048 * 64 + E * 64)),
    }
    for name, p in throughput_probe.PROBES.items():
        assert p.rows == E and p.work(E) == want[name], name
    # the orientation values: p4 moves 3 slabs of 19,968 x 4,800 fp32, p7 is
    # 5.23 GFLOP at the fp32 peak, its tensor-core form is bound by its bytes
    b = {n: p.bound_ms() for n, p in throughput_probe.PROBES.items()}
    assert b["p4"][1] == "bytes" and abs(b["p4"][0] - 0.3433) < 1e-3
    assert b["p4b"][1] == "bytes" and abs(b["p4b"][0] - 0.1717) < 1e-3
    assert b["p7"][1] == "operations" and abs(b["p7"][0] - 0.0781) < 1e-3
    assert b["p7_tf32"][1] == "bytes" and abs(b["p7_tf32"][0] - 0.0505) < 1e-3
    assert b["p1"] == b["p3"] and b["p1"][1] == "operations" and abs(b["p1"][0] - 0.0741) < 1e-3
    assert b["p5"][1] == "bytes" and b["p6"][1] == "bytes"
    # 256 sweeps: 49.1 GFLOP on the same 1.15 GB, bound by the fp32 rate
    assert b["p4c"][1] == "bytes" and abs(b["p4c"][0] - 0.3433) < 1e-3
    assert b["p4c_ns256"][1] == "operations" and abs(b["p4c_ns256"][0] - 0.7324) < 1e-3


def _op_work(name, n):
    """(FLOPs, bytes) of a P1/P2 function at n rows: what it reads of each
    input (a part of a row in 32-byte sectors) and its output written once."""
    w = 64 * 24
    return {
        "k_repeat": (0, 4 * n * (16 + 64)),
        "k_squeeze": (0, 4 * n * (64 + 64)),            # columns 192..255: 8 sectors
        "k_merge128": (1024 * n, 4 * n * 2048),
        "k_merge64": (1024 * n, 4 * n * 2048),
        "k_outer": (2 * 16 * 64 * n, 4 * n * (16 + 64 + 64)),
        "k_lred": (1024 * n, 4 * n * (1024 + 16)),
        "k_atadd": (128 * n, 4 * n * (128 + 1024)),     # 1,152 floats a row, not 2,048
        "k_gather": (0, 32 * 64 * n + 4 * 64 * n),      # a sector per value
        "k_dot": (2 * w * n, 4 * (64 * n + w + 24 * n)),
        "k_slice_dot": ((64 + 2 * w) * n, 4 * (128 * n + w + 24 * n)),
        "k_tile": (0, 4 * n * (48 + 1200)),
        "k_erep": (0, 4 * n * (25 + 1200)),
        "k_split_sum": (1200 * n, 4 * n * (1200 + 48)),
        "k_bc_merge": (0, 4 * n * (25 + 1200)),
        # rows of 100 bytes: columns 3..9 of 8 rows lie in 14 sectors
        "k_rep_slice": (0, 14 * 32 * n // 8 + 4 * 35 * n),
        "k_concat": (1200 * n, 4 * n * 2400),
        # columns 7..126 of a 4,800-byte row: sectors 0..15
        "k_dot_odd": (2 * 120 * 24 * n, 16 * 32 * n + 4 * (120 * 24 + 24 * n)),
        "k_dot_t": (2 * n * 48 * 24, 4 * (n * 48 + n * 24 + 48 * 24)),
        "k_acc": (2 * n * 48 * 24 + n // 128 * 48 * 24, 4 * (n * 48 + 64 * 32)),
    }[name]


OP_PROBES = {**op_probe.PROBES, **op_probe2.PROBES}


def test_op_probe_work_counts():
    p = op_probe.PROBES["k_dot"]
    assert p.work(128) == (128 * 2 * 64 * 24, 4 * (128 * 64 + 64 * 24 + 128 * 24))
    p = op_probe2.PROBES["k_acc"]
    assert p.rows == 512 and p.scratch(512) == (4, 48 * 24)
    assert p.work(512) == (2 * 512 * 48 * 24 + 4 * 48 * 24, 4 * (512 * 48 + 64 * 32))
    assert all(q.bound_ms()[0] > 0 for q in ALL.values())
    # every P1/P2 function at its own size and at the bench rows
    for name, q in OP_PROBES.items():
        for n in q.timed_rows:
            assert q.work(n) == _op_work(name, n), (name, n)
    # the corrected bounds at 19,968 rows (us, bytes at 3.35 TB/s)
    b = {n: q.bound_ms(19968) for n, q in OP_PROBES.items() if q.bench_rows}
    assert all(by == "bytes" for _, by in b.values())
    for name, us in (("k_merge128", 48.8), ("k_merge64", 48.8), ("k_concat", 57.2),
                     ("k_atadd", 27.5), ("k_tile", 29.8), ("k_erep", 29.2),
                     ("k_bc_merge", 29.2), ("k_split_sum", 29.8), ("k_lred", 24.8),
                     ("k_gather", 13.7)):
        assert abs(b[name][0] * 1e3 - us) < 0.05, name


def test_sector_bytes_counts_the_sectors_touched():
    rng = np.random.default_rng(0)
    for rows, width, cols in ((19968, 1024, range(0, 1024, 16)), (13, 25, range(3, 10)),
                              (1000, 1200, range(7, 127)), (7, 3, (0, 2)),
                              (9, 1024, tuple(sorted(rng.choice(1024, 40, replace=False))))):
        addr = 4 * (np.arange(rows)[:, None] * width + np.asarray(cols)[None, :])
        want = 32 * len(np.unique(np.concatenate([addr // 32, (addr + 3) // 32])))
        assert probe.sector_bytes(rows, width, tuple(cols)) == want
    # a whole row block is its bytes; one float a row of 64 floats is a sector
    assert probe.sector_bytes(10, 64, tuple(range(64))) == 4 * 640
    assert probe.sector_bytes(10, 64, (5,)) == 320


def test_op_probes_run_at_two_sizes():
    assert probe.BENCH_ROWS == 19968 and probe.ODD_ROWS % 8 and probe.ODD_ROWS % 128
    for name, p in OP_PROBES.items():
        if name == "k_dot_t":  # the closure is one tile
            assert p.timed_rows == p.checked_rows == (128,) and p.max_rows == 128
            continue
        odd = () if name == "k_acc" else (probe.ODD_ROWS,)
        assert p.timed_rows == (p.rows, 19968) and p.checked_rows == (p.rows, 19968, *odd)
        for n in p.checked_rows:
            shapes = p.shapes(n)
            assert shapes[0][0] == n and all(len(s) == 2 for s in shapes)
            assert p.out_shape(n) == ((64, 32) if name == "k_acc" else (n, p.out_shape(1)[1]))
        t128, t_bench = (p.bound_ms(n)[0] for n in p.timed_rows)
        assert 0 < t128 < t_bench
    assert op_probe2.PROBES["k_acc"].scratch(19968) == (156, 48 * 24)


@pytest.mark.parametrize("name", sorted(n for n, p in OP_PROBES.items() if p.odd_rows))
def test_plain_matches_the_closure_at_odd_rows(name):
    """The plain versions at a row count that is no multiple of 8 or 128."""
    p = OP_PROBES[name]
    tensors = p.inputs(np.random.default_rng(6), "cpu", p.odd_rows)
    ref = np.asarray(JAX_FORMS[name](*[jnp.asarray(t.numpy()) for t in tensors]))
    got = p.plain(*tensors).numpy()
    assert got.shape == ref.shape == (p.odd_rows, p.out_shape(1)[1])
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * max(1.0, float(np.abs(ref).max())))


def test_k_acc_plain_at_bench_rows_is_the_tile_order_sum():
    p = op_probe2.PROBES["k_acc"]
    (a,) = p.inputs(np.random.default_rng(7), "cpu", p.bench_rows)
    got = p.plain(a).numpy()
    # the sequential grid's order: 0 + P_0 + P_1 + ... in fp32, P_t in float64
    x = a.numpy().astype(np.float64)
    want = np.zeros((64, 32), np.float32)
    for t in range(156):
        at = x[t * 128:(t + 1) * 128]
        want[3:51, :24] += (at.T @ at[:, :24]).astype(np.float32)
    scale = float(np.abs(want).max())
    assert np.abs(got - want).max() <= 1e-5 * scale
    np.testing.assert_allclose(got, np.asarray(_k_acc(jnp.asarray(a.numpy()))),
                               rtol=1e-5, atol=1e-5 * scale)
    assert not got[:3].any() and not got[51:].any() and not got[:, 24:].any()


@pytest.mark.parametrize("mod,n", [(op_probe, 10), (op_probe2, 9)])
def test_probe_mains_run_on_cpu(mod, n, capsys):
    rows = mod.main(["--device", "cpu", "--seed", "1"])
    out = capsys.readouterr().out
    # each probe at each of its sizes: 128 (k_acc 512), 19,968 and 1,001 rows
    assert len(mod.PROBES) == n
    checks = sum(len(p.checked_rows) for p in mod.PROBES.values())
    assert checks == {10: 30, 9: 24}[n]
    assert len(rows) == checks and all(r["ok"] for r in rows)
    assert out.count(": OK ") == checks and "FAIL" not in out
    assert "tile semantics (a|a|...): True" in out
    if mod is op_probe2:
        assert "a second launch is bit-identical: True" in out


def _p7_segments(rows):
    """p7's split as csrc/probe_throughput.cu walks it: the chunks of all
    tiles, tile-major, in equal contiguous runs, one a block (P7_BLOCKS, or
    one a chunk where there are fewer); (block, tile, first chunk, end chunk)
    for each run's part of a tile, chunks counted within the tile."""
    tp = throughput_probe
    per_tile = tp.FAN // tp.P7_KC
    chunks = -(-rows // tp.P7_BM) * per_tile
    runs = min(tp.P7_BLOCKS, chunks)
    segs = []
    for blk in range(runs):
        c, hi = chunks * blk // runs, chunks * (blk + 1) // runs
        while c < hi:
            t = c // per_tile
            end = min(hi, (t + 1) * per_tile)
            segs.append((blk, t, c - t * per_tile, end - t * per_tile))
            c = end
    return segs


@pytest.mark.parametrize("rows", [64, 256, throughput_probe.ODD_TILES, throughput_probe.E])
def test_p7_split_covers_every_term_once(rows):
    """p7's split: every (row, column, depth) term of the product lies in
    exactly one segment (a segment spans all V columns and rows past E are
    never stored), segments use distinct scratch slots inside the scratch,
    and the reduce's block arithmetic (``p7_block_of``) finds exactly each
    tile's segments."""
    tp = throughput_probe
    per_tile = tp.FAN // tp.P7_KC
    segs = _p7_segments(rows)
    tiles = -(-rows // tp.P7_BM)
    depth = np.zeros((tiles, tp.FAN), dtype=np.int64)
    for _, t, c0, c1 in segs:
        assert 0 <= c0 < c1 <= per_tile
        depth[t, c0 * tp.P7_KC:c1 * tp.P7_KC] += 1
    assert (depth == 1).all()
    slots = [blk + t for blk, t, _, _ in segs]
    assert len(set(slots)) == len(slots)
    assert max(slots) < tp.p7_scratch(rows)[0] // (tp.P7_BM * tp.V)
    chunks = tiles * per_tile
    runs = min(tp.P7_BLOCKS, chunks)
    block_of = lambda c: ((c + 1) * runs - 1) // chunks  # noqa: E731
    for t in range(tiles):
        first, last = block_of(t * per_tile), block_of((t + 1) * per_tile - 1)
        assert [blk for blk, tt, _, _ in segs if tt == t] == list(range(first, last + 1))
    # the runs are even: no block holds more than one chunk beyond another
    per_block = np.bincount([blk for blk, _, _, _ in segs],
                            weights=[c1 - c0 for _, _, c0, c1 in segs])
    assert len(per_block) == runs and per_block.min() >= 1
    assert per_block.max() - per_block.min() <= 1


def _mma_m16n8k8(acc, a, b):
    """mma.sync m16n8k8 on per-lane fragments, as the PTX ISA lays them out
    (gid = lane // 4, tig = lane % 4): a[lane] = A[gid, tig], A[gid + 8, tig],
    A[gid, tig + 4], A[gid + 8, tig + 4]; b[lane] = B[tig, gid], B[tig + 4,
    gid]; acc[lane] = C[gid, 2 tig], C[gid, 2 tig + 1], C[gid + 8, 2 tig],
    C[gid + 8, 2 tig + 1].  Arrays of 32 lanes; float64, no rounding: this
    checks index maps, not arithmetic."""
    lane = np.arange(32)
    gid, tig = lane // 4, lane % 4
    A = np.zeros((16, 8))
    B = np.zeros((8, 8))
    A[gid, tig], A[gid + 8, tig], A[gid, tig + 4], A[gid + 8, tig + 4] = a.T
    B[tig, gid], B[tig + 4, gid] = b.T
    C = A @ B
    return acc + np.stack([C[gid, 2 * tig], C[gid, 2 * tig + 1],
                           C[gid + 8, 2 * tig], C[gid + 8, 2 * tig + 1]], axis=1)


# p7_tf32's layout, as csrc/probe_throughput.cu sets it
T7 = dict(KC=32, STAGES=5, CW=4, MT=3)
T7_TM = 160
_CU = Path(tp_kernel.CSRC) / "probe_throughput.cu"


def test_p7_tf32_layout_is_the_sources():
    text = _CU.read_text()
    for line in ("constexpr int T7_KC = 32;", "constexpr int T7_STAGES = 5;",
                 "constexpr int T7_CW = 4;", "constexpr int T7_TM = 160;",
                 "constexpr int T7_MT = 3;", "q0 = (warp + 2) % 4;",
                 "const int box_rows = (min(share, T7_TM) + 7) / 8 * 8;",
                 "CU_TENSOR_MAP_SWIZZLE_128B", "constexpr int P1_PN = 4 * MUL;",
                 "constexpr int P6_BM = 64;", "p1_kernel<<<blocks, P6_NT, P1_SMEM"):
        assert line in text, line


def _t7_box_rows(rows, blocks=132):
    return (min(-(-rows // blocks), T7_TM) + 7) // 8 * 8


def _t7_pass(a, b, box_rows):
    """One pass of a p7_tf32 block over rows a (at most box_rows) and depth
    b.shape[0] (a multiple of T7_KC), through the kernel's index maps: the
    TMA box of 128-byte rows with the 128-byte swizzle (16-byte piece j of
    row r at j ^ (r % 8)), rows past the share filled with garbage, B's
    chunk dense, the converter's rotated turns into fragment order, the
    consumers' m16 tiles (warp w: q, q + 4, q + 8 with q = (w + 2) % 4), their
    permuted 16-byte A loads and their stores."""
    rows, depth = a.shape[0], b.shape[0]
    lane = np.arange(32)
    gid, tig = lane // 4, lane % 4
    acc = np.zeros((T7["CW"], T7["MT"], 8, 32, 4))

    def tiles(w_):
        q0 = (w_ + 2) % 4
        return [(mt, q0 + 4 * mt) for mt in range(T7["MT"])
                if q0 + 4 * mt < T7_TM // 16 and 16 * (q0 + 4 * mt) < rows]
    for k0 in range(0, depth, T7["KC"]):
        stage = np.full(T7_TM * 32, np.nan)
        box = np.full((box_rows, 32), 1e30)  # another block's rows, or zeros past E
        box[:rows] = a[:, k0:k0 + T7["KC"]]
        for r in range(box_rows):
            for j in range(8):
                stage[r * 32 + 4 * (j ^ (r % 8)):r * 32 + 4 * (j ^ (r % 8)) + 4] = \
                    box[r, 4 * j:4 * j + 4]
        raw = b[k0:k0 + T7["KC"]].ravel()
        frag = np.full(T7["KC"] * 64, np.nan)
        swap = tig >> 1
        for s in range(4):
            for n in range(4):
                np_ = (n + tig) & 3
                r = (8 * tig + s) * 64 + 16 * np_ + gid
                first, second = r + 8 * swap, r + 8 * (1 - swap)
                x0, x1, y0, y1 = raw[first], raw[first + 4 * 64], raw[second], raw[second + 4 * 64]
                w = np.where(swap[:, None] == 1, np.stack([y0, y1, x0, x1], axis=1),
                             np.stack([x0, x1, y0, y1], axis=1))
                idx = ((s * 4 + np_) * 32 + lane) * 4
                for q in range(4):
                    frag[idx + q] = w[:, q]
        for w_ in range(T7["CW"]):
            af = np.zeros((T7["MT"], 2, 8, 32))
            for mt, tile in tiles(w_):
                for h in range(2):
                    src = (16 * tile + 8 * h + gid) * 32
                    for d in range(8):
                        piece = (2 * tig + d // 4) ^ gid
                        af[mt, h, d] = stage[src + 4 * piece + d % 4]
            for s in range(4):
                for np_ in range(4):
                    idx = ((s * 4 + np_) * 32 + lane) * 4
                    b0 = np.stack([frag[idx], frag[idx + 1]], axis=1)
                    b1 = np.stack([frag[idx + 2], frag[idx + 3]], axis=1)
                    for mt, _ in tiles(w_):
                        a4 = np.stack([af[mt, 0, s], af[mt, 1, s], af[mt, 0, s + 4],
                                       af[mt, 1, s + 4]], axis=1)
                        acc[w_, mt, 2 * np_] = _mma_m16n8k8(acc[w_, mt, 2 * np_], a4, b0)
                        acc[w_, mt, 2 * np_ + 1] = _mma_m16n8k8(acc[w_, mt, 2 * np_ + 1], a4, b1)
    out = np.full((rows, 64), np.nan)
    for w_ in range(T7["CW"]):
        for mt, tile in tiles(w_):
            for h in range(2):
                r = 16 * tile + 8 * h + gid
                keep = r < rows
                for n in range(8):
                    for q in range(2):
                        out[r[keep], 8 * n + 2 * tig[keep] + q] = acc[w_, mt, n, keep, 2 * h + q]
    return out


@pytest.mark.parametrize("rows", [152, 151, 33, 8])
def test_p7_tf32_fragment_maps_give_the_product(rows):
    """The kernel's layouts and fragment maps compute A @ B over two chunks,
    for a block's share at E = 19,968 (152 or 151 rows, the box 152 tall), one
    that leaves most m16 tiles empty (33) and one inside an m16 tile (8, as at
    1,088 rows, the box 16 tall); rows past the share never reach the
    result."""
    rng = np.random.default_rng(7)
    a = rng.normal(size=(rows, 2 * T7["KC"]))
    b = rng.normal(size=(2 * T7["KC"], 64))
    box_rows = {152: _t7_box_rows(19_968), 151: _t7_box_rows(19_968), 33: 40,
                8: _t7_box_rows(1088)}[rows]
    np.testing.assert_allclose(_t7_pass(a, b, box_rows), a @ b, rtol=1e-12, atol=1e-12)


def test_p7_tf32_converter_and_a_loads_hit_distinct_banks():
    """Each shared-memory load instruction of p7_tf32's converter (a float,
    32 lanes) and of its consumers (16 bytes, eight lanes a phase) touches
    each bank once."""
    lane = np.arange(32)
    gid, tig = lane // 4, lane % 4
    swap = tig >> 1
    for s in range(4):
        for n in range(4):
            np_ = (n + tig) & 3
            r = (8 * tig + s) * 64 + 16 * np_ + gid
            for addr in (r + 8 * swap, r + 8 * swap + 4 * 64, r + 8 * (1 - swap),
                         r + 8 * (1 - swap) + 4 * 64):
                assert len(set(addr % 32)) == 32
    for half in range(2):
        piece = (2 * tig + half) ^ gid  # rows gid of an eight-row group
        unit = gid * 8 + piece          # 16-byte units, rows of 128 bytes
        for phase in range(4):
            sel = slice(8 * phase, 8 * phase + 8)
            assert len(set(unit[sel] % 8)) == 8


@pytest.mark.parametrize("rows", [64, throughput_probe.ODD_TILES, throughput_probe.E, 65_536])
def test_p7_tf32_shares_cover_every_term_once(rows):
    """p7_tf32's schedule: block b of G (one an SM) takes rows
    [E b / G, E (b + 1) / G), in passes of at most T7_TM rows, each the whole
    depth in chunks of T7_KC: every (row, depth) term once, no two shares
    more than one row apart, every pass inside one box (at most T7_TM rows,
    a multiple of 8), and what a chunk's mbarrier expects fits its count."""
    G, fan, nkc = 132, throughput_probe.FAN, throughput_probe.FAN // T7["KC"]
    box_rows = _t7_box_rows(rows, G)
    assert box_rows % 8 == 0 and box_rows <= T7_TM
    assert (box_rows * T7["KC"] + T7["KC"] * 64) * 4 < 2 ** 20
    seen = np.zeros(rows, dtype=np.int64)
    sizes = []
    for blk in range(G):
        lo, hi = rows * blk // G, rows * (blk + 1) // G
        sizes.append(hi - lo)
        if lo >= hi:
            continue
        chunks = -(-(hi - lo) // T7_TM) * nkc
        depth = np.zeros((hi - lo, fan), dtype=np.int64)
        for c in range(chunks):
            row0, k0 = lo + (c // nkc) * T7_TM, (c % nkc) * T7["KC"]
            n = min(T7_TM, hi - row0)
            assert 0 < n <= box_rows
            depth[row0 - lo:row0 - lo + n, k0:k0 + T7["KC"]] += 1
        assert (depth == 1).all()
        seen[lo:hi] += 1
    assert (seen == 1).all() and max(sizes) - min(sizes) <= 1
    if rows == throughput_probe.E:
        assert box_rows == 152 and set(sizes) == {151, 152}


# p1's layout: items (panel of 96 output columns, tile of 64 edges),
# panel-major, in even contiguous runs; warp w owns rows 16 (w % 4) .. of a
# tile and n8 tiles 6 (w // 4) .. 6 (w // 4) + 5 of a panel
P1_PN, P1_PANELS, P1_WJ = 96, 10, 6


def _p1_items(rows, blocks):
    n_tiles = rows // 64
    items = P1_PANELS * n_tiles
    return [[(it // n_tiles, it % n_tiles) for it in range(items * b // blocks,
                                                           items * (b + 1) // blocks)]
            for b in range(blocks)]


@pytest.mark.parametrize("rows", [64, throughput_probe.ODD_TILES, throughput_probe.E])
def test_p1_items_cover_every_term_once(rows):
    """p1's schedule at two blocks an SM: every (row, column) of the output
    in exactly one item and one warp's fragments (the D1 x S depth terms of
    each are ``test_p1_fragment_maps_give_the_closure``'s); runs no more than
    one item apart; at the bench rows a block loads at most two panels."""
    blocks = 2 * 132
    runs = _p1_items(rows, blocks)
    lens = [len(r) for r in runs]
    assert max(lens) - min(lens) <= 1
    owner = np.zeros((rows, throughput_probe.KM), dtype=np.int64)
    lane = np.arange(32)
    gid, tig = lane // 4, lane % 4
    for run in runs:
        if rows == throughput_probe.E:
            assert len({pn for pn, _ in run}) <= 2
        for pn, tile in run:
            for w in range(8):
                r0, j0 = 16 * (w % 4), P1_WJ * (w // 4)
                for q in range(P1_WJ):
                    col = pn * P1_PN + 8 * (j0 + q) + 2 * tig
                    for r in (64 * tile + r0 + gid, 64 * tile + r0 + gid + 8):
                        owner[r, col] += 1
                        owner[r, col + 1] += 1
    assert (owner == 1).all()


def test_p1_fragment_maps_give_the_closure():
    """One p1 item through the kernel's index maps (the panel's fragment
    order for all five blocks of Crep, the sh fragments, depth 24 apart, and
    x by its class q mod 3 of each warp's n8 tiles) equals plain_p1 on that
    tile and panel, for each panel."""
    tp = throughput_probe
    rng = np.random.default_rng(8)
    x = rng.normal(size=(64, tp.D1 * tp.MUL))
    sh = rng.normal(size=(64, tp.S))
    crep = rng.normal(size=(tp.S, tp.W))
    want = tp.plain_p1(*(torch.as_tensor(v) for v in (x, sh, crep))).numpy()
    lane = np.arange(32)
    gid, tig = lane // 4, lane % 4
    for pn in range(P1_PANELS):
        got = np.full((64, P1_PN), np.nan)
        # load_split_panel for each i: bf[i][j][s][lane] = (b0, b1), b24[i][c]
        bf = np.zeros((tp.D1, 2 * P1_WJ, 3, 32, 2))
        b24 = np.zeros((tp.D1, P1_PN))
        for i in range(tp.D1):
            col0 = i * tp.KM + pn * P1_PN
            for j in range(2 * P1_WJ):
                for s in range(3):
                    col, k = col0 + 8 * j + gid, 8 * s + tig
                    bf[i, j, s, :, 0], bf[i, j, s, :, 1] = crep[k, col], crep[k + 4, col]
            b24[i] = crep[tp.S - 1, col0:col0 + P1_PN]
        for w in range(8):
            r0, j0 = 16 * (w % 4), P1_WJ * (w // 4)
            af = [np.stack([sh[r0 + gid, 8 * s + tig], sh[r0 + gid + 8, 8 * s + tig],
                            sh[r0 + gid, 8 * s + tig + 4], sh[r0 + gid + 8, 8 * s + tig + 4]],
                           axis=1) for s in range(3)]
            acc = np.zeros((P1_WJ, 32, 4))
            for i in range(tp.D1):
                # class c: columns 8 c + 2 tig, +1 of block i, rows gid and gid + 8
                xv = [np.stack([x[r0 + gid + 8 * h, i * tp.MUL + 8 * c + 2 * tig + u]
                                for h in range(2) for u in range(2)], axis=1)
                      for c in range(3)]
                for q in range(P1_WJ):
                    j = j0 + q
                    v = np.zeros((32, 4))
                    for s in range(3):
                        v = _mma_m16n8k8(v, af[s], bf[i, j, s])
                    b = np.stack([b24[i, 8 * j + 2 * tig], b24[i, 8 * j + 2 * tig + 1]], axis=1)
                    v[:, 0] += sh[r0 + gid, tp.S - 1] * b[:, 0]
                    v[:, 1] += sh[r0 + gid, tp.S - 1] * b[:, 1]
                    v[:, 2] += sh[r0 + gid + 8, tp.S - 1] * b[:, 0]
                    v[:, 3] += sh[r0 + gid + 8, tp.S - 1] * b[:, 1]
                    xq = xv[q % 3]
                    acc[q] = v * xq if i == 0 else acc[q] + v * xq
            for q in range(P1_WJ):
                c = 8 * (j0 + q) + 2 * tig
                got[r0 + gid, c], got[r0 + gid, c + 1] = acc[q, :, 0], acc[q, :, 1]
                got[r0 + gid + 8, c], got[r0 + gid + 8, c + 1] = acc[q, :, 2], acc[q, :, 3]
        np.testing.assert_allclose(got, want[:, pn * P1_PN:(pn + 1) * P1_PN],
                                   rtol=1e-10, atol=1e-10)


def test_p7_tf32_library_allows_tf32_for_its_call_only(monkeypatch):
    """p7_tf32's yardstick runs torch.matmul with TF32 allowed, and leaves
    the precision setting as it found it, whatever that was, also when the
    product raises; on the CPU it is the plain product."""
    m = torch.backends.cuda.matmul
    name = "fp32_precision" if hasattr(m, "fp32_precision") else "allow_tf32"
    lib = throughput_probe.PROBES["p7_tf32"].library
    a, b = (torch.as_tensor(np.random.default_rng(9).normal(size=s).astype(np.float32))
            for s in ((64, 2048), (2048, 64)))
    start = getattr(m, name)
    seen = []
    real = torch.matmul

    def spy(x, y):
        seen.append(getattr(m, name))
        return real(x, y)

    try:
        for setting in (("ieee", "none") if name == "fp32_precision" else (False,)):
            setattr(m, name, setting)
            before = getattr(m, name)
            got = lib(a, b)
            assert float((got - a @ b).abs().max()) <= 1e-5 * float((a @ b).abs().max())
            assert getattr(m, name) == before
            monkeypatch.setattr(torch, "matmul", spy)
            lib(a, b)
            assert seen[-1] in ("tf32", True) and getattr(m, name) == before

            def boom(x, y):
                seen.append(getattr(m, name))
                raise RuntimeError("product failed")

            monkeypatch.setattr(torch, "matmul", boom)
            with pytest.raises(RuntimeError, match="product failed"):
                lib(a, b)
            assert seen[-1] in ("tf32", True) and getattr(m, name) == before
            monkeypatch.setattr(torch, "matmul", real)
    finally:
        setattr(m, name, start)


def test_p6_p7_are_checked_at_odd_tiles():
    for name in ("p1", "p6", "p7", "p7_tf32"):
        p = throughput_probe.PROBES[name]
        assert p.checked_rows == (throughput_probe.E, 1088) and p.timed_rows == (throughput_probe.E,)
        assert 1088 % p.row_quantum == 0 and 1088 % 128 and 1088 // 64 == 17
    assert throughput_probe.PROBES["p7"].scratch(19_968) == ((396 + 156) * 128 * 64,)


def test_throughput_main_runs_on_cpu(capsys):
    rows = throughput_probe.main(["--device", "cpu", "--edges", "64"])
    out = capsys.readouterr().out
    assert [r["name"] for r in rows] == list(throughput_probe.PROBES)
    assert all(r["ok"] and r["ms"] > 0 and r["bound_ms"] > 0 for r in rows)
    # a CPU run states no device rate
    assert "TFLOP/s" not in out and "lane-ops" not in out


def test_probe_main_fails_on_disagreement(monkeypatch, capsys):
    # on the CPU the wrapper is the plain version, so the check itself is made to fail
    real = probe.check
    monkeypatch.setattr(probe, "check", lambda pr, t: {**real(pr, t), "ok": pr.name != "k_dot"})
    with pytest.raises(SystemExit) as exc:
        op_probe.main(["--device", "cpu"])
    assert exc.value.code == 1
    assert "k_dot" in capsys.readouterr().err


def test_probes_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the probes would run")
    for mod in (op_probe, op_probe2, throughput_probe):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main([])


def test_device_time_ms_on_cpu():
    calls = []
    t = device_time_ms(lambda a: calls.append(1) or a.sum(), (torch.ones(8),), n=5, warmup=2)
    assert len(calls) == 7 and t > 0
    assert device_time_ms(lambda: None, n=3, warmup=0, device="cpu") >= 0


def test_device_time_ms_is_strict():
    # no tensor to take the device from: it must be named
    with pytest.raises(ValueError, match="name the device"):
        device_time_ms(lambda: None, n=1, warmup=0)
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the busy-wait exists and is used")
    # a card's reading is never taken without the busy-wait in front of it
    real = getattr(torch.cuda, "_sleep", None)
    try:
        if real is not None:
            del torch.cuda._sleep
        with pytest.raises(RuntimeError, match="_sleep"):
            device_time_ms(lambda: None, n=1, warmup=0, device="cuda")
    finally:
        if real is not None:
            torch.cuda._sleep = real


def _body(text, name):
    """The source of ``def <name>(`` in ``text``: its line and the lines
    below it that are blank or indented deeper."""
    lines = text.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.lstrip().startswith(f"def {name}("))
    indent = len(lines[start]) - len(lines[start].lstrip())
    end = start + 1
    while end < len(lines) and (not lines[end].strip()
                                or len(lines[end]) - len(lines[end].lstrip()) > indent):
        end += 1
    return "\n".join(lines[start:end])


# closure -> expressions its body in the TPU probe must still hold: what
# JAX_FORMS and the port's plain versions restate
RESTATED = {
    "tools_dev/mosaic_probe.py": {
        "k_repeat": ["pltpu.repeat(a_ref[:], 4, axis=1)"],
        "k_squeeze": ["reshape(TE, K, MUL)", "a3[:, 3:4, :].reshape(TE, MUL)"],
        "k_merge128": ["reshape(TE, 8, 128)", "(a3 + 1.0).reshape(TE, 8 * 128)"],
        "k_merge64": ["reshape(TE, K, MUL)", "(a3 + 1.0).reshape(TE, K * MUL)"],
        "k_outer": ["a_ref[:][:, :, None] * b_ref[:][:, None, :]", "jnp.sum(t, axis=1)"],
        "k_lred": ["reshape(TE, K, MUL)", "jnp.sum(a3, axis=2)"],
        "k_atadd": ["jnp.zeros((TE, K * MUL), jnp.float32)",
                    "v.at[:, 64 : 64 + 128].add(a_ref[:][:, :128])"],
        "k_gather": ["np.arange(0, K * MUL, K, dtype=np.int32)", "a_ref[:][:, idx]"],
        "k_dot": ["jnp.dot(a_ref[:], b_ref[:],"],
        "k_slice_dot": ["a3[:, 2:4, :]", "blk[:, 0:1, :].reshape(TE, MUL) + "
                        "blk[:, 1:2, :].reshape(TE, MUL)", "jnp.dot(s, b_ref[:],"],
    },
    "tools_dev/mosaic_probe2.py": {
        "k_tile": ["pltpu.repeat(a_ref[:], K, axis=1)"],
        "k_erep": ["jnp.repeat(a_ref[:], MUL, axis=1)"],
        "k_split_sum": ["reshape(TE, K, MUL)", "jnp.sum(a3, axis=1)"],
        "k_bc_merge": ["a_ref[:][:, :, None]", "jnp.broadcast_to(a3, (TE, K, MUL))",
                       "b.reshape(TE, K * MUL)"],
        "k_rep_slice": ["pltpu.repeat(a_ref[:][:, 3 : 3 + 7], 5, axis=1)"],
        "k_concat": ["a_ref[:][:, i * MUL : (i + 1) * MUL] * float(i) for i in range(K)",
                     "jnp.concatenate(parts, axis=1)"],
        "k_dot_odd": ["jnp.dot(a_ref[:][:, 7 : 7 + 120], b_ref[:],"],
        "k_dot_t": ["a_ref[:], b_ref[:], (((0,), (0,)), ((), ())),"],
        "k_acc": ["pl.program_id(0) == 0", "jnp.zeros_like(o_ref)",
                  "o_ref[3 : 3 + MUL, :24] += jax.lax.dot_general(",
                  "a_ref[:], a_ref[:][:, :24], (((0,), (0,)), ((), ())),"],
    },
    "tools_dev/vpu_probe.py": {
        "p1": ["for i in range(D1):", "crep_ref[:, i * KM:(i + 1) * KM],",
               "pltpu.repeat(x_ref[:, i * MUL:(i + 1) * MUL], K, axis=1)", "term = W * B",
               "midf = term if midf is None else midf + term"],
        "p3": ["jnp.dot(sh_ref[:], crep_ref[:],",
               "pltpu.repeat(x_ref[:, i * MUL:(i + 1) * MUL], K, axis=1)",
               "jnp.concatenate(Bs, axis=1)", "prod = W * B", "h = n // 2",
               "prod[:, :h * KM] + prod[:, h * KM:2 * h * KM] if n % 2 == 0",
               "prod[:, 2 * h * KM:]], axis=1)", "n = n - h", "prod[:, :KM]"],
        "p4": ["for _ in range(NS):", "acc = acc * b_ref[:]"],
        "p4c": ["for _ in range(NS):", "acc = acc + a_ref[:] * b_ref[:]"],
        "p5": ["pltpu.repeat(x_ref[:, i * MUL:(i + 1) * MUL], K, axis=1)",
               "for i in range(D1)]", "jnp.concatenate(outs, axis=1)"],
        "p6": ["jnp.dot(sh_ref[:], crep_ref[:],"],
        "p7": ["jnp.dot(b_ref[:], w_ref[:],"],
    },
}

# the sizes the closures run at, as their files set them
SIZES = {
    "tools_dev/mosaic_probe.py": ["TE, K, MUL = 128, 16, 64", "size=(MUL, 24)"],
    "tools_dev/mosaic_probe2.py": ["TE, K, MUL = 128, 25, 48", "grid=(4,),", "size=(120, 24)",
                                   "jax.ShapeDtypeStruct((64, 32), jnp.float32)",
                                   "np.allclose(r, np.tile(np.asarray(xi), (1, K)))"],
    "tools_dev/vpu_probe.py": ["E = 19968", "S = 25", "D1 = 5 ", "MUL = 24", "K = 40 ",
                               "NS = 8", "FAN, V = 2048, 64", "n=8, warmup=2"],
}


@pytest.mark.parametrize("path", sorted(RESTATED))
def test_tpu_probe_sources_still_say_what_is_restated(path):
    """JAX_FORMS restates the closures, which cannot be imported; if one of
    them changes in its file, this fails and the restatement is looked at
    again.  ``mosaic_probe2.py`` itself checks (on a TPU) that ``pltpu.repeat``
    tiles, which is what ``_tile`` takes it to do."""
    text = (Path(__file__).resolve().parents[1] / path).read_text()
    for line in SIZES[path]:
        assert line in text, line
    for name, exprs in RESTATED[path].items():
        body = _body(text, name)
        for expr in exprs:
            assert expr in body, (name, expr)
    mod = {"tools_dev/mosaic_probe.py": op_probe, "tools_dev/mosaic_probe2.py": op_probe2,
           "tools_dev/vpu_probe.py": throughput_probe}[path]
    # every probe names a closure of this file, at the line of its def (or of
    # the comment that heads it)
    lines = text.splitlines()
    for name, p in mod.PROBES.items():
        src, line = p.replaces.split(":")
        closure = {"p4b": "p4", "p4c_ns256": "p4c", "p7_tf32": "p7"}.get(name, name)
        assert src == path and closure in RESTATED[path]
        near = "\n".join(lines[int(line) - 1:int(line) + 1])
        assert f"def {closure}(" in near, (name, near)


SOURCES = {"probe_ops": {**op_probe.PROBES, **op_probe2.PROBES},
           "probe_throughput": throughput_probe.PROBES}


@pytest.mark.parametrize("src", sorted(SOURCES))
def test_sources_hold_a_kernel_per_probe_and_no_library(src):
    text = (Path(tp_kernel.CSRC) / f"{src}.cu").read_text()
    n_global = len(re.findall(r"__global__", text))
    if src == "probe_ops":
        # written out or through the macro MAP_KERNEL_1, whose definition
        # holds the one __global__ that names no kernel; one or more a probe
        kernels = (set(re.findall(r"__global__\s+void\s+(\w+)\s*\(", text))
                   | set(re.findall(r"^MAP_KERNEL_1\((\w+),", text, re.M))) - {"kernel"}
        n_global = len(kernels)
        for name in SOURCES[src]:
            assert any(k.startswith(f"{name}_") for k in kernels), name
    # p4c_ns256 is the second instance of p4c's templated kernel
    n_instances = n_global + (src == "probe_throughput")
    assert n_instances >= len(SOURCES[src])
    for name, p in SOURCES[src].items():
        assert re.search(rf"\bprobe_{name}\b", text) or f"ROWWISE_1({name}," in text \
            or f"ROWWISE_2({name}," in text, name
        assert p.kernel.name == f"probe_{name}"
    assert f"{src}_error_string" in text
    assert not re.search(r"atomic\w*\s*\(|cuda::atomic", text)
    assert not re.search(r"#include\s*[<\"](cublas|cutlass|cute|cudnn|torch|ATen)", text, re.I)
    assert not re.search(r"cublas\w*\s*\(|cutlass::", text)
    if src == "probe_throughput":
        # p7_tf32: TF32 mma.sync fed by the copy engine (a TMA box a chunk)
        assert "packed_tp::mma_tf32" in text and "cp.async.bulk.tensor.2d" in text
        assert "__nv_bfloat162" in text
        assert "p4c_kernel<NS><<<" in text and "p4c_kernel<NS_DEEP><<<" in text


def test_probe_kernels_share_one_library_per_source():
    assert {k.source for k in probe.PROBE_KERNELS.values()} == {"probe_ops", "probe_throughput"}
    assert len(probe.PROBE_KERNELS) == 29
    # the model's kernels keep a library each
    assert {k.source for k in tp_kernel.KERNELS.values()} == set(tp_kernel.KERNELS)
