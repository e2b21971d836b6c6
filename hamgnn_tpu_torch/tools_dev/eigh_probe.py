"""The band branch's eigensolve on the card (``physics/eigh.py``
``hermitian_eigh``: the NaN masks around ``torch.linalg.eigh``), against
``torch.linalg.eigh`` alone.

    python -m hamgnn_tpu_torch.tools_dev.eigh_probe [--sizes 896,1216,1792] [--batch 24]

For each size, a batch of Hermitian complex64 matrices shaped like the band
steps' A = L^-1 H L^-H (a random Hermitian part on a diagonal that runs from
-5 to the pad energy, 1e3): ``hermitian_eigh``'s eigenvalues against
``torch.linalg.eigh``'s within 1e-5 * max|lambda|, its residual
max|A v - lambda v| within 1e-4 * max|A|, and both timed in turns on the
host clock (each waits for the card inside its call).  Last, it tries to
capture ``torch.linalg.eigh`` alone in a CUDA graph, which cuSOLVER refuses
(the solver waits for the card inside the call): the result says whether
the capture held, and the error where it did not.  That attempt can leave
the process's CUDA state unusable, so it comes last and the script is run
in a process of its own.  Prints one JSON line ``{"eigh_probe": ...}``
and writes it to ``chiprun_out/eigh_probe.json``; exits 1 where a check
fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

EIG_TOL = 1e-5      # max|lambda - lambda_torch| / max|lambda|
RESIDUAL_TOL = 1e-4  # max|A v - lambda v| / max|A|


def hermitian_batch(batch: int, n: int, seed: int, device) -> torch.Tensor:
    g = torch.Generator(device="cpu").manual_seed(seed)
    a = torch.randn(batch, n, n, dtype=torch.complex64, generator=g)
    a = 0.5 * (a + a.mH) + torch.diag_embed(torch.linspace(-5.0, 1.0e3, n)).to(a.dtype)
    return a.to(device)


def _host_ms(fn, reps: int) -> list:
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def check_size(n: int, batch: int, reps: int, device) -> dict:
    from hamgnn_tpu_torch.physics.eigh import CARD_SOLVES, hermitian_eigh

    a = hermitian_batch(batch, n, n, device)
    before = CARD_SOLVES["calls"]
    w, v = hermitian_eigh(a)
    torch.cuda.synchronize()
    ref = torch.linalg.eigvalsh(a)
    scale = float(ref.abs().max())
    eig_err = float((w - ref).abs().max()) / scale
    residual = float((a @ v - v * w[..., None, :]).abs().max()) / float(a.abs().max())
    times = {"hermitian_eigh": [], "torch_linalg_eigh": []}
    for _ in range(reps):  # in turns
        times["hermitian_eigh"] += _host_ms(lambda: hermitian_eigh(a), 1)
        times["torch_linalg_eigh"] += _host_ms(lambda: torch.linalg.eigh(a), 1)
    ms = {k: sorted(t)[len(t) // 2] for k, t in times.items()}
    return {"n": n, "batch": batch, "eig_rel_err": eig_err, "residual_rel": residual,
            "ok": eig_err <= EIG_TOL and residual <= RESIDUAL_TOL,
            "ms": ms, "times_ms": times, "solves": CARD_SOLVES["calls"] - before}


def try_capture(n: int, device) -> dict:
    """Capture ``torch.linalg.eigh`` of one matrix alone (no ``host_step``)."""
    a = hermitian_batch(1, n, 0, device)
    torch.linalg.eigh(a)  # the solver's handle and workspace, outside the capture
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, stream=stream):
            torch.linalg.eigh(a)
        graph.replay()
        torch.cuda.synchronize()
        return {"n": n, "captured": True}
    except Exception as exc:  # the finding, reported: a captured step cuts around it
        return {"n": n, "captured": False, "error": str(exc).splitlines()[0][:300]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="896,1216,1792")
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("eigh_probe: no card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    rows = [check_size(int(n), args.batch, args.reps, device) for n in args.sizes.split(",")]
    capture = try_capture(int(args.sizes.split(",")[0]), device)
    result = {"eigh_probe": {"card": card, "eig_tol": EIG_TOL, "residual_tol": RESIDUAL_TOL,
                             "sizes": rows, "capture_alone": capture}}
    line = json.dumps(result)
    out = Path(__file__).resolve().parents[2] / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "eigh_probe.json").write_text(line + "\n")
    print(line, flush=True)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
