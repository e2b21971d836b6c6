"""Time the model's TP kernels of this checkout against another source tree's,
in turns, each tree through its own package in a process of its own.

    python -m hamgnn_tpu_torch.tools_dev.compare_kernels --against build/parent [--rounds 2]

A tree is a checkout of the repository (an earlier commit unpacked with
``git archive`` into ``build/``, which is not committed).  Its
``hamgnn_tpu_torch`` is imported from the tree and builds its kernels into the
tree's own ``build/kernels``, so that a tree whose kernels take other
arguments runs through its own wrappers.  The processes run in turns (the
other tree, this one, this one, the other, per round); each times B1, B2, B3
and B4 in their default form (fp32, no switch set) through their public
wrappers at the bench plans (E = 19,968: pair, node, edge), each a median of
10 CUDA-event readings after 2 warm-up runs, and prints one JSON line.  The
main process prints, per kernel and tree, the ms a training step (the 13 launches:
1 pair, 6 node, 6 edge) as the median over its processes, and ptxas's
registers and spill bytes of each tree's build; the results go to
``chiprun_out/compare_kernels.json``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
BENCH_FEAT = "64x0e+32x0o+24x1o+12x1e+12x2e+6x2o+4x3o+4x3e+2x4e"
BENCH_SH = "0e + 1o + 2e + 3o + 4e"
E_BENCH = 19_968
# bench plan -> launches a training step
PLANS = {"pair": 1, "node": 6, "edge": 6}
KERNELS = ("packed_tp_fwd", "packed_tp_bwd", "zonal_tp_fwd", "zonal_tp_bwd")


def worker() -> dict:
    """Run inside a tree (its root first on ``sys.path``): build its kernels,
    time each at the bench plans, return {kernel: {plan: ms}, "ptxas": ...}."""
    import torch

    from hamgnn_tpu_torch.e3 import tp_kernel, zonal_kernel
    from hamgnn_tpu_torch.e3.irreps import Irreps
    from hamgnn_tpu_torch.e3.packed_tp import get_plan
    from hamgnn_tpu_torch.utils.profiling import device_time_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    built = tp_kernel.build_kernels(list(KERNELS))
    ptxas = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
             for n, (_p, log) in built.items()}
    feat = Irreps(BENCH_FEAT)
    inputs = {"pair": Irreps("96x0e"), "node": Irreps([(2 * m, ir) for m, ir in feat]),
              "edge": feat}
    out = {k: {} for k in KERNELS}
    dev = torch.device("cuda", 0)
    for name in PLANS:
        plan = get_plan(repr(inputs[name]), repr(Irreps(BENCH_SH)), repr(feat), repr(feat))
        rng = np.random.default_rng(3)
        x, sh, w, fw, gy = (torch.as_tensor(rng.normal(size=s).astype(np.float32), device=dev)
                            for s in ((E_BENCH, plan.irreps_in.dim),
                                      (E_BENCH, plan.irreps_sh.dim),
                                      (E_BENCH, plan.weight_numel), (plan.linear_numel,),
                                      (E_BENCH, plan.irreps_out.dim)))
        calls = {
            "packed_tp_fwd": lambda: tp_kernel.packed_tp_forward(plan, x, sh, w, fw),
            "packed_tp_bwd": lambda: tp_kernel.packed_tp_backward(plan, x, sh, w, fw, gy),
            "zonal_tp_fwd": lambda: zonal_kernel.zonal_core_forward(plan, x, w, fw),
            "zonal_tp_bwd": lambda: zonal_kernel.zonal_core_backward(plan, x, w, fw, gy)}
        with torch.inference_mode():
            for k, fn in calls.items():
                out[k][name] = device_time_ms(fn, n=10, warmup=2, device="cuda")
        del x, sh, w, fw, gy
        torch.cuda.empty_cache()
    out["ptxas"] = ptxas
    out["card"] = torch.cuda.get_device_name(0)
    return out


def run_tree(tree: Path) -> dict:
    """One worker process on ``tree``: this file run as a script, the tree's
    root first on its path, so that the tree's own package is timed."""
    res = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker", str(tree)],
                         capture_output=True, text=True, cwd=str(tree), timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"{tree}: worker failed:\n{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, help="the other source tree")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        sys.path.insert(0, str(args.worker.resolve()))
        print(json.dumps(worker()))
        return
    if args.against is None:
        ap.error("--against is required")
    trees = {"other": args.against.resolve(), "this": ROOT}
    runs = {k: [] for k in trees}
    for _ in range(args.rounds):
        for label in ("other", "this", "this", "other"):
            runs[label].append(run_tree(trees[label]))
            print(f"[compare_kernels] {label}: " + ", ".join(
                f"{k} {step_ms(runs[label][-1], k):.3f}" for k in KERNELS) + " ms a step",
                flush=True)
    result = {"card": runs["this"][0]["card"], "trees": {k: str(v) for k, v in trees.items()},
              "ms_per_step": {label: {k: float(np.median([step_ms(r, k) for r in rs]))
                                      for k in KERNELS} for label, rs in runs.items()},
              "per_plan": {label: {k: {p: float(np.median([r[k][p] for r in rs]))
                                       for p in PLANS} for k in KERNELS}
                           for label, rs in runs.items()},
              "ptxas": {label: rs[0]["ptxas"] for label, rs in runs.items()}}
    for label in trees:
        for k, lines in result["ptxas"][label].items():
            for ln in lines:
                print(f"[ptxas] {label} {k}: {ln}")
    for k in KERNELS:
        a, b = result["ms_per_step"]["other"][k], result["ms_per_step"]["this"][k]
        print(f"[compare_kernels] {k}: other {a:.3f} ms, this {b:.3f} ms a step "
              f"({100 * (b / a - 1):+.2f}%), {result['card']}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "compare_kernels.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result["ms_per_step"]))


def step_ms(run: dict, kernel: str) -> float:
    return sum(run[kernel][p] * per for p, per in PLANS.items())


if __name__ == "__main__":
    main()
