"""The readings the limits of ``correct`` are set from, on the card at a
cell's own size, several seeds in one process:

* ``program``: the numbers a sound run compares (the program's timed path
  against the float32 reference), the lower readings;
* ``control``: the reference in the program's place with TF32 on (the
  precision below the configuration's float32 with TF32 off), against the
  float32 reference, the upper readings;
* ``fault``: a training cell's reference with every second edge of its
  batch masked (left out of the messages and of the loss, whose mean is
  taken over the rest); a prediction cell's
  program output with one sampled edge's block set to zero.  (A step that
  returns its state unchanged reads 1 in ``change_gap`` by definition.)

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 [--seconds 1]

prints one JSON line a seed.  The benchmark's own runs never run this.
"""

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def readings(cell, seed: int, seconds: float, device) -> dict:
    from harness import cells, correct
    from harness.weights import make_weights

    kind = cell.traffic["kind"]
    t_start = time.perf_counter()
    out = {"seed": seed}
    if kind == "train":
        run, record, follow = cells.train(cell, seed, seconds, False, device, t_start,
                                          log=lambda m: None)
        cells.release()
        weights = make_weights(run.leaves, seed, device)
        ref = correct.reference_train_record(cell.config, weights, follow, device)
        out["program"] = correct.train_numbers(record, ref)
        tf32 = correct.reference_train_record(cell.config, weights, follow, device, tf32=True)
        out["control"] = correct.train_numbers(tf32, ref)
        with _half_edges():
            half = correct.reference_train_record(cell.config, weights, follow, device)
        out["fault_half_batch"] = correct.train_numbers(half, ref)
    else:
        run, kept, crystals = cells.predict(cell, seed, seconds, False, device, t_start,
                                            log=lambda m: None)
        cells.release()
        weights = make_weights(run.leaves, seed, device)
        sample = {j: crystals[j] for j in kept}
        ref = correct.reference_predictions(cell.config, weights, sample, device)
        out["program"] = correct.predict_numbers(kept, ref)
        tf32 = correct.reference_predictions(cell.config, weights, sample, device, tf32=True)
        out["control"] = correct.predict_numbers(tf32, ref)
        altered = {}
        for j, pred in kept.items():
            pred = dict(pred)
            for k in pred:
                if k.endswith("_off"):
                    pred[k] = pred[k].clone()
                    pred[k][seed % crystals[j]["edge_index"].shape[1]] = 0.0
            altered[j] = pred
        out["fault_altered_answer"] = correct.predict_numbers(altered, ref)
    out["attempted"] = len(run.items)
    return out


@contextlib.contextmanager
def _half_edges():
    """The reference's graphs with every second edge masked."""
    import torch

    from reference import graph as ref_graph

    original = ref_graph.graph_from_crystal

    def halved(c, device, dtype=torch.float32):
        g = original(c, device, dtype)
        keep = torch.arange(g.num_edges, device=g.edge_mask.device) % 2 == 0
        return dataclasses.replace(g, edge_mask=g.edge_mask & keep)

    ref_graph.graph_from_crystal = halved
    try:
        yield
    finally:
        ref_graph.graph_from_crystal = original


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=1.0)
    args = parser.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    import torch

    from harness import spec

    if not torch.cuda.is_available():
        print("the control readings need a CUDA device", file=sys.stderr)
        return 2
    cell = spec.resolve(ROOT, args.workload)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, args.seconds, torch.device("cuda", 0))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
