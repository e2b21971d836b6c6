"""A run of a cell from its specification to its result line: the run of
``cells``, the comparison with the reference once the program's state is
freed, and every metric the cell reports, each read by its own file under
``metrics/``."""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import torch

from . import cells, correct, spec, work
from .weights import make_weights

PROBE = {"atoms": 5, "cell_A": 5.0, "species": [6, 14], "neighbour_cutoff_A": 3.5,
         "seed_offset": 0}


@dataclasses.dataclass
class Context:
    """What a metric's ``read`` gets."""
    kind: str                    # the traffic's kind: train or predict
    run: cells.Run
    work: Optional[work.ModelWork] = None


def model_work(config: Dict) -> work.ModelWork:
    """The reference model's work counts, from a forward on a small crystal
    on the host."""
    from reference.build import build_model
    from reference.graph import graph_from_crystal

    from .traffic import make_one

    probe = graph_from_crystal(make_one(PROBE, config["targets"], 0, 0), "cpu")
    return work.model_work(build_model(config["model"]), probe)


def device_info(device, run: cells.Run, traced: bool) -> Dict:
    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                "memory_peak_bytes": int(run.memory_peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if traced and run.trace is not None:
        info["busy_s"] = run.trace.busy_s()
        info["window_s"] = run.trace.window_s
    return info


def compare(cell: spec.Cell, seed: int, device, outcome, log) -> Dict[str, float]:
    """The comparison's numbers, the reference run on the freed device."""
    kind = cell.traffic["kind"]
    t0 = time.perf_counter()
    weights = make_weights(outcome["leaves"], seed, device)
    if kind == "train":
        ref = correct.reference_train_record(cell.config, weights, outcome["follow"], device)
        numbers = correct.train_numbers(outcome["record"], ref)
    else:
        ref = correct.reference_predictions(
            cell.config, weights, {j: outcome["crystals"][j] for j in outcome["kept"]}, device)
        numbers = correct.predict_numbers(outcome["kept"], ref)
    log(f"reference: {time.perf_counter() - t0:.3f} s")
    return numbers


def execute(cell: spec.Cell, seed: int, seconds: float, traced: bool, device,
            t_start: float, log=print, faults=None) -> Dict:
    """One run of ``cell``; returns the result line's object.  ``faults``: a
    context manager to run the program under (the tests plant faults in the
    timed path with it)."""
    import contextlib

    kind = cell.traffic["kind"]
    with (faults or contextlib.nullcontext()):
        if kind == "train":
            run, record, follow = cells.train(cell, seed, seconds, traced, device, t_start, log)
            outcome = {"record": record, "follow": follow}
        elif kind == "predict":
            run, kept, crystals = cells.predict(cell, seed, seconds, traced, device, t_start,
                                                log)
            outcome = {"kept": kept, "crystals": crystals}
        else:
            raise ValueError(f"traffic kind {kind!r}: train or predict")
    cells.release()
    outcome["leaves"] = run.leaves
    numbers = compare(cell, seed, device, outcome, log)
    ctx = Context(kind=kind, run=run, work=model_work(cell.config) if traced else None)
    wanted = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = spec.metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if kind == "predict":
        log(f"predictions in the window: {len(run.latency_s)}")
    result = {"correct": correct.judge(numbers, cell.limits), "attempted": len(run.items),
              "failed": run.failed, "metrics": metrics,
              "device": device_info(device, run, traced)}
    if traced and run.trace is not None:
        result["breakdown"] = run.trace.breakdown()
    result["compared"] = {k: {"value": v, "limit": cell.limits[k]} for k, v in numbers.items()}
    return result

