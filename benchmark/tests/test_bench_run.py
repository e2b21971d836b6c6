"""A run of a cell end to end on the CPU at a tiny size (the harness's look
for a card skipped): a sound run comes out correct, and a run with its timed
path broken underneath comes out not correct, once for each fault the cell
can have.  And the command itself refuses to run without a card."""

import dataclasses
import os
import shutil
import subprocess
import sys
import time
from unittest import mock

import pytest
import torch

from bench_tiny import BENCH, CELLS, ROOT, tiny_cell
from harness import runner

SEED = 2**31 + 17


def run_cell(name, faults=None, traced=False):
    return runner.execute(tiny_cell(name), SEED, 0.5, traced, torch.device("cpu"),
                          time.perf_counter(), log=lambda m: None, faults=faults)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result = run_cell(name)
    assert result["correct"], result["compared"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "compared"
    assert set(result["metrics"]) >= {"setup_s"}


def state_unchanged():
    """The optimizer's step leaves the parameters and its state as they were."""
    from hamgnn_tpu_torch.train.optim import Amsgrad

    return mock.patch.object(Amsgrad, "step",
                             lambda self, params, grad, lr, loss=None: torch.ones((), dtype=torch.bool))


def half_batch():
    """The loss of every step over the first half of the batch's edges alone
    (its mean taken over the rest)."""
    from hamgnn_tpu_torch.train import trainer

    original = trainer.compute_losses

    def halved(preds, graph, losses, **kw):
        keep = torch.arange(graph.edge_mask.shape[0]) < graph.edge_mask.sum() // 2
        return original(preds, dataclasses.replace(graph, edge_mask=graph.edge_mask & keep),
                        losses, **kw)

    return mock.patch.object(trainer, "compute_losses", halved)


def altered_answer(key):
    """One edge's Hamiltonian block altered where the head produces it."""
    from hamgnn_tpu_torch.models.output import HamGNNPlusPlusOut

    original = HamGNNPlusPlusOut.forward_view

    def altered(self, view, representation, k_vecs=None):
        out = original(self, view, representation, k_vecs=k_vecs)
        h = out[key].clone()
        h[0] = h[0] + 1.0
        return dict(out, **{key: h})

    return mock.patch.object(HamGNNPlusPlusOut, "forward_view", altered)


@pytest.mark.parametrize("name,fault", [
    ("nao26-train-c512", state_unchanged),
    ("nao26-train-c512", half_batch),
    ("nao26soc-train-c512", state_unchanged),
    ("nao26soc-train-c512", half_batch),
    ("nao26-predict-c512", lambda: altered_answer("hamiltonian_off")),
])
def test_a_fault_in_the_timed_path_is_not_correct(name, fault):
    result = run_cell(name, faults=fault())
    assert not result["correct"], result["compared"]


def test_traced_run_reads_its_layers():
    result = run_cell("nao26-train-c512", traced=True)
    assert {"data_wait_ms.train", "mfu.train", "step_host_ms.train"} <= set(result["metrics"])
    assert "breakdown" in result and "window_s" in result["device"]
    # no device on the CPU: no kernel, so no roofline
    assert "b2_roofline" not in result["metrics"]


@pytest.mark.parametrize("only_paths", [False, True])
def test_the_command_fails_without_a_card(tmp_path, only_paths):
    """No CUDA device (or a checkout holding only BENCHMARK.json and the
    benchmark's folder): exit code other than 0, no result printed."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cwd = ROOT
    if only_paths:
        shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
        shutil.copytree(BENCH, tmp_path / "benchmark",
                        ignore=shutil.ignore_patterns("__pycache__"))
        cwd = str(tmp_path)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                          "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                         cwd=cwd, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""

