"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix and metric resolves to its files, and the file keeps to the
benchmark's contract."""

import json
import os
import re

import pytest

from bench_tiny import BENCH, ROOT
from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark(ROOT)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert bench["command"][1] == "benchmark/run.py"
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_are_unique_and_well_formed(bench):
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), names


@pytest.mark.parametrize("group,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
])
def test_entry_keys(bench, group, keys):
    for entry in bench[group]:
        assert set(entry) == keys, entry


def test_every_cell_resolves_to_its_files(bench):
    configs = {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        assert w["config"] in configs
        cell = spec.resolve(ROOT, w["name"])
        assert cell.limits, w["name"]
        assert cell.traffic["kind"] in ("train", "predict")
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer, w["name"]


def test_every_config_is_used_and_lies_under_paths(bench):
    used = {w["config"] for w in bench["workloads"]}
    files = [c["file"] for c in bench["configs"]]
    assert used == {c["name"] for c in bench["configs"]}
    assert len(files) == len(set(files))
    for c in bench["configs"]:
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["source"] == c["source"]
        assert body["reduced"] == c["reduced"]


def test_every_metric_has_its_reader(bench):
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            assert callable(spec.metric_reader(m["name"])), m["name"]


def test_metric_fields(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    layers = {}
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        layers.setdefault(m["layer"], set()).add(m["name"])
        if m["name"].endswith("_roofline") or "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        for cell in m.get("workloads", []):
            moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
            assert cell in moved.get("workloads", [cell])


def test_check_fits_its_time(bench):
    """A full check of 24 cells at this run length fits its 43,200 s."""
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_traffic_files_exist_for_every_cell(bench):
    for w in bench["workloads"]:
        assert os.path.isfile(os.path.join(BENCH, "traffic", f"{w['traffic']}.json"))
        assert os.path.isfile(os.path.join(BENCH, "workloads", f"{w['name']}.json"))
