"""The harness on the CPU: BENCHMARK.json against the contract's shape, the
result line's keys, no measurement without a card, and a configuration,
mix, driver and metric found as files by name."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
import types

import pytest

from perfbench import harness
from perfbench.tests.conftest import tiny_cell

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_shape():
    bench = harness.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "perfbench/run.py"]
    assert bench["paths"] == ["perfbench"]
    assert 1 <= bench["run_seconds"] <= 51
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in bench[k]}) == len(bench[k])
    assert len(set(e2e) | {m["name"] for m in bench["per_layer"]}) == len(
        bench["end_to_end"]) + len(bench["per_layer"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        cfg = harness.load_json(ROOT / c["file"])
        assert cfg["name"] == c["name"]
        assert c["reduced"] == cfg["reduced"]
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (harness.BENCH_DIR / "traffic"
                / f"{w['traffic']}.json").is_file()
        assert (harness.BENCH_DIR / "limits" / f"{w['name']}.json").is_file()
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_every_layer_metric_moves_a_metric_its_cells_report():
    bench = harness.benchmark()
    for m in bench["per_layer"]:
        (mover,) = [e for e in bench["end_to_end"] if e["name"] == m["moves"]]
        for cell in m.get("workloads", [w["name"]
                                        for w in bench["workloads"]]):
            assert cell in mover.get("workloads", [cell])
        assert (harness.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
    for w in bench["workloads"]:
        cell = harness.Cell(bench, w["name"])
        assert "setup_s" in [m["name"] for m in cell.end_to_end]
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_result_line_keys_and_checks_last():
    cell = tiny_cell("avmnist_found_train")
    out = cell.module("drivers", "found_train").run(
        cell, seed=5, seconds=0.5, trace=False,
        t_start=time.perf_counter(), device="cpu")
    line = harness.result_line(cell, out, trace=0)
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert set(line["metrics"]) == {"train_samples_per_s", "peak_mem_gib",
                                    "setup_s"}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    json.dumps(line)


def _run_cli(cwd, *extra, env=None):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "avmnist_found_train", "--seed", "1", "--seconds", "1",
         "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def test_no_card_no_measurement():
    """Without a CUDA device the command exits non-zero and prints no
    result: no measurement path falls back to the CPU."""
    proc = _run_cli(ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    with pytest.raises(harness.NoDevice):
        harness.require_devices(1)


def test_benchmark_files_alone_print_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and perfbench/."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = _run_cli(tmp_path, env=env)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_configuration_mix_and_metric_found_as_files(tmp_path):
    """Files added under a benchmark root are found by the names in
    BENCHMARK.json, with no code of the harness edited."""
    root = tmp_path / "bench"
    for d in ("configs", "traffic", "drivers", "metrics", "limits"):
        (root / d).mkdir(parents=True)
    (root / "configs" / "toy.json").write_text(json.dumps(
        {"name": "toy", "reduced": [], "scale": 3}))
    (root / "traffic" / "steady.json").write_text(json.dumps(
        {"driver": "toy_driver", "work": 7}))
    (root / "limits" / "toy.steady.json").write_text(json.dumps(
        {"gap": 0.5}))
    (root / "drivers" / "toy_driver.py").write_text(
        "import types\n"
        "def run(cell, seed, seconds, trace, t_start, device=None):\n"
        "    w = cell.traffic['work'] * cell.cfg['scale']\n"
        "    return types.SimpleNamespace(\n"
        "        correct=True, attempted=w, failed=0,\n"
        "        end_to_end={'items_per_s': float(w), 'setup_s': 1.0},\n"
        "        layer={'busy': 0.25}, trace=None,\n"
        "        device={'platform': 'cpu'},\n"
        "        peaks={}, checks={'gap': {'value': 0.1,\n"
        "                                   'limit': cell.limits['gap']}})\n")
    (root / "metrics" / "toy.busy_share.py").write_text(
        "def read(outcome):\n    return 100 * outcome.layer['busy']\n")
    bench = {
        "configs": [{"name": "toy", "file": str(root / "configs"
                                                / "toy.json")}],
        "workloads": [{"name": "toy.steady", "config": "toy",
                       "traffic": "steady", "chips": 1}],
        "end_to_end": [{"name": "items_per_s", "unit": "items/s"},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "toy.busy_share", "unit": "%",
                       "moves": "items_per_s"}]}
    cell = harness.Cell(bench, "toy.steady", root=root)
    drv = cell.module("drivers", cell.traffic["driver"])
    out = drv.run(cell, seed=1, seconds=1, trace=False, t_start=0.0)
    assert harness.result_line(cell, out, 0)["metrics"]["items_per_s"][
        "value"] == 21.0
    line = harness.result_line(cell, out, 1)
    assert line["metrics"] == {"toy.busy_share": {"value": 25.0,
                                                  "unit": "%"}}
    assert line["checks"] == {"gap": {"value": 0.1, "limit": 0.5}}


def test_missing_reading_leaves_the_metric_out():
    cell = harness.Cell(harness.benchmark(), "avmnist_found_train")
    outcome = types.SimpleNamespace(
        correct=True, attempted=1, failed=0, end_to_end={}, device={},
        layer={"model_flops": None, "window_s": 1.0, "loader_ms": None},
        trace=None, peaks={}, checks={})
    assert harness.result_line(cell, outcome, 1)["metrics"] == {}
