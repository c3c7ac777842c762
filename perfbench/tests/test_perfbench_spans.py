"""The readers of the program's spans (perfbench/spans.py and the metrics
that read it): None without a trace, or where the program has no span
registry, and each share from a registry the test fills in."""

from __future__ import annotations

import types

import pytest

from perfbench import harness
from mfas_tpu_torch.runtime import profiler

WINDOW = 20.0
REGISTRY = {
    "loader.wait": {"count": 72, "host_s": 4.0, "top_s": 4.0,
                    "idle_s": 3.5},
    "sampler": {"count": 8, "host_s": 0.02, "top_s": 0.02, "idle_s": 0.01},
    "features": {"count": 72, "host_s": 10.0, "top_s": 10.0,
                 "idle_s": None},
    "population.setup": {"count": 24, "host_s": 0.6, "top_s": 0.6,
                         "idle_s": None},
    "population.readback": {"count": 72, "host_s": 0.2, "top_s": 0.2,
                            "idle_s": None},
    "graphs.capture": {"count": 1, "host_s": 0.5, "top_s": 0.0,
                       "idle_s": None},
}
# the metric -> its reading from REGISTRY over WINDOW
WANT = {
    "loader.wait.search": 20.0,
    "loader.wait.train": 20.0,
    "population.setup_pct": 3.0,
    "population.readback_pct": 1.0,
    "graphs.capture_pct": 2.5,
    "searcher.unnamed_pct": 100.0 * (WINDOW - 14.82) / WINDOW,
    "device_idle.search.named": 100.0 * 3.51 / WINDOW,
    "device_idle.train.named": 100.0 * 3.51 / WINDOW,
}


def _outcome(trace=True):
    return types.SimpleNamespace(
        trace={"window_s": WINDOW, "busy_s": 15.0, "n_device_ops": 9}
        if trace else None, layer={})


def _reader(name):
    return harness.load_file_module("metrics", name)


def test_every_span_metric_is_in_the_benchmark():
    names = {m["name"]: m for m in harness.benchmark()["per_layer"]}
    for name in WANT:
        assert names[name]["source"] == "program_span"
        assert names[name]["unit"] == "%"


@pytest.mark.parametrize("name", sorted(WANT))
def test_span_reader(name, monkeypatch):
    monkeypatch.setattr(profiler, "span_totals",
                        lambda: {k: dict(v) for k, v in REGISTRY.items()})
    read = _reader(name).read
    assert read(_outcome(trace=False)) is None
    assert read(_outcome()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_span_reader_without_a_registry(name, monkeypatch):
    """A program without spans (the benchmark laid over an older commit)
    reads None, and raises nothing."""
    monkeypatch.delattr(profiler, "span_totals")
    assert _reader(name).read(_outcome()) is None


def test_a_span_never_entered_reads_none(monkeypatch):
    monkeypatch.setattr(profiler, "span_totals",
                        lambda: {"features": dict(REGISTRY["features"])})
    for name in ("loader.wait.search", "population.setup_pct",
                 "population.readback_pct", "device_idle.search.named"):
        assert _reader(name).read(_outcome()) is None
    # a window without a capture captured nothing: 0, not unread
    assert _reader("graphs.capture_pct").read(_outcome()) == 0.0
