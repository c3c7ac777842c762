"""The port's spans (mfas_tpu_torch/runtime/profiler.py: ``span``, the span
registry, ``SectionTimer``'s sections and ``maybe_profile``'s span table)
on the CPU: off without a profiler, counted under one, and placed so that a
tiny NTU search's top-level spans partition its wall time. This file
imports neither JAX nor the JAX package."""

import random
import time

import numpy as np
import pytest
import torch
from torch.profiler import profile

from mfas_tpu_torch import main_searchable_ntu as tmain
from mfas_tpu_torch.data import ntu_pack as tpack
from mfas_tpu_torch.data.loader import prefetch_to_device
from mfas_tpu_torch.runtime import profiler as TP
from mfas_tpu_torch.search.searchers import NTUSearcher

SECTIONS = ("sampler", "surrogate", "population steps", "features")
# entries of each section in the tiny search below, counted with the same
# wrapper around SectionTimer.section before the sections became spans
SECTION_ENTRIES = {"sampler": 4, "surrogate": 3, "population steps": 20,
                   "features": 14}


@pytest.fixture(autouse=True)
def spans():
    TP.reset_spans()
    yield
    TP.reset_spans()


def _raise(*a, **k):
    raise AssertionError("called with no profiler active")


def test_span_without_a_profiler_does_nothing(monkeypatch):
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.cuda, "Event", _raise)
    timer = TP.SectionTimer("cpu")
    with TP.span("loader.wait", host_only=True):
        with TP.span("population.setup"):
            pass
    with timer.section("sampler", host_only=True):
        pass
    assert TP.span_totals() == {}
    assert set(timer.seconds) == {"sampler"}


def test_spans_count_under_a_profiler():
    with profile() as prof:
        for _ in range(3):
            with TP.span("population.setup"):
                with TP.span("graphs.capture"):
                    pass
        with TP.span("loader.wait", host_only=True):
            time.sleep(0.02)
    got = TP.span_totals()
    assert got["population.setup"]["count"] == 3
    assert got["graphs.capture"]["count"] == 3
    assert got["graphs.capture"]["top_s"] == 0.0      # nested
    assert got["loader.wait"]["count"] == 1
    assert got["loader.wait"]["host_s"] >= 0.02
    assert got["loader.wait"]["top_s"] == got["loader.wait"]["host_s"]
    # the CPU has no stream to time idle on
    assert all(s["idle_s"] is None for s in got.values())
    annotations = {e.name: e for e in prof.events() if e.is_user_annotation}
    assert "loader.wait" in annotations
    assert annotations["loader.wait"].device_type == \
        torch.autograd.DeviceType.CPU
    # spans that may launch device work stay out of the trace
    assert "population.setup" not in annotations
    assert "graphs.capture" not in annotations


def test_a_section_adds_to_its_timer_and_the_registry():
    timer = TP.SectionTimer("cpu")
    with profile():
        with timer.section("features"):
            time.sleep(0.01)
        with timer.section("sampler", host_only=True):
            time.sleep(0.01)
    got = TP.span_totals()
    for name in ("features", "sampler"):
        assert got[name]["count"] == 1
        # the span holds the section; a thread switch may fall between
        assert got[name]["host_s"] >= timer.seconds[name] >= 0.01
        assert got[name]["host_s"] == pytest.approx(timer.seconds[name],
                                                    abs=0.005)


def test_each_wait_of_the_prefetch_consumer_is_a_span():
    with profile():
        got = list(prefetch_to_device(iter(range(3)), lambda b: b * 2))
    assert got == [0, 2, 4]
    # three batches and the end of the stream
    assert TP.span_totals()["loader.wait"]["count"] == 4


def test_maybe_profile_writes_the_span_table(tmp_path):
    with TP.maybe_profile(str(tmp_path), "cpu"):
        with TP.span("loader.wait", host_only=True):
            time.sleep(0.01)
        with TP.span("loader.wait", host_only=True):
            pass
    text = (tmp_path / "ops.txt").read_text()
    row = [ln for ln in text.splitlines() if ln.startswith("loader.wait")]
    assert len(row) == 1
    name, count, host_s, top_s, idle = row[0].split()
    assert int(count) == 2 and float(host_s) >= 0.01 and idle == "-"
    assert text.index("loader.wait") > text.index("Name")   # under the ops


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = tmp_path_factory.mktemp("spans_ntu")
    for seed, (split, n) in enumerate((("trainexp", 12), ("dev", 6))):
        tpack.make_synthetic_packed_ntu(str(root / "packed" / split), n=n,
                                        frames=6, h=32, w=32, skel_frames=40,
                                        num_classes=3, seed=seed)
    return root


@pytest.fixture
def one_thread():
    """One intra-op thread: under a parallel test runner every split op
    waits on threads the other workers' processes hold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_a_tiny_search_is_partitioned_by_its_spans(store, monkeypatch,
                                                   one_thread):
    args = tmain.parse_args([
        "--packed_datadir", str(store / "packed"), "--checkpointdir",
        str(store), "--num_outputs", "3", "--batchsize", "4",
        "--vid_len", "4", "32", "--resnet3d_layers", "1", "1", "1", "1",
        "--resnet3d_base_width", "8", "--drpt", "0", "--j", "2",
        "--search_iterations", "1", "--max_fusions", "2",
        "--num_samples", "3", "--epochs", "2", "--epochs_surrogate", "5",
        "--device_input_normalize", "--no-verbose", "--random_backbones"])
    entries = {}
    section = TP.SectionTimer.section

    def counted(self, name, host_only=False):
        entries[name] = entries.get(name, 0) + 1
        return section(self, name, host_only)

    monkeypatch.setattr(TP.SectionTimer, "section", counted)
    np.random.seed(0)
    random.seed(0)
    timer = TP.SectionTimer("cpu")
    searcher = NTUSearcher(args, device="cpu", timer=timer)
    with profile():
        t0 = time.perf_counter()
        searcher.search()
        wall = time.perf_counter() - t0
    got = TP.span_totals()
    assert entries == SECTION_ENTRIES
    for name in SECTIONS:
        assert got[name]["count"] == entries[name]
        # each entry's span holds the section's time and a few statements
        # besides, where a switch to a loader thread may fall (the
        # interpreter's switch interval is 5 ms)
        assert timer.seconds[name] <= got[name]["host_s"] \
            <= timer.seconds[name] + 0.01 * entries[name]
    # the top-level spans do not overlap: with the remainder they make up
    # the search's wall time
    named = sum(s["top_s"] for name, s in got.items()
                if name != "graphs.capture")
    assert 0.0 < named <= wall * 1.01
    for name in ("loader.wait", "population.setup", "population.readback"):
        assert got[name]["top_s"] == pytest.approx(got[name]["host_s"])
    # two populations of two epochs: one setup before the epochs and one
    # after them, two readbacks an epoch; each epoch's train pass waits
    # for its 3 batches and the end of the stream, the first dev pass for
    # 2 and the end (dev features are kept after it)
    assert got["population.setup"]["count"] == 2 * 2
    assert got["population.readback"]["count"] == 2 * 2 * 2
    assert got["loader.wait"]["count"] == 2 * 2 * (3 + 1) + (2 + 1)
    assert "graphs.capture" not in got       # the CPU runs eagerly
