"""The port's spans on the card (mfas_tpu_torch/runtime/profiler.py): a tiny
streamed NTU search and one forced graph capture under torch.profiler. The
spans add no device-side annotation to the trace, the device idle they
time lies inside the trace's own idle, and "graphs.capture" counts the
captures. Every test here needs a CUDA device and skips without one. This
file imports neither JAX nor the JAX package, so it also runs where they
are not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_spans.py
"""

import random
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mfas_tpu_torch import main_searchable_ntu as tmain
from mfas_tpu_torch.data import ntu_pack as tpack
from mfas_tpu_torch.runtime import graphs
from mfas_tpu_torch.runtime import profiler as TP
from mfas_tpu_torch.search.searchers import NTUSearcher

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (spans time the device's idle "
                    "with CUDA events)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    TP.reset_spans()
    yield torch.device("cuda")
    TP.reset_spans()


def _captures():
    return sum(c["captures"] for c in graphs.GRAPH_COUNTS.values())


def _busy_s(events):
    """The union of the device events' intervals, in seconds."""
    dev = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in events if str(e.device_type()).endswith("CUDA"))
    busy, end = 0, None
    for a, b in dev:
        end = a if end is None else end
        busy += max(0, b - max(a, end))
        end = max(end, b)
    return busy / 1e9


def test_spans_of_a_streamed_search_on_the_card(cuda, tmp_path):
    for seed, (split, n) in enumerate((("trainexp", 12), ("dev", 6))):
        tpack.make_synthetic_packed_ntu(str(tmp_path / "packed" / split),
                                        n=n, frames=6, h=32, w=32,
                                        skel_frames=40, num_classes=3,
                                        seed=seed)
    args = tmain.parse_args([
        "--packed_datadir", str(tmp_path / "packed"), "--checkpointdir",
        str(tmp_path), "--num_outputs", "3", "--batchsize", "4",
        "--vid_len", "4", "32", "--resnet3d_layers", "1", "1", "1", "1",
        "--resnet3d_base_width", "8", "--drpt", "0", "--j", "2",
        "--search_iterations", "1", "--max_fusions", "2",
        "--num_samples", "3", "--epochs", "2", "--epochs_surrogate", "5",
        "--no-verbose", "--random_backbones"])
    np.random.seed(0)
    random.seed(0)
    searcher = NTUSearcher(args, device=cuda,
                           timer=TP.SectionTimer(cuda))
    searcher.search()           # captures the search's graphs
    torch.cuda.synchronize()
    x = torch.ones(1024, device=cuda)
    before = _captures()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        graphs.capture("spans_forced", lambda: x * 2)
        searcher.search()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    made = _captures() - before
    got = TP.span_totals()
    assert made >= 1 and got["graphs.capture"]["count"] == made
    events = prof.profiler.kineto_results.events()
    annotated = [e.name() for e in events
                 if str(e.device_type()).endswith("CUDA")
                 and e.is_user_annotation()]
    assert annotated == []
    assert any(e.name() == "loader.wait" and e.is_user_annotation()
               for e in events)
    idle = {k: s["idle_s"] for k, s in got.items()
            if s["idle_s"] is not None}
    assert set(idle) == {"loader.wait", "sampler"}
    assert all(v >= 0.0 for v in idle.values())
    trace_idle = 1.0 - _busy_s(events) / window
    named_idle = sum(idle.values()) / window
    assert named_idle <= trace_idle + 0.01, (named_idle, trace_idle, got)
