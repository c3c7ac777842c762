"""``--profile_dir`` (port of mfas_tpu/runtime/profiler.py): an opt-in
``torch.profiler`` trace of the run, while the CLI keeps its summary lines.
``SectionTimer`` splits a run's wall time into named sections;
``StepTimer`` keeps per-step wall times and their summary.
``profile_summary`` reads a trace's kernels: the device's busy time, device
time by kernel class (``KERNEL_CLASSES``) and the largest kernels
(``tools/profile_step.py``, ``chip_smoke.py``)."""

from __future__ import annotations

import contextlib
import json
import os
import time

import numpy as np
import torch


class SectionTimer:
    """Wall seconds per named section. On a CUDA device each section ends
    with a synchronize, so it holds the device work it launched."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds = {}

    @contextlib.contextmanager
    def section(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)


class StepTimer:
    """Host wall time per step, ``start()`` to ``stop()``. On a CUDA device
    ``stop`` synchronizes first, so a step holds the device work it
    launched."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.times = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.times.append(time.perf_counter() - self._t0)

    def summary(self):
        """{} before any step, else the count, mean, median and 95th
        percentile in seconds (the JAX package's keys)."""
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {"steps": len(arr), "mean_s": float(arr.mean()),
                "p50_s": float(np.percentile(arr, 50)),
                "p95_s": float(np.percentile(arr, 95))}


@contextlib.contextmanager
def maybe_profile(profile_dir, device):
    """Profile the block when ``profile_dir`` is given, with the card's
    activity when ``device`` is CUDA: ``trace.json`` (chrome://tracing or
    Perfetto) and ``ops.txt`` (per-op totals, by self device time on the
    card, self CPU time otherwise). Yields the profiler, or None when off."""
    if not profile_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    sort = "self_device_time_total" if on_card else "self_cpu_time_total"
    with open(os.path.join(profile_dir, "ops.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=40))


# kernel classes of a train step, by kernel name: the first class one of
# whose substrings the name holds (cuDNN names its conv kernels fprop/dgrad/
# wgrad or convolve*; torch's foreach Adam runs in multi_tensor_apply)
KERNEL_CLASSES = (
    ("input_K1_K2", ("u8_norm",)),
    ("conv_wgrad", ("wgrad",)),
    ("conv_dgrad", ("dgrad", "flip_filter")),
    ("conv_fwd", ("fprop", "convolve")),
    ("cudnn_layout", ("nchwToNhwc", "nhwcToNchw")),
    ("pool", ("pool",)),
    ("adam", ("multi_tensor_apply",)),
    ("matmul", ("gemm", "nvjet", "cublas")),
    ("reduce", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "copy_kernel")),
)
# how many of the largest kernels profile_summary lists
TOP_KERNELS = 10


def kernel_class(name):
    for cls, keys in KERNEL_CLASSES:
        if any(k in name for k in keys):
            return cls
    return "other"


def profile_summary(trace_path, steps=1):
    """Device busy time (the union of the kernels' intervals), device time
    by kernel class and the TOP_KERNELS largest kernels of a torch.profiler
    chrome trace; times in ms per step. A trace without kernels (a CPU run)
    gives ``{"kernels": 0}``."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    ks = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                if e.get("cat") == "kernel" and "dur" in e)
    if not ks:
        return {"kernels": 0}
    busy, end = 0.0, ks[0][0]
    by_name, by_class = {}, {}
    for a, b, name in ks:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        by_name[name] = by_name.get(name, 0.0) + (b - a)
        c = kernel_class(name)
        by_class[c] = by_class.get(c, 0.0) + (b - a)
    span = end - ks[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP_KERNELS]
    per = 1e3 * steps       # trace times are µs
    return {"kernels_per_step": len(ks) / steps,
            "device_busy_ms": busy / per, "span_ms": span / per,
            "busy_share": busy / span,
            "by_class_ms": {c: t / per for c, t in sorted(
                by_class.items(), key=lambda kv: -kv[1])},
            "top_ms": [[n[:70], t / per] for n, t in top]}
