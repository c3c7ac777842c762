"""``--profile_dir`` (port of mfas_tpu/runtime/profiler.py): an opt-in
``torch.profiler`` trace of the run, while the CLI keeps its summary lines.
``span`` names a stretch of the run's host time while a profiler runs, and
the registry (``span_totals``) keeps each span's count, host seconds and,
for host-only spans on the card, the device's idle seconds inside it.
``SectionTimer`` splits a run's wall time into named sections, each a span
too. ``profile_summary`` reads a trace's kernels: the device's busy time,
device time by kernel class (``KERNEL_CLASSES``) and the largest kernels
(``tools/profile_step.py``, ``chip_smoke.py``)."""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time

import torch

# name -> {"count", "host_s", "top_s", "idle_s", "pending"}; see span
_SPANS: dict = {}
_LOCK = threading.Lock()
_OPEN = threading.local()


@contextlib.contextmanager
def span(name, host_only=False):
    """Count the block and its host seconds under ``name`` while a torch
    profiler is active; otherwise the block runs alone, at the cost of one
    read of the profiler's flag.

    ``top_s`` takes the host seconds of the entries made while no other
    span was open on the thread, so the top-level spans of a thread do not
    overlap. A ``host_only`` block launches no device work on its own
    thread. Only such a block becomes a ``record_function`` range in the
    trace, on the device trace's clock (a range that launches kernels would
    add a device-side annotation to the trace's device events). On the card
    it also records a timing event on the current stream before the range
    and another after it: the time between them, resolved by
    ``span_totals``, is the time the stream sat with nothing of this
    thread's to run while the host was inside the block, the device's idle
    time put down to the span. Work that another thread enqueues on the
    same stream inside the block (the loaders' host->device copies) lies
    between the two events, so it counts as idle here, while the device
    trace counts it busy."""
    if not torch.autograd.profiler._is_profiler_enabled:
        yield
        return
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    top = not stack
    events = None
    if host_only and torch.cuda.is_initialized():
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        events[0].record()
    stack.append(name)
    rng = (torch.autograd.profiler.record_function(name) if host_only
           else contextlib.nullcontext())
    try:
        with rng:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
    finally:
        stack.pop()
        if events is not None:
            events[1].record()
        with _LOCK:
            s = _SPANS.get(name)
            if s is None:
                s = _SPANS[name] = {"count": 0, "host_s": 0.0, "top_s": 0.0,
                                    "idle_s": None, "pending": []}
            s["count"] += 1
            s["host_s"] += dt
            if top:
                s["top_s"] += dt
            if events is not None:
                s["pending"].append(events)


def span_totals():
    """name -> {"count", "host_s", "top_s", "idle_s"} of every span entered
    since ``reset_spans``; ``idle_s`` is None for a span that timed no
    device idle (not host-only, or off the card). The device idle of the
    entries not yet read is resolved here, after one synchronize."""
    with _LOCK:
        if any(s["pending"] for s in _SPANS.values()):
            torch.cuda.synchronize()
        for s in _SPANS.values():
            for a, b in s["pending"]:
                s["idle_s"] = (s["idle_s"] or 0.0) + a.elapsed_time(b) / 1e3
            s["pending"] = []
        return {name: {k: s[k] for k in ("count", "host_s", "top_s",
                                         "idle_s")}
                for name, s in _SPANS.items()}


def reset_spans():
    with _LOCK:
        _SPANS.clear()


def span_table():
    """The registry as a text table, one span a line."""
    rows = [f"{'span':<24}{'count':>8}{'host s':>12}{'top-level s':>14}"
            f"{'device idle s':>16}"]
    for name, s in sorted(span_totals().items()):
        idle = "-" if s["idle_s"] is None else f"{s['idle_s']:.4f}"
        rows.append(f"{name:<24}{s['count']:>8}{s['host_s']:>12.4f}"
                    f"{s['top_s']:>14.4f}{idle:>16}")
    return "\n".join(rows) + "\n"


class SectionTimer:
    """Wall seconds per named section. On a CUDA device each section ends
    with a synchronize, so it holds the device work it launched. Each
    section is also a ``span`` of its name, its synchronize included."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds = {}

    @contextlib.contextmanager
    def section(self, name, host_only=False):
        with span(name, host_only):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self.seconds[name] = (self.seconds.get(name, 0.0)
                                      + time.perf_counter() - t0)


@contextlib.contextmanager
def maybe_profile(profile_dir, device):
    """Profile the block when ``profile_dir`` is given, with the card's
    activity when ``device`` is CUDA: ``trace.json`` (chrome://tracing or
    Perfetto) and ``ops.txt`` (per-op totals, by self device time on the
    card, self CPU time otherwise, then the spans of the block:
    ``span_table``). Yields the profiler, or None when off."""
    if not profile_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    os.makedirs(profile_dir, exist_ok=True)
    reset_spans()
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    sort = "self_device_time_total" if on_card else "self_cpu_time_total"
    with open(os.path.join(profile_dir, "ops.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=40))
        f.write("\n" + span_table())


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
