"""The traced run's device trace (``--trace 1``): ``torch.profiler`` over the
measured window's last seconds, reduced in one pass after the window to
the device's busy seconds, device time by kernel class and by kernel name,
and the longest idle gaps labelled by what the host was doing. No chrome
trace is written.
"""

from __future__ import annotations

import time

import torch

# kernel classes by kernel name: the first class one of whose substrings
# the name holds (a copy of mfas_tpu_torch/runtime/profiler.py's table)
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
TOP = 10


def kernel_class(name):
    for cls, keys in KERNEL_CLASSES:
        if any(k in name for k in keys):
            return cls
    if name.startswith(("Memcpy", "Memset")):
        return "memcpy_memset"
    return "other"


class DeviceTrace:
    """A profiler over one window: ``start()``, ``stop()``, then
    ``summary``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.summary = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        window_s = time.perf_counter() - self._t0
        self._prof.stop()
        self.summary = reduce_events(
            self._prof.profiler.kineto_results.events(), window_s)
        self._prof = None
        return self.summary


def reduce_events(events, window_s):
    """-> dict(busy_s, window_s, by_class, by_name, kernels (name ->
    [count, seconds]), idle_gaps)."""
    dev, host = [], []
    for e in events:
        kind = str(e.device_type())
        start = e.start_ns()
        dur = e.duration_ns()
        if kind.endswith("CUDA"):
            dev.append((start, start + dur, e.name()))
        elif not _is_python(e):
            host.append((start, start + dur, e.name()))
    out = {"window_s": window_s, "busy_s": 0.0, "by_class": {},
           "kernels": {}, "idle_gaps": [], "n_device_ops": len(dev)}
    if not dev:
        return out
    dev.sort()
    busy, end = 0, dev[0][0]
    gaps = []
    kernels = {}
    by_class = {}
    for a, b, name in dev:
        if a > end:
            gaps.append((a - end, end, a))
        busy += max(0, b - max(a, end))
        end = max(end, b)
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (b - a) / 1e9
        c = kernel_class(name)
        by_class[c] = by_class.get(c, 0.0) + (b - a) / 1e9
    out["busy_s"] = busy / 1e9
    out["by_class"] = dict(sorted(by_class.items(), key=lambda kv: -kv[1]))
    out["kernels"] = kernels
    gaps.sort(reverse=True)
    out["idle_gaps"] = [[_host_label(host, (g0 + g1) // 2), dur / 1e9]
                        for dur, g0, g1 in gaps[:TOP]]
    return out


def _is_python(event):
    # torch releases differ in which event accessors they have
    check = getattr(event, "is_python_function", None)
    return bool(check()) if check is not None else False


def _host_label(host, t):
    """The innermost host event running at ``t`` (the latest-starting
    one that covers it), else the last one that had ended."""
    best, last = None, None
    for a, b, name in host:
        if a <= t <= b and (best is None or a > best[0]):
            best = (a, name)
        elif b < t and (last is None or b > last[0]):
            last = (b, name)
    if best is not None:
        return best[1][:80]
    return ("after " + last[1])[:80] if last is not None else "host"


def kernel_seconds(summary, substring):
    """(launches, seconds) of the kernels whose name holds ``substring``."""
    n, s = 0, 0.0
    for name, (count, seconds) in summary["kernels"].items():
        if substring in name:
            n += count
            s += seconds
    return n, s


def breakdown(summary):
    """The result line's ``breakdown``: the device time by kernel class
    and the longest idle gaps, at most TOP entries each."""
    ops = list(summary["by_class"].items())[:TOP]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": summary["idle_gaps"][:TOP]}

