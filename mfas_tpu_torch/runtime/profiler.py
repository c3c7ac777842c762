"""``--profile_dir`` (port of mfas_tpu/runtime/profiler.py): an opt-in
``torch.profiler`` trace of the run, while the CLI keeps its summary lines.
``SectionTimer`` splits a run's wall time into named sections."""

from __future__ import annotations

import contextlib
import os
import time

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
