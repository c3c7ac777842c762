"""searcher.sampler_pct: the share of the search window in the
``SectionTimer`` section "sampler" (mfas_tpu_torch/runtime/profiler.py;
each section ends with a device synchronize), over the window's host
seconds."""


def read(outcome):
    sections = outcome.layer.get("sections")
    if not sections or not outcome.layer.get("window_s"):
        return None
    return 100.0 * sections["sampler"] / outcome.layer["window_s"]
