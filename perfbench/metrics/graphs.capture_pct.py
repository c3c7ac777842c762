"""graphs.capture_pct: the share of the traced search window in the span
"graphs.capture" (mfas_tpu_torch/runtime/graphs.py::capture, its warm-up
calls included). It nests inside the span that asked for the capture; 0 in
a window whose every graph was captured in set-up."""

from perfbench import spans


def read(outcome):
    value = spans.host_pct(outcome, "graphs.capture")
    if value is None and spans.totals(outcome):
        return 0.0
    return value
