"""loader.wait.search: the share of the traced search window in which the
program waited for a loader batch: the host seconds of the span
"loader.wait" (mfas_tpu_torch/data/loader.py::prefetch_to_device, every
``q.get()`` of the consumer, each new thread's first batch included)."""

from perfbench import spans


def read(outcome):
    return spans.host_pct(outcome, "loader.wait")
