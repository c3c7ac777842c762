"""loader.wait.train: the share of the traced training window in which the
engine waited for a loader batch: the host seconds of the span
"loader.wait" (mfas_tpu_torch/data/loader.py::prefetch_to_device, which
``ClassifierEngine._prefetched`` runs for train and dev batches)."""

from perfbench import spans


def read(outcome):
    return spans.host_pct(outcome, "loader.wait")
