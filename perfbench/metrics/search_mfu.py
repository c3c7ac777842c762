"""search_mfu: the model FLOPs a search needs (the benchmark's count of its
train-mode feature passes: iterations x fusions x epochs x train batches,
each a forward of both backbones at the batch, perfbench/counts.py), times
the searches of the window, over the window's seconds, as a share of the
float32 peak (perfbench/peaks.py)."""


def read(outcome):
    layer = outcome.layer
    if not layer.get("model_flops") or not layer.get("window_s") \
            or "sections" not in layer:
        return None
    return 100.0 * layer["model_flops"] / layer["window_s"] \
        / layer["peak_flops"]
