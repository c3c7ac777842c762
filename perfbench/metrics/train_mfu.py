"""train_mfu: the model FLOPs of the window's train steps and dev passes
(perfbench/counts.py: 3x the forward per train sample, 1x per dev sample),
over the window's seconds, as a share of the peak of the cell's precision
(perfbench/peaks.py)."""


def read(outcome):
    layer = outcome.layer
    if not layer.get("model_flops") or not layer.get("window_s"):
        return None
    return 100.0 * layer["model_flops"] / layer["window_s"] \
        / layer["peak_flops"]
