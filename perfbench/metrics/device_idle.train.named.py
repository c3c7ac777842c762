"""device_idle.train.named: the device's idle seconds inside the program's
host-only spans (the engine's "loader.wait"), timed by a CUDA event pair on
the current stream around each, over the traced training window."""

from perfbench import spans


def read(outcome):
    return spans.named_idle_pct(outcome)
