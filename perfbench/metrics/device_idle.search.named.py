"""device_idle.search.named: the device's idle seconds inside the program's
host-only spans ("loader.wait", the section "sampler"), timed by a CUDA
event pair on the current stream around each, over the traced search
window."""

from perfbench import spans


def read(outcome):
    return spans.named_idle_pct(outcome)
