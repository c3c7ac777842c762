"""k2_roofline: kernel K2's least time from bytes (perfbench/counts.py
``k2_bytes`` at 3.35 TB/s, perfbench/peaks.py) over its device time in
the trace, summed over its launches in the traced window. K1 and K2 share
the kernel ``u8_norm_frames``; in a cell whose prep is K2 every launch of
it is K2's."""

from perfbench import peaks
from perfbench.tracing import kernel_seconds


def read(outcome):
    layer = outcome.layer
    if layer.get("k2_bytes") is None or outcome.trace is None:
        return None
    launches, seconds = kernel_seconds(outcome.trace, "u8_norm_frames")
    if not launches or seconds <= 0.0:
        return None
    least = launches * layer["k2_bytes"] / peaks.HBM_BYTES_PER_S
    return 100.0 * least / seconds
