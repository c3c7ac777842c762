"""device_idle.search: the share of the traced window in which no operation
ran on the card (torch.profiler's device events, their union)."""


def read(outcome):
    trace = outcome.trace
    if trace is None or not trace["window_s"] or not trace["n_device_ops"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
