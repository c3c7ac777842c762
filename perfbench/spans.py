"""The program's spans (mfas_tpu_torch/runtime/profiler.py: ``span``, and
``SectionTimer``'s sections, which are spans too), read for the per-layer
metrics of a traced run. Spans record only while a profiler runs, and a
traced run holds one profiler session, so the registry's totals are the
traced part of the window (``outcome.trace["window_s"]``). Every reader
gives None without a trace, and where the program has no span registry or
never entered the span."""


def totals(outcome):
    """name -> {"count", "host_s", "top_s", "idle_s"}, or None without a
    trace or a registry."""
    trace = outcome.trace
    if trace is None or not trace["window_s"]:
        return None
    from mfas_tpu_torch.runtime import profiler

    read = getattr(profiler, "span_totals", None)
    return None if read is None else read()


def host_pct(outcome, name):
    """The span's host seconds as a share of the traced window."""
    spans = totals(outcome)
    if not spans or name not in spans:
        return None
    return 100.0 * spans[name]["host_s"] / outcome.trace["window_s"]


def unnamed_pct(outcome):
    """The share of the traced window outside every top-level span;
    "graphs.capture" is no part of the partition (it nests inside the
    span that asked for the capture)."""
    spans = totals(outcome)
    if not spans:
        return None
    named = sum(s["top_s"] for name, s in spans.items()
                if name != "graphs.capture")
    window = outcome.trace["window_s"]
    return 100.0 * (window - named) / window


def named_idle_pct(outcome):
    """The device's idle seconds inside host-only spans, as a share of the
    traced window."""
    spans = totals(outcome)
    idle = [s["idle_s"] for s in (spans or {}).values()
            if s["idle_s"] is not None]
    if not idle:
        return None
    return 100.0 * sum(idle) / outcome.trace["window_s"]
