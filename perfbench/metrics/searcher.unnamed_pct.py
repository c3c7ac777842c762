"""searcher.unnamed_pct: the share of the traced search window outside every
top-level span of the program: its sections (sampler, surrogate,
population steps, features), "loader.wait", "population.setup" and
"population.readback" ("graphs.capture" nests inside a section)."""

from perfbench import spans


def read(outcome):
    return spans.unnamed_pct(outcome)
