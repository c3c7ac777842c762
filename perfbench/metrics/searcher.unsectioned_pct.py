"""searcher.unsectioned_pct: the share of the search window outside every
``SectionTimer`` section (sampler, surrogate, population steps, features):
the searcher's own loop, loader waits, captures and whatever no span names
yet."""


def read(outcome):
    sections = outcome.layer.get("sections")
    window = outcome.layer.get("window_s")
    if not sections or not window:
        return None
    return 100.0 * (window - sum(sections.values())) / window
