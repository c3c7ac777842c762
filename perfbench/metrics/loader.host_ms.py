"""loader.host_ms: host milliseconds per batch that the program's loader
yields inside the window, timed around each ``next()`` by the benchmark's
wrapper on the loader's prefetch thread (train and dev batches)."""


def read(outcome):
    return outcome.layer.get("loader_ms")
