"""CUDA graphs of the search's programs: the port's counterpart of the JAX
package's jitted ``lax.scan`` programs (search/surrogate.py's fit and
predict, search/population.py's fused bank epoch).

``capture(name, fn, generators)`` warms ``fn`` up on a side stream, then
records one call of it on that stream into a ``torch.cuda.CUDAGraph``. The
tensors ``fn`` reads are its static inputs: the caller fills them with
``copy_`` before a replay and reads what ``fn`` wrote after it. ``fn``'s return value lives in
the graph's memory pool and each replay rewrites it. A generator ``fn``
draws from is registered with the graph, so every replay draws the numbers
an eager call from the generator's state would. The warm-up calls change
what ``fn`` writes, so the caller loads its state after the capture.

A failed capture or replay raises; nothing here falls back to eager calls.

``GRAPH_COUNTS``: captures and replays per program name since
``reset_graph_counts()``, which is how a run shows that it went through its
graphs.
"""

from __future__ import annotations

import torch

WARMUP_CALLS = 2

GRAPH_COUNTS: dict = {}


def reset_graph_counts():
    GRAPH_COUNTS.clear()


def _count(name, what):
    counts = GRAPH_COUNTS.setdefault(name, {"captures": 0, "replays": 0})
    counts[what] += 1


class Graph:
    """One captured call: ``replay()`` reruns it, ``out`` is what it
    returned."""

    def __init__(self, name, graph, out):
        self.name, self._graph, self.out = name, graph, out

    def replay(self):
        self._graph.replay()
        _count(self.name, "replays")


def capture(name, fn, generators=()):
    """``fn()`` warmed up and captured (see the module docstring)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(WARMUP_CALLS):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    with torch.cuda.graph(graph, stream=side):
        out = fn()
    _count(name, "captures")
    return Graph(name, graph, out)
