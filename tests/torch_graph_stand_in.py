"""An eager stand-in for the CUDA graphs of mfas_tpu_torch/runtime/graphs.py,
for the CPU tests of the port's graphed programs.

``_eager_record`` replaces ``graphs._record``: it makes the warm-up calls
and the captured call as a capture would, then reruns the captured function
at every replay, writing its results into the tensors the captured call
returned and holding the replay counters (a replay reruns kernels, not the
Python that counts them). Everything else is the code the card runs: the
signature cache, the static inputs, the resident tensors passed through,
the state put back after the warm-up, the cloned outputs, the counters that
advance per replay, the engines' and the population trainer's graphed
entries. ``eager_capture`` installs it (``eager_graphs`` is the pytest
fixture); with ``force=True`` every engine and trainer built inside it
takes its graphed entries on the CPU under any process group, gloo ones
included, so a test runs the card's bookkeeping, collectives and all, with
the CPU's arithmetic.

This module imports torch, pytest and mfas_tpu_torch only: the rank
processes of tests/torch_ranks.py import it, and they never load JAX.
"""

from __future__ import annotations

import contextlib

import pytest
import torch

from mfas_tpu_torch.runtime import graphs


class _Rerun:
    """The stand-in's graph: ``replay()`` reruns the captured function
    into the tensors its captured call returned (a function that returns
    None, as the fused epoch's chunks, only runs)."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        held = [(c, dict(c)) for c in graphs._REPLAY_COUNTERS]
        new = self.fn()
        for c, v in held:
            graphs._restore(c, v)
        with torch.no_grad():
            for o, n in zip(self.out or (), new or ()):
                o.copy_(n)


def _eager_record(fn, generators, pool, mark):
    for _ in range(graphs.WARMUP_CALLS):
        fn()
    mark()
    out = fn()
    return _Rerun(fn, out), out


@contextlib.contextmanager
def eager_capture(force=False):
    """graphs.capture on the CPU (module docstring); yields GRAPH_COUNTS,
    reset on entry and on exit. ``force``: ``graphs.graphable`` says True
    for every device and group."""
    saved = (graphs._record, graphs.graphable, torch.cuda.graph_pool_handle)
    graphs._record = _eager_record
    torch.cuda.graph_pool_handle = lambda: None
    if force:
        graphs.graphable = lambda device, *groups: True
    graphs.reset_graph_counts()
    try:
        yield graphs.GRAPH_COUNTS
    finally:
        (graphs._record, graphs.graphable,
         torch.cuda.graph_pool_handle) = saved
        graphs.reset_graph_counts()


@pytest.fixture
def eager_graphs():
    """graphs.capture on the CPU (``eager_capture``); yields GRAPH_COUNTS."""
    with eager_capture() as counts:
        yield counts
