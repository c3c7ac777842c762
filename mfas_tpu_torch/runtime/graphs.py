"""CUDA graphs of the port's jitted programs: the counterpart of the JAX
package's jitted ``lax.scan`` programs (search/surrogate.py's fit and
predict, search/population.py's fused bank epoch) and of its per-batch
jitted steps (engine/classifier.py's train and eval step,
search/population.py's streamed ``features``/``train_step``/``eval_step``),
with or without a mesh.

``capture(name, fn, generators, pool)`` warms ``fn`` up on a side stream,
then records one call of it on that stream into a ``torch.cuda.CUDAGraph``
(in the memory pool ``pool`` when given, so several graphs can share one).
The tensors ``fn`` reads are its static inputs: the caller fills them with
``copy_`` before a replay and reads what ``fn`` wrote after it. ``fn``'s
return value lives in the graph's memory pool and each replay rewrites it. A
generator ``fn`` draws from is registered with the graph, so every replay
draws the numbers an eager call from the generator's state would. The
warm-up calls change what ``fn`` writes, so the caller loads its state after
the capture (or lets ``Step`` put it back).

``Step(name, fn, ...)``: a per-batch step captured once per signature of
its batch (a dict of tensors: shapes, dtypes, and the address of each
resident tensor) and replayed after that. It owns the static inputs and
fills them with ``copy_`` before each replay; resident tensors (a store
already on the card at a stable address, which rides in every batch) pass
through uncopied; the outputs are cloned, since the next replay overwrites
them; the warm-up's moves of the step's state (parameters, buffers,
optimizer state, generators) are undone into the same tensors. A train
step's graphs either keep one signature at a time (``exclusive``: the
gradients live in the graph's pool) or live side by side on gradients of
fixed address (``grads``: allocated by the first warm-up, outside every
pool, and zeroed in place by the step).

Counters: a dict registered with ``count_replays`` (the input kernels'
``launch_counts``) counts what a call does. A replay adds what the captured
call added to it; the warm-up calls, whose effects are undone, add nothing.

A failed capture or replay raises; nothing here falls back to eager calls.

Collectives: a program that reduces over an NCCL process group (the data
and pop groups of parallel/mesh.py) is captured with its collectives
inside, since NCCL enqueues them on the card; ``graphable`` says which
programs are. Each group's communicator must exist before the capture: a
group's first collective inside a capture invalidates it, and the warm-up
calls, which run every collective of ``fn`` once, create it.

``GRAPH_COUNTS``: captures and replays per program name since
``reset_graph_counts()``, which is how a run shows that it went through its
graphs. Each capture, its warm-up calls included, is the span
"graphs.capture" (runtime/profiler.py::span), inside whatever span asked
for it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from mfas_tpu_torch.runtime.profiler import span

WARMUP_CALLS = 2

GRAPH_COUNTS: dict = {}

_REPLAY_COUNTERS: list = []


def graphable(device, *groups):
    """Whether the programs of ``device`` that reduce over ``groups`` are
    CUDA graphs: on a CUDA device when every group is None or an NCCL
    group. Gloo runs its collectives on the host, so a capture cannot hold
    them, and a program under a gloo group (and every program on the CPU)
    runs eagerly."""
    return torch.device(device).type == "cuda" and all(
        g is None or dist.get_backend(g) == "nccl" for g in groups)


def reset_graph_counts():
    GRAPH_COUNTS.clear()


def _count(name, what):
    counts = GRAPH_COUNTS.setdefault(name, {"captures": 0, "replays": 0})
    counts[what] += 1


def count_replays(counter):
    """Register ``counter`` (a dict of numbers that calls advance): every
    graph captured after this adds, per replay, what its captured call
    added to it."""
    if not any(c is counter for c in _REPLAY_COUNTERS):
        _REPLAY_COUNTERS.append(counter)


def uncount_replays(counter):
    _REPLAY_COUNTERS[:] = [c for c in _REPLAY_COUNTERS if c is not counter]


def _restore(counter, values):
    counter.clear()
    counter.update(values)


class Graph:
    """One captured call: ``replay()`` reruns it, ``out`` is what it
    returned."""

    def __init__(self, name, graph, out, added=()):
        self.name, self._graph, self.out = name, graph, out
        self._added = added

    def replay(self):
        self._graph.replay()
        for counter, delta in self._added:
            for k, d in delta.items():
                counter[k] = counter.get(k, 0) + d
        _count(self.name, "replays")


def _record(fn, generators, pool, mark):
    """``fn()`` warmed up on a side stream, ``mark()``, then one call of
    it recorded on that stream: (the CUDA graph, what the call returned).
    Other threads may use the card meanwhile (the loaders' copies run on a
    prefetch thread), so only this thread's calls are checked during the
    capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(WARMUP_CALLS):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    # the warm-up's cached blocks go back to the card before the graph's
    # pool grows: a full-width step holds tens of GiB of them
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    mark()
    with torch.cuda.graph(graph, pool=pool, stream=side,
                          capture_error_mode="thread_local"):
        out = fn()
    return graph, out


def capture(name, fn, generators=(), pool=None, warmed=None):
    """``fn()`` warmed up and captured (see the module docstring);
    ``warmed()``, when given, is called between the warm-up and the
    capture."""
    with span("graphs.capture"):
        return _capture(name, fn, generators, pool, warmed)


def _capture(name, fn, generators, pool, warmed):
    counters = list(_REPLAY_COUNTERS)
    before = [dict(c) for c in counters]
    at_capture = []

    def mark():
        at_capture.extend(dict(c) for c in counters)
        if warmed is not None:
            warmed()

    graph, out = _record(fn, generators, pool, mark)
    added = []
    for counter, start, old in zip(counters, at_capture, before):
        delta = {k: v - start.get(k, 0) for k, v in counter.items()
                 if v != start.get(k, 0)}
        if delta:
            added.append((counter, delta))
        _restore(counter, old)
    _count(name, "captures")
    return Graph(name, graph, out, tuple(added))


def _signature(batch, resident):
    return tuple(
        (k, tuple(v.shape), v.dtype, v.stride(),
         v.data_ptr() if k in resident else None)
        for k, v in sorted(batch.items()))


class Step:
    """``fn(batch) -> tuple of tensors``, captured once per signature of
    ``batch`` and replayed (module docstring).

    state: a callable returning the tensors a call of ``fn`` moves; the
    warm-up's moves are copied back into them after the capture, and a
    tensor the warm-up created (torch's optimizers create their state, as
    zeros, at the first step) is zeroed. generators: drawn from by ``fn``,
    registered with each graph, their states put back after the capture.
    resident: batch keys passed through uncopied. pool: the memory pool the
    graphs share (``torch.cuda.graph_pool_handle()``), or None for one of
    their own. exclusive: keep only the latest signature's graph (a train
    step whose gradients the backward allocates: they land in the graph's
    pool, which the next capture frees and reuses). grads: a callable
    returning the parameters a train step trains, for train graphs of
    several signatures alive at once; ``fn`` zeroes their gradients in
    place (``zero_grad(set_to_none=False)``) so that the backward adds
    into them. The first capture's warm-up allocates them, outside every
    pool, for the parameters that receive one, and the Step holds them for
    as long as its graphs live: every graph reads and writes the same
    tensors. A parameter the loss never reaches keeps no gradient, so an
    optimizer that skips grad-None parameters never steps it. A capture
    that would move a held gradient raises."""

    def __init__(self, name, fn, *, state=tuple, generators=(),
                 resident=(), pool=None, exclusive=False, grads=None):
        self.name, self.fn = name, fn
        self.state, self.generators = state, tuple(generators)
        self.resident, self.pool = frozenset(resident), pool
        self.exclusive, self.grads = exclusive, grads
        self._graphs, self._held = {}, None

    def __len__(self):
        return len(self._graphs)

    def has(self, batch):
        """Whether ``batch``'s signature has its graph already."""
        return _signature(batch, self.resident) in self._graphs

    def __call__(self, batch):
        key = _signature(batch, self.resident)
        entry = self._graphs.get(key)
        if entry is None:
            if self.exclusive:
                self._graphs.clear()
            entry = self._graphs[key] = self._capture(batch)
        static, graph = entry
        with torch.no_grad():
            for k, buf in static.items():
                buf.copy_(batch[k])
        graph.replay()
        return tuple(t.clone() for t in graph.out)

    def _capture(self, batch):
        static = {k: torch.empty_like(v) for k, v in batch.items()
                  if k not in self.resident}
        bound = {k: static.get(k, v) for k, v in batch.items()}
        with torch.no_grad():
            for k, buf in static.items():
                buf.copy_(batch[k])
            saved = [(t, t.clone()) for t in self.state()]
        gen_states = [g.get_state() for g in self.generators]
        if self._held is not None:
            # an eager step in between may have dropped them
            for p, g in self._held.items():
                p.grad = g
        fn = self.fn
        graph = capture(self.name, lambda: tuple(fn(bound)),
                        self.generators, self.pool,
                        None if self.grads is None else self._hold_grads)
        if self.grads is not None:
            moved = [p for p in self.grads()
                     if p.grad is not self._held.get(p)]
            if moved:
                raise RuntimeError(
                    f"{self.name}: the capture moved or made the gradients "
                    f"of {len(moved)} parameters; a graph of this step "
                    "must zero its gradients in place")
        with torch.no_grad():
            kept = {id(t) for t, _ in saved}
            for t, v in saved:
                t.copy_(v)
            for t in self.state():
                if id(t) not in kept:
                    t.zero_()
        for g, s in zip(self.generators, gen_states):
            g.set_state(s)
        return static, graph

    def _hold_grads(self):
        """After the first warm-up: the gradients it allocated are the
        ones every graph of this Step reads and writes."""
        if self._held is None:
            self._held = {p: p.grad for p in self.grads()
                          if p.grad is not None}
