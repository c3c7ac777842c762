"""Driver of the search cells: whole EPNAS searches re-entered on one
``NTUSearcher`` built at set-up (the searcher, its loaders, extractor,
population trainer and surrogate live through the run), each search's
sampler streams seeded from ``--seed``.

Set-up builds the searcher and runs one whole search: every population
shape's graphs and every surrogate fit and predict shape that search draws
(the fit's groups grow with the search's steps) are captured there, and
the first three train steps of its first population (the first step's 32
one-row confs) are the ones the reference follows. The window then runs
whole searches at the configuration's iterations, starting a new one while
less than ``--seconds`` have passed, and ends when the last one does; a
run prints the graph captures its window made (a shape the warm-up search
did not draw).

``correct``: the first population's first gradient as Adam holds it (its
functional Adam's first moment over 1 - beta1) and each candidate's change
over the three steps, against the reference: K1's normalization and both
backbones in train mode (``reference/<config>.py::features``) on the
batches the upstream loader rule gives, each candidate's head
(``reference/_plain.py::population_init``, ``candidate_logits``) and a plain
Adam, with the program's dropout stream (the trainer's generator seeded
``seed + 1``: five skeleton masks, then one (P, B, hidden) mask per row of
the population). The population step keeps no loss, so the numbers are
``head_grad_gap``, ``grad_gap_med`` and ``change_gap_med``
(perfbench/correctness.py::gaps). The dev evaluation, the surrogate's fit
and predictions and the sampler are not compared.

Traffic keys: ``driver``, ``precision``, ``store_clips``,
``one_clip_per_class``.
"""

from __future__ import annotations

import gc
import random
import shutil
import sys
import tempfile
import time
import types

import numpy as np
import torch

from perfbench import correctness, counts, peaks
from perfbench.harness import (TRACE_SECONDS, device_info, peaks_info,
                               reference_module, sync)
from perfbench.reference import _plain as P
from perfbench.tracing import DeviceTrace
from perfbench.weights import make_weights, sub_seed

CHECK_STEPS = correctness.CHECK_STEPS
SECTIONS = ("sampler", "surrogate", "population steps", "features")


class StopSearch(Exception):
    """Raised once the checked steps are read, when no window follows."""


class PopulationRecorder:
    """Wraps the population trainer's streamed steps (the module-level
    ``streamed_steps`` that ``train_population`` calls): the first
    population's first gradient of each candidate's leaves as its Adam
    holds it, and their change over the first steps."""

    def __init__(self, population, steps, stop=False):
        self.population, self.steps, self.stop = population, steps, stop
        self.k = 0
        self.grad = self.change = None
        self._p0 = None
        self._wrapped = []
        self._orig_fn = population.streamed_steps
        population.streamed_steps = self._streamed_steps

    def close(self):
        """Put the module's function and every wrapped step back (the
        steps are cached process-wide, shared by later searchers)."""
        self.population.streamed_steps = self._orig_fn
        for prog in self._wrapped:
            del prog.train_batch
        self._wrapped = []

    def _streamed_steps(self, *args, **kw):
        prog = self._orig_fn(*args, **kw)
        if self.k < self.steps and "train_batch" not in vars(prog):
            orig = prog.train_batch

            def train_batch(*a, **k):
                self._step(prog, orig, *a, **k)

            prog.train_batch = train_batch
            self._wrapped.append(prog)
        return prog

    def _norms(self, tensors):
        return {f"{p}.{key}": float(t[p].double().norm())
                for key, t in tensors.items() for p in range(t.shape[0])}

    def _step(self, prog, orig, *args, **kw):
        if self.k >= self.steps:
            return orig(*args, **kw)
        st = prog.st
        if self.k == 0:
            self._p0 = {k: v.detach().clone() for k, v in st["params"].items()}
        orig(*args, **kw)
        if self.k == 0:
            m = dict(zip(st["params"], st["adam"]["m"]))
            self.grad = self._norms({k: v / (1 - P.BETAS[0])
                                     for k, v in m.items()})
        self.k += 1
        if self.k == self.steps:
            self.change = self._norms({k: v.detach() - self._p0[k]
                                       for k, v in st["params"].items()})
            self._p0 = None
            if self.stop:
                raise StopSearch()

    def readings(self):
        return {"grad": self.grad, "change": self.change}


def _seed_sampler(seed, i):
    s = sub_seed(seed, f"sampler{i}") % 2 ** 32
    np.random.seed(s)
    random.seed(s)


def _captures(graphs):
    return {k: c["captures"] for k, c in graphs.GRAPH_COUNTS.items()}


def program_run(cell, seed, device, workdir, seconds, trace=None,
                window=True):
    """Set up the searcher, run the warm-up search and the window; return
    what the run saw. With ``window=False`` it stops after the checked
    steps of the warm-up search's first population."""
    from mfas_tpu_torch.runtime import graphs
    from mfas_tpu_torch.runtime.profiler import SectionTimer
    from mfas_tpu_torch.search import population

    cfg, traffic = cell.cfg, cell.traffic
    marks = [("start", time.perf_counter())]
    adapter = cell.module("adapters", cfg["search"]["adapter"])
    ref = reference_module(cfg["reference"])
    data = adapter.make_data(cfg, traffic, seed, device, workdir)
    sync(device)
    marks.append(("data", time.perf_counter()))
    weights = make_weights(ref.backbone_specs(cfg), seed, device)
    timer = SectionTimer(device)
    prog = adapter.build(cfg, traffic, data, weights, device, timer)
    del weights
    searcher = prog.searcher
    sync(device)
    marks.append(("program built", time.perf_counter()))
    rec = PopulationRecorder(population, CHECK_STEPS, stop=not window)
    try:
        _seed_sampler(seed, 0)
        try:
            searcher.search()
        except StopSearch:
            pass
        sync(device)
        marks.append(("warm-up search", time.perf_counter()))
        captures0 = _captures(graphs)
        t0 = t1 = time.perf_counter()
        searches = 0
        cands0 = searcher.train_fn.candidates_trained
        sec0 = dict(timer.seconds)
        tracing = False
        while window:
            # trace from the second search on, or the window's last
            # TRACE_SECONDS: the post-processing grows with the events
            if (trace is not None and not tracing
                    and (searches >= 1 or time.perf_counter() - t0
                         >= seconds - TRACE_SECONDS)):
                tracing = True
                trace.start()
            _seed_sampler(seed, searches + 1)
            searcher.search()
            searches += 1
            t1 = time.perf_counter()
            if t1 - t0 >= seconds:
                break
        sync(device)
        if tracing:
            trace.stop()
        if window:
            made = {k: n - captures0.get(k, 0)
                    for k, n in _captures(graphs).items()
                    if n > captures0.get(k, 0)}
            print(f"perfbench: graph captures in the window "
                  f"{sum(made.values())} {made}", file=sys.stderr)
    finally:
        rec.close()
    print("perfbench: set-up " + ", ".join(
        f"{name} {t - marks[i][1]:.2f} s"
        for i, (name, t) in enumerate(marks[1:])), file=sys.stderr)
    cuda = device.type == "cuda"
    run = types.SimpleNamespace(
        readings=rec.readings(), t0=t0, t1=t1, searches=searches,
        candidates=searcher.train_fn.candidates_trained - cands0,
        sections={k: timer.seconds.get(k, 0.0) - sec0.get(k, 0.0)
                  for k in SECTIONS},
        peak_reserved=torch.cuda.max_memory_reserved(device) if cuda else 0)
    del prog, searcher, rec, data, timer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return run


def first_population(sizes_a, sizes_b):
    """The first search step's population and its seed: every one-row
    conf [a tap, b tap, activation (ReLU, sigmoid)] in lexicographic order
    (the upstream search space), seeded 1 (the port's population counter
    starts at 0 and counts up before each population)."""
    confs = [[[a, b, n]] for a in range(len(sizes_a))
             for b in range(len(sizes_b)) for n in range(2)]
    return confs, 1


def reference_readings(cell, seed, device, ctx=None, follow=None,
                       precision="float32", fault=None, steps=CHECK_STEPS):
    """The reference's first gradients and changes of the first
    population's candidates (see the module docstring). It runs free:
    ``ctx`` and ``follow`` are taken for the training driver's signature
    and not read (the heads' three steps agree to round-off, PERF.md)."""
    cfg, traffic = cell.cfg, cell.traffic
    ref = reference_module(cfg["reference"])
    adapter = cell.module("adapters", cfg["search"]["adapter"])
    sc = adapter.search_cfg(cfg)
    raw = adapter.make_raw(cfg, traffic, seed, device)
    backbones = make_weights(ref.backbone_specs(cfg), seed, device)
    sizes_a, sizes_b = ref.tap_sizes(cfg)
    confs, pop_seed = first_population(sizes_a, sizes_b)
    H, rows = int(sc["inner_representation_size"]), int(sc["max_fusions"])
    heads = P.population_init(confs, sizes_a, sizes_b, H,
                              int(sc["num_outputs"]), pop_seed, device)
    keys = ("W", "b", "cls_w", "cls_b")

    def leaves(p):
        h = heads[p]
        return {"W": h["W"], "b": h["b"], "cls_w": [h["cls_w"]],
                "cls_b": [h["cls_b"]]}

    for h in heads:
        for v in h.values():
            for t in (v if isinstance(v, list) else [v]):
                t.requires_grad_(True)
    init = [{k: [t.detach().clone() for t in v]
             for k, v in leaves(p).items()} for p in range(len(heads))]
    n_train = len(raw["trainexp"]["labels"])
    etas = P.cosine_etas(float(sc["eta_max"]), float(sc["eta_min"]),
                         float(sc["Ti"]), n_train / int(sc["batchsize"]),
                         steps)
    masks = P.MaskStream(torch.Generator(device=device)
                         .manual_seed(pop_seed + 1))
    drpt = float(sc["drpt"])
    batches = ref.train_batches(raw, sc, steps, split="trainexp")
    flat = [(p, k, i, t) for p in range(len(heads))
            for k, v in leaves(p).items() for i, t in enumerate(v)]
    state = {(p, k, i): (torch.zeros_like(t), torch.zeros_like(t))
             for p, k, i, t in flat}
    grad = {}
    with P.Precision(precision) as prec:
        for s, batch in enumerate(batches):
            inputs, label, mask = ref.inputs(raw, batch, device)
            if fault == "label":
                label = label.clone()
                label[0] = (label[0] + 1) % int(sc["num_outputs"])
            elif fault == "half":
                mask = mask.clone()
                mask[len(mask) // 2:] = 0.0
            elif fault is not None:
                raise ValueError(f"unknown fault {fault!r}")
            with torch.no_grad():
                taps_s, taps_v, _, _ = ref.features(backbones, inputs, sc,
                                                    masks, prec)
            B = taps_s[0].shape[0]
            keeps = [masks.keep((len(heads), B, H), drpt, device)
                     for _ in range(rows)]
            loss = sum(P.masked_ce(P.candidate_logits(
                heads[p], confs[p], taps_s, taps_v, keeps, p, drpt, prec),
                label, mask) for p in range(len(heads)))
            grads = torch.autograd.grad(loss, [t for *_, t in flat])
            with torch.no_grad():
                for (p, k, i, t), g in zip(flat, grads):
                    g = g + P.WEIGHT_DECAY * t
                    if s == 0:
                        grad.setdefault((p, k), []).append(g)
                    m, v = state[(p, k, i)]
                    P.adam_step(t, g, m, v, s + 1, etas[s])
    out = {"grad": {}, "change": {}}
    for p in range(len(heads)):
        for k in keys:
            out["grad"][f"{p}.{k}"] = float(torch.sqrt(sum(
                g.double().square().sum() for g in grad[(p, k)])))
            out["change"][f"{p}.{k}"] = float(torch.sqrt(sum(
                (t.detach().double() - t0.double()).square().sum()
                for t, t0 in zip(leaves(p)[k], init[p][k]))))
    out["heads"] = [n for n in out["grad"] if ".cls_" in n]
    return out


def context(cell, seed):
    """The reference needs nothing of a run besides the seed."""
    return None


def checked_steps(cell, seed, device):
    """The program through the checked steps alone (no window)."""
    workdir = tempfile.mkdtemp(prefix="perfbench-check-")
    try:
        run = program_run(cell, seed, device, workdir, 0.0, window=False)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    run.ctx = None
    return run


def run(cell, seed, seconds, trace, t_start, device=None):
    """One run of the cell -> the outcome the harness prints."""
    device = torch.device(device or "cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    workdir = tempfile.mkdtemp(prefix="perfbench-")
    dt = DeviceTrace(device) if trace else None
    try:
        r = program_run(cell, seed, device, workdir, seconds, trace=dt)
        checks, correct = correctness.judge(
            cell, *correctness.gaps(r.readings,
                                    reference_readings(cell, seed, device)))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return outcome(cell, r, checks, correct, dt, t_start, device)


def outcome(cell, r, checks, correct, dt, t_start, device):
    cfg = cell.cfg
    adapter = cell.module("adapters", cfg["search"]["adapter"])
    sc = adapter.search_cfg(cfg)
    ref = reference_module(cfg["reference"])
    window_s = r.t1 - r.t0
    B = int(sc["batchsize"])
    n_train = int(cell.traffic["store_clips"]["trainexp"])
    # train-mode feature batches a search needs: every population trains
    # --epochs epochs over the train split; the dev features are cached
    batches = (int(sc["search_iterations"]) * int(sc["max_fusions"])
               * int(sc["epochs"]) * -(-n_train // B))
    shapes = [[B] + list(s[1:]) for s in cfg["input_shapes"]]
    fwd = counts.forward_flops(ref, sc, shapes, fn="features")
    frames, side = int(sc["vid_len"][0]), int(sc["vid_dim"])
    layer = {"window_s": window_s, "sections": r.sections,
             "model_flops": r.searches * batches * fwd,
             "peak_flops": peaks.FLOPS["float32"],
             "k1_bytes": counts.k1_bytes(B, frames, side, side, 4)}
    return types.SimpleNamespace(
        correct=bool(correct), attempted=r.candidates, failed=0,
        end_to_end={"search_cands_per_h": r.candidates * 3600.0 / window_s,
                    "peak_mem_gib": r.peak_reserved / 2 ** 30,
                    "setup_s": r.t0 - t_start},
        layer=layer, trace=dt.summary if dt is not None else None,
        checks=checks, device=device_info(device, r.peak_reserved),
        peaks=peaks_info())
