"""Driver of the found-architecture training cells: phase 2 of the found
CLIs (the whole net, a fresh Adam, the per-batch cosine schedule), whole
epochs of ``ClassifierEngine.train_track_acc``, each with its dev pass.

One ``train_track_acc`` call holds the whole run, since a new call would
build a new optimizer and capture its step again. Its first
``warmup_epochs`` epochs are set-up: they capture the train and dev steps,
and their first three steps are the ones the reference follows. The
window opens when the next train epoch starts and closes at the start of
the first train epoch that would begin once ``--seconds`` have passed; the
benchmark's wrapper of the train loader raises ``WindowClosed`` there,
which ends the call.

Traffic keys: ``driver``, ``precision`` ("float32" | "bfloat16"),
``warmup_epochs``, ``store_clips`` (clips per split of a store the
benchmark makes at a cut scale).
"""

from __future__ import annotations

import gc
import math
import shutil
import statistics
import sys
import tempfile
import time
import types

import torch

from perfbench import correctness, counts, peaks
from perfbench.harness import (TRACE_SECONDS, device_info, peaks_info,
                               reference_module, sync)
from perfbench.tracing import DeviceTrace
from perfbench.weights import make_weights



class WindowClosed(Exception):
    """Raised by the train loader's wrapper when the window ends."""


class Window:
    """The measured window over whole epochs, and the loader's host time
    per batch inside it."""

    def __init__(self, seconds, warmup_epochs):
        self.seconds, self.warmup = seconds, warmup_epochs
        self.epoch = -1
        self.t0 = self.t1 = None
        self.epochs = 0
        self.batch_ms = []

    @property
    def open(self):
        return self.t0 is not None and self.t1 is None

    def train_epoch_starts(self):
        self.epoch += 1
        if self.epoch < self.warmup:
            return
        now = time.perf_counter()
        if self.t0 is None:
            self.t0 = now
            return
        self.epochs += 1
        if now - self.t0 >= self.seconds:
            self.t1 = now
            raise WindowClosed()


class TimedLoader:
    """The program's loader with its batches timed (host ms per batch the
    loader yields, on the prefetch thread); the train loader's also marks
    the window's epochs."""

    def __init__(self, loader, window, train):
        self.loader, self.window, self.train = loader, window, train

    @property
    def dataset_size(self):
        return self.loader.dataset_size

    def __iter__(self):
        if self.train:
            self.window.train_epoch_starts()
        it = iter(self.loader)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            if self.window.open:
                self.window.batch_ms.append(
                    1e3 * (time.perf_counter() - t0))
            yield batch


class Recorder:
    """Wraps ``engine.train_step``: the losses of the first steps, the
    first gradient as Adam holds it (its first moment over 1 - beta1),
    each leaf's change in each of the first steps (``<leaf>@<step>``) and
    the parameters before every step after the first, on the host (the
    reference starts those steps from them); calls ``on_window_step``
    before every step (which starts the trace)."""

    def __init__(self, engine, steps, on_window_step):
        self.engine, self.steps = engine, steps
        self.k = 0
        self.losses = []
        self.grad_norms = None
        self.change_norms = {}
        self.states = []
        self._prev = None
        self._on_window_step = on_window_step
        self._orig = engine.train_step
        engine.train_step = self._train_step

    def _params(self):
        return dict(self.engine.model.named_parameters())

    def _train_step(self, batch, optimizer, eta):
        checked = self.k < self.steps
        if checked:
            params = self._params()
            if self.k:
                self.states.append({n: p.detach().to("cpu", copy=True)
                                    for n, p in params.items()})
            self._prev = {n: p.detach().clone() for n, p in params.items()}
        self._on_window_step()
        out = self._orig(batch, optimizer, eta)
        if checked:
            self.losses.append(out[0].detach().clone())
            if self.k == 0:
                b1 = optimizer.defaults["betas"][0]
                self.grad_norms = {
                    n: (optimizer.state[p]["exp_avg"].double().norm()
                        / (1 - b1)
                        if p in optimizer.state and optimizer.state[p]
                        else torch.zeros((), dtype=torch.float64,
                                         device=p.device))
                    for n, p in self._params().items()}
            for n, p in self._params().items():
                self.change_norms[f"{n}@{self.k + 1}"] = (
                    p.detach().double() - self._prev[n].double()).norm()
            self._prev = None
        self.k += 1
        return out

    def readings(self):
        return {"losses": [float(x) for x in self.losses],
                "grad": {n: float(v) for n, v in self.grad_norms.items()},
                "change": {n: float(v)
                           for n, v in self.change_norms.items()},
                "states": self.states}


def program_steps(cell, seed, device, workdir, seconds, trace=None,
                  steps=correctness.CHECK_STEPS, window=True):
    """Set up the program, run its call, and return what the run saw: the
    recorder's readings, the window and the counts for the metrics. With
    ``window=False`` the call stops after the checked steps."""
    cfg, traffic = cell.cfg, cell.traffic
    marks = [("start", time.perf_counter())]
    adapter = cell.module("adapters", cfg["adapter"])
    ref = reference_module(cfg["reference"])
    data = adapter.make_data(cfg, traffic, seed, device, workdir)
    sync(device)
    marks.append(("data", time.perf_counter()))
    weights = make_weights(ref.param_specs(cfg), seed, device)
    prog = adapter.build(cfg, traffic, data, weights, device)
    del weights
    sync(device)
    marks.append(("program built", time.perf_counter()))
    win = Window(seconds if window else math.inf,
                 int(traffic["warmup_epochs"]))

    tracing = [False]

    def on_window_step():
        if (trace is not None and win.open and not tracing[0]
                and time.perf_counter() - win.t0
                >= win.seconds - TRACE_SECONDS):
            tracing[0] = True
            trace.start()

    rec = Recorder(prog.engine, steps, on_window_step)
    if not window:
        stop_after = steps

        def stop_step(batch, optimizer, eta, _inner=rec._train_step):
            out = _inner(batch, optimizer, eta)
            if rec.k >= stop_after:
                raise WindowClosed()
            return out

        prog.engine.train_step = stop_step
    loaders = {"train": TimedLoader(prog.loaders["train"], win, True),
               "dev": TimedLoader(prog.loaders["dev"], win, False)}
    sizes = {k: v.dataset_size for k, v in loaders.items()}
    ctx = context(cell, seed)
    if ctx["n_train"] != sizes["train"]:
        raise ValueError(f"the program's train split holds {sizes['train']}"
                         f" rows, the cell's files {ctx['n_train']}")
    scheduler = prog.scheduler(sizes["train"])
    dropout_seed = ctx["dropout_seed"]
    try:
        prog.engine.train_track_acc(
            None, loaders, sizes, scheduler, num_epochs=10 ** 9,
            print_loss=False, seed=dropout_seed)
    except WindowClosed:
        pass
    sync(device)
    if trace is not None and tracing[0]:
        trace.stop()
    if win.t0 is not None:
        marks.append(("warm-up epochs", win.t0))
    print("perfbench: set-up " + ", ".join(
        f"{name} {t - marks[i][1]:.2f} s"
        for i, (name, t) in enumerate(marks[1:])), file=sys.stderr)
    cuda = device.type == "cuda"
    run = types.SimpleNamespace(
        readings=rec.readings(), window=win, sizes=sizes, ctx=ctx,
        batch=int(prog.args.batchsize),
        peak_reserved=torch.cuda.max_memory_reserved(device) if cuda else 0)
    # the program's state goes before the reference runs
    prog.engine.release_graphs()
    prog.close()
    del prog, loaders, rec, data
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return run


def context(cell, seed):
    """What the reference needs of a run besides the seed."""
    return correctness.training_context(cell, seed)


def checked_steps(cell, seed, device):
    """The program through the checked steps alone (no window): its
    readings and ``ctx``."""
    workdir = tempfile.mkdtemp(prefix="perfbench-check-")
    try:
        return program_steps(cell, seed, device, workdir, 0.0, window=False)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def reference_readings(cell, seed, device, ctx, **kw):
    """The frozen reference's readings (perfbench/correctness.py)."""
    return correctness.reference_readings(cell, seed, device, ctx, **kw)


def run(cell, seed, seconds, trace, t_start, device=None):
    """One run of the cell -> the outcome the harness prints. ``device``:
    the first CUDA device unless given (the tests pass the CPU)."""
    device = torch.device(device or "cuda:0")
    # the configurations state float32: no TF32 in convolutions or
    # products (torch leaves it on for cuDNN by default; bfloat16 autocast
    # runs on the tensor cores regardless)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_driver = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    print(f"perfbench: set-up process to driver {t_driver - t_start:.2f} s, "
          f"device init {time.perf_counter() - t_driver:.2f} s",
          file=sys.stderr)
    workdir = tempfile.mkdtemp(prefix="perfbench-")
    dt = DeviceTrace(device) if trace else None
    try:
        r = program_steps(cell, seed, device, workdir, seconds, trace=dt)
        ref = reference_readings(cell, seed, device, r.ctx,
                                 follow=r.readings)
        checks, correct = correctness.judge(
            cell, *correctness.gaps(r.readings, ref))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return outcome(cell, r, checks, correct, dt, t_start, device)


def outcome(cell, r, checks, correct, dt, t_start, device):
    cfg, traffic = cell.cfg, cell.traffic
    win = r.window
    window_s = win.t1 - win.t0
    train_samples = win.epochs * r.sizes["train"]
    dev_samples = win.epochs * r.sizes["dev"]
    steps = win.epochs * (-(-r.sizes["train"] // r.batch)
                          + -(-r.sizes["dev"] // r.batch))
    ref = reference_module(cfg["reference"])
    fwd = counts.forward_flops(ref, cfg, cfg["input_shapes"]) / r.batch
    precision = traffic["precision"]
    end_to_end = {
        "train_samples_per_s": train_samples / window_s,
        "peak_mem_gib": r.peak_reserved / 2 ** 30,
        "setup_s": win.t0 - t_start,
    }
    layer = {
        "window_s": window_s,
        "model_flops": fwd * (counts.TRAIN_STEP_FORWARDS * train_samples
                              + dev_samples),
        "peak_flops": peaks.FLOPS[precision],
        "loader_ms": (statistics.fmean(win.batch_ms) if win.batch_ms
                      else None),
        "k2_bytes": (counts.k2_bytes(
            r.batch, int(cfg["vid_len"][0]), int(cfg["vid_dim"]),
            int(cfg["vid_dim"]), 2 if precision == "bfloat16" else 4)
            if cfg.get("input_kernel") == "K2" else None),
    }
    return types.SimpleNamespace(
        correct=bool(correct), attempted=steps, failed=0,
        end_to_end=end_to_end, layer=layer,
        trace=dt.summary if dt is not None else None,
        checks=checks, device=device_info(device, r.peak_reserved),
        peaks=peaks_info())
