#!/usr/bin/env python3
"""Benchmark harness of the port (port of bench.py; the same sections,
record keys, env switches and output contract).

    python3 -m mfas_tpu_torch.bench                    # lean profile
    MFAS_BENCH_FULL=1 python3 -m mfas_tpu_torch.bench  # re-measure everything

Headline metric: MFAS search speedup against the reference's sequential
candidate loop at the NTU vertical's shapes (B=16, 256 px clips, the
inflated ResNet-50 + HCN backbones, a K=15 population). Two views:

1. **Per-step proxy** (``bench_proxy``): sequential unit = one train-mode
   backbone feature pass + one single-candidate head train step;
   population unit = the same feature pass + one K-candidate head step;
   speedup = K * t_sequential / t_population. The sequential side is
   charged no model build or checkpoint reload. The section also times the
   found net's train step and inference in f32 and bf16, counts the train
   step's FLOPs (``torch.utils.flop_counter.FlopCounterMode``: forward and
   backward, no optimizer FLOPs) and, under MFAS_BENCH_FULL=1, sweeps the
   bf16 step over B = 16/32/48/64.
2. **End-to-end search wall-clock** (``bench_search_wallclock``): a real
   tiny EPNAS search (``NTUSearcher`` on a synthetic packed store, MapLoader
   threads, kernel K1 normalizing the uint8 clips, surrogate fits,
   sampling), timed in population mode in pairs with one warm sequential
   candidate; the headline is the median of the per-pair ratios. The
   measured ``--sequential_candidates`` search, the amortization trend and
   the 197-candidate full-scale search run under MFAS_BENCH_FULL=1.

``bench_e2e_input`` feeds the found net from the packed store (K1) and from
the card-resident store (K2, the prep of ``main_found_ntu --hbm_resident``),
and ``bench_host_input`` times the native host gather + normalize.

Output contract: after every section one compact JSON record line is
printed (the last printed line is the record) and the full detail dict is
written atomically to the sidecar, ``--detail_file`` (default
``mfas_tpu_torch/bench_detail.cuda.json`` on the card,
``bench_detail.cpu.json`` beside it on the CPU); SIGTERM/SIGINT re-print
the latest line and exit 113; a section failure is recorded as
``<section>_error`` and the line still prints. MFAS_BENCH_BUDGET_S (default
2900 s) is a soft budget: optional sections are skipped when it cannot
cover them. The lean profile skips the settled experiments and carries
their keys forward from the previous run's sidecar, only from the default
sidecar and only when it was measured on a card of the same name;
otherwise it records why each was skipped (``<first key>_skipped``).

Timing: steps run through the entries the CLIs call, so on the card they
are CUDA graph replays (the engine's ``train_step``/``eval_step``, the
population trainer's ``streamed_features`` and the streamed population
step), as the JAX bench times the jitted step; the FLOP count alone runs
the eager step. INNER (INNER_HEAD for head steps) chained steps per timed
window, parameters, optimizer and BatchNorm state carried from step to
step; each window ends in a device synchronize; median of 3 after 1
warm-up (the capture, on the card). TF32 is off for matmul and cuDNN. The
input kernels are built before the first section (``kernel_build_s``), and
each section's kernel launches are recorded (``kernel_launches``; a graph
replay adds the launches it holds).

From the command line the bench needs a CUDA device and exits non-zero
without one; ``main(argv, device="cpu")`` runs it on the CPU at a tiny size.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import types

import numpy as np

METRIC = "mfas_search_speedup_vs_sequential_candidates"
INNER = 4        # chained steps per timed window: backbone / whole-net steps
INNER_HEAD = 16  # cheap head steps need a longer chain for stable timing
SIGNAL_EXIT = 113

PROXY_BATCH = 16   # near the reference's batchsize=20
PROXY_IMG = 256    # the reference's NTU clip resolution (vid_dim 256)
PROXY_K = 15       # reference --num_samples
FOUND_CONF = [[3, 1, 1], [1, 3, 0], [1, 1, 1], [3, 3, 0]]
FOUND_ARGS = dict(inner_representation_size=256, drpt=0.4, multitask=True)
# the CPU run's shapes (device="cpu" only): batch, image, chains, clip frames
CPU_SHRINK = dict(batch=2, img=32, inner=1, inner_head=2, vid_len=(2, 32))

# dense bf16 peak TFLOP/s by torch.cuda.get_device_name (MFU denominators;
# the f32 step is reported against the same peak, as a lower bound). H100
# SXM5: 989 TFLOP/s dense bf16, NVIDIA's H100 data sheet. Any other card
# gets no MFU.
_PEAK_TFLOPS = {"NVIDIA H100 80GB HBM3": 989.0}

_COMPACT_KEYS = (
    "device_kind",
    "search_wallclock_speedup", "search_wallclock_cached_speedup",
    "search_wallclock_resident_speedup",
    "search_wallclock_cached_resident_speedup",
    "search_wallclock_measured_speedup",
    "search_wallclock_cached_measured_speedup",
    "search_wallclock_seq_measured_s", "search_wallclock_seq_s",
    "search_wallclock_pop_s", "search_wallclock_pop_cached_s",
    "search_trend_speedup", "search_trend_cached_speedup",
    "search_trend_candidates",
    "search_fullscale_candidates", "search_fullscale_pop_cached_s",
    "search_fullscale_cached_speedup", "search_fullscale_speedup",
    "found_train_clips_per_s", "found_train_bf16_clips_per_s",
    "found_train_bf16_batch_sweep_clips_per_s",
    "found_infer_clips_per_s", "found_infer_bf16_clips_per_s",
    "mfu_estimate_bf16",
    "e2e_train_clips_per_s", "e2e_train_clips_per_s_resident",
    "e2e_train_clips_per_s_resident_bf16",
    "h2d_gbps", "search_speedup_proxy",
)

LEAN = "lean profile (MFAS_BENCH_FULL=0)"


def default_detail_file(on_card):
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(here, "bench_detail.%s.json"
                        % ("cuda" if on_card else "cpu"))


@dataclasses.dataclass
class BenchRun:
    """One bench process: its device, sidecar, budget and profile, the
    previous record it may carry keys from, and its latest printed line."""
    device: object
    detail_file: str
    budget_s: float
    full: bool
    t0: float
    carry_source: dict = dataclasses.field(default_factory=dict)
    latest_line: str | None = None

    @property
    def on_card(self):
        return self.device.type == "cuda"

    def budget_left(self):
        return self.budget_s - (time.perf_counter() - self.t0)

    def sync(self):
        if self.on_card:
            import torch
            torch.cuda.synchronize(self.device)

    def switch(self, name):
        """An env switch that defaults to on in the full profile only."""
        return os.environ.get(name, "1" if self.full else "0")


def _maybe_inject(name):
    """Test hook: MFAS_BENCH_INJECT_ERROR=<section> makes that section
    raise, so 'a section failure still prints a parseable line with an
    errors count' is testable."""
    if os.environ.get("MFAS_BENCH_INJECT_ERROR") == name:
        raise RuntimeError(f"injected failure in {name} (test hook)")


def _load_carry_source(path, is_default, device_kind):
    """The previous run's record, read once before the first emit rewrites
    it; {} unless ``path`` is the default sidecar and it was measured on a
    card named ``device_kind``."""
    if not is_default:
        return {}
    try:
        with open(path) as f:
            prev = json.load(f)
    except (OSError, ValueError):
        return {}
    if prev.get("detail", {}).get("device_kind") != device_kind:
        return {}
    return prev


def _carry_forward(detail, run, keys, reason):
    """A skipped section must not erase the last real measurement: copy its
    keys from the previous record, stamped with the run they came from, or,
    with nothing to carry, record why the section was skipped."""
    prev = run.carry_source
    prev_detail = prev.get("detail", {})
    carried = {k: prev_detail[k] for k in keys if k in prev_detail}
    if not carried:
        detail[keys[0] + "_skipped"] = reason
        return
    detail.update(carried)
    prev_stamp = prev_detail.get(keys[0] + "_carried_from", {})
    detail[keys[0] + "_carried_from"] = {
        "measured_at": (prev_stamp.get("measured_at")
                        or prev.get("measured_at")),
        "skip_reason": reason,
        "note": ("these keys are from the previous bench run (skipped this "
                 "run); ratios among them are intra-THAT-run, not comparable "
                 "to this run's fresh timings")}


# ---------------------------------------------------------------------------
# Record emission: a full record line after every section, reprinted on
# SIGTERM/SIGINT, so a kill at any point leaves a parseable last line.
# ---------------------------------------------------------------------------
def _emit(detail, headline, run, partial_after=None):
    """Write the sidecar atomically and print the one-line JSON record;
    returns the line. ``partial_after`` names the last completed section
    of an intermediate record."""
    errors = sorted(k for k in detail if k.endswith("_error"))
    carried = sorted(k[: -len("_carried_from")] for k in detail
                     if k.endswith("_carried_from"))
    measured_at = time.strftime("%Y-%m-%dT%H:%M:%S%z")
    record = {"metric": METRIC, "value": round(headline, 3), "unit": "x",
              "vs_baseline": round(headline, 3), "measured_at": measured_at,
              "detail": detail}
    if partial_after:
        record["partial_after_section"] = partial_after
    tmp = run.detail_file + ".tmp"
    try:
        with open(tmp, "w") as f:                # atomic: a killed run
            json.dump(record, f, indent=1)       # never leaves torn JSON
        os.replace(tmp, run.detail_file)
    except OSError as e:
        detail["sidecar_write_error"] = repr(e)
        errors = sorted(set(errors) | {"sidecar_write_error"})

    line = {"metric": METRIC, "value": round(headline, 3), "unit": "x",
            "vs_baseline": round(headline, 3), "measured_at": measured_at,
            "detail_file": os.path.basename(run.detail_file),
            "detail": {k: detail[k] for k in _COMPACT_KEYS if k in detail}}
    if errors:
        line["errors"] = len(errors)
        line["error_keys"] = errors
    if carried:
        line["carried"] = carried
    if partial_after:
        line["partial_after_section"] = partial_after
    run.latest_line = json.dumps(line)
    print(run.latest_line, flush=True)
    return run.latest_line


def _install_signal_fallback(run):
    """SIGTERM/SIGINT -> re-print the latest complete record and exit 113
    (best effort: a handler cannot preempt a blocked native call). Only
    the main thread can set handlers; a caller on another thread gets
    none."""

    def handler(signum, frame):  # noqa: ARG001
        if run.latest_line is not None:
            sys.stdout.write("\n" + run.latest_line + "\n")
            sys.stdout.flush()
        os._exit(SIGNAL_EXIT)

    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, handler)


def _ntu_args(**kw):
    d = dict(num_outputs=60, vid_len=(8, 32), drpt=0.5,
             inner_representation_size=16, multitask=False, alphas=False,
             batchnorm=False, num_classes=60)
    d.update(kw)
    return types.SimpleNamespace(**d)


def proxy_confs(K):
    """The K population confs and the one-candidate population."""
    rows = [[a, b, n] for a in range(4) for b in range(4) for n in range(2)]
    confs_K = [np.array([rows[i % 32], rows[(7 * i) % 32]])
               for i in range(K)]
    return confs_K, [confs_K[0]]


def _timeit(fn, run, inner, warmup=1, iters=3):
    """fn() runs ``inner`` chained steps; seconds per step, the median of
    ``iters`` windows after ``warmup``, each ending in a synchronize."""
    for _ in range(warmup):
        fn()
        run.sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        run.sync()
        times.append((time.perf_counter() - t0) / inner)
    return float(np.median(times))


def _release(engine):
    """Free ``engine``'s CUDA graphs and their memory pool (the section's
    engines share one net, and each graphed train step holds a pool the
    size of its activations), and hand the cached blocks back."""
    engine.release_graphs()
    gc.collect()
    if engine.device.type == "cuda":
        import torch
        torch.cuda.empty_cache()


def _peak_tflops(device):
    if device.type != "cuda":
        return None
    import torch
    return _PEAK_TFLOPS.get(torch.cuda.get_device_name(device))


def found_train_step_flops(engine, batch, optimizer):
    """FLOPs of one ``engine._train_step`` (forward and backward; the
    counter sees no optimizer FLOPs). The step runs: the net moves by it."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        engine._train_step(batch, optimizer, 1e-3)
    return int(counter.get_total_flops())


def paired_speedup(pairs, n_trained):
    """Median over (t_pop, t_cand) pairs of n_trained * t_cand / t_pop, and
    the sorted ratios."""
    pair_ratios = sorted(n_trained * tc / tp for tp, tc in pairs)
    n_r = len(pair_ratios)
    speedup = (pair_ratios[n_r // 2] if n_r % 2
               else (pair_ratios[n_r // 2 - 1] + pair_ratios[n_r // 2]) / 2)
    return speedup, pair_ratios


def n_candidates(search_iterations, levels, num_samples):
    """Candidates an EPNAS search trains: all 32 one-row confs at the first
    step, num_samples at each later one."""
    return 32 + (search_iterations * levels - 1) * num_samples


# ---------------------------------------------------------------------------
# Section 1+2: per-step proxy + found-arch throughput
# ---------------------------------------------------------------------------
def bench_proxy(detail, run):
    _maybe_inject("bench_proxy")
    import torch

    from mfas_tpu_torch.core.layers import set_dropout_generator
    from mfas_tpu_torch.engine.classifier import (ClassifierEngine,
                                                  set_trainable, snapshot)
    from mfas_tpu_torch.fusion.ntu import (NTUFeatureExtractor,
                                           Searchable_Skeleton_Image_Net,
                                           tap_sizes)
    from mfas_tpu_torch.search.population import (PopulationSpec,
                                                  PopulationTrainer,
                                                  conf_tensors,
                                                  init_population,
                                                  streamed_steps)

    device = run.device
    B, IMG, K = PROXY_BATCH, PROXY_IMG, PROXY_K
    inner, inner_head = INNER, INNER_HEAD
    if run.on_card:
        args = _ntu_args()
    else:
        # without a card the 256 px ResNet-50 steps would take minutes each
        B, IMG = CPU_SHRINK["batch"], CPU_SHRINK["img"]
        inner, inner_head = CPU_SHRINK["inner"], CPU_SHRINK["inner_head"]
        args = _ntu_args(vid_len=CPU_SHRINK["vid_len"])

    rs = np.random.RandomState(0)

    def clips(bs):
        rgb = rs.randn(bs, args.vid_len[0], IMG, IMG, 3).astype(np.float32)
        ske = rs.randn(bs, 3, args.vid_len[1], 25, 2).astype(np.float32)
        label = rs.randint(0, 60, bs).astype(np.int32)
        return {k: torch.as_tensor(v).to(device) for k, v in
                (("rgb", rgb), ("ske", ske), ("label", label),
                 ("_mask", np.ones((bs,), np.float32)))}

    batch = clips(B)
    rgb, ske, label, wmask = (batch[k] for k in ("rgb", "ske", "label",
                                                 "_mask"))

    extractor = NTUFeatureExtractor(
        args, device=device, generator=torch.Generator().manual_seed(0))
    sizes_ske, sizes_ims = tap_sizes(args)
    spec = PopulationSpec(
        sizes_a=tuple(sizes_ske), sizes_b=tuple(sizes_ims),
        hidden=args.inner_representation_size, num_outputs=60, max_rows=4,
        batchnorm=False, drpt=args.drpt, use_alphas=False, multitask=False)
    trainer = PopulationTrainer(spec, extractor, device=device)
    confs_K, conf1 = proxy_confs(K)

    # ---- backbone feature pass, train mode (batch statistics, dropout),
    # the streamed search's entry (a CUDA graph replay on the card)
    def feats_loop(tr):
        def steps():
            for _ in range(inner):
                tr.streamed_features((rgb, ske))
        return steps

    t_backbone = _timeit(feats_loop(trainer), run, inner)

    with_bf16 = os.environ.get("MFAS_BENCH_BF16", "1") != "0"
    t_backbone_bf16 = None
    if with_bf16:
        trainer_bf16 = PopulationTrainer(
            dataclasses.replace(spec, feature_dtype="bfloat16"), extractor,
            device=device)
        t_backbone_bf16 = _timeit(feats_loop(trainer_bf16), run, inner)
        del trainer_bf16

    fa, fb, lb, la = trainer._features((rgb, ske), train=True)
    head_batch = (fa, fb, lb, la, label, wmask)

    # ---- head step, population of 1 (sequential unit) vs K, through the
    # streamed search's per-batch step (a CUDA graph replay on the card):
    # parameters, Adam state and BatchNorm state chain from step to step
    def pop_loop(confs):
        params, bn = init_population(confs, spec, seed=0, device=device)
        conf = conf_tensors(confs, spec, device)
        prog = streamed_steps(spec, params, bn, conf, device=device,
                              graphed=trainer.graphed)
        prog.load(params, bn, conf)

        def steps():
            for _ in range(inner_head):
                prog.train_batch(head_batch[:4], label, wmask, 1e-3,
                                 trainer.generator)
        return steps

    t_head_seq1 = _timeit(pop_loop(conf1), run, inner_head)
    t_head_popK = _timeit(pop_loop(confs_K), run, inner_head)
    del extractor, trainer, fa, fb, lb, la, head_batch

    t_seq_candidate = t_backbone + t_head_seq1
    t_pop = t_backbone + t_head_popK
    speedup = K * t_seq_candidate / t_pop

    # ---- found-arch whole-net train step (clips/s)
    fargs = _ntu_args(**FOUND_ARGS)
    model = Searchable_Skeleton_Image_Net(
        fargs, np.array(FOUND_CONF), device=device,
        generator=torch.Generator().manual_seed(0))
    set_trainable(model, None)
    init_state = snapshot(model)

    def fresh(engine):
        """The initial net, its dropout drawn from ``engine``'s generator;
        -> a fresh Adam."""
        model.load_state_dict(init_state)
        set_dropout_generator(model, engine.generator)
        engine.generator.manual_seed(0)
        return engine.make_optimizer()

    def train_loop(engine, opt, b):
        def steps():
            model.train()
            for _ in range(inner):
                engine.train_step(b, opt, 1e-3)
        return steps

    engine = ClassifierEngine(model, device, multitask=True,
                              input_keys=("rgb", "ske"))
    opt = fresh(engine)
    t_full = _timeit(train_loop(engine, opt, batch), run, inner)
    _release(engine)

    flops_step = None
    try:
        flops_step = found_train_step_flops(engine, batch, opt)
    except Exception as e:  # noqa: BLE001 — recorded, counted as an error
        traceback.print_exc()
        detail["cost_analysis_error"] = repr(e)
    del opt

    t_full_bf16 = None
    if with_bf16:
        engine_bf16 = ClassifierEngine(model, device, multitask=True,
                                       input_keys=("rgb", "ske"),
                                       compute_dtype=torch.bfloat16)
        opt_bf16 = fresh(engine_bf16)
        t_full_bf16 = _timeit(train_loop(engine_bf16, opt_bf16, batch), run,
                              inner)

        # ---- bf16 found-train batch sweep; an out-of-memory batch is data
        sweep_bs = (16, 32, 48, 64) if run.on_card else (2, 4)
        if not run.full:
            sweep_bs = ()
            _carry_forward(detail, run,
                           ["found_train_bf16_batch_sweep_clips_per_s"], LEAN)
        sweep = {}
        for bs in sweep_bs:
            if bs == B:
                sweep[str(bs)] = round(B / t_full_bf16, 2)
                continue
            try:
                t_s = _timeit(train_loop(engine_bf16, opt_bf16, clips(bs)),
                              run, inner)
                sweep[str(bs)] = round(bs / t_s, 2)
            except torch.OutOfMemoryError as e:
                sweep[str(bs)] = f"error: {type(e).__name__}"
            finally:
                _release(engine_bf16)
        if sweep:   # lean profile: keep the carried value
            detail["found_train_bf16_batch_sweep_clips_per_s"] = sweep
        _release(engine_bf16)
        del opt_bf16

    # ---- inference, eval mode
    def infer_loop(engine):
        def steps():
            model.eval()
            for _ in range(inner):
                engine.eval_step(batch)
        return steps

    model.load_state_dict(init_state)
    t_infer = _timeit(infer_loop(engine), run, inner)
    _release(engine)
    t_infer_bf16 = None
    if with_bf16:
        t_infer_bf16 = _timeit(infer_loop(engine_bf16), run, inner)
        _release(engine_bf16)

    peak = _peak_tflops(device)
    detail.update({
        "batch": B, "img": IMG, "K": K,
        "baseline_definition": (
            "sequential unit = 1 backbone fwd + 1 single-candidate head "
            "train step per candidate, with ZERO model-build/checkpoint-"
            "reload cost charged (conservative); population unit = 1 "
            "backbone fwd + 1 batched K-candidate head train step. "
            "found_train_step_tflops: FlopCounterMode over one found-net "
            "train step (forward + backward, no optimizer FLOPs); "
            "mfu_estimate is the f32 step against the dense bf16 peak "
            "(a lower bound), mfu_estimate_bf16 the bf16 step"),
        "t_backbone_s": round(t_backbone, 6),
        "t_head_seq1_s": round(t_head_seq1, 6),
        "t_head_popK_s": round(t_head_popK, 6),
        "search_speedup_proxy": round(speedup, 3),
        "found_train_clips_per_s": round(B / t_full, 2),
        "found_infer_clips_per_s": round(B / t_infer, 2),
    })
    if t_infer_bf16 is not None:
        detail["found_infer_bf16_clips_per_s"] = round(B / t_infer_bf16, 2)
    if flops_step is not None:
        achieved = flops_step / t_full / 1e12
        detail["found_train_step_tflops"] = round(flops_step / 1e12, 4)
        detail["found_train_achieved_tflops_per_s"] = round(achieved, 3)
        if peak:
            detail["assumed_peak_bf16_tflops"] = peak
            detail["mfu_estimate"] = round(achieved / peak, 5)
    if t_backbone_bf16 is not None:
        detail["t_backbone_bf16_s"] = round(t_backbone_bf16, 6)
        detail["search_speedup_bf16_features"] = round(
            K * (t_backbone_bf16 + t_head_seq1)
            / (t_backbone_bf16 + t_head_popK), 3)
    if t_full_bf16 is not None:
        detail["found_train_bf16_clips_per_s"] = round(B / t_full_bf16, 2)
        if flops_step is not None and peak:
            detail["mfu_estimate_bf16"] = round(
                flops_step / t_full_bf16 / 1e12 / peak, 5)
    return speedup


# ---------------------------------------------------------------------------
# Section 3: end-to-end search wall-clock (real tiny EPNAS on packed data)
# ---------------------------------------------------------------------------
def _search_args(packed_dir, ckpt_dir, batch, **overrides):
    """Search-CLI args against a packed store (whose files fix the input
    resolution)."""
    from mfas_tpu_torch import main_searchable_ntu as ms

    args = ms.parse_args([
        "--datadir", "", "--checkpointdir", ckpt_dir,
        "--packed_datadir", packed_dir,
        "--batchsize", str(batch), "--epochs", "1",
        "--search_iterations", "1", "--max_fusions", "2",
        "--num_samples", "4", "--epochs_surrogate", "10",
        "--random_backbones", "--no-verbose",
        "--device_input_normalize", "--seed", "0",
        # the default 16 loader threads thrash small hosts
        "--num_workers", "2",
        # few classes so 1-epoch candidates have nonzero dev accuracy: the
        # sampler draws with p ~ acc^(1/T) and fails on all-zero accuracies
        "--num_outputs", "4",
    ])
    for k, v in overrides.items():
        setattr(args, k, v)
    return args


def bench_search_wallclock(detail, run, tmp_root):
    _maybe_inject("bench_search_wallclock")
    import torch

    from mfas_tpu_torch.core.sched import LRCosineAnnealingScheduler
    from mfas_tpu_torch.data.ntu_pack import make_synthetic_packed_ntu
    from mfas_tpu_torch.engine.classifier import ClassifierEngine, snapshot
    from mfas_tpu_torch.fusion.ntu import Searchable_Skeleton_Image_Net
    from mfas_tpu_torch.search.searchers import NTUSearcher

    on_card = run.on_card
    img, batch = (256, 16) if on_card else (32, 4)
    n_train, n_dev = (128, 64) if on_card else (8, 4)
    epochs = 2 if on_card else 1
    packed = os.path.join(tmp_root, "packed")
    make_synthetic_packed_ntu(os.path.join(packed, "trainexp"), n=n_train,
                              frames=8, h=img, w=img, num_classes=4)
    make_synthetic_packed_ntu(os.path.join(packed, "dev"), n=n_dev,
                              frames=8, h=img, w=img, num_classes=4)

    def run_search(searcher=None, **overrides):
        if searcher is None:
            overrides.setdefault("epochs", epochs)
            args = _search_args(packed, tmp_root, batch, **overrides)
            searcher = NTUSearcher(args, device=run.device)
        np.random.seed(0)
        t0 = time.perf_counter()
        searcher.search()
        run.sync()
        return time.perf_counter() - t0, searcher

    spreads = {}

    def min2(runs_key, *thunks):
        """min-of-N; the single runs are recorded."""
        times = [t() for t in thunks]
        spreads[runs_key] = [round(t, 2) for t in times]
        return min(times)

    # run 1 pays cuDNN's first-use heuristics and the allocator's growth;
    # later runs build a brand-new searcher (loaders, backbones, banks);
    # resident runs re-enter search() on the same searcher
    wall_pop_cold, pop_searcher = run_search()
    args = pop_searcher.args
    n_trained = n_candidates(1, args.max_progression_levels, args.num_samples)

    # the sequential per-candidate engine, built now so population runs and
    # per-candidate runs are timed in adjacent pairs: host drift lands in
    # both sides of a pair's ratio
    seq_args = _search_args(packed, tmp_root, batch, epochs=epochs,
                            sequential_candidates=True)
    seq_searcher = NTUSearcher(seq_args, device=run.device)
    seq = seq_searcher.train_fn
    model = Searchable_Skeleton_Image_Net(
        seq_args, np.array([[3, 1, 1], [1, 3, 0]]), device=run.device,
        generator=torch.Generator().manual_seed(1))
    for attr, state in seq.backbone_states.items():
        getattr(model, attr).load_state_dict(state, strict=True)
    init_state = snapshot(model)
    engine = ClassifierEngine(model, run.device, multitask=False,
                              input_keys=("rgb", "ske"),
                              batch_prep=seq.batch_prep)
    seq_loaders = seq_searcher.dataloaders
    sizes = {k: dl.dataset_size for k, dl in seq_loaders.items()}

    def one_candidate(num_epochs=epochs):
        model.load_state_dict(init_state)
        sched = LRCosineAnnealingScheduler(
            seq_args.eta_max, seq_args.eta_min, seq_args.Ti, seq_args.Tm,
            sizes["train"] / seq_args.batchsize)
        t0 = time.perf_counter()
        engine.train_track_acc(model.central_params(), seq_loaders, sizes,
                               sched, num_epochs=num_epochs, print_loss=False)
        run.sync()
        return time.perf_counter() - t0

    one_candidate()                      # cold

    # 5 pairs on the card: the median survives two drift-poisoned pairs
    pairs = []                           # (t_pop, t_cand) back to back
    for _ in range(5 if on_card else 2):
        pairs.append((run_search()[0], one_candidate()))
    wall_pop = min(tp for tp, _ in pairs)
    t_cand = min(tc for _, tc in pairs)
    spreads["pop"] = [round(tp, 2) for tp, _ in pairs]
    spreads["seq_percand"] = [round(tc, 2) for _, tc in pairs]
    speedup_paired, pair_ratios = paired_speedup(pairs, n_trained)

    wall_pop_res = min2("pop_resident",
                        lambda: run_search(searcher=pop_searcher)[0],
                        lambda: run_search(searcher=pop_searcher)[0])
    del pop_searcher

    # --cache_features: the backbones run once per sample in all; later
    # epochs and populations gather from the device bank
    _, cached_searcher = run_search(cache_features=True)
    wall_pop_cached = min2("pop_cached",
                           lambda: run_search(cache_features=True)[0],
                           lambda: run_search(cache_features=True)[0])
    wall_pop_cached_res = min2(
        "pop_cached_resident",
        lambda: run_search(searcher=cached_searcher)[0],
        lambda: run_search(searcher=cached_searcher)[0])
    detail["cached_search_feature_dtype"] = str(
        cached_searcher.train_fn.trainer.spec.feature_dtype or "float32")
    del cached_searcher

    # measured sequential wall-clock: one full --sequential_candidates
    # search of the same config (per-candidate model build included, which
    # the extrapolated basis below excludes)
    seq_keys = ["search_wallclock_seq_measured_s",
                "search_wallclock_measured_speedup",
                "search_wallclock_cached_measured_speedup"]
    wall_seq_measured = None
    if run.switch("MFAS_BENCH_SEQ_MEASURED") != "0":
        if run.budget_left() > 2600:
            wall_seq_measured = run_search(sequential_candidates=True)[0]
        else:
            reason = f"budget: {run.budget_left():.0f}s left"
            detail["search_wallclock_seq_measured_skipped"] = reason
            _carry_forward(detail, run, seq_keys, reason)
    else:
        _carry_forward(detail, run, seq_keys, LEAN)

    # sequential basis: candidates x the warm per-candidate time of the
    # pairs above
    wall_seq = n_trained * t_cand

    detail.update({
        "search_wallclock_pop_s": round(wall_pop, 2),
        "search_wallclock_pop_cold_s": round(wall_pop_cold, 2),
        "search_wallclock_pop_resident_s": round(wall_pop_res, 2),
        "search_wallclock_resident_speedup": round(wall_seq / wall_pop_res, 2),
        "search_wallclock_pop_cached_s": round(wall_pop_cached, 2),
        "search_wallclock_cached_speedup": round(
            wall_seq / wall_pop_cached, 2),
        "search_wallclock_pop_cached_resident_s": round(
            wall_pop_cached_res, 2),
        "search_wallclock_cached_resident_speedup": round(
            wall_seq / wall_pop_cached_res, 2),
        "search_wallclock_seq_s": round(wall_seq, 2),
        "search_wallclock_seq_percand_s": round(t_cand, 3),
        "search_wallclock_candidates": n_trained,
        "search_wallclock_run_spreads_s": spreads,
        "search_wallclock_config": {
            "img": img, "batch": batch, "n_train": n_train, "n_dev": n_dev,
            "search_iterations": 1, "max_fusions": 2, "num_samples": 4,
            "epochs": epochs},
        "search_wallclock_speedup": round(speedup_paired, 2),
        "search_wallclock_speedup_pairs": [round(r, 2) for r in pair_ratios],
        "search_wallclock_speedup_minbasis": round(wall_seq / wall_pop, 2),
        "search_wallclock_note": (
            "pop = the whole EPNAS loop incl. surrogate fits, sampling and "
            "host IO, a WARM run (a new searcher in the same process: "
            "loaders, backbones and banks rebuilt; cuDNN's algorithm choice "
            "and the caching allocator warm); the first run is pop_cold "
            "(the kernels were built before the first section). seq = "
            "candidates x the measured WARM per-candidate training "
            "wall-clock (model build excluded). speedup = MEDIAN of "
            "per-PAIR ratios (each pop run timed back to back with a "
            "per-candidate run, so host drift between the two sides "
            "cancels; the min-basis ratio is kept beside it). seq_measured "
            "= ONE real --sequential_candidates search of the same config, "
            "per-candidate model build included. resident_* = re-entering "
            "search() on the SAME searcher (for the cached variant the "
            "feature bank persists): the steady-state per-level cost of a "
            "long-running process. Every candidate is charged the 2-row "
            "head cost though the 32 first-step entries train 1-row heads: "
            "immaterial at 256 px, where the backbone pass dominates"),
    })
    if wall_seq_measured is not None:
        detail.update({
            "search_wallclock_seq_measured_s": round(wall_seq_measured, 2),
            "search_wallclock_measured_speedup": round(
                wall_seq_measured / wall_pop, 2),
            "search_wallclock_cached_measured_speedup": round(
                wall_seq_measured / wall_pop_cached, 2),
        })

    # amortization trend: 2 search iterations x 3 fusion levels, K=8 (72
    # candidates), so per-level fixed costs are shown to amortize
    trend_keys = ["search_trend_config", "search_trend_candidates",
                  "search_trend_pop_s", "search_trend_pop_cached_s",
                  "search_trend_seq_s", "search_trend_speedup",
                  "search_trend_cached_speedup"]
    trend_on = run.switch("MFAS_BENCH_TREND") != "0"
    if on_card and not trend_on:
        _carry_forward(detail, run, trend_keys, LEAN)
    elif on_card and trend_on and run.budget_left() <= 900:
        _carry_forward(detail, run, trend_keys,
                       f"budget: {run.budget_left():.0f}s left")
    if on_card and trend_on and run.budget_left() > 900:
        # the CLI's --max_fusions parses into args.max_progression_levels
        big = dict(search_iterations=2, max_progression_levels=3,
                   num_samples=8)
        run_search(**big)                            # cold (3-row head)
        big_pop = min2("trend_pop", lambda: run_search(**big)[0],
                       lambda: run_search(**big)[0])
        run_search(cache_features=True, **big)
        big_pop_cached = min2(
            "trend_pop_cached",
            lambda: run_search(cache_features=True, **big)[0],
            lambda: run_search(cache_features=True, **big)[0])
        n_big = n_candidates(big["search_iterations"],
                             big["max_progression_levels"],
                             big["num_samples"])
        detail.update({
            "search_trend_config": big,
            "search_trend_candidates": n_big,
            "search_trend_pop_s": round(big_pop, 2),
            "search_trend_pop_cached_s": round(big_pop_cached, 2),
            "search_trend_seq_s": round(n_big * t_cand, 2),
            "search_trend_speedup": round(n_big * t_cand / big_pop, 2),
            "search_trend_cached_speedup": round(
                n_big * t_cand / big_pop_cached, 2),
        })

    # full scale: the reference's NTU search shape (3 search iterations x 4
    # levels, K=15, 3 epochs: 197 candidates) with --cache_features, the
    # sequential basis re-measured at 3 epochs. MFAS_BENCH_FULLSCALE: "1"
    # runs on the card (default under MFAS_BENCH_FULL=1), "0" skips,
    # "force" runs even on the CPU (a tiny-shape run of the section)
    fullscale_env = run.switch("MFAS_BENCH_FULLSCALE")
    fullscale_on = (fullscale_env != "0"
                    and (on_card or fullscale_env == "force"))
    fullscale_keys = ["search_fullscale_pop_cached_s",
                      "search_fullscale_pop_cached_cold_s",
                      "search_fullscale_pop_cached_resident_s",
                      "search_fullscale_pop_s",
                      "search_fullscale_seq_percand_s",
                      "search_fullscale_seq_s",
                      "search_fullscale_cached_speedup",
                      "search_fullscale_cached_resident_speedup",
                      "search_fullscale_speedup",
                      "search_fullscale_candidates",
                      "search_fullscale_config"]
    if on_card and not fullscale_on:
        _carry_forward(detail, run, fullscale_keys, LEAN)
    if fullscale_on and run.budget_left() <= 900:
        _carry_forward(detail, run, fullscale_keys,
                       f"budget: {run.budget_left():.0f}s left")
    if fullscale_on and run.budget_left() > 900:
        full = dict(search_iterations=3, max_progression_levels=4,
                    num_samples=15, epochs=3)
        t_cand3 = min2("fullscale_seq_percand",
                       lambda: one_candidate(3), lambda: one_candidate(3))
        n_full = n_candidates(full["search_iterations"],
                              full["max_progression_levels"],
                              full["num_samples"])
        full_cold, full_searcher = run_search(cache_features=True, **full)
        full_pop_cached = min2(
            "fullscale_pop_cached",
            lambda: run_search(cache_features=True, **full)[0],
            lambda: run_search(cache_features=True, **full)[0])
        full_pop_cached_res = min2(
            "fullscale_pop_cached_resident",
            lambda: run_search(searcher=full_searcher)[0],
            lambda: run_search(searcher=full_searcher)[0])
        del full_searcher
        detail.update({
            "search_fullscale_config": full,
            "search_fullscale_candidates": n_full,
            "search_fullscale_pop_cached_cold_s": round(full_cold, 2),
            "search_fullscale_pop_cached_s": round(full_pop_cached, 2),
            "search_fullscale_pop_cached_resident_s": round(
                full_pop_cached_res, 2),
            "search_fullscale_seq_percand_s": round(t_cand3, 3),
            "search_fullscale_seq_s": round(n_full * t_cand3, 2),
            "search_fullscale_cached_speedup": round(
                n_full * t_cand3 / full_pop_cached, 2),
            "search_fullscale_cached_resident_speedup": round(
                n_full * t_cand3 / full_pop_cached_res, 2),
        })
        if run.budget_left() > 1200:
            # one streamed run of the same structure (the backbones re-run
            # per epoch per level: what --cache_features removes)
            full_pop = min2("fullscale_pop", lambda: run_search(**full)[0])
            detail.update({
                "search_fullscale_pop_s": round(full_pop, 2),
                "search_fullscale_speedup": round(
                    n_full * t_cand3 / full_pop, 2),
            })


# ---------------------------------------------------------------------------
# Section 4: end-to-end input-fed found-arch training throughput
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _path_launches(detail, name):
    """Record the input-kernel launches of the block under
    detail["kernel_launches"][name]."""
    from mfas_tpu_torch.ops.input_kernels import launch_counts

    before = dict(launch_counts)
    try:
        yield
    finally:
        detail.setdefault("kernel_launches", {})[name] = {
            k: launch_counts[k] - before[k] for k in launch_counts}


def bench_e2e_input(detail, run, tmp_root):
    _maybe_inject("bench_e2e_input")
    import torch

    from mfas_tpu_torch.core.layers import set_dropout_generator
    from mfas_tpu_torch.data.loader import MapLoader
    from mfas_tpu_torch.data.ntu import Compose, NormalizeLen
    from mfas_tpu_torch.data.ntu_pack import (PackedNTU,
                                              make_device_normalize_prep,
                                              make_synthetic_packed_ntu)
    from mfas_tpu_torch.data.resident import (ResidentLoader,
                                              ResidentNTUStore,
                                              make_resident_prep)
    from mfas_tpu_torch.engine.classifier import (ClassifierEngine,
                                                  place_batch, set_trainable,
                                                  snapshot)
    from mfas_tpu_torch.fusion.ntu import Searchable_Skeleton_Image_Net

    device = run.device
    B, IMG = (16, 256) if run.on_card else (2, 32)
    fargs = _ntu_args(modality="both", no_norm=False, **FOUND_ARGS)
    if not run.on_card:
        fargs.vid_len = CPU_SHRINK["vid_len"]

    store = os.path.join(tmp_root, "e2e")
    n = 12 * B   # enough batches that prefetch startup amortizes
    make_synthetic_packed_ntu(store, n=n, frames=fargs.vid_len[0],
                              h=IMG, w=IMG)
    transform = Compose([NormalizeLen(fargs.vid_len)])
    ds = PackedNTU(store, transform=transform, args=fargs,
                   device_normalize=True)
    loader = MapLoader(ds, B, shuffle=True, num_workers=4, prefetch=2)

    model = Searchable_Skeleton_Image_Net(
        fargs, np.array(FOUND_CONF), device=device,
        generator=torch.Generator().manual_seed(0))
    set_trainable(model, None)
    init_state = snapshot(model)

    def fresh(engine):
        """The initial net, its dropout drawn from ``engine``'s generator;
        -> a fresh Adam."""
        model.load_state_dict(init_state)
        set_dropout_generator(model, engine.generator)
        engine.generator.manual_seed(7)
        return engine.make_optimizer()

    def epoch_fn(engine, batches):
        """-> a function that runs one epoch of ``batches`` from the initial
        net and returns (seconds, batches)."""
        opt = fresh(engine)

        def epoch():
            model.train()
            t0 = time.perf_counter()
            nb = 0
            for _, b in engine._prefetched(batches):
                engine.train_step(b, opt, 1e-3)
                nb += 1
            run.sync()
            return time.perf_counter() - t0, nb

        return epoch

    # packed store streamed as uint8 clips, normalized by K1 on the card
    engine = ClassifierEngine(model, device, multitask=True,
                              input_keys=("rgb", "ske"),
                              batch_prep=make_device_normalize_prep())
    with _path_launches(detail, "bench_e2e_input/streamed"):
        epoch = epoch_fn(engine, loader)
        epoch()                          # cold: page-in, allocator growth
        t1, nb = epoch()
        t2, _ = epoch()
    _release(engine)
    detail["e2e_epoch_runs_s"] = [round(t1, 2), round(t2, 2)]
    t = min(t1, t2)
    detail["e2e_train_clips_per_s"] = round(nb * B / t, 2)

    # the card-resident store: batches are index plans; gather, temporal
    # resample and normalize run on the card in K2, with the prep of
    # main_found_ntu --hbm_resident (fuse_gather=True)
    res_store = ResidentNTUStore(store, device, args=fargs)
    res_loader = ResidentLoader(res_store, B, transform=transform,
                                shuffle=True)
    res_engine = ClassifierEngine(
        model, device, multitask=True, input_keys=("rgb", "ske"),
        batch_prep=make_resident_prep(fuse_gather=True, store=res_store))
    with _path_launches(detail, "bench_e2e_input/resident"):
        res_epoch = epoch_fn(res_engine, res_loader)
        res_epoch()                      # cold
        r1, rnb = res_epoch()
        r2, _ = res_epoch()
    _release(res_engine)
    detail["e2e_train_clips_per_s_resident"] = round(
        rnb * B / min(r1, r2), 2)

    # bf16 + resident: main_found_ntu --hbm_resident --bf16 (K2 writes bf16)
    if os.environ.get("MFAS_BENCH_BF16", "1") != "0":
        bf16_engine = ClassifierEngine(
            model, device, multitask=True, input_keys=("rgb", "ske"),
            batch_prep=make_resident_prep(fuse_gather=True,
                                          compute_dtype=torch.bfloat16,
                                          store=res_store),
            compute_dtype=torch.bfloat16)
        with _path_launches(detail, "bench_e2e_input/resident_bf16"):
            bf16_epoch = epoch_fn(bf16_engine, res_loader)
            bf16_epoch()                 # cold
            rb1, rnb = bf16_epoch()
            rb2, _ = bf16_epoch()
        _release(bf16_engine)
        detail["e2e_train_clips_per_s_resident_bf16"] = round(
            rnb * B / min(rb1, rb2), 2)
    del res_store, res_loader

    # breakdown: (a) host produce + collate alone, (b) the step alone on one
    # batch already on the card (K1 normalizes it every step)
    def host_only_epoch():
        t0 = time.perf_counter()
        nb2 = sum(1 for _ in loader)
        return (time.perf_counter() - t0) / nb2

    host_only_epoch()
    t_host = min(host_only_epoch(), host_only_epoch())

    on_card_batch = place_batch(next(iter(loader)), device)
    with _path_launches(detail, "bench_e2e_input/step_only"):
        opt = fresh(engine)

        def step_only():
            model.train()
            t0 = time.perf_counter()
            for _ in range(4):
                engine.train_step(on_card_batch, opt, 1e-3)
            run.sync()
            return (time.perf_counter() - t0) / 4

        step_only()
        t_step = min(step_only(), step_only())
    _release(engine)
    detail["e2e_breakdown_per_batch_s"] = {
        "host_produce_collate": round(t_host, 4),
        "device_step_resident": round(t_step, 4),
        "epoch_total": round(t / nb, 4)}

    # raw host -> card bandwidth at the same transfer size, from pageable
    # memory (the loader's batches are copied into pinned memory first)
    buf = np.zeros((B, fargs.vid_len[0], IMG, IMG, 3), np.uint8)

    def put():
        torch.from_numpy(buf).to(device)
        run.sync()

    put()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        put()
        times.append(time.perf_counter() - t0)
    h2d = buf.nbytes / np.median(times) / 1e9
    detail["h2d_gbps"] = round(h2d, 3)
    detail["e2e_h2d_bound_clips_per_s"] = round(
        h2d * 1e9 / (buf.nbytes / B), 2)
    detail["e2e_config"] = {"batch": B, "img": IMG, "n_samples": n,
                            "num_workers": 4, "device_normalize": True,
                            "resident_prep": "fuse_gather=True (K2)",
                            "h2d_buffer_pinned": False}
    detail["e2e_note"] = (
        "epoch_total against device_step_resident and host_produce_collate: "
        "the loader's thread collates batch N+1 and copies it to the card "
        "(pinned memory, non_blocking) while the card runs batch N, so an "
        "epoch near the step time means the input is hidden and one near "
        "the host time means the host bounds it. h2d_gbps is one pageable "
        "torch.from_numpy(buf).to(device) of a batch of uint8 clips, ended "
        "by a synchronize; e2e_h2d_bound_clips_per_s is the clip rate that "
        "rate alone allows. The resident path uses the prep of the port's "
        "main_found_ntu --hbm_resident (K2: gather + resample + normalize "
        "in one kernel), where the JAX bench's resident path used the JAX "
        "defaults (XLA gather, no Pallas kernel). The JAX bench's chunked-"
        "H2D experiment (engine.h2d_chunks) has no counterpart: the port "
        "copies a batch once, from pinned memory, on the prefetch thread")


# ---------------------------------------------------------------------------
# Section 5: host input pipeline (native C++ gather + normalize)
# ---------------------------------------------------------------------------
def bench_host_input(detail):
    _maybe_inject("bench_host_input")
    from mfas_tpu_torch.data import native as nat

    B, IMG, T = 16, 256, 8
    store = np.random.RandomState(1).randint(
        0, 256, (64, T, IMG, IMG, 3), np.uint8)
    idx = np.random.RandomState(2).randint(0, 64, B).astype(np.int64)
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)

    best = (0.0, None)
    for nt in (1, 2, 4):
        nat.gather_normalize_u8(store, idx, mean, std, num_threads=nt)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            out = nat.gather_normalize_u8(store, idx, mean, std,
                                          num_threads=nt)
            times.append(time.perf_counter() - t0)
        gbps = out.nbytes * 1.25 / np.median(times) / 1e9
        if gbps > best[0]:
            best = (gbps, nt)
    detail["native_input_normalize_gbps"] = round(best[0], 2)
    detail["native_input_normalize_threads"] = best[1]


def _power_limit_w():
    """The card's power limit in W, from nvidia-smi (None without it)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
        return float(out.splitlines()[0].rsplit(",", 1)[1].split()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return None


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="The port's benchmark harness (one JSON record line "
                    "per section).")
    parser.add_argument("--detail_file", type=str, default=None,
                        help="sidecar with the full record (default "
                             "mfas_tpu_torch/bench_detail.cuda.json; "
                             "bench_detail.cpu.json on the CPU); only the "
                             "default sidecar is a carry-forward source")
    return parser.parse_args(argv)


def main(argv=None, device=None):
    """Run the bench; -> the detail dict. ``device=None`` is CUDA and exits
    without it; ``device="cpu"`` runs the CPU shapes."""
    t0 = time.perf_counter()
    args = parse_args(argv)
    from mfas_tpu_torch.runtime.cli import cli_device

    device = cli_device(device, "mfas_tpu_torch.bench")
    import torch

    from mfas_tpu_torch.ops import input_kernels as tk

    on_card = device.type == "cuda"
    default = default_detail_file(on_card)
    detail_file = os.path.abspath(args.detail_file or default)
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    full = os.environ.get("MFAS_BENCH_FULL", "0") == "1"
    run = BenchRun(device=device, detail_file=detail_file,
                   budget_s=float(os.environ.get("MFAS_BENCH_BUDGET_S",
                                                 "2900")),
                   full=full, t0=t0,
                   carry_source=_load_carry_source(
                       detail_file, detail_file == os.path.abspath(default),
                       kind))
    _install_signal_fallback(run)

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    detail = {"device": (f"{device} ({kind}); torch {torch.__version__}, "
                         f"CUDA {torch.version.cuda}"),
              "device_kind": kind,
              "power_limit_w": _power_limit_w() if on_card else None,
              "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
              "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32,
              "bench_profile": "full" if full else "lean"}
    fast = os.environ.get("MFAS_BENCH_FAST") == "1"

    try:
        # build (or load) the input kernels before any timed section, so no
        # cold figure holds nvcc's time
        k0 = time.perf_counter()
        if on_card:
            tk.load_library()
        detail["kernel_build_s"] = (round(time.perf_counter() - k0, 3)
                                    if on_card else None)

        def section(fn, *section_args):
            tk.reset_launch_counts()
            try:
                return fn(detail, run, *section_args)
            except Exception as e:  # noqa: BLE001 — the record must print
                traceback.print_exc()
                detail[fn.__name__ + "_error"] = repr(e)
            finally:
                detail.setdefault("kernel_launches", {})[fn.__name__] = \
                    dict(tk.launch_counts)
                if on_card:
                    torch.cuda.empty_cache()

        speedup = section(bench_proxy) or 0.0

        # headline: the end-to-end search wall-clock speedup once that
        # section has run; the per-step proxy until then (and on FAST runs)
        def headline():
            return detail.get("search_wallclock_speedup", speedup)

        _emit(detail, headline(), run, partial_after="bench_proxy")

        hang = float(os.environ.get("MFAS_BENCH_HANG_S", "0"))
        if hang:   # test hook: a stuck section (the SIGTERM fallback test)
            time.sleep(hang)

        with tempfile.TemporaryDirectory() as tmp_root:
            if not fast:
                for fn in (bench_search_wallclock, bench_e2e_input):
                    section(fn, tmp_root)
                    _emit(detail, headline(), run,
                          partial_after=fn.__name__)
            try:
                bench_host_input(detail)
            except Exception as e:  # noqa: BLE001
                traceback.print_exc()
                detail["bench_host_input_error"] = repr(e)

        detail["bench_wallclock_s"] = round(time.perf_counter() - t0, 1)
        _emit(detail, headline(), run)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return detail


if __name__ == "__main__":
    main()
