#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mfas_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. the device: nvidia-smi's name and power limit, SM clock and throttle
   reasons (card_state), torch and CUDA versions;
2. builds the input kernels (mfas_tpu_torch/csrc/input_kernels.cu) with nvcc;
3. K1 u8_normalize against its plain PyTorch version, bitwise, at
   (20,8,256,256,3) in f32 and bf16, and with the frame pick 24 -> 8;
4. K2 u8_gather_normalize against its plain version, bitwise, from a
   (50,24,256,256,3) store with B=20, T=8, in f32 and bf16;
5. times K1, K2, torch gather + K1 and the plain versions (median of CUDA
   event timings, L2 flushed between launches), f32 and bf16;
6. the found-NTU --test_cp slice end to end at full width (ResNet-50 3-4-6-3
   at base width 64, HCN over 32 frames, found conf 4, random weights from a
   seed): a synthetic packed store at 256x256 (24 frames, 300 skeleton
   frames; train 40, dev 20, test 50 so the last test batch of 20 is
   ragged) and a torch.save'd checkpoint go through
   ``mfas_tpu_torch.main_found_ntu`` with --device_input_normalize (K1) and
   with --hbm_resident (K2), each twice (cold, then warm); each run must
   launch its kernel and print a finite Model Acc, and the two paths' fused
   logits must agree; the first two test clips are checked against the same
   net on the CPU;
7. found-NTU training at full width (the same net at the CLI's default
   --inner_representation_size 256, --batchsize 20, --random_backbones,
   --epochs 1, so phase 1 and phase 2 each run one epoch) on the same
   store: (a) --hbm_resident f32, writing a train state and a
   --save_checkpoint file; (b) --device_input_normalize f32; (c)
   --hbm_resident --bf16; (d) --hbm_resident --remat; (e) a resume of (a)'s
   state to --epochs 2 under --profile_dir, which must skip phase 1. Each
   run must print finite losses and Model Acc and launch its kernel exactly
   once per train, dev and test batch (bf16 output in (c)); train clips/s
   and peak allocated memory are printed per phase;
8. steady-state train steps at full width, B=20, on the resident path:
   f32, bf16 and remat, phase 1 and phase 2 (median of 5 after 2), then 3
   steps each under torch.profiler: device time per step by kernel class
   (convolution forward/dgrad/wgrad, elementwise, reductions, Adam, the
   input kernel, ...) and the device's busy share; the card's state after
   each mode;
9. one phase-2 train step at full width on 2 clips with --drpt 0, card
   against CPU: in f64 with --batchnorm, the loss within 1e-4 relative and
   every gradient and BatchNorm statistic within 1e-3 of its tensor's max;
   in f32, the loss within 1e-4 relative and the gradients no further from
   the CPU's f64 ones than the CPU's f32 ones are (card_vs_cpu says why).

TF32 is off throughout. Any failed check exits non-zero. Before the last
lines come {"slice": ...} and {"training": ...} with the measured numbers;
the line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero.
"""

import json
import os
import shutil
import subprocess
import sys
import time

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
K1_SHAPE = (20, 8, 256, 256, 3)
K1_PICK_SHAPE = (20, 24, 256, 256, 3)
K2_STORE = (50, 24, 256, 256, 3)
SEED = 0


class SmokeFailure(Exception):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def phase(name):
    print(f"== {name}", flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


CARD_STATE = ("clocks.sm,clocks.max.sm,temperature.gpu,power.draw,"
              "clocks_throttle_reasons.active")


def card_state(when):
    """nvidia-smi's SM clock, its maximum, temperature, power draw and
    throttle reasons, printed and returned: compute-bound times scale with
    the SM clock, so a time read on a throttled card says so beside it. A
    failed query is reported, not fatal."""
    r = subprocess.run(["nvidia-smi", f"--query-gpu={CARD_STATE}",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    line = (r.stdout.strip().splitlines() or [""])[0] if r.returncode == 0 \
        else f"nvidia-smi failed: {r.stderr.strip()[:200]}"
    print(f"card state {when} ({CARD_STATE}): {line}", flush=True)
    return line


def time_ms(torch, fn, iters=25, warmup=3):
    """Median device time of fn() from CUDA events. Before each timed call a
    256 MB read evicts the 50 MB L2 (the inputs are not cached), leaves no
    dirty line whose write-back would land inside the timed call, and keeps
    the card busy while the host enqueues fn's work, so the host's launch
    overhead is not timed."""
    flush = torch.zeros(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.max()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def bitwise(torch, got, want, what):
    torch.cuda.synchronize()
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{what}: {got.dtype}{tuple(got.shape)} vs "
          f"{want.dtype}{tuple(want.shape)}")
    err = (got.float() - want.float()).abs().max().item()
    check(torch.equal(got, want), f"{what}: not bitwise equal to the plain "
          f"version (max abs err {err})")
    print(f"{what}: bitwise equal to the plain version")
    return err


def kernel_phases(torch, tk):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    err = {"u8_normalize": 0.0, "u8_gather_normalize": 0.0}

    phase("K1 u8_normalize vs plain")
    x = torch.randint(0, 256, K1_SHAPE, dtype=torch.uint8, device=dev,
                      generator=g)
    for dt in (torch.float32, torch.bfloat16):
        e = bitwise(torch, tk.u8_normalize(x, MEAN, STD, out_dtype=dt),
                    tk.u8_normalize_plain(x, MEAN, STD, out_dtype=dt),
                    f"K1 {tuple(K1_SHAPE)} {dt}")
        err["u8_normalize"] = max(err["u8_normalize"], e)
    xp = torch.randint(0, 256, K1_PICK_SHAPE, dtype=torch.uint8, device=dev,
                       generator=g)
    pick = tk.linspace_frame_indices(K1_PICK_SHAPE[1], 8)
    for dt in (torch.float32, torch.bfloat16):
        e = bitwise(torch, tk.u8_normalize(xp, MEAN, STD, pick, out_dtype=dt),
                    tk.u8_normalize_plain(xp, MEAN, STD, pick, out_dtype=dt),
                    f"K1 pick {tuple(K1_PICK_SHAPE)}->T'=8 {dt}")
        err["u8_normalize"] = max(err["u8_normalize"], e)
    del xp

    phase("K2 u8_gather_normalize vs plain")
    store = torch.randint(0, 256, K2_STORE, dtype=torch.uint8, device=dev,
                          generator=g)
    B, T = K1_SHAPE[:2]
    sidx = torch.randint(0, K2_STORE[0], (B,), device=dev, generator=g)
    fidx = torch.randint(0, K2_STORE[1], (B, T), device=dev, generator=g)
    for dt in (torch.float32, torch.bfloat16):
        e = bitwise(torch,
                    tk.u8_gather_normalize(store, sidx, fidx, MEAN, STD, dt),
                    tk.u8_gather_normalize_plain(store, sidx, fidx, MEAN, STD,
                                                 dt),
                    f"K2 store {tuple(K2_STORE)} B={B} T={T} {dt}")
        err["u8_gather_normalize"] = max(err["u8_gather_normalize"], e)

    phase("kernel times")
    n = B * T * K1_SHAPE[2] * K1_SHAPE[3] * K1_SHAPE[4]
    ms = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        moved = n * (1 + dt.itemsize)   # uint8 read + output written
        ms[name] = t = {
            "K1": time_ms(torch, lambda: tk.u8_normalize(
                x, MEAN, STD, out_dtype=dt)),
            "K1_plain": time_ms(torch, lambda: tk.u8_normalize_plain(
                x, MEAN, STD, out_dtype=dt)),
            "K2": time_ms(torch, lambda: tk.u8_gather_normalize(
                store, sidx, fidx, MEAN, STD, dt)),
            "gather_K1": time_ms(torch, lambda: tk.u8_normalize(
                store[sidx[:, None], fidx], MEAN, STD, out_dtype=dt)),
            "K2_plain": time_ms(torch, lambda: tk.u8_gather_normalize_plain(
                store, sidx, fidx, MEAN, STD, dt)),
        }
        for k, v in t.items():
            print(f"{name} {k}: {v * 1e3:.1f} us, {moved / v / 1e6:.1f} GB/s "
                  f"(uint8 in + {name} out bytes / time)")
    print("kernel_times_ms " + json.dumps(ms))
    return err, ms


SPLITS = (("train", 40), ("dev", 20), ("test", 50))


def write_store(work):
    from mfas_tpu_torch.data.ntu_pack import make_synthetic_packed_ntu

    packed = os.path.join(work, "packed")
    t0 = time.time()
    for seed, (split, n) in enumerate(SPLITS):
        make_synthetic_packed_ntu(os.path.join(packed, split), n=n,
                                  frames=24, h=256, w=256, skel_frames=300,
                                  num_classes=60, seed=seed)
    print(f"synthetic packed store written in {time.time() - t0:.1f} s")
    return packed


def slice_phase(torch, work, packed):
    import numpy as np

    from mfas_tpu_torch import main_found_ntu as tmain
    from mfas_tpu_torch.data.ntu import Compose, NormalizeLen
    from mfas_tpu_torch.data.ntu_pack import (PackedNTU,
                                              make_device_normalize_prep)
    from mfas_tpu_torch.engine.classifier import valid_rows
    from mfas_tpu_torch.fusion.ntu import Searchable_Skeleton_Image_Net
    from mfas_tpu_torch.ops import input_kernels as tk

    phase("found-NTU --test_cp slice, full width")
    argv = ["--checkpointdir", work, "--test_cp", "net.pt",
            "--packed_datadir", packed, "--conf", "4", "--num_outputs", "60",
            "--batchsize", "20", "--inner_representation_size", "128",
            "--batchnorm", "--vid_len", "8", "32"]
    args = tmain.parse_args(argv)
    net = Searchable_Skeleton_Image_Net(
        args, tmain.FOUND_CONFS[4], device="cuda",
        generator=torch.Generator().manual_seed(SEED))
    state = net.state_dict()
    torch.save(state, os.path.join(work, "net.pt"))
    n_params = sum(v.numel() for k, v in state.items()
                   if not k.endswith("num_batches_tracked"))
    print(f"checkpoint: {len(state)} tensors, {n_params} values")
    del net

    # each path runs twice, in turns: the first pass of the process pays
    # cuDNN's and the loaders' first-call costs, the second is warm
    runs = {}
    for rep in ("cold", "warm"):
        for name, flag, kernel in (("packed", "--device_input_normalize",
                                    "u8_normalize"),
                                   ("resident", "--hbm_resident",
                                    "u8_gather_normalize")):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            tk.reset_launch_counts()
            run = tmain.main(argv + [flag])
            acc, rec = run.acc, run.eval
            counts = dict(tk.launch_counts)
            peak = torch.cuda.max_memory_allocated()
            check(counts[kernel] > 0, f"{name}: {kernel} never launched "
                  f"({counts})")
            check(np.isfinite(acc), f"{name}: Model Acc {acc} is not finite")
            logits = valid_rows(rec)
            check(logits.shape == (50, 60) and np.isfinite(logits).all(),
                  f"{name}: fused logits {logits.shape}, finite="
                  f"{np.isfinite(logits).all()}")
            print(f"{name} ({rep}): Model Acc {acc}, launches {counts}, eval "
                  f"{rec.clips / rec.seconds:.2f} clips/s ({rec.clips} clips "
                  f"in {rec.seconds:.3f} s, loader + H2D + forward), peak "
                  f"{peak / 2**30:.2f} GiB allocated")
            r = runs.setdefault(name, dict(acc=acc, logits=logits,
                                           counts=counts, peak_bytes=peak,
                                           first=rec.fused_logits[0]))
            r[f"{rep}_clips_per_s"] = rec.clips / rec.seconds
            if rep == "warm":
                print(f"{name}: warm vs cold fused logits, max abs diff "
                      f"{np.abs(logits - r['logits']).max():.3e}")

    a, b = runs["packed"]["logits"], runs["resident"]["logits"]
    # the paths differ only in the skeleton lerp's float association (~1e-6
    # relative); the absolute floor is 1e-5 of the logits' range, for
    # entries near zero
    diff = np.abs(a - b)
    bound = 1e-4 * np.maximum(np.abs(a), np.abs(b)) + 1e-5 * np.abs(a).max()
    check(np.all(diff <= bound), f"packed vs resident fused logits differ: "
          f"max abs {diff.max()}, max |logit| {np.abs(a).max()}")
    check(runs["packed"]["acc"] == runs["resident"]["acc"],
          f"Model Acc differs: {runs['packed']['acc']} vs "
          f"{runs['resident']['acc']}")
    print(f"packed vs resident fused logits: max abs diff {diff.max():.3e} "
          f"(max |logit| {np.abs(a).max():.3e})")

    phase("reference: the same net on the CPU, first two test clips")
    cpu = Searchable_Skeleton_Image_Net(
        args, tmain.FOUND_CONFS[4], device="cpu",
        generator=torch.Generator().manual_seed(SEED + 1))
    cpu.load_state_dict({k: v.cpu() for k, v in state.items()}, strict=True)
    cpu.eval()
    ds = PackedNTU(os.path.join(packed, "test"),
                   Compose([NormalizeLen(args.vid_len)]), args,
                   device_normalize=True)
    batch = {k: torch.from_numpy(np.stack([ds[i][k] for i in range(2)]))
             for k in ("rgb", "ske")}
    batch = make_device_normalize_prep()(batch)
    with torch.inference_mode():
        ref = cpu((batch["rgb"], batch["ske"]))[0].double().numpy()
    got = runs["packed"]["first"][:2].double().cpu().numpy()
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    print(f"card vs CPU fused logits, 2 clips: max abs diff "
          f"{np.abs(got - ref).max():.3e}, relative to max |logit| {rel:.3e}")
    # f32 through ~70 layers, summed in other orders by cuDNN and oneDNN
    check(rel <= 1e-3, f"card vs CPU logits: relative error {rel}")
    return runs


# --inner_representation_size stays at the CLI's default (256)
TRAIN_ARGV = ["--conf", "4", "--num_outputs", "60", "--batchsize", "20",
              "--batchnorm", "--vid_len", "8", "32", "--epochs", "1",
              "--random_backbones"]
BATCHES = {"train": 2, "dev": 1, "test": 3}     # of 20, from SPLITS


def _tally_out_dtypes(tk):
    """Wrap the two kernel wrappers so each call's output dtype is tallied
    (the batch prep binds them when a run builds its engine). Returns the
    tally and a function that puts the wrappers back."""
    seen = {}
    orig = {n: getattr(tk, n) for n in ("u8_normalize",
                                         "u8_gather_normalize")}

    def wrap(name, fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            key = (name, str(out.dtype))
            seen[key] = seen.get(key, 0) + 1
            return out
        return wrapped

    for n, fn in orig.items():
        setattr(tk, n, wrap(n, fn))
    return seen, lambda: [setattr(tk, n, fn) for n, fn in orig.items()]


# kernel classes of a train step, by kernel name: the first class one of
# whose substrings the name holds (cuDNN names its conv kernels fprop/dgrad/
# wgrad or convolve*; torch's foreach Adam runs in multi_tensor_apply)
KERNEL_CLASSES = (
    ("input_K1_K2", ("u8_norm",)),
    ("conv_wgrad", ("wgrad",)),
    ("conv_dgrad", ("dgrad", "flip_filter")),
    ("conv_fwd", ("fprop", "convolve")),
    ("cudnn_layout", ("nchwToNhwc", "nhwcToNchw")),
    ("pool", ("pool",)),
    ("adam", ("multi_tensor_apply",)),
    ("matmul", ("gemm", "nvjet", "cublas")),
    ("reduce", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "copy_kernel")),
)


def kernel_class(name):
    for cls, keys in KERNEL_CLASSES:
        if any(k in name for k in keys):
            return cls
    return "other"


def profile_summary(trace_path, steps=1):
    """Device busy share, device time by kernel class and the largest
    kernels of a torch.profiler chrome trace; times in ms per step."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    ks = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                if e.get("cat") == "kernel" and "dur" in e)
    if not ks:
        return {"kernels": 0}
    busy, end = 0.0, ks[0][0]
    by_name, by_class = {}, {}
    for a, b, name in ks:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        by_name[name] = by_name.get(name, 0.0) + (b - a)
        c = kernel_class(name)
        by_class[c] = by_class.get(c, 0.0) + (b - a)
    span = end - ks[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    per = 1e3 * steps       # trace times are µs
    return {"kernels_per_step": len(ks) / steps,
            "device_busy_ms": busy / per, "span_ms": span / per,
            "busy_share": busy / span,
            "by_class_ms": {c: t / per for c, t in sorted(
                by_class.items(), key=lambda kv: -kv[1])},
            "top_ms": [[n[:70], t / per] for n, t in top]}


def training_phase(torch, work, packed):
    import numpy as np

    from mfas_tpu_torch import main_found_ntu as tmain
    from mfas_tpu_torch.ops import input_kernels as tk
    from mfas_tpu_torch.runtime.checkpoint import load_state_dict

    phase("found-NTU training, full width")
    state = os.path.join(work, "train_state.pt")
    prof = os.path.join(work, "profile")
    base = ["--checkpointdir", work, "--packed_datadir", packed, *TRAIN_ARGV]
    runs = [
        ("a_resident_f32", "--hbm_resident",
         ["--train_state", state, "--save_checkpoint"]),
        ("b_packed_f32", "--device_input_normalize", []),
        ("c_resident_bf16", "--hbm_resident", ["--bf16"]),
        ("d_resident_remat", "--hbm_resident", ["--remat"]),
        ("e_resume", "--hbm_resident",
         ["--train_state", state, "--resume", "--epochs", "2",
          "--profile_dir", prof]),
    ]
    seen, unwrap = _tally_out_dtypes(tk)
    out = {}
    try:
        for name, flag, extra in runs:
            kernel = ("u8_gather_normalize" if flag == "--hbm_resident"
                      else "u8_normalize")
            dt = "torch.bfloat16" if "--bf16" in extra else "torch.float32"
            torch.cuda.empty_cache()
            tk.reset_launch_counts()
            seen.clear()
            t0 = time.time()
            run = tmain.main(base + [flag] + extra)
            wall = time.time() - t0
            counts = dict(tk.launch_counts)
            resumed = name == "e_resume"
            check(len(run.train) == (1 if resumed else 2),
                  f"{name}: {len(run.train)} training phases ran")
            if resumed:
                check([e["epoch"] for e in run.train[0].epochs] == [1, 1],
                      f"{name}: resumed epochs {run.train[0].epochs}")
            n_epochs = sum(e["phase"] == "train" for r in run.train
                           for e in r.epochs)
            want = (n_epochs * (BATCHES["train"] + BATCHES["dev"])
                    + BATCHES["test"])
            check(counts[kernel] == want and sum(counts.values()) == want,
                  f"{name}: launches {counts}, want {want} of {kernel}")
            check(seen == {(kernel, dt): want},
                  f"{name}: kernel outputs {seen}, want {want} x {dt}")
            stats = [e for r in run.train for e in r.epochs]
            check(all(np.isfinite(e["loss"]) for e in stats),
                  f"{name}: non-finite loss in {stats}")
            check(np.isfinite(run.acc), f"{name}: Model Acc {run.acc}")
            phases = [{"phase": "central" if len(run.train) == 2 and i == 0
                       else "whole",
                       "train_clips_per_s": r.train_clips / r.train_seconds,
                       "train_clips": r.train_clips,
                       "train_seconds": r.train_seconds,
                       "peak_bytes": peak}
                      for i, (r, peak) in enumerate(zip(run.train,
                                                        run.train_peak_bytes))]
            for p in phases:
                print(f"{name} {p['phase']}: {p['train_clips_per_s']:.2f} "
                      f"train clips/s ({p['train_clips']} clips in "
                      f"{p['train_seconds']:.3f} s), peak "
                      f"{p['peak_bytes'] / 2**30:.2f} GiB allocated")
            eval_rate = run.eval.clips / run.eval.seconds
            print(f"{name}: Model Acc {run.acc}, launches {counts}, "
                  f"{want} x {dt} out, eval {eval_rate:.2f} clips/s, run "
                  f"{wall:.1f} s, losses "
                  f"{[round(e['loss'], 4) for e in stats]}")
            out[name] = {"model_acc": run.acc, "phases": phases,
                         "launches": counts[kernel], "run_seconds": wall}
            if name == "a_resident_f32":
                sd = load_state_dict(run.saved)
                keys = {k[len("model/"):] for k in torch.load(
                    state, weights_only=True) if k.startswith("model/")}
                check(set(sd) == keys and all(
                    torch.isfinite(v.float()).all() for v in sd.values()),
                      "the saved checkpoint and the train state's model "
                      "differ in keys, or hold non-finite values")
                print(f"saved {os.path.basename(run.saved)}: {len(sd)} "
                      "tensors, the train state's keys")
            del run
    finally:
        unwrap()
    for f in ("trace.json", "ops.txt"):
        check(os.path.exists(os.path.join(prof, f)), f"--profile_dir: no {f}")
    summary = profile_summary(os.path.join(prof, "trace.json"))
    print("profile of e_resume (one phase-2 epoch + test): "
          + json.dumps(summary))
    out["e_resume"]["profile"] = summary
    return out


def warm_train_steps(torch, work, packed, n_warm=2, n_timed=5, n_prof=3):
    """Steady-state train step times at full width, B=20, on the resident
    path (K2 inside the step): for f32, bf16 and remat, phase 1 (central
    weights) and phase 2 (whole net), the median of n_timed steps after
    n_warm, each step ended by a synchronize; peak allocated memory over
    the timed steps. Then n_prof more steps under torch.profiler give the
    device time per step by kernel class (profile_summary)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from mfas_tpu_torch import main_found_ntu as tmain
    from mfas_tpu_torch.core.optim import make_adam
    from mfas_tpu_torch.data.ntu import Compose, NormalizeLen
    from mfas_tpu_torch.data.resident import ResidentLoader, ResidentNTUStore
    from mfas_tpu_torch.engine.classifier import (WEIGHT_DECAY, place_batch,
                                                  set_trainable)

    phase("warm train steps, full width, B=20")
    out = {}
    for mode, extra in (("f32", []), ("bf16", ["--bf16"]),
                        ("remat", ["--remat"])):
        args = tmain.parse_args(["--packed_datadir", packed,
                                 "--hbm_resident", *TRAIN_ARGV, *extra])
        model = tmain.build_model(args, tmain.FOUND_CONFS[4], "cuda")
        engine = tmain.make_engine(model, args, "cuda")
        store = ResidentNTUStore(os.path.join(packed, "train"), "cuda",
                                 args=args)
        loader = ResidentLoader(store, args.batchsize,
                                Compose([NormalizeLen(args.vid_len)]))
        batch = place_batch(next(iter(loader)), "cuda")
        for name, prefixes in (("central", model.central_params()),
                               ("whole", None)):
            set_trainable(model, prefixes)
            model.train()
            opt = make_adam(model.parameters(), WEIGHT_DECAY)
            times = []
            for i in range(n_warm + n_timed):
                if i == n_warm:
                    torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                loss, _ = engine._train_step(batch, opt, args.eta_max)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                check(np.isfinite(float(loss)), f"{mode} {name}: loss {loss}")
            ms = float(np.median(times[n_warm:])) * 1e3
            r = {"step_ms": ms, "train_clips_per_s": args.batchsize / ms * 1e3,
                 "peak_bytes": torch.cuda.max_memory_allocated(),
                 "step_ms_all": [t * 1e3 for t in times],
                 "card_state": card_state(f"after warm {mode} {name}")}
            out[f"{mode}_{name}"] = r
            print(f"warm {mode} {name}: {ms:.1f} ms/step, "
                  f"{r['train_clips_per_s']:.2f} train clips/s, peak "
                  f"{r['peak_bytes'] / 2**30:.2f} GiB allocated "
                  f"(steps {[round(t, 1) for t in r['step_ms_all']]} ms)")
            trace = os.path.join(work, f"warm_{mode}_{name}.json")
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(n_prof):
                    engine._train_step(batch, opt, args.eta_max)
                torch.cuda.synchronize()
                traced = time.perf_counter() - t0
            prof.export_chrome_trace(trace)
            r["profile"] = p = profile_summary(trace, steps=n_prof)
            p["wall_ms_traced"] = traced / n_prof * 1e3
            os.remove(trace)
            print(f"profile {mode} {name}, ms per step: wall (traced) "
                  f"{p['wall_ms_traced']:.1f}, device busy "
                  f"{p['device_busy_ms']:.1f} ({100 * p['busy_share']:.0f} % "
                  f"of the kernel span), {p['kernels_per_step']:.0f} kernels; "
                  + ", ".join(f"{c} {t:.2f}"
                              for c, t in p["by_class_ms"].items()))
            del opt
        del model, engine, store, loader, batch
        torch.cuda.empty_cache()
    return out


def card_vs_cpu(torch, packed):
    """One phase-2 train step at full width on 2 clips, --drpt 0, on the
    card and on the CPU, in two parts.

    Agreement, in float64 with --batchnorm (so the fusion head's
    BatchNorm1d runs in train mode too), both sides fed the same float64
    clips normalized on the host: the loss within 1e-4 relative, and every
    parameter's gradient and every BatchNorm running statistic after the
    step within 1e-3 of that tensor's max |value|.

    Precision, in float32 (TF32 off), the card with K1 in the step: the
    gradients of a random 50-layer net with train-mode BatchNorm over 2
    clips are ill-conditioned. On the CPU alone, f32 against f64 differs by
    ~1e-1 of a tensor's max |grad| (~2e-2 norm-wise), so no f32 computation
    meets 1e-3 of max |grad| against another. The card's f32 step is held
    to what f32 can give: the loss within 1e-4 relative of the CPU's, the
    whole gradient's norm-wise error against the CPU's f64 gradient at most
    twice the CPU f32's (plus 1e-6), and no tensor's more than ten times
    the CPU f32's (plus 1e-5). This part runs without the head's
    BatchNorm1d, which over 2 samples of the nearly constant pooled
    features of random backbones is worse still in f32."""
    import numpy as np

    from mfas_tpu_torch import main_found_ntu as tmain
    from mfas_tpu_torch.core.optim import make_adam
    from mfas_tpu_torch.data.ntu import Compose, NormalizeLen
    from mfas_tpu_torch.data.ntu_pack import (PackedNTU,
                                              make_device_normalize_prep)
    from mfas_tpu_torch.engine.classifier import (WEIGHT_DECAY,
                                                  ClassifierEngine,
                                                  set_trainable)

    phase("one phase-2 train step at full width, card vs CPU")
    argv = ["--packed_datadir", packed, "--device_input_normalize",
            *TRAIN_ARGV, "--drpt", "0"]
    args_bn = tmain.parse_args(argv)
    args = tmain.parse_args([a for a in argv if a != "--batchnorm"])
    ds = PackedNTU(os.path.join(packed, "train"),
                   Compose([NormalizeLen(args.vid_len)]), args,
                   device_normalize=True)
    host = {k: torch.from_numpy(np.stack([ds[i][k] for i in range(2)]))
            for k in ("rgb", "ske", "label")}
    host["_mask"] = torch.ones(2)
    host64 = make_device_normalize_prep(torch.float64)(
        {k: v.double() if v.is_floating_point() else v
         for k, v in host.items()})

    def step(name, args, dev, dt, batch, batch_prep):
        t0 = time.time()
        model = tmain.build_model(args, tmain.FOUND_CONFS[4], dev).to(dt)
        engine = ClassifierEngine(model, dev, multitask=args.multitask,
                                  input_keys=("rgb", "ske"),
                                  batch_prep=batch_prep)
        set_trainable(model, None)
        model.train()
        opt = make_adam(model.parameters(), WEIGHT_DECAY)
        loss, _ = engine._train_step({k: v.to(dev) for k, v in batch.items()},
                                     opt, args.eta_max)
        grads = {n: p.grad.detach().cpu().double()
                 for n, p in model.named_parameters() if p.grad is not None}
        stats = {k: v.detach().cpu().double()
                 for k, v in model.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}
        print(f"{name}: loss {float(loss):.12f}, {len(grads)} grads, "
              f"{len(stats)} BatchNorm statistics, {time.time() - t0:.1f} s")
        del model, engine, opt
        torch.cuda.empty_cache()
        return float(loss), grads, stats

    def max_dev(a, b):
        """The largest max|a - b| / max|b| over the tensors of b."""
        check(a.keys() == b.keys(), "the two steps differ in tensors")
        r = {n: float((a[n] - b[n]).abs().max()
                      / max(float(b[n].abs().max()), 1e-30)) for n in b}
        worst = max(r, key=r.get)
        return r[worst], worst

    prep32 = make_device_normalize_prep(torch.float32)
    l64c, g64c, s64c = step("card f64 --batchnorm", args_bn, "cuda",
                            torch.float64, host64, None)
    l64h, g64h, s64h = step("CPU f64 --batchnorm", args_bn, "cpu",
                            torch.float64, host64, None)
    check(any(n.startswith("fusion_layers.") and n.endswith(".2.weight")
              for n in g64h), "no head BatchNorm1d gradient in the "
          "--batchnorm step")
    loss64_rel = abs(l64c - l64h) / abs(l64h)
    grad64_dev, grad64_t = max_dev(g64c, g64h)
    stat64_dev, stat64_t = max_dev(s64c, s64h)
    print(f"card vs CPU, f64 --batchnorm: loss relative diff "
          f"{loss64_rel:.3e}; largest grad deviation {grad64_dev:.3e} of "
          f"max |grad| ({grad64_t}); largest BatchNorm statistic deviation "
          f"{stat64_dev:.3e} ({stat64_t})")
    check(loss64_rel <= 1e-4, f"f64 card vs CPU loss: relative diff "
          f"{loss64_rel}")
    check(grad64_dev <= 1e-3, f"f64 card vs CPU grad {grad64_t}: "
          f"{grad64_dev} of max |grad|")
    check(stat64_dev <= 1e-3, f"f64 card vs CPU statistic {stat64_t}: "
          f"{stat64_dev} of its max")

    lc, gc, _ = step("card f32", args, "cuda", torch.float32, host, prep32)
    lh, gh, _ = step("CPU f32", args, "cpu", torch.float32, host, prep32)
    _, g64, _ = step("CPU f64", args, "cpu", torch.float64, host64, None)
    check(gc.keys() == gh.keys() == g64.keys(), "grads differ in keys")
    names = sorted(g64)

    def norm_err(g):
        per = {n: float((g[n] - g64[n]).norm() / g64[n].norm().clamp_min(
            1e-30)) for n in names}
        whole = float(torch.cat([(g[n] - g64[n]).ravel() for n in names]
                                ).norm() / torch.cat(
            [g64[n].ravel() for n in names]).norm())
        return per, whole

    (pc, wc), (ph, wh) = norm_err(gc), norm_err(gh)
    loss_rel = abs(lc - lh) / abs(lh)
    dev_card, t_card = max_dev(gc, gh)
    dev_cpu, t_cpu = max_dev(gh, g64)
    ratio = {n: pc[n] / (10 * ph[n] + 1e-5) for n in names}
    worst = max(ratio, key=ratio.get)
    print(f"card vs CPU, f32: loss relative diff {loss_rel:.3e}; largest "
          f"grad deviation {dev_card:.3e} of max |grad| ({t_card}); CPU f32 "
          f"vs f64: {dev_cpu:.3e} ({t_cpu})")
    print(f"norm-wise error against f64: card {wc:.3e}, CPU f32 {wh:.3e} "
          f"(whole gradient); worst tensor {worst}: card {pc[worst]:.3e}, "
          f"CPU f32 {ph[worst]:.3e}")
    check(loss_rel <= 1e-4, f"card vs CPU loss: relative diff {loss_rel}")
    check(wc <= 2 * wh + 1e-6, f"card gradient error {wc} against f64 "
          f"exceeds twice the CPU f32's {wh}")
    check(ratio[worst] <= 1.0, f"card grad {worst}: error {pc[worst]} "
          f"against f64, CPU f32 {ph[worst]}")
    return {"f64_batchnorm": {"loss_rel": loss64_rel,
                              "grad_dev": grad64_dev,
                              "grad_dev_tensor": grad64_t,
                              "stat_dev": stat64_dev},
            "f32": {"loss_rel": loss_rel, "grad_dev": dev_card,
                    "grad_dev_tensor": t_card,
                    "cpu32_vs_f64_grad_dev": dev_cpu,
                    "norm_err_card": wc, "norm_err_cpu32": wh}}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "an NVIDIA card", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    from mfas_tpu_torch.ops import input_kernels as tk

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    phase("device")
    smi = nvidia_smi()
    print(smi)
    card_state("at start")
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {kind}, count {torch.cuda.device_count()}")

    phase("kernel build")
    t0 = time.time()
    tk.load_library()
    print(f"input kernels built/loaded in {time.time() - t0:.2f} s")
    log = tk.build_log() or ""
    for line in log.splitlines():
        if "ptxas info" in line:
            print(line.strip())

    err, ms = kernel_phases(torch, tk)
    torch.cuda.empty_cache()

    work = os.path.join(root, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        packed = write_store(work)
        runs = slice_phase(torch, work, packed)
        torch.cuda.empty_cache()
        train = training_phase(torch, work, packed)
        torch.cuda.empty_cache()
        warm = warm_train_steps(torch, work, packed)
        step = card_vs_cpu(torch, packed)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    print(json.dumps({"slice": {
        k: {"model_acc": r["acc"],
            "eval_clips_per_s_cold": r["cold_clips_per_s"],
            "eval_clips_per_s_warm": r["warm_clips_per_s"],
            "peak_bytes": r["peak_bytes"]} for k, r in runs.items()},
        "nvidia_smi": smi}))
    print(json.dumps({"training": train, "warm_train_steps": warm,
                      "card_vs_cpu_step": step, "nvidia_smi": smi}))
    src = "mfas_tpu_torch/csrc/input_kernels.cu"
    # launches: the training runs' counts, one per train, dev and test batch
    print(json.dumps({"kernels": [
        {"name": "u8_normalize", "route": "cuda", "source": src,
         "replaces": "mfas_tpu/ops/input_kernels.py:71",
         "launches": train["b_packed_f32"]["launches"],
         "max_abs_err": err["u8_normalize"], "ms": ms["f32"]["K1"],
         "plain_ms": ms["f32"]["K1_plain"]},
        {"name": "u8_gather_normalize", "route": "cuda", "source": src,
         "replaces": "mfas_tpu/ops/input_kernels.py:174",
         "launches": train["a_resident_f32"]["launches"],
         "max_abs_err": err["u8_gather_normalize"], "ms": ms["f32"]["K2"],
         "plain_ms": ms["f32"]["K2_plain"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
