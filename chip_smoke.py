#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mfas_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. the device: nvidia-smi's name and power limit, torch and CUDA versions;
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
   frames; train 20, dev 20, test 50 so the last batch of 20 is ragged) and
   a torch.save'd checkpoint go through ``mfas_tpu_torch.main_found_ntu``
   with --device_input_normalize (K1) and with --hbm_resident (K2), each
   twice (cold, then warm); each run must launch its kernel and print a
   finite Model Acc, and the two paths' fused logits must agree; the first
   two test clips are checked against the same net on the CPU.

TF32 is off throughout. Any failed check exits non-zero. The line before
the last is {"kernels": [...]} with the measured numbers; the last line is
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


def slice_phase(torch, work):
    import numpy as np

    from mfas_tpu_torch import main_found_ntu as tmain
    from mfas_tpu_torch.data.ntu import Compose, NormalizeLen
    from mfas_tpu_torch.data.ntu_pack import (PackedNTU,
                                              make_device_normalize_prep,
                                              make_synthetic_packed_ntu)
    from mfas_tpu_torch.engine.classifier import valid_rows
    from mfas_tpu_torch.fusion.ntu import Searchable_Skeleton_Image_Net
    from mfas_tpu_torch.ops import input_kernels as tk

    phase("found-NTU --test_cp slice, full width")
    packed = os.path.join(work, "packed")
    t0 = time.time()
    for seed, (split, n) in enumerate((("train", 20), ("dev", 20),
                                       ("test", 50))):
        make_synthetic_packed_ntu(os.path.join(packed, split), n=n,
                                  frames=24, h=256, w=256, skel_frames=300,
                                  num_classes=60, seed=seed)
    print(f"synthetic packed store written in {time.time() - t0:.1f} s")
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
            acc, rec = tmain.main(argv + [flag])
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
        runs = slice_phase(torch, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    src = "mfas_tpu_torch/csrc/input_kernels.cu"
    print(json.dumps({"kernels": [
        {"name": "u8_normalize", "route": "cuda", "source": src,
         "replaces": "mfas_tpu/ops/input_kernels.py:71",
         "launches": runs["packed"]["counts"]["u8_normalize"],
         "max_abs_err": err["u8_normalize"], "ms": ms["f32"]["K1"],
         "plain_ms": ms["f32"]["K1_plain"]},
        {"name": "u8_gather_normalize", "route": "cuda", "source": src,
         "replaces": "mfas_tpu/ops/input_kernels.py:174",
         "launches": runs["resident"]["counts"]["u8_gather_normalize"],
         "max_abs_err": err["u8_gather_normalize"], "ms": ms["f32"]["K2"],
         "plain_ms": ms["f32"]["K2_plain"]},
    ]}))
    print(json.dumps({"slice": {
        k: {"model_acc": r["acc"],
            "eval_clips_per_s_cold": r["cold_clips_per_s"],
            "eval_clips_per_s_warm": r["warm_clips_per_s"],
            "peak_bytes": r["peak_bytes"]} for k, r in runs.items()},
        "nvidia_smi": smi}))
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
