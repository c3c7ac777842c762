"""Sweep precision, batch size and the convolution / pooling formulations
over the found-NTU train step on the card (port of tools/bf16_sweep.py;
the same variants).

    python -m mfas_tpu_torch.tools.bf16_sweep [variant ...]

Each variant builds the found net at conf [[3,1,1],[1,3,0],[1,1,1],[3,3,0]]
(multitask, no batchnorm, --drpt 0.4, --inner_representation_size 256,
--vid_len 8 32) from seed 0, with its inputs (B, 8, 256, 256, 3) RGB clips,
skeletons and labels from RandomState(0), and times whole-net train steps
(``mfas_tpu_torch.tools.profile_step``'s found_train: Adam at lr 1e-3):
INNER dependent steps per call, 1 warm-up call and 3 timed calls, each
fenced by ``torch.cuda.synchronize()``; the median call over INNER is the
step time. "bf16" is the engine's --bf16 autocast path; "chlast",
"3das2d" and "seppool" are core/functional.py's conv_channels_last (the
weights converted once), conv3d_as_2d and pool_separable, held while the
variant's steps run and put back after. TF32 is off, for cuDNN and for
matmul, while the sweep runs (put back after), so an "f32" variant
computes in float32. With no argument every variant runs; otherwise the
named ones.

Printed: one line per variant (its step time and clips/s, the first step's
loss, peak allocated memory and the calls each option's formulation took),
then one JSON dict {variant: {"step_s", "clips_per_s"}}. A variant that
runs out of device memory is recorded with its error instead, and the
command then exits 1.

From the command line it runs on CUDA and fails without it;
``main(argv, device="cpu")`` runs on the CPU (the tests, at a size they
choose).
"""

import json
import sys
import time

import numpy as np

INNER = 4       # dependent train steps per timed call
WARMUP = 1      # untimed calls
ITERS = 3       # timed calls
IMG = 256

# (name, batch, bf16, conv_channels_last, conv3d_as_2d, pool_separable)
VARIANTS = (
    ("f32_B16", 16, False, False, False, False),
    ("bf16_B16", 16, True, False, False, False),
    ("bf16_B16_chlast", 16, True, True, False, False),
    ("bf16_B32", 32, True, False, False, False),
    ("bf16_B32_chlast", 32, True, True, False, False),
    ("bf16_B16_3das2d", 16, True, False, True, False),
    ("f32_B16_3das2d", 16, False, False, True, False),
    ("bf16_B16_3das2d_chlast", 16, True, True, True, False),
    ("bf16_B16_seppool", 16, True, False, False, True),
    ("bf16_B32_seppool", 32, True, False, False, True),
    ("f32_B16_seppool", 16, False, False, False, True),
    ("bf16_B64", 64, True, False, False, False),
)


def run_variant(variant, device, img=IMG, arch=None, iters=ITERS):
    """Build and time one variant -> its record (step_s, clips_per_s,
    first_loss, peak_bytes, option_calls)."""
    import torch

    from mfas_tpu_torch.core import functional as F
    from mfas_tpu_torch.engine.classifier import _sync
    from mfas_tpu_torch.tools.profile_step import build

    name, B, bf16, chlast, as2d, psep = variant
    options = dict(conv_channels_last=chlast, conv3d_as_2d=as2d,
                   pool_separable=psep)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    step = build("found_train", B, img, bf16, device, arch=arch,
                 channels_last=chlast)
    calls_before = F.OPTION_CALLS.copy()

    def call():
        with F.layout_options(**options):
            losses = [step() for _ in range(INNER)]
        _sync(device)
        return losses

    first_loss = None
    for _ in range(WARMUP):
        losses = call()
        first_loss = float(losses[0]) if first_loss is None else first_loss
    times = []
    for _ in range(iters):
        _sync(device)
        t0 = time.perf_counter()
        losses = call()
        times.append((time.perf_counter() - t0) / INNER)
    last = float(losses[-1])
    if not (np.isfinite(first_loss) and np.isfinite(last)):
        raise RuntimeError(f"{name}: non-finite loss {first_loss}, {last}")
    t = float(np.median(times))
    calls = F.OPTION_CALLS - calls_before
    return {"step_s": t, "clips_per_s": B / t, "first_loss": first_loss,
            "peak_bytes": (torch.cuda.max_memory_allocated(device)
                           if on_card else None),
            "option_calls": dict(calls), "batch": B, "bf16": bf16,
            "options": options}


def main(argv=None, device=None, *, img=IMG, arch=None, iters=ITERS):
    """-> {variant: record} of the variants run (a failed one: {"error"}).
    ``img``, ``arch`` (profile_step.build's) and ``iters`` shrink the run
    for a test."""
    import torch

    from mfas_tpu_torch.runtime.cli import cli_device

    argv = sys.argv[1:] if argv is None else list(argv)
    known = [v[0] for v in VARIANTS]
    unknown = sorted(set(argv) - set(known))
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {known}")
    device = cli_device(device, "mfas_tpu_torch.tools.bf16_sweep")
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"bf16_sweep on {device} ({where}), img {img}, {INNER} steps per "
          f"call, {WARMUP} warm-up + {iters} timed calls; TF32 off",
          flush=True)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    try:
        for variant in VARIANTS:
            name = variant[0]
            if argv and name not in argv:
                continue
            try:
                r = run_variant(variant, device, img=img, arch=arch,
                                iters=iters)
            except torch.OutOfMemoryError as e:
                r = {"error": f"out of memory: {str(e).splitlines()[0]}"}
            results[name] = r
            print(name, r, flush=True)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    print(json.dumps({k: ({"step_s": r["step_s"],
                           "clips_per_s": r["clips_per_s"]}
                          if "error" not in r else r)
                      for k, r in results.items()}))
    return results


if __name__ == "__main__":
    sys.exit(1 if any("error" in r for r in main().values()) else 0)
