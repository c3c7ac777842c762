"""Profile a train step or a forward on the card and print where the time
goes (port of tools/profile_step.py; same flags and workloads).

    python -m mfas_tpu_torch.tools.profile_step --what found_train --bf16
    python -m mfas_tpu_torch.tools.profile_step --what visual_fwd \\
        --batch 16 --img 256

``found_train`` is one ``ClassifierEngine`` train step (multitask, Adam at
lr 1e-3, the whole net trainable) of the found NTU net at conf
[[3,1,1],[1,3,0],[1,1,1],[3,3,0]] (--inner_representation_size 256, no
batchnorm, --drpt 0.4) on an f32 RGB clip (B, 8, img, img, 3), a skeleton
(B, 3, 32, 25, 2) and labels, all drawn from RandomState(0); --bf16 runs it
under the engine's --bf16 path. ``visual_fwd`` is the eval forward of the
RGB backbone (models/ntu.py::Visual), with bf16 weights under --bf16.

WARMUP iterations run first; then INNER iterations run inside one
torch.profiler session with the card's activity (the JAX tool scans INNER
iterations in one compiled program). The train step is the engine's
``train_step``, as the CLIs run it: on the card a replay of the CUDA graph
the first warm-up iteration captured (engine/classifier.py). Printed: wall
ms/iter; device-busy ms/iter, the union of the kernels' intervals, so wall
minus busy is host dispatch; self device time per framework (aten) op from
``key_averages()``, the counterpart of the JAX tool's HLO ``op_name``
attribution (a graph's kernels run with no aten op on the host, so for a
replayed step it lists only the ops outside the graph: the batch copied
into the graph's inputs, the outputs' clones); device time by kernel class
(runtime/profiler.py::KERNEL_CLASSES); the top kernels; and whether TF32 is
on for matmul and for cuDNN. The tool leaves torch's TF32
settings as it finds them, as the port's CLIs do, and says which it ran.

From the command line it runs on CUDA and fails without it; ``main(argv,
device="cpu")`` runs on the CPU, where the summary lists the CPU ops by
self CPU time and zero kernels.
"""

import argparse
import os
import tempfile
import time
import types

import numpy as np

INNER = 4       # profiled iterations
WARMUP = 2      # iterations before the profiled ones
TOP_OPS = 15    # framework ops listed
FOUND_CONF = [[3, 1, 1], [1, 3, 0], [1, 1, 1], [3, 3, 0]]


def _args(**kw):
    d = dict(num_outputs=60, vid_len=(8, 32), drpt=0.4,
             inner_representation_size=256, multitask=True, alphas=False,
             batchnorm=False, num_classes=60)
    d.update(kw)
    return types.SimpleNamespace(**d)


def build(what, B, img, bf16, device, arch=None, channels_last=False):
    """-> a function that runs one iteration of ``what`` and returns a
    scalar tensor of its result. ``arch``: overrides of the found net's
    arguments (``resnet3d_layers``, ``resnet3d_base_width``: the shrink
    knobs of a test); ``channels_last``: the found net's weights in
    channels-last memory format (core/layers.py::to_channels_last)."""
    import torch

    rs = np.random.RandomState(0)
    gen = torch.Generator().manual_seed(0)

    if what == "visual_fwd":
        from mfas_tpu_torch.models.ntu import Visual

        args = _args(drpt=0.0, multitask=False)
        vis = Visual(args, device=device, generator=gen).eval()
        dt = torch.bfloat16 if bf16 else torch.float32
        vis.to(dt)
        rgb = torch.as_tensor(
            rs.randn(B, args.vid_len[0], img, img, 3).astype(np.float32)
        ).to(device=device, dtype=dt)

        @torch.no_grad()
        def fwd():
            return vis(rgb)[-1].float().sum()

        return fwd

    from mfas_tpu_torch.engine.classifier import (ClassifierEngine,
                                                  set_trainable)
    from mfas_tpu_torch.fusion.ntu import Searchable_Skeleton_Image_Net

    args = _args(**(arch or {}))
    model = Searchable_Skeleton_Image_Net(args, np.array(FOUND_CONF),
                                          device=device, generator=gen)
    if channels_last:
        from mfas_tpu_torch.core.layers import to_channels_last
        to_channels_last(model)
    engine = ClassifierEngine(
        model, device, multitask=True, input_keys=("rgb", "ske"),
        compute_dtype=torch.bfloat16 if bf16 else None)
    engine.generator.manual_seed(0)
    set_trainable(model, None)
    model.train()
    opt = engine.make_optimizer()
    batch = {"rgb": torch.as_tensor(rs.randn(B, args.vid_len[0], img, img,
                                             3), dtype=torch.float32),
             "ske": torch.as_tensor(rs.randn(B, 3, 32, 25, 2),
                                    dtype=torch.float32),
             "label": torch.as_tensor(rs.randint(0, 60, B),
                                      dtype=torch.int32),
             "_mask": torch.ones(B)}
    batch = {k: v.to(device) for k, v in batch.items()}

    def train_step():
        loss, _ = engine.train_step(batch, opt, 1e-3)
        return loss

    return train_step


def op_times(prof, on_card):
    """(name, self µs over the session) of each aten op with self time:
    device time on the card, CPU time on the CPU. Only aten ops count: the
    profiler also hands device time to runtime events such as "Command
    Buffer Full", whose kernels their aten op already holds."""
    attr = "self_device_time_total" if on_card else "self_cpu_time_total"
    ops = [(e.key, getattr(e, attr)) for e in prof.key_averages()
           if e.key.startswith("aten::") and getattr(e, attr) > 0]
    return sorted(ops, key=lambda kv: -kv[1])


def profile(step, device):
    """WARMUP untraced iterations, then INNER under torch.profiler -> the
    summary dict (times per iteration)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from mfas_tpu_torch.engine.classifier import _sync
    from mfas_tpu_torch.runtime.profiler import profile_summary

    on_card = device.type == "cuda"
    for _ in range(WARMUP):
        float(step())
    _sync(device)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(INNER):
            out = step()
        _sync(device)
        wall = time.perf_counter() - t0
    if not torch.isfinite(out):
        raise RuntimeError(f"profile_step: non-finite result {float(out)}")
    with tempfile.TemporaryDirectory(prefix="mfas_prof_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        summary = profile_summary(path, steps=INNER)
    ops = op_times(prof, on_card)
    total = sum(t for _, t in ops) or 1.0
    per = 1e3 * INNER              # profiler times are µs
    return {"wall_ms": wall * 1e3 / INNER,
            "busy_ms": summary.get("device_busy_ms", 0.0),
            "kernels_per_iter": summary.get("kernels_per_step", 0),
            "by_class_ms": summary.get("by_class_ms", {}),
            "top_ms": summary.get("top_ms", []),
            "by_op_ms": [[n, t / per, t / total] for n, t in ops[:TOP_OPS]]}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--what", choices=("found_train", "visual_fwd"),
                   default="found_train")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--img", type=int, default=256)
    p.add_argument("--bf16", action="store_true", default=False)
    return p.parse_args(argv)


def main(argv=None, device=None):
    """-> the printed summary as a dict."""
    import torch

    from mfas_tpu_torch.runtime.cli import cli_device

    a = parse_args(argv)
    device = cli_device(device, "mfas_tpu_torch.tools.profile_step")
    on_card = device.type == "cuda"
    tf32 = {"matmul": bool(torch.backends.cuda.matmul.allow_tf32),
            "cudnn": bool(torch.backends.cudnn.allow_tf32)}
    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    r = profile(build(a.what, a.batch, a.img, a.bf16, device), device)
    r.update(what=a.what, bf16=a.bf16, batch=a.batch, img=a.img,
             device=name, tf32=tf32)
    print(f"profile_step: {a.what} {'bf16' if a.bf16 else 'f32'}, "
          f"B={a.batch}, img {a.img}, on {device} ({name}); TF32 "
          f"{'on' if tf32['matmul'] else 'off'} for matmul, "
          f"{'on' if tf32['cudnn'] else 'off'} for cuDNN")
    print(f"wall {r['wall_ms']:.2f} ms/iter, device busy "
          f"{r['busy_ms']:.2f} ms/iter (host dispatch = the difference), "
          f"{r['kernels_per_iter']:.0f} kernels/iter")
    held = sum(ms for _, ms, _ in r["by_op_ms"])
    print(f"\nby framework op (self {'device' if on_card else 'CPU'} "
          f"ms/iter; these {len(r['by_op_ms'])} hold {held:.2f} ms"
          + (f" of {sum(r['by_class_ms'].values()):.2f} ms of kernel time"
             if on_card else "") + "):")
    for n, ms, share in r["by_op_ms"]:
        print(f"{ms:8.3f}  {share * 100:5.1f}%  {n}")
    print("\ndevice time by kernel class (ms/iter):")
    for c, ms in r["by_class_ms"].items():
        print(f"{ms:8.3f}  {c}")
    print("\ntop kernels (ms/iter):")
    for n, ms in r["top_ms"]:
        print(f"{ms:8.3f}  {n}")
    return r


if __name__ == "__main__":
    main()
