"""One-command real-data parity kit for the NTU headline runs (port of
tools/parity_kit.py; same flags, checks and return codes).

The reference's published accuracy channel is its README command and the
released checkpoints: the 0.9134 ``--conf 4`` eval, the paper-conf eval,
and the checkpoint bundle with ``skeleton_32frames_85.24.checkpoint`` /
``rgb_8frames_83.91.checkpoint`` backbones. This kit makes that run turnkey
once the NTU data and the released files exist:

    python -m mfas_tpu_torch.tools.parity_kit --datadir /data/NTU \\
        --checkpointdir /data/NTU/checkpoints

checks every precondition (dataset layout and split counts, each released
checkpoint loadable through the torch-format reader and shape-matched
against the port's models, optionally a converter output) and prints the
port's commands for the 0.9134 eval, the found-arch training run and the
search run, plus the card's production variants (packed store,
--hbm_resident --bf16, --cache_features). Prints ``[READY]`` and returns 0
when every check passes, ``[NOT READY]`` and 1 when one fails, and 2 without
--datadir and --checkpointdir.

A dry run against fixtures it writes itself (needs cv2):

    python -m mfas_tpu_torch.tools.parity_kit --synthetic /tmp/kitcheck

A host check: the model templates are built on the CPU, and no device is
touched.
"""

import argparse
import os
import sys
import types

import numpy as np

# the reference README's released-artifact names
BEST_CP = "best_3_1_1_1_3_0_1_1_1_3_3_0_0.9134.checkpoint"
PAPER_CP = ("conf_[[3_0_0]_[1_3_0]_[1_1_1]_[3_3_0]]_both_"
            "0.896888457572633.checkpoint")
SKE_CP = "skeleton_32frames_85.24.checkpoint"
RGB_CP = "rgb_8frames_83.91.checkpoint"

# NTU RGB+D cross-subject protocol: 40 subjects, 60 actions; the full
# dataset is 56880 clips (minus 302 bad skeletons)
FULL_TOTAL = 56880


def _model_args(a):
    return types.SimpleNamespace(
        num_outputs=a.num_outputs, vid_len=tuple(a.vid_len), drpt=0.0,
        inner_representation_size=a.inner_representation_size,
        multitask=True, alphas=False, batchnorm=a.batchnorm,
        resnet3d_layers=tuple(a.resnet3d_layers),
        resnet3d_base_width=a.resnet3d_base_width)


def _found_net(args):
    """The found net of ``--conf`` on the CPU, initial weights from seed 0."""
    import torch

    from mfas_tpu_torch.fusion.ntu import Searchable_Skeleton_Image_Net
    from mfas_tpu_torch.main_found_ntu import FOUND_CONFS

    return Searchable_Skeleton_Image_Net(
        _model_args(args), FOUND_CONFS[args.conf], device="cpu",
        generator=torch.Generator().manual_seed(0))


def check_dataset(datadir, vid_dim=256, vid_fr=30, out=print):
    """Layout + per-split counts for the AVI/skeleton directory pair."""
    from mfas_tpu_torch.data.ntu import SPLITS

    ok = True
    rgb_dir = os.path.join(datadir,
                           f"nturgbd_rgb/avi_{vid_dim}x{vid_dim}_{vid_fr}")
    ske_dir = os.path.join(datadir, "nturgbd_skeletons")
    for d, what in ((rgb_dir, "AVI clips"), (ske_dir, "skeleton files")):
        if not os.path.isdir(d):
            out(f"[FAIL] {what}: directory missing: {d}")
            ok = False
    if not ok:
        return False, {}
    avis = [f for f in sorted(os.listdir(rgb_dir)) if f.endswith(".avi")]
    skes = [f for f in sorted(os.listdir(ske_dir))
            if f.endswith(".skeleton")]
    if not avis:
        out(f"[FAIL] no .avi files under {rgb_dir}")
        return False, {}

    # the SxxxCxxxPxxxRxxxAxxx scheme is what data/ntu.py parses subject
    # and label from: a stray nonconforming file is a [FAIL] line, not a
    # ValueError out of the checker
    def _subject(f):
        try:
            return int(f[9:12])
        except ValueError:
            return None
    bad_names = [f for f in avis if _subject(f) is None]
    if bad_names:
        out(f"[FAIL] {len(bad_names)} .avi files don't follow the "
            f"SxxxCxxxPxxxRxxxAxxx naming the loader parses (first: "
            f"{bad_names[0]!r}) — remove or rename them")
        ok = False
        avis = [f for f in avis if _subject(f) is not None]
    counts = {}
    for stage, subjects in SPLITS.items():
        n = sum(1 for f in avis if _subject(f) in subjects)
        counts[stage] = n
        if n == 0:
            out(f"[FAIL] split '{stage}' has 0 clips (subjects {subjects} "
                "absent) — check the cross-subject file naming "
                "SxxxCxxxPxxxRxxxAxxx_rgb.avi")
            ok = False
    stems_a = {f[:20] for f in avis}
    stems_s = {f[:20] for f in skes}
    unpaired = len(stems_a - stems_s)
    if unpaired:
        out(f"[warn] {unpaired} clips have no .skeleton pair (they will "
            "pair positionally after sorting — verify the lists align)")
    out(f"[{'ok' if ok else 'FAIL'}] dataset: {len(avis)} AVIs / "
        f"{len(skes)} skeletons at {vid_dim}x{vid_dim}_{vid_fr}; splits "
        + ", ".join(f"{k}={v}" for k, v in counts.items())
        + (f" (full NTU = {FULL_TOTAL} clips)"
           if len(avis) < FULL_TOTAL else ""))
    return ok, counts


def _shape_check(flat, template, label, out=print):
    """``flat`` (a loaded checkpoint) against ``template`` (a module's
    state_dict): the same keys, each of the same shape."""
    missing = [k for k in template if k not in flat]
    unexpected = [k for k in flat if k not in template]
    bad_shape = [k for k in template if k in flat
                 and tuple(flat[k].shape) != tuple(template[k].shape)]
    if missing or unexpected or bad_shape:
        out(f"[FAIL] {label}: missing={missing[:3]} "
            f"unexpected={unexpected[:3]} shape-mismatch="
            + str([(k, tuple(flat[k].shape), tuple(template[k].shape))
                   for k in bad_shape[:3]]))
        return False
    n = sum(int(v.numel()) for v in flat.values())
    out(f"[ok] {label}: {len(flat)} tensors / {n:,} params, all shapes "
        "match the model")
    return True


def check_checkpoints(checkpointdir, args, out=print):
    """Load every released checkpoint present through the torch-format
    reader (zip and legacy stream) and shape-check it against the conf
    model and the backbones."""
    from mfas_tpu_torch.runtime import checkpoint as ckpt

    net = _found_net(args)
    ok, any_found = True, False
    for name, template, what in (
            (args.test_cp or BEST_CP, net.state_dict(),
             f"full net (--conf {args.conf})"),
            (args.ske_cp or SKE_CP, net.skenet.state_dict(),
             "skeleton backbone"),
            (args.rgb_cp or RGB_CP, net.rgbnet.state_dict(),
             "RGB backbone")):
        path = os.path.join(checkpointdir, name)
        if not os.path.exists(path):
            out(f"[missing] {what}: {path} — download the released bundle "
                "(reference README Google-Drive link) into "
                f"{checkpointdir}")
            ok = False
            continue
        any_found = True
        try:
            flat = ckpt.load_state_dict(path)
        except Exception as e:              # noqa: BLE001 — report, don't die
            out(f"[FAIL] {what}: reader error on {path}: {e}")
            ok = False
            continue
        ok &= _shape_check(flat, template, f"{what} ({name})", out=out)
    if ok and any_found:
        out("[ok] all released checkpoints load and shape-match")
    return ok


def check_converter(converted, out=print):
    """Optional: a torchvision-converted ImageNet init for from-scratch
    backbone training (``mfas_tpu_torch.tools.convert_torchvision
    resnet50_inflate``)."""
    import torch

    from mfas_tpu_torch.models.resnet3d import inflated_resnet50
    from mfas_tpu_torch.runtime import checkpoint as ckpt

    if not os.path.exists(converted):
        out(f"[missing] converted ImageNet init: {converted} — run "
            "`python -m mfas_tpu_torch.tools.convert_torchvision "
            "resnet50_inflate --src resnet50-19c8e357.pth --dst "
            f"{converted}` wherever the torchvision file exists")
        return False
    flat = ckpt.load_state_dict(converted)
    template = inflated_resnet50(
        device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
    return _shape_check(flat, template, "converted ResNet-50 init", out=out)


def emit_commands(args, out=print):
    d, c = args.datadir, args.checkpointdir
    found = "python -m mfas_tpu_torch.main_found_ntu"
    size_flags = (f"--inner_representation_size "
                  f"{args.inner_representation_size}"
                  + (" --batchnorm" if args.batchnorm else ""))
    out("\n== commands (reference README equivalents) ==")
    out("# 1. eval the released best-found net (expected Model Acc "
        "~0.9134):")
    out(f"{found} --datadir {d} --checkpointdir {c} "
        f"--test_cp {args.test_cp or BEST_CP} --conf {args.conf} "
        f"{size_flags}")
    out("# 2. eval the paper architecture (expected ~0.8969):")
    out(f"{found} --datadir {d} --checkpointdir {c} --test_cp {PAPER_CP}")
    out("# 3. retrain the found arch from the released backbones "
        "(two-phase central->full recipe, reference defaults):")
    out(f"{found} --datadir {d} --checkpointdir {c} --conf {args.conf} "
        f"{size_flags} --epochs 30 --save_checkpoint")
    out("# 3b. the card's production variant (packed store copied to the "
        "card once, batches gathered and normalized there, bf16 steps):")
    out(f"python -m mfas_tpu_torch.tools.pack_ntu --datadir {d} --out "
        f"{d}/packed --stages train dev test")
    out(f"{found} --datadir {d} --packed_datadir {d}/packed --checkpointdir "
        f"{c} --conf {args.conf} {size_flags} --epochs 30 --hbm_resident "
        "--bf16 --save_checkpoint")
    out("# 4. run the search itself (reference hyperparameters; "
        "--cache_features extracts each sample's frozen-backbone "
        "features once for the whole search):")
    out(f"python -m mfas_tpu_torch.main_searchable_ntu --datadir {d} "
        f"--checkpointdir {c} --epochs 3 --search_iterations 10 "
        "--num_samples 15 --cache_features")
    out("# each command resumes after interruption via --train_state/"
        "--resume (3) or --search_state/--resume_search (4); see "
        "docs/PARITY.md")


def write_ntu_fixture(root, subjects=(1, 2, 3), n_actions=3, frames=12,
                      dim=32):
    """A tiny raw NTU layout: one MJPG AVI of random frames and one
    skeleton file per (subject, action). Subjects 1, 2 and 3 put clips in
    the train, dev and test splits."""
    import cv2

    rgb_dir = os.path.join(root, "nturgbd_rgb", "avi_256x256_30")
    ske_dir = os.path.join(root, "nturgbd_skeletons")
    os.makedirs(rgb_dir, exist_ok=True)
    os.makedirs(ske_dir, exist_ok=True)
    rs = np.random.RandomState(0)
    for s in subjects:
        for a in range(1, n_actions + 1):
            name = f"S001C001P{s:03d}R001A{a:03d}"
            vw = cv2.VideoWriter(os.path.join(rgb_dir, f"{name}_rgb.avi"),
                                 cv2.VideoWriter_fourcc(*"MJPG"), 30,
                                 (dim, dim))
            for _ in range(frames):
                vw.write(rs.randint(0, 255, (dim, dim, 3), np.uint8))
            vw.release()
            lines = [str(frames)]
            for _ in range(frames):
                lines += ["1", "pid 0 0 0 0 0 0 0 0 1", "25"]
                for _ in range(25):
                    x, y, z = rs.randn(3) * 0.1
                    lines.append(f"{x:.4f} {y:.4f} {z:.4f} 0 0 0 0 0 0 0 0 2")
            with open(os.path.join(ske_dir, f"{name}.skeleton"), "w") as f:
                f.write("\n".join(lines) + "\n")


def build_synthetic(root, out=print):
    """Tiny fixtures exercising every check: an AVI/skeleton pair tree and
    torch-format checkpoints in both container formats (the zip one, and
    the legacy stream the released 2019 files use)."""
    import torch

    from mfas_tpu_torch.runtime import checkpoint as ckpt

    os.makedirs(root, exist_ok=True)
    write_ntu_fixture(root)
    cdir = os.path.join(root, "checkpoints")
    os.makedirs(cdir, exist_ok=True)

    a = _parse([])                       # defaults, then shrink
    a.num_outputs, a.inner_representation_size = 3, 8
    a.vid_len = [2, 32]
    a.resnet3d_layers, a.resnet3d_base_width = [1, 1, 1, 1], 16
    a.batchnorm = False
    net = _found_net(a)
    ckpt.save(net.state_dict(), os.path.join(cdir, BEST_CP))
    ckpt.save(net.rgbnet.state_dict(), os.path.join(cdir, RGB_CP))
    torch.save({k: v.detach().clone() for k, v
                in net.skenet.state_dict().items()},
               os.path.join(cdir, SKE_CP),
               _use_new_zipfile_serialization=False)
    out(f"[synthetic] fixture + checkpoints under {root}")
    return a, cdir


def _parse(argv):
    p = argparse.ArgumentParser(
        description="check real-data parity-run preconditions and emit "
                    "the exact commands")
    p.add_argument("--datadir", type=str, default="")
    p.add_argument("--checkpointdir", type=str, default="")
    p.add_argument("--synthetic", type=str, default="",
                   help="build tiny fixtures under this dir and run the "
                        "checks against them (no real data needed)")
    p.add_argument("--vid_dim", type=int, default=256)
    p.add_argument("--vid_fr", type=int, default=30)
    p.add_argument("--conf", type=int, default=4)
    p.add_argument("--num_outputs", type=int, default=60)
    p.add_argument("--inner_representation_size", type=int, default=128)
    p.add_argument("--batchnorm", action="store_true", default=True)
    p.add_argument("--no_batchnorm", dest="batchnorm",
                   action="store_false")
    p.add_argument("--vid_len", type=int, nargs="+", default=[8, 32])
    p.add_argument("--resnet3d_layers", type=int, nargs=4,
                   default=[3, 4, 6, 3])
    p.add_argument("--resnet3d_base_width", type=int, default=64)
    p.add_argument("--test_cp", type=str, default="")
    p.add_argument("--ske_cp", type=str, default="")
    p.add_argument("--rgb_cp", type=str, default="")
    p.add_argument("--converted_init", type=str, default="",
                   help="also check a convert_torchvision resnet50_inflate "
                        "output at this path")
    return p.parse_args(argv)


def main(argv=None):
    args = _parse(sys.argv[1:] if argv is None else argv)
    if args.synthetic:
        root = args.synthetic
        args, cdir = build_synthetic(root)
        args.datadir, args.checkpointdir = root, cdir
        args.vid_dim = 256               # fixture dir name uses 256x256_30
    if not args.datadir or not args.checkpointdir:
        print("pass --datadir and --checkpointdir (or --synthetic DIR); "
              "see --help")
        return 2
    ok, _ = check_dataset(args.datadir, args.vid_dim, args.vid_fr)
    ok &= check_checkpoints(args.checkpointdir, args)
    if args.converted_init:
        ok &= check_converter(args.converted_init)
    if ok:
        print("[READY] all preconditions pass — run:")
        emit_commands(args)
        return 0
    print("[NOT READY] fix the [FAIL]/[missing] items above; commands "
          "that will work once they pass:")
    emit_commands(args)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
