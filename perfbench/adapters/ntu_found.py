"""NTU RGB+D found-architecture training through the port's
``main_found_ntu`` (the system under test): its model, its resident-store
loaders (``get_dataloaders``) and its engine (``make_engine``, K2 as the
prep), at the configuration's flags.

The data is a packed store made from the seed on the card and written
under ``TMPDIR``: uint8 clips of ``frames_stored`` frames at
``vid_dim``^2 and float32 skeletons of up to ``max_skel_frames`` frames
(valid lengths drawn per clip), with a class signal in both (the label
adds to the pixels and, scaled, to the joints).
"""

from __future__ import annotations

import json
import os
import types

import numpy as np
import torch

from perfbench.weights import sub_seed


def make_raw(cfg, traffic, seed, device):
    """{split: dict(rgb (n,F,H,W,3) uint8, ske (n,3,S,25,2) f32, ske_len
    (n,) numpy, labels (n,), frames)} on ``device``, from the seed, for the
    splits and clip counts of the traffic's ``store_clips``. A split named
    in the traffic's ``one_clip_per_class`` holds one clip of each class,
    in an order drawn from the seed."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "data"))
    C = int(cfg["num_outputs"])
    F, H = int(cfg["frames_stored"]), int(cfg["vid_dim"])
    S = int(cfg["max_skel_frames"])
    out = {}
    for split, n in traffic["store_clips"].items():
        if split in traffic.get("one_clip_per_class", ()):
            if n != C:
                raise ValueError(f"{split}: one clip per class needs {C}")
            labels = torch.randperm(C, generator=gen, device=device)
        else:
            labels = torch.randint(0, C, (n,), generator=gen, device=device)
        rgb = torch.randint(0, 256 - C, (n, F, H, H, 3), generator=gen,
                            device=device, dtype=torch.uint8)
        rgb += labels.to(torch.uint8).view(-1, 1, 1, 1, 1)
        ske_len = torch.randint(int(cfg["min_skel_frames"]), S + 1, (n,),
                                generator=gen, device=device)
        ske = (torch.randn((n, 3, S, 25, 2), generator=gen, device=device)
               * 0.3 + labels.view(-1, 1, 1, 1, 1) * 0.01)
        valid = (torch.arange(S, device=device).view(1, 1, S, 1, 1)
                 < ske_len.view(-1, 1, 1, 1, 1))
        out[split] = {"rgb": rgb, "ske": ske * valid,
                      "ske_len": ske_len.cpu().numpy().astype(np.int32),
                      "labels": labels, "frames": F}
    return out


def make_data(cfg, traffic, seed, device, workdir):
    """The packed store (``pack_ntu``'s layout) under ``workdir``."""
    raw = make_raw(cfg, traffic, seed, device)
    for split, d in raw.items():
        path = os.path.join(workdir, split)
        os.makedirs(path)
        np.save(os.path.join(path, "rgb.npy"), d["rgb"].cpu().numpy())
        np.save(os.path.join(path, "ske.npy"), d["ske"].cpu().numpy())
        np.save(os.path.join(path, "ske_len.npy"), d["ske_len"])
        np.save(os.path.join(path, "labels.npy"),
                d["labels"].cpu().numpy().astype(np.int32))
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"n": len(d["ske_len"]), "frames": d["frames"],
                       "h": int(cfg["vid_dim"]), "w": int(cfg["vid_dim"]),
                       "max_skel_frames": int(cfg["max_skel_frames"]),
                       "stage": split}, f)
    del raw
    return {"dir": workdir}


def _check_args(args, cfg):
    want = {"num_outputs": cfg["num_outputs"], "batchsize": cfg["batchsize"],
            "inner_representation_size": cfg["inner_representation_size"],
            "drpt": cfg["drpt"], "batchnorm": cfg["batchnorm"],
            "vid_len": tuple(cfg["vid_len"]), "eta_max": cfg["eta_max"],
            "eta_min": cfg["eta_min"], "Ti": cfg["Ti"], "Tm": cfg["Tm"],
            "resnet3d_layers": tuple(cfg["resnet3d_layers"]),
            "resnet3d_base_width": cfg["resnet3d_base_width"]}
    got = {k: (tuple(v) if isinstance(v, (list, tuple)) else v)
           for k, v in ((k, getattr(args, k)) for k in want)}
    if got != want:
        raise ValueError(f"the CLI's arguments {got} are not the "
                         f"configuration's {want}")


def build(cfg, traffic, data, weights, device):
    """The program: args, model (weights loaded), loaders, engine."""
    from mfas_tpu_torch import main_found_ntu as mf
    from mfas_tpu_torch.core.sched import LRCosineAnnealingScheduler

    argv = list(cfg["argv"]) + ["--packed_datadir", data["dir"]]
    if traffic["precision"] == "bfloat16":
        argv.append("--bf16")
    args = mf.parse_args(argv)
    _check_args(args, cfg)
    with torch.device("meta"):
        model = mf.build_model(args, mf.FOUND_CONFS[args.conf], "meta")
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    loaders = mf.get_dataloaders(args, device)
    engine = mf.make_engine(model, args, device, None,
                            loaders["train"].store)

    def scheduler(n_train):
        return LRCosineAnnealingScheduler(args.eta_max, args.eta_min,
                                          args.Ti, args.Tm,
                                          n_train / args.batchsize)

    def close():
        loaders.clear()

    return types.SimpleNamespace(args=args, model=model, engine=engine,
                                 loaders=loaders, scheduler=scheduler,
                                 close=close)
