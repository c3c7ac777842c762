"""AV-MNIST found-architecture training through the port's
``main_found_avmnist`` (the system under test): its model and the engine
and loaders its CLI builds (``ClassifierEngine`` over ``ArrayLoader``s of
the train / dev rows of ``train_dev_split``), fed from host arrays.

The data follows the port's synthetic AV-MNIST distribution (the digit's
mean brightness carries the label), made from the seed on the card in
three calls and copied to host memory; the digit channel is normalized as
the port's array loader does at load time. Nothing is written to disk.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from perfbench.weights import sub_seed


def make_raw(cfg, traffic, seed, device):
    """dict(image (N,784), audio (N,112,112), label (N,)) on ``device``."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "data"))
    n = int(cfg["samples"])
    label = torch.randint(0, int(cfg["num_outputs"]), (n,), generator=gen,
                          device=device)
    audio = torch.rand((n, 112, 112), generator=gen, device=device) * 0.1
    image = (torch.rand((n, 784), generator=gen, device=device)
             + label[:, None] * 0.08)
    return {"image": image, "audio": audio, "label": label,
            "split": tuple(cfg["split"])}


def make_data(cfg, traffic, seed, device, workdir):
    from mfas_tpu_torch.data.avmnist import MNIST_MEAN, MNIST_STD

    raw = make_raw(cfg, traffic, seed, device)
    image = ((raw["image"] - MNIST_MEAN) / MNIST_STD).reshape(-1, 1, 28, 28)
    arrays = {"image": image.cpu().numpy(),
              "audio": raw["audio"][:, None].cpu().numpy(),
              "label": raw["label"].to(torch.int32).cpu().numpy()}
    del raw, image
    return {"arrays": arrays}


def build(cfg, traffic, data, weights, device):
    from mfas_tpu_torch import main_found_avmnist as ma
    from mfas_tpu_torch.core.sched import LRCosineAnnealingScheduler
    from mfas_tpu_torch.data.avmnist import train_dev_split
    from mfas_tpu_torch.data.loader import ArrayLoader
    from mfas_tpu_torch.engine.classifier import ClassifierEngine

    if traffic["precision"] != "float32":
        raise ValueError("the AV-MNIST CLI trains in float32 only")
    args = ma.parse_args(list(cfg["argv"]))
    for k in ("num_outputs", "channels", "batchsize",
              "inner_representation_size", "drpt", "eta_max", "eta_min",
              "Ti", "Tm"):
        if getattr(args, k) != cfg[k]:
            raise ValueError(f"--{k} {getattr(args, k)} is not the "
                             f"configuration's {cfg[k]}")
    with torch.device("meta"):
        model = ma.build_model(args, ma.FOUND_CONFS[args.conf], "meta")
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    arrays = data["arrays"]
    dev_lo, dev_hi = train_dev_split(arrays["image"].shape[0])
    if (dev_lo, dev_hi - dev_lo) != tuple(cfg["split"]):
        raise ValueError(f"split {(dev_lo, dev_hi - dev_lo)} is not the "
                         f"configuration's {cfg['split']}")
    loaders = {"train": ArrayLoader(arrays, args.batchsize, shuffle=True,
                                    indices=np.arange(0, dev_lo)),
               "dev": ArrayLoader(arrays, args.batchsize,
                                  indices=np.arange(dev_lo, dev_hi))}
    engine = ClassifierEngine(model, device, multitask=args.multitask,
                              input_keys=("image", "audio"))

    def scheduler(n_train):
        return LRCosineAnnealingScheduler(args.eta_max, args.eta_min,
                                          args.Ti, args.Tm,
                                          n_train / args.batchsize)

    def close():
        loaders.clear()
        data.clear()

    return types.SimpleNamespace(args=args, model=model, engine=engine,
                                 loaders=loaders, scheduler=scheduler,
                                 close=close)
