"""Frozen plain-PyTorch reference of the MFAS AV-MNIST found network
(Perez-Rua et al., MFAS, CVPR 2019, arXiv:1903.06496; the upstream
``main_found_avmnist.py`` and ``models/auxiliary/avmnist.py``).

  * image net GP_LeNet on 28x28 digits: 3 stages of conv (5/3/3, no bias)
    + BatchNorm + ReLU, a 2x2 max pool after each; its taps are the global
    means of each stage's activation before the pool;
  * audio net GP_LeNet_Deeper on 112x112 spectrograms: 5 such stages; tap 1
    is the mean after stage 1's pool, taps 2-5 before their pools (an
    upstream quirk);
  * each net classifies its deepest tap with a Linear;
  * the fusion head (``_plain.fusion_head``) over rows [audio tap, image
    tap, activation] of the found configuration.

Inputs are built from the raw arrays the benchmark made: the digit is
normalized with MNIST's (0.1307, 0.3081), the spectrogram is used as it is.
The first train batches are the rows the upstream loader visits: a
``RandomState(0)`` shuffle of the train rows.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import _plain as P

MNIST_MEAN, MNIST_STD = 0.1307, 0.3081

# the output layers, whose leaves the multitask loss reaches first
HEADS = ("central_classifier.", "rgbnet.classifier.", "audnet.classifier.")


def _widths(cfg):
    ch = int(cfg["channels"])
    return [ch, 2 * ch, 4 * ch], [ch, 2 * ch, 4 * ch, 8 * ch, 16 * ch]


def param_specs(cfg):
    image_w, audio_w = _widths(cfg)
    n_out = int(cfg["num_outputs"])
    specs = []
    for net, widths in (("rgbnet", image_w), ("audnet", audio_w)):
        prev = 1
        for i, w in enumerate(widths, start=1):
            k = 5 if i == 1 else 3
            specs += P.conv_spec(f"{net}.conv{i}", w, prev, (k, k), False)
            specs += P.bn_spec(f"{net}.bn{i}", w)
            prev = w
        specs += P.linear_spec(f"{net}.classifier.0", n_out, prev)
    conf = np.asarray(cfg["conf"]).tolist()
    specs += P.fusion_head_specs(conf, audio_w, image_w,
                                 int(cfg["inner_representation_size"]),
                                 n_out, batchnorm=False)
    return specs


def _lenet(params, net, x, stages, post_pool_first, prec):
    taps, out = [], x
    for i in range(1, stages + 1):
        w = params[f"{net}.conv{i}.weight"]
        a = P.conv(prec, out, w, padding=w.shape[-1] // 2)
        a = torch.relu(P.batch_norm_train(a, params[f"{net}.bn{i}.weight"],
                                          params[f"{net}.bn{i}.bias"]))
        out = torch.nn.functional.max_pool2d(a, 2)
        tap = out if (post_pool_first and i == 1) else a
        taps.append(tap.mean(dim=(2, 3)))
    logits = P.linear(prec, taps[-1], params[f"{net}.classifier.0.weight"],
                      params[f"{net}.classifier.0.bias"])
    return logits, taps


def forward(params, inputs, cfg, masks, prec=P.FLOAT32):
    """Train-mode forward -> (fused logits, image logits, audio logits)."""
    image, audio = inputs
    image_logits, image_taps = _lenet(params, "rgbnet", image, 3, False,
                                      prec)
    audio_logits, audio_taps = _lenet(params, "audnet", audio, 5, True,
                                      prec)
    conf = np.asarray(cfg["conf"]).tolist()
    fused = P.fusion_head(params, conf, audio_taps, image_taps,
                          float(cfg["drpt"]), False, masks, prec)
    return fused, image_logits, audio_logits


def train_batches(data, cfg, steps):
    """The first ``steps`` train batches as the upstream loader yields
    them: dicts of the raw rows, label and validity mask."""
    n_train = data["split"][0]
    order = np.arange(n_train)
    np.random.RandomState(0).shuffle(order)
    bs = int(cfg["batchsize"])
    out = []
    for s in range(steps):
        take = order[s * bs:(s + 1) * bs]
        out.append({"rows": take,
                    "mask": np.ones(len(take), np.float32)})
    return out


def inputs(data, batch, device):
    """(image, audio) normalized inputs, label and mask of ``batch``."""
    rows = batch["rows"]
    image = torch.as_tensor(data["image"][rows], device=device)
    image = (image.reshape(-1, 1, 28, 28) - MNIST_MEAN) / MNIST_STD
    audio = torch.as_tensor(data["audio"][rows], device=device)[:, None]
    label = torch.as_tensor(data["label"][rows], device=device)
    mask = torch.as_tensor(batch["mask"], device=device)
    return (image, audio), label, mask
