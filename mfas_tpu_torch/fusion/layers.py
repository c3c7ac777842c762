"""conf -> progressive fusion head builder (port of mfas_tpu/fusion/layers.py).

An architecture is an integer matrix ``conf`` of shape (L, 3): row i =
[modA_tap_idx, modB_tap_idx, activation_idx] with activations 0=ReLU,
1=Sigmoid, 2=LeakyReLU. At each row the two chosen globally-pooled taps
(optionally alpha-gated) are concatenated with the previous fusion output and
pushed through Linear -> activation (-> BatchNorm1d) (-> Dropout) into a
shared hidden size; a final Linear classifies.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from mfas_tpu_torch.core import init as I
from mfas_tpu_torch.core import layers as L

ACTIVATIONS = {0: L.ReLU, 1: L.Sigmoid, 2: L.LeakyReLU}
ACT_NAMES = {0: "relu", 1: "sigmoid", 2: "lrelu"}


def build_fusion_layers(conf, sizes_a, sizes_b, hidden, drpt, batchnorm, *,
                        device, generator):
    """ModuleList of per-row Sequential(Linear, act[, BN1d][, Dropout]); the
    parameter-less activation keeps index 1, so BN's keys are
    ``fusion_layers.{i}.2.*`` as in the JAX package."""
    rows = []
    for i, row in enumerate(np.asarray(conf)):
        in_size = sizes_a[int(row[0])] + sizes_b[int(row[1])]
        if i > 0:
            in_size += hidden
        mods = [L.Linear(in_size, hidden, device=device, generator=generator),
                ACTIVATIONS[int(row[2])]()]
        if batchnorm:
            mods.append(L.BatchNorm1d(hidden, device=device))
        if drpt > 1e-10:
            mods.append(L.Dropout(drpt))
        rows.append(nn.Sequential(*mods))
    return nn.ModuleList(rows)


def build_alphas(conf, sizes_a, sizes_b, *, device, generator):
    """Per-row AlphaScalarMultiplication gates, alpha ~ N(0, 0.1)."""
    return nn.ModuleList([
        L.AlphaScalarMultiplication(sizes_a[int(r[0])], sizes_b[int(r[1])],
                                    alpha_init=I.normal(0.0, 0.1),
                                    device=device, generator=generator)
        for r in np.asarray(conf)
    ])


def progressive_fuse(net, feats_a, feats_b):
    """Shared forward of the searchable fusion heads. ``net`` owns
    ``alphas`` / ``fusion_layers`` / ``central_classifier``; ``feats_a`` /
    ``feats_b`` are per-row lists of (B, C_row) pooled taps."""
    out = None
    for i in range(len(net.conf)):
        fa, fb = feats_a[i], feats_b[i]
        if net.args.alphas:
            fa, fb = net.alphas[i](fa, fb)
        pieces = [fa, fb] if out is None else [fa, fb, out]
        out = net.fusion_layers[i](torch.cat(pieces, dim=1))
    return net.central_classifier(out)


def enumerate_layer_confs(n_taps_a, n_taps_b, n_acts):
    """All one-row unfoldings [a_idx, b_idx, act] in lexicographic order."""
    return [[a, b, n] for a in range(n_taps_a) for b in range(n_taps_b)
            for n in range(n_acts)]


def shared_weight_key(layer_index, in_size, out_size, act_idx):
    """Weight-sharing key '{i}.L_{in}_{out}.A_{relu|sigmoid|lrelu}'."""
    return f"{layer_index}.L_{in_size}_{out_size}.A_{ACT_NAMES[int(act_idx)]}"
