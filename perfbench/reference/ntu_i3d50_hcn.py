"""Frozen plain-PyTorch reference of the MFAS NTU RGB+D found network
(Perez-Rua et al., MFAS, CVPR 2019, arXiv:1903.06496; the upstream
``main_found_ntu.py``, ``models/central/ntu.py`` and
``models/search/ntu_searchable.py``).

  * RGB: an inflated ResNet-50 over (B, T, W, H, 3) clips: a frame-wise 2D
    7x7/2 stem conv + BatchNorm + 3x3/2 max pool + ReLU, four stages of
    Bottleneck3D blocks (1x1x1, 3x3x3 with spatial stride, 1x1x1, BatchNorm
    after each, a projection shortcut on each stage's first block); taps
    fm2, fm3, fm4 and the (T, 7, 7) average of fm4; a Linear classifier;
  * skeleton: HCN over (N, 3, T, 25, M=2) joints: a position and a motion
    stream (the temporal difference bilinearly re-interpolated to T
    frames), each conv1 1x1 + ReLU, conv2 (3, 1), the point-to-joint
    transpose, conv3 3x3 + max pool, conv4 3x3 + Dropout2d + max pool; the
    streams concatenated; conv5 and conv6 (3x3 + ReLU + Dropout2d + max
    pool); persons max-merged; fc7 (+ ReLU + dropout) and fc8; taps are
    the person-max of conv5's and conv6's maps, the flattened map and fc7;
  * the fusion head over rows [skeleton tap, rgb tap, activation], each tap
    globally averaged.

Inputs are built from the raw store the benchmark made: the train batches'
clips, frame picks and skeleton resampling are worked out here from the
upstream loader's rule (a ``RandomState(0)`` shuffle, one seed per sample,
the random temporal crop, the length normalization), the clips normalized
with ImageNet's statistics and the skeletons centred on joint 2 of person 1.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF

from perfbench.reference import _plain as P

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# the output layers, whose leaves the multitask loss reaches first
HEADS = ("central_classifier.", "rgbnet.classifier.", "skenet.fc8.")


def _resnet_layout(cfg):
    return (tuple(cfg.get("resnet3d_layers", (3, 4, 6, 3))),
            int(cfg.get("resnet3d_base_width", 64)))


def tap_sizes(cfg):
    _, width = _resnet_layout(cfg)
    wl = int(cfg["vid_len"][1])
    sizes_ske = [128, 256, 256 * max((wl // 16) ** 2, 1), 512]
    sizes_rgb = [width * 8, width * 16, width * 32, width * 32]
    return sizes_ske, sizes_rgb


def backbone_specs(cfg):
    """The two backbones' parameters (``rgbnet.*``, ``skenet.*``)."""
    layers, width = _resnet_layout(cfg)
    n_out = int(cfg["num_outputs"])
    s = []
    s += P.conv_spec("rgbnet.cnn.conv1", width, 3, (7, 7), False)
    s += P.bn_spec("rgbnet.cnn.bn1", width)
    inplanes = width
    for li, (blocks, planes) in enumerate(zip(layers, [width, width * 2,
                                                       width * 4,
                                                       width * 8]), 1):
        for bi in range(blocks):
            p = f"rgbnet.cnn.layer{li}.{bi}."
            s += P.conv_spec(p + "conv1", planes, inplanes, (1, 1, 1), False)
            s += P.bn_spec(p + "bn1", planes)
            s += P.conv_spec(p + "conv2", planes, planes, (3, 3, 3), False)
            s += P.bn_spec(p + "bn2", planes)
            s += P.conv_spec(p + "conv3", planes * 4, planes, (1, 1, 1),
                             False)
            s += P.bn_spec(p + "bn3", planes * 4)
            if bi == 0:
                s += P.conv_spec(p + "downsample.0", planes * 4, inplanes,
                                 (1, 1, 1), False)
                s += P.bn_spec(p + "downsample.1", planes * 4)
            inplanes = planes * 4
    s += P.linear_spec("rgbnet.classifier", n_out, width * 32)

    wl = int(cfg["vid_len"][1])
    for m in ("", "m"):
        s += P.conv_spec(f"skenet.conv1{m}.0", 64, 3, (1, 1), True)
        s += P.conv_spec(f"skenet.conv2{m}", wl, 64, (3, 1), True)
        s += P.conv_spec(f"skenet.conv3{m}.0", 32, 25, (3, 3), True)
        s += P.conv_spec(f"skenet.conv4{m}.0", 64, 32, (3, 3), True)
    s += P.conv_spec("skenet.conv5.0", 128, 128, (3, 3), True)
    s += P.conv_spec("skenet.conv6.0", 256, 128, (3, 3), True)
    s += P.linear_spec("skenet.fc7.0", 512, 256 * max((wl // 16) ** 2, 1))
    s += P.linear_spec("skenet.fc8", n_out, 512)
    return s


def param_specs(cfg):
    """The found net's parameters: the backbones and the fusion head."""
    conf = np.asarray(cfg["conf"]).tolist()
    sizes_ske, sizes_rgb = tap_sizes(cfg)
    return backbone_specs(cfg) + P.fusion_head_specs(
        conf, sizes_ske, sizes_rgb, int(cfg["inner_representation_size"]),
        int(cfg["num_outputs"]), bool(cfg["batchnorm"]))


# --------------------------------------------------------------------------
# RGB: inflated ResNet-50
# --------------------------------------------------------------------------
def _bn(params, name, x):
    return P.batch_norm_train(x, params[name + ".weight"],
                              params[name + ".bias"])


def _block(params, p, x, stride, prec):
    out = torch.relu(_bn(params, p + "bn1",
                         P.conv(prec, x, params[p + "conv1.weight"])))
    out = torch.relu(_bn(params, p + "bn2",
                         P.conv(prec, out, params[p + "conv2.weight"],
                                stride=(1, stride, stride), padding=1)))
    out = _bn(params, p + "bn3", P.conv(prec, out, params[p + "conv3.weight"]))
    if p + "downsample.0.weight" in params:
        res = _bn(params, p + "downsample.1",
                  P.conv(prec, x, params[p + "downsample.0.weight"],
                         stride=(1, stride, stride)))
    else:
        res = x
    return torch.relu(out + res)


def visual(params, clips, cfg, prec):
    """clips (B, T, W, H, 3) -> (fm2, fm3, fm4, pooled, logits)."""
    layers, _ = _resnet_layout(cfg)
    x = clips.permute(0, 4, 1, 2, 3)                  # (B, 3, T, W, H)
    B, C, T, W, H = x.shape
    frames = x.transpose(1, 2).reshape(B * T, C, W, H)
    out = _bn(params, "rgbnet.cnn.bn1",
              P.conv(prec, frames, params["rgbnet.cnn.conv1.weight"],
                     stride=2, padding=3))
    out = torch.relu(TF.max_pool2d(out, 3, stride=2, padding=1))
    _, c, w, h = out.shape
    out = out.reshape(B, T, c, w, h).transpose(1, 2)
    maps = []
    for li, blocks in enumerate(layers, 1):
        for bi in range(blocks):
            stride = 2 if (bi == 0 and li > 1) else 1
            out = _block(params, f"rgbnet.cnn.layer{li}.{bi}.", out, stride,
                         prec)
        maps.append(out)
    pooled = maps[3].mean(dim=(2, 3, 4))
    logits = P.linear(prec, pooled, params["rgbnet.classifier.weight"],
                      params["rgbnet.classifier.bias"])
    return maps[1], maps[2], maps[3], pooled, logits


# --------------------------------------------------------------------------
# skeleton: HCN
# --------------------------------------------------------------------------
def _conv(params, name, x, prec, padding=0):
    return P.conv(prec, x, params[name + ".weight"], params[name + ".bias"],
                  padding=padding)


def _motion(x):
    """(N, C, T, V, M): the temporal difference, bilinearly resampled back
    to T frames (half-pixel centres)."""
    N, C, T, V, M = x.shape
    d = x[:, :, 1:] - x[:, :, :-1]
    d = d.permute(0, 1, 4, 2, 3).reshape(N, C * M, T - 1, V)
    d = TF.interpolate(d, size=(T, V), mode="bilinear", align_corners=False)
    return d.reshape(N, C, M, T, V).permute(0, 1, 3, 4, 2)


def _stream(params, x, m, masks, drpt, prec):
    out = torch.relu(_conv(params, f"skenet.conv1{m}.0", x, prec))
    out = _conv(params, f"skenet.conv2{m}", out, prec, padding=(1, 0))
    out = out.permute(0, 3, 2, 1)                   # point -> joint level
    out = TF.max_pool2d(_conv(params, f"skenet.conv3{m}.0", out, prec,
                              padding=1), 2)
    out = _conv(params, f"skenet.conv4{m}.0", out, prec, padding=1)
    return TF.max_pool2d(masks.drop(out, drpt, channels=True), 2)


def skeleton(params, ske, cfg, masks, prec):
    """ske (N, 3, T, 25, M) -> (taps [conv5 map, conv6 map, flat, fc7],
    logits); the maps person-maxed."""
    drpt = float(cfg["drpt"])
    wl = int(cfg["vid_len"][1])
    N, C, T, V, M = ske.shape

    def fold(a):
        return a.permute(0, 4, 1, 2, 3).reshape(N * M, C, T, V)

    def person_max(a):
        return a.reshape(N, M, *a.shape[1:]).amax(dim=1)

    p4 = _stream(params, fold(ske), "", masks, drpt, prec)
    m4 = _stream(params, fold(_motion(ske)), "m", masks, drpt, prec)
    out = torch.cat([p4, m4], dim=1)
    out5 = masks.drop(torch.relu(_conv(params, "skenet.conv5.0", out, prec,
                                       padding=1)), drpt, channels=True)
    if wl != 8:
        out5 = TF.max_pool2d(out5, 2)
    out6 = masks.drop(torch.relu(_conv(params, "skenet.conv6.0", out5, prec,
                                       padding=1)), drpt, channels=True)
    out6 = TF.max_pool2d(out6, 2)
    out7 = person_max(out6).reshape(N, -1)
    out8 = masks.drop(torch.relu(P.linear(prec, out7,
                                          params["skenet.fc7.0.weight"],
                                          params["skenet.fc7.0.bias"])),
                      drpt, channels=True)
    logits = P.linear(prec, out8, params["skenet.fc8.weight"],
                      params["skenet.fc8.bias"])
    return [person_max(out5), person_max(out6), out7, out8], logits


def _gap(t):
    return t.reshape(t.shape[0], t.shape[1], -1).mean(dim=2)


def features(params, inputs, cfg, masks, prec=P.FLOAT32):
    """Both backbones in train mode -> (skeleton taps, rgb taps, rgb
    logits, skeleton logits), every tap globally averaged."""
    clips, ske = inputs
    fm2, fm3, fm4, pooled, rgb_logits = visual(params, clips, cfg, prec)
    ske_taps, ske_logits = skeleton(params, ske, cfg, masks, prec)
    return ([_gap(t) for t in ske_taps],
            [_gap(t) for t in (fm2, fm3, fm4, pooled)], rgb_logits,
            ske_logits)


def forward(params, inputs, cfg, masks, prec=P.FLOAT32):
    """Train-mode forward -> (fused logits, rgb logits, skeleton logits)."""
    taps_s, taps_v, rgb_logits, ske_logits = features(params, inputs, cfg,
                                                      masks, prec)
    conf = np.asarray(cfg["conf"]).tolist()
    fused = P.fusion_head(params, conf, taps_s, taps_v, float(cfg["drpt"]),
                          bool(cfg["batchnorm"]), masks, prec)
    return fused, rgb_logits, ske_logits


# --------------------------------------------------------------------------
# the upstream train loader's rule, worked out again
# --------------------------------------------------------------------------
def _frame_pick(num, out_len):
    return np.linspace(0, num - 1, out_len).astype(int)


def _time_plan(T, out_len):
    if T == out_len:
        idx = np.arange(out_len)
        return idx, idx, np.zeros(out_len, np.float32)
    pos = (np.arange(out_len, dtype=np.float64) + 0.5) * (T / out_len) - 0.5
    pos = np.clip(pos, 0.0, T - 1)
    lo = np.floor(pos).astype(int)
    return lo, np.minimum(lo + 1, T - 1), (pos - lo).astype(np.float32)


def _train_plan(n_frames, ske_len, rs, vid_len, p_interval=0.5):
    """The random temporal crop (RGB keeps a centred fraction, the skeleton
    a window of at least 64 frames) and the length normalization, as frame
    indices into the stored clip."""
    ratio = 1.0 - p_interval * rs.rand()
    k = int(n_frames * ratio)
    begin = (n_frames - k) // 2
    window = np.arange(n_frames)[begin:n_frames - begin]
    rgb_t = window[_frame_pick(len(window), vid_len[0])]
    p = float(rs.rand(1)[0]) * (1.0 - p_interval) + p_interval
    cropped = int(min(max(int(math.floor(ske_len * p)), 64), ske_len))
    bias = rs.randint(0, ske_len - cropped + 1)
    sk = np.arange(bias, bias + cropped)
    lo, hi, w = _time_plan(len(sk), vid_len[1])
    return rgb_t, sk[lo], sk[hi], w


def train_batches(data, cfg, steps, split="train"):
    """The first ``steps`` batches of the shuffled ``split`` as the upstream
    train loader yields them, epoch after epoch (one ``RandomState(0)``: a
    shuffle, then one seed per sample, each epoch): sample rows, RGB frame
    picks, skeleton (lo, hi, w) resampling, mask."""
    train = data[split]
    n = len(train["labels"])
    rs = np.random.RandomState(0)
    bs = int(cfg["batchsize"])
    vid_len = tuple(cfg["vid_len"])
    out = []
    while len(out) < steps:
        order = np.arange(n)
        rs.shuffle(order)
        seeds = rs.randint(0, 2 ** 31 - 1, size=n)
        for start in range(0, n, bs):
            if len(out) == steps:
                break
            take = order[start:start + bs]
            plans = [_train_plan(train["frames"], int(train["ske_len"][i]),
                                 np.random.RandomState(int(seeds[start + j])),
                                 vid_len)
                     for j, i in enumerate(take)]
            mask = np.zeros(bs, np.float32)
            mask[:len(take)] = 1.0
            pad = bs - len(take)
            take = np.concatenate([take, np.repeat(take[:1], pad)])
            plans += [plans[0]] * pad
            out.append({"split": split, "rows": take,
                        "rgb_t": np.stack([p[0] for p in plans]),
                        "ske_lo": np.stack([p[1] for p in plans]),
                        "ske_hi": np.stack([p[2] for p in plans]),
                        "ske_w": np.stack([p[3] for p in plans]),
                        "mask": mask})
    return out


def inputs(data, batch, device):
    """(clips, skeletons) normalized inputs, label and mask of ``batch``."""
    train = data[batch["split"]]
    rows = torch.as_tensor(batch["rows"], device=device)
    rgb = torch.as_tensor(train["rgb"], device=device)[
        rows[:, None], torch.as_tensor(batch["rgb_t"], device=device)]
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    std = torch.tensor(IMAGENET_STD, device=device)
    clips = (rgb.float() / 255.0 - mean) / std
    ske = torch.as_tensor(train["ske"], device=device)[rows].float()
    lo = torch.as_tensor(batch["ske_lo"], device=device)
    hi = torch.as_tensor(batch["ske_hi"], device=device)
    w = torch.as_tensor(batch["ske_w"], device=device)
    ar = torch.arange(len(rows), device=device)[:, None]
    # (B, 3, S, 25, 2) -> (B, T, 3, 25, 2) picks -> back to (B, 3, T, 25, 2)
    s_t = ske.permute(0, 2, 1, 3, 4)
    res = (s_t[ar, lo] * (1.0 - w)[:, :, None, None, None]
           + s_t[ar, hi] * w[:, :, None, None, None])
    res = res.permute(0, 2, 1, 3, 4)
    res = res - res[:, :, :, 1, 0][:, :, :, None, None]
    label = torch.as_tensor(train["labels"], device=device)[rows]
    mask = torch.as_tensor(batch["mask"], device=device)
    return (clips, res), label, mask
