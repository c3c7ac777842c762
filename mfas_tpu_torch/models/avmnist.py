"""AV-MNIST backbones and hand-built fusion baselines (port of
mfas_tpu/models/avmnist.py).

  * GP_LeNet: 3 stages of conv(5/3/3)+BN+ReLU with a 2x2 max-pool after
    each, GlobalPooling2D taps; gp1 taps the *pre-pool* stage-1 activation.
  * GP_LeNet_Deeper: 5 stages; gp1 taps the *post-pool* stage-1 activation
    and gp2..gp5 the pre-pool ones, a reference quirk kept here.
  * SimpleAVNet / SimpleAVNet_Deeper: late fusion baselines.
  * SimpleAV_CentralNet: an alpha-weighted central column of Conv1d ops over
    fused 1-D features.

The backbones' convolutions and classifiers use kaiming_uniform(a=0).
"""

from __future__ import annotations

import torch
from torch import nn

from mfas_tpu_torch.core import functional as F
from mfas_tpu_torch.core import init as I
from mfas_tpu_torch.core import layers as L

_KU = I.kaiming_uniform(0.0)


def _stage(in_ch, out_ch, k, kw):
    conv = L.Conv2d(in_ch, out_ch, kernel_size=k, padding=k // 2, bias=False,
                    weight_init=_KU, **kw)
    return conv, L.BatchNorm2d(out_ch, device=kw["device"])


class GP_LeNet(nn.Module):
    """Returns (logits, gp1, gp2, gp3)."""

    def __init__(self, args, in_channels, *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        ch = int(args.channels)
        self.conv1, self.bn1 = _stage(in_channels, ch, 5, kw)
        self.gp1 = L.GlobalPooling2D()
        self.conv2, self.bn2 = _stage(ch, 2 * ch, 3, kw)
        self.gp2 = L.GlobalPooling2D()
        self.conv3, self.bn3 = _stage(2 * ch, 4 * ch, 3, kw)
        self.gp3 = L.GlobalPooling2D()
        self.classifier = nn.Sequential(
            L.Linear(4 * ch, args.num_outputs, weight_init=_KU, **kw))

    def forward(self, x):
        gps = []
        out = x
        for i in range(1, 4):
            acti = torch.relu(getattr(self, f"bn{i}")(
                getattr(self, f"conv{i}")(out)))
            out = F.max_pool2d(acti, 2)
            gps.append(getattr(self, f"gp{i}")(acti))
        return (self.classifier(gps[-1]), *gps)


class GP_LeNet_Deeper(nn.Module):
    """Returns (logits, gp1, gp2, gp3, gp4, gp5)."""

    def __init__(self, args, in_channels, *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        ch = int(args.channels)
        prev = in_channels
        for i, w in enumerate([ch, 2 * ch, 4 * ch, 8 * ch, 16 * ch], start=1):
            conv, bn = _stage(prev, w, 5 if i == 1 else 3, kw)
            setattr(self, f"conv{i}", conv)
            setattr(self, f"bn{i}", bn)
            setattr(self, f"gp{i}", L.GlobalPooling2D())
            prev = w
        self.classifier = nn.Sequential(
            L.Linear(16 * ch, args.num_outputs, weight_init=_KU, **kw))

    def forward(self, x):
        gps = []
        out = x
        for i in range(1, 6):
            acti = torch.relu(getattr(self, f"bn{i}")(
                getattr(self, f"conv{i}")(out)))
            out = F.max_pool2d(acti, 2)
            # reference quirk: stage 1 taps post-pool, stages 2-5 pre-pool
            gps.append(getattr(self, f"gp{i}")(out if i == 1 else acti))
        return (self.classifier(gps[-1]), *gps)


class SimpleAVNet(nn.Module):
    """Late fusion of two GP_LeNets on the deepest taps."""

    def __init__(self, args, audio_channels, image_channels, *, device,
                 generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.audio_net = GP_LeNet(args, audio_channels, **kw)
        self.image_net = GP_LeNet(args, image_channels, **kw)
        self.classifier = L.Linear(int(2 * 4 * args.channels),
                                   args.num_outputs, **kw)

    def forward(self, audio, image):
        a3 = self.audio_net(audio)[3]
        i3 = self.image_net(image)[3]
        return self.classifier(torch.cat([a3, i3], dim=1))


class SimpleAVNet_Deeper(nn.Module):
    def __init__(self, args, audio_channels, image_channels, *, device,
                 generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.audio_net = GP_LeNet_Deeper(args, audio_channels, **kw)
        self.image_net = GP_LeNet(args, image_channels, **kw)
        self.classifier = L.Linear(int(20 * args.channels), args.num_outputs,
                                   **kw)

    def forward(self, audio, image):
        aud = self.audio_net(audio)
        img = self.image_net(image)
        return self.classifier(torch.cat([aud[5], img[3]], dim=1))


def _lateral_pad(x, pad):
    if pad <= 0:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], pad))], dim=1)


def fuse_features(f1, f2, a1, a2, fusetype):
    """cat with zero lateral padding, or an alpha-weighted sum."""
    dif = f1.shape[1] - f2.shape[1]
    if fusetype == "cat":
        if dif > 0:
            return torch.cat([f1, _lateral_pad(f2, dif)], dim=1)
        if dif < 0:
            return torch.cat([_lateral_pad(f1, -dif), f2], dim=1)
        return torch.cat([f1, f2], dim=1)
    # wsum; the reference uses a1 for both sides in the equal-size case
    if dif > 0:
        return f1 * a1 + _lateral_pad(f2, dif) * a2
    if dif < 0:
        return _lateral_pad(f1, -dif) * a1 + f2 * a2
    return f1 * a1 + f2 * a1


_ALPHAS = ("alpha1_feat1", "alpha2_feat1", "alpha3_feat1",
           "alpha1_feat2", "alpha2_feat2", "alpha3_feat2",
           "alpha_conv1", "alpha_conv2")


class SimpleAV_CentralNet(nn.Module):
    """CentralNet baseline: 3 fusion points chosen by args.fusingmix, a
    Conv1d central column with alpha-weighted sums."""

    def __init__(self, args, audio_channels, image_channels, *, device,
                 generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.args = args
        self.audio_net = GP_LeNet_Deeper(args, audio_channels, **kw)
        self.image_net = GP_LeNet(args, image_channels, **kw)

        rand = I.uniform(0.0, 1.0)       # torch.rand init
        for name in _ALPHAS:
            setattr(self, name, nn.Parameter(rand(generator, (1,), device)))

        for i in (1, 2, 3):
            setattr(self, f"central_conv{i}",
                    L.Conv1d(1, 1, kernel_size=3, padding=1, bias=False,
                             **kw))

        if args.fusingmix in ("11,32,53", "31,42,53"):
            nodes = 384
        elif args.fusingmix == "11,22,33":
            nodes = 96
        else:
            raise ValueError(f"fusingmix {args.fusingmix} not implemented")
        if args.fusetype == "cat":
            nodes *= 2
        self.central_classifier = L.Linear(nodes, args.num_outputs, **kw)

    def central_params(self):
        """Dotted prefixes of the central (fusion) parameters."""
        return ["central_conv1", "central_conv2", "central_conv3",
                *_ALPHAS, "central_classifier"]

    def forward(self, audio, image):
        aud = self.audio_net(audio)
        img = self.image_net(image)
        audio_out, a = aud[0], aud[1:]
        image_out, v = img[0], img[1:]

        pick = {"11,32,53": ((a[0], v[0]), (a[2], v[1]), (a[4], v[2])),
                "11,22,33": ((a[0], v[0]), (a[1], v[1]), (a[2], v[2])),
                "31,42,53": ((a[2], v[0]), (a[3], v[1]), (a[4], v[2]))
                }[self.args.fusingmix]

        ft = self.args.fusetype
        fuse1 = fuse_features(*pick[0], self.alpha1_feat1, self.alpha1_feat2,
                              ft)
        fuse2 = fuse_features(*pick[1], self.alpha2_feat1, self.alpha2_feat2,
                              ft)
        fuse3 = fuse_features(*pick[2], self.alpha3_feat1, self.alpha3_feat2,
                              ft)

        one = fuse1.new_ones((1,))
        cc1 = torch.relu(self.central_conv1(fuse1[:, None, :]))
        cc1 = fuse_features(cc1[:, 0, :], fuse2, self.alpha_conv1, one,
                            "wsum")
        cc2 = torch.relu(self.central_conv2(cc1[:, None, :]))
        cc2 = fuse_features(cc2[:, 0, :], fuse3, self.alpha_conv2, one,
                            "wsum")
        cc3 = torch.relu(self.central_conv3(cc2[:, None, :]))

        fusion_out = self.central_classifier(cc3[:, 0, :])
        return audio_out, image_out, fusion_out
