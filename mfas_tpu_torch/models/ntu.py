"""NTU RGB+D backbones (port of mfas_tpu/models/ntu.py: Visual, hcn_motion,
Skeleton).

  * Visual: inflated ResNet-50 over (B,T,W,H,C) video; returns the four
    stage maps, the (T,7,7)-average-pooled embedding, and logits.
  * Skeleton: HCN two-stream (position + temporal-difference motion
    re-interpolated to T frames) per-person co-occurrence CNN; streams
    concatenated, persons max-merged; returns 8 hidden taps + logits.

Persons are folded into the batch (one conv call over N*M samples); the
max-merge afterwards equals the reference's per-person loop.
"""

from __future__ import annotations

import torch
from torch import nn

from mfas_tpu_torch.core import functional as F
from mfas_tpu_torch.core import init as I
from mfas_tpu_torch.core import layers as L
from mfas_tpu_torch.models.resnet3d import ResNet3D


class Visual(nn.Module):
    """Returns (fm1, fm2, fm3, fm4, pooled, logits)."""

    def __init__(self, args, *, device, generator):
        super().__init__()
        layers = tuple(getattr(args, "resnet3d_layers", (3, 4, 6, 3)))
        width = int(getattr(args, "resnet3d_base_width", 64))
        self.cnn = ResNet3D(layers, base_width=width, device=device,
                            generator=generator)
        self.classifier = L.Linear(width * 32, args.num_outputs,
                                   device=device, generator=generator)

    def forward(self, x):
        # (B, T, W, H, C) -> (B, C, T, W, H)
        x = x.permute(0, 4, 1, 2, 3)
        fm1, fm2, fm3, fm4 = self.cnn(x)
        # temporal pooling: AvgPool3d((T,7,7)) == global mean over (T,W,H)
        pooled = fm4.mean(dim=(2, 3, 4))
        return fm1, fm2, fm3, fm4, pooled, self.classifier(pooled)


def hcn_motion(x):
    """HCN motion branch (reference models/central/ntu.py:131-135): temporal
    difference, bilinearly re-interpolated back to T frames.
    x: (N, C, T, V, M) -> same shape."""
    N, C, T, V, M = x.shape
    motion = x[:, :, 1:] - x[:, :, :-1]                    # (N,C,T-1,V,M)
    motion = motion.permute(0, 1, 4, 2, 3).reshape(N, C * M, T - 1, V)
    motion = F.interpolate_bilinear(motion, (T, V))
    return motion.reshape(N, C, M, T, V).permute(0, 1, 3, 4, 2)


class Skeleton(nn.Module):
    """HCN co-occurrence net. Returns (hidden_taps[8], logits)."""

    def __init__(self, args, *, device, generator):
        super().__init__()
        in_channel, num_joint, out_channel = 3, 25, 64
        window_size = args.vid_len[1]
        drpt = args.drpt

        def conv(in_ch, out_ch, k, padding=0):
            return L.Conv2d(in_ch, out_ch, kernel_size=k, stride=1,
                            padding=padding, weight_init=I.xavier_uniform,
                            bias_init=I.zeros, device=device,
                            generator=generator)

        def linear(in_f, out_f):
            return L.Linear(in_f, out_f, weight_init=I.xavier_uniform,
                            bias_init=I.zeros, device=device,
                            generator=generator)

        Seq = nn.Sequential
        # position stream
        self.conv1 = Seq(conv(in_channel, out_channel, 1), L.ReLU())
        self.conv2 = conv(out_channel, window_size, (3, 1), padding=(1, 0))
        self.conv3 = Seq(conv(num_joint, out_channel // 2, 3, padding=1),
                         L.MaxPool2d(2))
        self.conv4 = Seq(conv(out_channel // 2, out_channel, 3, padding=1),
                         L.Dropout2d(drpt), L.MaxPool2d(2))
        # motion stream
        self.conv1m = Seq(conv(in_channel, out_channel, 1), L.ReLU())
        self.conv2m = conv(out_channel, window_size, (3, 1), padding=(1, 0))
        self.conv3m = Seq(conv(num_joint, out_channel // 2, 3, padding=1),
                          L.MaxPool2d(2))
        self.conv4m = Seq(conv(out_channel // 2, out_channel, 3, padding=1),
                          L.Dropout2d(drpt), L.MaxPool2d(2))
        # merged column
        conv5 = [conv(out_channel * 2, out_channel * 2, 3, padding=1),
                 L.ReLU(), L.Dropout2d(drpt)]
        if window_size != 8:
            conv5.append(L.MaxPool2d(2))
        self.conv5 = Seq(*conv5)
        self.conv6 = Seq(conv(out_channel * 2, out_channel * 4, 3, padding=1),
                         L.ReLU(), L.Dropout2d(drpt), L.MaxPool2d(2))

        lin = (out_channel * 4) * max((window_size // 16) ** 2, 1)
        self.fc7 = Seq(linear(lin, 512), L.ReLU(), L.Dropout2d(drpt))
        self.fc8 = linear(512, args.num_outputs)

    def _stream(self, x, motion: bool):
        """One co-occurrence column over person-folded input (N*M,C,T,V)."""
        m = "m" if motion else ""
        out1 = getattr(self, "conv1" + m)(x)
        out2 = getattr(self, "conv2" + m)(out1)
        # point-level -> joint-level: (N,C',T,V) -> (N,V,T,C')
        out3 = getattr(self, "conv3" + m)(out2.permute(0, 3, 2, 1))
        out4 = getattr(self, "conv4" + m)(out3)
        return out1, out2, out3, out4

    def forward(self, x):
        N, C, T, V, M = x.shape

        def fold(a):       # (N,C,T,V,M) -> (N*M, C, T, V), person-major
            return a.permute(0, 4, 1, 2, 3).reshape(N * M, C, T, V)

        def unfold_max(a):  # (N*M, ...) -> max over persons -> (N, ...)
            return a.reshape(N, M, *a.shape[1:]).amax(dim=1)

        p1, p2, p3, p4 = self._stream(fold(x), motion=False)
        _, _, _, m4 = self._stream(fold(hcn_motion(x)), motion=True)

        out4 = torch.cat([p4, m4], dim=1)
        out5 = self.conv5(out4)
        out6 = self.conv6(out5)
        out7 = unfold_max(out6).reshape(N, -1)
        out8 = self.fc7(out7)
        logits = self.fc8(out8)

        # hidden taps: max over persons of each stage, then the flattened
        # max map and the fc7 embedding. Tap 2 is the JOINT-LEVEL view of
        # out2: the reference appends out2 after its permute
        hidden = [unfold_max(p1), unfold_max(p2.permute(0, 3, 2, 1)),
                  unfold_max(p3), unfold_max(out4), unfold_max(out5),
                  unfold_max(out6), out7, out8]
        return hidden, logits
