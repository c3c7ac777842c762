"""Inflated 3D ResNet-50, the RGB video backbone (port of
mfas_tpu/models/resnet3d.py).

  * 2D 7x7/s2 stem + 3x3/s2 maxpool applied frame-wise;
  * four Bottleneck3D stages with 1x1x1 / 3x3x3 / 1x1x1 convs and
    spatial-only strides (1,s,s);
  * conv init N(0, sqrt(2/n)), n = k0*k1*out_channels; BN gamma=1 beta=0;
  * ``forward`` returns the four stage outputs.

``layers`` / ``base_width`` shrink the net for tests; the defaults are the
reference's ResNet-50 ([3,4,6,3], 64).
"""

from __future__ import annotations

import torch
from torch import nn

from mfas_tpu_torch.core import functional as F
from mfas_tpu_torch.core import init as I
from mfas_tpu_torch.core.layers import BatchNorm2d, BatchNorm3d, Conv2d, Conv3d


class Bottleneck3D(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 dilation=1, *, device, generator):
        super().__init__()
        kw = dict(bias=False, weight_init=I.resnet_conv_weight, device=device,
                  generator=generator)
        self.conv1 = Conv3d(inplanes, planes, kernel_size=1, **kw)
        self.bn1 = BatchNorm3d(planes, device=device)
        self.conv2 = Conv3d(planes, planes, kernel_size=3, stride=stride,
                            padding=1, dilation=(1, dilation, dilation), **kw)
        self.bn2 = BatchNorm3d(planes, device=device)
        self.conv3 = Conv3d(planes, planes * 4, kernel_size=1, **kw)
        self.bn3 = BatchNorm3d(planes * 4, device=device)
        if downsample is not None:
            self.downsample = downsample
        self._has_downsample = downsample is not None

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = self.downsample(x) if self._has_downsample else x
        return torch.relu(out + residual)


class ResNet3D(nn.Module):
    """Inflated ResNet with a 2D stem; ``forward`` is the reference's
    ``get_feature_maps``."""

    def __init__(self, layers=(3, 4, 6, 3), base_width=64, *, device,
                 generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.inplanes = base_width
        self.conv1 = Conv2d(3, base_width, kernel_size=7, stride=2, padding=3,
                            bias=False, weight_init=I.resnet_conv_weight,
                            device=device, generator=generator)
        self.bn1 = BatchNorm2d(base_width, device=device)
        channels = [base_width, base_width * 2, base_width * 4, base_width * 8]
        self.layer1 = self._make_layer(channels[0], layers[0], 1, kw)
        self.layer2 = self._make_layer(channels[1], layers[1], 2, kw)
        self.layer3 = self._make_layer(channels[2], layers[2], 2, kw)
        self.layer4 = self._make_layer(channels[3], layers[3], 2, kw)

    def _make_layer(self, planes, blocks, stride, kw):
        downsample = None
        st = (1, stride, stride)
        if stride != 1 or self.inplanes != planes * Bottleneck3D.expansion:
            downsample = nn.Sequential(
                Conv3d(self.inplanes, planes * Bottleneck3D.expansion,
                       kernel_size=1, stride=st, bias=False,
                       weight_init=I.resnet_conv_weight, **kw),
                BatchNorm3d(planes * Bottleneck3D.expansion,
                            device=kw["device"]),
            )
        mods = [Bottleneck3D(self.inplanes, planes, st, downsample, **kw)]
        self.inplanes = planes * Bottleneck3D.expansion
        for _ in range(1, blocks):
            mods.append(Bottleneck3D(self.inplanes, planes, **kw))
        return nn.Sequential(*mods)

    def blocks(self):
        """The residual blocks of the four stages, in order."""
        return [b for layer in (self.layer1, self.layer2, self.layer3,
                                self.layer4) for b in layer]

    def forward(self, x):
        """x: (B, C, T, W, H) -> (fm1, fm2, fm3, fm4), all 5D."""
        B, C, T, W, H = x.shape
        # frame-wise 2D stem: (B,C,T,W,H) -> (B*T,C,W,H)
        frames = x.transpose(1, 2).reshape(B * T, C, W, H)
        out = self.bn1(self.conv1(frames))
        # the reference's relu -> maxpool, pooled first: relu is monotone,
        # so relu(max(x)) == max(relu(x)) bit for bit, on 1/4 of the values
        out = torch.relu(F.max_pool2d(out, 3, stride=2, padding=1))
        _, c, w, h = out.shape
        out = out.reshape(B, T, c, w, h).transpose(1, 2)
        fm1 = self.layer1(out)
        fm2 = self.layer2(fm1)
        fm3 = self.layer3(fm2)
        fm4 = self.layer4(fm3)
        return fm1, fm2, fm3, fm4
