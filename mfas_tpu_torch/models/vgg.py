"""VGG-19 feature trunk, the MM-IMDB image backbone (port of
mfas_tpu/models/vgg.py).

torchvision's ``vgg19.features`` (configuration E): conv3x3 blocks
[64,64, M, 128,128, M, 256x4, M, 512x4, M, 512x4, M], a ReLU after every
conv, at torchvision's module indices, so its pretrained weights load after
``remap_torchvision_vgg_keys`` renames ``features.N`` to ``vgg.N``.
"""

from __future__ import annotations

from torch import nn

from mfas_tpu_torch.core import layers as L

VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]


def vgg19_features(*, device, generator):
    """ModuleList at torchvision vgg19.features' module indices."""
    mods = []
    in_ch = 3
    for v in VGG19_CFG:
        if v == "M":
            mods.append(L.MaxPool2d(2, stride=2))
        else:
            mods.append(L.Conv2d(in_ch, v, kernel_size=3, padding=1,
                                 device=device, generator=generator))
            mods.append(L.ReLU())
            in_ch = v
    return nn.ModuleList(mods)


def remap_torchvision_vgg_keys(flat: dict, prefix: str = "vgg") -> dict:
    """torchvision 'features.N.weight' -> '{prefix}.N.weight'; the
    classifier's weights are dropped (only the trunk is used)."""
    return {f"{prefix}." + k[len("features."):]: v for k, v in flat.items()
            if k.startswith("features.")}
