"""AV-MNIST searchable fusion net and its search space (port of
mfas_tpu/fusion/avmnist.py).

  * Searchable_Audio_Image_Net: a GP_LeNet image backbone (3 taps, widths
    [ch, 2ch, 4ch]) and a GP_LeNet_Deeper audio backbone (5 taps, widths
    [ch, 2ch, 4ch, 8ch, 16ch]); the taps come globally pooled from the
    backbones; the fusion layers have no BatchNorm option. The multitask
    forward returns (fused_logits, image_logits, audio_logits).
  * the search space: 5*3*2 = 30 one-row unfoldings;
  * AVMnistFeatureExtractor: the two backbones alone (the population
    trainer's frozen features).
"""

from __future__ import annotations

import numpy as np
from torch import nn

from mfas_tpu_torch.core import layers as L
from mfas_tpu_torch.fusion.layers import (build_alphas, build_fusion_layers,
                                          enumerate_layer_confs,
                                          progressive_fuse)
from mfas_tpu_torch.models.avmnist import GP_LeNet, GP_LeNet_Deeper


def tap_sizes(args):
    ch = int(args.channels)
    sizes_ims = [ch, 2 * ch, 4 * ch]
    sizes_aud = [ch, 2 * ch, 4 * ch, 8 * ch, 16 * ch]
    return sizes_aud, sizes_ims


class Searchable_Audio_Image_Net(nn.Module):
    def __init__(self, args, conf, *, device, generator):
        super().__init__()
        self.conf = np.asarray(conf)
        self.args = args
        kw = dict(device=device, generator=generator)

        self.rgbnet = GP_LeNet(args, 1, **kw)
        self.audnet = GP_LeNet_Deeper(args, 1, **kw)

        sizes_aud, sizes_ims = tap_sizes(args)
        self.alphas = build_alphas(self.conf, sizes_aud, sizes_ims, **kw)
        self.fusion_layers = build_fusion_layers(
            self.conf, sizes_aud, sizes_ims, args.inner_representation_size,
            args.drpt, batchnorm=False, **kw)
        self.central_classifier = L.Linear(args.inner_representation_size,
                                           args.num_outputs, **kw)

    def central_params(self):
        """Trainable prefixes for frozen-backbone training; alphas only when
        they are in the graph (args.alphas)."""
        prefixes = ["fusion_layers", "central_classifier"]
        if self.args.alphas:
            prefixes.insert(0, "alphas")
        return prefixes

    def forward(self, tensor_tuple):
        image, sound = tensor_tuple[0], tensor_tuple[1]
        img = self.rgbnet(image)
        visual_logits, visual_taps = img[0], img[1:]
        aud = self.audnet(sound)
        audio_logits, audio_taps = aud[0], aud[1:]

        feats_v = [visual_taps[int(r[1])] for r in self.conf]
        feats_a = [audio_taps[int(r[0])] for r in self.conf]
        out = progressive_fuse(self, feats_a, feats_v)
        if not self.args.multitask:
            return out
        return out, visual_logits, audio_logits


def get_possible_layer_configurations(progression_index=None):
    """30 rows: audio in [0,5), image in [0,3), act in [0,2)."""
    return enumerate_layer_confs(5, 3, 2)


class AVMnistFeatureExtractor(nn.Module):
    """Frozen-backbone tap extractor for the population trainer: returns
    (audio taps, image taps, image logits, audio logits), all pooled.
    ``state_dict`` keys are ``rgbnet.*`` and ``audnet.*``, as in the
    searchable net."""

    def __init__(self, args, *, device, generator):
        super().__init__()
        self.rgbnet = GP_LeNet(args, 1, device=device, generator=generator)
        self.audnet = GP_LeNet_Deeper(args, 1, device=device,
                                      generator=generator)

    def forward(self, inputs):
        image, sound = inputs
        img = self.rgbnet(image)
        aud = self.audnet(sound)
        return list(aud[1:]), list(img[1:]), img[0], aud[0]
