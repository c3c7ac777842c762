"""NTU searchable fusion net and its search space (port of
mfas_tpu/fusion/ntu.py).

  * Searchable_Skeleton_Image_Net: Visual + Skeleton backbones expose taps;
    skeleton taps = last 4 hidden maps with channel sizes
    [128, 256, vid_len[1]*32, 512]; rgb taps = [fm2, fm3, fm4, pooled];
    GlobalPooling2D per tap, optional alpha gates, progressive Linear fusion
    chain, final classifier. The multitask forward returns
    (fused_logits, visual_logits, skel_logits).
  * the search space: 4*4*2 = 32 one-row unfoldings.
"""

from __future__ import annotations

import numpy as np
from torch import nn

from mfas_tpu_torch.core import functional as F
from mfas_tpu_torch.core import layers as L
from mfas_tpu_torch.fusion.layers import (build_alphas, build_fusion_layers,
                                          enumerate_layer_confs,
                                          progressive_fuse)
from mfas_tpu_torch.models.ntu import Skeleton, Visual


def tap_sizes(args):
    """rgb sizes [512,1024,2048,2048] are the ResNet-50 stage widths (base
    width 64 x [8,16,32,32]) and scale with resnet3d_base_width."""
    w = int(getattr(args, "resnet3d_base_width", 64))
    # skeleton tap 2 is the flattened out7 map, 256*max((wl//16)**2, 1)
    # wide; the reference's vid_len[1]*32 formula matches it only for
    # window lengths 8 and 32, so reject the others here
    wl = int(args.vid_len[1])
    true_w = 256 * max((wl // 16) ** 2, 1)
    if wl * 32 != true_w:
        raise ValueError(
            f"vid_len[1]={wl}: the reference's skeleton tap-size formula "
            f"vid_len[1]*32={wl * 32} disagrees with the real flattened "
            f"tap width 256*max((vid_len[1]//16)**2,1)={true_w}; only "
            "window lengths 8 and 32 are supported")
    sizes_ske = [128, 256, wl * 32, 512]
    sizes_ims = [w * 8, w * 16, w * 32, w * 32]
    return sizes_ske, sizes_ims


class Searchable_Skeleton_Image_Net(nn.Module):
    def __init__(self, args, conf, *, device, generator):
        super().__init__()
        self.conf = np.asarray(conf)
        self.args = args
        kw = dict(device=device, generator=generator)

        self.rgbnet = Visual(args, **kw)
        self.skenet = Skeleton(args, **kw)

        sizes_ske, sizes_ims = tap_sizes(args)
        self.alphas = build_alphas(self.conf, sizes_ske, sizes_ims, **kw)
        self.fusion_layers = build_fusion_layers(
            self.conf, sizes_ske, sizes_ims, args.inner_representation_size,
            args.drpt, args.batchnorm, **kw)
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
        image, skeleton = tensor_tuple[0], tensor_tuple[1]
        vis = self.rgbnet(image)
        visual_logits = vis[-1]
        visual_taps = vis[1:5]  # fm2, fm3, fm4, pooled
        ske_hidden, skel_logits = self.skenet(skeleton)
        ske_taps = ske_hidden[-4:]

        feats_v = [F.global_avg_pool2d(visual_taps[int(r[1])])
                   for r in self.conf]
        feats_s = [F.global_avg_pool2d(ske_taps[int(r[0])]) for r in self.conf]
        out = progressive_fuse(self, feats_s, feats_v)
        if not self.args.multitask:
            return out
        return out, visual_logits, skel_logits


def get_possible_layer_configurations(progression_index=None):
    """32 rows: ske in [0,4), rgb in [0,4), act in [0,2)."""
    return enumerate_layer_confs(4, 4, 2)
