"""MM-IMDB model family (port of mfas_tpu/models/mm_imdb.py).

  * GP_VGG: the VGG-19 trunk with GlobalPooling2D taps after module indices
    20/26/33/36 (all 512-d) and a BatchNorm + Linear classifier on the last
    tap; returns (gp1, gp2, gp3, gp4, logits).
  * SimpleRecurrentModel: two GRUs over padded GloVe sequences, dropout
    0.666 between them in train mode only, the last valid step classified.
  * MaxOut_MLP: the maxout text net, returning (o1, o3, o5).
  * Late fusion: SimpleVTNet (LeNet image net), VGGVTNet.
  * CentralNets: VGGT_CentralNet and SimpleVT_CentralNet with U(0,1) scalar
    alphas, VGGT_CentralNetV2 with zero-init sigmoid gate vectors.
  * WeightedCrossEntropyWithLogits (core/functional.py holds the formula).

The LeNet image net is models/avmnist.py's GP_LeNet_Deeper, which returns
(logits, gp1..gp5): the reference's MM-IMDB copy returns (gp1..gp5, logits),
so the nets below index the reused order. Every net returns (text logits,
image logits, fusion logits) or the fusion logits alone; the engine reads
the last.
"""

from __future__ import annotations

import torch
from torch import nn

from mfas_tpu_torch.core import functional as F
from mfas_tpu_torch.core import init as I
from mfas_tpu_torch.core import layers as L
from mfas_tpu_torch.core.rnn import GRU
from mfas_tpu_torch.models.avmnist import (GP_LeNet_Deeper, _lateral_pad,
                                           fuse_features)
from mfas_tpu_torch.models.vgg import vgg19_features

# tap positions in the VGG feature stack (reference :41-51)
_VGG_TAPS = (20, 26, 33, 36)
# the width of every VGG tap
_VGG_TAP = 512


class GP_VGG(nn.Module):
    """Returns (gp1, gp2, gp3, gp4, logits)."""

    def __init__(self, args, *, device, generator):
        super().__init__()
        self.vgg = vgg19_features(device=device, generator=generator)
        self.bn4 = L.BatchNorm1d(_VGG_TAP, device=device)
        self.classifier = L.Linear(_VGG_TAP, args.num_outputs, device=device,
                                   generator=generator)

    def forward(self, x):
        taps = []
        for i, layer in enumerate(self.vgg):
            x = layer(x)
            if i in _VGG_TAPS:
                taps.append(F.global_avg_pool2d(x))
        return (*taps, self.classifier(self.bn4(taps[3])))


class SimpleRecurrentModel(nn.Module):
    """2xGRU text net over (B, T, feats) padded input and (B,) lengths.

    The reference's dropout between the GRUs also fires in eval mode; here,
    as in the JAX package, it runs in train mode only."""

    def __init__(self, args, num_hidden=100, number_input_feats=100, *,
                 device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.num_hidden = num_hidden
        self.embedding1 = GRU(number_input_feats, num_hidden, **kw)
        self.embedding2 = GRU(num_hidden, num_hidden, **kw)
        self.drop = L.Dropout(0.666)
        self.hid2val = L.Linear(num_hidden, args.num_outputs, **kw)

    def forward(self, padded_input, input_lengths):
        out1, _ = self.embedding1(padded_input)
        out2, _ = self.embedding2(self.drop(out1))
        idx = (torch.as_tensor(input_lengths, device=out2.device).long()
               - 1)
        last = out2[torch.arange(out2.shape[0], device=out2.device), idx]
        return self.hid2val(last)


class MaxOut_MLP(nn.Module):
    """Maxout(5) -> BN+Drop -> Maxout(5) -> BN+Drop -> Linear; returns
    (o1, o3, o5)."""

    def __init__(self, args, first_hidden=64, number_input_feats=300, *,
                 device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.op1 = L.Maxout(number_input_feats, first_hidden, 5, **kw)
        self.op2 = nn.Sequential(L.BatchNorm1d(first_hidden, device=device),
                                 L.Dropout(0.5))
        self.op3 = L.Maxout(first_hidden, first_hidden * 2, 5, **kw)
        self.op4 = nn.Sequential(
            L.BatchNorm1d(first_hidden * 2, device=device), L.Dropout(0.5))
        self.hid2val = L.Linear(first_hidden * 2, args.num_outputs, **kw)

    def forward(self, x):
        o1 = self.op1(x)
        o3 = self.op3(self.op2(o1))
        o5 = self.hid2val(self.op4(o3))
        return o1, o3, o5


class SimpleVTNet(nn.Module):
    """Late fusion: deepest LeNet tap + maxout text feature."""

    def __init__(self, args, text_first_hidden, image_channels, *, device,
                 generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.image_net = GP_LeNet_Deeper(args, image_channels, **kw)
        self.text_net = MaxOut_MLP(args, text_first_hidden, **kw)
        self.classifier = L.Linear(
            int(16 * args.channels + 2 * text_first_hidden),
            args.num_outputs, **kw)

    def central_params(self):
        return ["classifier"]

    def forward(self, text, image):
        img = self.image_net(image)
        _, t_o2, _ = self.text_net(text)
        return self.classifier(torch.cat([t_o2, img[5]], dim=1))


class VGGVTNet(nn.Module):
    """Late fusion: the BatchNorm'd deepest VGG tap + maxout text feature."""

    def __init__(self, args, text_first_hidden, image_channels=3, *, device,
                 generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.image_net = GP_VGG(args, **kw)
        self.text_net = MaxOut_MLP(args, text_first_hidden, **kw)
        self.classifier = L.Linear(int(_VGG_TAP + 2 * text_first_hidden),
                                   args.num_outputs, **kw)
        self.bn4 = L.BatchNorm1d(_VGG_TAP, device=device)

    def central_params(self):
        return ["classifier"]

    def forward(self, text, image):
        gp4 = self.image_net(image)[3]
        _, t_o2, _ = self.text_net(text)
        return self.classifier(torch.cat([t_o2, self.bn4(gp4)], dim=1))


_ALPHAS = ("alpha1_feat1", "alpha2_feat1", "alpha1_feat2", "alpha2_feat2",
           "alpha_conv1", "alpha_conv2")


def _central_params():
    return ["central_conv1", "central_conv2", "central_classifier", *_ALPHAS]


def _check_text_width(text_first_hidden):
    """The VGG CentralNets fuse the text net's second maxout output
    (2 * text_first_hidden wide) with a 512-d VGG tap into layers sized for
    the tap; a wider text output fails in the JAX package at the first
    forward, as a shape error deep in the fusion."""
    if 2 * int(text_first_hidden) > _VGG_TAP:
        raise ValueError(
            f"--text_first_hidden {text_first_hidden}: the VGG CentralNets "
            f"need 2 * text_first_hidden <= {_VGG_TAP} (the VGG taps' width);"
            " use --text_first_hidden 256")


def _vgg_mix(args, gp):
    mix = {"11,24": (gp[0], gp[3]), "13,24": (gp[2], gp[3]),
           "12,24": (gp[1], gp[3])}
    if args.fusingmix not in mix:
        raise ValueError(f"fusingmix {args.fusingmix} not implemented")
    return mix[args.fusingmix]


class VGGT_CentralNet(nn.Module):
    """Linear central column over BatchNorm'd VGG taps + maxout text."""

    def __init__(self, args, text_first_hidden, image_channels=3, *, device,
                 generator):
        super().__init__()
        _check_text_width(text_first_hidden)
        kw = dict(device=device, generator=generator)
        self.args = args
        self.image_net = GP_VGG(args, **kw)
        self.text_net = MaxOut_MLP(args, text_first_hidden, **kw)
        rand = I.uniform(0.0, 1.0)       # torch.rand init
        for name in _ALPHAS:
            setattr(self, name, nn.Parameter(rand(generator, (1,), device)))
        for i in range(1, 5):
            setattr(self, f"bn{i}", L.BatchNorm1d(_VGG_TAP, device=device))

        nodes, inunits = args.channels, _VGG_TAP
        if args.fusetype == "cat":
            nodes *= 2
            inunits *= 2
        self.central_conv1 = L.Linear(inunits, args.channels, **kw)
        self.central_conv2 = L.Linear(inunits, args.channels, **kw)
        # built, as in the reference, but never run
        self.bnc1 = L.BatchNorm1d(args.channels, device=device)
        self.bnc2 = L.BatchNorm1d(args.channels, device=device)
        self.central_classifier = L.Linear(nodes, args.num_outputs, **kw)

    def central_params(self):
        return _central_params()

    def forward(self, text, image):
        gps = self.image_net(image)
        gp = [getattr(self, f"bn{i + 1}")(gps[i]) for i in range(4)]
        t_o1, t_o2, t_out = self.text_net(text)
        im1, im2 = _vgg_mix(self.args, gp)
        ft = self.args.fusetype
        fuse1 = fuse_features(t_o1, im1, self.alpha1_feat1, self.alpha1_feat2,
                              ft)
        fuse2 = fuse_features(t_o2, im2, self.alpha2_feat1, self.alpha2_feat2,
                              ft)
        cc1 = torch.relu(self.central_conv1(fuse1))
        cc2 = torch.relu(self.central_conv2(fuse2))
        fuse3 = fuse_features(cc1, cc2, self.alpha_conv1, self.alpha_conv2, ft)
        return t_out, gps[4], self.central_classifier(fuse3)


class SimpleVT_CentralNet(nn.Module):
    """Conv1d central column over LeNet taps + maxout text."""

    def __init__(self, args, text_first_hidden, image_channels, *, device,
                 generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.args = args
        self.image_net = GP_LeNet_Deeper(args, image_channels, **kw)
        self.text_net = MaxOut_MLP(args, text_first_hidden, **kw)
        rand = I.uniform(0.0, 1.0)
        for name in _ALPHAS:
            setattr(self, name, nn.Parameter(rand(generator, (1,), device)))
        self.central_conv1 = L.Conv1d(1, 1, kernel_size=3, padding=1,
                                      bias=False, **kw)
        self.central_conv2 = L.Conv1d(1, 1, kernel_size=3, padding=1,
                                      bias=False, **kw)
        if args.fusingmix in ("11,25", "13,25"):
            nodes = 384
        elif args.fusingmix == "11,23":
            nodes = 256
        else:
            raise ValueError(f"fusingmix {args.fusingmix} not implemented")
        if args.fusetype == "cat":
            nodes *= 2
        self.central_classifier = L.Linear(nodes, args.num_outputs, **kw)

    def central_params(self):
        return _central_params()

    def forward(self, text, image):
        img = self.image_net(image)
        im_out, gp = img[0], img[1:]
        t_o1, t_o2, t_out = self.text_net(text)
        # '13' maps to gp2: a reference quirk (mm_imdb.py:458 uses im_gp2
        # for fusingmix '13,25')
        im1, im2 = {"11,23": (gp[0], gp[2]), "11,25": (gp[0], gp[4]),
                    "13,25": (gp[1], gp[4])}[self.args.fusingmix]
        ft = self.args.fusetype
        fuse1 = fuse_features(t_o1, im1, self.alpha1_feat1, self.alpha1_feat2,
                              ft)
        fuse2 = fuse_features(t_o2, im2, self.alpha2_feat1, self.alpha2_feat2,
                              ft)
        one = fuse1.new_ones((1,))
        cc1 = torch.relu(self.central_conv1(fuse1[:, None, :]))
        cc1 = fuse_features(cc1[:, 0, :], fuse2, self.alpha_conv1, one,
                            "wsum")
        cc2 = torch.relu(self.central_conv2(cc1[:, None, :]))
        return t_out, im_out, self.central_classifier(cc2[:, 0, :])


class VGGT_CentralNetV2(nn.Module):
    """V2: per-feature sigmoid gate vectors (zero-init, so every gate
    starts at 0.5) instead of scalar alphas."""

    def __init__(self, args, text_first_hidden, image_channels=3, *, device,
                 generator):
        super().__init__()
        _check_text_width(text_first_hidden)
        kw = dict(device=device, generator=generator)
        self.args = args
        self.image_net = GP_VGG(args, **kw)
        self.text_net = MaxOut_MLP(args, text_first_hidden, **kw)
        for i in range(1, 5):
            setattr(self, f"bn{i}", L.BatchNorm1d(_VGG_TAP, device=device))

        nodes, inunits = args.channels, _VGG_TAP
        for name in _ALPHAS[:4]:
            setattr(self, name, nn.Parameter(
                I.zeros(generator, (1, inunits), device)))
        if args.fusetype == "cat":
            nodes *= 2
            inunits *= 2
        for name in _ALPHAS[4:]:
            setattr(self, name, nn.Parameter(
                I.zeros(generator, (1, args.channels), device)))
        self.central_conv1 = L.Linear(inunits, args.channels, **kw)
        self.central_conv2 = L.Linear(inunits, args.channels, **kw)
        # built, as in the reference, but never run
        self.bnc1 = L.BatchNorm1d(args.channels, device=device)
        self.bnc2 = L.BatchNorm1d(args.channels, device=device)
        self.central_classifier = L.Linear(nodes, args.num_outputs, **kw)

    def central_params(self):
        return _central_params()

    @staticmethod
    def _gated_fuse(f1, f2, a1, a2, fusetype):
        """Both features zero-padded to the wider one, gated by
        sigmoid(a1)/sigmoid(a2), then concatenated or summed."""
        width = max(f1.shape[1], f2.shape[1])
        in1 = _lateral_pad(f1, width - f1.shape[1]) * torch.sigmoid(a1)
        in2 = _lateral_pad(f2, width - f2.shape[1]) * torch.sigmoid(a2)
        if fusetype == "cat":
            return torch.cat([in1, in2], dim=1)
        return in1 + in2

    def forward(self, text, image):
        gps = self.image_net(image)
        gp = [getattr(self, f"bn{i + 1}")(gps[i]) for i in range(4)]
        t_o1, t_o2, t_out = self.text_net(text)
        im1, im2 = _vgg_mix(self.args, gp)
        ft = self.args.fusetype
        fuse1 = self._gated_fuse(t_o1, im1, self.alpha1_feat1,
                                 self.alpha1_feat2, ft)
        fuse2 = self._gated_fuse(t_o2, im2, self.alpha2_feat1,
                                 self.alpha2_feat2, ft)
        cc1 = torch.relu(self.central_conv1(fuse1))
        cc2 = torch.relu(self.central_conv2(fuse2))
        fuse3 = self._gated_fuse(cc1, cc2, self.alpha_conv1, self.alpha_conv2,
                                 ft)
        return t_out, gps[4], self.central_classifier(fuse3)


class WeightedCrossEntropyWithLogits(nn.Module):
    """Mean weighted BCE over logits (reference aux_models.py:129-147)."""

    def __init__(self, pos_weight):
        super().__init__()
        self.pos_weight = pos_weight

    def forward(self, logits, targets):
        return F.weighted_bce_with_logits(logits, targets, self.pos_weight)
