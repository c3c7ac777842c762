"""ENAS-style micro-cell machinery of the CIFAR vertical (port of
mfas_tpu/models/enas_cell.py; reference models/auxiliary/aux_models.py:
152-540).

  * CreateOp: the 10-way op factory (identity-ish 1x1, conv 1/3/5/7,
    separable 3/5/7, max/avg pool branches), by label or index;
  * ConvBranch, SeparableConvOld, SeparableConv, PoolBranch,
    FactorizedReduction (the stride-2 form, the only one the network
    builds), AuxiliaryHead, and the reference's zero paddings
    Tensor1DLateralPadding and ChannelPadding;
  * CellBlock with DropPath: ONE uniform draw per DropPath per train-mode
    forward, from the engine's generator (a whole-batch decision, inverted
    scaling); the decision stays a tensor, so a dropped op's gradient is
    zeros, as under the JAX package's ``jnp.where``, and no draw syncs the
    host;
  * Cell (search time: the SUM of unused block outputs, then BatchNorm) and
    FixedCell (found-arch training: their CONCAT, then a 1x1 reduction).

The ``nn.Sequential`` nesting gives the JAX package's ``flatten_tree`` keys
(``op1.0.0.weight`` for IdentityOp, ``path2.1.weight`` for a
FactorizedReduction's second path), so a JAX tree loads with strict keys.
Layers with parameters take a keyword ``device`` and a ``torch.Generator``
(``generator``) that draws their initial values.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from mfas_tpu_torch.core import functional as F
from mfas_tpu_torch.core import layers as L


class SeparableConvOld(nn.Module):
    def __init__(self, in_planes, out_planes, kernel_size, *, device,
                 generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        padding = (kernel_size - 1) // 2
        self.depthwise = L.Conv2d(in_planes, in_planes, kernel_size,
                                  padding=padding, groups=in_planes,
                                  bias=False, **kw)
        self.pointwise = L.Conv2d(in_planes, out_planes, 1, bias=False, **kw)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


class SeparableConv(nn.Module):
    """The double separable stack (aux_models.py:437-457): depthwise,
    pointwise, BatchNorm (eps 1e-3), ReLU, twice. No op of the search space
    builds it (CreateOp's separable ops are SeparableConvOld)."""

    def __init__(self, in_planes, out_planes, kernel_size, bias=False, *,
                 device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        padding = (kernel_size - 1) // 2
        self.op = nn.Sequential(
            L.Conv2d(in_planes, in_planes, kernel_size, padding=padding,
                     groups=in_planes, bias=bias, **kw),
            L.Conv2d(in_planes, out_planes, 1, bias=bias, **kw),
            L.BatchNorm2d(out_planes, eps=1e-3, device=device),
            L.ReLU(),
            L.Conv2d(out_planes, out_planes, kernel_size, padding=padding,
                     groups=out_planes, bias=bias, **kw),
            L.Conv2d(out_planes, out_planes, 1, bias=False, **kw),
            L.BatchNorm2d(out_planes, eps=1e-3, device=device),
            L.ReLU())

    def forward(self, x):
        return self.op(x)


def _conv_bn_relu(in_planes, out_planes, kernel_size, padding, device,
                  generator):
    return nn.Sequential(
        L.Conv2d(in_planes, out_planes, kernel_size, padding=padding,
                 bias=False, device=device, generator=generator),
        L.BatchNorm2d(out_planes, device=device), L.ReLU())


class ConvBranch(nn.Module):
    def __init__(self, in_planes, out_planes, kernel_size, separable=False, *,
                 device, generator):
        super().__init__()
        if kernel_size not in (1, 3, 5, 7):
            raise ValueError(f"kernel_size {kernel_size} not in 1, 3, 5, 7")
        self.inp_conv1 = _conv_bn_relu(in_planes, out_planes, 1, 0, device,
                                       generator)
        if separable:
            self.out_conv = nn.Sequential(
                SeparableConvOld(out_planes, out_planes, kernel_size,
                                 device=device, generator=generator),
                L.BatchNorm2d(out_planes, device=device), L.ReLU())
        else:
            self.out_conv = _conv_bn_relu(out_planes, out_planes,
                                          kernel_size, (kernel_size - 1) // 2,
                                          device, generator)

    def forward(self, x):
        return self.out_conv(self.inp_conv1(x))


class PoolBranch(nn.Module):
    def __init__(self, in_planes, out_planes, avg_or_max, *, device,
                 generator):
        super().__init__()
        self.conv1 = _conv_bn_relu(in_planes, out_planes, 1, 0, device,
                                   generator)
        if avg_or_max == "avg":
            # pads 1 and counts the padding in each window's mean
            self.pool = L.AvgPool2d(3, stride=1, padding=1)
        elif avg_or_max == "max":
            self.pool = L.MaxPool2d(3, stride=1, padding=1)
        else:
            raise ValueError(f"Unknown pool {avg_or_max}")

    def forward(self, x):
        return self.pool(self.conv1(x))


def IdentityOp(in_planes, out_planes, *, device, generator):
    """conv_type 0: 1x1 conv+BN+ReLU then identity (aux_models.py:470-475).
    A bare Sequential, as the reference's: its keys sit directly under the
    owning attribute (``op{1,2}.0.0.weight``)."""
    return nn.Sequential(
        _conv_bn_relu(in_planes, out_planes, 1, 0, device, generator),
        L.Identity())


OP_NAMES = {'I': 0, '1x1 conv': 1, '3x3 conv': 2, '5x5 conv': 3,
            '7x7 conv': 4, '3x3 depthconv': 5, '5x5 depthconv': 6,
            '7x7 depthconv': 7, '3x3 maxpool': 8, '3x3 avgpool': 9}


def CreateOp(conv_type, input_planes=64, output_planes=64, *, device,
             generator):
    """The op of ``conv_type``, a label of OP_NAMES or its index."""
    kw = dict(device=device, generator=generator)
    table = {
        0: lambda: IdentityOp(input_planes, output_planes, **kw),
        1: lambda: ConvBranch(input_planes, output_planes, 1, **kw),
        2: lambda: ConvBranch(input_planes, output_planes, 3, **kw),
        3: lambda: ConvBranch(input_planes, output_planes, 5, **kw),
        4: lambda: ConvBranch(input_planes, output_planes, 7, **kw),
        5: lambda: ConvBranch(input_planes, output_planes, 3, separable=True,
                              **kw),
        6: lambda: ConvBranch(input_planes, output_planes, 5, separable=True,
                              **kw),
        7: lambda: ConvBranch(input_planes, output_planes, 7, separable=True,
                              **kw),
        8: lambda: PoolBranch(input_planes, output_planes, "max", **kw),
        9: lambda: PoolBranch(input_planes, output_planes, "avg", **kw),
    }
    key = OP_NAMES.get(conv_type, conv_type)
    if key not in table:
        raise NotImplementedError(conv_type)
    return table[key]()


class DropPath(L.StochasticLayer):
    """Whole-output stochastic path with inverted scaling
    (aux_models.py:527-540). forward -> (out, dropped), ``dropped`` a bool
    tensor; an output is kept whenever ``other_dropped`` (its sibling was
    dropped)."""

    def __init__(self, keep_prob=0.9):
        super().__init__()
        self.keep_prob = keep_prob

    def forward(self, x, other_dropped=None):
        if not self.training or self.keep_prob >= 1.0:
            return x, torch.zeros((), dtype=torch.bool, device=x.device)
        p = torch.rand((), generator=self._train_generator(),
                       device=x.device, dtype=x.dtype)
        keep = p <= self.keep_prob
        if other_dropped is not None:
            keep = keep | other_dropped
        return torch.where(keep, x / self.keep_prob, torch.zeros_like(x)), ~keep


class CellBlock(nn.Module):
    def __init__(self, op1_type, op2_type, args, *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.op1 = CreateOp(op1_type, args.planes, args.planes, **kw)
        self.op2 = CreateOp(op2_type, args.planes, args.planes, **kw)
        self.op1_type = op1_type
        self.op2_type = op2_type
        self.dp1 = DropPath(1.0 - args.drop_path)
        self.dp2 = DropPath(1.0 - args.drop_path)

    def forward(self, x1, x2):
        xa, xa_dropped = self.dp1(self.op1(x1))
        xb, _ = self.dp2(self.op2(x2), xa_dropped)
        return xa + xb


class _CellBase(nn.Module):
    def __init__(self, operation_labels, configuration_indexes, connections,
                 args, *, device, generator):
        super().__init__()
        self._configuration = configuration_indexes
        self._connections = np.asarray(connections)
        self._operation_labels = operation_labels
        self._planes = args.planes
        self.blocks = nn.ModuleList()
        self.block_used = [False] * len(self._connections)
        for b_i, block_conf in enumerate(self._configuration):
            self.blocks.append(CellBlock(
                operation_labels[int(block_conf[0])],
                operation_labels[int(block_conf[1])], args, device=device,
                generator=generator))
            for c in self._connections[b_i]:
                if c >= 0:
                    self.block_used[int(c)] = True
        self.num_concatenations = sum(1 for bu in self.block_used if not bu)

    def _block_outputs(self, x1, x2):
        """The outputs of the blocks no later block reads."""
        outs = [x1, x2]
        for b_i, block in enumerate(self.blocks):
            c0, c1 = (int(v) + 2 for v in self._connections[b_i])
            outs.append(block(outs[c0], outs[c1]))
        return [o for i, o in enumerate(outs[2:]) if not self.block_used[i]]


class Cell(_CellBase):
    """Search-time cell: SUM of unused block outputs + BN
    (aux_models.py:195-211)."""

    def __init__(self, operation_labels, configuration_indexes, connections,
                 args, *, device, generator):
        super().__init__(operation_labels, configuration_indexes, connections,
                         args, device=device, generator=generator)
        self.bn = L.BatchNorm2d(self._planes, eps=1e-3, device=device)

    def forward(self, x1, x2):
        unused = self._block_outputs(x1, x2)
        out = unused[0]
        for o in unused[1:]:
            out = out + o
        return self.bn(out)


class FixedCell(_CellBase):
    """Found-arch cell: CONCAT of unused outputs + 1x1 reduce
    (aux_models.py:255-274)."""

    def __init__(self, operation_labels, configuration_indexes, connections,
                 args, *, device, generator):
        super().__init__(operation_labels, configuration_indexes, connections,
                         args, device=device, generator=generator)
        self.dim_reduc = nn.Sequential(
            L.Conv2d(self.num_concatenations * self._planes, self._planes, 1,
                     bias=False, device=device, generator=generator),
            L.ReLU(), L.BatchNorm2d(self._planes, device=device))

    def forward(self, x1, x2):
        return self.dim_reduc(torch.cat(self._block_outputs(x1, x2), dim=1))


class FactorizedReduction(nn.Module):
    """Halve spatial dims, optionally change filters
    (aux_models.py:300-344, stride 2)."""

    def __init__(self, in_planes, out_planes, *, device, generator):
        super().__init__()
        if out_planes % 2:
            raise ValueError(f"out_planes {out_planes} is odd")
        kw = dict(device=device, generator=generator)
        self.path1 = nn.Sequential(
            L.AvgPool2d(1, stride=2),
            L.Conv2d(in_planes, out_planes // 2, 1, bias=False, **kw))
        self.path2 = nn.Sequential(
            L.AvgPool2d(1, stride=2),
            L.Conv2d(in_planes, out_planes // 2, 1, bias=False, **kw))
        self.bn = L.BatchNorm2d(out_planes, device=device)

    def forward(self, x):
        p1 = self.path1(x)
        # shift-by-one path: pad bottom/right, then crop top/left
        shifted = torch.nn.functional.pad(x, (0, 1, 0, 1))[:, :, 1:, 1:]
        p2 = self.path2(shifted)
        return self.bn(torch.cat([p1, p2], dim=1))


class AuxiliaryHead(nn.Module):
    """(aux_models.py:501-520)."""

    def __init__(self, num_classes, filters=96, *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.features = nn.Sequential(
            L.AvgPool2d(5, stride=2, padding=0, count_include_pad=False),
            L.Conv2d(filters, filters * 2, 1, bias=False, **kw),
            L.BatchNorm2d(filters * 2, device=device), L.ReLU(),
            L.Conv2d(filters * 2, filters * 6, 2, bias=False, **kw),
            L.BatchNorm2d(filters * 6, device=device), L.ReLU())
        self.classifier = L.Linear(filters * 6, num_classes, **kw)

    def forward(self, x):
        x = F.adaptive_avg_pool2d_1x1(self.features(x))
        return self.classifier(x.reshape(x.shape[0], -1))


# small pieces the reference's aux_models also exports
class Tensor1DLateralPadding(nn.Module):
    """(B, C) -> (B, C + pad), zeros appended."""

    def __init__(self, pad):
        super().__init__()
        self.pad = pad

    def forward(self, x):
        return torch.cat([x, x.new_zeros((x.shape[0], self.pad))], dim=1)


class ChannelPadding(nn.Module):
    """(B, C, ...) -> (B, C + pad, ...), zero channels appended."""

    def __init__(self, pad):
        super().__init__()
        self.pad = pad

    def forward(self, x):
        return torch.cat([x, x.new_zeros((x.shape[0], self.pad)
                                         + tuple(x.shape[2:]))], dim=1)
