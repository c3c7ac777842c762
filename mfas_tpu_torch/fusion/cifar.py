"""CIFAR searchable micro-CNN and its search space (port of
mfas_tpu/fusion/cifar.py; reference models/search/cifar_searchable.py).

conf rows are [op1, op2, conn1, conn2] with conn in [-2, block_index);
cells are stacked per ``args.net_str`` (2 marks a reduction point, where
every accumulated output is downsampled by its own FactorizedReduction);
search-time cells sum unused blocks, found-arch (fixed=True) cells concat +
reduce and double ``args.planes`` after each reduction, mutating the
caller's args as the reference does (:257-285). The aux head reads the cell
output at index ``int(last_cell * 0.666)`` (:240-243).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from mfas_tpu_torch.core import functional as F
from mfas_tpu_torch.core import init as I
from mfas_tpu_torch.core import layers as L
from mfas_tpu_torch.models.enas_cell import (AuxiliaryHead, Cell,
                                             FactorizedReduction, FixedCell)

OPERATION_LABELS = ['I', '3x3 conv', '5x5 conv', '3x3 depthconv',
                    '5x5 depthconv', '7x7 depthconv', '3x3 maxpool',
                    '3x3 avgpool']


def get_possible_layer_configurations(progression_index):
    """All [op1, op2, conn1, conn2] rows with op1 != op2 among the first 5
    ops and both connections in [-2, progression_index) (:65-79)."""
    num_ops_per_block = 5
    label_list = []
    for op1i in range(num_ops_per_block):
        for op2i in range(num_ops_per_block):
            if op1i == op2i:
                continue
            for bi1 in range(-2, progression_index):
                for bi2 in range(-2, progression_index):
                    label_list.append([op1i, op2i, bi1, bi2])
    return label_list


class Searchable_MicroCNN(nn.Module):
    """forward(x (N,3,H,W)) -> (logits, aux_logits)."""

    def __init__(self, args, configuration, fixed=False, *, device,
                 generator):
        super().__init__()
        conf = np.asarray(configuration, np.int64)
        if conf.ndim == 1:
            conf = conf[None, :]
        self.conf = conf
        self._network_shape = list(args.net_str)
        kw = dict(device=device, generator=generator)
        planes = int(args.planes)

        self.input_conv = nn.Sequential(
            L.Conv2d(3, planes, 3, padding=1, bias=False, **kw),
            L.BatchNorm2d(planes, eps=1e-3, device=device))

        self.cell_array = nn.ModuleList()
        self.pooled_layers = nn.ModuleList()
        for layer_red in self._network_shape:
            cls = FixedCell if fixed else Cell
            self.cell_array.append(cls(OPERATION_LABELS, conf[:, 0:2],
                                       conf[:, 2:], args, **kw))
            if layer_red == 2:
                out_planes = args.planes * (2 if fixed else 1)
                for _ in range(len(self.cell_array) + 1):
                    self.pooled_layers.append(FactorizedReduction(
                        args.planes, out_planes, **kw))
                if fixed:
                    args.planes *= 2

        self.classifier = L.Linear(int(args.planes), args.num_outputs, **kw)
        self.dropout_cla = L.Dropout(args.drop_prob)
        self.aux_head = AuxiliaryHead(args.num_outputs, args.planes, **kw)

        # the reference re-draws EVERY Conv2d weight of the assembled net
        # with kaiming_uniform(fan_in, relu), the aux head and reductions
        # included; biases and the Linears keep torch defaults (:215-217)
        ku = I.kaiming_uniform(0.0)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, L.Conv2d):
                    m.weight.copy_(ku(generator, m.weight.shape, device))

    def forward(self, x):
        cell_outputs = [self.input_conv(x)]
        pool_layer_id = 0
        for index_cell, cell in enumerate(self.cell_array):
            if index_cell == 0:
                out = cell(cell_outputs[0], cell_outputs[0])
            else:
                out = cell(cell_outputs[-2], cell_outputs[-1])
            cell_outputs.append(out)
            if self._network_shape[index_cell] == 2:
                for idx in range(len(cell_outputs)):
                    cell_outputs[idx] = self.pooled_layers[pool_layer_id](
                        cell_outputs[idx])
                    pool_layer_id += 1

        out = F.adaptive_avg_pool2d_1x1(cell_outputs[-1])
        out = self.classifier(self.dropout_cla(out.reshape(out.shape[0], -1)))
        iout = self.aux_head(cell_outputs[int(index_cell * 0.666)])
        return out, iout
