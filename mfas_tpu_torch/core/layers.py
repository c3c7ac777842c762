"""Layers of the ported paths (port of mfas_tpu/core/layers.py).

``nn.Module``s whose ``state_dict`` keys are the JAX package's tree paths:
``weight``, ``bias``, ``running_mean``, ``running_var``,
``num_batches_tracked``, ``alpha_x``, ``alpha``, ``beta``, and ``0``, ``1``,
... in a ``ParamList``. Layers with parameters take a keyword
``device`` and a ``torch.Generator`` (``generator``) that draws their initial
values.
"""

from __future__ import annotations

import torch
from torch import nn

from mfas_tpu_torch.core import functional as F
from mfas_tpu_torch.core import init as I
from mfas_tpu_torch.ops.batchnorm import batch_norm
from mfas_tpu_torch.parallel.mesh import group_rank, group_size


# --------------------------------------------------------------------------
# parametric layers
# --------------------------------------------------------------------------
class Linear(nn.Module):
    def __init__(self, in_features, out_features, bias=True, weight_init=None,
                 bias_init=None, *, device, generator):
        super().__init__()
        wshape = (int(out_features), int(in_features))
        self.weight = nn.Parameter((weight_init or I.torch_default_weight)(
            generator, wshape, device))
        if bias:
            binit = bias_init or I.torch_default_bias(wshape)
            self.bias = nn.Parameter(binit(generator, (wshape[0],), device))
        else:
            self.bias = None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


def _tuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _ConvNd(nn.Module):
    _ndim = 2
    _fn = staticmethod(F.conv2d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, bias=True, weight_init=None,
                 bias_init=None, *, device, generator):
        super().__init__()
        self.stride = _tuple(stride, self._ndim)
        self.padding = _tuple(padding, self._ndim)
        self.dilation = _tuple(dilation, self._ndim)
        self.groups = groups
        wshape = ((int(out_channels), int(in_channels) // groups)
                  + _tuple(kernel_size, self._ndim))
        self.weight = nn.Parameter((weight_init or I.torch_default_weight)(
            generator, wshape, device))
        if bias:
            binit = bias_init or I.torch_default_bias(wshape)
            self.bias = nn.Parameter(binit(generator, (wshape[0],), device))
        else:
            self.bias = None

    def forward(self, x):
        return self._fn(x, self.weight, self.bias, stride=self.stride,
                        padding=self.padding, dilation=self.dilation,
                        groups=self.groups)


class Conv1d(_ConvNd):
    _ndim = 1
    _fn = staticmethod(F.conv1d)


class Conv2d(_ConvNd):
    _ndim = 2
    _fn = staticmethod(F.conv2d)


class Conv3d(_ConvNd):
    _ndim = 3
    _fn = staticmethod(F.conv3d)


class _BatchNorm(nn.Module):
    """torch BatchNorm keys, with the JAX package's numerics:

    * train mode: batch statistics in f32 in ONE pass (E[x^2] - E[x]^2,
      clamped at 0), biased variance normalizes, unbiased variance feeds the
      running average, which stays f32 (mfas_tpu/core/layers.py:171-210);
    * eval mode: the running statistics cast to the activation dtype
      (:211-216);
    * the normalization and the affine run in the activation dtype: under
      bf16 autocast ``weight``/``bias`` are cast to bf16 as the JAX
      package's ``cast_compute`` casts them, so they never promote the
      activations back to f32.

    ``update_running_stats = False`` makes a train-mode forward leave the
    running statistics and ``num_batches_tracked`` alone (the recomputation
    of a rematerialized segment, core/remat.py).

    ``group`` (``set_data_group``): a process group over which the batch is
    split by rows. The per-channel ``[sum x, sum x^2, count]`` go through a
    differentiable SUM over it (parallel/mesh.py::all_reduce_sum, whose
    backward sums the upstream gradient), so every rank normalizes with the
    statistics of the global batch and the running variance's unbiased
    factor counts the global rows. Without a group the same sums are used
    as they are.

    ``forward(x, residual=None, relu=False)`` adds ``residual`` to the
    output and then applies ReLU, where asked: on the card, the epilogue of
    the fused kernel (ops/batchnorm.py).
    """

    def __init__(self, num_features, eps=1e-5, momentum=0.1, *, device):
        super().__init__()
        n = int(num_features)
        self.eps = eps
        self.momentum = momentum
        self.update_running_stats = True
        self.group = None
        self.weight = nn.Parameter(torch.ones(n, device=device))
        self.bias = nn.Parameter(torch.zeros(n, device=device))
        self.register_buffer("running_mean", torch.zeros(n, device=device))
        self.register_buffer("running_var", torch.ones(n, device=device))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long, device=device))

    def forward(self, x, residual=None, relu=False):
        """relu?(BatchNorm(x) + residual?): ops/batchnorm.py::batch_norm,
        the fused kernels on the card and the plain version on the CPU."""
        return batch_norm(
            x, self.weight, self.bias, self.running_mean, self.running_var,
            self.num_batches_tracked, training=self.training,
            momentum=self.momentum, eps=self.eps,
            update_running_stats=self.update_running_stats, group=self.group,
            residual=residual, relu=relu)


class BatchNorm1d(_BatchNorm):
    pass


class BatchNorm2d(_BatchNorm):
    pass


class BatchNorm3d(_BatchNorm):
    pass


# --------------------------------------------------------------------------
# stateless layers
# --------------------------------------------------------------------------
class ReLU(nn.Module):
    def forward(self, x):
        return torch.relu(x)


class LeakyReLU(nn.Module):
    def __init__(self, negative_slope=0.01):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return torch.nn.functional.leaky_relu(x, self.negative_slope)


class Sigmoid(nn.Module):
    def forward(self, x):
        return torch.sigmoid(x)


class Tanh(nn.Module):
    def forward(self, x):
        return torch.tanh(x)


class ELU(nn.Module):
    def forward(self, x):
        return torch.nn.functional.elu(x)


class StochasticLayer(nn.Module):
    """A layer whose train-mode forward draws from ``self.generator``, a
    ``torch.Generator`` on the activations' device that the training engine
    hands to every such layer of its model (``set_dropout_generator``).
    A train-mode draw without one raises: nothing ever comes from torch's
    global RNG."""

    def __init__(self):
        super().__init__()
        self.generator = None
        # (dim, index, count): this rank's part of a batch split over a
        # process group (set_data_group); a mask is drawn at the global
        # shape and the rank keeps its part, so every rank's generator
        # advances alike and the ranks together draw the one-rank mask
        self.shard = None

    def _train_generator(self):
        if self.generator is None:
            raise RuntimeError(
                f"{type(self).__name__} in train mode has no generator: "
                "call core.layers.set_dropout_generator(model, generator)")
        return self.generator


class _DropoutBase(StochasticLayer):
    _fn = None

    def __init__(self, p=0.5):
        super().__init__()
        self.p = float(p)
        # a functional.MaskTape while a rematerialized segment runs
        # (core/remat.py)
        self.masks = None

    def forward(self, x):
        if not self.training:
            return x
        return type(self)._fn(x, self.p, self._train_generator(),
                              shards=(self.shard,) if self.shard else (),
                              masks=self.masks)


class Dropout(_DropoutBase):
    _fn = staticmethod(F.dropout)


class Dropout2d(_DropoutBase):
    _fn = staticmethod(F.dropout2d)


def set_dropout_generator(model, generator):
    """Point every dropout layer (every StochasticLayer) of ``model`` at
    ``generator``."""
    for m in model.modules():
        if isinstance(m, StochasticLayer):
            m.generator = generator


def set_data_group(model, group):
    """Hand ``group``, the process group over which ``model``'s batches are
    split by rows (parallel/mesh.py), to every BatchNorm (statistics over
    the global batch) and every StochasticLayer (masks drawn at the global
    shape); None undoes it. Like ``SyncBatchNorm.convert_sync_batchnorm``,
    the group lives on the layers, not in a global."""
    shard = (None if group is None
             else (0, group_rank(group), group_size(group)))
    for m in model.modules():
        if isinstance(m, _BatchNorm):
            m.group = group
        elif isinstance(m, StochasticLayer):
            m.shard = shard


def to_channels_last(model):
    """Give every 4-D and 5-D parameter of ``model`` (the convolution
    weights) the channels-last memory format of its rank (NHWC / NDHWC
    strides, the same shape and values), in place."""
    formats = {4: torch.channels_last, 5: torch.channels_last_3d}
    for p in model.parameters():
        if p.dim() in formats:
            p.data = p.data.contiguous(memory_format=formats[p.dim()])


class GlobalPooling2D(nn.Module):
    """Mean over every dim after the channel one (aux_models.py:54-64)."""

    def forward(self, x):
        return F.global_avg_pool2d(x)


class MaxPool2d(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__()
        self.kernel_size, self.stride, self.padding = (kernel_size, stride,
                                                       padding)

    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding)


class AvgPool2d(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0,
                 count_include_pad=True):
        super().__init__()
        self.kernel_size, self.stride, self.padding = (kernel_size, stride,
                                                       padding)
        self.count_include_pad = count_include_pad

    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.count_include_pad)


class AvgPool3d(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__()
        self.kernel_size, self.stride, self.padding = (kernel_size, stride,
                                                       padding)

    def forward(self, x):
        return F.avg_pool3d(x, self.kernel_size, self.stride, self.padding)


class AdaptiveAvgPool2d(nn.Module):
    """AdaptiveAvgPool2d((1, 1)), the only output size the reference
    uses."""

    def __init__(self, output_size=(1, 1)):
        super().__init__()
        if tuple(output_size) != (1, 1):
            raise ValueError(f"output_size {output_size}: only (1, 1) is "
                             "used by the reference")

    def forward(self, x):
        return F.adaptive_avg_pool2d_1x1(x)


class GlobalPooling1D(nn.Module):
    def forward(self, x):
        return F.global_avg_pool1d(x)


class Flatten(nn.Module):
    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class Identity(nn.Module):
    def forward(self, x):
        return x


# --------------------------------------------------------------------------
# reference-specific small modules
# --------------------------------------------------------------------------
class Maxout(nn.Module):
    """Linear(d -> m*k), then the max over each group of k
    (aux_models.py:78-91)."""

    def __init__(self, d, m, k, *, device, generator):
        super().__init__()
        self.d_out, self.pool_size = int(m), int(k)
        self.lin = Linear(d, m * k, device=device, generator=generator)

    def forward(self, x):
        out = self.lin(x)
        return out.reshape(*x.shape[:-1], self.d_out,
                           self.pool_size).amax(dim=-1)


class AlphaScalarMultiplication(nn.Module):
    """x*sigmoid(alpha), y*(1-sigmoid(alpha)) gate (aux_models.py:94-111).
    The fusion nets re-init alpha_x ~ N(0, 0.1)
    (models/search/ntu_searchable.py:202-204)."""

    def __init__(self, size_alpha_x, size_alpha_y, alpha_init=None, *, device,
                 generator):
        super().__init__()
        self.alpha_x = nn.Parameter(
            (alpha_init or I.zeros)(generator, (1,), device))

    def forward(self, x, y):
        factor = torch.sigmoid(self.alpha_x.to(x.dtype))
        return x * factor, y * (1.0 - factor)


class AlphaVectorMultiplication(nn.Module):
    """x * sigmoid(alpha), alpha of shape (1, size_alpha) starting at 0
    (aux_models.py:114-125)."""

    def __init__(self, size_alpha, *, device):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros((1, int(size_alpha)),
                                              device=device))

    def forward(self, x):
        return x * torch.sigmoid(self.alpha.to(x.dtype))


class ParamList(nn.ParameterList):
    """One parameter per shape, keyed ``0``, ``1``, ... (so a CentralNet's
    keys are ``alphas_a.0``, ...), drawn by ``init`` (default U(0, 1), torch
    ``rand``)."""

    def __init__(self, shapes, init=None, *, device, generator):
        init = init or I.uniform(0.0, 1.0)
        super().__init__([nn.Parameter(init(generator, tuple(s), device))
                          for s in shapes])


ACTIVATIONS = ("LeakyReLU", "ELU", "ReLU", "Tanh", "Sigmoid", "Swish")


class Activ(nn.Module):
    """Activation by name (reference models/central/ops.py:6-30); "Swish"
    is sigmoid(beta * x) * x with a learned ``beta`` starting at 0.5. Any
    other name warns and passes x through, as the reference does."""

    def __init__(self, activation: str, *, device):
        super().__init__()
        self.activation = activation
        if activation not in ACTIVATIONS:
            print("WARNING: REQUIRED ACTIVATION IS NOT DEFINED")
        if activation == "Swish":
            self.beta = nn.Parameter(torch.tensor([0.5], device=device))

    def forward(self, x):
        a = self.activation
        if a == "LeakyReLU":
            return torch.nn.functional.leaky_relu(x, 0.01)
        if a == "ELU":
            return torch.nn.functional.elu(x)
        if a == "ReLU":
            return torch.relu(x)
        if a == "Tanh":
            return torch.tanh(x)
        if a == "Sigmoid":
            return torch.sigmoid(x)
        if a == "Swish":
            return torch.sigmoid(self.beta.to(x.dtype) * x) * x
        return x
