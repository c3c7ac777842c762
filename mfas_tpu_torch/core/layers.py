"""Layers of the ported paths (port of mfas_tpu/core/layers.py).

``nn.Module``s whose ``state_dict`` keys are the JAX package's tree paths:
``weight``, ``bias``, ``running_mean``, ``running_var``,
``num_batches_tracked``, ``alpha_x``. Layers with parameters take a keyword
``device`` and a ``torch.Generator`` (``generator``) that draws their initial
values.
"""

from __future__ import annotations

import torch
from torch import nn

from mfas_tpu_torch.core import functional as F
from mfas_tpu_torch.core import init as I


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
    """

    def __init__(self, num_features, eps=1e-5, momentum=0.1, *, device):
        super().__init__()
        n = int(num_features)
        self.eps = eps
        self.momentum = momentum
        self.update_running_stats = True
        self.weight = nn.Parameter(torch.ones(n, device=device))
        self.bias = nn.Parameter(torch.zeros(n, device=device))
        self.register_buffer("running_mean", torch.zeros(n, device=device))
        self.register_buffer("running_var", torch.ones(n, device=device))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long, device=device))

    def forward(self, x):
        shape = [1] * x.dim()
        shape[1] = -1
        if self.training:
            axes = [i for i in range(x.dim()) if i != 1]
            xs = x if x.dtype == torch.float64 else x.float()
            mean = xs.mean(dim=axes)
            var = torch.clamp(xs.square().mean(dim=axes) - mean.square(),
                              min=0.0)
            if self.update_running_stats:
                with torch.no_grad():
                    n = x.numel() // x.shape[1]
                    m = self.momentum
                    self.running_mean.mul_(1 - m).add_(m * mean)
                    self.running_var.mul_(1 - m).add_(
                        m * (var * (n / max(n - 1, 1))))
                    self.num_batches_tracked.add_(1)
            mean, var = mean.to(x.dtype), var.to(x.dtype)
        else:
            mean = self.running_mean.to(x.dtype)
            var = self.running_var.to(x.dtype)
        # autocast runs rsqrt in f32 on the card: cast it back
        inv = torch.rsqrt(var.reshape(shape) + self.eps).to(x.dtype)
        out = (x - mean.reshape(shape)) * inv
        return (out * self.weight.to(x.dtype).reshape(shape)
                + self.bias.to(x.dtype).reshape(shape))


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


class _DropoutBase(nn.Module):
    """Train-mode dropout draws its mask from ``self.generator``, a
    ``torch.Generator`` on the activations' device that the training engine
    hands to every dropout layer of its model (``set_dropout_generator``).
    A train-mode forward without one raises: no mask ever comes from
    torch's global RNG."""
    _fn = None

    def __init__(self, p=0.5):
        super().__init__()
        self.p = float(p)
        self.generator = None

    def forward(self, x):
        if not self.training:
            return x
        if self.generator is None:
            raise RuntimeError(
                f"{type(self).__name__} in train mode has no generator: "
                "call core.layers.set_dropout_generator(model, generator)")
        return type(self)._fn(x, self.p, self.generator)


class Dropout(_DropoutBase):
    _fn = staticmethod(F.dropout)


class Dropout2d(_DropoutBase):
    _fn = staticmethod(F.dropout2d)


def set_dropout_generator(model, generator):
    """Point every dropout layer of ``model`` at ``generator``."""
    for m in model.modules():
        if isinstance(m, _DropoutBase):
            m.generator = generator


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
