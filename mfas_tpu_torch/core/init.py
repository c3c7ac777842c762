"""Weight initializers of the found-NTU path (port of mfas_tpu/core/init.py).

Each initializer is ``f(generator, shape, device) -> tensor``. Values are
drawn on the host from the passed ``torch.Generator`` (a CPU generator) and
then moved to ``device``, so a seed gives the same weights on every device.
They match the JAX package in distribution only: its parity tests share
weights.
"""

from __future__ import annotations

import math

import torch


def _fan_in_out(shape):
    """fan_in/fan_out like torch.nn.init._calculate_fan_in_and_fan_out."""
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:  # Linear: (out, in)
        return shape[1], shape[0]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def _uniform(generator, shape, device, low, high):
    t = torch.empty(shape, dtype=torch.float32)
    t.uniform_(low, high, generator=generator)
    return t.to(device)


def _normal(generator, shape, device, mean, std):
    t = torch.empty(shape, dtype=torch.float32)
    t.normal_(mean, std, generator=generator)
    return t.to(device)


def normal(mean, std):
    def f(generator, shape, device):
        return _normal(generator, shape, device, mean, std)

    return f


def uniform(low, high):
    def f(generator, shape, device):
        return _uniform(generator, shape, device, low, high)

    return f


def constant(value):
    """Every element ``value``; draws nothing from the generator."""
    def f(generator, shape, device):
        return torch.full(shape, float(value), dtype=torch.float32,
                          device=device)

    return f


def zeros(generator, shape, device):
    return torch.zeros(shape, dtype=torch.float32, device=device)


def ones(generator, shape, device):
    return torch.ones(shape, dtype=torch.float32, device=device)


def kaiming_uniform(a: float = 0.0):
    """torch.nn.init.kaiming_uniform_ (fan_in, leaky_relu gain)."""

    def f(generator, shape, device):
        fan_in, _ = _fan_in_out(shape)
        bound = math.sqrt(2.0 / (1.0 + a * a)) * math.sqrt(3.0 / fan_in)
        return _uniform(generator, shape, device, -bound, bound)

    return f


torch_default_weight = kaiming_uniform(a=math.sqrt(5.0))
"""torch Linear/Conv default weight: kaiming_uniform(a=sqrt(5))."""


def torch_default_bias(weight_shape):
    """torch Linear/Conv default bias: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    fan_in, _ = _fan_in_out(weight_shape)
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0

    def f(generator, shape, device):
        return _uniform(generator, shape, device, -bound, bound)

    return f


def xavier_uniform(generator, shape, device):
    """Glorot-uniform (torch fan convention)."""
    fan_in, fan_out = _fan_in_out(shape)
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return _uniform(generator, shape, device, -bound, bound)


def hcn_conv_weight(generator, shape, device):
    """reference models/utils.py:9-16, conv branch: Glorot-uniform with
    fan_in = prod(shape[1:4]) and fan_out = shape[0] * prod(shape[2:4])
    (indices on the OIHW weight)."""
    fan_in = math.prod(shape[1:4])
    fan_out = shape[0] * math.prod(shape[2:4])
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return _uniform(generator, shape, device, -bound, bound)


def orthogonal(generator, shape, device):
    """jax.nn.initializers.orthogonal() (column axis -1): a matrix of
    prod(shape[:-1]) rows and shape[-1] columns whose rows or columns,
    whichever are fewer, are orthonormal, from the QR decomposition of a
    standard normal draw with R's diagonal made positive."""
    if len(shape) < 2:
        raise ValueError("orthogonal initializer requires at least a 2D "
                         "shape")
    n_cols = shape[-1]
    n_rows = math.prod(shape) // n_cols
    a = torch.empty((max(n_rows, n_cols), min(n_rows, n_cols)),
                    dtype=torch.float32)
    a.normal_(0.0, 1.0, generator=generator)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if n_rows < n_cols:
        q = q.T
    return q.reshape(shape).to(device)


def resnet_conv_weight(generator, shape, device):
    """reference models/auxiliary/resnet/resnet.py:32-35 — N(0, sqrt(2/n)),
    n = k0*k1*out_channels."""
    n = shape[0] * math.prod(shape[2:4])
    return _normal(generator, shape, device, 0.0, math.sqrt(2.0 / n))
