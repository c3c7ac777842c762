"""Functional ops of the found-NTU path (port of mfas_tpu/core/functional.py).

Torch layouts throughout: (N,C,H,W) and (N,C,D,H,W), weights (O,I,k...).
Convolutions are cuDNN's on the card, as the JAX package leaves them to XLA
outside any kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as TF


def conv2d(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
    return TF.conv2d(x, w, b, stride=stride, padding=padding,
                     dilation=dilation, groups=groups)


def conv3d(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
    return TF.conv3d(x, w, b, stride=stride, padding=padding,
                     dilation=dilation, groups=groups)


def linear(x, w, b=None):
    return TF.linear(x, w, b)


def max_pool2d(x, kernel_size, stride=None, padding=0):
    """Padding counts as -inf, as in torch and the JAX reduce_window."""
    return TF.max_pool2d(x, kernel_size, stride=stride, padding=padding)


def global_avg_pool2d(x):
    """Reference GlobalPooling2D (models/auxiliary/aux_models.py:54-64):
    mean over everything after the channel dim; identity on (N,C)."""
    return x.reshape(x.shape[0], x.shape[1], -1).mean(dim=2)


def interpolate_bilinear(x, size):
    """(N,C,H,W) -> (N,C,*size), half-pixel centers, no antialias. Equal to
    the JAX package's jax.image.resize(linear) when upsampling, the only
    use on the found-NTU path (hcn_motion's (T-1) -> T)."""
    return TF.interpolate(x, size=tuple(size), mode="bilinear",
                          align_corners=False)


def _drop(x, p, mask_shape):
    keep = torch.empty(mask_shape, device=x.device, dtype=x.dtype)
    return x * keep.bernoulli_(1.0 - p) / (1.0 - p)


def dropout(x, p):
    """torch Dropout train mode: zero with prob p, keep scaled by 1/(1-p)."""
    if p <= 0.0:
        return x
    return _drop(x, p, x.shape)


def dropout2d(x, p):
    """Whole channels (axis 1) on rank >= 3 inputs; element-wise on rank
    <= 2, as the JAX package's dropout2d."""
    if p <= 0.0:
        return x
    if x.dim() <= 2:
        return dropout(x, p)
    return _drop(x, p, x.shape[:2] + (1,) * (x.dim() - 2))


def cross_entropy(logits, labels, weights=None):
    """torch CrossEntropyLoss (mean reduction); ``weights`` is an optional
    per-sample 0/1 mask for padded batches (mean over valid samples)."""
    nll = TF.cross_entropy(logits, labels.long(), reduction="none")
    if weights is None:
        return nll.mean()
    return (nll * weights).sum() / torch.clamp(weights.sum(), min=1.0)
