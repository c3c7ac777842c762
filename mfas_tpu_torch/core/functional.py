"""Functional ops of the ported paths (port of mfas_tpu/core/functional.py).

Torch layouts throughout: (N,C,L), (N,C,H,W) and (N,C,D,H,W), weights
(O,I,k...).
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


def conv1d(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
    """x: (N,C,L), w: (O,I,k) (the AV-MNIST CentralNet's central column)."""
    return TF.conv1d(x, w, b, stride=stride, padding=padding,
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
    use on the found-NTU path (hcn_motion's (T-1) -> T). The result keeps
    x's dtype (autocast runs the resize in f32 on the card)."""
    return TF.interpolate(x, size=tuple(size), mode="bilinear",
                          align_corners=False).to(x.dtype)


def _drop(x, p, mask_shape, generator):
    if generator is None:
        raise ValueError("dropout draws its mask from an explicit "
                         "torch.Generator; got None")
    keep = torch.empty(mask_shape, device=x.device, dtype=x.dtype)
    return x * keep.bernoulli_(1.0 - p, generator=generator) / (1.0 - p)


def dropout(x, p, generator):
    """torch Dropout train mode: zero with prob p, keep scaled by 1/(1-p).
    The mask comes from ``generator`` (on x's device), never from torch's
    global RNG."""
    if p <= 0.0:
        return x
    return _drop(x, p, x.shape, generator)


def dropout2d(x, p, generator):
    """Whole channels (axis 1) on rank >= 3 inputs; element-wise on rank
    <= 2, as the JAX package's dropout2d."""
    if p <= 0.0:
        return x
    if x.dim() <= 2:
        return dropout(x, p, generator)
    return _drop(x, p, x.shape[:2] + (1,) * (x.dim() - 2), generator)


def cross_entropy(logits, labels, weights=None):
    """torch CrossEntropyLoss (mean reduction); ``weights`` is an optional
    per-sample 0/1 mask for padded batches (mean over valid samples)."""
    nll = TF.cross_entropy(logits, labels.long(), reduction="none")
    if weights is None:
        return nll.mean()
    return (nll * weights).sum() / torch.clamp(weights.sum(), min=1.0)


def weighted_bce_elements(logits, targets, pos_weight, stable=False):
    """Per-element weighted BCE terms (mfas_tpu/core/functional.py:373-391).

    ``stable=False`` is the reference formula
    ``pw*z*-log(sigmoid(x)) + (1-z)*-log(1-sigmoid(x))`` (reference
    aux_models.py:129-147), overflow NaNs included: at x >= ~17 in f32
    sigmoid rounds to 1, so a positive label gives 0*inf = NaN, which the
    MM-IMDB engine's NaN escape relies on. Below x ~ -88.72 exp(-x)
    overflows and a negative label NaNs too; between -88.72 and -87.34 XLA
    on the CPU flushes sigmoid's subnormal result to 0 (NaN there in JAX)
    while torch keeps it (finite here).

    ``stable=True`` is the algebraically equal logsumexp form
    ``pw*z*softplus(-x) + (1-z)*(x + softplus(-x))``, exact for all x
    (``logaddexp``, as jax.nn.softplus: torch's softplus switches to the
    identity above 20).
    """
    z = targets
    if stable:
        sp = torch.logaddexp(-logits, torch.zeros_like(logits))
        return pos_weight * z * sp + (1.0 - z) * (logits + sp)
    x = torch.sigmoid(logits)
    return pos_weight * z * -torch.log(x) + (1.0 - z) * -torch.log(1.0 - x)


def weighted_bce_with_logits(logits, targets, pos_weight, stable=False):
    """Mean-reduced weighted BCE (see weighted_bce_elements)."""
    return weighted_bce_elements(logits, targets, pos_weight,
                                 stable=stable).mean()
