"""Adam with the JAX package's semantics (port of mfas_tpu/core/optim.py).

The JAX package writes torch's Adam by hand: coupled L2 weight decay added
to the gradient, betas (0.9, 0.999), eps 1e-8, bias-corrected moments, and
a learning rate fed in per step from the host scheduler. Here that is
``torch.optim.Adam`` itself (its multi-tensor ``foreach`` form on the card;
the update is plain XLA in the JAX package, not a Pallas kernel).

torch keeps a step count per parameter and skips a parameter whose grad is
None, moments and weight decay included: the JAX package's
``adam_init(per_leaf_step=True)`` + ``adam_update(skip_disconnected=True)``
mode. For a trainable set whose every parameter gets a gradient at every
step, that equals the JAX default (one shared step, nothing skipped).
"""

from __future__ import annotations

import numpy as np
import torch

BETAS = (0.9, 0.999)
EPS = 1e-8


def make_adam(params, weight_decay):
    """Adam over the parameters of ``params`` that require grad. The
    learning rate is set before every step (``set_lr``)."""
    return torch.optim.Adam([p for p in params if p.requires_grad], lr=0.0,
                            betas=BETAS, eps=EPS, weight_decay=weight_decay)


def set_lr(optimizer, eta):
    """The scheduler's float64 eta, rounded to float32 as the JAX engine
    feeds it to its step (``jnp.float32(eta)``)."""
    lr = float(np.float32(eta))
    for group in optimizer.param_groups:
        group["lr"] = lr
