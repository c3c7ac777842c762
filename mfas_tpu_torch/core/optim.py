"""Adam with the JAX package's semantics (port of mfas_tpu/core/optim.py).

The JAX package writes torch's Adam by hand: coupled L2 weight decay added
to the gradient, betas (0.9, 0.999), eps 1e-8, bias-corrected moments, and
a learning rate fed in per step from the host scheduler. Here that is
``torch.optim.Adam`` itself (its multi-tensor ``foreach`` form on the card;
the update is plain XLA in the JAX package, not a Pallas kernel).

torch keeps a step count per parameter and skips a parameter whose grad is
None, moments and weight decay included. For a trainable set whose every
parameter gets a gradient at every step, that equals the JAX default (one
shared step, nothing skipped). ``adam_step_skip_zero_grads`` also skips a
parameter whose gradient is all zero (a path DropPath dropped): the JAX
package's ``adam_init(per_leaf_step=True)`` +
``adam_update(skip_disconnected=True)`` mode of whole-net training.
"""

from __future__ import annotations

import numpy as np
import torch

BETAS = (0.9, 0.999)
EPS = 1e-8


MOMENTS = ("exp_avg", "exp_avg_sq")


def make_adam(params, weight_decay, capturable=False):
    """Adam over the parameters of ``params`` that require grad. The
    learning rate is set before every step (``set_lr``). ``capturable``
    keeps the step counts and bias corrections on the parameters' device
    (``adam_step_skip_zero_grads`` needs that on the card)."""
    return torch.optim.Adam([p for p in params if p.requires_grad], lr=0.0,
                            betas=BETAS, eps=EPS, weight_decay=weight_decay,
                            capturable=capturable)


def _copies(tensors):
    copies = [torch.empty_like(t) for t in tensors]
    if copies:
        torch._foreach_copy_(copies, tensors)
    return copies


def adam_step_skip_zero_grads(optimizer):
    """``optimizer.step()``, after which a parameter whose gradient is all
    zero has its value, moments and step count back as they were. The
    decision stays on the gradients' device (no host sync), so on the card
    the step counts must live there too (``make_adam(capturable=True)``)."""
    params = [p for g in optimizer.param_groups for p in g["params"]
              if p.grad is not None]
    if not params:
        return
    if (any(p.device.type != "cpu" for p in params)
            and not all(g["capturable"] for g in optimizer.param_groups)):
        raise ValueError("skipping zero gradients on the device needs "
                         "make_adam(capturable=True)")
    with torch.no_grad():
        # an L1 norm is 0 only for an all-zero gradient (NaN counts as
        # connected, as in JAX's any(g != 0))
        zero = torch.stack(torch._foreach_norm(
            [p.grad for p in params], 1)).eq(0)
        had = [bool(optimizer.state[p]) for p in params]
        old = {"param": iter(_copies(params))}
        for k in MOMENTS:
            old[k] = iter(_copies([optimizer.state[p][k]
                                   for p, h in zip(params, had) if h]))
        optimizer.step()
        for i, (p, h) in enumerate(zip(params, had)):
            z = zero[i]
            torch.where(z, next(old["param"]), p, out=p)
            for k in MOMENTS:
                m = optimizer.state[p][k]
                if h:
                    torch.where(z, next(old[k]), m, out=m)
                else:       # a fresh state: its moments were zeros
                    m.masked_fill_(z, 0.0)
        # every step count went up by one: take it back where skipped
        steps = [optimizer.state[p]["step"] for p in params]
        torch._foreach_sub_(steps, list(zero.to(steps[0].dtype).unbind()))


def set_lr(optimizer, eta):
    """The scheduler's float64 eta, rounded to float32 as the JAX engine
    feeds it to its step (``jnp.float32(eta)``)."""
    lr = float(np.float32(eta))
    for group in optimizer.param_groups:
        group["lr"] = lr
