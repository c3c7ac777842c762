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

``adam_init``/``adam_update`` are the JAX package's functional Adam itself,
for the search's captured programs (search/surrogate.py,
search/population.py): explicit moments and one shared step tensor, the
learning rate a device tensor, bias corrections in float32, every update in
place, so a CUDA graph that captured a step replays it on the same tensors.
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
    keeps the step counts, the bias corrections (in float32) and the
    learning rate (a 0-d float32 tensor) on the parameters' device, so a
    CUDA graph can capture the step and a replay reads the rate ``set_lr``
    wrote (``adam_step_skip_zero_grads`` needs it on the card too)."""
    params = [p for p in params if p.requires_grad]
    lr = (torch.zeros((), device=params[0].device) if capturable and params
          else 0.0)
    return torch.optim.Adam(params, lr=lr, betas=BETAS, eps=EPS,
                            weight_decay=weight_decay, capturable=capturable)


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
    feeds it to its step (``jnp.float32(eta)``); a device learning rate
    (``make_adam(capturable=True)``) is filled in place, with no host
    sync."""
    lr = float(np.float32(eta))
    for group in optimizer.param_groups:
        if torch.is_tensor(group["lr"]):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def adam_init(params):
    """The JAX package's ``adam_init`` state for a list of tensors: zero
    moments ("m", "v", lists in the parameters' order) and one shared
    "step", a 0-d float32 tensor on the parameters' device."""
    return {"m": [torch.zeros_like(p) for p in params],
            "v": [torch.zeros_like(p) for p in params],
            "step": torch.zeros((), device=params[0].device)}


def adam_update(params, grads, state, lr, weight_decay=0.0):
    """One step of the JAX package's ``adam_update``, in place on
    ``params`` and ``state`` (no host sync, nothing allocated that outlives
    the call, so a CUDA graph can capture it): coupled L2 weight decay,
    m = b1 m + (1-b1) g, v = b2 v + (1-b2) g^2, the step advanced, then
    p -= lr * (m / bc1) / (sqrt(v / bc2) + eps) with bc = 1 - b^step in
    float32. ``lr``: a 0-d tensor on the parameters' device (or a float)."""
    b1, b2 = BETAS
    m, v, step = state["m"], state["v"], state["step"]
    with torch.no_grad():
        if weight_decay:
            grads = torch._foreach_add(grads, params, alpha=weight_decay)
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1.0 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, grads, grads, value=1.0 - b2)
        step.add_(1.0)
        denom = torch._foreach_div(v, 1.0 - b2 ** step)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        upd = torch._foreach_div(m, 1.0 - b1 ** step)
        torch._foreach_div_(upd, denom)
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(params, upd)
