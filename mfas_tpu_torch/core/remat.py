"""Activation rematerialization for ``--remat`` (the port of the JAX
engine's ``jax.checkpoint``, mfas_tpu/engine/classifier.py:169-170).

The JAX engine wraps its whole forward in one ``jax.checkpoint``. In torch a
single checkpoint around the whole forward would recompute, and hold, every
activation at once in backward, so the peak would not fall. The port
checkpoints segments instead (``model.remat_segments()``: each residual
block of the 3D ResNet and the skeleton net): only a segment's inputs are
kept from the forward, and backward recomputes one segment at a time. The
gradients are the same.

The recomputation must not change two things:

* dropout masks. A segment's dropout layers draw from an explicit
  ``torch.Generator``, which ``torch.utils.checkpoint`` does not restore
  (``preserve_rng_state`` covers only torch's global RNG). The recomputation
  replays each generator from the state it had when the segment first ran,
  and puts back the state it found, so the training stream goes on as if
  nothing had been recomputed.
* BatchNorm running statistics. The recomputation runs with
  ``update_running_stats`` off, so they move once per step.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from mfas_tpu_torch.core.layers import _BatchNorm, _DropoutBase


def _checkpointed(forward, module, *args):
    if not torch.is_grad_enabled():
        return forward(*args)
    gens = list({id(m.generator): m.generator for m in module.modules()
                 if isinstance(m, _DropoutBase)
                 and m.generator is not None}.values())
    start = [g.get_state() for g in gens]
    first = [True]

    def run(*a):
        if first[0]:
            first[0] = False
            return forward(*a)
        bns = [m for m in module.modules() if isinstance(m, _BatchNorm)]
        flags = [bn.update_running_stats for bn in bns]
        found = [g.get_state() for g in gens]
        for g, s in zip(gens, start):
            g.set_state(s)
        for bn in bns:
            bn.update_running_stats = False
        try:
            return forward(*a)
        finally:
            for bn, f in zip(bns, flags):
                bn.update_running_stats = f
            for g, s in zip(gens, found):
                g.set_state(s)

    # no global RNG is drawn from inside a segment: nothing to preserve
    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


def enable_remat(segments):
    """Checkpoint the forward of every module in ``segments`` whenever
    autograd records it (eval and inference passes run it plainly)."""
    for m in segments:
        if "forward" not in vars(m):     # not wrapped yet
            m.forward = functools.partial(_checkpointed, m.forward, m)
