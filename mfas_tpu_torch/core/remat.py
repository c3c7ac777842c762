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

* dropout masks. A segment's dropout layers draw their masks from an
  explicit ``torch.Generator`` in its first run and record them on a
  ``functional.MaskTape``; the recomputation multiplies by the recorded
  masks and draws nothing, so the training stream goes on as if nothing
  had been recomputed. Nothing touches a generator's state, which a CUDA
  graph capture forbids, so a captured train step (engine/classifier.py)
  recomputes as an eager one does. The masks are what a segment keeps
  beyond its inputs: (B, C) per Dropout2d of the skeleton net.
* BatchNorm running statistics. The recomputation runs with
  ``update_running_stats`` off, so they move once per step.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from mfas_tpu_torch.core.functional import MaskTape
from mfas_tpu_torch.core.layers import _BatchNorm, _DropoutBase


def _taped(drops, tape, forward, args):
    for m in drops:
        m.masks = tape
    try:
        return forward(*args)
    finally:
        for m in drops:
            m.masks = None


def _checkpointed(forward, module, *args):
    if not torch.is_grad_enabled():
        return forward(*args)
    drops = [m for m in module.modules() if isinstance(m, _DropoutBase)]
    tape = MaskTape()
    first = [True]

    def run(*a):
        if first[0]:
            first[0] = False
            return _taped(drops, tape, forward, a)
        bns = [m for m in module.modules() if isinstance(m, _BatchNorm)]
        flags = [bn.update_running_stats for bn in bns]
        tape.rewind()
        for bn in bns:
            bn.update_running_stats = False
        try:
            return _taped(drops, tape, forward, a)
        finally:
            for bn, f in zip(bns, flags):
                bn.update_running_stats = f

    # no global RNG is drawn from inside a segment: nothing to preserve
    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


def enable_remat(segments):
    """Checkpoint the forward of every module in ``segments`` whenever
    autograd records it (eval and inference passes run it plainly)."""
    for m in segments:
        if "forward" not in vars(m):     # not wrapped yet
            m.forward = functools.partial(_checkpointed, m.forward, m)
