"""The benchmark's own counts of work: model FLOPs, input-kernel bytes and
the candidates of a search. None of them reads the program.

FLOP convention: 2 x the multiply-adds of every convolution and matrix
product at its output positions; nothing elementwise (BatchNorm,
activations, pooling, the loss and the optimizer are not counted). A
forward pass counts 1x; a phase-2 train step, in which every weight trains,
counts 3x its forward (the backward's input and weight gradients). The
count is that of ``torch.utils.flop_counter.FlopCounterMode`` over the
frozen reference's forward on the meta device, which holds the same
convention (``conv_flops`` / ``linear_flops`` are its closed form, checked
against it in the tests).
"""

from __future__ import annotations

import math

import torch

from perfbench.reference import _plain as P

TRAIN_STEP_FORWARDS = 3


def conv_flops(batch, out_ch, in_ch_per_group, kernel, out_spatial):
    """2 x multiply-adds of one convolution."""
    return (2 * batch * out_ch * in_ch_per_group * math.prod(kernel)
            * math.prod(out_spatial))


def linear_flops(rows, in_f, out_f):
    return 2 * rows * in_f * out_f


class _NoMasks:
    """Dropout as the identity: it changes no FLOP count."""

    def drop(self, x, p, channels=False):
        return x


def forward_flops(ref, cfg, input_shapes, fn="forward"):
    """FLOPs of one train-mode call of reference module ``ref``'s ``fn``
    (its whole ``forward``, or e.g. its backbones' ``features``) at
    ``input_shapes`` (one shape per input), counted on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        params = {name: torch.empty(shape, dtype=(torch.long
                                                  if kind == "count"
                                                  else torch.float32))
                  for name, shape, kind, _ in ref.param_specs(cfg)}
        inputs = tuple(torch.empty(s) for s in input_shapes)
    with FlopCounterMode(display=False) as counter:
        getattr(ref, fn)(params, inputs, cfg, _NoMasks(), P.FLOAT32)
    return int(counter.get_total_flops())


def k2_bytes(batch, frames, height, width, out_bytes):
    """Least bytes of one gather-normalize launch (K2): the gathered uint8
    frames read, their int64 frame index read, the normalized elements
    written at ``out_bytes`` each (4 float32, 2 bfloat16)."""
    n = batch * frames * height * width * 3
    return n + 8 * batch * frames + n * out_bytes


def k1_bytes(batch, frames, height, width, out_bytes):
    """Least bytes of one normalize launch (K1): B*T*H*W*3 uint8 read, as
    many elements written at ``out_bytes`` each."""
    n = batch * frames * height * width * 3
    return n + n * out_bytes


def n_candidates(search_iterations, levels, num_samples):
    """Candidates an EPNAS search trains: all 32 one-row confs at the
    first step, ``num_samples`` at each later one."""
    return 32 + (search_iterations * levels - 1) * num_samples
