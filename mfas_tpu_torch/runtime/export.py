"""Serving export (port of mfas_tpu/runtime/export.py): a found model's eval
forward as one self-contained ``torch.export`` artifact (``.pt2``).

The artifact holds the graph and the trained weights, so the serving host
needs no checkpoint. A model exported on the card records its BatchNorms as
the custom op ``mfas::batch_norm_eval`` (ops/batchnorm.py: the fused kernels
on the card, the plain version elsewhere), so loading its artifact needs
this package, which ``load_exported`` imports; one exported on the CPU holds
plain PyTorch only:

    exp = load_exported("model.pt2", device="cuda")
    logits = exp.call(rgb, ske)          # or exp.module()(rgb, ske)

The weights live on the device the model was exported from; ``load_exported``
moves the whole program (weights, constants and the devices written into
the graph) to the device the caller names. A ``.pt2`` is not lowered for a
platform ahead of time, so the JAX package's multi-platform list has no
counterpart here.
"""

from __future__ import annotations

import inspect
import os

import torch


def _batch_dims(module, example_inputs):
    """Every input's axis 0 as one symbolic batch size >= 1, in the
    structure of ``module.forward``'s parameters (a ``*inputs`` forward
    takes them as one tuple)."""
    batch = torch.export.Dim("b", min=1)
    dims = tuple({0: batch} for _ in example_inputs)
    params = list(inspect.signature(module.forward).parameters.values())
    if params and params[0].kind is inspect.Parameter.VAR_POSITIONAL:
        return (dims,)
    return dims


def export_eval_fn(module, example_inputs, dynamic_batch=False):
    """``torch.export.export`` of ``module(*example_inputs)`` in eval mode ->
    an ExportedProgram. ``example_inputs`` fixes the shapes and dtypes; with
    ``dynamic_batch`` axis 0 of every input is symbolic (give an example
    batch of 2 or more, or torch specializes the program to size 1)."""
    module.eval()
    example_inputs = tuple(example_inputs)
    with torch.no_grad():
        return torch.export.export(
            module, example_inputs,
            dynamic_shapes=_batch_dims(module, example_inputs)
            if dynamic_batch
            else None)


def save_exported(path, module, example_inputs, dynamic_batch=False):
    """Export and write the artifact; -> its size in bytes. The example
    inputs are not written into it (they only fix shapes and dtypes; at
    NTU's full width they would add 12.6 MB of zeros)."""
    program = export_eval_fn(module, example_inputs, dynamic_batch)
    program.example_inputs = None
    torch.export.save(program, path)
    return os.path.getsize(path)


class Exported:
    """A loaded artifact placed on one device: ``call(*inputs)`` runs it
    (inputs are moved to the device), ``module()`` is the callable
    GraphModule, ``program`` the ExportedProgram."""

    def __init__(self, program, device):
        self.program = program
        self.device = torch.device(device)
        self._module = program.module()
        # a serving module: no autograd graph behind its outputs
        self._module.requires_grad_(False)

    def module(self):
        return self._module

    def call(self, *inputs):
        inputs = tuple(torch.as_tensor(x).to(self.device) for x in inputs)
        with torch.no_grad():
            return self._module(*inputs)


def load_exported(path, device="cpu"):
    """-> Exported, its program moved to ``device``."""
    from torch.export.passes import move_to_device_pass

    # registers mfas::batch_norm_eval, which an export on the card records
    from mfas_tpu_torch.ops import batchnorm  # noqa: F401

    program = torch.export.load(path)
    program = move_to_device_pass(program, torch.device(device))
    return Exported(program, device)
