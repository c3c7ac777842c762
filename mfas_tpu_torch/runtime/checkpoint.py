"""Checkpoints in the torch format (the found-NTU slice's part of
mfas_tpu/runtime/checkpoint.py).

``load_state_dict`` reads what ``torch.save`` and the JAX package's
torch-free codec (``mfas_tpu.runtime.checkpoint.save``) both write.
``state_dict_from_numpy`` carries the JAX package's parameters (a
``flatten_tree`` dict of arrays) into a ``state_dict`` of the port.
"""

from __future__ import annotations

import numpy as np
import torch


def strip_module_prefix(flat: dict) -> dict:
    """Remove DataParallel's 'module.' prefix (avmnist_searchable.py:51-57)."""
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in flat.items()}


def load_state_dict(path) -> dict:
    """A checkpoint as a flat {dotted.path: tensor} dict on the CPU; the
    {'state_dict': {...}, ...} training-wrapper layout is unwrapped."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(obj, dict):
        raise ValueError("checkpoint does not contain a state_dict")
    if isinstance(obj.get("state_dict"), dict):
        obj = obj["state_dict"]
    return strip_module_prefix(obj)


def state_dict_from_numpy(flat: dict) -> dict:
    """JAX parameters ({path: array}) -> a state_dict to load with
    strict=True. Every array is copied, because JAX on the CPU can alias
    numpy memory that torch would then mutate in place (BatchNorm's running
    statistics); ``num_batches_tracked`` becomes int64, torch's counter type
    (int32 in JAX without x64)."""
    out = {}
    for k, v in flat.items():
        a = np.array(v, copy=True)
        if k.endswith("num_batches_tracked"):
            a = a.astype(np.int64)
        out[k] = torch.from_numpy(a)
    return out
