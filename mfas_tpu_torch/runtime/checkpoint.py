"""Checkpoints in the torch format (the found-NTU slice's part of
mfas_tpu/runtime/checkpoint.py and search/searchers.py::_load_backbone_tree).

``load_state_dict`` reads what ``torch.save`` and the JAX package's
torch-free codec (``mfas_tpu.runtime.checkpoint.save``) both write; ``save``
writes what both read. ``load_backbone`` fills a backbone from its published
checkpoint. ``state_dict_from_numpy`` carries the JAX package's parameters
(a ``flatten_tree`` dict of arrays) into a ``state_dict`` of the port.
"""

from __future__ import annotations

import os

import numpy as np
import torch

_WARNED_MISSING = set()


def strip_module_prefix(flat: dict) -> dict:
    """Remove DataParallel's 'module.' prefix (avmnist_searchable.py:51-57)."""
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in flat.items()}


def load_state_dict(path) -> dict:
    """A checkpoint as a flat {dotted.path: tensor} dict on the CPU; the
    {'state_dict': {...}, ...} training-wrapper layout is unwrapped. Python
    scalars become 0-d tensors of numpy's dtype for them; any other
    non-tensor entry (a nested dict, a string) is refused with a ValueError
    naming it, as the JAX package's loader does."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(obj, dict):
        raise ValueError("checkpoint does not contain a state_dict")
    if isinstance(obj.get("state_dict"), dict):
        obj = obj["state_dict"]
    bad = [k for k, v in obj.items()
           if not isinstance(v, (torch.Tensor, int, float, bool))]
    if bad:
        raise ValueError(
            f"checkpoint entries are not tensors: {bad[:5]} — not a "
            "state_dict (wrapper layouts other than 'state_dict' are not "
            "auto-unwrapped)")
    return strip_module_prefix({
        str(k): v if isinstance(v, torch.Tensor)
        else torch.from_numpy(np.asarray(v)) for k, v in obj.items()})


def save(state_dict, path):
    """``torch.save`` of ``state_dict`` as contiguous CPU tensors (the
    format ``--test_cp`` and the JAX package's ``load_state_dict`` read,
    whatever memory format the model's tensors have)."""
    torch.save({k: v.detach().to("cpu").contiguous()
                for k, v in state_dict.items()}, path)


def load_backbone(path, module, random_ok=False):
    """Load a torch-format backbone checkpoint into ``module`` (strict keys);
    with ``random_ok``, a missing file leaves the module's initial weights
    and warns once per path per process (--random_backbones)."""
    if path and os.path.exists(path):
        module.load_state_dict(load_state_dict(path), strict=True)
        return
    if not random_ok:
        raise FileNotFoundError(
            f"backbone checkpoint {path!r} not found; pass "
            "--random_backbones to run without pretrained weights")
    if path not in _WARNED_MISSING:
        _WARNED_MISSING.add(path)
        print(f"WARNING: backbone checkpoint {path!r} not found — "
              "using random init (--random_backbones)")


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


def nest_tree(flat: dict) -> dict:
    """{"a.b.c": x} -> {"a": {"b": {"c": x}}}: the JAX package's nested
    parameter trees, as search states and shared weights store them."""
    out = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def flatten_tree(tree: dict, prefix="") -> dict:
    """The inverse of ``nest_tree``: dotted paths, as a ``state_dict``."""
    out = {}
    for k, v in tree.items():
        p = f"{prefix}.{k}" if prefix else k
        out.update(flatten_tree(v, p) if isinstance(v, dict) else {p: v})
    return out
