"""2D -> 3D weight inflation for the video backbone (port of
mfas_tpu/models/inflate.py).

  * a 2D conv weight (O,I,kh,kw) destined for a 5D slot (O,I,kt,kh,kw) is
    repeated along time and then *center-inflated*: every temporal slice
    except the middle one is zeroed, so an untrained inflated net computes
    exactly the 2D network per frame (``mean`` divides by kt instead);
  * ``fc.weight``/``fc.bias`` are dropped; any 2D key without a 3D
    destination is reported.

An offline transform over flat state dicts of tensors (numpy arrays are
accepted), run by ``mfas_tpu_torch.tools.convert_torchvision``; it never
touches a device.
"""

from __future__ import annotations

import torch


def inflate_weight(w2d, kt: int, inflation: str = "center"):
    """(O,I,kh,kw) -> (O,I,kt,kh,kw)."""
    w = torch.as_tensor(w2d).unsqueeze(2).repeat(1, 1, kt, 1, 1)
    if inflation == "center":
        mid = int(kt / 2.0)
        out = torch.zeros_like(w)
        out[:, :, mid] = w[:, :, mid]
        return out
    if inflation == "mean":
        return w / kt
    raise ValueError(f"unknown inflation mode {inflation!r}")


def inflate_resnet_state(flat_2d: dict, flat_3d_template: dict,
                         inflation: str = "center",
                         verbose: bool = False) -> dict:
    """Map a torchvision ResNet-50 flat state_dict onto the ResNet3D
    template (``inflated_resnet50().state_dict()``), inflating 4D conv
    weights whose destination is 5D; f64 becomes f32, and every key the 2D
    state lacks keeps the template's value."""
    out = dict(flat_3d_template)
    for k, v in flat_2d.items():
        if k in ("fc.weight", "fc.bias"):
            continue
        if k not in flat_3d_template:
            if verbose:
                print(f"{k} cannot be init from ImageNet weights")
            continue
        dst = flat_3d_template[k]
        v = torch.as_tensor(v)
        if dst.ndim == 5 and v.ndim == 4:
            v = inflate_weight(v, int(dst.shape[2]), inflation)
        out[k] = v.float() if v.dtype == torch.float64 else v
    return out
