"""NTU RGB+D host-side transforms (the found-NTU slice's part of
mfas_tpu/data/ntu.py; host numpy, shared by the packed and resident paths).

  * NormalizeLen: RGB -> vid_len[0] linspace frames; skeleton -> vid_len[1]
    frames by bilinear time interpolation (reference datasets/ntu.py:91-119);
  * CenterCrop (:124-143) and AugCrop (:146-169) temporal crops; AugCrop
    draws from a per-sample RandomState when one is passed;
  * RGB normalization uses the RGB-ordered ImageNet statistics, as the
    reference does on its BGR frames.
"""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def interp_time_plan(T, out_len):
    """The (lo, hi, w) gather plan of the bilinear time resample: out[t] =
    in[lo[t]]*(1-w[t]) + in[hi[t]]*w[t]. Shared by the host interpolation
    and the resident device path, so both resample identically."""
    if T == out_len:
        idx = np.arange(out_len)
        return idx, idx, np.zeros(out_len, np.float32)
    scale = T / out_len
    pos = (np.arange(out_len, dtype=np.float64) + 0.5) * scale - 0.5
    pos = np.clip(pos, 0.0, T - 1)
    lo = np.floor(pos).astype(int)
    hi = np.minimum(lo + 1, T - 1)
    w = (pos - lo).astype(np.float32)
    return lo, hi, w


def linspace_frame_idx(num, out_len):
    """NormalizeLen's RGB frame pick (reference datasets/ntu.py:99-102)."""
    return np.linspace(0, num - 1, out_len).astype(int)


def interpolate_skeleton_time(skel, out_len):
    """(C, T, V, M) -> (C, out_len, V, M), bilinear over time with
    half-pixel centers (torch F.interpolate align_corners=False)."""
    T = skel.shape[1]
    if T == out_len:
        return skel.astype(np.float32)
    lo, hi, w = interp_time_plan(T, out_len)
    data = skel.astype(np.float32)
    return (data[:, lo] * (1.0 - w)[None, :, None, None]
            + data[:, hi] * w[None, :, None, None])


# --------------------------------------------------------------------------
# transforms (sample = {'rgb', 'ske', 'label'})
# --------------------------------------------------------------------------
class NormalizeLen:
    def __init__(self, vid_len=(8, 32)):
        self.vid_len = vid_len

    def __call__(self, sample):
        rgb, skel = sample["rgb"], sample["ske"]
        if rgb.shape[0] != 1:
            rgb = rgb[linspace_frame_idx(len(rgb), self.vid_len[0])]
        if skel.shape[0] != 1:
            skel = interpolate_skeleton_time(skel, self.vid_len[1])
        return {"rgb": rgb, "ske": skel, "label": sample["label"]}


class CenterCrop:
    """Symmetric temporal crop keeping p_interval of the sequence."""

    def __init__(self, p_interval=0.9):
        self.p_interval = p_interval

    def __call__(self, sample):
        rgb, skel = sample["rgb"], sample["ske"]
        if skel.shape[0] != 1:
            valid = skel.shape[1]
            bias = int((1 - self.p_interval) * valid / 2)
            skel = skel[:, bias:valid - bias]
        if rgb.shape[0] != 1:
            num = len(rgb)
            bias = int((1 - self.p_interval) * num / 2)
            rgb = rgb[bias:num - bias]
        return {"rgb": rgb, "ske": skel, "label": sample["label"]}


class AugCrop:
    """Random temporal crop: RGB keeps a centered random fraction, skeleton
    keeps a random window of >=64 frames."""

    accepts_rng = True   # per-sample RNG protocol (Compose/getitem_seeded)

    def __init__(self, p_interval=0.5, seed=0):
        self.p_interval = p_interval
        self.rng = np.random.RandomState(seed)

    def __call__(self, sample, rng=None):
        r = rng if rng is not None else self.rng
        rgb, skel = sample["rgb"], sample["ske"]
        ratio = 1.0 - self.p_interval * r.rand()
        if rgb.shape[0] != 1:
            num = len(rgb)
            begin = (num - int(num * ratio)) // 2
            rgb = rgb[begin:num - begin]
        if skel.shape[0] != 1:
            valid = skel.shape[1]
            p = float(r.rand(1)[0]) * (1.0 - self.p_interval) + self.p_interval
            cropped = int(np.minimum(np.maximum(int(np.floor(valid * p)), 64),
                                     valid))
            bias = r.randint(0, valid - cropped + 1)
            skel = skel[:, bias:bias + cropped]
        return {"rgb": rgb, "ske": skel, "label": sample["label"]}


class Compose:
    # forwards a per-sample rng to the members that accept it
    accepts_rng = True

    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, sample, rng=None):
        for t in self.transforms:
            if rng is not None and getattr(t, "accepts_rng", False):
                sample = t(sample, rng=rng)
            else:
                sample = t(sample)
        return sample
