"""Packed NTU store (the found-NTU slice's part of mfas_tpu/data/ntu_pack.py).

A packed split directory holds ``rgb.npy`` (N, frames, H, W, 3) uint8,
``ske.npy`` (N, 3, max_skel_frames, 25, 2) float32, ``ske_len.npy``,
``labels.npy`` and ``meta.json``, in the JAX package's layout, so one store
serves both packages.

``PackedNTU(device_normalize=True)`` ships RGB as raw uint8 and leaves the
/255 + ImageNet normalize to the card (``make_device_normalize_prep`` ->
``u8_normalize``, kernel K1; ``make_device_normalize_inputs_prep`` on the
search path). Temporal transforms are pure slicing and commute with the
normalize, so they still run on the host.
"""

from __future__ import annotations

import json
import os

import numpy as np

from mfas_tpu_torch.data import ntu as ntu_data

HOST_NORMALIZE_TODO = (
    "PackedNTU(device_normalize=False) normalizes on the host with the "
    "native C++ reader (data/native.py), which is not ported yet: see "
    "ROADMAP.md §1 'NTU raw-AVI and native IO path'. Use "
    "--device_input_normalize or --hbm_resident")


class PackedNTU:
    """Indexable dataset over a packed store."""

    def __init__(self, packed_dir, transform=None, args=None,
                 device_normalize=False):
        modality = getattr(args, "modality", "both") if args else "both"
        if not device_normalize and modality in ("rgb", "both"):
            raise NotImplementedError(HOST_NORMALIZE_TODO)
        with open(os.path.join(packed_dir, "meta.json")) as f:
            self.meta = json.load(f)
        self.rgb = np.load(os.path.join(packed_dir, "rgb.npy"), mmap_mode="r")
        self.ske = np.load(os.path.join(packed_dir, "ske.npy"), mmap_mode="r")
        self.ske_len = np.load(os.path.join(packed_dir, "ske_len.npy"))
        self.labels = np.load(os.path.join(packed_dir, "labels.npy"))
        self.transform = transform
        self.args = args
        self.modality = modality
        self.device_normalize = device_normalize

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, idx):
        return self._get(idx)

    def getitem_seeded(self, idx, seed):
        """Per-sample-seeded fetch (MapLoader protocol)."""
        return self._get(idx, rng=np.random.RandomState(seed))

    def _get(self, idx, rng=None):
        no_norm = getattr(self.args, "no_norm", False) if self.args else False
        video = np.zeros([1], np.float32)
        skeleton = np.zeros([1], np.float32)
        if self.modality in ("rgb", "both"):
            video = np.asarray(self.rgb[idx])  # raw uint8
        if self.modality in ("skeleton", "both"):
            skeleton = np.asarray(self.ske[idx, :, :self.ske_len[idx]],
                                  np.float32)
            if not no_norm:
                origin = skeleton[:, :, 1, 0]
                skeleton = skeleton - origin[:, :, None, None]

        sample = {"rgb": video, "ske": skeleton,
                  "label": int(self.labels[idx])}
        if self.transform:
            if rng is not None and getattr(self.transform, "accepts_rng",
                                           False):
                sample = self.transform(sample, rng=rng)
            else:
                sample = self.transform(sample)
        sample["label"] = np.int32(sample["label"])
        rgb_dtype = np.uint8 if self.device_normalize else np.float32
        sample["rgb"] = np.asarray(sample["rgb"], rgb_dtype)
        sample["ske"] = np.asarray(sample["ske"], np.float32)
        return sample


def make_device_normalize_prep(compute_dtype=None):
    """Engine batch_prep: uint8 'rgb' -> normalized clips on the batch's
    device (kernel K1 on the card), in ``compute_dtype`` (float32 when None;
    a bf16 clip is rounded once from the f32 affine, inside the kernel).
    Only raw uint8 3-channel clips get the affine; anything else (a
    skeleton-only placeholder, an already-float clip) is cast and passes
    through, never normalized twice."""
    import torch

    from mfas_tpu_torch.ops.input_kernels import u8_normalize

    out_dtype = compute_dtype or torch.float32

    def prep(batch):
        batch = dict(batch)
        rgb = batch["rgb"]
        if rgb.shape[-1] == 3 and rgb.dtype == torch.uint8:
            batch["rgb"] = u8_normalize(rgb, ntu_data.IMAGENET_MEAN,
                                        ntu_data.IMAGENET_STD,
                                        out_dtype=out_dtype)
        else:
            batch["rgb"] = rgb.to(out_dtype)
        return batch

    return prep


def make_device_normalize_inputs_prep(compute_dtype=None):
    """Population trainer input_prep, the search path's twin of
    ``make_device_normalize_prep``: every uint8 (..., 3) element of the
    inputs tuple goes through ``u8_normalize`` (K1 on the card) into
    ``compute_dtype`` (float32 when None); any other uint8 tensor is cast to
    float32; float tensors pass through."""
    import torch

    from mfas_tpu_torch.ops.input_kernels import u8_normalize

    out_dtype = compute_dtype or torch.float32

    def prep(inputs):
        return tuple(
            u8_normalize(x, ntu_data.IMAGENET_MEAN, ntu_data.IMAGENET_STD,
                         out_dtype=out_dtype)
            if (x.dtype == torch.uint8 and x.shape[-1] == 3)
            else (x.float() if x.dtype == torch.uint8 else x)
            for x in inputs)

    return prep


def make_synthetic_packed_ntu(out_dir, n=32, frames=8, h=64, w=64,
                              skel_frames=32, num_classes=60, seed=0):
    """Random packed store in the pack_ntu layout (tests/smoke fixture); the
    same seed writes the same files as the JAX package's twin."""
    os.makedirs(out_dir, exist_ok=True)
    rs = np.random.RandomState(seed)
    rgb = rs.randint(0, 256, (n, frames, h, w, 3)).astype(np.uint8)
    ske = (rs.randn(n, 3, skel_frames, 25, 2) * 0.3).astype(np.float32)
    np.save(os.path.join(out_dir, "rgb.npy"), rgb)
    np.save(os.path.join(out_dir, "ske.npy"), ske)
    np.save(os.path.join(out_dir, "ske_len.npy"),
            np.full((n,), skel_frames, np.int32))
    np.save(os.path.join(out_dir, "labels.npy"),
            rs.randint(0, num_classes, n).astype(np.int32))
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump({"n": n, "frames": frames, "h": h, "w": w,
                   "max_skel_frames": skel_frames, "stage": "synthetic"}, f)
    return n
