"""Packed NTU store (port of mfas_tpu/data/ntu_pack.py).

``pack_ntu`` decodes every clip of a raw NTU split once (cv2) into a split
directory holding ``rgb.npy`` (N, frames, H, W, 3) uint8 (raw BGR frames),
``ske.npy`` (N, 3, max_skel_frames, 25, 2) float32 (parsed by the native
C++ reader, data/native.py), ``ske_len.npy``, ``labels.npy`` and
``meta.json``: the JAX package's layout, byte for byte, so one store serves
both packages.

``PackedNTU`` serves samples like data.ntu.NTU, through the same
transforms, with no video decode:

  * ``device_normalize=False`` (the CLIs' default) normalizes each clip on
    the host with the native threaded gather (``gather_normalize_u8``:
    /255 + ImageNet mean/std) and yields float32 clips;
  * ``device_normalize=True`` yields raw uint8 clips and leaves the
    normalize to the card (``make_device_normalize_prep`` ->
    ``u8_normalize``, kernel K1; ``make_device_normalize_inputs_prep`` on
    the search path). Temporal transforms are pure slicing and commute with
    the normalize, so they still run on the host.
"""

from __future__ import annotations

import json
import os

import numpy as np

from mfas_tpu_torch.data import native
from mfas_tpu_torch.data import ntu as ntu_data

DEFAULT_FRAMES = 24          # load_video's default (datasets/ntu.py:12)
MAX_SKEL_FRAMES = 300
# threads of one clip's host normalize: the loader's workers run several
# clips at once (the JAX package's PackedNTU default)
HOST_NORMALIZE_THREADS = 2


def pack_ntu(root_dir, out_dir, stage, args=None, frames=DEFAULT_FRAMES,
             max_skel_frames=MAX_SKEL_FRAMES, vid_dim=256, vid_fr=30,
             verbose=True):
    """Decode every sample of a split once into the packed layout; -> the
    number of samples."""
    os.makedirs(out_dir, exist_ok=True)
    ds = ntu_data.NTU(root_dir, transform=None, stage=stage,
                      vid_dim=vid_dim, vid_fr=vid_fr, args=args,
                      shuffle_seed=0)
    n = len(ds)
    if n == 0:
        raise ValueError(f"no samples for stage {stage!r} under {root_dir}")

    # the first clip gives the frame size (and is not decoded twice)
    first = ntu_data.load_video(ds.rgb_list[0], vid_len=frames)
    H, W = first.shape[1], first.shape[2]

    rgb = np.lib.format.open_memmap(
        os.path.join(out_dir, "rgb.npy"), mode="w+", dtype=np.uint8,
        shape=(n, frames, H, W, 3))
    ske = np.lib.format.open_memmap(
        os.path.join(out_dir, "ske.npy"), mode="w+", dtype=np.float32,
        shape=(n, 3, max_skel_frames, 25, 2))
    ske_len = np.zeros((n,), np.int32)
    labels = np.zeros((n,), np.int32)

    for i in range(n):
        video = first if i == 0 else ntu_data.load_video(ds.rgb_list[i],
                                                         vid_len=frames)
        rgb[i] = np.clip(video, 0, 255).astype(np.uint8)
        parsed, true_len = native.parse_skeleton(ds.ske_list[i],
                                                 max_skel_frames)
        ske[i] = parsed
        ske_len[i] = min(true_len, max_skel_frames)
        labels[i] = ds.labels[i] - 1
        if verbose and i % 200 == 0:
            print(f"packed {i}/{n}")

    rgb.flush()
    ske.flush()
    del rgb, ske
    np.save(os.path.join(out_dir, "ske_len.npy"), ske_len)
    np.save(os.path.join(out_dir, "labels.npy"), labels)
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump({"n": n, "frames": frames, "h": H, "w": W,
                   "max_skel_frames": max_skel_frames, "stage": stage}, f)
    if verbose:
        print(f"packed {n} samples to {out_dir}")
    return n


class PackedNTU:
    """Indexable dataset over a packed store; a drop-in for data.ntu.NTU."""

    def __init__(self, packed_dir, transform=None, args=None,
                 device_normalize=False):
        with open(os.path.join(packed_dir, "meta.json")) as f:
            self.meta = json.load(f)
        self.rgb = np.load(os.path.join(packed_dir, "rgb.npy"), mmap_mode="r")
        self.ske = np.load(os.path.join(packed_dir, "ske.npy"), mmap_mode="r")
        self.ske_len = np.load(os.path.join(packed_dir, "ske_len.npy"))
        self.labels = np.load(os.path.join(packed_dir, "labels.npy"))
        self.transform = transform
        self.args = args
        self.modality = getattr(args, "modality", "both") if args else "both"
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
            if self.device_normalize:
                video = np.asarray(self.rgb[idx])  # raw uint8
            else:
                # all stored frames, before NormalizeLen picks vid_len[0],
                # as the JAX package does
                video = native.gather_normalize_u8(
                    self.rgb[idx][None], np.asarray([0]),
                    ntu_data.IMAGENET_MEAN, ntu_data.IMAGENET_STD,
                    num_threads=HOST_NORMALIZE_THREADS)[0]
        if self.modality in ("skeleton", "both"):
            skeleton = np.asarray(self.ske[idx, :, :self.ske_len[idx]],
                                  np.float32)
            if not no_norm:
                origin = skeleton[:, :, 1, 0]
                skeleton = skeleton - origin[:, :, None, None]

        sample = {"rgb": video, "ske": skeleton,
                  "label": int(self.labels[idx])}
        if self.transform:
            sample = ntu_data.apply_transform(self.transform, sample, rng)
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
