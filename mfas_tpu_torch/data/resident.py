"""Device-resident packed NTU split: upload once, batch by device gather
(port of mfas_tpu/data/resident.py, single device).

The packed uint8 clips and float32 skeletons are copied to the device ONCE;
per batch only sample indices, temporal-pick indices and lerp weights cross
the host link, and the gather + temporal resample + normalize run on the
device (``make_resident_prep``). The NTU transform pipeline (AugCrop /
CenterCrop windows, NormalizeLen's RGB pick and skeleton time resample) is
purely temporal, so it is exactly a per-sample gather plan:

  rgb[out]  = store_rgb[sample, rgb_t[out]]
  ske[out]  = store_ske[sample, :, lo[out]]*(1-w) + [...hi[out]]*w

``plan_temporal`` computes that plan on the host by driving the real
transform objects over index surrogates (the same RNG draws in the same
order as the sample path). Skeleton origin subtraction commutes with the
resample by linearity, so it runs on the device after the gather; float
association differs from the host path by about 1e-6.

Memory: full-resolution cross-subject NTU (~40k clips x 24 x 256x256x3
uint8) is ~188 GB, past one card; resident mode is for stores that fit.

Under a data group (parallel/mesh.py) the store is replicated on every
rank by default, and each rank reads its rows of a batch with K2.
``ResidentNTUStore(shard=group)`` splits the sample axis instead: rank r
holds samples [r*m, (r+1)*m), m = ceil(n/D), zero-padded. A batch is then
read by the masked local gather and byte SUM of
``parallel/mesh.py::gather_rows`` over the group's whole plan (the plan's
rows are all-gathered first), the rank keeps its rows, and K1 normalizes
them: the fused gather of K2 reads one device's store only, so it is off
on a sharded store (with the JAX package's warning).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from mfas_tpu_torch.data import ntu as ntu_data
from mfas_tpu_torch.data.loader import ResumableRng
from mfas_tpu_torch.parallel import mesh as pm


def _unwrap(transform):
    if transform is None:
        return []
    if isinstance(transform, ntu_data.Compose):
        return list(transform.transforms)
    return [transform]


def plan_temporal(transform, n_frames, ske_valid, rng=None):
    """Per-sample temporal gather plan for a transform chain ending in
    NormalizeLen. Returns dict(rgb_t (t_rgb,) i32, ske_lo/ske_hi (t_ske,)
    i32, ske_w (t_ske,) f32); entries are None for absent modalities."""
    chain = _unwrap(transform)
    if not chain or not isinstance(chain[-1], ntu_data.NormalizeLen):
        raise ValueError(
            "resident planning requires a transform chain ending in "
            f"NormalizeLen (got {[type(t).__name__ for t in chain]})")
    norm_len = chain[-1]

    sample = {
        "rgb": (np.arange(n_frames).reshape(-1, 1, 1, 1)
                if n_frames else np.zeros([1], np.float32)),
        "ske": (np.broadcast_to(
            np.arange(ske_valid, dtype=np.float64).reshape(1, -1, 1, 1),
            (2, ske_valid, 1, 1)).copy()
            if ske_valid else np.zeros([1], np.float32)),
        "label": 0,
    }
    for t in chain[:-1]:
        if rng is not None and getattr(t, "accepts_rng", False):
            sample = t(sample, rng=rng)
        else:
            sample = t(sample)

    plan = {"rgb_t": None, "ske_lo": None, "ske_hi": None, "ske_w": None}
    if n_frames:
        window = sample["rgb"][:, 0, 0, 0]
        pick = ntu_data.linspace_frame_idx(len(window), norm_len.vid_len[0])
        plan["rgb_t"] = window[pick].astype(np.int32)
    if ske_valid:
        window = sample["ske"][0, :, 0, 0].astype(np.int64)
        lo, hi, w = ntu_data.interp_time_plan(len(window),
                                              norm_len.vid_len[1])
        plan["ske_lo"] = window[lo].astype(np.int32)
        plan["ske_hi"] = window[hi].astype(np.int32)
        plan["ske_w"] = w
    return plan


class ResidentNTUStore:
    """A packed split copied to ``device`` once: whole, or under ``shard``
    (a process group) this rank's part of its samples."""

    def __init__(self, packed_dir, device, args=None, shard=None):
        with open(os.path.join(packed_dir, "meta.json")) as f:
            self.meta = json.load(f)
        self.modality = (getattr(args, "modality", "both")
                         if args is not None else "both")
        self.ske_len = np.load(os.path.join(packed_dir, "ske_len.npy"))
        self.labels = np.load(os.path.join(packed_dir, "labels.npy"))
        self.n = len(self.labels)
        self.n_frames = int(self.meta["frames"])
        self.group = shard
        self.sharded = shard is not None

        def place(name):
            arr = np.load(os.path.join(packed_dir, name), mmap_mode="r")
            if self.sharded:
                arr = pm.split_rows(arr, shard)
            return torch.from_numpy(np.array(arr)).to(device)

        self.rgb_dev = (place("rgb.npy")
                        if self.modality in ("rgb", "both") else None)
        self.ske_dev = (place("ske.npy")
                        if self.modality in ("skeleton", "both") else None)

    def __len__(self):
        return self.n


class ResidentLoader(ResumableRng):
    """Loader twin of MapLoader over a ResidentNTUStore: the same shuffle
    RNG and per-sample transform seed draws, so the resident stream visits
    samples and augmentations in the order the streaming path would. Batches
    are index plans plus the device store; the ragged last batch repeats its
    first sample, masked out by ``_mask``."""

    def __init__(self, store, batch_size, transform, shuffle=False, seed=0):
        self.store = store
        self.batch_size = int(batch_size)
        self.transform = transform
        self.shuffle = shuffle
        self._seed_rng(seed)
        self._needs_rng = any(getattr(t, "accepts_rng", False)
                              for t in _unwrap(transform))

    @property
    def dataset_size(self):
        return self.store.n

    def __len__(self):
        return -(-self.store.n // self.batch_size)

    def __iter__(self):
        st = self.store
        idx = np.arange(st.n)
        if self.shuffle:
            self._rng.shuffle(idx)
        # drawn unconditionally to mirror MapLoader's RNG consumption
        drawn = self._rng.randint(0, 2 ** 31 - 1, size=len(idx))
        seeds = drawn if self._needs_rng else [None] * len(idx)
        bs = self.batch_size
        want_rgb = st.rgb_dev is not None
        want_ske = st.ske_dev is not None
        for start in range(0, len(idx), bs):
            take = idx[start:start + bs]
            n = len(take)
            mask = np.zeros((bs,), np.float32)
            mask[:n] = 1.0
            if n < bs:
                take = np.concatenate([take, np.repeat(take[:1], bs - n)])
            plans = [plan_temporal(
                self.transform,
                st.n_frames if want_rgb else 0,
                int(st.ske_len[i]) if want_ske else 0,
                rng=(np.random.RandomState(int(seeds[start + j]))
                     if seeds[start + j] is not None else None))
                for j, i in enumerate(take[:n])]
            plans += [plans[0]] * (bs - n)
            batch = {
                "_idx": take.astype(np.int32),
                "label": st.labels[take].astype(np.int32),
                "_mask": mask,
            }
            if want_rgb:
                batch["rgb_t"] = np.stack([p["rgb_t"] for p in plans])
                batch["_rgb_store"] = st.rgb_dev
            if want_ske:
                batch["ske_lo"] = np.stack([p["ske_lo"] for p in plans])
                batch["ske_hi"] = np.stack([p["ske_hi"] for p in plans])
                batch["ske_w"] = np.stack([p["ske_w"] for p in plans])
                batch["_ske_store"] = st.ske_dev
            yield batch


def make_resident_prep(no_norm=False, fuse_gather=False,
                       compute_dtype=None, store=None):
    """Engine batch_prep: store gather + temporal resample + normalize on
    the store's device. Clips come out in ``compute_dtype`` (float32 when
    None): under bf16 the kernel rounds the f32 affine once and writes bf16,
    so no f32 clip is written and read back for the cast
    (mfas_tpu/data/resident.py:233-307). Skeletons stay f32.

    fuse_gather=True reads the clips straight out of the store with
    ``u8_gather_normalize`` (kernel K2 on the card: the gathered uint8 clip
    is never written); False gathers with torch indexing and normalizes with
    ``u8_normalize`` (K1).

    store: the ResidentNTUStore. On a store sharded over the data group
    (``store.sharded``), whose rows each batch holds, the batch is read with
    ``gather_rows`` and normalized by K1; ``fuse_gather`` is then turned off
    with a warning."""
    from mfas_tpu_torch.ops.input_kernels import (u8_gather_normalize,
                                                  u8_normalize)

    mean, std = ntu_data.IMAGENET_MEAN, ntu_data.IMAGENET_STD
    out_dtype = compute_dtype or torch.float32
    sharded = bool(store is not None and store.sharded)
    if fuse_gather and sharded:
        import warnings
        warnings.warn("fuse_gather=True needs an unsharded store (the fused "
                      "kernel reads one device's store) — falling back to "
                      "the gather + K1 for this sharded store")
        fuse_gather = False
    group = store.group if sharded else None

    def gathered(local, idx, index=None):
        """The rank's rows of a sharded store's batch: the group's plan,
        the masked gather + byte SUM, then this rank's rows."""
        got = pm.gather_rows(local, idx, group, index)
        return got[pm.row_slice(got.shape[0], group)]

    def prep(batch):
        batch = dict(batch)
        idx = batch.pop("_idx").long()
        rgb_store = batch.pop("_rgb_store", None)
        ske_store = batch.pop("_ske_store", None)
        if sharded:
            idx_all = pm.all_gather_rows(idx, group)
        if rgb_store is not None:
            rgb_t = batch.pop("rgb_t").long()
            if fuse_gather:
                batch["rgb"] = u8_gather_normalize(rgb_store, idx, rgb_t,
                                                   mean, std, out_dtype)
            else:
                if sharded:
                    t_all = pm.all_gather_rows(rgb_t, group)
                    clips = gathered(rgb_store, idx_all,
                                     lambda st, rows: st[rows[:, None],
                                                         t_all])
                else:
                    clips = rgb_store[idx[:, None], rgb_t]
                batch["rgb"] = u8_normalize(clips, mean, std,
                                            out_dtype=out_dtype)
        else:
            batch["rgb"] = torch.zeros((idx.shape[0], 1),
                                       device=idx.device)
        if ske_store is not None:
            lo = batch.pop("ske_lo").long()[:, None, :, None, None]
            hi = batch.pop("ske_hi").long()[:, None, :, None, None]
            w = batch.pop("ske_w")[:, None, :, None, None]
            s = (gathered(ske_store, idx_all) if sharded
                 else ske_store[idx])              # (B, 3, S, 25, 2)
            s = (torch.take_along_dim(s, lo, dim=2) * (1.0 - w)
                 + torch.take_along_dim(s, hi, dim=2) * w)
            if not no_norm:
                # centered on joint 2 of person 1; linear, so moving it
                # after the resample is exact up to float association
                s = s - s[:, :, :, 1, 0][:, :, :, None, None]
            batch["ske"] = s
        else:
            batch["ske"] = torch.zeros((idx.shape[0], 1), device=idx.device)
        return batch

    return prep
