"""CIFAR-10 data of the CIFAR vertical (port of mfas_tpu/data/cifar.py).

Reads the standard ``cifar-10-batches-py`` pickle layout from a local
directory (nothing is downloaded) and applies the reference's train
transforms in numpy on the host: a random 32x32 crop from 4-pixel zero
padding, a random horizontal flip, the per-channel normalization
(0.4914,0.4822,0.4465)/(0.2023,0.1994,0.2010), and the optional Cutout
(reference models/utils.py:64-116). ``CifarLoader`` draws in the JAX
loader's order (the shuffle first, then one crop/flip and one cutout draw
per batch from the same RandomState), so its batches are bitwise the JAX
package's.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from mfas_tpu_torch.data.loader import ArrayLoader

CIFAR_MEAN = np.asarray([0.4914, 0.4822, 0.4465], np.float32)
CIFAR_STD = np.asarray([0.2023, 0.1994, 0.2010], np.float32)


def load_cifar10_arrays(root_dir, train=True):
    """-> dict(image (N,3,32,32) f32 in [0,1], label (N,) i32)."""
    base = os.path.join(root_dir, "cifar-10-batches-py")
    files = ([f"data_batch_{i}" for i in range(1, 6)] if train
             else ["test_batch"])
    xs, ys = [], []
    for fname in files:
        with open(os.path.join(base, fname), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        xs.append(np.asarray(d[b"data"], np.uint8))
        ys.append(np.asarray(d[b"labels"], np.int32))
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).astype(np.float32) / 255.0
    return {"image": x, "label": np.concatenate(ys)}


def train_split(n):
    """The search/train rows [0, split) and the dev rows [split, hi) of a
    train store of n images: 45,000 / 5,000 for CIFAR-10, the last
    max(1, n // 10) rows below 50,000 images."""
    if n >= 50000:
        return 45000, 50000
    return n - max(1, n // 10), n


def normalize(images):
    return ((images - CIFAR_MEAN.reshape(1, 3, 1, 1))
            / CIFAR_STD.reshape(1, 3, 1, 1))


def random_crop_flip(images, rng, padding=4):
    """RandomCrop(32, padding=4) + RandomHorizontalFlip on (N,3,32,32)."""
    n, c, h, w = images.shape
    padded = np.pad(images, ((0, 0), (0, 0), (padding, padding),
                             (padding, padding)))
    out = np.empty_like(images)
    ys = rng.randint(0, 2 * padding + 1, n)
    xs = rng.randint(0, 2 * padding + 1, n)
    flips = rng.rand(n) < 0.5
    for i in range(n):
        crop = padded[i, :, ys[i]:ys[i] + h, xs[i]:xs[i] + w]
        out[i] = crop[:, :, ::-1] if flips[i] else crop
    return out


CUTOUT_LENGTH = 16


def cutout(images, rng):
    """Cutout of one 16-pixel hole per image (reference
    models/utils.py:64-113, as main_found_cifar builds it)."""
    n, c, h, w = images.shape
    out = images.copy()
    half = CUTOUT_LENGTH // 2
    for i in range(n):
        y = rng.randint(0, h)
        x = rng.randint(0, w)
        y1, y2 = np.clip([y - half, y + half], 0, h)
        x1, x2 = np.clip([x - half, x + half], 0, w)
        out[i, :, y1:y2, x1:x2] = 0.0
    return out


class CifarLoader(ArrayLoader):
    """ArrayLoader + the host-side CIFAR pipeline: train-time random
    crop/flip (+ optional cutout) and per-channel normalization. Same
    padded-batch/mask contract as the base; ``train`` also shuffles."""

    def __init__(self, arrays, batch_size, train=False, seed=0, indices=None,
                 use_cutout=False):
        super().__init__(arrays, batch_size, shuffle=train, seed=seed,
                         indices=indices)
        self.train = train
        self.use_cutout = use_cutout

    def __iter__(self):
        for batch in super().__iter__():
            image = batch["image"]
            if self.train:
                image = random_crop_flip(image, self._rng)
                if self.use_cutout:
                    image = cutout(image, self._rng)
            batch["image"] = normalize(image).astype(np.float32)
            yield batch


def make_synthetic_cifar(root_dir, n_per_batch=20, seed=0):
    """A tiny cifar-10-batches-py store: uniform uint8 pixels and labels."""
    rs = np.random.RandomState(seed)
    base = os.path.join(root_dir, "cifar-10-batches-py")
    os.makedirs(base, exist_ok=True)
    for fname in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        data = {b"data": rs.randint(0, 256, (n_per_batch, 3072), np.uint8),
                b"labels": rs.randint(0, 10, n_per_batch).tolist()}
        with open(os.path.join(base, fname), "wb") as f:
            pickle.dump(data, f)
