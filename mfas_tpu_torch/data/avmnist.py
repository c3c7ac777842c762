"""AV-MNIST dataset (port of mfas_tpu/data/avmnist.py).

Layout on disk: ``{root}/audio/{train,test}_data.npy`` spectrograms
(N,112,112), ``{root}/images/{train,test}_data.npy`` digits (N,784) and
``{root}/{train,test}_labels.npy``. A split is loaded whole as normalized
fixed-shape arrays (the image channel's MNIST normalization (0.1307, 0.3081)
applied at load); batches are then drawn from host memory by
``data/loader.py::ArrayLoader``.
"""

from __future__ import annotations

import os

import numpy as np

MNIST_MEAN, MNIST_STD = 0.1307, 0.3081


class ToTensor:
    """The reference transform; arrays are already numeric here, so this
    only fixes dtypes."""

    def __call__(self, sample):
        return {"image": np.asarray(sample["image"], np.float32),
                "audio": np.asarray(sample["audio"], np.float32),
                "label": int(sample["label"])}


class Normalize:
    """Image-channel normalization."""

    def __init__(self, mean_vector=(MNIST_MEAN,), std_devs=(MNIST_STD,)):
        self.mean = np.asarray(mean_vector, np.float32)
        self.std = np.asarray(std_devs, np.float32)

    def __call__(self, sample):
        image = np.asarray(sample["image"], np.float32)
        image = ((image - self.mean.reshape(-1, 1, 1))
                 / self.std.reshape(-1, 1, 1))
        return {**sample, "image": image}


def load_avmnist_arrays(root_dir, stage="train", normalize=True):
    """-> dict(image (N,1,28,28) f32, audio (N,1,112,112) f32, label (N,) i32)."""
    sub = "train" if stage == "train" else "test"
    audio = np.load(os.path.join(root_dir, "audio", f"{sub}_data.npy"))
    image = np.load(os.path.join(root_dir, "images", f"{sub}_data.npy"))
    labels = np.load(os.path.join(root_dir, f"{sub}_labels.npy"))

    audio = np.asarray(audio, np.float32)[:, None, :, :]
    image = np.asarray(image, np.float32).reshape(image.shape[0], 1, 28, 28)
    if normalize:
        image = (image - MNIST_MEAN) / MNIST_STD
    return {"image": image, "audio": audio,
            "label": np.asarray(labels, np.int32)}


def train_dev_split(n):
    """Rows of the train store: the reference's train[0:50000] and dev
    [50000:55000] when it holds 55000 samples or more, else the last n//8
    (at least 1) as dev (models/searchable.py:199-203) -> (dev_lo, dev_hi)."""
    if n >= 55000:
        return 50000, 55000
    return n - max(1, n // 8), n


def mute_modality(batch, p_muting, rng):
    """RandomModalityMuting, fixed: with probability p one random modality
    is zeroed (the reference's version never runs: its ``__call_`` typo)."""
    out = dict(batch)
    if rng.rand() <= p_muting:
        if rng.rand() <= 0.5:
            out["image"] = np.zeros_like(batch["image"])
        else:
            out["audio"] = np.zeros_like(batch["audio"])
    return out


class AVMnist:
    """Indexable view with the reference class's interface; bulk training
    uses load_avmnist_arrays + ArrayLoader."""

    def __init__(self, root_dir="./avMNIST", transform=None, stage="train"):
        self.arrays = load_avmnist_arrays(root_dir, stage,
                                          normalize=transform is None)
        self.transform = transform

    def __len__(self):
        return self.arrays["image"].shape[0]

    def __getitem__(self, idx):
        sample = {k: v[idx] for k, v in self.arrays.items()}
        if self.transform:
            sample = self.transform(sample)
        return sample


def make_synthetic_avmnist(root_dir, n_train=256, n_test=64, seed=0):
    """Write a synthetic dataset in the on-disk layout; the image's mean
    brightness carries the label. The arrays equal the JAX package's for
    the same seed."""
    rs = np.random.RandomState(seed)
    os.makedirs(os.path.join(root_dir, "audio"), exist_ok=True)
    os.makedirs(os.path.join(root_dir, "images"), exist_ok=True)
    for sub, n in (("train", n_train), ("test", n_test)):
        labels = rs.randint(0, 10, n)
        audio = rs.rand(n, 112, 112).astype(np.float32) * 0.1
        image = (rs.rand(n, 784).astype(np.float32)
                 + labels[:, None] * 0.08)
        np.save(os.path.join(root_dir, "audio", f"{sub}_data.npy"), audio)
        np.save(os.path.join(root_dir, "images", f"{sub}_data.npy"), image)
        np.save(os.path.join(root_dir, f"{sub}_labels.npy"), labels)
