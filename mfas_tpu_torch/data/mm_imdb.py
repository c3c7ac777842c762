"""MM-IMDB dataset: poster image + GloVe text sequences (port of
mfas_tpu/data/mm_imdb.py; host numpy, as there).

Layout: per-sample ``{stage}/image_{idx:06}.npy`` (H, W, 3) float32,
``label_{idx:06}.npy`` (multi-hot genres), ``text_{idx:06}.npy``
(T_i, feat_dim) GloVe rows; the reference's split sizes are train 15552 /
test 7799 / dev 2608.

Batching (reference collate_imdb): text padded to the batch's longest with
-10.0 fill, rounded up to a power-of-two bucket as in the JAX package (so
a batch's shapes, and the batches, equal its loader's for a seed); images
transposed (0, 3, 2, 1) to channel-first; a ``textlen`` vector and the 0/1
``_mask`` of the rows padded with the batch's first sample.
"""

from __future__ import annotations

import os

import numpy as np

SPLIT_SIZES = {"train": 15552, "test": 7799, "dev": 2608}
TEXT_PAD_VALUE = -10.0


class Normalize:
    """Per-channel image normalization transform (reference :29-57)."""

    def __init__(self, mean_vector, std_devs):
        self.mean = np.asarray(mean_vector, np.float32)
        self.std = np.asarray(std_devs, np.float32)

    def __call__(self, sample):
        image = np.asarray(sample["image"], np.float32)
        image = (image - self.mean.reshape(-1, 1, 1)) / self.std.reshape(-1, 1, 1)
        return {**sample, "image": image}


class RandomModalityMuting:
    """Randomly zero one modality (reference :63-82, whose version never
    fires: ``__call_`` typo); this one works and carries its own RNG."""

    def __init__(self, p_muting=0.1, seed=0):
        self.p_muting = p_muting
        self.rng = np.random.RandomState(seed)

    def __call__(self, sample):
        out = dict(sample)
        if self.rng.rand() <= self.p_muting:
            if self.rng.rand() <= 0.5:
                out["image"] = np.zeros_like(sample["image"])
            else:
                out["text"] = np.zeros_like(sample["text"])
        return out


class MM_IMDB:
    def __init__(self, root_dir="", transform=None, stage="train",
                 feat_dim=100, average_text=False, len_data=None):
        self.len_data = SPLIT_SIZES[stage] if len_data is None else len_data
        self.transform = transform
        self.root_dir = root_dir
        self.stage = stage
        self.feat_dim = feat_dim
        self.average_text = average_text

    def __len__(self):
        return self.len_data

    def __getitem__(self, idx):
        base = os.path.join(self.root_dir, self.stage)
        image = np.load(os.path.join(base, "image_{:06}.npy".format(idx)))
        label = np.load(os.path.join(base, "label_{:06}.npy".format(idx)))
        text = np.load(os.path.join(base, "text_{:06}.npy".format(idx)))
        if self.average_text:
            text = text.mean(0)
        sample = {"image": np.asarray(image, np.float32),
                  "text": np.asarray(text, np.float32),
                  "label": np.asarray(label, np.float32),
                  "textlen": text.shape[0]}
        if self.transform:
            sample = self.transform(sample)
        return sample


def _bucket(n):
    b = 8
    while b < n:
        b *= 2
    return b


class MMIMDBLoader:
    """Batches with collate_imdb semantics: channel-first images, text
    padded with -10.0, textlen vector, plus the framework's 0/1 validity
    mask. Padded text always runs to a power-of-two bucket, so that every
    batch is bitwise the JAX loader's."""

    def __init__(self, dataset, batch_size, shuffle=False, seed=0):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self._rng = np.random.RandomState(seed)

    @property
    def dataset_size(self):
        return len(self.dataset)

    def __len__(self):
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        bs = self.batch_size
        for s in range(0, len(idx), bs):
            take = idx[s:s + bs]
            samples = [self.dataset[int(i)] for i in take]
            n = len(samples)
            while len(samples) < bs:
                samples.append(samples[0])

            if samples[0]["text"].ndim == 1:  # average_text collapsed it
                text = np.stack([s_["text"] for s_ in samples]).astype(np.float32)
                textlen = np.asarray([s_["textlen"] for s_ in samples], np.int32)
            else:
                max_len = _bucket(max(s_["text"].shape[0] for s_ in samples))
                fdim = samples[0]["text"].shape[1]
                text = np.full((bs, max_len, fdim), TEXT_PAD_VALUE, np.float32)
                textlen = np.zeros((bs,), np.int32)
                for i, s_ in enumerate(samples):
                    L = s_["text"].shape[0]
                    text[i, :L] = s_["text"]
                    textlen[i] = s_["textlen"]

            images = np.stack([s_["image"] for s_ in samples])
            if images.ndim == 4 and images.shape[-1] in (1, 3):
                images = np.transpose(images, (0, 3, 2, 1))  # collate_imdb:168

            labels = np.stack([s_["label"] for s_ in samples])
            mask = np.zeros((bs,), np.float32)
            mask[:n] = 1.0
            yield {"image": images.astype(np.float32), "text": text,
                   "label": labels.astype(np.float32), "textlen": textlen,
                   "_mask": mask}


def samples_f1(y_true, y_pred):
    """Samples-averaged F1 (sklearn f1_score(average='samples') equivalent,
    reference train_searchable/mmimdb.py:101) in plain numpy."""
    y_true = np.asarray(y_true, bool)
    y_pred = np.asarray(y_pred, bool)
    tp = (y_true & y_pred).sum(axis=1)
    p_den = y_pred.sum(axis=1)
    r_den = y_true.sum(axis=1)
    precision = np.where(p_den > 0, tp / np.maximum(p_den, 1), 0.0)
    recall = np.where(r_den > 0, tp / np.maximum(r_den, 1), 0.0)
    f1 = np.where(precision + recall > 0,
                  2 * precision * recall / np.maximum(precision + recall, 1e-12),
                  0.0)
    return float(f1.mean())


def make_synthetic_mmimdb(root_dir, stage="train", n=32, feat_dim=100,
                          num_labels=23, seed=0):
    """Tiny on-disk fixture in the reference layout."""
    rs = np.random.RandomState(seed)
    base = os.path.join(root_dir, stage)
    os.makedirs(base, exist_ok=True)
    for i in range(n):
        np.save(os.path.join(base, "image_{:06}.npy".format(i)),
                rs.rand(160, 256, 3).astype(np.float32))
        lab = np.zeros(num_labels, np.float32)
        lab[rs.randint(0, num_labels, 2)] = 1.0
        np.save(os.path.join(base, "label_{:06}.npy".format(i)), lab)
        T = rs.randint(5, 30)
        np.save(os.path.join(base, "text_{:06}.npy".format(i)),
                rs.randn(T, feat_dim).astype(np.float32))
    return n
