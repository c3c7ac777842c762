"""Host-side batch loaders (port of mfas_tpu/data/loader.py).

Every batch is padded to the full batch size and carries a 0/1 ``_mask``;
losses and accuracy counters are mask-weighted, which reproduces the
reference's dataset-level statistics. ``ArrayLoader`` serves in-memory numpy
arrays (AV-MNIST); ``MapLoader`` wraps an indexable dataset (NTU). Both draw
the same shuffles (and per-sample seeds) as the JAX package's, so both
packages visit samples and augmentations in the same order.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


class ResumableRng:
    """Shuffle/seed-stream RNG checkpointing shared by the loaders."""

    def rng_state(self):
        return self._rng.get_state()

    def set_rng_state(self, state):
        self._rng.set_state(state)


class ArrayLoader(ResumableRng):
    """Batches over parallel in-memory arrays.

    arrays: dict name -> np.ndarray with equal leading dim; ``indices``
    selects the rows of this split. Yields dicts of numpy arrays plus
    ``_mask`` (float32 0/1); the final batch is padded to ``batch_size`` by
    repeating its first row."""

    def __init__(self, arrays: dict, batch_size: int, shuffle: bool = False,
                 seed: int = 0, indices=None):
        self.arrays = arrays
        first = next(iter(arrays.values()))
        self.indices = (np.arange(len(first)) if indices is None
                        else np.asarray(indices))
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self._rng = np.random.RandomState(seed)

    @property
    def dataset_size(self):
        return len(self.indices)

    def __len__(self):
        return -(-len(self.indices) // self.batch_size)

    def __iter__(self):
        idx = self.indices.copy()
        if self.shuffle:
            self._rng.shuffle(idx)
        bs = self.batch_size
        for start in range(0, len(idx), bs):
            take = idx[start:start + bs]
            n = len(take)
            mask = np.zeros((bs,), np.float32)
            mask[:n] = 1.0
            if n < bs:
                take = np.concatenate([take, np.repeat(take[:1], bs - n)])
            batch = {k: v[take] for k, v in self.arrays.items()}
            batch["_mask"] = mask
            yield batch


def to_device(x, device):
    """numpy array -> tensor on ``device``; a CUDA copy goes from pinned
    host memory with non_blocking=True. Tensors pass through unchanged
    (the resident store rides along in its batches)."""
    if torch.is_tensor(x):
        return x
    t = torch.from_numpy(np.ascontiguousarray(x))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _drain(q):
    try:
        while True:
            q.get_nowait()
    except queue.Empty:
        pass


def prefetch_to_device(iterator, place, size=2):
    """Host collation and the host->device copy of batch N+1 run on a
    background thread while the consumer runs batch N; ``place(batch)``
    maps a host batch to what the consumer receives."""
    q: queue.Queue = queue.Queue(maxsize=max(1, size))
    stop = threading.Event()

    def producer():
        try:
            for batch in iterator:
                if stop.is_set():
                    return
                q.put(("item", place(batch)))
        except BaseException as e:  # re-raised on the consumer's thread
            q.put(("error", e))
        else:
            q.put(None)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            kind, payload = item
            if kind == "error":
                raise payload
            yield payload
    finally:
        stop.set()
        _drain(q)


class MapLoader(ResumableRng):
    """Indexable-dataset loader: samples are fetched by ``num_workers``
    threads and collated into padded fixed-shape batches, in order.

    dataset: object with __len__ and __getitem__(i) -> dict of np arrays;
    datasets with ``getitem_seeded(i, seed)`` get one seed per sample, drawn
    on the caller's thread in a fixed order."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, num_workers: int = 4, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.num_workers = max(1, int(num_workers))
        self.prefetch = max(1, int(prefetch))
        self._rng = np.random.RandomState(seed)

    @property
    def dataset_size(self):
        return len(self.dataset)

    def __len__(self):
        return -(-len(self.dataset) // self.batch_size)

    def _fetch(self, i, seed=None):
        if seed is not None:
            return self.dataset.getitem_seeded(int(i), int(seed))
        return self.dataset[int(i)]

    def __iter__(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        if hasattr(self.dataset, "getitem_seeded"):
            seeds = self._rng.randint(0, 2**31 - 1, size=len(idx))
        else:
            seeds = [None] * len(idx)
        bs = self.batch_size
        batches = [list(zip(idx[s:s + bs], seeds[s:s + bs]))
                   for s in range(0, len(idx), bs)]

        def collate(samples):
            n = len(samples)
            while len(samples) < bs:   # pad with the first sample, masked
                samples.append(samples[0])
            batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
            mask = np.zeros((bs,), np.float32)
            mask[:n] = 1.0
            batch["_mask"] = mask
            return batch

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as ex:
                    window: collections.deque = collections.deque()
                    nxt = 0
                    while nxt < len(batches) and len(window) <= self.prefetch:
                        window.append([ex.submit(self._fetch, i, sd)
                                       for i, sd in batches[nxt]])
                        nxt += 1
                    while window:
                        samples = [f.result() for f in window.popleft()]
                        if nxt < len(batches):
                            window.append([ex.submit(self._fetch, i, sd)
                                           for i, sd in batches[nxt]])
                            nxt += 1
                        if stop.is_set():
                            ex.shutdown(wait=False, cancel_futures=True)
                            return
                        q.put(("batch", collate(samples)))
            except BaseException as e:  # re-raised on the consumer's thread
                q.put(("error", e))
            else:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                kind, payload = item
                if kind == "error":
                    raise payload
                yield payload
        finally:
            stop.set()
            _drain(q)
