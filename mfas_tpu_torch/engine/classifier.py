"""Evaluation engine for the classification verticals (the evaluation half
of mfas_tpu/engine/classifier.py).

Loop semantics kept from the reference (train_searchable/ntu.py:14-89):
  * multitask predictions are the argmax of the summed logits of the three
    heads (:60-61);
  * corrects are ``_mask``-weighted, so the padded rows of a ragged last
    batch never count, and accuracy divides by the dataset size.
The eval step runs under ``torch.inference_mode()`` with the model in
``eval()``. Batches are collated and copied to the device one batch ahead
on a background thread (``prefetch_to_device``).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from mfas_tpu_torch.core import functional as F
from mfas_tpu_torch.data.loader import prefetch_to_device, to_device


def place_batch(batch, device):
    """Host batch -> tensors on ``device``; tensors already placed (the
    resident store riding along in its batches) pass through untouched."""
    return {k: to_device(v, device) for k, v in batch.items()}


@dataclasses.dataclass
class EvalRecord:
    """What one ``test_track_acc`` pass saw: the fused head's logits and the
    validity mask of every batch (on the device), and its wall time, which
    ends with a device synchronize."""
    acc: float
    fused_logits: list
    masks: list
    seconds: float
    clips: int


class ClassifierEngine:
    def __init__(self, model, device, multitask=False,
                 input_keys=("image", "audio"), batch_prep=None):
        self.model = model
        self.device = torch.device(device)
        self.multitask = multitask
        self.input_keys = tuple(input_keys)
        # batch_prep: on-device batch transform (e.g. the uint8 -> float
        # input kernels for packed and resident NTU batches)
        self.batch_prep = batch_prep
        self.last_eval = None

    def _forward(self, batch):
        """-> (loss, corrects, model output) for one placed batch."""
        if self.batch_prep is not None:
            batch = self.batch_prep(batch)
        out = self.model(tuple(batch[k] for k in self.input_keys))
        label = batch["label"].long()
        w = batch["_mask"]
        if self.multitask:
            loss = sum(F.cross_entropy(o, label, w) for o in out)
            preds = torch.argmax(sum(out), dim=1)
        else:
            if isinstance(out, (tuple, list)):
                out = out[0]
            loss = F.cross_entropy(out, label, w)
            preds = torch.argmax(out, dim=1)
        corrects = ((preds == label).to(w.dtype) * w).sum()
        return loss, corrects, out

    def _prefetched(self, loader):
        return prefetch_to_device(loader,
                                  lambda b: place_batch(b, self.device))

    def test_track_acc(self, dataloader, dataset_size):
        """Accuracy of the model over ``dataloader``; the pass is kept in
        ``self.last_eval``."""
        self.model.eval()
        corrects, logits, masks = [], [], []
        t0 = time.perf_counter()
        with torch.inference_mode():
            for batch in self._prefetched(dataloader):
                _, c, out = self._forward(batch)
                corrects.append(c)
                logits.append(out[0] if isinstance(out, (tuple, list))
                              else out)
                masks.append(batch["_mask"])
            total = float(torch.stack(corrects).sum()) if corrects else 0.0
        seconds = time.perf_counter() - t0
        acc = total / dataset_size
        self.last_eval = EvalRecord(acc=acc, fused_logits=logits, masks=masks,
                                    seconds=seconds, clips=int(dataset_size))
        return acc


def valid_rows(record: EvalRecord):
    """The fused logits of ``record`` without the padded rows, as one
    float64 numpy array (for comparing two passes)."""
    return np.concatenate([
        lg.float().cpu().numpy()[m.cpu().numpy() > 0].astype(np.float64)
        for lg, m in zip(record.fused_logits, record.masks)])
