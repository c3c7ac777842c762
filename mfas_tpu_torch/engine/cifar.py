"""CIFAR train engine (port of mfas_tpu/engine/cifar.py; reference
models/search/train_searchable/cifar.py): a single ``image`` input, a
(logits, aux_logits) model output, the aux loss weighted 0.4 only under
``use_intermediate``, and a best-dev start of -1.0.

The reference tracks the best dev ERROR from 1e100, so its first dev epoch
always snapshots, even at accuracy 0; with 0 epochs the -1.0 comes back as
the "accuracy", as the reference's 1 - 1e100 does (:18, :80-83). Whole-net
training has dead parameters (the aux head without ``use_intermediate``,
the FactorizedReductions of outputs no later cell reads): their grad stays
None and torch's Adam never steps them. An op that DropPath dropped gets an
all-zero gradient, and ``adam_step_skip_zero_grads`` leaves its value,
moments and step count as they were: together the JAX engine's
``adam_skip_disconnected`` with per-leaf steps. Dropout and DropPath draw
from the engine's generator, seeded at ``seed + epoch``; under a data
``group`` every rank seeds it alike, so DropPath's one draw per forward
agrees across ranks (dropout masks are drawn at the global batch shape),
and the zero-gradient skip sees the reduced gradient.
"""

from __future__ import annotations

import torch

from mfas_tpu_torch.core import functional as F
from mfas_tpu_torch.core.optim import adam_step_skip_zero_grads, make_adam
from mfas_tpu_torch.engine.classifier import WEIGHT_DECAY, ClassifierEngine


class CifarEngine(ClassifierEngine):
    AUX_WEIGHT = 0.4

    def __init__(self, model, device, use_intermediate=False, group=None):
        super().__init__(model, device, input_keys=("image",),
                         initial_best_acc=-1.0, group=group)
        self.use_intermediate = use_intermediate

    def make_optimizer(self):
        return make_adam(self.model.parameters(), WEIGHT_DECAY,
                         capturable=self.device.type == "cuda")

    def _optimizer_step(self, optimizer):
        adam_step_skip_zero_grads(optimizer)

    def _forward(self, batch):
        out, iout = self.model(batch["image"])
        label = batch["label"].long()
        w, count = batch["_mask"], batch.get("_count")
        loss = F.cross_entropy(out, label, w, count)
        if self.use_intermediate:
            loss = loss + self.AUX_WEIGHT * F.cross_entropy(iout, label, w,
                                                            count)
        preds = torch.argmax(out, dim=1)
        corrects = ((preds == label).to(w.dtype) * w).sum()
        return loss, corrects, out
