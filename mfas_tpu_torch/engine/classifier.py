"""Train/eval engine for the classification verticals (port of
mfas_tpu/engine/classifier.py).

Loop semantics kept from the reference (train_ntu_track_acc,
train_searchable/ntu.py:14-89):
  * epochs x {train, dev} phases; the train phase steps the scheduler per
    batch *before* the optimizer step;
  * multitask loss = sum of CE over the three heads; predictions are the
    argmax of the summed logits (:60-61);
  * corrects are ``_mask``-weighted, so the padded rows of a ragged last
    batch never count, and accuracy divides by the dataset size;
  * the best-dev state is kept (strict ``>`` over a start of
    ``initial_best_acc``: 0.0, so a 0.0 dev epoch never snapshots, except
    in the CIFAR engine) and restored at the end (:82-88).

A train step is forward, (multitask) CE, backward and a torch Adam step
with coupled weight decay WEIGHT_DECAY (core/optim.py); the trainable set is a
``requires_grad`` split by dotted prefixes, so autograd never records the
frozen part, while the whole model runs in ``train()`` and the frozen
BatchNorms still update their running statistics, as the JAX engine folds
``ctx.updates`` into its frozen tree. Per-batch losses and corrects stay on
the device until a phase ends. Batches are collated and copied to the device
one batch ahead on a background thread (``prefetch_to_device``).

``compute_dtype=torch.bfloat16`` runs forward and backward under
``torch.autocast`` with f32 parameters and Adam; inputs are cast like the
JAX engine's ``cast_compute``, outputs go back to f32 before the loss, and
BatchNorm statistics are computed and kept in f32 (core/layers.py).
``remat=True`` checkpoints the model's segments (core/remat.py).

Dropout draws from ``self.generator``, on the engine's device, seeded per
epoch at ``seed + epoch`` (``train_track_acc``'s ``seed``, by default
``TRAIN_SEED_OFFSET``: apart from the found CLIs' init seed 0), and the same
at an epoch whether the run was resumed or not.

``group`` (parallel/mesh.py): data parallelism over a process group, one
process per GPU. Each rank takes its rows of every global batch on the host
(``place_batch``); its loss is its share of the global masked mean (the
global valid count rides in the batch as ``_count``), the gradients are
SUMmed over the group before the optimizer step, BatchNorm statistics and
dropout masks are those of the global batch (``set_data_group``), and the
epoch sums are reduced, so every rank prints the numbers of the one-rank
run. Only rank 0 writes the train state; a resume must resolve the same
epoch on every rank. An EvalRecord holds the rank's own rows.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import numpy as np
import torch

from mfas_tpu_torch.core import functional as F
from mfas_tpu_torch.core.layers import set_data_group, set_dropout_generator
from mfas_tpu_torch.core.optim import make_adam, set_lr
from mfas_tpu_torch.data.loader import prefetch_to_device, to_device
from mfas_tpu_torch.parallel import mesh as pm

# the offset between a net's init seed and its dropout seed
# (mfas_tpu/search/trainers.py::TRAIN_SEED_OFFSET), so the training stream
# never replays the init stream; large, so neither the search's
# +1-per-candidate counter nor the engine's +epoch walks an init seed onto a
# training seed. The found CLIs (init seed 0) train at this seed.
TRAIN_SEED_OFFSET = 1_000_003
# the JAX engine's default coupled L2 weight decay (engine/classifier.py:90)
WEIGHT_DECAY = 1e-4


def place_batch(batch, device, group=None):
    """Host batch -> tensors on ``device``; tensors already placed (the
    resident store riding along in its batches) pass through untouched.
    Under a data ``group`` the rank's rows are taken on the host first, and
    ``_count`` holds the global batch's valid rows (the loss normalizer).
    Collective-free: it runs on the prefetch thread."""
    if group is not None:
        count = np.sum(batch["_mask"], keepdims=True, dtype=np.float32)
        batch = pm.shard_batch(batch, group)
        batch["_count"] = count
    placed = {k: to_device(v, device) for k, v in batch.items()}
    if group is not None:
        placed["_count"] = placed["_count"].reshape(())
    return placed


def set_trainable(model, prefixes=None):
    """requires_grad on the parameters under any of the dotted ``prefixes``
    (every parameter when None), off on the rest: the JAX engine's
    ``split_tree`` (engine/classifier.py:38-50, ``prefix_predicate``)."""
    for name, p in model.named_parameters():
        p.requires_grad_(prefixes is None or any(
            name == q or name.startswith(q + ".") for q in prefixes))


def snapshot(model):
    """A copy of the model's state_dict on its device."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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


@dataclasses.dataclass
class TrainRecord:
    """One ``train_track_acc`` call: the printed per-epoch statistics
    (dicts of phase, epoch, loss, acc), and the wall time of its train
    phases (each ends with a device synchronize) and the clips they took."""
    epochs: list = dataclasses.field(default_factory=list)
    train_seconds: float = 0.0
    train_clips: int = 0
    best_acc: float = 0.0


class ClassifierEngine:
    def __init__(self, model, device, multitask=False,
                 input_keys=("image", "audio"), batch_prep=None,
                 compute_dtype=None, remat=False, initial_best_acc=0.0,
                 group=None):
        self.model = model
        self.group = group
        self.device = torch.device(device)
        self.multitask = multitask
        self.input_keys = tuple(input_keys)
        # batch_prep: on-device batch transform (e.g. the uint8 -> float
        # input kernels for packed and resident NTU batches)
        self.batch_prep = batch_prep
        self.compute_dtype = compute_dtype
        self.initial_best_acc = initial_best_acc
        self.generator = torch.Generator(device=self.device)
        set_dropout_generator(model, self.generator)
        set_data_group(model, group)
        if remat:
            from mfas_tpu_torch.core.remat import enable_remat
            enable_remat(model.remat_segments())
        self.last_eval = None
        self.train_records = []

    # ---------------- one batch
    def _autocast(self):
        if self.compute_dtype is None:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=self.compute_dtype)

    def _forward(self, batch):
        """-> (loss, corrects, model output) for one placed batch."""
        if self.batch_prep is not None:
            batch = self.batch_prep(batch)
        inputs = tuple(batch[k] for k in self.input_keys)
        if self.compute_dtype is not None:
            inputs = tuple(x.to(self.compute_dtype) if x.is_floating_point()
                           else x for x in inputs)
        with self._autocast():
            out = self.model(inputs)
        if self.compute_dtype is not None:
            out = (tuple(o.float() for o in out)
                   if isinstance(out, (tuple, list)) else out.float())
        label = batch["label"].long()
        w, count = batch["_mask"], batch.get("_count")
        if self.multitask:
            loss = sum(F.cross_entropy(o, label, w, count) for o in out)
            preds = torch.argmax(sum(out), dim=1)
        else:
            if isinstance(out, (tuple, list)):
                out = out[0]
            loss = F.cross_entropy(out, label, w, count)
            preds = torch.argmax(out, dim=1)
        corrects = ((preds == label).to(w.dtype) * w).sum()
        return loss, corrects, out

    def make_optimizer(self):
        """A fresh Adam over the model's trainable parameters."""
        return make_adam(self.model.parameters(), WEIGHT_DECAY)

    def _optimizer_step(self, optimizer):
        optimizer.step()

    def _train_step(self, batch, optimizer, eta):
        loss, corrects, _ = self._forward(batch)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        pm.all_reduce_grads(self.model.parameters(), self.group)
        set_lr(optimizer, eta)
        self._optimizer_step(optimizer)
        return loss.detach(), corrects.detach()

    def _prefetched(self, loader):
        """(n_valid, device batch) pairs, one batch ahead."""
        def place(batch):
            return (float(np.sum(batch["_mask"])),
                    place_batch(batch, self.device, self.group))

        return prefetch_to_device(loader, place)

    # ---------------- host loops
    def train_track_acc(self, trainable_prefixes, dataloaders, dataset_sizes,
                        scheduler, num_epochs, print_loss=True,
                        state_path=None, resume=False,
                        seed=TRAIN_SEED_OFFSET):
        """Train the parameters under ``trainable_prefixes`` (all when
        None) with a fresh Adam. Returns (best_dev_acc, best_state) and
        leaves the model in ``best_state``, which is the initial state when
        no dev epoch beat ``initial_best_acc``. Dropout draws from ``seed``
        at epoch 0 and from ``seed + epoch`` after, as the JAX engine's
        ``Rng(seed)`` and its resume at ``Rng(seed + start_epoch)``. With
        ``state_path`` the whole training state is written after every
        epoch, and ``resume=True`` continues from it when the file exists.
        The call's TrainRecord is appended to ``self.train_records``."""
        model = self.model
        set_trainable(model, trainable_prefixes)
        pm.replicate(model.state_dict().values(), self.group)
        optimizer = self.make_optimizer()
        best_acc = self.initial_best_acc
        best_state = snapshot(model)
        start_epoch = 0
        found_state = bool(state_path and os.path.exists(state_path))
        if resume:
            # a state file only some processes see would start them over
            # while the others skip ahead: the group would hang
            pm.require_resume_agreement((int(found_state),))
        if resume and found_state:
            from mfas_tpu_torch.runtime.train_state import load_train_state
            st = load_train_state(state_path, model=model,
                                  optimizer=optimizer, scheduler=scheduler)
            best_state, best_acc = st["best_state"], st["best_acc"]
            pm.require_resume_agreement((int(st["epoch"]),))
            start_epoch = st["epoch"] + 1
            if print_loss:
                print(f"Resuming training at epoch {start_epoch} "
                      f"(best dev acc {best_acc:.4f})")

        record = TrainRecord()
        for epoch in range(start_epoch, num_epochs):
            self.generator.manual_seed(seed + epoch)
            for phase in ("train", "dev"):
                train = phase == "train"
                model.train(train)
                losses, n_valid, corrects = [], [], []
                t0 = time.perf_counter()
                with contextlib.nullcontext() if train else \
                        torch.inference_mode():
                    for n, batch in self._prefetched(dataloaders[phase]):
                        if train:
                            loss, c = self._train_step(batch, optimizer,
                                                       scheduler.step())
                        else:
                            loss, c, _ = self._forward(batch)
                        losses.append(loss)
                        corrects.append(c)
                        n_valid.append(n)
                _sync(self.device)
                if train:
                    record.train_seconds += time.perf_counter() - t0
                    record.train_clips += int(dataset_sizes[phase])
                # one device->host copy (and one reduction) per phase
                ls = (pm.reduce_sum(torch.stack(losses), self.group).tolist()
                      if losses else [])
                cs = (pm.reduce_sum(torch.stack(corrects), self.group)
                      .tolist() if corrects else [])
                epoch_loss = (sum(l * n for l, n in zip(ls, n_valid))
                              / dataset_sizes[phase])
                epoch_acc = sum(cs) / dataset_sizes[phase]
                record.epochs.append(dict(phase=phase, epoch=epoch,
                                          loss=epoch_loss, acc=epoch_acc))
                if print_loss:
                    print("{} Loss: {:.4f} Acc: {:.4f}".format(
                        phase, epoch_loss, epoch_acc))
                if not train and epoch_acc > best_acc:
                    best_acc = epoch_acc
                    best_state = snapshot(model)

            if state_path:
                from mfas_tpu_torch.runtime.train_state import \
                    save_train_state
                save_train_state(state_path, model=model,
                                 best_state=best_state, optimizer=optimizer,
                                 scheduler=scheduler, epoch=epoch,
                                 best_acc=best_acc)

        model.load_state_dict(best_state)
        record.best_acc = best_acc
        self.train_records.append(record)
        return best_acc, best_state

    def test_track_acc(self, dataloader, dataset_size):
        """Accuracy of the model over ``dataloader``; the pass is kept in
        ``self.last_eval``."""
        self.model.eval()
        corrects, logits, masks = [], [], []
        t0 = time.perf_counter()
        with torch.inference_mode():
            for _, batch in self._prefetched(dataloader):
                _, c, out = self._forward(batch)
                corrects.append(c)
                logits.append(out[0] if isinstance(out, (tuple, list))
                              else out)
                masks.append(batch["_mask"])
            total = (float(pm.reduce_sum(torch.stack(corrects).sum(),
                                         self.group)) if corrects else 0.0)
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
