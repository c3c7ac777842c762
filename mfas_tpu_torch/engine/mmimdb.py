"""MM-IMDB multi-label training engine (port of mfas_tpu/engine/mmimdb.py;
reference models/search/train_searchable/mmimdb.py:15-137).

Semantics kept: the per-batch cosine scheduler steps before the optimizer
step; the loss is the ``_mask``-weighted mean of each sample's mean
weighted BCE (``stable_bce=False``: the reference formula, overflow NaNs
and all); Adam with coupled weight decay leaves grad-None parameters
unstepped (the unimodal heads are dead in the loss: core/optim.py); the
dev phase predicts at sigmoid > th_fscore and the best samples-F1 (strict
``>``) keeps its state; a NaN epoch loss prints "Nan loss during training,
escaping" and returns the best F1 so far; the one-extra-epoch NaN-F1
failsafe; a NaN best F1 collapses to 0.0.

The trainable set is a ``requires_grad`` split by dotted prefixes, as
``ClassifierEngine``'s; the whole model runs in train mode, so frozen
BatchNorms still move their statistics. Dropout draws from the engine's
generator, seeded at ``seed + epoch`` (``TRAIN_SEED_OFFSET`` by default,
apart from the CLI's init seed 0). Batches are collated and placed one
ahead (``prefetch_to_device``); per-batch losses and predictions stay on
the device until their phase ends.

CUDA graphs (the counterpart of the JAX engine's jitted train and eval
programs, one per (phase, text length), mfas_tpu/engine/mmimdb.py:102-125):
on a CUDA device with no data group or an NCCL one (``graphs.graphable``),
``train_step`` and ``eval_step``
replay CUDA graphs (runtime/graphs.py::Step) of the eager step
(``_step``, and ``_eval``: the logits and the thresholded predictions),
captured once per batch signature, so each text length a loader pads to
has its graph, as each has its JAX program; the 25th graph warns as the
JAX engine's 25th program does. Adam is capturable with its learning rate
on the card (``make_optimizer``), which ``set_lr`` fills before each
replay. The train graphs of one optimizer live side by side on gradients of
fixed address (``graphs.Step``'s ``grads``: the step zeroes them in place),
and only parameters the loss reaches have one, so the dead heads stay
grad-None and unstepped; another optimizer frees the engine's graphs
first. The train and eval graphs share one memory pool. Under an NCCL
data group the train graphs hold the gradients' all-reduce and the eval
graphs the all-gather of their logits (the JAX engine's replicated
``out_shardings``). Under a gloo group, and on the CPU, every step runs
eagerly through the same functions.

``group`` (parallel/mesh.py): data parallelism as ``ClassifierEngine``'s
(rows per rank, the global masked mean, gradients SUMmed before Adam,
BatchNorm and dropout over the global batch, the epoch loss reduced); the
predictions and logits of a dev or test pass are all-gathered before the
samples-F1, which every rank then computes over the whole split, as the JAX
package's replicated eval output.
"""

from __future__ import annotations

import math
import time
import warnings
import weakref

import numpy as np
import torch

from mfas_tpu_torch.core import functional as F
from mfas_tpu_torch.core.layers import set_data_group, set_dropout_generator
from mfas_tpu_torch.core.optim import make_adam, set_lr
from mfas_tpu_torch.data.loader import prefetch_to_device
from mfas_tpu_torch.data.mm_imdb import samples_f1
from mfas_tpu_torch.engine.classifier import (TRAIN_SEED_OFFSET, EvalRecord,
                                              TrainRecord, _sync, place_batch,
                                              set_trainable, snapshot)
from mfas_tpu_torch.parallel import mesh as pm
from mfas_tpu_torch.runtime import graphs

# the JAX engine warns when it compiles more (phase, text length) programs
MAX_PROGRAMS = 24


class MMIMDBEngine:
    """``train_track_f1`` appends a TrainRecord (``best_acc`` holds the best
    dev F1; its epochs are {phase: train, epoch, loss} and {phase: dev,
    epoch, f1}) to ``train_records``; ``test_track_f1`` keeps an EvalRecord
    (``acc`` holds the samples-F1, ``fused_logits`` the fusion logits) in
    ``last_eval``."""

    def __init__(self, model, device, pos_weight=2.0, weight_decay=1e-4,
                 th_fscore=0.3, stable_bce=False, group=None):
        self.model = model
        self.group = group
        self.device = torch.device(device)
        self.pos_weight = pos_weight
        self.weight_decay = weight_decay
        self.th_fscore = th_fscore
        self.stable_bce = stable_bce
        self.generator = torch.Generator(device=self.device)
        set_dropout_generator(model, self.generator)
        set_data_group(model, group)
        self.graphed = graphs.graphable(self.device, group)
        self._programs, self._graphs_for, self._pool = {}, None, None
        self.train_records = []
        self.last_eval = None

    # ---------------- one batch
    def _forward(self, batch):
        out = self.model(batch["text"], batch["image"])
        return out[-1] if isinstance(out, (tuple, list)) else out

    def make_optimizer(self):
        """A fresh Adam over the model's trainable parameters, capturable
        (a device learning rate) on the card."""
        return make_adam(self.model.parameters(), self.weight_decay,
                         capturable=self.device.type == "cuda")

    def _step(self, batch, optimizer, set_to_none=True):
        """One train step at the learning rate already in ``optimizer``;
        a graph zeroes the gradients in place (``set_to_none=False``)."""
        per = F.weighted_bce_elements(self._forward(batch), batch["label"],
                                      self.pos_weight, stable=self.stable_bce)
        loss = F.masked_mean(per.mean(dim=1), batch["_mask"],
                             batch.get("_count"))
        optimizer.zero_grad(set_to_none=set_to_none)
        loss.backward()
        pm.all_reduce_grads(self.model.parameters(), self.group)
        optimizer.step()
        return loss.detach()

    def _train_step(self, batch, optimizer, eta):
        """The eager train step: the loss on the device."""
        set_lr(optimizer, eta)
        return self._step(batch, optimizer)

    def _eval(self, batch):
        """The eager eval step: (logits, predictions at sigmoid >
        th_fscore), the split's rows on every rank."""
        out = pm.all_gather_rows(self._forward(batch), self.group)
        return out, torch.sigmoid(out) > self.th_fscore

    def train_step(self, batch, optimizer, eta):
        """One train step, ``(loss,)`` on the device, a tuple of outputs as
        ``ClassifierEngine.train_step`` returns: a replay of the step
        captured for this batch's signature when ``self.graphed``, else
        ``_train_step``."""
        if not self.graphed:
            return (self._train_step(batch, optimizer, eta),)
        set_lr(optimizer, eta)
        return self._replay("train", batch, optimizer)

    def eval_step(self, batch):
        """One eval step under inference mode, (logits, predictions) on
        the device: a replay when ``self.graphed``."""
        with torch.inference_mode():
            if not self.graphed:
                return self._eval(batch)
            return self._replay("eval", batch)

    def release_graphs(self):
        """Free the captured steps and the gradients the train graphs
        hold."""
        self._programs, self._graphs_for, self._pool = {}, None, None
        for p in self.model.parameters():
            p.grad = None

    def _replay(self, kind, batch, optimizer=None):
        prog = self._program(kind, optimizer)
        if not prog.has(batch) and sum(map(
                len, self._programs.values())) == MAX_PROGRAMS:
            warnings.warn(
                f"MMIMDBEngine captured {MAX_PROGRAMS} distinct (phase, "
                "text_len) graphs; MMIMDBLoader pads text to pow-2 buckets "
                "to bound them", RuntimeWarning, stacklevel=3)
        return prog(batch)

    def _program(self, kind, optimizer=None):
        """The engine's ``graphs.Step`` of ``kind`` ("train" for
        ``optimizer``, or "eval"), built on first use; its graphs are keyed
        by batch signature (one per text length)."""
        if kind == "train" and self._graphs_for is not optimizer:
            self.release_graphs()
            self._graphs_for = optimizer
        prog = self._programs.get(kind)
        if prog is None:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            model, name = self.model, f"{type(self).__name__}_{kind}"
            # held weakly, as ClassifierEngine's graphs hold theirs
            engine = weakref.proxy(self)
            if kind == "train":
                def state():
                    return [*model.parameters(), *model.buffers(),
                            *(t for st in optimizer.state.values()
                              for t in st.values() if torch.is_tensor(t))]

                def trained():
                    return [p for p in model.parameters() if p.requires_grad]

                prog = graphs.Step(
                    name, lambda b: (engine._step(b, optimizer, False),),
                    state=state, generators=[self.generator],
                    pool=self._pool, grads=trained)
            else:
                prog = graphs.Step(name, lambda b: engine._eval(b),
                                   pool=self._pool)
            self._programs[kind] = prog
        return prog

    def _prefetched(self, loader):
        """(n_valid, host label, host mask, device batch), one batch
        ahead: the F1 reads per-sample rows on the host."""
        def place(batch):
            return (float(np.sum(batch["_mask"])), batch["label"],
                    batch["_mask"], place_batch(batch, self.device,
                                                self.group))

        return prefetch_to_device(loader, place)

    def _predict(self, loader, keep_logits=False):
        """Eval-mode predictions at sigmoid > th_fscore over ``loader``:
        (samples-F1 of the valid rows, per-batch logits, per-batch masks)."""
        self.model.eval()
        preds, labels, logits, masks = [], [], [], []
        for _, label, mask, batch in self._prefetched(loader):
            # the split's logits on every rank (label and mask are the
            # global batch's host arrays)
            out, pred = self.eval_step(batch)
            preds.append(pred)
            keep = mask > 0
            labels.append(label[keep])
            masks.append(mask)
            if keep_logits:
                logits.append(out)
        # one device->host copy per pass
        with torch.inference_mode():
            pred = torch.cat(preds).cpu().numpy()
        pred = pred[np.concatenate(masks) > 0]
        return samples_f1(np.concatenate(labels) > 0.5, pred), logits, masks

    # ---------------- host loops
    def train_track_f1(self, trainable_prefixes, dataloaders, dataset_sizes,
                       scheduler, num_epochs, seed=TRAIN_SEED_OFFSET,
                       verbose=False, init_f1=0.0):
        """Train the parameters under ``trainable_prefixes`` (all when None)
        with a fresh Adam; returns (best dev F1, best state) and leaves the
        model in the best state (the initial one when no dev epoch beat
        ``init_f1``)."""
        model = self.model
        self.release_graphs()
        set_trainable(model, trainable_prefixes)
        pm.replicate(model.state_dict().values(), self.group)
        optimizer = self.make_optimizer()
        best_f1 = init_f1
        best = snapshot(model)
        record = TrainRecord()
        self.train_records.append(record)

        def finish(f1):
            model.load_state_dict(best)
            record.best_acc = f1
            return f1, best

        failsafe, cont_overloop = True, 0
        while failsafe:
            for epoch in range(num_epochs):
                self.generator.manual_seed(seed + epoch)
                model.train()
                losses, n_valid = [], []
                t0 = time.perf_counter()
                for n, _, _, batch in self._prefetched(dataloaders["train"]):
                    losses.append(self.train_step(batch, optimizer,
                                                  scheduler.step())[0])
                    n_valid.append(n)
                _sync(self.device)
                record.train_seconds += time.perf_counter() - t0
                record.train_clips += int(dataset_sizes["train"])
                ls = (pm.reduce_sum(torch.stack(losses), self.group).tolist()
                      if losses else [])
                epoch_loss = (sum(l * n for l, n in zip(ls, n_valid))
                              / dataset_sizes["train"])
                record.epochs.append(dict(phase="train", epoch=epoch,
                                          loss=epoch_loss))
                if math.isnan(epoch_loss):
                    # NaN escape (reference :110-114)
                    print("Nan loss during training, escaping")
                    return finish(0.0 if math.isnan(best_f1) else best_f1)

                curr_f1, _, _ = self._predict(dataloaders["dev"])
                record.epochs.append(dict(phase="dev", epoch=epoch,
                                          f1=curr_f1))
                if verbose:
                    print("epoch #{} {} F1: {:.4f} ".format(epoch, "dev",
                                                            curr_f1))
                if curr_f1 > best_f1:
                    best_f1 = curr_f1
                    best = snapshot(model)

            # reachable only when the caller passes init_f1=NaN: the update
            # above never assigns NaN (as in the reference, :20,124-127)
            if math.isnan(best_f1) and num_epochs == 1 and cont_overloop < 1:
                print("Recording a NaN F1, training for one more epoch.")
            else:
                failsafe = False
            cont_overloop += 1

        return finish(0.0 if math.isnan(best_f1) else best_f1)

    def test_track_f1(self, dataloader):
        """Samples-F1 of the model over ``dataloader`` at sigmoid >
        th_fscore; the pass (its wall time ending with a device
        synchronize) is kept in ``self.last_eval``."""
        t0 = time.perf_counter()
        f1, logits, masks = self._predict(dataloader, keep_logits=True)
        _sync(self.device)
        self.last_eval = EvalRecord(
            acc=f1, fused_logits=logits,
            masks=[torch.from_numpy(m) for m in masks],
            seconds=time.perf_counter() - t0,
            clips=int(dataloader.dataset_size))
        return f1
