"""Population training of candidate fusion heads over frozen-backbone
features (port of mfas_tpu/search/population.py).

During the search only the fusion heads train; both backbones are frozen,
so each batch's backbone features are computed once and shared by every
candidate of the population. Candidates are independent: the forward is
batched over a leading population axis P by hand (``torch.bmm`` against
stacked per-candidate weights), and one backward plus one ``torch.optim.Adam``
step over the stacked parameters trains the whole population.

Heterogeneous fusion shapes are handled by padding, as in the JAX package:
every tap is zero-padded to the widest tap of its modality, every row's
Linear is embedded in a (hidden, cmax_a + cmax_b + hidden) matrix whose
padding columns only multiply zeros, and confs shorter than ``max_rows``
carry the previous row's output through masked rows. Each row draws its
initial weights with the candidate's true fan-in from a numpy
``RandomState``, so the initial heads equal the JAX package's bitwise.

Feature sources: the train split is either extracted every batch with the
backbones in train mode (batch statistics, dropout; the running statistics
stay as they are) or, with ``cache_train_features``, once in eval mode into a
device bank (bf16 or int8) that later epochs and populations gather from.
The dev split is extracted once in eval mode and kept: as a bank for the
fused epoch loop, or as a per-batch cache.

Several processes (parallel/mesh.py) lay out as a (pop, data) grid. The
``data`` group splits every batch by rows: each rank extracts features of
its rows (train-mode BatchNorm statistics and dropout masks of the global
batch), its loss is its share of each candidate's global masked mean, the
gradients are SUMmed over the group, and the heads' masked BatchNorm
statistics are reduced in two passes ([sum w*h, sum w], then
sum w*(h - mean)^2). A batch whose size the group does not divide is
replicated on every rank instead, as the JAX package replicates a leading
dim the mesh axis does not divide. ``shard_feature_bank`` splits a bank's
rows over the data group (labels stay whole, so the epoch plans key off the
true sample count); a batch is then read by ``gather_rows``. The ``pop``
group splits the candidates (replicated when it does not divide them):
every pop group trains its part on the same features, and accuracies and
parameters are all-gathered at the end. Collectives run on the main thread,
in step order, never on the prefetch thread.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as TF

from mfas_tpu_torch.core import functional as F
from mfas_tpu_torch.core.layers import (_BatchNorm, set_data_group,
                                        set_dropout_generator)
from mfas_tpu_torch.core.optim import make_adam, set_lr
from mfas_tpu_torch.data.loader import prefetch_to_device, to_device
from mfas_tpu_torch.fusion.layers import shared_weight_key
from mfas_tpu_torch.parallel import mesh as pm

# process-wide token source for the loader-keyed feature caches (never
# reused, unlike id() after garbage collection)
_cache_token_counter = itertools.count(1)

_DTYPES = {"bfloat16": torch.bfloat16}


@dataclass
class PopulationSpec:
    sizes_a: tuple          # tap widths, modality A (skeleton)
    sizes_b: tuple          # tap widths, modality B (rgb)
    hidden: int
    num_outputs: int
    max_rows: int
    batchnorm: bool = False
    drpt: float = 0.0
    use_alphas: bool = False
    multitask: bool = False
    weight_decay: float = 1e-4
    # reduced-precision frozen-backbone features ('bfloat16'): they only
    # perturb candidate scores, never the found architecture's training
    feature_dtype: str | None = None

    @property
    def cmax_a(self):
        return max(self.sizes_a)

    @property
    def cmax_b(self):
        return max(self.sizes_b)

    @property
    def in_max(self):
        return self.cmax_a + self.cmax_b + self.hidden


# --------------------------------------------------------------------------
# conf encoding / parameter init
# --------------------------------------------------------------------------
def encode_confs(confs, spec: PopulationSpec):
    """List of (L_i, 3) int confs -> dict of (P, R) arrays + row mask."""
    P, R = len(confs), spec.max_rows
    sel_a = np.zeros((P, R), np.int32)
    sel_b = np.zeros((P, R), np.int32)
    act = np.zeros((P, R), np.int32)
    row_mask = np.zeros((P, R), np.float32)
    for p, conf in enumerate(confs):
        conf = np.asarray(conf)
        L = len(conf)
        sel_a[p, :L] = conf[:, 0]
        sel_b[p, :L] = conf[:, 1]
        act[p, :L] = conf[:, 2]
        row_mask[p, :L] = 1.0
    return {"sel_a": sel_a, "sel_b": sel_b, "act": act, "row_mask": row_mask}


def conf_tensors(confs, spec, device):
    """``encode_confs`` on ``device``: int64 selectors, float row mask."""
    return {k: torch.as_tensor(v, device=device,
                               dtype=torch.float32 if k == "row_mask"
                               else torch.long)
            for k, v in encode_confs(confs, spec).items()}


def init_population(confs, spec: PopulationSpec, seed=0, *, device):
    """Stacked fusion-head params with per-candidate true-fan-in init, as
    (params, bn_state) dicts of float32 tensors on ``device``; every param
    requires grad."""
    P, R = len(confs), spec.max_rows
    rs = np.random.RandomState(seed)
    H, In = spec.hidden, spec.in_max
    ca, cb = spec.cmax_a, spec.cmax_b

    W = np.zeros((P, R, H, In), np.float32)
    b = np.zeros((P, R, H), np.float32)
    alpha = np.zeros((P, R), np.float32)
    cls_w = np.zeros((P, spec.num_outputs, H), np.float32)
    cls_b = np.zeros((P, spec.num_outputs), np.float32)

    for p, conf in enumerate(confs):
        conf = np.asarray(conf)
        for r in range(len(conf)):
            na = spec.sizes_a[int(conf[r, 0])]
            nb = spec.sizes_b[int(conf[r, 1])]
            fan_in = na + nb + (H if r > 0 else 0)
            bound = 1.0 / math.sqrt(fan_in)
            W[p, r, :, :na] = rs.uniform(-bound, bound, (H, na))
            W[p, r, :, ca:ca + nb] = rs.uniform(-bound, bound, (H, nb))
            if r > 0:
                W[p, r, :, ca + cb:] = rs.uniform(-bound, bound, (H, H))
            b[p, r] = rs.uniform(-bound, bound, H)
        if spec.use_alphas:
            alpha[p, :len(conf)] = rs.normal(0.0, 0.1, len(conf))
        cb_bound = 1.0 / math.sqrt(H)
        cls_w[p] = rs.uniform(-cb_bound, cb_bound, (spec.num_outputs, H))
        cls_b[p] = rs.uniform(-cb_bound, cb_bound, spec.num_outputs)

    params = {"W": W, "b": b, "cls_w": cls_w, "cls_b": cls_b}
    if spec.use_alphas:
        params["alpha"] = alpha
    if spec.batchnorm:
        params["bn_scale"] = np.ones((P, R, H), np.float32)
        params["bn_bias"] = np.zeros((P, R, H), np.float32)
    params = {k: torch.tensor(v, device=device, requires_grad=True)
              for k, v in params.items()}
    bn_state = {"mean": torch.zeros((P, R, H), device=device),
                "var": torch.ones((P, R, H), device=device)}
    return params, bn_state


def pad_taps(taps, cmax):
    """List of (B, C_i) pooled taps -> (B, n_taps, cmax), zero padded."""
    return torch.stack([TF.pad(t, (0, cmax - t.shape[1])) for t in taps],
                       dim=1)


def _quantize_rows(x):
    """Symmetric int8 over the channel (last) axis: per-row float32
    absmax/127 scale, values rounded to nearest (half to even) and clipped
    to [-127, 127]."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _bank_value(got, k):
    """One gathered bank column as float32: int8 banks carry a per-row
    ``"<k>_scale"`` factor from ``_quantize_rows``; f32/bf16 banks have no
    scale entry."""
    x = got[k].float()
    s = got.get(k + "_scale")
    return x * s if s is not None else x


# --------------------------------------------------------------------------
# weight sharing across search steps: true-shape row weights keyed
# '{i}.L_{in}_{out}.A_{act}', nested {"0": {weight, bias}, "2": {BN}} numpy
# dicts, the layout the sequential trainer and the JAX package use
# --------------------------------------------------------------------------
def _row_spans(spec, conf_row, row_index):
    na = spec.sizes_a[int(conf_row[0])]
    nb = spec.sizes_b[int(conf_row[1])]
    return na, nb, row_index > 0


def _numpy(t):
    return t.detach().cpu().numpy()


def extract_shared_states(params, bn_state, confs, spec, state_dict,
                          verbose=False):
    """Slice each candidate's padded row weights back to their true shapes
    and store them under their shared-weight keys; candidates are written
    in population order (the last one wins per key)."""
    H, ca, cb = spec.hidden, spec.cmax_a, spec.cmax_b
    W = _numpy(params["W"])
    b = _numpy(params["b"])
    if spec.batchnorm:
        bn_scale = _numpy(params["bn_scale"])
        bn_bias = _numpy(params["bn_bias"])
        bn_mean = _numpy(bn_state["mean"])
        bn_var = _numpy(bn_state["var"])
    for p, conf in enumerate(confs):
        conf = np.asarray(conf)
        for r in range(len(conf)):
            na, nb, with_prev = _row_spans(spec, conf[r], r)
            in_size = na + nb + (H if with_prev else 0)
            pieces = [W[p, r, :, :na], W[p, r, :, ca:ca + nb]]
            if with_prev:
                pieces.append(W[p, r, :, ca + cb:ca + cb + H])
            entry = {"0": {"weight": np.concatenate(pieces, axis=1),
                           "bias": b[p, r].copy()}}
            if spec.batchnorm:
                # BN sits at Sequential slot 2 (Linear, act, BN, Dropout)
                entry["2"] = {
                    "weight": bn_scale[p, r].copy(),
                    "bias": bn_bias[p, r].copy(),
                    "running_mean": bn_mean[p, r].copy(),
                    "running_var": bn_var[p, r].copy(),
                    "num_batches_tracked": np.asarray(0, np.int32),
                }
            key = shared_weight_key(r, in_size, H, conf[r, 2])
            if verbose:
                print(("Updating" if key in state_dict else "Creating")
                      + " shared weight with ID: {}".format(key))
            state_dict[key] = entry
    return state_dict


def inject_shared_states(params, bn_state, confs, spec, state_dict,
                         verbose=False):
    """Load stored true-shape layers into the padded population slots whose
    shared-weight key matches; returns new (params, bn_state)."""
    H, ca, cb = spec.hidden, spec.cmax_a, spec.cmax_b
    device = params["W"].device
    W, b = _numpy(params["W"]).copy(), _numpy(params["b"]).copy()
    if spec.batchnorm:
        bn_scale = _numpy(params["bn_scale"]).copy()
        bn_bias = _numpy(params["bn_bias"]).copy()
    mean = _numpy(bn_state["mean"]).copy()
    var = _numpy(bn_state["var"]).copy()

    for p, conf in enumerate(confs):
        conf = np.asarray(conf)
        for r in range(len(conf)):
            na, nb, with_prev = _row_spans(spec, conf[r], r)
            in_size = na + nb + (H if with_prev else 0)
            key = shared_weight_key(r, in_size, H, conf[r, 2])
            if key not in state_dict:
                continue
            entry = state_dict[key]
            lw = np.asarray(entry["0"]["weight"])
            W[p, r, :, :na] = lw[:, :na]
            W[p, r, :, ca:ca + nb] = lw[:, na:na + nb]
            if with_prev:
                W[p, r, :, ca + cb:ca + cb + H] = lw[:, na + nb:]
            b[p, r] = np.asarray(entry["0"]["bias"])
            if spec.batchnorm and "2" in entry:
                bn_scale[p, r] = np.asarray(entry["2"]["weight"])
                bn_bias[p, r] = np.asarray(entry["2"]["bias"])
                mean[p, r] = np.asarray(entry["2"]["running_mean"])
                var[p, r] = np.asarray(entry["2"]["running_var"])
            if verbose:
                print("Loaded shared weight with ID: {}".format(key))

    new = {"W": W, "b": b}
    if spec.batchnorm:
        new.update(bn_scale=bn_scale, bn_bias=bn_bias)
    params = dict(params)
    params.update({k: torch.tensor(v, device=device, requires_grad=True)
                   for k, v in new.items()})
    return params, {"mean": torch.tensor(mean, device=device),
                    "var": torch.tensor(var, device=device)}


# --------------------------------------------------------------------------
# the population forward, loss and train step
# --------------------------------------------------------------------------
def population_forward(spec, params, bn_state, conf, feats_a, feats_b,
                       train, wmask, generator=None, group=None, shards=()):
    """Every candidate's fusion head over the shared padded taps.
    feats_a: (B, n_taps_a, cmax_a). Returns (logits (P, B, O), new
    bn_state). wmask (B,): validity weights; a ragged final batch repeats a
    sample, and train-mode BatchNorm statistics cover only the real rows.
    ``group``: the data group whose rows the batch holds (statistics of
    the global batch); ``shards``: this rank's part of the global (P, B, H)
    dropout mask (core/functional.py::dropout)."""
    B = feats_a.shape[0]
    P = conf["sel_a"].shape[0]
    H = spec.hidden
    out = feats_a.new_zeros((P, B, H))
    new_mean, new_var = [], []
    w = wmask.to(feats_a.dtype)[None, :, None]          # (1, B, 1)

    for r in range(spec.max_rows):
        fa = feats_a.index_select(1, conf["sel_a"][:, r]).transpose(0, 1)
        fb = feats_b.index_select(1, conf["sel_b"][:, r]).transpose(0, 1)
        if spec.use_alphas:
            g = torch.sigmoid(params["alpha"][:, r])[:, None, None]
            fa, fb = fa * g, fb * (1.0 - g)
        x = torch.cat([fa, fb, out], dim=2)             # (P, B, In)
        h = torch.baddbmm(params["b"][:, r, None, :], x,
                          params["W"][:, r].transpose(1, 2))

        a = conf["act"][:, r][:, None, None]
        h = torch.where(a == 0, torch.relu(h),
                        torch.where(a == 1, torch.sigmoid(h),
                                    TF.leaky_relu(h, 0.01)))

        if spec.batchnorm:
            if train:
                # masked, centred statistics over the real rows (of the
                # global batch under a group): [sum w*h, sum w], then
                # sum w*(h - mean)^2
                sums = pm.all_reduce_sum(torch.cat(
                    [(h * w).sum(dim=1).reshape(-1), w.sum().reshape(1)]),
                    group)
                cnt = torch.clamp(sums[-1], min=1.0)
                mean = sums[:-1].reshape(P, H) / cnt              # (P, H)
                var = pm.all_reduce_sum(
                    ((h - mean[:, None]).square() * w).sum(dim=1),
                    group) / cnt
                with torch.no_grad():
                    unbiased = var * (cnt / torch.clamp(cnt - 1.0, min=1.0))
                    new_mean.append(0.9 * bn_state["mean"][:, r]
                                    + 0.1 * mean)
                    new_var.append(0.9 * bn_state["var"][:, r]
                                   + 0.1 * unbiased)
            else:
                mean, var = bn_state["mean"][:, r], bn_state["var"][:, r]
            h = (h - mean[:, None]) * torch.rsqrt(var[:, None] + 1e-5)
            h = (h * params["bn_scale"][:, r, None]
                 + params["bn_bias"][:, r, None])

        if spec.drpt > 1e-10 and train:
            h = F.dropout(h, spec.drpt, generator, shards)

        m = conf["row_mask"][:, r].to(h.dtype)[:, None, None]
        out = m * h + (1.0 - m) * out

    logits = torch.baddbmm(params["cls_b"][:, None, :], out,
                           params["cls_w"].transpose(1, 2))
    if spec.batchnorm and train:
        new_bn = {"mean": torch.stack(new_mean, 1),
                  "var": torch.stack(new_var, 1)}
    else:
        new_bn = bn_state
    return logits, new_bn


def _masked_ce(logits, label, w, count=None):
    """Per-candidate masked mean cross entropy: logits (P, B, O) or (B, O)
    -> (P,) or scalar; ``count``: the global batch's valid rows."""
    lead = logits.shape[:-1]
    nll = TF.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           label.expand(lead).reshape(-1),
                           reduction="none").reshape(lead)
    if count is None:
        count = w.sum()
    return (nll * w).sum(dim=-1) / torch.clamp(count, min=1.0)


def population_losses(spec, params, bn_state, conf, batch, train,
                      generator=None, group=None, shards=()):
    """batch: (fa, fb, logits_b, logits_a, label, wmask). Returns
    (loss (P,), corrects (P,), new bn_state). Under a data ``group`` the
    losses are this rank's shares of the global masked means."""
    fa, fb, lb, la, label, wmask = batch
    label = label.long()
    logits, new_bn = population_forward(spec, params, bn_state, conf, fa, fb,
                                        train, wmask, generator, group,
                                        shards)
    w = wmask.to(logits.dtype)
    count = None if group is None else pm.reduce_sum(w.sum(), group)
    loss = _masked_ce(logits, label, w, count)
    summed = logits
    if spec.multitask:
        loss = (loss + _masked_ce(lb, label, w, count)
                + _masked_ce(la, label, w, count))
        summed = logits + lb + la
    corrects = ((summed.argmax(dim=-1) == label).to(w.dtype) * w).sum(-1)
    return loss, corrects, new_bn


def train_step(spec, params, bn_state, optimizer, conf, batch, lr,
               generator=None, group=None, shards=()):
    """One step of the whole population: the loss summed over candidates,
    one backward, one Adam step over the stacked parameters (each
    candidate's gradient SUMmed over the data ``group`` first). Returns
    (new bn_state, loss (P,), corrects (P,)), all on the device."""
    loss, corrects, new_bn = population_losses(spec, params, bn_state, conf,
                                               batch, True, generator, group,
                                               shards)
    optimizer.zero_grad(set_to_none=True)
    loss.sum().backward()
    pm.all_reduce_grads(params.values(), group)
    set_lr(optimizer, lr)
    optimizer.step()
    return new_bn, loss.detach(), corrects.detach()


def eval_step(spec, params, bn_state, conf, batch):
    with torch.no_grad():
        loss, corrects, _ = population_losses(spec, params, bn_state, conf,
                                              batch, False)
    return loss, corrects


# --------------------------------------------------------------------------
# trainer
# --------------------------------------------------------------------------
class PopulationTrainer:
    """Trains a whole population of fusion heads in one batched step.

    ``extractor(inputs)`` (an ``nn.Module``, e.g. fusion/ntu.py::
    NTUFeatureExtractor) returns (taps_a list, taps_b list, logits_b,
    logits_a), every tap globally pooled to (B, C_i). The trainer owns it:
    its BatchNorms never update their running statistics, and its dropout
    draws from the trainer's generator. With ``spec.feature_dtype`` it runs
    a bfloat16 copy of it on bfloat16 inputs.

    input_prep: transform of the placed inputs tuple before the extractor
    (the uint8 -> normalized clip kernel K1 for packed batches).

    cache_train_features: extract the train split once, in eval mode, into
    a device bank (bf16 under a reduced feature dtype; symmetric int8 with
    per-row scales under ``int8_bank``) that every later epoch of every
    population gathers shuffled batches from. This freezes the augmentation
    draw and uses the backbones' running statistics: candidate scoring only.

    fused_epochs: with the bank, run each epoch as one loop over an index
    plan with the dev split as a bank too; otherwise per loader batch, with
    the dev split in a per-batch cache.

    bank_batch: target batch for the eval-mode extraction passes (bank
    build and dev features): consecutive loader batches are concatenated
    up to it and the outputs re-split; eval-mode features are per sample,
    so they do not change.

    timer: optional ``runtime/profiler.py::SectionTimer``; the trainer times
    its "features" and "population steps" sections on it.

    group / pop_group: the data and pop groups of this rank in a (pop,
    data) grid of processes (``parallel/mesh.py::pop_data_groups``; the
    CLIs build a data group only). shard_feature_bank: split the banks'
    rows over the data group.
    """

    MAX_DEV_BANK = 50000

    def __init__(self, spec: PopulationSpec, extractor, *, device,
                 input_prep=None, cache_train_features=False,
                 fused_epochs=True, bank_batch=None, int8_bank=False,
                 timer=None, group=None, pop_group=None,
                 shard_feature_bank=False):
        self.spec = spec
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        if spec.feature_dtype:
            extractor = copy.deepcopy(extractor).to(
                _DTYPES[spec.feature_dtype])
        for m in extractor.modules():
            if isinstance(m, _BatchNorm):
                m.update_running_stats = False
        set_dropout_generator(extractor, self.generator)
        self.extractor = extractor.requires_grad_(False)
        self.input_prep = input_prep
        self.cache_train_features = bool(cache_train_features)
        self.fused_epochs = bool(fused_epochs)
        self.bank_batch = int(bank_batch) if bank_batch else None
        self.int8_bank = bool(int8_bank)
        self.timer = timer
        self.group, self.pop_group = group, pop_group
        self.shard_feature_bank = bool(shard_feature_bank
                                       and group is not None)
        self._dev_cache = self._dev_cache_key = None
        self._train_bank = self._train_bank_key = None
        self._dev_bank = self._dev_bank_key = None

    def _section(self, name):
        return (self.timer.section(name) if self.timer is not None
                else contextlib.nullcontext())

    # ----- the data and pop axes
    def _rows(self, batch_size):
        """This rank's rows of a batch of ``batch_size``, or None when there
        is no data group or it does not divide the batch (replicated)."""
        if self.group is None or batch_size % pm.group_size(self.group):
            return None
        return pm.row_slice(batch_size, self.group)

    def _batch_group(self, batch_size):
        """The group a batch's statistics and gradients reduce over."""
        return self.group if self._rows(batch_size) is not None else None

    def _shards(self, batch_size, pop_split):
        """This rank's part of a global (P, B, H) dropout mask."""
        shards = []
        if pop_split:
            shards.append((0, pm.group_rank(self.pop_group),
                           pm.group_size(self.pop_group)))
        if self._rows(batch_size) is not None:
            shards.append((1, pm.group_rank(self.group),
                           pm.group_size(self.group)))
        return tuple(shards)

    def _reduce_counts(self, counts, batch_size):
        """Per-candidate counts of this rank's rows -> the global batch's:
        SUM over the data group, a replicated batch counted on its first
        rank only."""
        if self.group is None:
            return counts
        if self._rows(batch_size) is None and pm.group_rank(self.group):
            counts = torch.zeros_like(counts)
        return pm.reduce_sum(counts, self.group)

    # ----- backbone features (shared by every candidate)
    def _features(self, inputs, train):
        """-> (fa, fb, logits_b, logits_a) float32; no autograd."""
        spec = self.spec
        with torch.no_grad():
            if self.input_prep is not None:
                inputs = self.input_prep(inputs)
            if spec.feature_dtype:
                dt = _DTYPES[spec.feature_dtype]
                inputs = tuple(x.to(dt) if x.is_floating_point() else x
                               for x in inputs)
            self.extractor.train(train)
            taps_a, taps_b, logits_b, logits_a = self.extractor(inputs)
            return (pad_taps(taps_a, spec.cmax_a).float(),
                    pad_taps(taps_b, spec.cmax_b).float(),
                    logits_b.float(), logits_a.float())

    @staticmethod
    def _epoch_index_plan(n, batch_size, rs=None):
        """Host-side (take, wmask) arrays of shape (steps, batch) for one
        epoch: a fresh permutation when rs is given (train) else sequential
        order (dev); the ragged final batch repeats its first index under a
        zero weight-mask."""
        idx = rs.permutation(n) if rs is not None else np.arange(n)
        steps = (n + batch_size - 1) // batch_size
        take = np.zeros((steps, batch_size), np.int32)
        wm = np.zeros((steps, batch_size), np.float32)
        for s in range(steps):
            part = idx[s * batch_size:(s + 1) * batch_size]
            take[s, :len(part)] = part
            if len(part) < batch_size:
                take[s, len(part):] = part[0]
            wm[s, :len(part)] = 1.0
        return take, wm

    @staticmethod
    def _loader_token(loader):
        """Identity token for the loader-keyed caches, stored on the loader
        so a new loader never inherits a reused id(); loaders that refuse
        attributes are never cached."""
        tok = getattr(loader, "_mfas_cache_token", None)
        if tok is None:
            tok = next(_cache_token_counter)
            try:
                loader._mfas_cache_token = tok
            except AttributeError:
                return None
        return tok

    def _cached_bank(self, which, loader, input_keys, label_key):
        """One eval-mode extraction pass per loader identity, reused across
        populations (shared by the train and dev splits)."""
        bank_attr, key_attr = f"_{which}_bank", f"_{which}_bank_key"
        key = self._loader_token(loader)
        if key is not None and getattr(self, key_attr) == key:
            return getattr(self, bank_attr)
        bank = self._build_bank(loader, input_keys, label_key)
        if key is not None:
            setattr(self, bank_attr, bank)
            setattr(self, key_attr, key)
        return bank

    # ----- host loop
    def _placed_batches(self, loader, input_keys, label_key):
        """(inputs, label, wmask) device tuples of this rank's rows, host
        collation and the host->device copy running one batch ahead."""
        group = self._batch_group(loader.batch_size)

        def place(batch):
            batch = pm.shard_batch({k: batch[k] for k in (
                *input_keys, label_key, "_mask")}, group)
            return (tuple(to_device(batch[k], self.device)
                          for k in input_keys),
                    to_device(batch[label_key], self.device),
                    to_device(batch["_mask"], self.device))

        return prefetch_to_device(loader, place)

    def _eval_feature_batches(self, loader, input_keys, label_key):
        """Eval-mode features over a loader, (fa, fb, lb, la, label, wmask)
        per loader batch (this rank's rows); with bank_batch, consecutive
        batches share one backbone forward."""
        def extract(items):
            with self._section("features"):
                if len(items) == 1:
                    inputs, label, wmask = items[0]
                    return [(*self._features(inputs, False), label, wmask)]
                inputs = tuple(torch.cat([it[0][i] for it in items])
                               for i in range(len(items[0][0])))
                fa, fb, lb, la = self._features(inputs, False)
                out, off = [], 0
                for _, label, wmask in items:
                    sl = slice(off, off + int(label.shape[0]))
                    out.append((fa[sl], fb[sl], lb[sl], la[sl], label,
                                wmask))
                    off = sl.stop
                return out

        group, buf = 1, []
        for item in self._placed_batches(loader, input_keys, label_key):
            if not buf and self.bank_batch:
                # loader batches are uniform (final batch mask-padded)
                group = max(1, self.bank_batch // int(item[1].shape[0]))
            buf.append(item)
            if len(buf) >= group:
                yield from extract(buf)
                buf = []
        if buf:
            yield from extract(buf)

    def _dev_batches(self, loader, input_keys, label_key):
        """(fa, fb, lb, la, label, wmask) for the dev split, kept on the
        device after the first pass (up to MAX_DEV_BANK samples)."""
        key = self._loader_token(loader)
        cache = key is not None
        if cache and self._dev_cache is not None \
                and self._dev_cache_key == key:
            yield from self._dev_cache
            return
        collected, n = [], 0
        for item in self._eval_feature_batches(loader, input_keys,
                                               label_key):
            n += int(item[4].shape[0])
            if cache and n <= self.MAX_DEV_BANK:
                collected.append(item)
            else:
                cache, collected = False, []
            yield item
        if cache and collected:
            self._dev_cache, self._dev_cache_key = collected, key

    def _build_bank(self, loader, input_keys, label_key):
        """One eval-mode extraction pass -> dict of per-sample device
        arrays (the padding rows of the final batch dropped, so bank N ==
        dataset size), stored in the feature dtype or as int8. Each batch's
        rows are all-gathered over the data group; under
        ``shard_feature_bank`` a rank keeps feature rows [r*m, (r+1)*m), m =
        ceil(N/D), zero-padded, and every label."""
        store_dt = (_DTYPES[self.spec.feature_dtype]
                    if self.spec.feature_dtype else torch.float32)
        keys = ["fa", "fb", "lb", "la"]
        if self.int8_bank:
            keys += [k + "_scale" for k in keys]
        parts = {k: [] for k in keys + ["label"]}
        gather = self._rows(loader.batch_size) is not None
        lo = hi = None
        if self.shard_feature_bank:
            d = pm.group_size(self.group)
            m = -(-int(loader.dataset_size) // d)
            lo = pm.group_rank(self.group) * m
            hi = lo + m
        off = 0
        for fa, fb, lb, la, label, wmask in self._eval_feature_batches(
                loader, input_keys, label_key):
            if gather:
                fa, fb, lb, la, label, wmask = (
                    pm.all_gather_rows(t, self.group)
                    for t in (fa, fb, lb, la, label, wmask))
            n = int(wmask.sum())
            got = {}
            for k, v in (("fa", fa), ("fb", fb), ("lb", lb), ("la", la)):
                if self.int8_bank:
                    got[k], got[k + "_scale"] = _quantize_rows(v[:n])
                else:
                    got[k] = v[:n].to(store_dt)
            parts["label"].append(label[:n])
            mine = (slice(None) if lo is None
                    else slice(max(lo - off, 0), max(min(hi - off, n), 0)))
            for k in keys:
                parts[k].append(got[k][mine])
            off += n
        bank = {k: torch.cat(v) for k, v in parts.items()}
        if lo is not None:
            for k in keys:
                pad = (hi - lo) - bank[k].shape[0]
                if pad:
                    bank[k] = torch.cat([bank[k], bank[k].new_zeros(
                        (pad,) + tuple(bank[k].shape[1:]))])
        return bank

    def _bank_batch(self, bank, take, wmask):
        """Gather one batch of the bank by the index row ``take``: this
        rank's rows (all of them when replicated), from a whole bank
        directly, from a sharded one through ``gather_rows``."""
        rows = self._rows(len(take))
        idx = torch.as_tensor(take, dtype=torch.long, device=self.device)
        if self.shard_feature_bank:
            got = {k: (v.index_select(0, idx) if k == "label" else
                       pm.gather_rows(v, idx, self.group))
                   for k, v in bank.items()}
            if rows is not None:
                got = {k: v[rows] for k, v in got.items()}
        else:
            if rows is not None:
                idx = idx[rows]
            got = {k: v.index_select(0, idx) for k, v in bank.items()}
        wmask = wmask if rows is None else wmask[rows]
        return (*(_bank_value(got, k) for k in ("fa", "fb", "lb", "la")),
                got["label"], torch.as_tensor(wmask, device=self.device))

    def _bank_batches(self, bank, batch_size, shuffle_rs):
        """Batches gathered from the bank under a fresh host shuffle, with
        the fused loop's index plan."""
        n = int(bank["label"].shape[0])
        for take, wm in zip(*self._epoch_index_plan(n, batch_size,
                                                    shuffle_rs)):
            yield self._bank_batch(bank, take, wm)

    def _step(self, params, bn_state, opt, conf, batch, eta, batch_size,
              pop_split):
        with self._section("population steps"):
            return train_step(self.spec, params, bn_state, opt, conf, batch,
                              eta, self.generator,
                              self._batch_group(batch_size),
                              self._shards(batch_size, pop_split))

    def _eval(self, params, bn_state, conf, batch):
        with self._section("population steps"):
            return eval_step(self.spec, params, bn_state, conf, batch)[1]

    def train_population(self, confs, dataloaders, dataset_sizes, scheduler,
                         num_epochs, input_keys, label_key="label", seed=0,
                         verbose=False, shared_state_dict=None):
        """Returns (per-candidate best dev accuracy as a list of floats,
        params, bn_state), the whole population's on every rank.

        shared_state_dict: optional weight-sharing store, injected before
        training and extracted from the final population state after."""
        spec = self.spec
        params, bn_state = init_population(confs, spec, seed,
                                           device=self.device)
        if shared_state_dict is not None:
            params, bn_state = inject_shared_states(
                params, bn_state, confs, spec, shared_state_dict,
                verbose=verbose)
        P = len(confs)
        pop = pm.group_size(self.pop_group)
        pop_split = pop > 1 and P % pop == 0
        if pop_split:
            # this pop group's candidates (a population the pop axis does
            # not divide trains whole in every pop group)
            mine = pm.row_slice(P, self.pop_group)
            params = {k: v.detach()[mine].clone().requires_grad_()
                      for k, v in params.items()}
            bn_state = {k: v[mine].clone() for k, v in bn_state.items()}
        conf = conf_tensors(confs[mine] if pop_split else confs, spec,
                            self.device)
        opt = make_adam(params.values(), spec.weight_decay)
        self.generator.manual_seed(seed + 1)

        bank = None
        if self.cache_train_features:
            bank = self._cached_bank("train", dataloaders["train"],
                                     input_keys, label_key)
        bank_rs = np.random.RandomState(seed + 17)
        best = np.zeros((P,))

        def record(phase, terms, batch_size):
            if not terms:
                raise ValueError(
                    f"'{phase}' loader yielded no batches (dataset_size="
                    f"{dataset_sizes.get(phase)}): population training "
                    "needs at least one batch per split")
            # one reduction and one device->host copy per phase; float32
            # like the JAX package's accuracies
            counts = self._reduce_counts(torch.stack(terms).sum(0),
                                         batch_size)
            if pop_split:
                counts = pm.all_gather_rows(counts, self.pop_group)
            acc = counts.float().cpu().numpy() / np.float32(
                dataset_sizes[phase])
            if verbose:
                print("{} population acc: mean {:.4f} max {:.4f}".format(
                    phase, acc.mean(), acc.max()))
            return acc

        bs = dataloaders["train"].batch_size
        dev_bs = dataloaders["dev"].batch_size
        use_fused = (bank is not None and self.fused_epochs
                     and dataset_sizes.get("dev", 0) <= self.MAX_DEV_BANK)
        if use_fused:
            dev_bank = self._cached_bank("dev", dataloaders["dev"],
                                         input_keys, label_key)
            dev_plan = self._epoch_index_plan(
                int(dev_bank["label"].shape[0]), dev_bs)
            n_train = int(bank["label"].shape[0])
            for epoch in range(num_epochs):
                take, wm = self._epoch_index_plan(n_train, bs, bank_rs)
                # the scheduler steps exactly as on the per-batch path
                etas = [scheduler.step() for _ in range(take.shape[0])]
                tr = []
                for take_s, wm_s, eta in zip(take, wm, etas):
                    bn_state, _, corr = self._step(
                        params, bn_state, opt, conf,
                        self._bank_batch(bank, take_s, wm_s), eta, bs,
                        pop_split)
                    tr.append(corr)
                dev = [self._eval(params, bn_state, conf,
                                  self._bank_batch(dev_bank, t, w))
                       for t, w in zip(*dev_plan)]
                record("train", tr, bs)
                best = np.maximum(best, record("dev", dev, dev_bs))
        else:
            set_data_group(self.extractor, self._batch_group(bs))
            for epoch in range(num_epochs):
                for phase in ("train", "dev"):
                    terms = []
                    if phase == "train" and bank is not None:
                        for batch in self._bank_batches(bank, bs, bank_rs):
                            bn_state, _, corr = self._step(
                                params, bn_state, opt, conf, batch,
                                scheduler.step(), bs, pop_split)
                            terms.append(corr)
                    elif phase == "train":
                        for inputs, label, wmask in self._placed_batches(
                                dataloaders[phase], input_keys, label_key):
                            with self._section("features"):
                                feats = self._features(inputs, True)
                            bn_state, _, corr = self._step(
                                params, bn_state, opt, conf,
                                (*feats, label, wmask), scheduler.step(),
                                bs, pop_split)
                            terms.append(corr)
                    else:
                        for batch in self._dev_batches(
                                dataloaders["dev"], input_keys, label_key):
                            terms.append(self._eval(params, bn_state, conf,
                                                    batch))
                    acc = record(phase, terms,
                                 bs if phase == "train" else dev_bs)
                    if phase == "dev":
                        best = np.maximum(best, acc)

        if pop_split:
            params = {k: pm.all_gather_rows(v.detach(), self.pop_group)
                      for k, v in params.items()}
            bn_state = {k: pm.all_gather_rows(v, self.pop_group)
                        for k, v in bn_state.items()}
        if shared_state_dict is not None:
            extract_shared_states(params, bn_state, confs, spec,
                                  shared_state_dict, verbose=verbose)
        return [float(a) for a in best], params, bn_state
