"""Population training of candidate fusion heads over frozen-backbone
features (port of mfas_tpu/search/population.py).

During the search only the fusion heads train; both backbones are frozen,
so each batch's backbone features are computed once and shared by every
candidate of the population. Candidates are independent: the forward is
batched over a leading population axis P by hand (``torch.bmm`` against
stacked per-candidate weights), and one backward plus one Adam step
(``core/optim.py::adam_update``) over the stacked parameters trains the
whole population.

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

The fused epoch (the JAX package's ``_PopulationPrograms.train_epoch`` /
``eval_epoch``): with a bank and ``fused_epochs``, each epoch runs over
static copies of the population, its Adam state
(``core/optim.py::adam_update``), both banks and the epoch's index plan and
per-step learning rates, which the host scheduler fills as on the per-batch
path. Its train steps and its dev steps are CUDA graphs (runtime/graphs.py)
where the trainer is ``graphed`` (``graphs.graphable``: on a CUDA device
with no group or NCCL ones), captured once per shape and ``BatchLayout`` in
a process-wide cache (``fused_epochs``) and replayed: one replay per epoch
and phase when an epoch has at most MAX_GRAPH_STEPS steps. Elsewhere (the
CPU, a gloo group) the same step functions run eagerly.

The per-batch path (no fused epoch): each train batch's backbone features
(streamed: extracted in train mode; with a bank whose epochs are not fused,
``--no_fused_epochs`` or a dev split over MAX_DEV_BANK: gathered from it,
eagerly, as the JAX package dispatches its ``bank_gather`` on its own) and
the population's ``train_step`` run once per batch, as the JAX package's
jitted ``features`` and ``train_step`` do, and each dev batch's
``eval_step`` over the per-batch dev cache. Where the trainer is
``graphed`` each is a CUDA graph replayed per batch: the train-mode
features (K1 inside) captured per input shape and data group on the
trainer (``streamed_features``), the two steps over static copies of the
population, its Adam state and its learning rate in a process-wide cache
by shape and ``BatchLayout`` (``streamed_steps``), so a fresh population is
copied in, not captured again. Elsewhere the same functions run eagerly.
Every Adam here is the JAX package's ``adam_update``, so the per-batch and
fused paths step alike.

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
parameters are all-gathered at the end. A ``BatchLayout`` says how a batch
splits; the collectives of a step (the gradients' and statistics' SUMs,
``gather_rows``) run inside its graph, while the correct counts of a phase
are SUMmed over the data group and all-gathered over the pop group after
it (``_reduce_counts``). Collectives run on the main thread, in step order,
never on the prefetch thread.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import math
import weakref
from dataclasses import astuple, dataclass

import numpy as np
import torch
import torch.nn.functional as TF

from mfas_tpu_torch.core import functional as F
from mfas_tpu_torch.core.layers import (_BatchNorm, set_data_group,
                                        set_dropout_generator)
from mfas_tpu_torch.core.optim import adam_init, adam_update
from mfas_tpu_torch.data.loader import prefetch_to_device, to_device
from mfas_tpu_torch.fusion.layers import shared_weight_key
from mfas_tpu_torch.parallel import mesh as pm
from mfas_tpu_torch.runtime import graphs
from mfas_tpu_torch.runtime.profiler import span

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


def train_step(spec, params, bn_state, adam, conf, batch, lr,
               generator=None, group=None, shards=()):
    """One step of the whole population: the loss summed over candidates,
    one backward (each candidate's gradient SUMmed over the data ``group``),
    and the JAX package's Adam over the stacked parameters
    (``core/optim.py::adam_update`` on ``adam``, an ``adam_init`` state)
    at ``lr``: a float, rounded to float32 as the JAX step takes it, or a
    0-d tensor on the device. Returns (new bn_state, loss (P,), corrects
    (P,)), all on the device."""
    loss, corrects, new_bn = population_losses(spec, params, bn_state, conf,
                                               batch, True, generator, group,
                                               shards)
    plist = list(params.values())
    for p in plist:
        p.grad = None
    loss.sum().backward()
    pm.all_reduce_grads(plist, group)
    if not torch.is_tensor(lr):
        lr = float(np.float32(lr))
    adam_update(plist, [p.grad for p in plist], adam, lr, spec.weight_decay)
    return new_bn, loss.detach(), corrects.detach()


def eval_step(spec, params, bn_state, conf, batch):
    with torch.no_grad():
        loss, corrects, _ = population_losses(spec, params, bn_state, conf,
                                              batch, False)
    return loss, corrects


# --------------------------------------------------------------------------
# the fused bank epoch: the JAX package's _PopulationPrograms.train_epoch /
# eval_epoch
# --------------------------------------------------------------------------
MAX_GRAPH_STEPS = 64


def _graph_steps(steps):
    """The steps one graph holds: the largest divisor of ``steps`` up to
    MAX_GRAPH_STEPS, so an epoch is whole replays (one when it is short)."""
    return max(d for d in range(1, min(steps, MAX_GRAPH_STEPS) + 1)
               if steps % d == 0)


@dataclass(frozen=True)
class BatchLayout:
    """How a population batch splits over the process groups: ``group``,
    the data group whose rank keeps its rows of the batch (None: every rank
    holds the whole batch); ``shards``, this rank's part of the global
    (P, B, H) dropout mask; ``bank_group``, the data group a bank's feature
    rows are split over (``shard_feature_bank``; None: a whole bank)."""
    group: object = None
    shards: tuple = ()
    bank_group: object = None


def gather_batch(bank, idx, wmask, layout=BatchLayout()):
    """The batch of ``bank`` at the global row numbers ``idx`` (B,) with
    the weights ``wmask`` (B,), both on the device: (fa, fb, lb, la, label,
    wmask) float32, this rank's rows under ``layout.group``. A bank split
    over ``layout.bank_group`` is read through ``gather_rows`` (its labels
    stay whole)."""
    rows = (None if layout.group is None
            else pm.row_slice(idx.shape[0], layout.group))
    if layout.bank_group is None:
        if rows is not None:
            idx = idx[rows]
        got = {k: v.index_select(0, idx) for k, v in bank.items()}
    else:
        got = {k: (v.index_select(0, idx) if k == "label" else
                   pm.gather_rows(v, idx, layout.bank_group))
               for k, v in bank.items()}
        if rows is not None:
            got = {k: v[rows] for k, v in got.items()}
    if rows is not None:
        wmask = wmask[rows]
    return (*(_bank_value(got, k) for k in ("fa", "fb", "lb", "la")),
            got["label"], wmask)


def plan_batch(bank, take, wmask, pos, layout=BatchLayout()):
    """Step ``pos`` ((1,) on the device) of an index plan (take, wmask),
    gathered from ``bank`` (``gather_batch``)."""
    return gather_batch(bank, take.index_select(0, pos)[0],
                        wmask.index_select(0, pos)[0], layout)


def _next(pos, steps):
    with torch.no_grad():
        torch.remainder(pos + 1, steps, out=pos)


def fused_train_step(spec, st, generator, layout=BatchLayout()):
    """One train step of the fused epoch on the static state ``st``
    (``_FusedEpochs``): the batch of plan step st["pos"] (this rank's part
    under ``layout``), the summed loss's gradients (SUMmed over the data
    group), the JAX package's Adam at etas[pos] in place, the BatchNorm
    state, this rank's correct counts added to st["corr"], pos advanced
    (wrapping at the epoch's end). The same function runs eagerly and
    captured."""
    pos = st["pos"]
    batch = plan_batch(st["bank"], st["take"], st["wmask"], pos, layout)
    params = list(st["params"].values())
    loss, corrects, new_bn = population_losses(
        spec, st["params"], st["bn"], st["conf"], batch, True, generator,
        layout.group, layout.shards)
    grads = torch.autograd.grad(loss.sum(), params)
    pm.all_reduce_tensors(grads, layout.group)
    adam_update(params, grads, st["adam"], st["etas"].index_select(0, pos)[0],
                spec.weight_decay)
    with torch.no_grad():
        if spec.batchnorm:
            for k, v in new_bn.items():
                st["bn"][k].copy_(v)
        st["corr"].add_(corrects)
    _next(pos, st["take"].shape[0])


def fused_eval_step(spec, st, layout=BatchLayout()):
    """One dev step of the fused epoch: plan step st["dev_pos"] of the dev
    bank (this rank's part under ``layout``), its correct counts added to
    st["dev_corr"], dev_pos advanced."""
    pos = st["dev_pos"]
    batch = plan_batch(st["dev_bank"], st["dev_take"], st["dev_wmask"], pos,
                       layout)
    with torch.no_grad():
        _, corrects, _ = population_losses(spec, st["params"], st["bn"],
                                           st["conf"], batch, False)
        st["dev_corr"].add_(corrects)
    _next(pos, st["dev_take"].shape[0])


def _bank_layout(bank):
    return tuple((k, tuple(v.shape), v.dtype) for k, v in bank.items())


class _FusedEpochs:
    """The fused bank epoch of one shape (spec, P, banks, batch sizes): a
    static state ``st`` (the population's parameters, BatchNorm state and
    Adam state, its conf, copies of both banks, the train plan and its
    per-step learning rates, the dev plan, the correct counts, the plan
    positions) and a generator of its own. ``layouts``: the train and the
    dev batches' ``BatchLayout`` (the process groups they split over; the
    collectives of a step run inside it). ``graphed``: a CUDA graph of
    ``_graph_steps`` train steps and one of dev steps, captured when the
    program is built and replayed for every epoch; otherwise each step runs
    eagerly (the plain version: the CPU's and a gloo group's, and the
    card's reference in chip_smoke.py)."""

    def __init__(self, spec, params, bn_state, conf, bank, dev_bank,
                 batch_size, dev_batch_size, *, device, graphed,
                 layouts=(BatchLayout(), BatchLayout())):
        self.graphed = graphed
        n, n_dev = int(bank["label"].shape[0]), int(dev_bank["label"].shape[0])
        steps = -(-n // batch_size)
        dev_take, dev_wm = PopulationTrainer._epoch_index_plan(
            n_dev, dev_batch_size)

        def zeros(t):
            return torch.zeros(t.shape, dtype=t.dtype, device=device)

        st = {"params": {k: zeros(v).requires_grad_()
                         for k, v in params.items()},
              "bn": {k: zeros(v) for k, v in bn_state.items()},
              "conf": {k: zeros(v) for k, v in conf.items()},
              "bank": {k: zeros(v) for k, v in bank.items()},
              "dev_bank": {k: zeros(v) for k, v in dev_bank.items()},
              "take": torch.zeros((steps, batch_size), dtype=torch.long,
                                  device=device),
              "wmask": torch.zeros((steps, batch_size), device=device),
              "etas": torch.zeros((steps,), device=device),
              "dev_take": torch.as_tensor(dev_take, dtype=torch.long,
                                          device=device),
              "dev_wmask": torch.as_tensor(dev_wm, device=device),
              "pos": torch.zeros((1,), dtype=torch.long, device=device),
              "dev_pos": torch.zeros((1,), dtype=torch.long, device=device)}
        st["adam"] = adam_init(list(st["params"].values()))
        P = conf["sel_a"].shape[0]
        st["corr"] = torch.zeros((P,), device=device)
        st["dev_corr"] = torch.zeros((P,), device=device)
        self.st, self.bank_key = st, None
        self.generator = torch.Generator(device=device)
        self.chunk = (_graph_steps(steps), _graph_steps(dev_take.shape[0]))

        train_layout, dev_layout = layouts

        def train_chunk():
            for _ in range(self.chunk[0]):
                fused_train_step(spec, st, self.generator, train_layout)

        def eval_chunk():
            for _ in range(self.chunk[1]):
                fused_eval_step(spec, st, dev_layout)

        if graphed:
            self._train = graphs.capture("population_train_epoch",
                                         train_chunk, [self.generator]).replay
            self._eval = graphs.capture("population_eval_epoch",
                                        eval_chunk).replay
        else:
            self._train, self._eval = train_chunk, eval_chunk

    def load(self, params, bn_state, conf, bank, dev_bank, bank_key=None):
        """A new population into the static state: its parameters,
        BatchNorm state and conf copied in, Adam's moments and step zeroed;
        the banks copied only when ``bank_key`` (None: always) differs from
        the last one's."""
        st = self.st
        with torch.no_grad():
            for name, src in (("params", params), ("bn", bn_state),
                              ("conf", conf)):
                for k, v in src.items():
                    st[name][k].copy_(v)
            if bank_key is None or bank_key != self.bank_key:
                for name, src in (("bank", bank), ("dev_bank", dev_bank)):
                    for k, v in src.items():
                        st[name][k].copy_(v)
            self.bank_key = bank_key
            for t in (*st["adam"]["m"], *st["adam"]["v"], st["adam"]["step"],
                      st["pos"], st["dev_pos"]):
                t.zero_()

    def train_epoch(self, take, wmask, etas, generator):
        """One train epoch over the plan (take, wmask) at the per-step
        learning rates ``etas``, dropout drawn from ``generator``'s stream
        (its state moves on as an eager epoch would move it). Returns the
        correct counts (P,) of this rank's rows, a static tensor the next
        epoch rewrites."""
        st = self.st
        st["take"].copy_(torch.as_tensor(take))
        st["wmask"].copy_(torch.as_tensor(wmask))
        st["etas"].copy_(torch.as_tensor(np.asarray(etas, np.float32)))
        st["corr"].zero_()
        self.generator.set_state(generator.get_state())
        for _ in range(st["take"].shape[0] // self.chunk[0]):
            self._train()
        generator.set_state(self.generator.get_state())
        return st["corr"]

    def eval_epoch(self):
        """One dev epoch; returns the correct counts (P,), static."""
        self.st["dev_corr"].zero_()
        for _ in range(self.st["dev_take"].shape[0] // self.chunk[1]):
            self._eval()
        return self.st["dev_corr"]

    def state(self):
        """Copies of the population's (params, bn_state)."""
        return ({k: v.detach().clone() for k, v in self.st["params"].items()},
                {k: v.clone() for k, v in self.st["bn"].items()})


_FUSED_CACHE: dict = {}


def fused_epochs(spec, params, bn_state, conf, bank, dev_bank, batch_size,
                 dev_batch_size, *, device, graphed=None,
                 layouts=(BatchLayout(), BatchLayout())):
    """The process-wide ``_FusedEpochs`` of these shapes and ``layouts``
    (the counterpart of ``population_programs(program_key=...)``), built on
    first use: ``graphed`` (by default: on a CUDA device) or eager. It holds
    its own copy of the banks for as long as the process runs."""
    device = torch.device(device)
    if graphed is None:
        graphed = device.type == "cuda"
    key = (astuple(spec), tuple((k, tuple(v.shape)) for k, v in
                                params.items()),
           _bank_layout(bank), _bank_layout(dev_bank), batch_size,
           dev_batch_size, str(device), graphed, tuple(layouts))
    prog = _FUSED_CACHE.get(key)
    if prog is None:
        prog = _FUSED_CACHE[key] = _FusedEpochs(
            spec, params, bn_state, conf, bank, dev_bank, batch_size,
            dev_batch_size, device=device, graphed=graphed, layouts=layouts)
    return prog


# a population batch's entries, in population_losses' order
_BATCH_KEYS = ("fa", "fb", "lb", "la", "label", "wmask")


class _StreamedSteps:
    """The streamed per-batch steps of one population shape (spec, P): the
    JAX package's jitted ``train_step`` and ``eval_step`` driven once per
    batch (``_PopulationPrograms``' bankless path). A static state ``st``
    (the population's parameters, BatchNorm state, Adam state and conf, the
    learning rate, the train and dev correct counts) and a generator of its
    own. ``layout``: the train batches' ``BatchLayout`` (its data group's
    collectives run inside the train step; the eval step reduces nothing).
    ``graphed``: each step a CUDA graph (runtime/graphs.py::Step, one per
    batch shape, both in one memory pool), its batch (fa, fb, lb, la,
    label, wmask) copied into static inputs; otherwise each step runs
    eagerly (the plain version: the CPU's and a gloo group's, and the
    card's reference in chip_smoke.py)."""

    def __init__(self, spec, params, bn_state, conf, *, device, graphed,
                 layout=BatchLayout()):
        def zeros(t):
            return torch.zeros(t.shape, dtype=t.dtype, device=device)

        P = conf["sel_a"].shape[0]
        st = {"params": {k: zeros(v).requires_grad_()
                         for k, v in params.items()},
              "bn": {k: zeros(v) for k, v in bn_state.items()},
              "conf": {k: zeros(v) for k, v in conf.items()},
              "lr": torch.zeros((), device=device),
              "corr": torch.zeros((P,), device=device),
              "dev_corr": torch.zeros((P,), device=device)}
        st["adam"] = adam_init(list(st["params"].values()))
        self.spec, self.st, self.layout = spec, st, layout
        self.generator = torch.Generator(device=device)
        if graphed:
            pool = torch.cuda.graph_pool_handle()
            self._train = graphs.Step(
                "population_train_step", self._train_fn, state=self._moved,
                generators=[self.generator], pool=pool, exclusive=True)
            self._eval = graphs.Step(
                "population_eval_step", self._eval_fn,
                state=lambda: [st["dev_corr"]], pool=pool)
        else:
            self._train, self._eval = self._train_fn, self._eval_fn

    def _moved(self):
        st = self.st
        return [*st["params"].values(), *st["bn"].values(), *st["adam"]["m"],
                *st["adam"]["v"], st["adam"]["step"], st["corr"]]

    @staticmethod
    def _batch(b):
        return tuple(b[k] for k in _BATCH_KEYS)

    def _train_fn(self, b):
        st = self.st
        new_bn, _, corrects = train_step(
            self.spec, st["params"], st["bn"], st["adam"], st["conf"],
            self._batch(b), st["lr"], self.generator, self.layout.group,
            self.layout.shards)
        with torch.no_grad():
            if self.spec.batchnorm:
                for k, v in new_bn.items():
                    st["bn"][k].copy_(v)
            st["corr"].add_(corrects)
        return ()

    def _eval_fn(self, b):
        st = self.st
        _, corrects = eval_step(self.spec, st["params"], st["bn"],
                                st["conf"], self._batch(b))
        with torch.no_grad():
            st["dev_corr"].add_(corrects)
        return ()

    def load(self, params, bn_state, conf):
        """A new population into the static state: its parameters,
        BatchNorm state and conf copied in, Adam's moments and step and the
        correct counts zeroed."""
        st = self.st
        with torch.no_grad():
            for name, src in (("params", params), ("bn", bn_state),
                              ("conf", conf)):
                for k, v in src.items():
                    st[name][k].copy_(v)
            for t in (*st["adam"]["m"], *st["adam"]["v"], st["adam"]["step"],
                      st["corr"], st["dev_corr"]):
                t.zero_()

    def train_batch(self, feats, label, wmask, lr, generator):
        """One train step on the features ``feats`` (fa, fb, lb, la) at the
        scheduler's ``lr``, dropout drawn from ``generator``'s stream (its
        state moves on as an eager step would move it); the correct counts
        of this rank's rows add to ``st["corr"]``."""
        self.st["lr"].fill_(float(np.float32(lr)))
        self.generator.set_state(generator.get_state())
        self._train(dict(zip(_BATCH_KEYS, (*feats, label, wmask))))
        generator.set_state(self.generator.get_state())

    def eval_batch(self, batch):
        """One dev step on a cached (fa, fb, lb, la, label, wmask) batch;
        the correct counts add to ``st["dev_corr"]``."""
        self._eval(dict(zip(_BATCH_KEYS, batch)))

    def counts(self, which):
        """A copy of the correct counts (P,) of "corr" or "dev_corr",
        zeroed for the next phase."""
        c = self.st[which].clone()
        self.st[which].zero_()
        return c

    def state(self):
        """Copies of the population's (params, bn_state)."""
        return ({k: v.detach().clone() for k, v in self.st["params"].items()},
                {k: v.clone() for k, v in self.st["bn"].items()})


_STREAMED_CACHE: dict = {}


def streamed_steps(spec, params, bn_state, conf, *, device, graphed,
                   layout=BatchLayout()):
    """The process-wide ``_StreamedSteps`` of this population shape and
    ``layout``, built on first use (``graphed`` on a CUDA device with no
    group or NCCL ones, eager otherwise)."""
    device = torch.device(device)
    key = (astuple(spec), tuple((k, tuple(v.shape)) for k, v in
                                params.items()), str(device), graphed,
           layout)
    prog = _STREAMED_CACHE.get(key)
    if prog is None:
        prog = _STREAMED_CACHE[key] = _StreamedSteps(
            spec, params, bn_state, conf, device=device, graphed=graphed,
            layout=layout)
    return prog


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

    fused_epochs: with the bank, run each epoch over an index plan with the
    dev split as a bank too (graphed where the trainer is ``graphed``, see
    the module docstring); otherwise per loader batch, with the dev split
    in a per-batch cache.

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
        self._token = next(_cache_token_counter)
        self.graphed = graphs.graphable(self.device, group, pop_group)
        # the extractor's data group (set_data_group) and its train-mode
        # feature graphs, one graphs.Step per group
        self._feature_group = None
        self._train_features = {}

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

    def _layout(self, batch_size, pop_split):
        """The ``BatchLayout`` of this rank's batches of ``batch_size``."""
        return BatchLayout(self._batch_group(batch_size),
                           self._shards(batch_size, pop_split),
                           self.group if self.shard_feature_bank else None)

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
        """One eval-mode extraction pass over the loader's first epoch ->
        dict of per-sample device arrays (the padding rows of the final
        batch dropped, so bank N == dataset size), stored in the feature
        dtype or as int8. Each batch's rows are all-gathered over the data
        group; under ``shard_feature_bank`` a rank keeps feature rows
        [r*m, (r+1)*m), m = ceil(N/D), zero-padded, and every label."""
        store_dt = (_DTYPES[self.spec.feature_dtype]
                    if self.spec.feature_dtype else torch.float32)
        # a bank holds the loader's first epoch (its shuffle and per-sample
        # augmentation draws). A resumed search has restored the loader past
        # that epoch; without the rewind its bank would differ from the one
        # the uninterrupted search trained on, as the JAX package's does
        if hasattr(loader, "rewind_rng"):
            loader.rewind_rng()
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
        """Gather one batch of the bank by the host index row ``take``:
        this rank's rows (all of them when replicated), from a whole bank
        directly, from a sharded one through ``gather_rows``."""
        return gather_batch(
            bank, torch.as_tensor(take, dtype=torch.long, device=self.device),
            torch.as_tensor(wmask, device=self.device),
            self._layout(len(take), False))

    def _bank_batches(self, bank, batch_size, shuffle_rs):
        """Batches gathered from the bank under a fresh host shuffle, with
        the fused loop's index plan."""
        n = int(bank["label"].shape[0])
        for take, wm in zip(*self._epoch_index_plan(n, batch_size,
                                                    shuffle_rs)):
            yield self._bank_batch(bank, take, wm)

    def _train_batches(self, bank, loader, bank_rs, input_keys, label_key):
        """(features (fa, fb, lb, la), label, wmask) of each train batch of
        an epoch: gathered from ``bank`` under a fresh shuffle of
        ``bank_rs``, or the train-mode features of each loader batch."""
        if bank is not None:
            for *feats, label, wmask in self._bank_batches(
                    bank, loader.batch_size, bank_rs):
                yield feats, label, wmask
            return
        for inputs, label, wmask in self._placed_batches(loader, input_keys,
                                                         label_key):
            with self._section("features"):
                feats = self.streamed_features(inputs)
            yield feats, label, wmask

    def _set_feature_group(self, group):
        """The data group the train-mode features' batch statistics and
        dropout masks are those of (``set_data_group`` on the extractor)."""
        self._feature_group = group
        set_data_group(self.extractor, group)

    def streamed_features(self, inputs):
        """The train-mode features of one placed batch: when
        ``self.graphed`` a replay of ``_features(inputs, True)`` captured
        once per input shape and data group (the extractor and the
        generator are this trainer's; the graph holds the trainer weakly,
        so both go with its last user). Under an NCCL data group the
        graph holds the synced BatchNorms' all-reduces."""
        if not self.graphed:
            return self._features(inputs, True)
        step = self._train_features.get(self._feature_group)
        if step is None:
            trainer = weakref.proxy(self)
            step = self._train_features[self._feature_group] = graphs.Step(
                "population_features",
                lambda b: trainer._features(
                    tuple(b[k] for k in sorted(b)), True),
                generators=[self.generator])
        return step({str(i): x for i, x in enumerate(inputs)})

    def train_population(self, confs, dataloaders, dataset_sizes, scheduler,
                         num_epochs, input_keys, label_key="label", seed=0,
                         verbose=False, shared_state_dict=None):
        """Returns (per-candidate best dev accuracy as a list of floats,
        params, bn_state), the whole population's on every rank.

        shared_state_dict: optional weight-sharing store, injected before
        training and extracted from the final population state after.

        Spans (runtime/profiler.py::span): "population.setup", everything
        before the first epoch and the state taken out after the last;
        "population.readback", each phase's accuracies read to the host."""
        spec = self.spec
        P = len(confs)
        pop = pm.group_size(self.pop_group)
        pop_split = pop > 1 and P % pop == 0
        bs = dataloaders["train"].batch_size
        dev_bs = dataloaders["dev"].batch_size

        def record(phase, terms, batch_size):
            if not terms:
                raise ValueError(
                    f"'{phase}' loader yielded no batches (dataset_size="
                    f"{dataset_sizes.get(phase)}): population training "
                    "needs at least one batch per split")
            # one reduction and one device->host copy per phase; float32
            # like the JAX package's accuracies
            with span("population.readback"):
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

        with span("population.setup"):
            params, bn_state = init_population(confs, spec, seed,
                                               device=self.device)
            if shared_state_dict is not None:
                params, bn_state = inject_shared_states(
                    params, bn_state, confs, spec, shared_state_dict,
                    verbose=verbose)
            if pop_split:
                # this pop group's candidates (a population the pop axis
                # does not divide trains whole in every pop group)
                mine = pm.row_slice(P, self.pop_group)
                params = {k: v.detach()[mine].clone().requires_grad_()
                          for k, v in params.items()}
                bn_state = {k: v[mine].clone() for k, v in bn_state.items()}
            conf = conf_tensors(confs[mine] if pop_split else confs, spec,
                                self.device)
            self.generator.manual_seed(seed + 1)

            bank = None
            if self.cache_train_features:
                bank = self._cached_bank("train", dataloaders["train"],
                                         input_keys, label_key)
            bank_rs = np.random.RandomState(seed + 17)
            best = np.zeros((P,))
            layout = self._layout(bs, pop_split)
            self._set_feature_group(layout.group)
            use_fused = (bank is not None and self.fused_epochs
                         and dataset_sizes.get("dev", 0)
                         <= self.MAX_DEV_BANK)
            if use_fused:
                dev_bank = self._cached_bank("dev", dataloaders["dev"],
                                             input_keys, label_key)
                n_train = int(bank["label"].shape[0])
                prog = fused_epochs(spec, params, bn_state, conf, bank,
                                    dev_bank, bs, dev_bs, device=self.device,
                                    graphed=self.graphed,
                                    layouts=(layout,
                                             self._layout(dev_bs, False)))
                keys = (self._train_bank_key, self._dev_bank_key)
                prog.load(params, bn_state, conf, bank, dev_bank,
                          None if None in keys else (self._token, *keys))
            else:
                # the per-batch programs (graphed on the card)
                prog = streamed_steps(spec, params, bn_state, conf,
                                      device=self.device,
                                      graphed=self.graphed, layout=layout)
                prog.load(params, bn_state, conf)
        if use_fused:
            for epoch in range(num_epochs):
                take, wm = self._epoch_index_plan(n_train, bs, bank_rs)
                # the scheduler steps exactly as on the per-batch path
                etas = [scheduler.step() for _ in range(take.shape[0])]
                with self._section("population steps"):
                    tr = prog.train_epoch(take, wm, etas, self.generator)
                    dev = prog.eval_epoch()
                record("train", [tr], bs)
                best = np.maximum(best, record("dev", [dev], dev_bs))
        else:
            for epoch in range(num_epochs):
                n = 0
                for feats, label, wmask in self._train_batches(
                        bank, dataloaders["train"], bank_rs, input_keys,
                        label_key):
                    with self._section("population steps"):
                        prog.train_batch(feats, label, wmask,
                                         scheduler.step(), self.generator)
                    n += 1
                record("train", [prog.counts("corr")] if n else [], bs)
                n = 0
                for batch in self._dev_batches(dataloaders["dev"],
                                               input_keys, label_key):
                    with self._section("population steps"):
                        prog.eval_batch(batch)
                    n += 1
                best = np.maximum(best, record(
                    "dev", [prog.counts("dev_corr")] if n else [], dev_bs))

        with span("population.setup"):
            params, bn_state = prog.state()
            if pop_split:
                params = {k: pm.all_gather_rows(v.detach(), self.pop_group)
                          for k, v in params.items()}
                bn_state = {k: pm.all_gather_rows(v, self.pop_group)
                            for k, v in bn_state.items()}
            if shared_state_dict is not None:
                extract_shared_states(params, bn_state, confs, spec,
                                      shared_state_dict, verbose=verbose)
        return [float(a) for a in best], params, bn_state
