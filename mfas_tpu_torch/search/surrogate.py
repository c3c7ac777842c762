"""LSTM accuracy surrogate and its dataset (port of
mfas_tpu/search/surrogate.py).

Architecture: per-row Linear(3->100)+Sigmoid embedding -> LSTM(100) ->
last-step Linear(100->1)+Sigmoid. The Linear weights ~ U(-0.1, 0.1) and
their biases = 1.8; the LSTM keeps torch's default U(-1/sqrt(H)) init. All
initial values come from a ``torch.Generator`` seeded ``INIT_SEED``.

Training: epoch-major, one full-batch MSE step per sequence-length group,
the JAX package's functional Adam (core/optim.py::adam_update, no weight
decay) whose state persists across fits, as the reference builds its
optimizer once per search. As in the JAX package every group is padded to
one shape, (Lp, B) = (max(max_seq_len, longest length), ``_bucket`` of the
largest group): a sequence is read at its own last step through
``lengths`` and the loss is the masked mean sum(sq*mask)/max(sum(mask), 1),
so the padding changes only summation order. ``fit_step`` is that one step
and ``fit_epoch`` one pass over the groups, the same functions on both
devices. On the CPU a fit runs them eagerly: the plain version. On a CUDA
device a fit replays a CUDA graph of ``fit_epoch`` (runtime/graphs.py)
``num_epochs`` times and fetches only the last loss, and ``eval_models``
replays a graph of one padded forward; the graphs live in a process-wide
cache keyed by the net's shape, the device and the padded shapes, so a
fresh surrogate recaptures nothing (``_SurrogatePrograms``).

The parameters and the Adam state convert to and from the JAX package's
layout (nested dicts of numpy arrays keyed like the ``state_dict``; Adam as
{"m", "v", "step"} with one shared step), which is what a search state
holds.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from mfas_tpu_torch.core import init as I
from mfas_tpu_torch.core import layers as L
from mfas_tpu_torch.core.optim import adam_init, adam_update
from mfas_tpu_torch.core.rnn import LSTM
from mfas_tpu_torch.runtime import graphs
from mfas_tpu_torch.runtime.checkpoint import flatten_tree, nest_tree

_U01 = I.uniform(-0.1, 0.1)
_B18 = I.constant(1.8)
INIT_SEED = 0


class _SurrogateNet(nn.Module):
    def __init__(self, num_hidden, number_input_feats, size_embedding, *,
                 device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.embedding = nn.Sequential(
            L.Linear(number_input_feats, size_embedding, weight_init=_U01,
                     bias_init=_B18, **kw),
            L.Sigmoid())
        self.lstm = LSTM(size_embedding, num_hidden, **kw)
        self.hid2val = L.Linear(num_hidden, 1, weight_init=_U01,
                                bias_init=_B18, **kw)

    def forward(self, seq, lengths=None):
        """seq: (L, B, feats) float -> (B, 1) in (0,1). With ``lengths``
        (B,) each sequence's prediction reads its own last step; the LSTM
        state at step l-1 depends only on inputs 0..l-1, so the zero padding
        beyond a sequence's length cannot change it."""
        outs, _ = self.lstm(self.embedding(seq))
        if lengths is None:
            last = outs[-1]
        else:
            idx = (lengths - 1).view(1, -1, 1).expand(1, *outs.shape[1:])
            last = outs.gather(0, idx)[0]
        return torch.sigmoid(self.hid2val(last))


def _bucket(n):
    """The power of two a batch of ``n`` pads to."""
    b = 1
    while b < n:
        b *= 2
    return b


def pad_groups(dataset_conf, dataset_acc, max_seq_len):
    """The fit's groups stacked at one padded shape, as numpy arrays:
    seqs (G, Lp, B, feats), lengths (G, B) int64, targets (G, B, 1) and
    masks (G, B) float32; Lp = max(max_seq_len, longest length), B = the
    bucket of the largest group."""
    B = _bucket(max(conf.shape[1] for conf in dataset_conf))
    Lp = max(max(max_seq_len, conf.shape[0]) for conf in dataset_conf)
    G = len(dataset_conf)
    seqs = np.zeros((G, Lp, B, dataset_conf[0].shape[-1]), np.float32)
    lengths = np.zeros((G, B), np.int64)
    tgts = np.zeros((G, B, 1), np.float32)
    masks = np.zeros((G, B), np.float32)
    for g, (conf, acc) in enumerate(zip(dataset_conf, dataset_acc)):
        n_len, n = conf.shape[0], conf.shape[1]
        seqs[g, :n_len, :n] = conf
        lengths[g] = n_len
        tgts[g, :n] = acc
        masks[g, :n] = 1.0
    return seqs, lengths, tgts, masks


def pad_confs(confs, max_seq_len):
    """A conf list as one padded batch (seq (Lp, B, feats), lengths (B,)
    int64); the padding columns have length 1 and are discarded."""
    B = _bucket(len(confs))
    Lp = max(max(max_seq_len, len(c)) for c in confs)
    seq = np.zeros((Lp, B, confs[0].shape[-1]), np.float32)
    lengths = np.ones((B,), np.int64)
    for i, c in enumerate(confs):
        seq[:len(c), i] = c
        lengths[i] = len(c)
    return seq, lengths


def fit_step(net, adam, seq, lengths, target, mask, lr):
    """One full-batch step on one padded group: the masked MSE, its
    gradients, one Adam update in place. Returns the loss (0-d)."""
    params = list(net.parameters())
    sq = torch.square(net(seq, lengths) - target)[:, 0] * mask
    loss = sq.sum() / torch.clamp(mask.sum(), min=1.0)
    adam_update(params, torch.autograd.grad(loss, params), adam, lr)
    return loss.detach()


def fit_epoch(net, adam, data, lr):
    """One epoch: ``fit_step`` on each group of ``data`` (pad_groups' four
    arrays as tensors) in order. Returns the last step's loss."""
    seqs, lengths, tgts, masks = data
    for g in range(seqs.shape[0]):
        loss = fit_step(net, adam, seqs[g], lengths[g], tgts[g], masks[g], lr)
    return loss


class _SurrogatePrograms:
    """The CUDA graphs of one surrogate shape on one device. The net,
    Adam state, learning rate and padded inputs they read are static
    tensors here; a surrogate copies its state in before a replay and back
    after. One fit graph per (G, Lp, B), one epoch of G group steps; one
    predict graph per (Lp, B)."""

    def __init__(self, num_hidden, number_input_feats, size_ebedding,
                 device):
        self.net = _SurrogateNet(
            num_hidden, number_input_feats, size_ebedding, device=device,
            generator=torch.Generator().manual_seed(INIT_SEED))
        self.params = list(self.net.parameters())
        self.adam = adam_init(self.params)
        self.lr = torch.zeros((), device=device)
        self.device = device
        self._fits, self._predicts = {}, {}

    def _state(self, params, adam):
        return [*params, *adam["m"], *adam["v"], adam["step"]]

    @staticmethod
    @torch.no_grad()
    def _copy(dst, src):
        torch._foreach_copy_(dst, src)

    def _inputs(self, table, arrays, make):
        """The static input tensors of ``arrays``' shapes, filled with
        them; ``make(inputs)`` captures that shape's graph the first
        time."""
        key = tuple(a.shape for a in arrays)
        if key not in table:
            inputs = [torch.as_tensor(a, device=self.device) for a in arrays]
            table[key] = (inputs, make(inputs))
        else:
            for t, a in zip(table[key][0], arrays):
                t.copy_(torch.from_numpy(a))
        return table[key][1]

    def fit(self, surrogate, arrays, num_epochs, lr):
        """``num_epochs`` replays of the fit graph of ``arrays``' shapes,
        from and back into ``surrogate``'s state; returns the last loss
        (0-d tensor)."""
        self.lr.fill_(lr)
        mine = self._state(self.params, self.adam)
        theirs = self._state(list(surrogate.net.parameters()),
                             surrogate.adam)
        self._copy(mine, theirs)
        captured = len(self._fits)
        graph = self._inputs(self._fits, arrays, lambda data: graphs.capture(
            "surrogate_fit",
            lambda: fit_epoch(self.net, self.adam, data, self.lr)))
        if len(self._fits) > captured:      # the warm-up moved the state
            self._copy(mine, theirs)
        for _ in range(num_epochs):
            graph.replay()
        self._copy(theirs, mine)
        return graph.out

    def predict(self, surrogate, seq, lengths):
        """The predict graph of (seq, lengths)' shapes with
        ``surrogate``'s parameters: (B, 1)."""
        self._copy(self.params, list(surrogate.net.parameters()))

        def make(inputs):
            def forward():
                with torch.no_grad():
                    return self.net(*inputs)
            return graphs.capture("surrogate_predict", forward)

        graph = self._inputs(self._predicts, (seq, lengths), make)
        graph.replay()
        return graph.out


_PROGRAM_CACHE: dict = {}


def _surrogate_programs(num_hidden, number_input_feats, size_ebedding,
                        device):
    key = (num_hidden, number_input_feats, size_ebedding, str(device))
    progs = _PROGRAM_CACHE.get(key)
    if progs is None:
        progs = _PROGRAM_CACHE[key] = _SurrogatePrograms(
            num_hidden, number_input_feats, size_ebedding, device)
    return progs


class SimpleRecurrentSurrogate:
    """The surrogate net, its persistent Adam state, batched prediction."""

    def __init__(self, num_hidden=100, number_input_feats=3,
                 size_ebedding=100, max_seq_len=4, *, device):
        self.device = torch.device(device)
        self.shape = (num_hidden, number_input_feats, size_ebedding)
        self.net = _SurrogateNet(
            *self.shape, device=self.device,
            generator=torch.Generator().manual_seed(INIT_SEED))
        self.max_seq_len = max_seq_len
        self.adam = None

    def _programs(self):
        return _surrogate_programs(*self.shape, self.device)

    # ---------------- inference
    def eval_model(self, sequence_of_operations_np):
        """One conf (L, feats) -> its predicted accuracy; the conf pads to
        max_seq_len like every batch."""
        return self.eval_models([sequence_of_operations_np])[0]

    def eval_models(self, confs):
        """Predicted accuracies of a conf list in one forward of the batch
        padded to (max_seq_len, a power of two); mixed lengths are read at
        their own last step."""
        confs = [np.asarray(c, np.float32) for c in confs]
        if not confs:
            return []
        seq, lengths = pad_confs(confs, self.max_seq_len)
        if self.device.type == "cuda":
            out = self._programs().predict(self, seq, lengths)
        else:
            with torch.no_grad():
                out = self.net(torch.from_numpy(seq), torch.from_numpy(
                    lengths))
        return [float(v) for v in out[:len(confs), 0].tolist()]

    # ---------------- training
    def fit(self, dataset_conf, dataset_acc, num_epochs, lr):
        """dataset_conf: list of (L, N, feats) arrays grouped by sequence
        length; dataset_acc: list of (N, 1). Returns the last step's
        loss. ``lr`` rounds to float32, as the JAX package feeds it."""
        if self.adam is None:
            self.adam = adam_init(list(self.net.parameters()))
        if num_epochs <= 0 or not dataset_conf:
            return 0.0
        arrays = pad_groups(dataset_conf, dataset_acc, self.max_seq_len)
        lr = float(np.float32(lr))
        if self.device.type == "cuda":
            loss = self._programs().fit(self, arrays, int(num_epochs), lr)
        else:
            data = [torch.from_numpy(a) for a in arrays]
            lr_t = torch.tensor(lr)
            for _ in range(int(num_epochs)):
                loss = fit_epoch(self.net, self.adam, data, lr_t)
        return float(loss)

    # ---------------- the JAX package's layout (search states)
    def params_numpy(self):
        return nest_tree({k: v.detach().cpu().numpy().copy()
                          for k, v in self.net.state_dict().items()})

    def opt_state_numpy(self):
        """{"m", "v", "step"} like the JAX package's ``adam_init`` state;
        None before the first fit."""
        if self.adam is None:
            return None
        names = [name for name, _ in self.net.named_parameters()]
        state = {k: nest_tree({n: t.cpu().numpy().copy()
                               for n, t in zip(names, self.adam[k])})
                 for k in ("m", "v")}
        state["step"] = np.asarray(int(self.adam["step"]), np.int32)
        return state

    def load_numpy(self, params, opt_state=None):
        """Restore parameters (and the Adam state) written by
        ``params_numpy``/``opt_state_numpy`` or by the JAX package."""
        self.net.load_state_dict(
            {k: torch.from_numpy(np.array(v, np.float32))
             for k, v in flatten_tree(params).items()}, strict=True)
        if opt_state is None:
            return
        names = [name for name, _ in self.net.named_parameters()]
        self.adam = {k: [torch.tensor(np.array(flatten_tree(opt_state[k])[n],
                                               np.float32),
                                      device=self.device) for n in names]
                     for k in ("m", "v")}
        self.adam["step"] = torch.tensor(
            float(np.asarray(opt_state["step"])), device=self.device)


class SurrogateDataloader:
    """(conf, acc) store keyed by seq_len then conf bytes; duplicate confs
    keep the max accuracy."""

    def __init__(self):
        self._dict_data = {}

    def add_datum(self, datum_conf, datum_acc):
        conf = np.ascontiguousarray(np.asarray(datum_conf))
        seq_len = len(conf)
        h = conf.tobytes()
        group = self._dict_data.setdefault(seq_len, {})
        if h in group:
            group[h] = (conf, max(datum_acc, group[h][1]))
        else:
            group[h] = (conf, datum_acc)

    def __len__(self):
        return sum(len(g) for g in self._dict_data.values())

    def get_data(self):
        """-> (list of (L, N, feats) float32, list of (N, 1) float32)."""
        dataset_conf, dataset_acc = [], []
        for _, group in self._dict_data.items():
            confs = np.asarray([d[0] for d in group.values()], np.float32)
            accs = np.asarray([d[1] for d in group.values()], np.float32)
            dataset_conf.append(np.transpose(confs, (1, 0, 2)))
            dataset_acc.append(accs[:, None])
        return dataset_conf, dataset_acc

    def get_k_best(self, k):
        """Top-k via argpartition; k <= 0 or an empty store gives none."""
        confs, accs = [], []
        for _, group in self._dict_data.items():
            for conf, acc in group.values():
                confs.append(conf)
                accs.append(acc)
        accs = np.array(accs)
        if k <= 0 or accs.size == 0:
            # np.argpartition(accs, -0)[-0:] would return everything for
            # k=0 (and raise on an empty store)
            return [], [], np.array([], np.int64)
        k = min(k, accs.size)
        top = np.argpartition(accs, -k)[-k:]
        return [confs[i] for i in top], [accs[i] for i in top], top

    # ---- persistence (resumable search)
    def state(self):
        return [(int(L), [(c.tolist(), float(a)) for c, a in g.values()])
                for L, g in self._dict_data.items()]

    @classmethod
    def from_state(cls, state):
        self = cls()
        for _, entries in state:
            for conf, acc in entries:
                self.add_datum(np.asarray(conf), acc)
        return self
