"""LSTM accuracy surrogate and its dataset (port of
mfas_tpu/search/surrogate.py).

Architecture: per-row Linear(3->100)+Sigmoid embedding -> LSTM(100) ->
last-step Linear(100->1)+Sigmoid. The Linear weights ~ U(-0.1, 0.1) and
their biases = 1.8; the LSTM keeps torch's default U(-1/sqrt(H)) init. All
initial values come from a ``torch.Generator`` seeded ``INIT_SEED``.

Training: epoch-major, one full-batch MSE step per sequence-length group,
Adam (no weight decay) whose state persists across fits, as the reference
builds its optimizer once per search. Each group is its own unpadded batch:
eager PyTorch needs neither the JAX package's power-of-two buckets nor its
``lax.scan``.

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
from mfas_tpu_torch.core.optim import BETAS, EPS, set_lr
from mfas_tpu_torch.core.rnn import LSTM
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
            last = outs[lengths - 1, torch.arange(outs.shape[1],
                                                  device=outs.device)]
        return torch.sigmoid(self.hid2val(last))


class SimpleRecurrentSurrogate:
    """The surrogate net, its persistent Adam, batched prediction."""

    def __init__(self, num_hidden=100, number_input_feats=3,
                 size_ebedding=100, *, device):
        self.device = torch.device(device)
        self.net = _SurrogateNet(
            num_hidden, number_input_feats, size_ebedding, device=self.device,
            generator=torch.Generator().manual_seed(INIT_SEED))
        self.optimizer = None

    # ---------------- inference
    def eval_models(self, confs):
        """Predicted accuracies of a conf list in one forward: mixed
        lengths are zero padded and read at their own last step."""
        confs = [np.asarray(c, np.float32) for c in confs]
        if not confs:
            return []
        Lp = max(len(c) for c in confs)
        seq = np.zeros((Lp, len(confs), confs[0].shape[-1]), np.float32)
        for i, c in enumerate(confs):
            seq[:len(c), i] = c
        lengths = torch.as_tensor([len(c) for c in confs], device=self.device)
        with torch.no_grad():
            out = self.net(torch.from_numpy(seq).to(self.device), lengths)
        return [float(v) for v in out[:, 0].tolist()]

    # ---------------- training
    def _adam(self):
        if self.optimizer is None:
            self.optimizer = torch.optim.Adam(self.net.parameters(), lr=0.0,
                                              betas=BETAS, eps=EPS)
        return self.optimizer

    def fit(self, dataset_conf, dataset_acc, num_epochs, lr):
        """dataset_conf: list of (L, N, feats) arrays grouped by sequence
        length; dataset_acc: list of (N, 1). Returns the last step's
        loss."""
        opt = self._adam()
        if num_epochs <= 0 or not dataset_conf:
            return 0.0
        groups = [(torch.as_tensor(np.asarray(c, np.float32),
                                   device=self.device),
                   torch.as_tensor(np.asarray(a, np.float32),
                                   device=self.device))
                  for c, a in zip(dataset_conf, dataset_acc)]
        set_lr(opt, lr)
        for _ in range(int(num_epochs)):
            for seq, target in groups:
                loss = torch.square(self.net(seq) - target).mean()
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
        return float(loss.detach())

    # ---------------- the JAX package's layout (search states)
    def params_numpy(self):
        return nest_tree({k: v.detach().cpu().numpy().copy()
                          for k, v in self.net.state_dict().items()})

    def opt_state_numpy(self):
        """{"m", "v", "step"} like the JAX package's ``adam_init`` state
        (moments zero and step 0 before the first step); None before the
        first fit."""
        if self.optimizer is None:
            return None
        m, v, step = {}, {}, 0
        for name, p in self.net.named_parameters():
            st = self.optimizer.state.get(p, {})
            m[name] = (st["exp_avg"].cpu().numpy().copy() if st
                       else np.zeros(tuple(p.shape), np.float32))
            v[name] = (st["exp_avg_sq"].cpu().numpy().copy() if st
                       else np.zeros(tuple(p.shape), np.float32))
            step = int(st["step"]) if st else step
        return {"m": nest_tree(m), "v": nest_tree(v),
                "step": np.asarray(step, np.int32)}

    def load_numpy(self, params, opt_state=None):
        """Restore parameters (and the Adam state) written by
        ``params_numpy``/``opt_state_numpy`` or by the JAX package."""
        self.net.load_state_dict(
            {k: torch.from_numpy(np.array(v, np.float32))
             for k, v in flatten_tree(params).items()}, strict=True)
        if opt_state is None:
            return
        opt = self._adam()
        m, v = flatten_tree(opt_state["m"]), flatten_tree(opt_state["v"])
        step = int(np.asarray(opt_state["step"]))
        state = {}
        if step:
            for i, (name, _) in enumerate(self.net.named_parameters()):
                state[i] = {"step": torch.tensor(float(step)),
                            "exp_avg": torch.from_numpy(np.array(m[name])),
                            "exp_avg_sq": torch.from_numpy(np.array(v[name]))}
        sd = opt.state_dict()
        sd["state"] = state
        opt.load_state_dict(sd)     # moves the moments to each parameter


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
