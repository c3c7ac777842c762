"""Plain PyTorch pieces shared by the frozen references: parameter
specifications, the numeric precisions a reference can be computed in, the
dropout mask stream, BatchNorm, the progressive fusion head, the masked
cross entropy, Adam and the phase-2 cosine schedule.

Nothing here imports the program under test: a reference is the
architecture written down again from the paper and the upstream code, with
``torch`` and ``torch.nn.functional`` alone.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF

# the upstream Adam: coupled L2 weight decay, betas, eps (torch's defaults)
WEIGHT_DECAY = 1e-4
BETAS = (0.9, 0.999)
EPS = 1e-8


# --------------------------------------------------------------------------
# parameters: (name, shape, kind, fan_in); kinds: "w" a weight drawn
# U(-sqrt(6/fan_in), +), "b" a bias drawn U(-1/sqrt(fan_in), +), "one",
# "zero", "count" (an int64 scalar buffer)
# --------------------------------------------------------------------------
def conv_spec(name, out_ch, in_ch, kernel, bias):
    kernel = tuple(kernel)
    fan_in = in_ch * math.prod(kernel)
    specs = [(f"{name}.weight", (out_ch, in_ch) + kernel, "w", fan_in)]
    if bias:
        specs.append((f"{name}.bias", (out_ch,), "b", fan_in))
    return specs


def linear_spec(name, out_f, in_f, bias=True):
    specs = [(f"{name}.weight", (out_f, in_f), "w", in_f)]
    if bias:
        specs.append((f"{name}.bias", (out_f,), "b", in_f))
    return specs


def bn_spec(name, n):
    return [(f"{name}.weight", (n,), "one", 0),
            (f"{name}.bias", (n,), "zero", 0),
            (f"{name}.running_mean", (n,), "zero", 0),
            (f"{name}.running_var", (n,), "one", 0),
            (f"{name}.num_batches_tracked", (), "count", 0)]


def is_trained(kind):
    """Parameters train; running statistics and counters do not."""
    return kind in ("w", "b", "one", "zero")


def trained_names(specs):
    return [n for n, _, kind, _ in specs if is_trained(kind)
            and not n.endswith(("running_mean", "running_var"))]


# --------------------------------------------------------------------------
# precision: "float32" (TF32 off), "tf32" (TF32 on for convolutions and
# matrix products), "bf16" (bfloat16 autocast, as the port's --bf16),
# "fp8" (each convolution's and product's operands and output rounded to
# float8 with a per-tensor scale, e4m3 forward and e5m2 for their
# gradients: the activations a float8 autocast would hand the elementwise
# work after each product)
# --------------------------------------------------------------------------
class Precision:
    def __init__(self, name):
        if name not in ("float32", "tf32", "bf16", "fp8"):
            raise ValueError(f"unknown reference precision {name!r}")
        self.name = name

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32)
        tf32 = self.name == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        self._autocast = (torch.autocast("cuda", dtype=torch.bfloat16)
                          if self.name == "bf16" else None)
        if self._autocast is not None:
            self._autocast.__enter__()
        return self

    def __exit__(self, *exc):
        if self._autocast is not None:
            self._autocast.__exit__(*exc)
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._saved

    def q(self, x):
        """A convolution's or product's operand or output, as this
        precision holds it (float8: e4m3 forward, its gradient e5m2, each
        with a per-tensor scale, as float8 training keeps them)."""
        return _Float8.apply(x) if self.name == "fp8" else x


def _round_scaled(x, dtype, largest):
    scale = largest / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Float8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_scaled(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round_scaled(g, torch.float8_e5m2, 57344.0)


FLOAT32 = Precision("float32")


def conv(prec, x, w, b=None, **kw):
    fn = {3: TF.conv1d, 4: TF.conv2d, 5: TF.conv3d}[x.dim()]
    return prec.q(fn(prec.q(x), prec.q(w), b, **kw))


def linear(prec, x, w, b=None):
    return prec.q(TF.linear(prec.q(x), prec.q(w), b))


# --------------------------------------------------------------------------
# dropout masks, drawn as the upstream layers draw them: one bernoulli
# draw of the mask's shape from the training generator, in forward order
# --------------------------------------------------------------------------
class MaskStream:
    """Keep-masks from ``generator`` (on the activations' device), drawn
    in ``dtype``: the dtype the trained net computes its activations in."""

    def __init__(self, generator, dtype=torch.float32):
        self.generator, self.dtype = generator, dtype

    def keep(self, shape, p, device):
        """One keep-mask draw of ``shape``."""
        keep = torch.empty(shape, device=device, dtype=self.dtype)
        return keep.bernoulli_(1.0 - p, generator=self.generator)

    def drop(self, x, p, channels=False):
        """Dropout (``channels``: Dropout2d, whole channels of a rank >= 3
        input; element-wise on rank 2)."""
        if p <= 0.0:
            return x
        shape = (x.shape[:2] + (1,) * (x.dim() - 2)
                 if channels and x.dim() > 2 else x.shape)
        return x * self.keep(shape, p, x.device).to(x.dtype) / (1.0 - p)


def batch_norm_train(x, w, b, eps=1e-5):
    """Train-mode BatchNorm: batch statistics over every axis but 1,
    biased variance."""
    axes = [i for i in range(x.dim()) if i != 1]
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, unbiased=False, keepdim=True)
    shape = [1] * x.dim()
    shape[1] = -1
    return ((x - mean) * torch.rsqrt(var + eps) * w.reshape(shape)
            + b.reshape(shape))


ACTIVATIONS = {0: torch.relu, 1: torch.sigmoid,
               2: lambda x: TF.leaky_relu(x, 0.01)}


def fusion_head_specs(conf, sizes_a, sizes_b, hidden, num_outputs,
                      batchnorm):
    """The MFAS progressive fusion head: per row a Linear over the two
    chosen taps (and the previous row's output), an activation,
    optionally BatchNorm1d, Dropout; then the central classifier. The
    alpha gates of ``--alphas`` exist unused (one scalar per row)."""
    specs = [(f"alphas.{i}.alpha_x", (1,), "zero", 0)
             for i in range(len(conf))]
    for i, row in enumerate(conf):
        in_size = sizes_a[row[0]] + sizes_b[row[1]] + (hidden if i else 0)
        specs += linear_spec(f"fusion_layers.{i}.0", hidden, in_size)
        if batchnorm:
            specs += bn_spec(f"fusion_layers.{i}.2", hidden)
    specs += linear_spec("central_classifier", num_outputs, hidden)
    return specs


def fusion_head(params, conf, feats_a, feats_b, drpt, batchnorm, masks,
                prec):
    out = None
    for i, row in enumerate(conf):
        pieces = [feats_a[row[0]], feats_b[row[1]]]
        if out is not None:
            pieces.append(out)
        p = f"fusion_layers.{i}."
        h = linear(prec, torch.cat(pieces, dim=1), params[p + "0.weight"],
                   params[p + "0.bias"])
        h = ACTIVATIONS[row[2]](h)
        if batchnorm:
            h = batch_norm_train(h, params[p + "2.weight"],
                                 params[p + "2.bias"])
        out = masks.drop(h, drpt)
    return linear(prec, out, params["central_classifier.weight"],
                  params["central_classifier.bias"])


def population_init(confs, sizes_a, sizes_b, hidden, num_outputs, seed,
                    device):
    """The candidates' fusion heads as the port's population trainer
    draws them: one ``RandomState(seed)`` over the candidates in order;
    per row U(+-1/sqrt(fan_in)) for the A columns (hidden, n_a), the B
    columns, from the second row on the previous row's (hidden, hidden),
    and the bias; then the classifier's weight and bias U(+-1/sqrt(hidden)).
    -> a list of {"W": [(hidden, in) per row], "b": [...], "cls_w",
    "cls_b"} float32 tensors."""
    rs = np.random.RandomState(seed)
    heads = []
    for conf in confs:
        rows_w, rows_b = [], []
        for r, (ia, ib, _) in enumerate(conf):
            na, nb = sizes_a[ia], sizes_b[ib]
            bound = 1.0 / math.sqrt(na + nb + (hidden if r else 0))
            parts = [rs.uniform(-bound, bound, (hidden, na)),
                     rs.uniform(-bound, bound, (hidden, nb))]
            if r:
                parts.append(rs.uniform(-bound, bound, (hidden, hidden)))
            rows_w.append(np.concatenate(parts, axis=1))
            rows_b.append(rs.uniform(-bound, bound, hidden))
        cb = 1.0 / math.sqrt(hidden)
        head = {"W": rows_w, "b": rows_b,
                "cls_w": rs.uniform(-cb, cb, (num_outputs, hidden)),
                "cls_b": rs.uniform(-cb, cb, num_outputs)}
        heads.append({k: ([torch.tensor(np.float32(a), device=device)
                           for a in v] if isinstance(v, list)
                          else torch.tensor(np.float32(v), device=device))
                      for k, v in head.items()})
    return heads


def candidate_logits(head, conf, feats_a, feats_b, keeps, p, drpt, prec):
    """Candidate ``p``'s head over its chosen taps: per row a Linear over
    the two taps (and the previous row), the activation, dropout by row
    ``r``'s population keep-mask ``keeps[r][p]``; then the classifier."""
    out = None
    for r, (ia, ib, act) in enumerate(conf):
        pieces = [feats_a[ia], feats_b[ib]] + ([out] if r else [])
        h = ACTIVATIONS[act](linear(prec, torch.cat(pieces, dim=1),
                                    head["W"][r], head["b"][r]))
        out = h * keeps[r][p] / (1.0 - drpt) if drpt > 0.0 else h
    return linear(prec, out, head["cls_w"], head["cls_b"])


def masked_ce(logits, label, mask):
    nll = TF.cross_entropy(logits, label.long(), reduction="none")
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


# --------------------------------------------------------------------------
# the upstream phase-2 schedule and optimizer
# --------------------------------------------------------------------------
def cosine_etas(eta_max, eta_min, Ti, nbpe, steps):
    """The first ``steps`` learning rates of the per-batch cosine
    schedule with warm restarts (no restart within them), each rounded to
    float32 as the optimizer receives it."""
    etas = []
    for k in range(steps):
        tcur = k / nbpe
        eta = eta_min + 0.5 * (eta_max - eta_min) * (
            1 + math.cos(math.pi * tcur / Ti))
        etas.append(float(np.float32(eta)))
    return etas


def adam_step(p, g, m, v, step, lr):
    """One torch Adam update of ``p`` in place (coupled weight decay
    already in ``g``): bias-corrected moments, eps outside the root."""
    b1, b2 = BETAS
    m.mul_(b1).add_(g, alpha=1.0 - b1)
    v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
    bc1 = 1.0 - b1 ** step
    bc2 = 1.0 - b2 ** step
    denom = (v.sqrt() / math.sqrt(bc2)).add_(EPS)
    p.addcdiv_(m, denom, value=-lr / bc1)
