"""Functional ops of the ported paths (port of mfas_tpu/core/functional.py).

Torch layouts throughout: (N,C,L), (N,C,H,W) and (N,C,D,H,W), weights
(O,I,k...).
Convolutions are cuDNN's on the card, as the JAX package leaves them to XLA
outside any kernel.

Five options choose another formulation of the same math, with the JAX
package's setters and environment variables (read at import):

  * ``set_conv_channels_last`` (``MFAS_CONV_CHANNELS_LAST=1``): conv2d and
    conv3d hand cuDNN the input and the weight in ``torch.channels_last`` /
    ``torch.channels_last_3d`` memory format (NHWC / NDHWC, the layout its
    tensor-core convolutions read) and leave the output so. Logical shapes,
    values and ``state_dict``s are unchanged;
  * ``set_conv3d_as_2d`` (``MFAS_CONV3D_AS_2D=1``): a 3D conv with odd kd,
    stride_d = dilation_d = 1 and pad_d = kd//2 becomes kd batched conv2ds
    over (N*D, C, H, W) and a temporal shift-add;
  * ``set_conv1x1_as_matmul`` (``MFAS_CONV1X1_AS_MATMUL=1``): an unpadded,
    ungrouped 1x1x1 conv3d becomes a product over channels (cuBLAS);
  * ``set_pool_as_slices`` (``MFAS_POOL_AS_SLICES=1``): a max_pool2d window
    of at most 9 elements becomes a maximum tree over its strided slices
    (-inf padding);
  * ``set_pool_separable`` (``MFAS_POOL_SEPARABLE=1``): a max_pool2d of a
    window wider than 1 both ways becomes two 1-D max pools, rows then
    columns. Values are exact; where a window's maximum is tied, the
    backward may route the gradient to another of the tied elements.

conv3d tries them in the JAX package's order (matmul, then 3d-as-2d, then
channels-last; a conv outside an option's guard takes the next one), and
max_pool2d tries slices before separable. ``OPTION_CALLS`` counts the calls
each option's formulation took; ``layout_options`` holds options for a
block.
"""

from __future__ import annotations

import collections
import contextlib
import os

import torch
import torch.nn.functional as TF


def _option(env):
    return os.environ.get(env) == "1"


CONV_CHANNELS_LAST = _option("MFAS_CONV_CHANNELS_LAST")
CONV3D_AS_2D = _option("MFAS_CONV3D_AS_2D")
CONV1X1_AS_MATMUL = _option("MFAS_CONV1X1_AS_MATMUL")
POOL_AS_SLICES = _option("MFAS_POOL_AS_SLICES")
POOL_SEPARABLE = _option("MFAS_POOL_SEPARABLE")

# calls that took each option's formulation, by option name
OPTION_CALLS = collections.Counter()


def set_conv_channels_last(enabled: bool):
    global CONV_CHANNELS_LAST
    CONV_CHANNELS_LAST = bool(enabled)


def set_conv3d_as_2d(enabled: bool):
    global CONV3D_AS_2D
    CONV3D_AS_2D = bool(enabled)


def set_conv1x1_as_matmul(enabled: bool):
    global CONV1X1_AS_MATMUL
    CONV1X1_AS_MATMUL = bool(enabled)


def set_pool_as_slices(enabled: bool):
    global POOL_AS_SLICES
    POOL_AS_SLICES = bool(enabled)


def set_pool_separable(enabled: bool):
    global POOL_SEPARABLE
    POOL_SEPARABLE = bool(enabled)


_SETTERS = {"conv_channels_last": set_conv_channels_last,
            "conv3d_as_2d": set_conv3d_as_2d,
            "conv1x1_as_matmul": set_conv1x1_as_matmul,
            "pool_as_slices": set_pool_as_slices,
            "pool_separable": set_pool_separable}


def option_values():
    """{option name: whether it is on}, the names ``layout_options`` takes."""
    return {name: globals()[name.upper()] for name in _SETTERS}


@contextlib.contextmanager
def layout_options(**enabled):
    """Set the named options (``conv_channels_last=True``, ...) for the
    block and put every option back as it was on leaving it."""
    unknown = set(enabled) - set(_SETTERS)
    if unknown:
        raise ValueError(f"unknown layout options {sorted(unknown)}; "
                         f"known: {sorted(_SETTERS)}")
    before = option_values()
    try:
        for name, on in enabled.items():
            _SETTERS[name](on)
        yield
    finally:
        for name, on in before.items():
            _SETTERS[name](on)


def _tuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


def _channels_last(x, w):
    """x and w in the channels-last memory format of their rank (a no-op
    for a tensor already in it)."""
    OPTION_CALLS["conv_channels_last"] += 1
    fmt = torch.channels_last if x.dim() == 4 else torch.channels_last_3d
    return x.contiguous(memory_format=fmt), w.contiguous(memory_format=fmt)


def conv2d(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
    if CONV_CHANNELS_LAST:
        x, w = _channels_last(x, w)
    return TF.conv2d(x, w, b, stride=stride, padding=padding,
                     dilation=dilation, groups=groups)


def _conv3d_via_2d(x, w, b, stride, padding, dilation, groups):
    """x: (N,C,D,H,W), w: (O,I/g,kd,kh,kw) with stride_d = dilation_d = 1
    and pad_d = kd//2: tap dt of the kernel is a conv2d over the N*D frames,
    shifted by pad_d - dt frames (zeros shifted in) and summed."""
    N, C, D, H, W = x.shape
    kd, pad_d = w.shape[2], padding[0]
    frames = x.transpose(1, 2).reshape(N * D, C, H, W)
    out = None
    for dt in range(kd):
        yf = conv2d(frames, w[:, :, dt], None, stride=stride[1:],
                    padding=padding[1:], dilation=dilation[1:], groups=groups)
        y = yf.reshape(N, D, *yf.shape[1:])
        s = pad_d - dt                  # out[:, t] += y[:, t - s]
        if s > 0:
            y = TF.pad(y[:, :-s], (0, 0, 0, 0, 0, 0, s, 0))
        elif s < 0:
            y = TF.pad(y[:, -s:], (0, 0, 0, 0, 0, 0, 0, -s))
        out = y if out is None else out + y
    out = out.transpose(1, 2)
    if b is not None:
        out = out + b.reshape(1, -1, 1, 1, 1)
    return out


def conv3d(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
    stride, dilation = _tuple(stride, 3), _tuple(dilation, 3)
    padding = _tuple(padding, 3)
    if (CONV1X1_AS_MATMUL and tuple(w.shape[2:]) == (1, 1, 1)
            and groups == 1 and padding == (0, 0, 0)):
        # a 1x1x1 conv is a product over the channels; a stride subsamples
        OPTION_CALLS["conv1x1_as_matmul"] += 1
        if stride != (1, 1, 1):
            x = x[:, :, ::stride[0], ::stride[1], ::stride[2]]
        out = torch.einsum("ncdhw,oc->nodhw", x, w[:, :, 0, 0, 0])
        if b is not None:
            out = out + b.reshape(1, -1, 1, 1, 1)
        return out
    if (CONV3D_AS_2D and stride[0] == 1 and dilation[0] == 1
            and w.shape[2] % 2 == 1 and padding[0] == w.shape[2] // 2):
        # odd kd only: the shift-add assumes a centred temporal window
        OPTION_CALLS["conv3d_as_2d"] += 1
        return _conv3d_via_2d(x, w, b, stride, padding, dilation, groups)
    if CONV_CHANNELS_LAST:
        x, w = _channels_last(x, w)
    return TF.conv3d(x, w, b, stride=stride, padding=padding,
                     dilation=dilation, groups=groups)


def conv1d(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
    """x: (N,C,L), w: (O,I,k) (the AV-MNIST CentralNet's central column)."""
    return TF.conv1d(x, w, b, stride=stride, padding=padding,
                     dilation=dilation, groups=groups)


def linear(x, w, b=None):
    return TF.linear(x, w, b)


def _max_pool2d_slices(x, k, s, p):
    """The maximum over the k[0]*k[1] strided slices of x padded with
    -inf (the dtype's least value for integers)."""
    if p != (0, 0):
        neg = (float("-inf") if x.is_floating_point()
               else torch.iinfo(x.dtype).min)
        x = TF.pad(x, (p[1], p[1], p[0], p[0]), value=neg)
    H, W = x.shape[-2:]
    Ho, Wo = (H - k[0]) // s[0] + 1, (W - k[1]) // s[1] + 1
    out = None
    for di in range(k[0]):
        for dj in range(k[1]):
            v = x[..., di:di + (Ho - 1) * s[0] + 1:s[0],
                  dj:dj + (Wo - 1) * s[1] + 1:s[1]]
            out = v if out is None else torch.maximum(out, v)
    return out


def max_pool2d(x, kernel_size, stride=None, padding=0):
    """Padding counts as -inf, as in torch and the JAX reduce_window."""
    k = _tuple(kernel_size, 2)
    s = _tuple(stride, 2) if stride is not None else k
    p = _tuple(padding, 2)
    if POOL_AS_SLICES and k[0] * k[1] <= 9:
        OPTION_CALLS["pool_as_slices"] += 1
        return _max_pool2d_slices(x, k, s, p)
    if POOL_SEPARABLE and k[0] > 1 and k[1] > 1:
        # max over the window == max over rows of the max over columns
        OPTION_CALLS["pool_separable"] += 1
        rows = TF.max_pool2d(x, (1, k[1]), stride=(1, s[1]),
                             padding=(0, p[1]))
        return TF.max_pool2d(rows, (k[0], 1), stride=(s[0], 1),
                             padding=(p[0], 0))
    return TF.max_pool2d(x, k, stride=s, padding=p)


def avg_pool2d(x, kernel_size, stride=None, padding=0,
               count_include_pad=True):
    """Zero padding; ``count_include_pad=False`` divides each window by its
    count of unpadded elements (the JAX package's second reduce_window)."""
    return TF.avg_pool2d(x, kernel_size, stride=stride, padding=padding,
                         count_include_pad=count_include_pad)


def avg_pool3d(x, kernel_size, stride=None, padding=0):
    """Zero padding counted in every window's size."""
    return TF.avg_pool3d(x, kernel_size, stride=stride, padding=padding)


def adaptive_avg_pool2d_1x1(x):
    """AdaptiveAvgPool2d((1,1)) on (N,C,H,W)."""
    return x.mean(dim=(2, 3), keepdim=True)


def global_avg_pool2d(x):
    """Reference GlobalPooling2D (models/auxiliary/aux_models.py:54-64):
    mean over everything after the channel dim; identity on (N,C)."""
    return x.reshape(x.shape[0], x.shape[1], -1).mean(dim=2)


def global_avg_pool1d(x):
    """Reference GlobalPooling1D: the mean over axis 2."""
    return x.mean(dim=2)


def interpolate_bilinear(x, size):
    """(N,C,H,W) -> (N,C,*size), half-pixel centers, no antialias: the JAX
    package's jax.image.resize(linear, antialias=False), upsampling
    (hcn_motion's (T-1) -> T) and downsampling (CentralNet aligning the
    skeleton maps to the video's at 224 px, 32 -> 28 and 16 -> 14). The
    result keeps x's dtype (autocast runs the resize in f32 on the
    card)."""
    return TF.interpolate(x, size=tuple(size), mode="bilinear",
                          align_corners=False).to(x.dtype)


class MaskTape:
    """The keep masks of the dropouts that draw with it: recorded in order
    by a first run, handed back in the same order after ``rewind()``, so a
    rerun (core/remat.py's recomputation) draws nothing and multiplies by
    the same masks."""

    def __init__(self):
        self.masks, self._replay = [], None

    def rewind(self):
        self._replay = iter(self.masks)


def _drop(x, p, mask_shape, generator, shards=(), masks=None):
    if masks is not None and masks._replay is not None:
        return x * next(masks._replay) / (1.0 - p)
    if generator is None:
        raise ValueError("dropout draws its mask from an explicit "
                         "torch.Generator; got None")
    full = list(mask_shape)
    for dim, _, count in shards:
        full[dim] *= count
    keep = torch.empty(full, device=x.device, dtype=x.dtype)
    keep.bernoulli_(1.0 - p, generator=generator)
    for dim, index, count in shards:
        keep = keep.narrow(dim, index * mask_shape[dim], mask_shape[dim])
    if masks is not None:
        masks.masks.append(keep)
    return x * keep / (1.0 - p)


def dropout(x, p, generator, shards=(), masks=None):
    """torch Dropout train mode: zero with prob p, keep scaled by 1/(1-p).
    The mask comes from ``generator`` (on x's device), never from torch's
    global RNG. ``shards``: (dim, index, count) triples saying that ``x``
    is part ``index`` of ``count`` equal parts of a global tensor along
    ``dim``; the mask is drawn at the global shape and this part kept.
    ``masks``: a MaskTape that records the mask, or hands a recorded one
    back."""
    if p <= 0.0:
        return x
    return _drop(x, p, x.shape, generator, shards, masks)


def dropout2d(x, p, generator, shards=(), masks=None):
    """Whole channels (axis 1) on rank >= 3 inputs; element-wise on rank
    <= 2, as the JAX package's dropout2d."""
    if p <= 0.0:
        return x
    if x.dim() <= 2:
        return dropout(x, p, generator, shards, masks)
    return _drop(x, p, x.shape[:2] + (1,) * (x.dim() - 2), generator,
                 shards, masks)


def cross_entropy(logits, labels, weights=None, count=None):
    """torch CrossEntropyLoss (mean reduction); ``weights`` is an optional
    per-sample 0/1 mask for padded batches (mean over valid samples).
    ``count``: the valid samples of the global batch when these rows are
    one rank's part of it (parallel/mesh.py), else ``weights.sum()``."""
    nll = TF.cross_entropy(logits, labels.long(), reduction="none")
    if weights is None:
        return nll.mean()
    return masked_mean(nll, weights, count)


def masked_mean(values, weights, count=None):
    """sum(values * weights) / max(count, 1), ``count`` defaulting to
    ``weights.sum()``: a rank's share of the global masked mean when
    ``count`` is the global one."""
    if count is None:
        count = weights.sum()
    return (values * weights).sum() / torch.clamp(count, min=1.0)


def weighted_bce_elements(logits, targets, pos_weight, stable=False):
    """Per-element weighted BCE terms (mfas_tpu/core/functional.py:373-391).

    ``stable=False`` is the reference formula
    ``pw*z*-log(sigmoid(x)) + (1-z)*-log(1-sigmoid(x))`` (reference
    aux_models.py:129-147), overflow NaNs included: at x >= ~17 in f32
    sigmoid rounds to 1, so a positive label gives 0*inf = NaN, which the
    MM-IMDB engine's NaN escape relies on. Below x ~ -88.72 exp(-x)
    overflows and a negative label NaNs too; between -88.72 and -87.34 XLA
    on the CPU flushes sigmoid's subnormal result to 0 (NaN there in JAX)
    while torch keeps it (finite here).

    ``stable=True`` is the algebraically equal logsumexp form
    ``pw*z*softplus(-x) + (1-z)*(x + softplus(-x))``, exact for all x
    (``logaddexp``, as jax.nn.softplus: torch's softplus switches to the
    identity above 20).
    """
    z = targets
    if stable:
        sp = torch.logaddexp(-logits, torch.zeros_like(logits))
        return pos_weight * z * sp + (1.0 - z) * (logits + sp)
    x = torch.sigmoid(logits)
    return pos_weight * z * -torch.log(x) + (1.0 - z) * -torch.log(1.0 - x)


def weighted_bce_with_logits(logits, targets, pos_weight, stable=False):
    """Mean-reduced weighted BCE (see weighted_bce_elements)."""
    return weighted_bce_elements(logits, targets, pos_weight,
                                 stable=stable).mean()


def mse(pred, target):
    return ((pred - target) ** 2).mean()
