"""Fused BatchNorm with an optional (+ residual, ReLU) epilogue: the forward
of ``core/layers.py::_BatchNorm``, which every BatchNorm of the port calls.

``batch_norm(x, ..., residual=None, relu=False)`` is
``relu(bn(x) + residual)`` with the epilogue's parts where given. x's
channel axis is 1; the numerics are the JAX package's
(mfas_tpu/core/layers.py:171-216), as ``_BatchNorm``'s docstring sets out.

On a CUDA tensor it runs the hand-written Hopper kernels of
``mfas_tpu_torch/csrc/batchnorm.cu`` (nvcc at first use into
``build/mfas_tpu_torch/``, loaded with ctypes), whose backward is kernels
too: in train mode inside a ``torch.autograd.Function``, in eval mode as
the custom op ``mfas::batch_norm_eval``, so that ``torch.export`` of a
model on the card records the op (and its ``.pt2`` runs the kernels when
served on the card: loading one needs this module imported, which
``runtime/export.py::load_exported`` does). The kernels take float32,
bfloat16 and float64 in any layout without gaps or overlaps (contiguous,
channels-last, frames before channels, ...), and raise on anything else:
there is no fallback. On a CPU tensor ``batch_norm`` runs the plain PyTorch
version, ``batch_norm_plain`` (the composition the module ran before the
kernels, so the CPU tests see it bit for bit; an export on the CPU records
that composition), as the op does on a tensor off the card.

``batch_norm_backward_plain`` is the closed-form backward that the kernels
implement, in plain PyTorch; the CPU tests hold it to autograd of
``batch_norm_plain``.

Under a data group (``group``) the per-channel ``[sum x, sum x^2, count]``
of the forward and ``[sum g, sum g*xhat]`` of the backward are SUMmed over
it between the kernels, on the current stream, so a CUDA graph holds them.

``launch_counts`` counts kernel launches per kernel; a CUDA graph that holds
a launch adds it at every replay (runtime/graphs.py::count_replays).
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable

from mfas_tpu_torch.ops.cuda_build import CudaLibrary
from mfas_tpu_torch.parallel.mesh import all_reduce_sum, reduce_sum
from mfas_tpu_torch.runtime.graphs import count_replays

launch_counts = {"stats": 0, "finalize": 0, "apply": 0, "grad_stats": 0,
                 "grad_finalize": 0, "grad_input": 0}
count_replays(launch_counts)


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


# --------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the kernels' reference)
# --------------------------------------------------------------------------
def _channel_shape(x):
    shape = [1] * x.dim()
    shape[1] = -1
    return shape


def batch_statistics_plain(x, group=None):
    """Train-mode statistics of x's channels over the batch (over every
    rank of ``group``): (mean, var, count, clamped), in float32 (float64
    for float64 x); var is the one-pass biased variance clamped at 0, and
    ``clamped`` says where the clamp took effect."""
    axes = [i for i in range(x.dim()) if i != 1]
    xs = x if x.dtype == torch.float64 else x.float()
    sums = torch.stack([
        xs.sum(dim=axes), xs.square().sum(dim=axes),
        xs.new_full((x.shape[1],), x.numel() // x.shape[1])])
    s, s2, n = all_reduce_sum(sums, group).unbind(0)
    mean = s / n
    raw = s2 / n - mean.square()
    return mean, torch.clamp(raw, min=0.0), n, raw.detach() < 0


def batch_norm_plain(x, weight, bias, running_mean, running_var,
                     num_batches_tracked, *, training, momentum, eps,
                     update_running_stats=True, group=None, residual=None,
                     relu=False):
    shape = _channel_shape(x)
    if training:
        mean, var, n, _ = batch_statistics_plain(x, group)
        if update_running_stats:
            with torch.no_grad():
                m = momentum
                running_mean.mul_(1 - m).add_(m * mean)
                running_var.mul_(1 - m).add_(
                    m * (var * (n / torch.clamp(n - 1, min=1))))
                num_batches_tracked.add_(1)
        mean, var = mean.to(x.dtype), var.to(x.dtype)
    else:
        mean = running_mean.to(x.dtype)
        var = running_var.to(x.dtype)
    # autocast runs rsqrt in f32 on the card: cast it back
    inv = torch.rsqrt(var.reshape(shape) + eps).to(x.dtype)
    out = (x - mean.reshape(shape)) * inv
    out = (out * weight.to(x.dtype).reshape(shape)
           + bias.to(x.dtype).reshape(shape))
    if residual is not None:
        out = out + residual
    return torch.relu(out) if relu else out


def batch_norm_backward_plain(dy, x, y, mean, inv, weight, count, clamped,
                              *, training, relu, group=None):
    """(dx, dweight, dbias, dresidual) of ``batch_norm`` at the output
    gradient dy, as the kernels compute them: g = dy masked by y > 0 under
    ReLU (dresidual), xhat = (x - mean) * inv, and in train mode
    dx = inv*w*(g - mean(g) - xhat*mean(g*xhat)), the means over the
    ``count`` elements of a channel on every rank of ``group``, without the
    variance term where ``clamped``; in eval mode dx = inv*w*g. mean, inv
    and weight are per channel, as the forward used them."""
    shape = _channel_shape(x)
    axes = [i for i in range(x.dim()) if i != 1]
    g = torch.where(y <= 0, torch.zeros_like(dy), dy) if relu else dy
    xh = (x - mean.reshape(shape)) * inv.reshape(shape)
    dbias, dweight = g.sum(dim=axes), (g * xh).sum(dim=axes)
    k = inv * weight
    dx = k.reshape(shape) * g
    if training:
        sg, sgx = reduce_sum(torch.stack([dbias, dweight]), group).unbind(0)
        b = -k * (sg / count)
        c = torch.where(clamped, torch.zeros_like(k), -k * (sgx / count))
        dx = dx + b.reshape(shape) + c.reshape(shape) * xh
    return dx, dweight, dbias, g


# --------------------------------------------------------------------------
# the CUDA kernels: layout, build, launch
# --------------------------------------------------------------------------
# dtype codes of the parameters and running statistics (csrc/batchnorm.cu)
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
# forward finalize modes, backward finalize modes (csrc/batchnorm.cu)
_SUM, _STATS, _EVAL, _UPDATE = 1, 2, 4, 8
_GRAD_SUM, _GRAD_COEF, _GRAD_TRAIN = 1, 2, 4
# blocks of 256 threads the statistics passes aim at: two waves of 8
# resident blocks on each of the H100's 132 SMs
_STATS_BLOCKS = 132 * 8 * 2
_MAX_ELEMENTS = 2 ** 31 - 1


def _declare(lib):
    p, i64, i, d = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, \
        ctypes.c_double
    sigs = {
        "mfas_bn_launch_stats": [p, p, i64, i64, i64, i, i, p],
        "mfas_bn_launch_grad_stats": [p, p, p, p, p, i64, i64, i64, i, i, p],
        "mfas_bn_launch_finalize": [p, i, p, p, i64, d, i, p, p, i, p, p, i,
                                    p, d, d, p],
        "mfas_bn_launch_apply": [p, p, p, p, i64, i64, i64, i, i, p],
        "mfas_bn_launch_grad_finalize": [p, i, p, p, p, p, p, i, i64, i, p],
        "mfas_bn_launch_grad_input": [p, p, p, p, p, p, p, i64, i64, i64, i,
                                      p],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int


# one library per activation dtype, built at its first use: a run builds
# only the kernels of the dtypes it normalizes
_LIBS = {dt: CudaLibrary("batchnorm", _declare, name, [f"-DMFAS_BN_T={t}"])
         for dt, name, t in ((torch.float32, "f32", "float"),
                             (torch.bfloat16, "bf16", "__nv_bfloat16"),
                             (torch.float64, "f64", "double"))}


def load_library(dtype):
    """Build (when the source's hash has no library yet) and load the
    kernels for activations of ``dtype``; returns the ctypes handle."""
    return _LIBS[dtype].load()


def _dense(x):
    """Whether x's elements fill its storage span without gaps or
    overlaps, in some order of its dims."""
    expected = 1
    for stride, size in sorted((x.stride(d), x.shape[d])
                               for d in range(x.dim()) if x.shape[d] > 1):
        if stride != expected:
            return False
        expected *= size
    return True


def same_strides(a, x):
    """Whether a lays its elements out as x does (dims of size 1 aside)."""
    return a.shape == x.shape and all(
        a.stride(d) == x.stride(d) for d in range(x.dim()) if x.shape[d] > 1)


def layout(x):
    """(outer, C, inner) of x, channel axis 1, in memory order: the dims
    laid out outside the channel's (larger strides) make outer, those
    inside it inner. Contiguous (N, C, ...) is (N, C, prod(...));
    channels-last (N*prod(...), C, 1); frames before channels, (N, T, C,
    H, W) in memory, (N*T, C, H*W). Any layout without gaps or overlaps
    has one; anything else (a strided slice, an expanded view) raises
    ValueError."""
    if x.dim() < 2 or not _dense(x):
        raise ValueError(f"the BatchNorm kernels take a tensor with a "
                         f"channel axis 1 and no gaps or overlaps, got "
                         f"strides {x.stride()} for shape {tuple(x.shape)}")
    C = x.shape[1]
    if C == 1:
        return 1, 1, x.numel()
    inner = math.prod(x.shape[d] for d in range(x.dim())
                      if d != 1 and x.shape[d] > 1
                      and x.stride(d) < x.stride(1))
    return x.numel() // (C * inner), C, inner


def stats_splits(outer, C, inner, width):
    """Blocks that split each channel (planar) or each tile of channels
    (packed, inner == 1) in the statistics passes: enough for
    ``_STATS_BLOCKS`` in all, while every thread keeps four or more units
    of ``width`` elements to read (planar), or sixteen or more rows
    (packed, whose blocks end in a reduction over their rows in shared
    memory). A packed tile is TX = min(C / width, 32) units of channels
    side by side, with 256 / TX rows read at once
    (csrc/batchnorm.cu::packed_stats)."""
    if inner == 1:
        cv = C // width
        tx = min(cv, 32)
        tiles = -(-cv // tx)
        return max(1, min(-(-_STATS_BLOCKS // tiles),
                          outer // (256 // tx * 16)))
    units = outer * inner // width
    return max(1, min(-(-_STATS_BLOCKS // C), units // (256 * 4)))


def _vector_width(x):
    return 16 // x.element_size()


def _vectorized(C, inner, width, *tensors):
    """16-byte units of ``width`` elements: planar rows, or packed rows of
    channels, that hold a whole number of them, and every pointer 16-byte
    aligned."""
    return (inner if inner > 1 else C) % width == 0 and all(
        t is None or t.data_ptr() % 16 == 0 for t in tensors)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(err, what):
    if err != 0:
        raise RuntimeError(f"mfas_bn_{what} launch failed: CUDA error {err}")
    launch_counts[what] += 1


def _require(x, weight, bias, running_mean, running_var,
             num_batches_tracked, residual):
    if x.dtype not in _CODES:
        raise ValueError(f"the BatchNorm kernels take float32, bfloat16 or "
                         f"float64, got {x.dtype}")
    outer, C, inner = layout(x)
    for name, t in (("weight", weight), ("bias", bias),
                    ("running_mean", running_mean),
                    ("running_var", running_var)):
        if (t.device != x.device or t.dtype not in _CODES
                or tuple(t.shape) != (C,) or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({C},) float "
                             f"tensor on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if num_batches_tracked is not None and (
            num_batches_tracked.device != x.device
            or num_batches_tracked.dtype != torch.int64):
        raise ValueError("num_batches_tracked must be an int64 tensor on "
                         f"{x.device}")
    if residual is not None and (
            residual.shape != x.shape or residual.dtype != x.dtype
            or residual.device != x.device):
        raise ValueError("the residual must match x's shape, dtype and "
                         "device")
    if C > 65535 or x.numel() > _MAX_ELEMENTS:
        raise ValueError(f"BatchNorm of shape {tuple(x.shape)} is past the "
                         f"kernels' limits (C <= 65535, < 2**31 elements)")
    return outer, C, inner


def _launch_forward(x, weight, bias, residual, running_mean, running_var,
                    num_batches_tracked, training, momentum, eps,
                    update_running_stats, group, relu):
    """The forward kernels on x's card -> (y, coef): coef (6, C) is the
    per-channel record the backward reads (csrc/batchnorm.cu)."""
    outer, C, inner = _require(x, weight, bias, running_mean, running_var,
                               num_batches_tracked, residual)
    lib = load_library(x.dtype)
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    width = _vector_width(x)
    if residual is not None and not same_strides(residual, x):
        # a residual laid out otherwise (a block's input beside its last
        # convolution's output under a layout option) is copied into x's
        # layout; its gradient comes back in that layout
        residual = torch.empty_like(x).copy_(residual)
    y = torch.empty_like(x)
    vec = int(_vectorized(C, inner, width, x, residual, y))
    coef = torch.empty((6, C), dtype=acc, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def finalize(part, J, sums, mode):
        _check(lib.mfas_bn_launch_finalize(
            _ptr(part), J, _ptr(sums), coef.data_ptr(), C,
            float(outer * inner), mode, weight.data_ptr(), bias.data_ptr(),
            _CODES[weight.dtype], running_mean.data_ptr(),
            running_var.data_ptr(), _CODES[running_mean.dtype],
            _ptr(num_batches_tracked), float(eps), float(momentum),
            stream), "finalize")

    if training:
        J = stats_splits(outer, C, inner, width if vec else 1)
        part = torch.empty((2, C, J), dtype=acc, device=x.device)
        sums = torch.empty((3, C), dtype=acc, device=x.device)
        _check(lib.mfas_bn_launch_stats(
            x.data_ptr(), part.data_ptr(), outer, C, inner, J, vec, stream),
            "stats")
        mode = _STATS | (_UPDATE if update_running_stats else 0)
        if group is None:
            finalize(part, J, sums, _SUM | mode)
        else:
            finalize(part, J, sums, _SUM)
            dist.all_reduce(sums, group=group)
            finalize(part, J, sums, mode)
    else:
        finalize(None, 0, None, _EVAL)
    _check(lib.mfas_bn_launch_apply(
        x.data_ptr(), _ptr(residual), y.data_ptr(), coef.data_ptr(),
        x.numel(), C, inner, vec, int(relu), stream), "apply")
    return y, coef


def _launch_backward(dy, x, y, coef, param_dtype, training, group, need_x,
                     need_w, need_b, need_r):
    """The backward kernels -> (dx, dweight, dbias, dresidual), None where
    not needed; y is the forward's output under ReLU, else None."""
    outer, C, inner = layout(x)
    if not same_strides(dy, x):
        dy = torch.empty_like(x).copy_(dy)
    lib = load_library(x.dtype)
    acc = coef.dtype
    width = _vector_width(x)
    dx = torch.empty_like(x) if need_x else None
    dres = torch.empty_like(x) if need_r else None
    vec = int(_vectorized(C, inner, width, dy, x, y, dx, dres))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    dweight = dbias = None
    gcoef = torch.empty((3, C), dtype=acc, device=x.device)
    if need_x or need_w or need_b:
        J = stats_splits(outer, C, inner, width if vec else 1)
        part = torch.empty((2, C, J), dtype=acc, device=x.device)
        gsums = torch.empty((2, C), dtype=acc, device=x.device)
        _check(lib.mfas_bn_launch_grad_stats(
            dy.data_ptr(), x.data_ptr(), _ptr(y), coef.data_ptr(),
            part.data_ptr(), outer, C, inner, J, vec, stream), "grad_stats")
        if need_w:
            dweight = torch.empty(C, dtype=param_dtype, device=x.device)
        if need_b:
            dbias = torch.empty(C, dtype=param_dtype, device=x.device)

        def finalize(mode):
            _check(lib.mfas_bn_launch_grad_finalize(
                part.data_ptr(), J, gsums.data_ptr(), coef.data_ptr(),
                gcoef.data_ptr(), _ptr(dweight), _ptr(dbias),
                _CODES[param_dtype], C, mode, stream), "grad_finalize")

        coef_mode = (_GRAD_COEF | (_GRAD_TRAIN if training else 0)
                     if need_x else 0)
        if group is not None and training and need_x:
            finalize(_GRAD_SUM)
            dist.all_reduce(gsums, group=group)
            finalize(coef_mode)
        else:
            finalize(_GRAD_SUM | coef_mode)
    if need_x or need_r:
        _check(lib.mfas_bn_launch_grad_input(
            dy.data_ptr(), x.data_ptr(), _ptr(y), _ptr(dx), _ptr(dres),
            coef.data_ptr(), gcoef.data_ptr(), x.numel(), C, inner, vec,
            stream), "grad_input")
    return dx, dweight, dbias, dres


class _FusedBatchNorm(torch.autograd.Function):
    """Train mode on the card: the forward and backward kernels."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, running_mean, running_var,
                num_batches_tracked, momentum, eps, update_running_stats,
                group, relu):
        y, coef = _launch_forward(
            x, weight, bias, residual, running_mean, running_var,
            num_batches_tracked, True, momentum, eps, update_running_stats,
            group, relu)
        ctx.save_for_backward(x, y if relu else None, coef)
        ctx.param_dtype, ctx.group = weight.dtype, group
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, y, coef = ctx.saved_tensors
        grads = _launch_backward(dy, x, y, coef, ctx.param_dtype, True,
                                 ctx.group, *ctx.needs_input_grad[:4])
        return grads + (None,) * 8


# --------------------------------------------------------------------------
# eval mode: the custom op mfas::batch_norm_eval, which torch.export records
# --------------------------------------------------------------------------
@torch.library.custom_op(
    "mfas::batch_norm_eval", mutates_args=(),
    schema="(Tensor x, Tensor weight, Tensor bias, Tensor running_mean, "
           "Tensor running_var, Tensor? residual, float eps, bool relu) "
           "-> (Tensor, Tensor)")
def batch_norm_eval(x, weight, bias, running_mean, running_var, residual,
                    eps, relu):
    """Eval-mode ``batch_norm`` on the running statistics -> (y, coef): the
    kernels on a card tensor, the plain version on any other. coef (6, C)
    is the kernels' per-channel record (mean, inverse deviation, weight and
    bias as the forward rounded them; then two rows only train mode
    fills), which the backward reads."""
    if x.device.type == "cuda":
        return _launch_forward(x, weight, bias, residual, running_mean,
                               running_var, None, False, 0.0, eps, False,
                               None, relu)
    y = batch_norm_plain(x, weight, bias, running_mean, running_var, None,
                         training=False, momentum=0.0, eps=eps,
                         residual=residual, relu=relu)
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    rows = [running_mean.to(x.dtype),
            torch.rsqrt(running_var.to(x.dtype) + eps).to(x.dtype),
            weight.to(x.dtype), bias.to(x.dtype)]
    coef = torch.stack([r.to(acc) for r in rows]
                       + [torch.zeros_like(rows[0], dtype=acc)] * 2)
    return y, coef


@batch_norm_eval.register_fake
def _(x, weight, bias, running_mean, running_var, residual, eps, relu):
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    return torch.empty_like(x), x.new_empty((6, x.shape[1]), dtype=acc)


def _eval_setup(ctx, inputs, output):
    x, weight, _, _, _, residual, _, relu = inputs
    y, coef = output
    ctx.save_for_backward(x, y if relu else None, coef)
    ctx.param_dtype, ctx.relu = weight.dtype, relu
    ctx.with_residual = residual is not None


@once_differentiable
def _eval_backward(ctx, dy, _):
    x, y, coef = ctx.saved_tensors
    need_x, need_w, need_b, _, _, need_r = ctx.needs_input_grad[:6]
    if x.device.type == "cuda":
        dx, dw, db, dres = _launch_backward(dy, x, y, coef, ctx.param_dtype,
                                            False, None, need_x, need_w,
                                            need_b, need_r)
    else:
        dx, dw, db, dres = batch_norm_backward_plain(
            dy, x, y, coef[0], coef[1], coef[2], None, None, training=False,
            relu=ctx.relu)
        dx = dx.to(x.dtype)
        dw, db = dw.to(ctx.param_dtype), db.to(ctx.param_dtype)
        dres = dres.to(x.dtype) if ctx.with_residual else None
    return dx, dw, db, None, None, dres, None, None


batch_norm_eval.register_autograd(_eval_backward, setup_context=_eval_setup)


def batch_norm(x, weight, bias, running_mean, running_var,
               num_batches_tracked, *, training, momentum, eps,
               update_running_stats=True, group=None, residual=None,
               relu=False):
    """relu?(BatchNorm(x) + residual?); train mode updates the running
    statistics and ``num_batches_tracked`` in place unless
    ``update_running_stats`` is False."""
    kw = dict(training=training, momentum=momentum, eps=eps,
              update_running_stats=update_running_stats, group=group,
              residual=residual, relu=relu)
    if x.device.type != "cuda":
        return batch_norm_plain(x, weight, bias, running_mean, running_var,
                                num_batches_tracked, **kw)
    if not training:
        return batch_norm_eval(x, weight, bias, running_mean, running_var,
                               residual, float(eps), bool(relu))[0]
    return _FusedBatchNorm.apply(
        x, weight, bias, residual, running_mean, running_var,
        num_batches_tracked, momentum, eps, bool(update_running_stats),
        group, bool(relu))
