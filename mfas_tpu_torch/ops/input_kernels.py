"""uint8 clip -> normalized float input kernels (port of
mfas_tpu/ops/input_kernels.py).

``u8_normalize`` (K1) and ``u8_gather_normalize`` (K2) compute
``f32(x) * scale + bias`` per channel, with ``scale = 1/(255*std)`` and
``bias = -mean/std``; a bf16 output is rounded once from the f32 result.

On a CUDA tensor each wrapper launches the hand-written Hopper kernel in
``mfas_tpu_torch/csrc/input_kernels.cu`` (built with nvcc at first use into
``build/mfas_tpu_torch/``, loaded with ctypes) or raises; there is no
fallback. On a CPU tensor it runs the plain PyTorch version of the same
function (``u8_normalize_plain`` / ``u8_gather_normalize_plain``), which is
also what the kernel is held against on the card.

``launch_counts`` counts kernel launches per wrapper, so a run can show that
its main path went through the kernels; a CUDA graph that holds a launch
adds it at every replay (runtime/graphs.py::count_replays).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from mfas_tpu_torch.ops.cuda_build import CudaLibrary
from mfas_tpu_torch.runtime.graphs import count_replays

_OUT_DTYPES = (torch.float32, torch.bfloat16)

launch_counts = {"u8_normalize": 0, "u8_gather_normalize": 0}
count_replays(launch_counts)


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def _affine_from_stats(mean, std):
    """(x/255 - mean)/std == x * scale + bias (float32 on the host)."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    scale = 1.0 / (255.0 * std)
    bias = -mean / std
    return scale, bias


@functools.lru_cache(maxsize=None)
def _device_affine(mean, std, device):
    """scale and bias as (3,) float32 tensors on ``device``, copied there
    once per (stats, device): a host-to-card copy per call would
    synchronize the host with the card inside every plain call."""
    scale, bias = _affine_from_stats(mean, std)
    return (torch.as_tensor(scale, device=device),
            torch.as_tensor(bias, device=device))


def linspace_frame_indices(num_frames, out_frames):
    """The reference's NormalizeLen frame pick (datasets/ntu.py:99-102)."""
    return np.linspace(0, num_frames - 1, out_frames).astype(np.int32)


def _frame_index(frame_indices, x):
    """The (T',) frame pick as int64 on x's device; host indices are checked
    against T here (a bad device index traps inside the kernel)."""
    if not torch.is_tensor(frame_indices):
        fi = np.asarray(frame_indices, np.int64)
        if fi.size and (fi.min() < 0 or fi.max() >= x.shape[1]):
            raise IndexError(f"frame_indices out of range for T={x.shape[1]}:"
                             f" {fi.min()}..{fi.max()}")
        frame_indices = fi
    return torch.as_tensor(frame_indices, device=x.device).long()


def _check_three_channels(x, mean, std, name):
    if np.size(mean) != 3 or np.size(std) != 3 or x.shape[-1] != 3:
        raise ValueError(
            f"{name} is specialized to 3 channels (got stats of size "
            f"{np.size(mean)}/{np.size(std)}, input trailing dim "
            f"{x.shape[-1]})")


# --------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the kernels' reference on the card)
# --------------------------------------------------------------------------
def u8_normalize_plain(x, mean, std, frame_indices=None,
                       out_dtype=torch.float32):
    _check_three_channels(x, mean, std, "u8_normalize")
    if frame_indices is not None:
        x = x.index_select(1, _frame_index(frame_indices, x))
    scale, bias = _device_affine(tuple(np.ravel(mean).tolist()),
                                 tuple(np.ravel(std).tolist()), x.device)
    return (x.float() * scale + bias).to(out_dtype)


def u8_gather_normalize_plain(store, sample_idx, frame_idx, mean, std,
                              out_dtype=torch.float32):
    _check_three_channels(store, mean, std, "u8_gather_normalize")
    clips = store[sample_idx.long()[:, None], frame_idx.long()]
    return u8_normalize_plain(clips, mean, std, out_dtype=out_dtype)


# --------------------------------------------------------------------------
# the CUDA kernel: build, load, launch
# --------------------------------------------------------------------------
def _declare(lib):
    fn = lib.mfas_u8_normalize_frames
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3
                   + [ctypes.c_float] * 6 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int


_LIB = CudaLibrary("input_kernels", _declare)


def build_log():
    """nvcc's output (ptxas register and spill report) for the current
    source, or None when it has not been built."""
    return _LIB.build_log()


def load_library():
    """Build (when the source's hash has no library yet) and load the kernel
    library; returns its ctypes handle."""
    return _LIB.load()


def _launch(src, src_frame, n_frames, frame_shape, n_src_frames, mean, std,
            out_dtype):
    """out[m] = normalize(src frame src_frame[m]) on the current stream."""
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {_OUT_DTYPES}, got "
                         f"{out_dtype}")
    if src.dtype != torch.uint8 or not src.is_contiguous():
        raise ValueError("the kernel reads a contiguous uint8 tensor (got "
                         f"{src.dtype}, contiguous={src.is_contiguous()})")
    if src_frame is not None and (src_frame.device != src.device
                                  or src_frame.dtype != torch.int64
                                  or not src_frame.is_contiguous()):
        raise ValueError("frame indices must be contiguous int64 on the "
                         "input's device")
    frame_len = int(np.prod(frame_shape))
    out = torch.empty((n_frames,) + tuple(frame_shape), dtype=out_dtype,
                      device=src.device)
    scale, bias = _affine_from_stats(mean, std)
    fn = load_library().mfas_u8_normalize_frames
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(src.data_ptr(),
                 None if src_frame is None else src_frame.data_ptr(),
                 out.data_ptr(), n_frames, frame_len, n_src_frames,
                 *(float(v) for v in scale), *(float(v) for v in bias),
                 int(out_dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"u8_norm_frames launch failed: CUDA error {err}")
    return out


def _require_cuda(*tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {t.device} vs "
                             f"{dev}")
    if dev.type != "cuda":
        raise ValueError(f"the input kernels run on CPU (plain version) or "
                         f"CUDA tensors, got {dev}")


# --------------------------------------------------------------------------
# public wrappers
# --------------------------------------------------------------------------
def u8_normalize(x, mean, std, frame_indices=None, out_dtype=torch.float32):
    """(B, T, H, W, 3) uint8 -> (B, T', H, W, 3) out_dtype, normalized.

    frame_indices: optional (T',) frame pick along T, done inside the kernel
    so dropped frames are never read."""
    _check_three_channels(x, mean, std, "u8_normalize")
    if x.device.type == "cpu":
        return u8_normalize_plain(x, mean, std, frame_indices, out_dtype)
    _require_cuda(x)
    B, T = x.shape[:2]
    if frame_indices is None:
        src, n_out = None, B * T
    else:
        fi = _frame_index(frame_indices, x)
        src = (torch.arange(B, device=x.device)[:, None] * T
               + fi[None, :]).reshape(-1)
        n_out = src.numel()
    out = _launch(x, src, n_out, x.shape[2:], B * T, mean, std, out_dtype)
    launch_counts["u8_normalize"] += 1
    return out.reshape((B, n_out // B) + tuple(x.shape[2:]))


def u8_gather_normalize(store, sample_idx, frame_idx, mean, std,
                        out_dtype=torch.float32):
    """Resident-store batch read: (N, F, H, W, 3) uint8 store, (B,) sample
    indices, (B, T) per-sample frame picks -> (B, T, H, W, 3) out_dtype,
    equal to ``u8_normalize(store[sample_idx[:, None], frame_idx])`` with the
    gathered uint8 clip never written out."""
    _check_three_channels(store, mean, std, "u8_gather_normalize")
    if store.device.type == "cpu":
        return u8_gather_normalize_plain(store, sample_idx, frame_idx, mean,
                                         std, out_dtype)
    _require_cuda(store, sample_idx, frame_idx)
    N, F = store.shape[:2]
    B, T = frame_idx.shape
    src = (sample_idx.long()[:, None] * F + frame_idx.long()).reshape(-1)
    out = _launch(store, src, B * T, store.shape[2:], N * F, mean, std,
                  out_dtype)
    launch_counts["u8_gather_normalize"] += 1
    return out.reshape((B, T) + tuple(store.shape[2:]))
