"""ctypes bindings for the host IO library (data/cpp/mfas_io.cpp), with numpy
fallbacks (port of mfas_tpu/data/native.py).

The library is built once, at first use, by ``g++ -O3 -march=native
-shared`` into the git-ignored ``build/mfas_tpu_torch/``, named by the
source's hash and the host CPU's tag (``-march=native`` code carried to
another CPU must be rebuilt, not trap), published atomically and loaded with
ctypes. Without a toolchain every entry point runs its numpy version and a
WARNING says so once; ``get_lib()`` returns None then, so a caller that
needs the library can check. ctypes releases the GIL for each call, so
loader threads overlap this work with the card's steps.

This is host C++, not a device kernel: nothing here touches the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "cpp" / "mfas_io.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mfas_tpu_torch"

_lock = threading.Lock()
_lib = None
_build_failed = False


def _host_tag():
    """Short tag of the build host's CPU (model name and flags)."""
    try:
        with open("/proc/cpuinfo") as f:
            txt = "".join(ln for ln in f if ln.startswith(("model name",
                                                         "flags")))
    except OSError:
        txt = os.uname().machine
    return hashlib.md5(txt.encode()).hexdigest()[:10]


def library_path():
    src = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    return _BUILD_DIR / f"libmfas_io-{src}-{_host_tag()}.so"


def _build(so):
    # compile to a private path, then rename: a concurrent process never
    # loads a half-written library
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.build-{os.getpid()}")
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
           "-std=c++17", str(_SRC), "-o", str(tmp)]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, so)


def get_lib():
    """The loaded library, or None when it could not be built or loaded
    (the numpy versions then run)."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            so = library_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            lib.mfas_parse_skeleton.restype = ctypes.c_int
            lib.mfas_parse_skeleton.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int]
            lib.mfas_gather_normalize_u8.restype = None
            lib.mfas_gather_normalize_u8.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int]
            lib.mfas_gather_f32.restype = None
            lib.mfas_gather_f32.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int]
            _lib = lib
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", b"") or b""
            print(f"WARNING: native mfas_io unavailable ({e} "
                  f"{detail.decode(errors='replace')[:500]}); falling back "
                  "to numpy")
            _build_failed = True
        return _lib


def _fptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _default_threads(num_threads):
    n = os.cpu_count() or 1
    return max(1, min(num_threads if num_threads else n, n))


# --------------------------------------------------------------------------
# numpy versions (the fallback, and the library's reference in the tests)
# --------------------------------------------------------------------------
def parse_skeleton_numpy(path, max_frames):
    from mfas_tpu_torch.data.ntu import get_3D_skeleton

    out = np.zeros((3, max_frames, 25, 2), np.float32)
    full = get_3D_skeleton(path)
    T = min(full.shape[1], max_frames)
    out[:, :T] = full[:, :T]
    return out, full.shape[1]


def gather_normalize_u8_numpy(base, indices, mean, std):
    sel = np.asarray(base)[np.asarray(indices, np.int64)].astype(
        np.float32) / 255.0
    return ((sel - np.asarray(mean, np.float32))
            / np.asarray(std, np.float32)).astype(np.float32)


def gather_f32_numpy(base, indices):
    return np.asarray(base, np.float32)[np.asarray(indices, np.int64)].copy()


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------
def parse_skeleton(path, max_frames):
    """-> ((3, max_frames, 25, 2) float32, number of frames in the file).
    Raises IOError on a file that cannot be read or is truncated."""
    lib = get_lib()
    if lib is None:
        return parse_skeleton_numpy(path, max_frames)
    out = np.zeros((3, max_frames, 25, 2), np.float32)
    n = lib.mfas_parse_skeleton(str(path).encode(), _fptr(out), max_frames)
    if n == -2:
        raise IOError(f"truncated or malformed skeleton file {path}")
    if n < 0:
        raise IOError(f"failed to parse skeleton file {path}")
    return out, n


def _check_indices(indices, n):
    if indices.size and (indices.min() < 0 or indices.max() >= n):
        raise IndexError(f"indices {indices.min()}..{indices.max()} out of "
                         f"range for {n} samples")


def gather_normalize_u8(base, indices, mean, std, num_threads=None):
    """base: (N, ...) uint8 with a trailing channel dim of len(mean);
    -> (len(indices), ...) float32 = (base[idx]/255 - mean)/std."""
    base = np.ascontiguousarray(base, np.uint8)
    indices = np.ascontiguousarray(indices, np.int64)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    if base.shape[-1] != len(mean) or len(std) != len(mean):
        raise ValueError(f"trailing dim {base.shape[-1]} against "
                         f"{len(mean)} / {len(std)} channel statistics")
    _check_indices(indices, len(base))
    lib = get_lib()
    if lib is None:
        return gather_normalize_u8_numpy(base, indices, mean, std)
    sample_shape = base.shape[1:]
    out = np.empty((len(indices),) + sample_shape, np.float32)
    lib.mfas_gather_normalize_u8(
        base.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), _iptr(indices),
        len(indices), int(np.prod(sample_shape)), _fptr(mean), _fptr(std),
        len(mean), _fptr(out), _default_threads(num_threads))
    return out


def gather_f32(base, indices, num_threads=None):
    """-> base[indices] as a new float32 array."""
    base = np.ascontiguousarray(base, np.float32)
    indices = np.ascontiguousarray(indices, np.int64)
    _check_indices(indices, len(base))
    lib = get_lib()
    if lib is None:
        return gather_f32_numpy(base, indices)
    sample_shape = base.shape[1:]
    out = np.empty((len(indices),) + sample_shape, np.float32)
    lib.mfas_gather_f32(_fptr(base), _iptr(indices), len(indices),
                        int(np.prod(sample_shape)), _fptr(out),
                        _default_threads(num_threads))
    return out
