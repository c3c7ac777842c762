"""Input kernels of the port (mfas_tpu_torch/ops/input_kernels.py) against
the JAX package's Pallas kernels, run in interpret mode on the CPU.

On a CPU tensor the port's wrappers run their plain PyTorch versions, which
round after the multiply and after the add. XLA may contract the JAX affine
into an FMA, which rounds once: each f32 output of JAX equals the port's or
the FMA of the same affine (a difference within 1 ulp of the product term;
near a zero result that is many ulps of the result). bf16 outputs, one
rounding of that f32, agree within 1 bf16 ulp.

tests/test_torch_cuda_kernels.py holds the CUDA kernels against the plain
versions on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mfas_tpu.ops import input_kernels as jk
from mfas_tpu_torch.ops import input_kernels as tk

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _ordered_bf16(bits):
    """bf16 bit patterns -> integers in the order of their values."""
    b = bits.astype(np.int32)
    mag = b & 0x7FFF
    return np.where(b & 0x8000, -mag, mag)


def _fma(x_u8):
    """f32(x)*scale + bias rounded once (f64 holds the product exactly)."""
    scale, bias = tk._affine_from_stats(MEAN, STD)
    return (x_u8.astype(np.float64) * scale.astype(np.float64)
            + bias.astype(np.float64)).astype(np.float32)


def assert_matches(jax_out, torch_out, x_u8):
    """x_u8: the uint8 values that were normalized, in output order."""
    if torch_out.dtype == torch.bfloat16:
        a = np.asarray(jax_out).view(np.uint16)
        b = torch_out.view(torch.int16).numpy().view(np.uint16)
        assert a.shape == b.shape
        assert np.abs(_ordered_bf16(a) - _ordered_bf16(b)).max() <= 1
    else:
        a, b = np.asarray(jax_out), torch_out.numpy()
        assert a.shape == b.shape
        assert np.all((a == b) | (a == _fma(x_u8)))


@pytest.fixture(autouse=True)
def _zero_counts():
    tk.reset_launch_counts()
    yield


@pytest.mark.parametrize("pick", [False, True], ids=["no_pick", "linspace"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_u8_normalize_matches_jax_pallas(dt, pick):
    jdt, tdt = DTYPES[dt]
    x = np.random.RandomState(0).randint(0, 256, (2, 6, 8, 8, 3), np.uint8)
    fi = jk.linspace_frame_indices(6, 3) if pick else None
    want = jk.u8_normalize(jnp.asarray(x), MEAN, STD, frame_indices=fi,
                           out_dtype=jdt, interpret=True)
    got = tk.u8_normalize(torch.from_numpy(x), MEAN, STD, frame_indices=fi,
                          out_dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    assert_matches(want, got, x if fi is None else x[:, fi])


def test_u8_normalize_plain_is_two_roundings():
    """The CPU path is bitwise (x*scale) rounded, + bias rounded: the
    arithmetic the CUDA kernel reproduces with __fmul_rn/__fadd_rn."""
    x = np.random.RandomState(1).randint(0, 256, (2, 3, 5, 7, 3), np.uint8)
    scale, bias = tk._affine_from_stats(MEAN, STD)
    want = x.astype(np.float32) * scale + bias     # numpy: no contraction
    got = tk.u8_normalize(torch.from_numpy(x), MEAN, STD)
    np.testing.assert_array_equal(got.numpy(), want)
    bf = tk.u8_normalize(torch.from_numpy(x), MEAN, STD,
                         out_dtype=torch.bfloat16)
    np.testing.assert_array_equal(
        bf.float().numpy(),
        torch.from_numpy(want).to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_u8_gather_normalize_matches_jax_pallas(dt):
    jdt, tdt = DTYPES[dt]
    store = np.random.RandomState(4).randint(0, 256, (3, 5, 32, 32, 3),
                                             np.uint8)
    sample_idx = np.array([2, 0], np.int32)
    frame_idx = np.array([[0, 2, 4], [1, 1, 3]], np.int32)
    want = jk.u8_gather_normalize(jnp.asarray(store), jnp.asarray(sample_idx),
                                  jnp.asarray(frame_idx), MEAN, STD,
                                  out_dtype=jdt, interpret=True)
    got = tk.u8_gather_normalize(torch.from_numpy(store),
                                 torch.from_numpy(sample_idx),
                                 torch.from_numpy(frame_idx), MEAN, STD,
                                 out_dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    assert_matches(want, got, store[sample_idx[:, None], frame_idx])


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    x = torch.from_numpy(
        np.random.RandomState(2).randint(0, 256, (1, 4, 4, 4, 3), np.uint8))
    tk.u8_normalize(x, MEAN, STD, frame_indices=[0, 3])
    tk.u8_gather_normalize(x, torch.tensor([0]), torch.tensor([[1, 2]]),
                           MEAN, STD)
    assert tk.launch_counts == {"u8_normalize": 0, "u8_gather_normalize": 0}


def test_three_channel_rule_raises_as_in_jax():
    x = np.zeros((1, 2, 4, 4, 1), np.uint8)
    store = np.zeros((2, 2, 32, 32, 1), np.uint8)
    idx, fidx = np.array([0]), np.array([[0, 1]])
    with pytest.raises(ValueError):
        jk.u8_normalize(jnp.asarray(x), MEAN, STD, interpret=True)
    with pytest.raises(ValueError):
        tk.u8_normalize(torch.from_numpy(x), MEAN, STD)
    with pytest.raises(ValueError):
        jk.u8_gather_normalize(jnp.asarray(store), jnp.asarray(idx),
                               jnp.asarray(fidx), MEAN, STD, interpret=True)
    with pytest.raises(ValueError):
        tk.u8_gather_normalize(torch.from_numpy(store), torch.from_numpy(idx),
                               torch.from_numpy(fidx), MEAN, STD)
    with pytest.raises(ValueError):  # four-channel statistics
        tk.u8_normalize(torch.zeros((1, 1, 2, 2, 3), dtype=torch.uint8),
                        np.zeros(4), np.ones(4))


def test_frame_pick_out_of_range_raises():
    x = torch.zeros((1, 4, 2, 2, 3), dtype=torch.uint8)
    with pytest.raises(IndexError):
        tk.u8_normalize(x, MEAN, STD, frame_indices=[0, 4])


def test_tensor_on_another_device_raises_not_falls_back():
    x = torch.empty((1, 2, 4, 4, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tk.u8_normalize(x, MEAN, STD)
    assert tk.launch_counts["u8_normalize"] == 0
