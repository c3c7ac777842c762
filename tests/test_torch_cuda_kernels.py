"""The port's CUDA input kernels on the card, held bitwise against their
plain PyTorch versions (mfas_tpu_torch/ops/input_kernels.py). Every test
here needs a CUDA device and skips without one. This file imports neither
JAX nor the JAX package, so it also runs where they are not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from mfas_tpu_torch.ops import input_kernels as tk

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    tk.reset_launch_counts()
    return torch.device("cuda")


# (B, T, H, W): the 16-byte vector path with frames of one warp's 512
# elements and of several blocks, a frame (16*24*3 = 1152 bytes) whose last
# warp is partly past its end, and a frame of 5*7*3 = 105 bytes that takes
# the scalar path
CUDA_SHAPES = {"vec16": (2, 6, 16, 16), "vec16_blocks": (2, 3, 64, 64),
               "vec16_ragged_warp": (2, 3, 16, 24), "scalar": (3, 4, 5, 7)}


@pytest.mark.parametrize("shape", list(CUDA_SHAPES.values()),
                         ids=list(CUDA_SHAPES))
@pytest.mark.parametrize("dt", list(DTYPES))
def test_u8_normalize_bitwise_equals_plain(cuda, dt, shape):
    tdt = DTYPES[dt]
    x = torch.from_numpy(np.random.RandomState(5).randint(
        0, 256, shape + (3,), np.uint8)).to(cuda)
    for fi in (None, tk.linspace_frame_indices(shape[1], 3)):
        got = tk.u8_normalize(x, MEAN, STD, frame_indices=fi, out_dtype=tdt)
        want = tk.u8_normalize_plain(x, MEAN, STD, fi, out_dtype=tdt)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert tk.launch_counts["u8_normalize"] == 2


@pytest.mark.parametrize("dt", list(DTYPES))
def test_u8_gather_normalize_bitwise_equals_plain(cuda, dt):
    tdt = DTYPES[dt]
    store = torch.from_numpy(np.random.RandomState(6).randint(
        0, 256, (4, 6, 16, 16, 3), np.uint8)).to(cuda)
    sidx = torch.tensor([3, 0, 3], device=cuda)
    fidx = torch.tensor([[0, 5], [2, 2], [1, 4]], device=cuda)
    got = tk.u8_gather_normalize(store, sidx, fidx, MEAN, STD, out_dtype=tdt)
    want = tk.u8_gather_normalize_plain(store, sidx, fidx, MEAN, STD, tdt)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert tk.launch_counts["u8_gather_normalize"] == 1


def test_unaligned_input_takes_the_scalar_path(cuda):
    """A view that starts 1 byte into its storage cannot use 16-byte loads."""
    flat = torch.randint(0, 256, (1 + 2 * 3 * 16 * 16 * 3,),
                         dtype=torch.uint8, device=cuda)
    x = flat[1:].view(2, 3, 16, 16, 3)
    got = tk.u8_normalize(x, MEAN, STD)
    torch.cuda.synchronize()
    assert torch.equal(got, tk.u8_normalize_plain(x, MEAN, STD))


def test_wrappers_raise_on_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((2, 4, 8, 8, 3), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):                       # not contiguous
        tk.u8_normalize(x.transpose(2, 3), MEAN, STD)
    with pytest.raises(ValueError):                       # not uint8
        tk.u8_normalize(x.float(), MEAN, STD)
    with pytest.raises(ValueError):                       # output dtype
        tk.u8_normalize(x, MEAN, STD, out_dtype=torch.float16)
    with pytest.raises(ValueError):                       # mixed devices
        tk.u8_gather_normalize(x, torch.tensor([0]), torch.tensor([[0]]),
                               MEAN, STD)
    assert tk.launch_counts == {"u8_normalize": 0, "u8_gather_normalize": 0}
