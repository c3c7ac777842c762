"""The benchmark's own counts: FLOPs against hand-worked shapes and against
FlopCounterMode over the frozen references, input-kernel bytes, and the
candidates of a default search."""

from __future__ import annotations

import math

import pytest
import torch
import torch.nn.functional as TF
from torch.utils.flop_counter import FlopCounterMode

from perfbench import counts, peaks
from perfbench.harness import BENCH_DIR, load_json
from perfbench.reference import avmnist_lenet, ntu_i3d50_hcn
from perfbench.tests.conftest import tiny_cell


def test_conv_and_linear_flops_by_hand():
    # a 3x3 conv, 2 -> 4 channels, on 1 x 5x5 with padding 1: 25 outputs
    # per channel, 2*9 multiply-adds each
    assert counts.conv_flops(1, 4, 2, (3, 3), (5, 5)) == 2 * 4 * 25 * 18
    assert counts.linear_flops(8, 512, 60) == 2 * 8 * 512 * 60


@pytest.mark.parametrize("shape, kernel, stride, pad", [
    ((2, 3, 4, 10, 10), (5, 3, 3, 3, 3), (1, 2, 2), 1),
    ((3, 6, 12, 12), (8, 6, 5, 5), 1, 2),
])
def test_closed_form_matches_flop_counter(shape, kernel, stride, pad):
    with torch.device("meta"):
        x, w = torch.empty(shape), torch.empty(kernel)
    fn = TF.conv3d if len(shape) == 5 else TF.conv2d
    with FlopCounterMode(display=False) as fc:
        y = fn(x, w, stride=stride, padding=pad)
    assert fc.get_total_flops() == counts.conv_flops(
        shape[0], kernel[0], kernel[1], kernel[2:], y.shape[2:])


def _avmnist_by_hand(cfg):
    """The AV-MNIST found net's forward, layer by layer."""
    B, ch, n = cfg["batchsize"], cfg["channels"], cfg["num_outputs"]
    total, side, prev = 0, 28, 1
    for i, w in enumerate([ch, 2 * ch, 4 * ch]):
        k = 5 if i == 0 else 3
        total += counts.conv_flops(B, w, prev, (k, k), (side, side))
        prev, side = w, side // 2
    total += counts.linear_flops(B, 4 * ch, n)
    side, prev = 112, 1
    for i, w in enumerate([ch, 2 * ch, 4 * ch, 8 * ch, 16 * ch]):
        k = 5 if i == 0 else 3
        total += counts.conv_flops(B, w, prev, (k, k), (side, side))
        prev, side = w, side // 2
    total += counts.linear_flops(B, 16 * ch, n)
    h = cfg["inner_representation_size"]
    total += counts.linear_flops(B, 16 * ch + 4 * ch, h)
    total += counts.linear_flops(B, 16 * ch + 4 * ch + h, h)
    return total + counts.linear_flops(B, h, n)


@pytest.mark.parametrize("tiny", [True, False])
def test_avmnist_forward_flops(tiny):
    cfg = (tiny_cell("avmnist_found_train").cfg if tiny else
           load_json(BENCH_DIR / "configs" / "avmnist_lenet.json"))
    got = counts.forward_flops(avmnist_lenet, cfg, cfg["input_shapes"])
    assert got == _avmnist_by_hand(cfg)


def test_ntu_forward_flops_hold_the_resnet_and_hcn():
    """At full width the count holds the inflated ResNet-50's stem,
    worked by hand, and lands at ~163 GFLOP a clip (3.26 TFLOP a B=20
    forward, so ~9.8 TFLOP a train step)."""
    cfg = load_json(BENCH_DIR / "configs" / "ntu_i3d50_hcn.json")
    got = counts.forward_flops(ntu_i3d50_hcn, cfg, cfg["input_shapes"])
    stem = counts.conv_flops(20 * 8, 64, 3, (7, 7), (128, 128))
    assert got > stem
    per_clip = got / 20
    assert 1.6e11 < per_clip < 1.7e11, per_clip


def test_input_kernel_bytes():
    # (20, 8, 256, 256, 3): 31,457,280 uint8 elements
    n = 20 * 8 * 256 * 256 * 3
    assert counts.k1_bytes(20, 8, 256, 256, 4) == 5 * n
    assert counts.k1_bytes(20, 8, 256, 256, 2) == 3 * n
    assert counts.k2_bytes(20, 8, 256, 256, 4) == 5 * n + 8 * 160
    # the least times at 3.35 TB/s: 47.0 and 28.2 microseconds
    assert math.isclose(5 * n / peaks.HBM_BYTES_PER_S * 1e6, 46.96,
                        abs_tol=0.01)
    assert math.isclose(3 * n / peaks.HBM_BYTES_PER_S * 1e6, 28.17,
                        abs_tol=0.01)


def test_default_search_trains_197_candidates():
    assert counts.n_candidates(3, 4, 15) == 197
