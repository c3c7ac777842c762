"""Shared pieces of the benchmark's tests: cells cut to a size the CPU
runs in seconds, and the fixture that decides whether there is a card."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfbench import harness  # noqa: E402

# numbers compared in the tiny CPU cells and their limits: at this size
# sound runs read loss_gap <= 7e-6, head_grad_gap <= 3e-5, change_gap <=
# 6e-3 (seeds 1-3); half a batch left out reads loss_gap >= 6e-2 and
# head_grad_gap >= 0.6, an altered label loss_gap >= 3e-2 and
# head_grad_gap >= 6e-2 (seed 1), a state left unchanged change_gap 1
TINY_LIMITS = {"loss_gap": 1e-3, "head_grad_gap": 1e-3,
               "change_gap": 0.05}
# the tiny search: sound runs read head_grad_gap <= 4e-7, grad_gap_med <=
# 2e-8, change_gap_med <= 1e-5; the half-batch and label faults
# head_grad_gap >= 0.27; a state left unchanged change_gap_med ~1
TINY_SEARCH_LIMITS = {"head_grad_gap": 1e-3, "grad_gap_med": 1e-3,
                      "change_gap_med": 0.05}


def tiny_cell(name):
    """Cell ``name`` of BENCHMARK.json at a size the CPU trains in
    seconds: the same code and traffic, fewer and narrower layers."""
    cell = harness.Cell(harness.benchmark(), name)
    cfg = cell.cfg
    if name == "ntu_search_streamed":
        cfg.update(num_outputs=5, vid_dim=32, resnet3d_layers=[1, 1, 1, 1],
                   resnet3d_base_width=8, max_skel_frames=80,
                   min_skel_frames=48,
                   input_shapes=[[8, 8, 32, 32, 3], [8, 3, 32, 25, 2]])
        cfg["search"] = dict(cfg["search"], batchsize=8, search_iterations=1,
                             max_fusions=2, num_samples=3)
        cfg["search"]["argv"] = cfg["search"]["argv"] + [
            "--num_outputs", "5", "--batchsize", "8",
            "--search_iterations", "1", "--max_fusions", "2",
            "--num_samples", "3", "--epochs_surrogate", "5",
            "--num_workers", "2", "--resnet3d_layers", "1", "1", "1", "1",
            "--resnet3d_base_width", "8"]
        cell.traffic = dict(cell.traffic,
                            store_clips={"trainexp": 16, "dev": 5})
        cell.limits = dict(TINY_SEARCH_LIMITS)
        return cell
    if cfg["name"] == "ntu_i3d50_hcn":
        cfg.update(num_outputs=5, batchsize=8, vid_dim=32,
                   resnet3d_layers=[1, 1, 1, 1], resnet3d_base_width=8,
                   max_skel_frames=80, min_skel_frames=48,
                   input_shapes=[[8, 8, 32, 32, 3], [8, 3, 32, 25, 2]])
        cfg["argv"] = cfg["argv"] + [
            "--num_outputs", "5", "--batchsize", "8",
            "--resnet3d_layers", "1", "1", "1", "1",
            "--resnet3d_base_width", "8"]
        cell.traffic = dict(cell.traffic,
                            store_clips={"train": 24, "dev": 8, "test": 8})
    else:
        cfg.update(channels=4, batchsize=16, samples=512, split=[448, 64],
                   input_shapes=[[16, 1, 28, 28], [16, 1, 112, 112]])
        cfg["argv"] = cfg["argv"] + ["--channels", "4", "--batchsize", "16"]
    cell.limits = dict(TINY_LIMITS)
    return cell


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test on a machine without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")
