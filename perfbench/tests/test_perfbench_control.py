"""On the card: the control comes out not correct. The reference put in the
program's place and computed a precision below the configuration's (TF32
for float32, float8 for bfloat16), at the cell's own size, is judged by the
cell's own limits, as a run judges the program, on each of three seeds.
Skips without a card."""

from __future__ import annotations

import pytest

from perfbench import calibrate, correctness, harness

SEEDS = (4_000_000_001, 4_000_000_002, 4_000_000_003)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["avmnist_found_train",
                                  "ntu_found_train_f32",
                                  "ntu_found_train_bf16",
                                  "ntu_search_streamed"])
def test_control_is_not_correct(name, cuda_device):
    cell = harness.Cell(harness.benchmark(), name)
    driver = cell.module("drivers", cell.traffic["driver"])
    control = correctness.CONTROL[cell.traffic["precision"]]
    for seed in SEEDS:
        values, worst = calibrate.stand_in(
            cell, seed, cuda_device, driver.context(cell, seed),
            precision=control)
        checks, correct = correctness.judge(cell, values, worst)
        assert not correct, (seed, checks)
