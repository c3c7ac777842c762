"""Readings that the limits of ``correct`` are set from, for one cell, on
the card at the cell's own size, many seeds in one process:

    python3 perfbench/calibrate.py --workload <cell> --seeds 11 12 13 \\
        [--controls 3] [--out chiprun_out/calibrate_<cell>.jsonl]

For every seed: the program's checked steps, as a run takes them, against
the reference (the lower reading); for the first ``--controls`` seeds
also the control (the reference in the program's place, computed a
precision below the configuration's: TF32 for float32, float8 for
bfloat16) and the planted faults (``half``, ``label``; see
perfbench/correctness.py), each against the sound reference, which
follows them as it follows the program. In a training cell, for those
seeds, the witness of round-off: two free runs of the reference, one from
weights moved by one part in 10**7 (``ulp``); in a bfloat16 cell, on every
seed, the reference's first step under bfloat16 autocast in the program's
place (``witness``). One JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from perfbench import correctness, harness  # noqa: E402


def first_step(readings):
    """A training run's readings of its first step alone."""
    return {"losses": readings["losses"][:1], "grad": readings["grad"],
            "heads": readings["heads"],
            "change": {k: v for k, v in readings["change"].items()
                       if k.endswith("@1")}}


def stand_in(cell, seed, device, ctx, **kw):
    """The sound reference's gaps to the reference put in the program's
    place (``kw``: its precision or fault)."""
    driver = cell.module("drivers", cell.traffic["driver"])
    other = driver.reference_readings(cell, seed, device, ctx, **kw)
    sound = driver.reference_readings(cell, seed, device, ctx, follow=other)
    return correctness.gaps(other, sound)


def calibrate_seed(cell, seed, device, controls):
    driver = cell.module("drivers", cell.traffic["driver"])
    out = {"seed": seed}
    t = time.perf_counter()
    run = driver.checked_steps(cell, seed, device)
    out["program_s"] = time.perf_counter() - t
    t = time.perf_counter()
    ref = driver.reference_readings(cell, seed, device, run.ctx,
                                    follow=run.readings)
    out["reference_s"] = time.perf_counter() - t
    out["program"], out["program_worst"] = correctness.gaps(run.readings,
                                                            ref)
    if "losses" in ref:
        out["losses"] = {"program": run.readings["losses"],
                         "reference": ref["losses"]}
    precision = cell.traffic["precision"]
    if precision == "bfloat16":
        out["witness"], out["witness_worst"] = correctness.gaps(
            driver.reference_readings(cell, seed, device, run.ctx,
                                      precision="bf16", steps=1),
            first_step(ref))
    if controls:
        for name, kw in (("control",
                          {"precision": correctness.CONTROL[precision]}),
                         ("half", {"fault": "half"}),
                         ("label", {"fault": "label"})):
            out[name], out[name + "_worst"] = stand_in(
                cell, seed, device, run.ctx, **kw)
        if run.ctx is not None:
            free = driver.reference_readings(cell, seed, device, run.ctx)
            ulp = driver.reference_readings(cell, seed, device, run.ctx,
                                            perturb=True)
            out["ulp"], out["ulp_worst"] = correctness.gaps(ulp, free)
            out["ulp_losses"] = {"free": free["losses"],
                                 "perturbed": ulp["losses"]}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", type=int, default=3,
                   help="seeds (the first ones) that also read the "
                        "control and the faults")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = harness.Cell(harness.benchmark(), args.workload)
    harness.require_devices(cell.chips)
    harness.set_cache_dirs()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    sink = open(args.out, "a") if args.out else None
    try:
        for i, seed in enumerate(args.seeds):
            line = json.dumps(calibrate_seed(cell, seed, device,
                                             i < args.controls))
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
