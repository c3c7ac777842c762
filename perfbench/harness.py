"""The benchmark's harness: finds a cell's configuration, traffic mix,
driver, adapter, reference and per-layer metric readers by the names in
``BENCHMARK.json``, runs the cell, and prints the result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Every file of one configuration, mix or metric is its own:
``configs/<config>.json`` (which names its ``adapter`` and its
``reference``), ``traffic/<mix>.json`` (which names its ``driver``),
``adapters/<adapter>.py``, ``drivers/<driver>.py``,
``reference/<reference>.py``, ``limits/<cell>.json`` and
``metrics/<metric>.py``.

A run needs as many CUDA devices as its cell asks for; without them it
exits 2 and prints no result. It exits 3 without a result when ``jax``,
``jaxlib``, ``flax`` or the JAX package ``mfas_tpu`` (whole top-level
names) is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mfas_tpu")
# a traced run traces the window's last TRACE_SECONDS or more: the
# profiler's post-processing grows with the events it holds, and it runs
# after the window
TRACE_SECONDS = 12.0


class NoDevice(RuntimeError):
    """The run found fewer CUDA devices than its cell asks for."""


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark():
    return load_json(ROOT / "BENCHMARK.json")


def load_file_module(kind, name, root=BENCH_DIR):
    """``<root>/<kind>/<name>.py`` (by default under perfbench/) as a
    module; names may hold dots."""
    path = Path(root) / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    modname = f"perfbench_{kind}_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def reference_module(name):
    return importlib.import_module(f"perfbench.reference.{name}")


class Cell:
    """One cell of BENCHMARK.json with its configuration, mix, limits and
    the metrics it reports."""

    def __init__(self, bench, name, root=BENCH_DIR):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; known: "
                             f"{sorted(cells)}")
        self.bench, self.root = bench, Path(root)
        self.workload = cells[name]
        self.name = name
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.cfg = load_json(ROOT / self.config_entry["file"])
        self.traffic = load_json(self.root / "traffic"
                                 / f"{self.workload['traffic']}.json")
        limits = self.root / "limits" / f"{name}.json"
        self.limits = load_json(limits) if limits.is_file() else {}
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]

    @property
    def chips(self):
        return int(self.workload["chips"])

    def module(self, kind, name):
        return load_file_module(kind, name, self.root)


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def require_devices(count):
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < count:
        raise NoDevice(f"{torch.cuda.device_count()} CUDA devices, the "
                       f"cell asks for {count}")


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_info(device, peak_reserved):
    """The result line's ``device``: the card's name, one card, and the
    run's reserved peak."""
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak_reserved),
            "memory_total_bytes": int(
                torch.cuda.get_device_properties(device).total_memory)}


def peaks_info():
    from perfbench import peaks

    return {"flops": peaks.FLOPS, "hbm_bytes_per_s": peaks.HBM_BYTES_PER_S,
            "power_limit_w": peaks.power_limit_w()}


def set_cache_dirs():
    """Every build and kernel cache at a fixed path inside the checkout,
    so only a cell's first run there builds."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def result_line(cell, outcome, trace):
    """The result dict: the cell's end-to-end metrics (``trace`` 0) or
    per-layer metrics (``trace`` 1), with the checks last."""
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = cell.module("metrics", m["name"]).read(outcome)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            value = outcome.end_to_end.get(m["name"])
            if value is None or not math.isfinite(value):
                raise RuntimeError(f"{cell.name}: the run measured no "
                                   f"{m['name']}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics,
            "device": outcome.device}
    if trace and outcome.trace is not None:
        from perfbench.tracing import breakdown

        line["device"] = dict(outcome.device,
                              busy_s=outcome.trace["busy_s"],
                              window_s=outcome.trace["window_s"])
        line["breakdown"] = breakdown(outcome.trace)
    line["peaks"] = outcome.peaks
    line["checks"] = outcome.checks
    return line


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t_start=None):
    args = parse_args(argv)
    cell = Cell(benchmark(), args.workload)
    try:
        require_devices(cell.chips)
    except NoDevice as e:
        print(f"perfbench: no measurement: {e}", file=sys.stderr)
        return 2
    set_cache_dirs()
    driver = cell.module("drivers", cell.traffic["driver"])
    outcome = driver.run(cell, seed=args.seed, seconds=args.seconds,
                         trace=bool(args.trace), t_start=t_start)
    found = forbidden_modules()
    if found:
        print("perfbench: loaded after the window: " + ", ".join(found),
              file=sys.stderr)
        return 3
    line = result_line(cell, outcome, args.trace)
    for name, c in outcome.checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
