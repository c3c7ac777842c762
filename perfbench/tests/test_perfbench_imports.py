"""Import isolation, by whole top-level module names (``mfas_tpu_torch``
begins with ``mfas_tpu``): nothing under perfbench/ imports JAX or the
JAX package, the references import nothing of the program, and the
benchmark uses neither the program's own bench nor chip_smoke. Checked
statically over the sources and, after a tiny CPU run of every cell, in
``sys.modules`` of that process."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from perfbench import harness

JAX = {"jax", "jaxlib", "flax", "mfas_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            for a in node.names:
                yield f"{node.module}.{a.name}"


def _sources(sub=""):
    return sorted((harness.BENCH_DIR / sub).rglob("*.py"))


def test_no_jax_anywhere():
    for path in _sources():
        for name in _imports(path):
            assert name.split(".")[0] not in JAX, (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        for name in _imports(path):
            assert name.split(".")[0] != "mfas_tpu_torch", (path, name)


def test_not_the_programs_bench_or_chip_smoke():
    for path in _sources():
        for name in _imports(path):
            assert not name.startswith("mfas_tpu_torch.bench"), (path, name)
            assert name.split(".")[0] != "chip_smoke", (path, name)


RUN = """
import json, sys, time
sys.path.insert(0, {root!r})
from perfbench import harness
from perfbench.tests.conftest import tiny_cell
cell = tiny_cell({cell!r})
drv = cell.module("drivers", cell.traffic["driver"])
drv.run(cell, seed=3, seconds=0.2, trace=False, t_start=time.perf_counter(),
        device="cpu")
print(json.dumps(sorted(sys.modules)))
"""


@pytest.mark.parametrize("cell", ["avmnist_found_train",
                                  "ntu_found_train_f32",
                                  "ntu_search_streamed"])
def test_no_jax_in_a_run(cell):
    proc = subprocess.run(
        [sys.executable, "-c", RUN.format(root=str(harness.ROOT), cell=cell)],
        capture_output=True, text=True, timeout=600, check=True)
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "mfas_tpu_torch" in loaded
    assert not [m for m in loaded if m.split(".")[0] in JAX]
