"""The CIFAR search, JAX CLI against the port's, on the CPU.

A synthetic store (``make_synthetic_cifar``, 16 images per file: 72 train
and 8 dev images) at --planes 4 --net_str 1 2 1 --batchsize 8 --epochs 1
with --drop_path 0 --drop_prob 0 (the two packages' dropout streams
differ), ``get_possible_layer_configurations(0)`` cut to the same rows in
both packages, each port candidate with the JAX candidate's initial weights
(the same conf at the same seed) and the port's surrogate with the JAX
surrogate's:

* the whole EPNAS search over 6 one-block rows (--max_fusions 2
  --search_iterations 1 --num_samples 2: 6 + 2 whole-net candidates): the
  same first-step accuracies, sampled confs, second-step accuracies and
  printed top-5; resumed after its first step from the port's own state in
  a process seeded otherwise, it ends as the uninterrupted run;
* --weightsharing over 3 rows: the JAX package's state after the first
  step (its store of nested arrays, the last candidate's keys only)
  resumes in the port, which ends as the uninterrupted JAX run, with the
  same store keys.

Accuracies are compared exactly: each is a count of argmax hits over 8
images.
"""

import contextlib
import copy
import io
import pickle
import sys

import numpy as np
import pytest
import torch

import jax

import main_searchable_cifar as jsearch
from mfas_tpu.core import flatten_tree
from mfas_tpu.data.cifar import make_synthetic_cifar
from mfas_tpu.fusion import cifar as jfc
from mfas_tpu.search import searcher as jsearcher
from mfas_tpu.search.surrogate import SimpleRecurrentSurrogate as JSurrogate
from mfas_tpu_torch import main_searchable_cifar as tsearch
from mfas_tpu_torch.fusion import cifar as tfc
from mfas_tpu_torch.runtime.checkpoint import state_dict_from_numpy
from mfas_tpu_torch.search import searcher as tsearcher
from mfas_tpu_torch.search import searchers as tsearchers
from mfas_tpu_torch.search import trainers as ttrainers
from tests.test_torch_cifar_cli import SMALL
from tests.test_torch_search_cli import one_torch_thread  # noqa: F401
from tests.test_torch_search_ntu import _pairs, _steps_saved

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SEARCH = [*SMALL, "--epochs", "1", "--epochs_surrogate", "5",
          "--num_samples", "2", "--search_iterations", "1",
          "--max_fusions", "2", "--no-verbose", "--seed", "0"]
# every 14th one-block row: each of the 5 ops on both sides, and every
# connection pair
SUBSET = jfc.get_possible_layer_configurations(0)[::14]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: under a parallel test runner every split op
    waits on threads the other workers' processes hold."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cifar_search")
    make_synthetic_cifar(str(root), n_per_batch=16, seed=1)
    return root


def _subset(monkeypatch, module, rows=SUBSET):
    orig = module.get_possible_layer_configurations
    monkeypatch.setattr(module, "get_possible_layer_configurations",
                        lambda i: [list(r) for r in rows] if i == 0
                        else orig(i))


@pytest.fixture
def jax_init(monkeypatch):
    """Each port candidate gets the JAX candidate's initial weights (the
    same conf at the same seed), and the port's surrogate the JAX
    surrogate's."""
    build = ttrainers.CifarSearchTrainer.build_model

    def jax_weights(self, searchable_type, args, configuration):
        model = build(self, searchable_type, args, configuration)
        jnet = jfc.Searchable_MicroCNN(copy.copy(args), configuration)
        flat = {k: np.asarray(v)
                for k, v in flatten_tree(jnet.init(self._seed)).items()}
        model.load_state_dict(state_dict_from_numpy(flat), strict=True)
        return model

    monkeypatch.setattr(ttrainers.CifarSearchTrainer, "build_model",
                        jax_weights)
    params = jax.tree_util.tree_map(
        np.asarray, JSurrogate(100, 4, 100, max_seq_len=2).params)
    orig = tsearchers.SimpleRecurrentSurrogate

    def surrogate(*a, **k):
        s = orig(*a, **k)
        s.load_numpy(params)
        return s

    monkeypatch.setattr(tsearchers, "SimpleRecurrentSurrogate", surrogate)
    _subset(monkeypatch, tfc)


def _top5(out):
    lines = out.split("Now listing best architectures\n", 1)[1].splitlines()
    return lines[:5]


def _state_pairs(st):
    return {(np.asarray(c).tobytes(), a)
            for _, entries in st["surrogate_data"] for c, a in entries}


def _jax_run(argv, rows, state):
    """The JAX CLI over ``rows`` at step 0; its printed top-5 and its
    per-step states."""
    with pytest.MonkeyPatch.context() as mp:
        _subset(mp, jfc, rows)
        saved = _steps_saved(mp, jsearcher)
        mp.setattr(sys, "argv", ["main_searchable_cifar.py", *argv,
                                 "--search_state", state])
        out = _run_quietly(jsearch.main)
    return _top5(out), [tsearcher.ModelSearcher.load_state(p) for p in saved]


def _run_quietly(fn):
    """fn's standard output."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue()


def _resume(argv, st, path):
    """The port resumed from state ``st`` in a process seeded otherwise."""
    with open(path, "wb") as f:
        pickle.dump(st, f)
    other = [a for a in argv if a != "--no-verbose"]
    other[other.index("--seed") + 1] = "7"
    return tsearch.main([*other, "--search_state", path, "--resume_search"],
                        device="cpu")


def test_search_matches_jax_and_resumes(root, jax_init, monkeypatch, capsys,
                                        tmp_path):
    argv = ["--data_dir", str(root), *SEARCH]
    jtop, jsteps = _jax_run(argv, SUBSET, str(tmp_path / "jax.pkl"))
    saved = _steps_saved(monkeypatch, tsearcher)
    run = tsearch.main([*argv, "--search_state", str(tmp_path / "st.pkl")],
                       device="cpu")
    top = _top5(capsys.readouterr().out)
    steps = [tsearcher.ModelSearcher.load_state(p) for p in saved]
    assert len(steps) == len(jsteps) == 2
    first = _state_pairs(steps[0])
    assert len(first) == 6 and first == _state_pairs(jsteps[0])
    assert len({a for _, a in first}) > 1
    assert [c.tobytes() for c in steps[0]["sampled_k_confs"]] == \
        [c.tobytes() for c in jsteps[0]["sampled_k_confs"]]
    assert _state_pairs(steps[1]) == _state_pairs(jsteps[1]) == \
        _pairs(run.data)
    assert top == jtop and len(top) == 5
    assert run.candidates == 6 + 2
    assert set(run.split) == {"sampler", "whole-net candidates", "surrogate"}
    assert steps[1]["trainer_seed"] == jsteps[1]["trainer_seed"] == 8
    assert steps[1]["shared_weights"] == {}

    resumed = _resume(argv, steps[0], str(tmp_path / "resume.pkl"))
    assert "Resuming search after iteration 0 step 0" in \
        capsys.readouterr().out
    assert resumed.candidates == 2
    assert _pairs(resumed.data) == _pairs(run.data)


def test_jax_weightsharing_state_resumes(root, jax_init, monkeypatch,
                                         capsys, tmp_path):
    rows = SUBSET[:3]
    _subset(monkeypatch, tfc, rows)
    argv = ["--data_dir", str(root), *SEARCH, "--weightsharing"]
    _, jsteps = _jax_run(argv, rows, str(tmp_path / "jax.pkl"))
    assert len(jsteps) == 2
    store = jsteps[0]["shared_weights"]
    # the last first-step candidate's keys, as nested arrays
    last = tfc.Searchable_MicroCNN(
        tsearch.parse_args(argv), rows[-1], device="cpu",
        generator=torch.Generator())
    assert set(store) == set(ttrainers.get_cifar_states(last))
    assert store["input_conv"]["0"]["weight"].shape == (4, 3, 3, 3)

    loaded = []
    orig = ttrainers.set_cifar_states

    def spy(model, sd):
        loaded.append(set(sd))
        return orig(model, sd)

    monkeypatch.setattr(ttrainers, "set_cifar_states", spy)
    saved = _steps_saved(monkeypatch, tsearcher)
    resumed = _resume(argv, jsteps[0], str(tmp_path / "resume.pkl"))
    assert "Resuming search after iteration 0 step 0" in \
        capsys.readouterr().out
    assert resumed.candidates == 2 and loaded[0] == set(store)
    assert _pairs(resumed.data) == _state_pairs(jsteps[1])
    mine = tsearcher.ModelSearcher.load_state(saved[-1])
    assert set(mine["shared_weights"]) == set(jsteps[1]["shared_weights"])
