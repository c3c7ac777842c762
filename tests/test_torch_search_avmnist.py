"""The AV-MNIST search, JAX package against the port, on the CPU.

A synthetic store (``make_synthetic_avmnist``, 48 train samples: 42 train
and 6 dev rows; --channels 4, --batchsize 8, --drpt 0, --epochs 1, 3 samples
per step), the same backbone weights for both packages (the JAX extractor's
initial weights written as --rgb_cp and --audio_cp files) and the JAX
surrogate's initial weights carried into the port:

* the random-search sampler is bit-exact on numpy's and Python's RNGs,
  with and without the reference's stale-index bug;
* a whole EPNAS search (--search_iterations 1 --max_fusions 2) through the
  port's ``main(argv, device="cpu")`` against the JAX CLI: the first step's
  30 accuracies equal, the confs sampled for the second step identical, the
  same (conf, accuracy) pairs and the same printed top-5;
* --randsearch (2 iterations of 3 confs): the same confs and accuracies as
  the JAX CLI; a run resumed after its first iteration (from the port's or
  from the JAX package's state) ends as the uninterrupted one;
* --cache_features: with f32 banks the first step equals JAX's; the bf16
  default bank is built once per split; --int8_feature_bank --bank_batch,
  --sequential_candidates, --weightsharing and --population_weightsharing
  each run a step (over 10 of the 30 one-row confs);
* the CLI stops without CUDA and on the flags it does not carry.

Accuracies are compared exactly: each is a count of argmax hits over the
dev rows, and f32 features that agree to 1e-5 give the same argmaxes here.
"""

import pickle
import random
import sys

import numpy as np
import pytest
import torch

import jax

import main_searchable_avmnist as jmain
import mfas_tpu.search.tools as jtools
from mfas_tpu.core import flatten_tree
from mfas_tpu.data.avmnist import make_synthetic_avmnist
from mfas_tpu.fusion import avmnist as jfav
from mfas_tpu.runtime import checkpoint as jckpt
from mfas_tpu.search import searcher as jsearcher
from mfas_tpu.search.surrogate import SimpleRecurrentSurrogate as JSurrogate
import mfas_tpu_torch.search.tools as ttools
from mfas_tpu_torch import main_searchable_avmnist as tmain
from mfas_tpu_torch.fusion import avmnist as tfav
from mfas_tpu_torch.search import population as tpop
from mfas_tpu_torch.search import searcher as tsearcher
from mfas_tpu_torch.search import searchers as tsearchers
from tests.test_torch_search_cli import one_torch_thread  # noqa: F401
from tests.test_torch_search_ntu import _pairs, _steps_saved

SMALL = ["--channels", "4", "--batchsize", "8",
         "--inner_representation_size", "8", "--drpt", "0", "--epochs", "1",
         "--epochs_surrogate", "5", "--num_samples", "3",
         "--search_iterations", "1", "--max_fusions", "2", "--no-verbose",
         "--rgb_cp", "rgb.checkpoint", "--audio_cp", "audio.checkpoint",
         "--seed", "0"]


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
    root = tmp_path_factory.mktemp("search_avmnist")
    make_synthetic_avmnist(str(root / "data"), n_train=48, n_test=4)
    args = tmain.parse_args(["--channels", "4"])
    tree = jfav.AVMnistFeatureExtractor(args).init(0)
    for name, attr in (("rgb", "rgbnet"), ("audio", "audnet")):
        flat = {k: np.asarray(v) for k, v in flatten_tree(tree[attr]).items()}
        jckpt.save(flat, str(root / f"{name}.checkpoint"))
    return root


def argv_of(root, *extra):
    return ["--datadir", str(root / "data"), "--checkpointdir", str(root),
            *SMALL, *extra]


@pytest.fixture
def jax_surrogate(monkeypatch):
    """The port's searcher gets the JAX surrogate's initial weights."""
    params = jax.tree_util.tree_map(
        np.asarray, JSurrogate(100, 3, 100, max_seq_len=2).params)
    orig = tsearchers.SimpleRecurrentSurrogate

    def build(*a, **k):
        s = orig(*a, **k)
        s.load_numpy(params)
        return s

    monkeypatch.setattr(tsearchers, "SimpleRecurrentSurrogate", build)


def _top5(out):
    lines = out.split("Now listing best architectures\n", 1)[1].splitlines()
    return lines[:5]


def _jax_run(capsys, argv, state):
    """The JAX CLI; returns its printed top-5 and its per-step states."""
    with pytest.MonkeyPatch.context() as mp:
        saved = _steps_saved(mp, jsearcher)
        mp.setattr(sys, "argv", ["main_searchable_avmnist.py", *argv,
                                 "--search_state", state])
        jmain.main()
    out = capsys.readouterr().out
    return _top5(out), [tsearcher.ModelSearcher.load_state(p) for p in saved]


def _port_run(monkeypatch, capsys, argv, state):
    saved = _steps_saved(monkeypatch, tsearcher)
    run = tmain.main([*argv, "--search_state", state], device="cpu")
    out = capsys.readouterr().out
    return run, _top5(out), [tsearcher.ModelSearcher.load_state(p)
                             for p in saved]


def _state_pairs(st):
    return {(np.asarray(c).tobytes(), a)
            for _, entries in st["surrogate_data"] for c, a in entries}


# --------------------------------------------------------------------------
# the random-search sampler
# --------------------------------------------------------------------------
@pytest.mark.parametrize("legacy_bug", [False, True])
def test_sample_k_configurations_directly_bit_exact(legacy_bug):
    space = {0: [[0, 0, 0], [1, 0, 1]],
             1: [[2, 1, 0], [3, 2, 1], [4, 0, 0]],
             2: [[1, 1, 1], [0, 2, 0]]}.__getitem__
    out, states = [], []
    for sampler in (jtools.sample_k_configurations_directly,
                    ttools.sample_k_configurations_directly):
        np.random.seed(4)
        random.seed(4)
        out.append(sampler(20, 3, space, legacy_bug=legacy_bug))
        states.append((np.random.get_state(), random.getstate()))
    assert [c.tobytes() for c in out[0]] == [c.tobytes() for c in out[1]]
    assert [c.shape for c in out[0]] == [c.shape for c in out[1]]
    (nj, pj), (nt, pt) = states
    assert nj[1].tobytes() == nt[1].tobytes() and pj == pt
    rows = {tuple(r) for c in out[1] for r in c[:1]}
    # without the bug the first row comes from layer 0's space, with it
    # every row comes from the last layer's
    assert rows <= ({(1, 1, 1), (0, 2, 0)} if legacy_bug
                    else {(0, 0, 0), (1, 0, 1)})
    assert {len(c) for c in out[1]} == {1, 2, 3}

    np.random.seed(1)
    a = jtools.sample_k_configurations_uniform(space(1), 5)
    np.random.seed(1)
    assert ttools.sample_k_configurations_uniform(space(1), 5) == a


# --------------------------------------------------------------------------
# whole searches against the JAX CLI
# --------------------------------------------------------------------------
def test_epnas_search_matches_jax_cli(root, monkeypatch, capsys,
                                      jax_surrogate):
    argv = argv_of(root)
    jtop, jsteps = _jax_run(capsys, argv,
                            str(root / "jax_epnas.pkl"))
    run, top, steps = _port_run(monkeypatch, capsys, argv,
                                str(root / "epnas.pkl"))
    assert len(steps) == len(jsteps) == 2
    first, jfirst = _state_pairs(steps[0]), _state_pairs(jsteps[0])
    assert len(first) == 30 and first == jfirst
    # the step tells confs apart, and the store's label signal carries
    # through random frozen backbones: the best beats chance (0.1) by 2x
    assert len({a for _, a in first}) > 1
    assert max(a for _, a in first) > 0.2
    assert [c.tobytes() for c in steps[0]["sampled_k_confs"]] == \
        [c.tobytes() for c in jsteps[0]["sampled_k_confs"]]
    assert _state_pairs(steps[1]) == _state_pairs(jsteps[1]) == \
        _pairs(run.data)
    assert top == jtop and len(top) == 5
    assert run.candidates == 30 + 3
    assert set(run.split) == {"sampler", "features", "population steps",
                              "surrogate"}


def test_randsearch_matches_jax_and_resumes(root, monkeypatch, capsys):
    argv = argv_of(root, "--randsearch")
    _, jsteps = _jax_run(capsys, argv,
                         str(root / "jax_rand.pkl"))
    full, _, steps = _port_run(monkeypatch, capsys, argv,
                               str(root / "rand.pkl"))
    assert len(steps) == len(jsteps) == 2 and full.candidates == 6
    for st, jst in zip(steps, jsteps):
        assert [c.tobytes() for c in st["sampled_k_confs"]] == \
            [c.tobytes() for c in jst["sampled_k_confs"]]
        assert _state_pairs(st) == _state_pairs(jst)
    assert full.split.keys() == {"sampler", "features", "population steps"}

    # resumed after the first iteration, in a process seeded otherwise:
    # from the port's own state and from the JAX package's
    for name, st in (("port", steps[0]), ("jax", jsteps[0])):
        path = str(root / f"resume_{name}.pkl")
        with open(path, "wb") as f:
            pickle.dump(st, f)
        other = [a for a in argv if a != "--no-verbose"]
        other[other.index("--seed") + 1] = "7"
        resumed = tmain.main(
            [*other, "--search_state", path, "--resume_search"],
            device="cpu")
        assert "Resuming random search after iteration 0" in \
            capsys.readouterr().out
        assert resumed.candidates == 3
        assert _pairs(resumed.data) == _pairs(full.data)
        assert tsearcher.ModelSearcher.load_state(path)["si"] == 1


def test_cache_features(root, monkeypatch, capsys, jax_surrogate):
    steps1 = ["--max_fusions", "1"]
    f32 = ["--cache_features", "--f32_features"]
    _, jsteps = _jax_run(capsys, argv_of(root, *f32, *steps1),
                         str(root / "jax_cache.pkl"))
    _, _, steps = _port_run(monkeypatch, capsys,
                            argv_of(root, *f32, *steps1),
                            str(root / "cache.pkl"))
    assert _state_pairs(steps[0]) == _state_pairs(jsteps[0])

    calls = []
    orig = tpop.PopulationTrainer._features

    def count(self, inputs, train):
        calls.append(train)
        return orig(self, inputs, train)

    monkeypatch.setattr(tpop.PopulationTrainer, "_features", count)
    run = tmain.main(argv_of(root, "--cache_features"), device="cpu")
    assert run.candidates == 33
    assert calls == [False] * (6 + 1)     # train 42 and dev 6 at batch 8
    accs = [a for _, a in run.top]
    assert all(0.0 <= a <= 1.0 for a in accs)


@pytest.mark.parametrize("flags, split", [
    (["--cache_features", "--int8_feature_bank", "--bank_batch", "16"],
     {"sampler", "features", "population steps", "surrogate"}),
    (["--sequential_candidates"],
     {"sampler", "sequential candidates", "surrogate"}),
    (["--weightsharing"], {"sampler", "sequential candidates", "surrogate"}),
    (["--weightsharing", "--population_weightsharing"],
     {"sampler", "features", "population steps", "surrogate"}),
])
def test_trainer_flags_run_a_step(root, flags, split, monkeypatch,
                                  one_torch_thread):
    # every third of the 30 [audio tap, image tap, activation] rows: each
    # tap and both activations
    first = tfav.get_possible_layer_configurations()[::3]
    monkeypatch.setattr(tfav, "get_possible_layer_configurations",
                        lambda progression_index=None: first)
    run = tmain.main(argv_of(root, *flags, "--max_fusions", "1"),
                     device="cpu")
    assert run.candidates == len(first) and set(run.split) == split
    assert all(0.0 <= a <= 1.0 for _, a in run.top) and len(run.top) == 5


# the multi-GPU flags are ported (parallel/mesh.py): on a card-less command
# line they stop for want of CUDA like any other, and a partial --dist_*
# trio stops with the JAX package's ValueError before anything runs
@pytest.mark.parametrize("extra, item", [
    ([], None),
    (["--use_dataparallel"], None),
    (["--shard_feature_bank"], None),
    # a group it cannot form (no --dist_num_processes) fails
    (["--dist_coordinator", "localhost:1234"], "dist_num_processes"),
    (["--dist_num_processes", "2"], "dist_coordinator"),
])
def test_cli_guards(root, extra, item, monkeypatch):
    if item:
        with pytest.raises(ValueError, match=item):
            tmain.main(argv_of(root, *extra), device="cpu")
        return
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        tmain.main(argv_of(root, *extra))
    assert "needs a CUDA device" in str(e.value)


def test_parser_matches_the_jax_cli(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["main_searchable_avmnist.py"])
    want = vars(jmain.parse_args())
    got = vars(tmain.parse_args([]))
    assert got == want
    assert (got["channels"], got["batchsize"],
            got["inner_representation_size"]) == (32, 128, 16)
    assert tfav.tap_sizes(tmain.parse_args([])) == \
        ([32, 64, 128, 256, 512], [32, 64, 128])
