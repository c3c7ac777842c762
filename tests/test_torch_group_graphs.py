"""The port's graphed steps under a data or pop group, on the CPU: gloo
ranks (tests/torch_ranks.py) run each case eagerly, then with every engine
and trainer forced onto its graphed entries through the eager stand-in of
the CUDA graphs (tests/torch_graph_stand_in.py): the card's bookkeeping
(static inputs holding the rank's rows and the global valid count, the
warm-up undone, the collectives inside the captured function, the caches
keyed by group) with the CPU's arithmetic. On the card only NCCL groups
are graphed (``graphs.graphable``); gloo runs its collectives on the host,
so its programs stay eager, which is the eager side here.

* ``graphs.graphable``: False on the CPU and for a gloo group, True on a
  CUDA device with no group or NCCL ones;
* two ranks: ``ClassifierEngine`` on AV-MNIST (2 epochs at batch 8),
  graphed bitwise eager on every rank, and against the JAX engine on
  ``make_mesh(2)`` within tests/test_torch_engine_parallel.py's tolerance;
  the float64 ``CifarEngine`` step over a ragged masked batch of 8 split
  over the ranks, graphed bitwise eager, and against the JAX step within
  tests/test_torch_engine_parallel.py's bounds; ``MMIMDBEngine`` over a
  padded-sequence net at text lengths 8 and 16 (one train and one eval
  graph each), graphed bitwise eager, the all-gathered eval logits those
  of the one-rank run;
* four ranks on the (pop=2, data=2) layout of
  tests/test_torch_population_parallel.py: the streamed per-batch path,
  the fused bank, and the bank split by rows over the data group
  (``shard_feature_bank``, int8), graphed bitwise eager (accuracies and
  parameters), and against the JAX trainer on ``Mesh((2, 4))`` within that
  file's tolerances.
"""

import numpy as np
import pytest
import torch

from mfas_tpu.core import flatten_tree
from mfas_tpu.fusion import avmnist as fa
from mfas_tpu.parallel.mesh import make_mesh
from mfas_tpu_torch.runtime import graphs
from mfas_tpu_torch.search.population import PopulationSpec as TSpec
from tests.test_avmnist_vertical import make_args, synthetic_avmnist
from tests.test_population_trainer import build
from tests.test_torch_cifar import (CONF as CIFAR_CONF, LR, VANISHING,
                                    _batch, _engine_step, _flat, cifar_args,
                                    jfc)
from tests.test_torch_engine_parallel import CONF, _jax_avmnist
from tests.test_torch_population_parallel import (CONFS, VARIANTS, _data,
                                                  _jax_run, _spec)
from tests.torch_ranks import mmimdb_padded_run, run_ranks

POP_VARIANTS = ("per_batch", "fused_bank", "sharded_bank_int8")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: under a parallel test runner every split op
    waits on threads the other workers' processes hold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    args = make_args(drpt=0.0)
    jnet = fa.Searchable_Audio_Image_Net(args, CONF)
    cifar = {"args": cifar_args(), "conf": CIFAR_CONF, "batch": _batch(),
             "lr": LR, "flat": _flat(jfc.Searchable_MicroCNN(
                 cifar_args(), CIFAR_CONF, fixed=True), seed=1)}
    # float32, as JAX places synthetic_avmnist's float64 images
    data = {k: v.astype(np.float32) if v.dtype == np.float64 else v
            for k, v in synthetic_avmnist(32).items()}
    inputs = {"args": args, "conf": CONF, "data": data, "cifar": cifar,
              "flat": {k: np.asarray(v)
                       for k, v in flatten_tree(jnet.init(0)).items()}}
    out = run_ranks(2, ["group_graphs_engines"], inputs,
                    tmp_path_factory.mktemp("group_graphs_engines"))
    return inputs, [r["group_graphs_engines"] for r in out]


@pytest.fixture(scope="module")
def population(tmp_path_factory):
    args = make_args(drpt=0.0)
    _, _, btree = build(args)
    variants = {}
    for name in POP_VARIANTS:
        kw = dict(VARIANTS[name])
        kw["spec"] = _spec(TSpec, args, kw.pop("feature_dtype"))
        variants[name] = kw
    inputs = {"args": args, "confs": CONFS, "variants": variants,
              "data": {"n32": _data(32), "n21": _data(21)},
              "btree": {k: np.asarray(v)
                        for k, v in flatten_tree(btree).items()}}
    out = run_ranks(4, ["group_graphs_population"], inputs,
                    tmp_path_factory.mktemp("group_graphs_population"))
    return inputs, [r["group_graphs_population"] for r in out]


def _bitwise(a, b, where=""):
    """Two nested results (dicts, lists, numbers, arrays) equal bitwise."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _bitwise(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _bitwise(x, y, f"{where}/{i}")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


# --------------------------------------------------------------------------
# the rule
# --------------------------------------------------------------------------
@pytest.mark.parametrize("device, backends, want", [
    ("cpu", (), False),
    ("cpu", (None,), False),
    ("cuda", (), True),
    ("cuda", (None,), True),
    ("cuda", ("nccl",), True),
    ("cuda", ("nccl", None, "nccl"), True),
    ("cuda", ("gloo",), False),
    ("cuda", ("nccl", "gloo"), False),
])
def test_graphable(monkeypatch, device, backends, want):
    """Groups stand in as their backend's name, read back through a
    patched ``dist.get_backend``."""
    monkeypatch.setattr(graphs.dist, "get_backend", lambda g: g)
    assert graphs.graphable(device, *backends) is want
    assert graphs.graphable(torch.device(device), *backends) is want


# --------------------------------------------------------------------------
# the engines over two ranks
# --------------------------------------------------------------------------
def test_avmnist_engine_graphed_under_group(engines):
    inp, out = engines
    for r in out:
        run = r["avmnist"]
        assert run["eager_counts"] == {}
        _bitwise(run["graphed"], run["eager"])
        # 32 samples at batch 8: 4 train and 4 dev batches an epoch, one
        # graph each for the one optimizer of the run
        assert run["counts"] == {
            "ClassifierEngine_train": {"captures": 1, "replays": 8},
            "ClassifierEngine_eval": {"captures": 1, "replays": 8}}
    _bitwise(out[1]["avmnist"]["graphed"], out[0]["avmnist"]["graphed"])
    got = out[0]["avmnist"]["graphed"]
    acc_j, tree_j = _jax_avmnist(inp, make_mesh(2))
    assert got["acc"] == acc_j
    dead = {k for k, v in got["state"].items()
            if np.array_equal(v, inp["flat"][k])}
    for k, v in tree_j.items():
        if k in dead:
            continue
        # tests/test_engine_mesh.py's mesh-against-single tolerance, as
        # tests/test_torch_engine_parallel.py holds the eager ranks
        np.testing.assert_allclose(got["state"][k], v, rtol=2e-2, atol=5e-4,
                                   err_msg=k)


def test_cifar_f64_step_graphed_under_group(engines):
    inp, out = engines
    _, jloss, jgrads, _, _, _, _, _ = _engine_step(False)
    largest = max(np.abs(g).max() for g in jgrads.values())
    for r in out:
        run = r["cifar"]
        _bitwise(run["graphed"], run["eager"])
        assert run["counts"] == {
            "CifarEngine_train": {"captures": 1, "replays": 1}}
        got = run["graphed"]
        assert got["loss"] == pytest.approx(jloss, rel=1e-12)
        for k, g in got["grads"].items():
            if k in VANISHING:
                assert np.abs(g).max() < 1e-12 * largest, k
                continue
            np.testing.assert_allclose(g, jgrads[k], rtol=0,
                                       atol=1e-9 * np.abs(jgrads[k]).max(),
                                       err_msg=k)
    _bitwise(out[1]["cifar"]["graphed"]["after"],
             out[0]["cifar"]["graphed"]["after"])


def test_mmimdb_two_text_lengths_graphed_under_group(engines):
    _, out = engines
    one = mmimdb_padded_run(None)
    for r in out:
        run = r["mmimdb"]
        _bitwise(run["graphed"], run["eager"])
        assert run["counts"] == {
            "MMIMDBEngine_train": {"captures": 2, "replays": 4},
            "MMIMDBEngine_eval": {"captures": 2, "replays": 2}}
        for a, b in zip(run["graphed"]["logits"], one["logits"]):
            # the whole batch on every rank, computed by halves
            assert a.shape == b.shape == (4, 23)
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    _bitwise(out[1]["mmimdb"]["graphed"]["state"],
             out[0]["mmimdb"]["graphed"]["state"])


# --------------------------------------------------------------------------
# the population over four ranks, (pop=2, data=2)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("variant", POP_VARIANTS)
def test_population_graphed_under_groups(population, variant):
    inp, out = population
    runs = [r[variant] for r in out]
    for run in runs:
        assert run["eager_counts"] == {}
        _bitwise(run["graphed"], run["eager"])
    for run in runs[1:]:
        _bitwise(run["graphed"], runs[0]["graphed"])
    counts = runs[0]["counts"]
    if VARIANTS[variant]["cache_train_features"]:
        # one replay of each graph an epoch (an epoch's steps fit one)
        assert counts == {
            "population_train_epoch": {"captures": 1, "replays": 2},
            "population_eval_epoch": {"captures": 1, "replays": 2}}
    else:
        # 32 samples at batch 8, 2 epochs: a replay per batch
        assert counts == {
            "population_features": {"captures": 1, "replays": 8},
            "population_train_step": {"captures": 1, "replays": 8},
            "population_eval_step": {"captures": 1, "replays": 8}}
    got = runs[0]["graphed"]
    accs_j, params_j = _jax_run(inp, variant)
    # tests/test_population_mesh.py's tolerances, as
    # tests/test_torch_population_parallel.py holds the eager ranks
    np.testing.assert_allclose(got["accs"], accs_j, atol=1e-6)
    for k, v in params_j.items():
        np.testing.assert_allclose(got["params"][k], v, rtol=1e-4,
                                   atol=1e-5, err_msg=k)
