"""The port's engines under a data group against the JAX engines on
``make_mesh(D)`` and against the port on one rank, on the CPU (the port of
tests/test_engine_mesh.py and test_train_resume.py:61).

Ranks are gloo processes (tests/torch_ranks.py): one spawn of two ranks
runs the AV-MNIST, MM-IMDB, CIFAR and resume cases, one of four ranks the
AV-MNIST case again. Checked, with the tolerances stated at each assert:
  * ClassifierEngine, AV-MNIST conf [[4, 2, 0]], 2 epochs at batch 8,
    dropout 0: every rank prints the same epoch losses and accuracies,
    ends with bitwise equal parameters, and matches the port on one rank
    and the JAX engine on ``make_mesh(D)`` (best dev accuracy equal);
  * MMIMDBEngine, SimpleVTNet, 2 epochs: the best dev F1 and the test F1
    equal the one-rank port's and JAX's on the mesh, and the test logits
    are all-gathered whole on every rank;
  * one float64 CifarEngine step over a ragged masked batch of 8 split
    over two ranks: loss, gradients and parameters after the skip-zero
    Adam step as the one-rank port's and JAX's;
  * a run resumed from the train state under the data group equals the
    uninterrupted one.
"""

import numpy as np
import pytest

from mfas_tpu.core import flatten_tree
from mfas_tpu.core.sched import FixedScheduler
from mfas_tpu.data.loader import ArrayLoader
from mfas_tpu.engine.classifier import ClassifierEngine
from mfas_tpu.fusion import avmnist as fa
from mfas_tpu.parallel.mesh import make_mesh
from tests.test_avmnist_vertical import make_args, synthetic_avmnist
from tests.test_torch_cifar import (CONF as CIFAR_CONF, DEAD_FR, LR,
                                    VANISHING, _batch, _engine_step, _flat,
                                    cifar_args, jfc)
from tests.torch_ranks import (avmnist_engine_run, cifar_engine_step,
                               mmimdb_engine_run, run_ranks)

CONF = np.array([[4, 2, 0]])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: under a parallel test runner every split op
    waits on threads the other workers' processes hold."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_avmnist(inp, mesh):
    net = fa.Searchable_Audio_Image_Net(inp["args"], CONF)
    loaders = {"train": ArrayLoader(inp["data"], 8, shuffle=False),
               "dev": ArrayLoader(inp["data"], 8)}
    sizes = {k: v.dataset_size for k, v in loaders.items()}
    eng = ClassifierEngine(net, input_keys=("image", "audio"), mesh=mesh)
    acc, best = eng.train_track_acc(net.init(0), None, loaders, sizes,
                                    FixedScheduler(1e-3), num_epochs=2,
                                    print_loss=False)
    return acc, {k: np.asarray(v) for k, v in flatten_tree(best).items()}


def _mmimdb_inputs(root):
    from mfas_tpu.data.mm_imdb import make_synthetic_mmimdb
    from mfas_tpu.models import mm_imdb as M
    import types

    for stage, n in (("train", 16), ("dev", 8), ("test", 8)):
        make_synthetic_mmimdb(str(root), stage, n=n, feat_dim=300,
                              num_labels=5)
    model = M.SimpleVTNet(types.SimpleNamespace(num_outputs=5, channels=4),
                          8, 3)
    return {"root": str(root), "flat": {
        k: np.asarray(v) for k, v in flatten_tree(model.init(0)).items()}}


def _jax_mmimdb(inp, mesh):
    import types

    from mfas_tpu.core.sched import LRCosineAnnealingScheduler
    from mfas_tpu.data.mm_imdb import MM_IMDB, MMIMDBLoader
    from mfas_tpu.engine.mmimdb import MMIMDBEngine
    from mfas_tpu.models import mm_imdb as M

    model = M.SimpleVTNet(types.SimpleNamespace(num_outputs=5, channels=4),
                          8, 3)
    loaders, sizes = {}, {}
    for stage, n in (("train", 16), ("dev", 8), ("test", 8)):
        ds = MM_IMDB(inp["root"], stage=stage, feat_dim=300,
                     average_text=True, len_data=n)
        loaders[stage] = MMIMDBLoader(ds, 8, shuffle=(stage == "train"),
                                      seed=0)
        sizes[stage] = len(ds)
    eng = MMIMDBEngine(model, mesh=mesh)
    sched = LRCosineAnnealingScheduler(1e-3, 1e-6, 1, 2, sizes["train"] / 8)
    f1, best = eng.train_track_f1(
        model.init(0), None, {k: loaders[k] for k in ("train", "dev")},
        sizes, sched, num_epochs=2, seed=0)
    return f1, eng.test_track_f1(best, loaders["test"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("engines")
    args = make_args(drpt=0.0)
    jnet = fa.Searchable_Audio_Image_Net(args, CONF)
    # _engine_step's weights: the JAX net's init(1)
    cifar = {"args": cifar_args(), "conf": CIFAR_CONF, "batch": _batch(),
             "lr": LR, "flat": _flat(jfc.Searchable_MicroCNN(
                 cifar_args(), CIFAR_CONF, fixed=True), seed=1)}
    # float32, as JAX places synthetic_avmnist's float64 images
    data = {k: v.astype(np.float32) if v.dtype == np.float64 else v
            for k, v in synthetic_avmnist(32).items()}
    inputs = {"args": args, "conf": CONF, "data": data,
              "flat": {k: np.asarray(v)
                       for k, v in flatten_tree(jnet.init(0)).items()},
              "mmimdb": _mmimdb_inputs(tmp / "mmimdb"), "cifar": cifar}
    two = run_ranks(2, ["engine_avmnist", "engine_mmimdb", "engine_cifar",
                        "engine_resume"], inputs, tmp / "two")
    four = run_ranks(4, ["engine_avmnist"], inputs, tmp / "four")
    return inputs, {2: two, 4: four}


def _assert_ranks_agree(results):
    first = results[0]
    for r in results[1:]:
        assert r["epochs"] == first["epochs"]
        for k, v in first["state"].items():
            np.testing.assert_array_equal(r["state"][k], v, err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_classifier_engine_matches_one_rank_and_jax_mesh(runs, world):
    inp, out = runs
    got = [r["engine_avmnist"] for r in out[world]]
    _assert_ranks_agree(got)
    one = avmnist_engine_run(inp, None)
    acc_j, tree_j = _jax_avmnist(inp, make_mesh(world))
    assert got[0]["acc"] == one["acc"] == acc_j
    for a, b in zip(got[0]["epochs"], one["epochs"]):
        assert a["acc"] == b["acc"]
        # per-rank float32 partial sums, over parameters that drift by the
        # rounding of the reduced gradients
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
    dead = {k for k, v in one["state"].items()
            if np.array_equal(v, inp["flat"][k])}
    for k, v in one["state"].items():
        # two epochs of Adam over gradients summed in another order: Adam
        # turns their rounding into drift of up to ~0.1 lr on elements
        # whose gradient is near zero, so the parameters are held to
        # tests/test_engine_mesh.py's mesh-against-single tolerance (the
        # printed losses and accuracies above are the tight check)
        np.testing.assert_allclose(got[0]["state"][k], v, rtol=2e-2,
                                   atol=5e-4, err_msg=k)
        if k in dead:
            # no gradient (the backbones' own classifiers, the gates
            # without --alphas): torch never steps them, JAX moves them by
            # weight decay (ROADMAP.md §3)
            np.testing.assert_array_equal(got[0]["state"][k], v)
            continue
        # tests/test_engine_mesh.py's mesh-against-single tolerance
        np.testing.assert_allclose(got[0]["state"][k], tree_j[k], rtol=2e-2,
                                   atol=5e-4, err_msg=k)
    assert {k.split(".")[0] for k in dead if "num_batches" not in k} == {
        "rgbnet", "audnet", "alphas"}


def test_mmimdb_engine_matches_one_rank_and_jax_mesh(runs):
    inp, out = runs
    got = [r["engine_mmimdb"] for r in out[2]]
    _assert_ranks_agree(got)
    one = mmimdb_engine_run(inp["mmimdb"], None)
    f1_j, test_j = _jax_mmimdb(inp["mmimdb"], make_mesh(2))
    assert got[0]["f1"] == pytest.approx(one["f1"], abs=1e-9)
    assert got[0]["test_f1"] == pytest.approx(one["test_f1"], abs=1e-9)
    assert got[0]["f1"] == pytest.approx(f1_j, abs=1e-9)
    assert got[0]["test_f1"] == pytest.approx(test_j, abs=1e-9)
    for r in got:       # the whole test split's logits on every rank
        logits = np.concatenate(r["logits"])
        assert logits.shape == (8, 5)
        np.testing.assert_allclose(logits, np.concatenate(one["logits"]),
                                   rtol=1e-4, atol=1e-5)
    for k, v in one["state"].items():
        # as in the AV-MNIST case: Adam's drift on near-zero gradients
        np.testing.assert_allclose(got[0]["state"][k], v, rtol=2e-2,
                                   atol=5e-4, err_msg=k)


def test_cifar_engine_f64_step_over_two_ranks(runs):
    inp, out = runs
    flat, jloss, jgrads, jafter, tloss, tgrads, tafter, _ = _engine_step(
        False)
    for k, v in flat.items():
        np.testing.assert_array_equal(inp["cifar"]["flat"][k], v)
    one = cifar_engine_step(inp["cifar"], None)
    assert one["loss"] == tloss
    got = [r["engine_cifar"] for r in out[2]]
    largest = max(np.abs(g).max() for g in jgrads.values())
    for r in got:
        assert r["loss"] == pytest.approx(jloss, rel=1e-12)
        assert set(r["grads"]) == set(tgrads)
        for k, g in r["grads"].items():
            if k in VANISHING:
                assert np.abs(g).max() < 1e-12 * largest, k
                continue
            scale = np.abs(jgrads[k]).max()
            np.testing.assert_allclose(g, jgrads[k], rtol=0,
                                       atol=1e-9 * scale, err_msg=k)
            np.testing.assert_allclose(g, one["grads"][k], rtol=0,
                                       atol=1e-12 * scale, err_msg=k)
        for k, v in r["after"].items():
            if k.startswith(DEAD_FR) or k.startswith("aux_head.") \
                    and not k.endswith(("running_mean", "running_var",
                                        "num_batches_tracked")):
                continue
            if k.rsplit(".", 1)[0] + ".bias" in VANISHING and \
                    k.endswith("bias"):
                continue
            np.testing.assert_allclose(v, tafter[k], rtol=0, atol=1e-5 * LR,
                                       err_msg=k)
    for k, v in got[0]["after"].items():
        np.testing.assert_array_equal(got[1]["after"][k], v, err_msg=k)


def test_resume_under_the_data_group_matches_uninterrupted(runs):
    _, out = runs
    for r in out[2]:
        full, resumed = r["engine_resume"]["full"], r["engine_resume"][
            "resumed"]
        assert resumed["acc"] == full["acc"]
        # tests/test_train_resume.py's resume tolerance
        for k, v in full["state"].items():
            np.testing.assert_allclose(resumed["state"][k], v, rtol=2e-5,
                                       atol=2e-6, err_msg=k)
