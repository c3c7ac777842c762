"""The port's per-batch step programs (runtime/graphs.py::Step) on the CPU,
through an eager stand-in for the CUDA graph.

The stand-in (``eager_graphs``, tests/torch_graph_stand_in.py) replaces
``graphs._record``: it makes the warm-up calls and the captured call as a
capture would, then reruns the captured function at every replay, writing
its results into the tensors the captured call returned and holding the
replay counters (a replay reruns kernels, not the Python that counts them).
Everything else is the code the card runs: the signature cache, the static
inputs, the resident tensors passed through, the state put back after the
warm-up, the cloned outputs, the counters that advance per replay, the
engines' and the population trainer's graphed entries. A test that forces
``graphed`` on a CPU engine or trainer thus runs the card's bookkeeping
with the CPU's arithmetic.

* ``Step``: one capture per batch signature, the static inputs reused by
  every replay, the caller's tensors never read by the graph, resident
  tensors passed through uncopied (another address is another graph), the
  outputs cloned per step, a registered counter advanced once per replay
  and not by the warm-up (the input kernels' ``launch_counts`` is
  registered), and the warm-up's moves of parameters, buffers, optimizer
  state and generator undone: the first graphed step equals one eager step;
* the found-NTU CLI on the resident store (K2's plain version inside the
  step, the store passed through) with dropout, the AV-MNIST CLI and the
  CIFAR CLI with DropPath and dropout, graphed against eager: the printed
  losses and accuracies, the test logits and the saved parameters bitwise;
  one capture per (phase, split) and one replay per batch;
* a train state written by an eager run (torch's lazy Adam: the layout
  every earlier run wrote) resumes into the graphed engine, and the
  crash-resumed graphed run equals the uninterrupted one bitwise;
* the streamed search (the train-mode features, the population's train and
  eval steps) graphed against eager: the same accuracies, parameters and
  BatchNorm state bitwise, one capture per program and shape, and a second
  population loaded into the cached steps without a capture.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from mfas_tpu_torch import main_found_avmnist as tavmain
from mfas_tpu_torch import main_found_cifar as tcmain
from mfas_tpu_torch import main_found_ntu as tmain
from mfas_tpu_torch.data import avmnist as tav
from mfas_tpu_torch.data import cifar as tcifar
from mfas_tpu_torch.data import ntu_pack as tpack
from mfas_tpu_torch.engine import classifier as tengine
from mfas_tpu_torch.ops import input_kernels as tk
from mfas_tpu_torch.runtime import graphs
from mfas_tpu_torch.search import population as tpop
from tests import test_torch_found_ntu_train as ntu_train
from tests.test_torch_found_ntu_train import fx  # noqa: F401
from tests.torch_graph_stand_in import eager_graphs  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: under a parallel test runner every split op
    waits on threads the other workers' processes hold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def force_graphed(monkeypatch, remat=False):
    """Every ClassifierEngine, MMIMDBEngine and PopulationTrainer built from
    here on takes its graphed entries on the CPU (no group in these runs;
    no remat unless ``remat``)."""
    from mfas_tpu_torch.engine import mmimdb as tmm

    init = tengine.ClassifierEngine.__init__

    def engine_init(self, *a, **k):
        init(self, *a, **k)
        assert self.group is None and (remat or not k.get("remat"))
        self.graphed = True

    monkeypatch.setattr(tengine.ClassifierEngine, "__init__", engine_init)
    mm_init = tmm.MMIMDBEngine.__init__

    def mm_engine_init(self, *a, **k):
        mm_init(self, *a, **k)
        assert self.group is None
        self.graphed = True

    monkeypatch.setattr(tmm.MMIMDBEngine, "__init__", mm_engine_init)
    monkeypatch.setattr(tpop, "_STREAMED_CACHE", {})
    trainer_init = tpop.PopulationTrainer.__init__

    def pop_init(self, *a, **k):
        trainer_init(self, *a, **k)
        assert k.get("group") is None and k.get("pop_group") is None
        self.graphed = True

    monkeypatch.setattr(tpop.PopulationTrainer, "__init__", pop_init)


# --------------------------------------------------------------------------
# Step's bookkeeping
# --------------------------------------------------------------------------
def test_static_inputs_reused_outputs_cloned(eager_graphs):
    seen = []

    def fn(b):
        seen.append(b["x"])
        return b["x"] * 2.0, b["x"].sum()

    step = graphs.Step("t", fn)
    x1, x2 = torch.arange(4.0), torch.arange(4.0) + 10.0
    o1, o2 = step({"x": x1}), step({"x": x2})
    assert eager_graphs == {"t": {"captures": 1, "replays": 2}}
    # every call read the one static tensor, never the caller's
    assert all(t is seen[0] for t in seen)
    assert seen[0] is not x1 and seen[0] is not x2
    # each step's outputs are its own: the second did not overwrite them
    assert torch.equal(o1[0], x1 * 2.0) and torch.equal(o2[0], x2 * 2.0)
    assert float(o1[1]) == 6.0 and float(o2[1]) == 46.0
    # another shape, another capture; the first graph is kept
    step({"x": torch.arange(6.0)})
    step({"x": x1})
    assert eager_graphs["t"] == {"captures": 2, "replays": 4}


def test_resident_tensors_pass_through(eager_graphs):
    seen = []

    def fn(b):
        seen.append(b["_store"])
        return (b["_store"].index_select(0, b["i"]),)

    step = graphs.Step("r", fn, resident=("_store",))
    store = torch.arange(10.0)
    (a,) = step({"_store": store, "i": torch.tensor([1, 2])})
    (b,) = step({"_store": store, "i": torch.tensor([3, 4])})
    assert all(t is store for t in seen)          # never copied
    assert a.tolist() == [1.0, 2.0] and b.tolist() == [3.0, 4.0]
    assert eager_graphs["r"]["captures"] == 1
    other = torch.arange(10.0) + 100.0            # another address
    (c,) = step({"_store": other, "i": torch.tensor([0, 9])})
    assert c.tolist() == [100.0, 109.0]
    assert eager_graphs["r"] == {"captures": 2, "replays": 3}


def test_counters_advance_per_replay_not_per_warmup(eager_graphs):
    assert any(c is tk.launch_counts for c in graphs._REPLAY_COUNTERS)
    counter = {"launches": 0}
    graphs.count_replays(counter)
    try:
        def fn(b):
            counter["launches"] += 1
            return (b["x"] + 1.0,)

        step = graphs.Step("c", fn)
        for i in range(3):
            step({"x": torch.full((2,), float(i))})
            assert counter == {"launches": i + 1}
    finally:
        graphs.uncount_replays(counter)
    assert not any(c is counter for c in graphs._REPLAY_COUNTERS)


def _moving_step(p, buf, opt, gen):
    def fn(b):
        opt.zero_grad(set_to_none=True)
        noise = torch.rand(p.shape, generator=gen)
        (p * b["x"] * noise).sum().backward()
        opt.step()
        with torch.no_grad():
            buf.add_(noise)
        return (p.detach() * 1.0,)
    return fn


def _mover(seed):
    p = torch.nn.Parameter(torch.linspace(-1.0, 1.0, 5))
    buf = torch.zeros(5)
    opt = torch.optim.Adam([p], lr=0.1, weight_decay=1e-4)
    gen = torch.Generator().manual_seed(seed)
    return p, buf, opt, gen


def test_warmup_leaves_the_state_as_it_was(eager_graphs):
    """Two steps, graphed then eager from the same start: parameters,
    buffer, Adam state (created by the warm-up, then zeroed as a fresh
    one) and generator state equal bitwise after each."""
    x = [{"x": torch.linspace(0.5, 2.5, 5) * (i + 1)} for i in range(2)]
    p, buf, opt, gen = _mover(7)

    def state():
        return [p, buf, *(t for st in opt.state.values()
                          for t in st.values() if torch.is_tensor(t))]

    step = graphs.Step("m", _moving_step(p, buf, opt, gen), state=state,
                       generators=[gen])
    q, qbuf, qopt, qgen = _mover(7)
    eager = _moving_step(q, qbuf, qopt, qgen)
    for b in x:
        (got,) = step(b)
        (want,) = eager(b)
        assert torch.equal(got, want) and torch.equal(p, q)
        assert torch.equal(buf, qbuf)
        assert torch.equal(gen.get_state(), qgen.get_state())
        for k, v in qopt.state[q].items():
            assert torch.equal(opt.state[p][k], v), k
    assert eager_graphs["m"] == {"captures": 1, "replays": 2}


def test_engine_and_graphs_go_with_their_last_user(eager_graphs):
    """No reference cycle keeps a graphed engine (and so its graphs' memory
    pool) alive until a garbage collection: dropping the engine drops
    them."""
    from tests.test_torch_avmnist import _args, _inputs, _searchable

    _, _, net = _searchable(_args(), tmain.FOUND_CONFS[0])
    image, audio, label = _inputs(4)
    batch = {"image": torch.from_numpy(image),
             "audio": torch.from_numpy(audio),
             "label": torch.from_numpy(label), "_mask": torch.ones(4)}

    def run():
        eng = tengine.ClassifierEngine(net, "cpu", multitask=True,
                                       input_keys=("image", "audio"))
        eng.graphed = True
        eng.train_step(batch, eng.make_optimizer(), 1e-3)
        eng.eval_step(batch)
        return eng

    # torch wraps each of its optimizer functions at their first call in
    # the process, and that call's frames live until a collection
    run()
    gc.collect()
    gc.disable()
    try:
        eng = run()
        assert eager_graphs["ClassifierEngine_train"]["captures"] == 2
        gone = weakref.ref(eng._programs["train"])
        dead = weakref.ref(eng)
        del eng
        assert dead() is None and gone() is None
    finally:
        gc.enable()


# --------------------------------------------------------------------------
# the engines' graphed steps, through the CLIs
# --------------------------------------------------------------------------
NTU_ARGV = ["--conf", "4", "--num_outputs", "3", "--batchsize", "2",
            "--inner_representation_size", "16", "--vid_len", "4", "32",
            "--resnet3d_layers", "1", "1", "1", "1",
            "--resnet3d_base_width", "8", "--j", "2", "--random_backbones",
            "--drpt", "0.3", "--batchnorm", "--hbm_resident"]
NTU_SPLITS = {"train": 5, "dev": 3, "test": 5}       # batches of 2: 3, 2, 3


@pytest.fixture(scope="module")
def ntu_store(tmp_path_factory):
    packed = tmp_path_factory.mktemp("step_graphs_ntu") / "packed"
    for seed, (split, n) in enumerate(NTU_SPLITS.items()):
        tpack.make_synthetic_packed_ntu(str(packed / split), n=n, frames=6,
                                        h=32, w=32, skel_frames=40,
                                        num_classes=3, seed=seed)
    return packed


def _ntu_run(tmp_path, packed, *extra):
    run = tmain.main(["--checkpointdir", str(tmp_path), "--packed_datadir",
                      str(packed), *NTU_ARGV, *extra], device="cpu")
    return run


def _same_runs(a, b):
    assert a.acc == b.acc
    assert [r.epochs for r in a.train] == [r.epochs for r in b.train]
    for x, y in zip(a.eval.fused_logits, b.eval.fused_logits):
        assert torch.equal(x, y)


def test_ntu_found_run_graphed_equals_eager(tmp_path, ntu_store,
                                            eager_graphs, monkeypatch):
    eager = _ntu_run(tmp_path / "eager", ntu_store, "--epochs", "2")
    force_graphed(monkeypatch)
    graphed = _ntu_run(tmp_path / "graphed", ntu_store, "--epochs", "2")
    _same_runs(graphed, eager)
    # phase 1 (1 epoch) and phase 2 (2 epochs): a train graph and a dev
    # graph each, replayed per batch; the test split's own graph
    assert eager_graphs == {
        "ClassifierEngine_train": {"captures": 2, "replays": 3 * 3},
        "ClassifierEngine_eval": {"captures": 3, "replays": 3 * 2 + 3}}


def test_resumed_graphed_run_equals_uninterrupted(fx, tmp_path,
                                                  eager_graphs, monkeypatch):
    """The state of an eager first epoch (torch's lazy Adam: the layout
    every earlier run wrote) resumes into the graphed engine, which loads
    it before it captures: the resumed run ends as the uninterrupted
    graphed one, its states bitwise."""
    args = ntu_train._args(fx, "--drpt", "0.3", "--batchnorm")

    def run(epochs, path, resume=False):
        model = tmain.build_model(args, tmain.FOUND_CONFS[4], "cpu")
        eng = ntu_train._port_engine(model, args)
        loaders, sizes = ntu_train._port_loaders(fx)
        return eng.train_track_acc(
            None, loaders, sizes, ntu_train.TSched(*ntu_train._sched(sizes)),
            epochs, print_loss=False, state_path=path, resume=resume)

    part, whole = str(tmp_path / "part.pt"), str(tmp_path / "whole.pt")
    run(1, part)
    force_graphed(monkeypatch)
    acc_r, best_r = run(3, part, resume=True)
    acc_w, best_w = run(3, whole)
    assert acc_r == acc_w
    for k in best_w:
        assert torch.equal(best_r[k], best_w[k]), k
    sw = torch.load(whole, weights_only=True)
    sr = torch.load(part, weights_only=True)
    assert sw.keys() == sr.keys()
    for k in sw:
        assert torch.equal(sw[k], sr[k]), k
    # the resumed run captured its own train graph (2 of its epochs ran)
    assert eager_graphs["ClassifierEngine_train"]["captures"] == 2


def test_avmnist_found_run_graphed_equals_eager(tmp_path, eager_graphs,
                                                monkeypatch):
    tav.make_synthetic_avmnist(str(tmp_path / "av"), n_train=40, n_test=16)
    argv = ["--datadir", str(tmp_path / "av"), "--checkpointdir",
            str(tmp_path), "--channels", "2", "--batchsize", "16",
            "--epochs", "1", "--inner_representation_size", "8",
            "--drpt", "0.2"]
    eager = tavmain.main(argv, device="cpu")
    force_graphed(monkeypatch)
    graphed = tavmain.main(argv, device="cpu")
    _same_runs(graphed, eager)
    assert eager_graphs["ClassifierEngine_train"]["captures"] == 2
    assert eager_graphs["ClassifierEngine_train"]["replays"] > 2


def test_cifar_found_run_graphed_equals_eager(tmp_path, eager_graphs,
                                              monkeypatch):
    """DropPath and dropout draw from the engine's generator inside the
    graphed step, and the zero-gradient skip runs there."""
    root = str(tmp_path / "cifar")
    tcifar.make_synthetic_cifar(root, n_per_batch=8)
    argv = ["--data_dir", root, "--planes", "4", "--net_str", "1", "2", "1",
            "--batchsize", "8", "--epochs", "2", "--use_intermediate",
            "--drop_path", "0.4", "--drop_prob", "0.3",
            "--checkpointdir", str(tmp_path)]
    eager = tcmain.main(argv, device="cpu")
    force_graphed(monkeypatch)
    graphed = tcmain.main(argv, device="cpu")
    _same_runs(graphed, eager)
    assert eager_graphs["CifarEngine_train"]["captures"] == 1
    assert eager_graphs["CifarEngine_eval"]["captures"] >= 1


# --------------------------------------------------------------------------
# the streamed search's graphed steps
# --------------------------------------------------------------------------
def test_streamed_population_graphed_equals_eager(eager_graphs, monkeypatch):
    """Two populations (P=3, then P=2, then P=3 again) trained by one
    trainer over a loader of uint8 clips: graphed against eager, the same
    accuracies, parameters and BatchNorm state bitwise; the features
    captured once, each population shape's steps once."""
    from tests.test_torch_search_population import (CONFS, jax_extractor,
                                                    make_spec, small_args)

    args = small_args(["--drpt", "0.3"])
    _, _, extractor = jax_extractor(args)
    spec = make_spec(tpop, args, batchnorm=True, use_alphas=True,
                     multitask=True, drpt=0.3)
    rs = np.random.RandomState(4)
    data = {"rgb": rs.randint(0, 256, (7, 4, 32, 32, 3)).astype(np.uint8),
            "ske": (rs.randn(7, 3, 32, 25, 2) * 0.3).astype(np.float32),
            "label": rs.randint(0, 3, 7).astype(np.int32)}
    from mfas_tpu_torch.core.sched import FixedScheduler
    from mfas_tpu_torch.data.loader import ArrayLoader

    def search(trainer):
        out = []
        for confs, seed in ((CONFS[:3], 1), (CONFS[2:], 2), (CONFS[1:], 3)):
            loaders = {"train": ArrayLoader(data, 3, shuffle=True, seed=seed),
                       "dev": ArrayLoader(data, 4, shuffle=False)}
            accs, params, bn = trainer.train_population(
                confs, loaders, {"train": 7, "dev": 7}, FixedScheduler(1e-3),
                2, ("rgb", "ske"), seed=seed)
            out.append((accs, params, bn))
        return out

    def trainer():
        return tpop.PopulationTrainer(
            spec, extractor, device="cpu",
            input_prep=tpack.make_device_normalize_inputs_prep())

    eager = search(trainer())
    force_graphed(monkeypatch)
    graphed = search(trainer())
    for (ga, gp, gb), (ea, ep, eb) in zip(graphed, eager):
        assert ga == ea
        for k in ep:
            assert torch.equal(gp[k], ep[k]), k
        for k in eb:
            assert torch.equal(gb[k], eb[k]), k
    # 3 train batches of 3 and 2 dev batches of 4, 2 epochs, 3 populations
    assert eager_graphs == {
        "population_features": {"captures": 1, "replays": 3 * 2 * 3},
        "population_train_step": {"captures": 2, "replays": 3 * 2 * 3},
        "population_eval_step": {"captures": 2, "replays": 2 * 2 * 3}}
