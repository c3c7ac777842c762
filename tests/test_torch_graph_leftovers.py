"""The last per-batch programs graphed (runtime/graphs.py::Step) on the CPU,
through the eager stand-in of tests/test_torch_step_graphs.py
(``eager_graphs``, ``force_graphed``): the card's bookkeeping with the
CPU's arithmetic, held against the eager runs bitwise and against the JAX
package on the same numpy inputs and weights.

* ``MMIMDBEngine``: ``train_track_f1`` and ``test_track_f1`` of a graphed
  engine against mfas_tpu/engine/mmimdb.py with MaxOut_MLP's dropout at 0
  (the streams differ): the same dev F1s, best F1 and test F1, the epoch
  losses within rtol 1e-3 (as tests/test_torch_found_mmimdb.py holds them);
  the MM-IMDB CLI graphed against eager, bitwise (printed losses and F1s,
  test logits, saved parameters; the whole net with dropout on,
  ``--central_only``, ``--stable_bce``), one capture per (phase,
  signature) and one replay per batch; two text lengths alternating
  through one engine over a padded-sequence net (SimpleRecurrentModel and
  the poster): two train graphs alive at once on one set of gradients, a
  dead head without a gradient and unmoved, bitwise the eager engine; the
  25th graph warns, as the JAX engine's 25th program does;
* ``--remat``: the found-NTU run graphed against eager with dropout on,
  bitwise, the recomputation inside the captured step; one graphed remat
  step against the JAX ``remat=True`` step in float64 with --batchnorm
  (loss within rtol 1e-12, gradients and BatchNorm statistics within 1e-9
  of each tensor's max, parameters within 1e-5 of lr: JAX's bias
  corrections are float32);
* the bank's per-step loop (``--cache_features --no_fused_epochs``):
  graphed against the eager per-step loop, the accuracies, parameters and
  BatchNorm state bitwise, one train and one eval replay per batch; the
  accuracies equal to the JAX ``fused_epochs=False`` search's (bf16 bank,
  as tests/test_torch_search_population.py holds the fused bank).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfas_tpu.core import Ctx, Rng, flatten_tree, unflatten_tree
from mfas_tpu.core.module import merge
from mfas_tpu.core.optim import adam_init as jadam_init
from mfas_tpu.core.sched import FixedScheduler as JFixed
from mfas_tpu.data.mm_imdb import MM_IMDB as JMM_IMDB
from mfas_tpu.data.mm_imdb import MMIMDBLoader as JLoader
from mfas_tpu.engine.classifier import ClassifierEngine as JClassifier
from mfas_tpu.engine.classifier import split_tree
from mfas_tpu.engine.mmimdb import MMIMDBEngine as JEngine
from mfas_tpu.models import mm_imdb as jm
from mfas_tpu_torch import main_found_mmimdb as tmmain
from mfas_tpu_torch.core.optim import make_adam
from mfas_tpu_torch.core.sched import FixedScheduler
from mfas_tpu_torch.data.mm_imdb import MM_IMDB, MMIMDBLoader
from mfas_tpu_torch.engine.classifier import (WEIGHT_DECAY, ClassifierEngine,
                                              set_trainable, snapshot)
from mfas_tpu_torch.engine.mmimdb import MAX_PROGRAMS, MMIMDBEngine
from mfas_tpu_torch.runtime.checkpoint import load_state_dict
from mfas_tpu_torch.runtime.checkpoint import state_dict_from_numpy
from mfas_tpu_torch.search import population as tpop
from tests import test_torch_found_ntu_train as ntu_train
from tests import test_torch_search_population as spop
from tests.test_torch_cuda_graph_leftovers import PaddedNet, padded_batches
from tests.test_torch_found_mmimdb import SIZES, SMALL, V2, write_store
from tests.test_torch_found_ntu_train import fx  # noqa: F401
from tests.test_torch_search_population import store  # noqa: F401
from tests.test_torch_step_graphs import (_ntu_run, _same_runs,  # noqa: F401
                                          eager_graphs, force_graphed,
                                          ntu_store, one_thread)


@pytest.fixture(scope="module")
def mm(tmp_path_factory):
    root = tmp_path_factory.mktemp("graph_leftovers_mm")
    write_store(str(root / "data"))
    base = ["--datadir", str(root / "data"), "--checkpointdir", str(root),
            "--train_size", "16", "--dev_size", "8", "--test_size", "8"]
    return dict(root=root, data=str(root / "data"), base=base)


def _no_dropout(net):
    for op in ("op2", "op4"):
        getattr(net.text_net, op)[1].p = 0.0
    return net


# --------------------------------------------------------------------------
# MMIMDBEngine
# --------------------------------------------------------------------------
def test_mmimdb_graphed_engine_matches_jax(mm, eager_graphs, monkeypatch,
                                           capsys):
    args = tmmain.parse_args(mm["base"] + SMALL)
    jnet = _no_dropout(jm.SimpleVTNet(args, 8, 3))
    tree = jnet.init(0)
    flat = {k: np.asarray(v) for k, v in flatten_tree(tree).items()}
    sizes = dict(SIZES)

    def loaders(data, loader):
        return {s: loader(data(mm["data"], stage=s, feat_dim=300,
                               average_text=True, len_data=n), 8,
                          shuffle=(s == "train")) for s, n in SIZES}

    jlosses = []
    jget = JEngine._get_step

    def spy(self, kind, text_len):
        fn = jget(self, kind, text_len)
        if kind != "train":
            return fn

        def step(*a):
            out = fn(*a)
            jlosses.append(float(out[3]))
            return out
        return step

    monkeypatch.setattr(JEngine, "_get_step", spy)
    jeng = JEngine(jnet)
    jl = loaders(JMM_IMDB, JLoader)
    jbest, jtree = jeng.train_track_f1(
        unflatten_tree({k: jnp.asarray(v) for k, v in flat.items()}), None,
        jl, sizes, JFixed(1e-3), 2, verbose=True)
    jtest = jeng.test_track_f1(jtree, jl["test"])
    jout = capsys.readouterr().out

    force_graphed(monkeypatch)
    model = _no_dropout(tmmain.build_model(args, "cpu"))
    model.load_state_dict(state_dict_from_numpy(flat), strict=True)
    eng = MMIMDBEngine(model, "cpu")
    tl = loaders(MM_IMDB, MMIMDBLoader)
    tbest, _ = eng.train_track_f1(None, tl, sizes, FixedScheduler(1e-3), 2,
                                  verbose=True)
    ttest = eng.test_track_f1(tl["test"])
    tout = capsys.readouterr().out

    def dev(out):
        return [ln for ln in out.splitlines() if ln.startswith("epoch #")]

    assert len(dev(tout)) == 2 and dev(tout) == dev(jout)
    assert tbest == jbest and ttest == jtest
    # 2 train batches of 8 per epoch: the epoch loss is their mean
    want = [np.mean(jlosses[i:i + 2]) for i in (0, 2)]
    got = [e["loss"] for e in eng.train_records[0].epochs
           if e["phase"] == "train"]
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert eng.last_eval.acc == ttest and eng.last_eval.clips == 8
    # one train graph and one eval graph (dev and test batches share
    # their shapes), one replay per batch
    assert eager_graphs == {
        "MMIMDBEngine_train": {"captures": 1, "replays": 2 * 2},
        "MMIMDBEngine_eval": {"captures": 1, "replays": 2 + 1}}


CLI_CASES = {"whole_net_dropout": SMALL + ["--epochs", "2"],
             "central_only": V2 + ["--epochs", "2", "--central_only"],
             "stable_bce": SMALL + ["--epochs", "2", "--stable_bce"]}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_mmimdb_cli_graphed_equals_eager(mm, tmp_path, eager_graphs,
                                         monkeypatch, case):
    def run(name):
        out = tmp_path / name
        out.mkdir()
        argv = mm["base"] + CLI_CASES[case] + ["--checkpointdir", str(out),
                                               "--save_checkpoint"]
        return tmmain.main(argv, device="cpu")

    eager = run("eager")
    assert eager_graphs == {}
    force_graphed(monkeypatch)
    graphed = run("graphed")
    _same_runs(graphed, eager)
    want, got = load_state_dict(eager.saved), load_state_dict(graphed.saved)
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert eager_graphs == {
        "MMIMDBEngine_train": {"captures": 1, "replays": 2 * 2},
        "MMIMDBEngine_eval": {"captures": 1, "replays": 2 + 1}}


def _padded_engine(state=None):
    args = tmmain.parse_args([])
    net = PaddedNet(args, "cpu", torch.Generator().manual_seed(0))
    if state is not None:
        net.load_state_dict(state)
    eng = MMIMDBEngine(net, "cpu")
    eng.generator.manual_seed(3)
    net.train()
    return net, eng


def test_two_text_lengths_share_gradients(eager_graphs):
    """Lengths 8 and 16 alternating through one engine: two train graphs
    alive at once on one set of gradients (the address of each stays),
    the dead head without a gradient and unmoved; losses, parameters and
    the dropout stream bitwise the eager engine's; one eval graph per
    length."""
    batches = padded_batches((8, 16, 8, 16, 16, 8), "cpu")
    net, eng = _padded_engine()
    start = snapshot(net)
    eng.graphed = True
    opt = eng.make_optimizer()
    got = [eng.train_step(b, opt, 1e-2)[0] for b in batches]
    prog = eng._programs["train"]
    assert len(prog) == 2
    held = prog._held
    assert set(held) == {p for n, p in net.named_parameters()
                         if not n.startswith("dead.")}
    assert all(p.grad is g for p, g in held.items())
    assert net.dead.weight.grad is None and net.dead.bias.grad is None
    for k in ("dead.weight", "dead.bias"):
        assert torch.equal(net.state_dict()[k], start[k])
    net.eval()
    got_eval = [eng.eval_step(b) for b in batches[:2]]

    ref, reng = _padded_engine(start)
    ropt = reng.make_optimizer()
    want = [reng.train_step(b, ropt, 1e-2)[0] for b in batches]
    ref.eval()
    want_eval = [reng.eval_step(b) for b in batches[:2]]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for (a, pa), (b, pb) in zip(got_eval, want_eval):
        assert torch.equal(a, b) and torch.equal(pa, pb)
    for k, v in ref.state_dict().items():
        assert torch.equal(net.state_dict()[k], v), k
    assert torch.equal(eng.generator.get_state(), reng.generator.get_state())
    assert eager_graphs == {
        "MMIMDBEngine_train": {"captures": 2, "replays": 6},
        "MMIMDBEngine_eval": {"captures": 2, "replays": 2}}


def test_the_25th_graph_warns(eager_graphs):
    net, eng = _padded_engine()
    eng.graphed = True
    opt = eng.make_optimizer()
    batches = padded_batches(range(1, MAX_PROGRAMS + 2), "cpu", B=2)
    with pytest.warns(RuntimeWarning, match="24 distinct"):
        for b in batches:
            eng.train_step(b, opt, 1e-3)
    assert len(eng._programs["train"]) == MAX_PROGRAMS + 1


# --------------------------------------------------------------------------
# --remat
# --------------------------------------------------------------------------
def test_remat_run_graphed_equals_eager(tmp_path, ntu_store, eager_graphs,
                                        monkeypatch):
    """Dropout on (--drpt 0.3): the recomputation inside the captured step
    reuses its segment's masks, as the eager step's does."""
    eager = _ntu_run(tmp_path / "eager", ntu_store, "--epochs", "2",
                     "--remat")
    force_graphed(monkeypatch, remat=True)
    graphed = _ntu_run(tmp_path / "graphed", ntu_store, "--epochs", "2",
                       "--remat")
    _same_runs(graphed, eager)
    assert eager_graphs == {
        "ClassifierEngine_train": {"captures": 2, "replays": 3 * 3},
        "ClassifierEngine_eval": {"captures": 3, "replays": 3 * 2 + 3}}


def test_graphed_remat_step_matches_jax_remat_f64(fx, eager_graphs):  # noqa: F811
    args = ntu_train._args(fx, "--batchnorm")
    jmodel = ntu_train.Searchable_Skeleton_Image_Net(
        args, ntu_train.jmain.FOUND_CONFS[4])
    flat = {k: np.asarray(v) for k, v in flatten_tree(jmodel.init(0)).items()}
    host = ntu_train._host_batch(fx, idx=range(ntu_train.SPLITS["train"]))
    rgb = ntu_train.tpack.make_device_normalize_prep(torch.float64)(
        {"rgb": torch.from_numpy(host["rgb"])})["rgb"].numpy()
    batch = dict(rgb=rgb, ske=host["ske"].astype(np.float64),
                 label=host["label"], _mask=host["_mask"].astype(np.float64))
    lr = 1e-3

    jax.config.update("jax_enable_x64", True)
    try:
        eng = JClassifier(jmodel, multitask=True, input_keys=("rgb", "ske"),
                          remat=True)
        tree = unflatten_tree({k: jnp.asarray(
            v.astype(np.float64) if v.dtype == np.float32 else v)
            for k, v in flat.items()})
        trainable, frozen = split_tree(jmodel, tree, None)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        key = jax.random.PRNGKey(0)

        @jax.checkpoint
        def fwd(tr, b):
            ctx = Ctx(train=True, rng=Rng(key))
            loss, _ = eng._forward(merge(tr, frozen), ctx, b)
            return loss

        jgrads = jax.jit(jax.grad(fwd))(trainable, jb)
        new_tr, new_frozen, _, jloss, _ = eng._train_step(
            trainable, frozen, jadam_init(trainable), jb, jnp.float64(lr),
            key)
        jafter = {k: np.asarray(v) for k, v in flatten_tree(
            merge(new_tr, new_frozen)).items()}
        jgrads = {k: np.asarray(v) for k, v in flatten_tree(jgrads).items()
                  if v is not None}
        jloss = float(jloss)
    finally:
        jax.config.update("jax_enable_x64", False)

    model = ntu_train._port_model(args, flat).double()
    teng = ClassifierEngine(model, "cpu", multitask=args.multitask,
                            input_keys=("rgb", "ske"), remat=True)
    teng.graphed = True
    set_trainable(model, None)
    model.train()
    opt = make_adam(model.parameters(), WEIGHT_DECAY)
    tloss, _ = teng.train_step(ntu_train._torch_batch(batch), opt, lr)
    assert eager_graphs == {"ClassifierEngine_train": {"captures": 1,
                                                        "replays": 1}}
    tgrads = {n: p.grad.numpy() for n, p in model.named_parameters()
              if p.grad is not None}
    tafter = {k: v.numpy() for k, v in model.state_dict().items()}

    np.testing.assert_allclose(float(tloss), jloss, rtol=1e-12)
    alphas = {k for k in jgrads if k.startswith("alphas.")}
    assert set(tgrads) == set(jgrads) - alphas
    for k in tgrads:
        ntu_train._close_to_max(tgrads[k], jgrads[k], (0, 1e-9), k)
    for k, want in jafter.items():
        got = tafter[k]
        if k.startswith("alphas."):
            # torch never steps a grad-None gate (JAX's weight decay does)
            np.testing.assert_array_equal(got, flat[k])
        elif k.endswith("num_batches_tracked"):
            # once per step: the recomputation moved no statistic
            assert int(got) == int(want) == 1
        elif k.endswith(("running_mean", "running_var")):
            ntu_train._close_to_max(got, want, (0, 1e-9), k)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * lr,
                                       err_msg=k)


# --------------------------------------------------------------------------
# the bank's per-step loop
# --------------------------------------------------------------------------
def _bank_search(store_root, args, feature_dtype=None, batchnorm=False,
                 drpt=0.0):
    """A --cache_features --no_fused_epochs population search of
    BANK_CONFS over the store, 2 epochs: (accuracies, params, bn_state)."""
    _, _, tx = spop.jax_extractor(args)
    spec = spop.make_spec(tpop, args, feature_dtype=feature_dtype,
                          batchnorm=batchnorm, drpt=drpt)
    trainer = tpop.PopulationTrainer(
        spec, tx, device="cpu", cache_train_features=True,
        fused_epochs=False,
        input_prep=spop.tpack.make_device_normalize_inputs_prep(
            torch.bfloat16 if feature_dtype else None))
    loaders = spop._loaders(spop.tntu, spop.tpack, spop.tloader, store_root,
                            args)
    sizes = {k: v.dataset_size for k, v in loaders.items()}
    return trainer.train_population(
        spop.BANK_CONFS, loaders, sizes, spop.TSched(1e-3, 1e-6, 1, 2, 2.5),
        2, ("rgb", "ske"), seed=4)


def test_bank_per_step_loop_graphed_equals_eager(store, eager_graphs,  # noqa: F811
                                                 monkeypatch):
    args = spop.small_args(["--drpt", "0.3"])
    kw = dict(batchnorm=True, drpt=0.3)
    monkeypatch.setattr(tpop, "_STREAMED_CACHE", {})
    eager = _bank_search(store, args, **kw)
    assert eager_graphs == {}
    force_graphed(monkeypatch)
    graphed = _bank_search(store, args, **kw)
    assert graphed[0] == eager[0]
    for got, want in zip(graphed[1:], eager[1:]):
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
    # 10 train rows in batches of 4 (3 steps) and 6 dev rows (2 batches),
    # 2 epochs: one capture per program
    assert eager_graphs == {
        "population_train_step": {"captures": 1, "replays": 3 * 2},
        "population_eval_step": {"captures": 1, "replays": 2 * 2}}


def test_graphed_bank_per_step_loop_matches_jax(store, eager_graphs,  # noqa: F811
                                                monkeypatch):
    """A bf16 bank, drpt 0: the accuracies equal the JAX package's
    ``fused_epochs=False`` search's."""
    args = spop.small_args()
    want = spop._run_jax(store, args, "bfloat16", cache_train_features=True,
                         fused_epochs=False)
    force_graphed(monkeypatch)
    got, _, _ = _bank_search(store, args, "bfloat16")
    assert got == want
    assert eager_graphs["population_train_step"]["replays"] == 3 * 2
