"""MM-IMDB training, JAX engine and CLI against the port's, on the CPU.

A tiny store in the reference layout (32x32 posters, (T, 300) GloVe-like
text with T in [5, 30), 23-genre multi-hot labels; 16 train, 8 dev and 8
test samples), --batchsize 8:

* ``simplevt`` at --channels 4 --text_first_hidden 8 with MaxOut_MLP's
  dropout at 0 in both packages (their streams differ), the port's net
  holding the JAX net's initial weights: both CLIs over 2 epochs print the
  same dev F1s, Best dev F1 and Model F1, and their per-batch losses agree
  within rtol 1e-3 (f32 convolutions summed in other orders, then Adam);
  --save_checkpoint writes the JAX CLI's file name, which the JAX package's
  ``load_state_dict`` reads into its net (strict keys, equal values);
  --test_cp of it prints the same Model F1 in both CLIs;
* the default model, ``vggt_centralnet_v2`` at --text_first_hidden 256,
  trained --central_only: every non-central parameter bitwise unchanged;
  its checkpoint loads into the JAX package's VGGT_CentralNetV2 (strict
  keys) and --test_cp prints the same Model F1 in both CLIs;
* the NaN escape: logits pushed to ~40 make the reference BCE NaN for the
  positive labels; both engines print "Nan loss during training, escaping"
  and return 0.0, the port's model back in its initial state;
* one whole-net train step of ``VGGT_CentralNetV2`` through the engine in
  float64 (MaxOut_MLP dropout 0 on both sides): the loss within rtol 1e-12,
  every gradient and BatchNorm statistic within 1e-9 of its tensor's max
  (for the gradients, of at least 1e-6 of the largest one: a few vanish
  analytically and hold rounding noise); the parameters dead in the loss
  get no gradient in torch and exactly 0 in JAX;
* --vgg_cp loads torchvision vgg19 keys into the trunk; the CLI stops
  without CUDA, on the flags it does not carry, on --no-average_text (as
  the JAX CLI) and, with a clear error, at the default --text_first_hidden
  512 with a VGG CentralNet; its parser is the JAX CLI's.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import main_found_mmimdb as jmain
from mfas_tpu.core import flatten_tree, unflatten_tree
from mfas_tpu.core import Ctx, Rng
from mfas_tpu.core import functional as JF
from mfas_tpu.core.module import apply_updates, merge
from mfas_tpu.core.sched import FixedScheduler as JFixed
from mfas_tpu.data.mm_imdb import MM_IMDB as JMM_IMDB
from mfas_tpu.data.mm_imdb import MMIMDBLoader as JLoader
from mfas_tpu.engine.classifier import split_tree
from mfas_tpu.engine.mmimdb import MMIMDBEngine as JEngine
from mfas_tpu.models import mm_imdb as jm
from mfas_tpu.runtime import checkpoint as jckpt
from mfas_tpu_torch import main_found_mmimdb as tmain
from mfas_tpu_torch.core.optim import make_adam
from mfas_tpu_torch.core.sched import FixedScheduler
from mfas_tpu_torch.data.mm_imdb import MM_IMDB, MMIMDBLoader
from mfas_tpu_torch.engine.classifier import snapshot
from mfas_tpu_torch.engine.mmimdb import MMIMDBEngine
from mfas_tpu_torch.models import mm_imdb as tm
from mfas_tpu_torch.runtime.checkpoint import state_dict_from_numpy
from tests import test_torch_mmimdb as M
from tests.test_torch_search_cli import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZES = (("train", 16), ("dev", 8), ("test", 8))
SMALL = ["--model", "simplevt", "--channels", "4", "--text_first_hidden", "8",
         "--batchsize", "8"]
V2 = ["--text_first_hidden", "256", "--channels", "16", "--batchsize", "8"]


def write_store(root, poster=32, seed=0):
    """The reference layout with make_synthetic_mmimdb's distribution, at
    ``poster`` x ``poster``."""
    rs = np.random.RandomState(seed)
    for stage, n in SIZES:
        base = os.path.join(root, stage)
        os.makedirs(base)
        for i in range(n):
            np.save(os.path.join(base, f"image_{i:06}.npy"),
                    rs.rand(poster, poster, 3).astype(np.float32))
            lab = np.zeros(23, np.float32)
            lab[rs.randint(0, 23, 2)] = 1.0
            np.save(os.path.join(base, f"label_{i:06}.npy"), lab)
            np.save(os.path.join(base, f"text_{i:06}.npy"),
                    rs.randn(rs.randint(5, 30), 300).astype(np.float32))


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    root = tmp_path_factory.mktemp("found_mmimdb")
    write_store(str(root / "data"))
    base = ["--datadir", str(root / "data"), "--checkpointdir", str(root),
            "--train_size", "16", "--dev_size", "8", "--test_size", "8"]
    args = tmain.parse_args(base + SMALL)
    jnet = jm.SimpleVTNet(args, 8, 3)
    flat = {k: np.asarray(v) for k, v in flatten_tree(jnet.init(0)).items()}
    return dict(root=root, base=base, args=args, jnet=jnet, flat=flat)


def _no_dropout(net):
    for op in ("op2", "op4"):
        getattr(net.text_net, op)[1].p = 0.0
    return net


def _jax_cli(capsys, argv):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["main_found_mmimdb.py", *argv])
        mp.setattr(jmain, "build_model",
                   lambda args, _b=jmain.build_model: _no_dropout(_b(args)))
        jmain.main()
    return capsys.readouterr().out


def _printed(out):
    """The dev F1 lines and the named F1 lines of a run's output."""
    dev = [ln.split()[-1] for ln in out.splitlines()
           if ln.startswith("epoch #")]
    named = {k: ln[len(k):] for ln in out.splitlines()
             for k in ("Best dev F1: ", "Model F1: ") if ln.startswith(k)}
    return dev, named


_BUILD = tmain.build_model     # before any test patches it


def test_training_cli_matches_jax(fx, monkeypatch, capsys):
    argv = fx["base"] + SMALL + ["--epochs", "2"]
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

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JEngine, "_get_step", spy)
        jdev, jnamed = _printed(_jax_cli(capsys, argv))

    def build(args, device):
        model = _BUILD(args, device)
        model.load_state_dict(state_dict_from_numpy(fx["flat"]), strict=True)
        return _no_dropout(model)

    tlosses = []
    tstep = MMIMDBEngine._train_step

    def tspy(self, *a):
        loss = tstep(self, *a)
        tlosses.append(float(loss))
        return loss

    monkeypatch.setattr(tmain, "build_model", build)
    monkeypatch.setattr(MMIMDBEngine, "_train_step", tspy)
    run = tmain.main(argv + ["--save_checkpoint"], device="cpu")
    out = capsys.readouterr().out
    tdev, tnamed = _printed(out)
    assert len(jdev) == len(tdev) == 2 and tdev == jdev
    assert tnamed == jnamed and len(tnamed) == 2
    assert len(jlosses) == len(tlosses) == 4        # 2 epochs x 2 batches
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-3)
    assert all(np.isfinite(tlosses))
    rec = run.train[0]
    assert [e["phase"] for e in rec.epochs] == ["train", "dev"] * 2
    assert rec.best_acc == float(tnamed["Best dev F1: "])
    assert run.acc == float(tnamed["Model F1: "]) and run.eval.clips == 8

    # the checkpoint: the JAX name, read by the JAX package into its net
    name = f"mmimdb_simplevt_{run.acc:.4f}.checkpoint"
    assert os.path.basename(run.saved) == name and f"Saved {run.saved}" in out
    flat = jckpt.load_state_dict(run.saved)
    mine = torch.load(run.saved, weights_only=True)
    assert flat.keys() == mine.keys() == fx["flat"].keys()
    for k, v in mine.items():
        np.testing.assert_array_equal(flat[k], v.numpy(), err_msg=k)
    jckpt.tree_from_state_dict(flat, fx["jnet"].init(0))     # strict keys

    # --test_cp: no training, the same Model F1 in both CLIs
    monkeypatch.undo()
    test_cp = fx["base"] + SMALL + ["--test_cp", name]
    again = tmain.main(test_cp, device="cpu")
    out = capsys.readouterr().out
    assert again.train == [] and "Best dev F1" not in out
    assert again.acc == run.acc
    assert _printed(_jax_cli(capsys, test_cp))[1] == {
        "Model F1: ": str(run.acc)}


def test_default_model_central_only(fx, monkeypatch, capsys):
    """vggt_centralnet_v2 at --text_first_hidden 256, --central_only."""
    init = {}

    def build(args, device):
        model = _BUILD(args, device)
        init.update(snapshot(model))
        return model

    monkeypatch.setattr(tmain, "build_model", build)
    argv = fx["base"] + V2
    run = tmain.main(argv + ["--epochs", "1", "--central_only",
                             "--save_checkpoint", "--no-verbose"],
                     device="cpu")
    assert os.path.basename(run.saved).startswith("mmimdb_vggt_centralnet_v2_")
    after = torch.load(run.saved, weights_only=True)
    model = _BUILD(tmain.parse_args(argv), "cpu")
    central = tuple(model.central_params())
    moved = set()
    for name, _ in model.named_parameters():
        if name.startswith(central):
            if not torch.equal(after[name], init[name]):
                moved.add(name.split(".")[0])
        else:
            assert torch.equal(after[name], init[name]), name
    # the central column and its gates moved (the classifier's grads reach
    # every central parameter through the sigmoid gates)
    assert moved == set(central)
    assert not torch.equal(after["bn3.running_mean"], init["bn3.running_mean"])

    # the JAX package reads it into its VGGT_CentralNetV2, strict keys
    jnet = jm.VGGT_CentralNetV2(tmain.parse_args(argv), 256, 3)
    template = jax.eval_shape(lambda: jnet.init(0))
    flat = jckpt.load_state_dict(run.saved)
    tree = jckpt.tree_from_state_dict(flat, template)
    assert flatten_tree(tree).keys() == after.keys()

    monkeypatch.undo()
    test_cp = argv + ["--test_cp", os.path.basename(run.saved)]
    capsys.readouterr()
    again = tmain.main(test_cp, device="cpu")
    assert again.acc == run.acc
    assert _printed(_jax_cli(capsys, test_cp))[1] == {
        "Model F1: ": str(run.acc)}


def _loaders(pkg_mm, pkg_loader, root):
    return {stage: pkg_loader(pkg_mm(str(root / "data"), stage=stage,
                                     average_text=True, len_data=n), 8,
                              shuffle=stage == "train")
            for stage, n in SIZES[:2]}


def test_nan_escape_matches_jax(fx, capsys):
    """The classifier's bias at 40: sigmoid rounds to 1, so every positive
    label's term is 0 * log(0) = NaN in both packages (far from the
    -88.72..-87.34 band where they differ)."""
    flat = dict(fx["flat"])
    flat["classifier.bias"] = np.full_like(flat["classifier.bias"], 40.0)
    sizes = {"train": 16, "dev": 8}
    jeng = JEngine(_no_dropout(fx["jnet"]))
    jf1, _ = jeng.train_track_f1(
        unflatten_tree({k: jnp.asarray(v) for k, v in flat.items()}), None,
        _loaders(JMM_IMDB, JLoader, fx["root"]), sizes, JFixed(1e-3),
        num_epochs=2, verbose=True)
    jout = capsys.readouterr().out

    model = _no_dropout(_BUILD(fx["args"], "cpu"))
    model.load_state_dict(state_dict_from_numpy(flat), strict=True)
    start = snapshot(model)
    eng = MMIMDBEngine(model, "cpu")
    f1, _ = eng.train_track_f1(None, _loaders(MM_IMDB, MMIMDBLoader,
                                              fx["root"]),
                               sizes, FixedScheduler(1e-3), num_epochs=2,
                               verbose=True)
    out = capsys.readouterr().out
    line = "Nan loss during training, escaping"
    assert line in jout and line in out and "F1:" not in out + jout
    assert f1 == jf1 == 0.0
    assert np.isnan(eng.train_records[0].epochs[0]["loss"])
    for k, v in model.state_dict().items():
        assert torch.equal(v, start[k]), k


def test_vgg_cp_loads_the_trunk(fx, tmp_path):
    from mfas_tpu_torch.models.vgg import vgg19_features

    src = vgg19_features(device="cpu", generator=torch.Generator()
                         .manual_seed(7))
    tv = {f"features.{k}": v for k, v in src.state_dict().items()}
    tv["classifier.0.weight"] = torch.zeros(2, 3)
    torch.save(tv, tmp_path / "vgg19.pth")
    args = tmain.parse_args(V2)
    model = tmain.build_model(args, "cpu")
    tmain.load_vgg_trunk(model, str(tmp_path / "vgg19.pth"))
    for k, v in src.state_dict().items():
        assert torch.equal(model.state_dict()[f"image_net.vgg.{k}"], v)
    with pytest.raises(SystemExit, match="no VGG trunk"):
        tmain.load_vgg_trunk(tmain.build_model(fx["args"], "cpu"),
                             str(tmp_path / "vgg19.pth"))


# the multi-GPU flags are ported (parallel/mesh.py; the engine on two
# ranks in tests/test_torch_engine_parallel.py): on a card-less command
# line they stop for want of CUDA like any other, and a --dist_* trio that
# cannot form a group stops with a ValueError naming the missing flag
@pytest.mark.parametrize("extra, what", [
    ([], "needs a CUDA device"),
    (["--use_dataparallel"], "needs a CUDA device"),
    (["--dist_coordinator", "localhost:1234"], "dist_num_processes"),
    (["--dist_num_processes", "2"], "dist_coordinator"),
])
def test_cli_guards(fx, extra, what, monkeypatch):
    if what.startswith("dist_"):
        with pytest.raises(ValueError, match=what):
            tmain.main(fx["base"] + SMALL + extra, device="cpu")
    else:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(SystemExit) as e:
            tmain.main(fx["base"] + SMALL + extra)
        assert what in str(e.value)


def test_no_average_text_and_wide_text_stop(fx, monkeypatch, capsys):
    argv = fx["base"] + SMALL + ["--no-average_text"]
    with pytest.raises(SystemExit) as mine:
        tmain.main(argv, device="cpu")
    monkeypatch.setattr(sys, "argv", ["main_found_mmimdb.py", *argv])
    with pytest.raises(SystemExit) as want:
        jmain.main()
    assert str(mine.value) == str(want.value)
    assert "--no-average_text" in str(mine.value)
    # the default model at the default --text_first_hidden 512
    with pytest.raises(ValueError, match="--text_first_hidden 512"):
        tmain.main(fx["base"], device="cpu")


def test_parser_matches_the_jax_cli(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["main_found_mmimdb.py"])
    got = vars(tmain.parse_args([]))
    assert got == vars(jmain.parse_args())
    assert (got["model"], got["channels"], got["text_first_hidden"],
            got["batchsize"], got["fusingmix"], got["fusetype"],
            got["pos_weight"], got["th_fscore"], got["epochs"],
            got["average_text"]) == ("vggt_centralnet_v2", 512, 512, 64,
                                     "13,24", "cat", 2.0, 0.3, 50, True)
    assert not tmain.parse_args(["--no-average_text"]).average_text


# --------------------------------------------------------------------------
# one whole-net train step of the default model, float64
# --------------------------------------------------------------------------
def test_v2_train_step_matches_jax_f64():
    args = M._args()
    jnet = jm.VGGT_CentralNetV2(args, 256, 3)
    flat = M._flat(jnet)
    tnet = M._port(tm.VGGT_CentralNetV2(args, 256, 3, device="cpu",
                                        generator=M.GEN().manual_seed(0)),
                   flat)
    M._no_dropout(jnet, tnet)
    rs = np.random.RandomState(4)
    batch = {"text": M._text(4).astype(np.float64),
             "image": M._posters(4).astype(np.float64),
             "label": (rs.rand(4, 23) > 0.7).astype(np.float64),
             "_mask": np.array([1.0, 1.0, 1.0, 0.0])}
    jax.config.update("jax_enable_x64", True)
    try:
        jeng = JEngine(jnet)
        trainable, frozen = split_tree(jnet, unflatten_tree({
            k: jnp.asarray(v.astype(np.float64) if v.dtype == np.float32
                           else v) for k, v in flat.items()}))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}

        def loss_fn(tr):
            ctx = Ctx(train=True, rng=Rng(0))
            per = JF.weighted_bce_elements(
                jeng._forward(merge(tr, frozen), ctx, jb), jb["label"], 2.0)
            loss = jnp.sum(jnp.mean(per, axis=1) * jb["_mask"]) \
                / jnp.maximum(jnp.sum(jb["_mask"]), 1.0)
            return loss, ctx.updates

        (jloss, updates), jgrads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(trainable)
        jloss = float(jloss)
        jgrads = {k: np.asarray(v) for k, v in flatten_tree(jgrads).items()
                  if v is not None}
        jafter = {k: np.asarray(v) for k, v in flatten_tree(apply_updates(
            merge(trainable, frozen), updates)).items()}
    finally:
        jax.config.update("jax_enable_x64", False)

    tnet = tnet.double()
    eng = MMIMDBEngine(tnet, "cpu")
    tnet.train()
    opt = make_adam(tnet.parameters(), 1e-4)
    tloss = eng._train_step({k: torch.from_numpy(v) for k, v in
                             batch.items()}, opt, 1e-3)
    tgrads = {n: p.grad.numpy() for n, p in tnet.named_parameters()
              if p.grad is not None}
    np.testing.assert_allclose(float(tloss), jloss, rtol=1e-12)
    # dead in the loss: the unimodal heads, the taps fusingmix '13,24'
    # leaves out (bn1, bn2) and the never-run bnc1/bnc2; no gradient in
    # torch, exactly 0 in JAX
    dead = set(jgrads) - set(tgrads)
    assert dead == {f"{m}.{p}" for m in (
        "image_net.bn4", "image_net.classifier", "text_net.op4.0",
        "text_net.hid2val", "bn1", "bn2", "bnc1", "bnc2")
        for p in ("weight", "bias")}
    assert all(not jgrads[k].any() for k in dead)
    assert "image_net.vgg.0.weight" in tgrads and "alpha_conv2" in tgrads
    # floor: a few tensors' gradients vanish analytically (train-mode
    # BatchNorm after the tap) and hold rounding noise of ~1e-18
    scale = max(np.abs(g).max() for g in jgrads.values())
    for k in tgrads:
        M._close(tgrads[k], jgrads[k], (0, 1e-9), k, floor=1e-6 * scale)
    tafter = {k: v.numpy() for k, v in tnet.state_dict().items()}
    for k in ("bn3.running_mean", "bn4.running_var",
              "text_net.op2.0.running_var", "image_net.bn4.running_mean"):
        M._close(tafter[k], jafter[k], (0, 1e-9), k)
        assert not np.array_equal(tafter[k], flat[k])
