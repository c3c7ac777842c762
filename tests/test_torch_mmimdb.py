"""The MM-IMDB modules, JAX package against the port, on the CPU.

With the JAX modules' initial weights carried into the port
(``state_dict_from_numpy``, strict keys):

* ``Maxout``, ``GRU`` (both layouts; a step's output does not depend on
  later steps), ``MaxOut_MLP`` (eval and train mode, with the BatchNorm
  statistics it leaves) and ``SimpleRecurrentModel`` (the last valid step
  of each padded sequence; padding beyond a length moves nothing);
* ``GP_VGG`` on 32x32 posters, eval and train mode, its taps, logits and
  BatchNorm statistics; the VGG-19 trunk's torchvision indices and
  ``remap_torchvision_vgg_keys``;
* the five nets of the CLI's --model, both fusetypes for the CentralNets;
  both VGG CentralNets fail at --text_first_hidden 512 in both packages;
* the weighted BCE in the reference and the stable form, NaN included;
  ``samples_f1`` against a hand count;
* ``make_synthetic_mmimdb``, ``MM_IMDB``, the transforms and
  ``MMIMDBLoader`` (averaged and padded text) bitwise.

Tolerances: f32 outputs rtol 1e-4 and atol 1e-4 of each tensor's max (XLA
and oneDNN sum the convolutions in other orders; 1e-6 for the conv-free
layers). BCE: rtol 1e-6, NaN at the same positions. Data: exact.

The reference BCE NaNs where f32 sigmoid saturates: at x >= ~17 for a
positive label in both packages, and below x ~ -88.72 for a negative one.
Between -88.72 and -87.34 XLA flushes sigmoid's subnormal output to 0 (NaN
in JAX) while torch keeps it (finite): that band is an expected difference
and is not tested.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfas_tpu.core import Ctx, Rng, flatten_tree, unflatten_tree
from mfas_tpu.core import functional as JF
from mfas_tpu.core import layers as JL
from mfas_tpu.core.module import apply_updates, merge
from mfas_tpu.core.rnn import GRU as JGRU
from mfas_tpu.data import mm_imdb as jdata
from mfas_tpu.engine.classifier import split_tree
from mfas_tpu.engine.mmimdb import MMIMDBEngine as JEngine
from mfas_tpu.models import mm_imdb as jm
from mfas_tpu.models import vgg as jvgg
from mfas_tpu_torch.core import functional as TF
from mfas_tpu_torch.core import layers as TL
from mfas_tpu_torch.core.optim import make_adam
from mfas_tpu_torch.core.rnn import GRU
from mfas_tpu_torch.data import mm_imdb as tdata
from mfas_tpu_torch.engine.classifier import set_trainable
from mfas_tpu_torch.engine.mmimdb import MMIMDBEngine
from mfas_tpu_torch.models import mm_imdb as tm
from mfas_tpu_torch.models import vgg as tvgg
from mfas_tpu_torch.runtime.checkpoint import state_dict_from_numpy
from tests.test_torch_search_cli import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GEN = torch.Generator
POSTER = 32      # VGG-19's five pools take 32x32 to 1x1


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: under a parallel test runner every split op
    waits on threads the other workers' processes hold."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _args(**kw):
    d = dict(num_outputs=23, channels=16, fusetype="cat", fusingmix="13,24")
    d.update(kw)
    return types.SimpleNamespace(**d)


def _flat(jnet):
    return {k: np.asarray(v) for k, v in flatten_tree(jnet.init(0)).items()}


def _tree(flat):
    return unflatten_tree({k: jnp.asarray(v) for k, v in flat.items()})


def _port(tnet, flat):
    assert set(tnet.state_dict()) == set(flat)
    tnet.load_state_dict(state_dict_from_numpy(flat), strict=True)
    return tnet


def _close(got, want, rel=(1e-4, 1e-4), what="", floor=1e-30):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=rel[0],
                               atol=rel[1] * max(np.abs(want).max(), floor),
                               err_msg=what)


def _outs(x):
    return [np.asarray(o.detach().numpy() if torch.is_tensor(o) else o)
            for o in (x if isinstance(x, (tuple, list)) else (x,))]


def _text(n=4, seed=0):
    return np.random.RandomState(seed).randn(n, 300).astype(np.float32)


def _posters(n=2, seed=1, size=POSTER):
    rs = np.random.RandomState(seed)
    return rs.rand(n, 3, size, size).astype(np.float32)


def _no_dropout(jnet, tnet):
    """MaxOut_MLP's two dropouts to p=0 in both packages (their streams
    differ)."""
    for j, t in ((jnet, tnet) if hasattr(jnet, "op2")
                 else (jnet.text_net, tnet.text_net)),:
        for op in ("op2", "op4"):
            getattr(j, op)[1].p = 0.0
            getattr(t, op)[1].p = 0.0


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------
def test_maxout_matches_jax():
    jnet = JL.Maxout(12, 5, 3)
    flat = _flat(jnet)
    assert set(flat) == {"lin.weight", "lin.bias"}
    tnet = _port(TL.Maxout(12, 5, 3, device="cpu",
                           generator=GEN().manual_seed(0)), flat)
    x = np.random.RandomState(0).randn(4, 12).astype(np.float32)
    want = np.asarray(jnet(_tree(flat), Ctx(), jnp.asarray(x)))
    got = tnet(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (4, 5)
    _close(got, want, (1e-6, 1e-6))


@pytest.mark.parametrize("steps,cut", [(7, 4), (8, 1)])
def test_gru_matches_jax(steps, cut):
    """Batch-first (the layout SimpleRecurrentModel runs) within 1e-6;
    changing the input after step ``cut`` leaves the first ``cut`` steps'
    outputs bitwise alone."""
    jnet = JGRU(6, 5, batch_first=True)
    flat = _flat(jnet)
    tnet = _port(GRU(6, 5, device="cpu", generator=GEN().manual_seed(0)),
                 flat)
    x = np.random.RandomState(2).randn(3, steps, 6).astype(np.float32)
    jout, jh = jnet(_tree(flat), Ctx(), jnp.asarray(x))
    with torch.no_grad():
        tout, th = tnet(torch.from_numpy(x))
    assert tout.shape == (3, steps, 5) and th.shape == (3, 5)
    _close(tout.numpy(), jout, (1e-6, 1e-6))
    _close(th.numpy(), jh, (1e-6, 1e-6))
    x2 = x.copy()
    x2[:, cut:] = -10.0
    with torch.no_grad():
        tout2, _ = tnet(torch.from_numpy(x2))
    torch.testing.assert_close(tout2[:, :cut], tout[:, :cut], rtol=0, atol=0)


@pytest.mark.parametrize("train", [False, True])
def test_maxout_mlp_matches_jax(train):
    args = _args()
    jnet = jm.MaxOut_MLP(args, 32)
    flat = _flat(jnet)
    assert flat["op1.lin.weight"].shape == (160, 300)
    tnet = _port(tm.MaxOut_MLP(args, 32, device="cpu",
                               generator=GEN().manual_seed(0)), flat)
    _no_dropout(jnet, tnet)
    TL.set_dropout_generator(tnet, GEN().manual_seed(1))
    x = _text()
    ctx = Ctx(train=train, rng=Rng(0))
    want = _outs(jnet(_tree(flat), ctx, jnp.asarray(x)))
    tnet.train(train)
    with torch.no_grad():
        got = _outs(tnet(torch.from_numpy(x)))
    assert [g.shape for g in got] == [(4, 32), (4, 64), (4, 23)]
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, (1e-5, 1e-5), f"output {i}")
    if train:
        after = flatten_tree(apply_updates(_tree(flat), ctx.updates))
        for k in ("op2.0.running_mean", "op4.0.running_var"):
            _close(tnet.state_dict()[k].numpy(), after[k], (1e-5, 1e-5), k)
            assert not np.array_equal(tnet.state_dict()[k].numpy(), flat[k])


def test_simple_recurrent_model_matches_jax():
    args = _args(num_outputs=7)
    jnet = jm.SimpleRecurrentModel(args, num_hidden=16, number_input_feats=10)
    flat = _flat(jnet)
    assert "embedding1.weight_ih_l0" in flat
    tnet = _port(tm.SimpleRecurrentModel(
        args, num_hidden=16, number_input_feats=10, device="cpu",
        generator=GEN().manual_seed(0)), flat)
    x = np.random.RandomState(0).randn(3, 12, 10).astype(np.float32)
    lens = np.array([12, 5, 1], np.int32)
    x[1, 5:] = x[2, 1:] = tdata.TEXT_PAD_VALUE
    want = np.asarray(jnet(_tree(flat), Ctx(), jnp.asarray(x),
                           jnp.asarray(lens)))
    tnet.eval()
    with torch.no_grad():
        got = tnet(torch.from_numpy(x), torch.from_numpy(lens)).numpy()
        x2 = x.copy()
        x2[1, 6:] = 99.0
        again = tnet(torch.from_numpy(x2), lens).numpy()
    assert got.shape == (3, 7)
    _close(got, want, (1e-5, 1e-5))
    np.testing.assert_array_equal(again[1], got[1])
    # train mode: dropout between the GRUs, from the engine's generator
    tnet.train()
    with pytest.raises(RuntimeError, match="generator"):
        tnet(torch.from_numpy(x), lens)
    TL.set_dropout_generator(tnet, GEN().manual_seed(1))
    with torch.no_grad():
        dropped = tnet(torch.from_numpy(x), lens).numpy()
    assert np.isfinite(dropped).all() and not np.allclose(dropped, got)


# --------------------------------------------------------------------------
# the VGG trunk
# --------------------------------------------------------------------------
def test_vgg_trunk_indices_and_remap():
    assert tvgg.VGG19_CFG == jvgg.VGG19_CFG
    feats = tvgg.vgg19_features(device="cpu", generator=GEN().manual_seed(0))
    convs = [i for i, m in enumerate(feats) if isinstance(m, TL.Conv2d)]
    assert convs == [0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32,
                     34]
    assert len(feats) == 37 and isinstance(feats[36], TL.MaxPool2d)
    rs = np.random.RandomState(0)
    fake = {f"features.{i}.{p}": rs.randn(2).astype(np.float32)
            for i in convs[:3] for p in ("weight", "bias")}
    fake["classifier.0.weight"] = rs.randn(3, 2).astype(np.float32)
    for prefix in ("vgg", "image_net.vgg"):
        got = tvgg.remap_torchvision_vgg_keys(fake, prefix)
        want = jvgg.remap_torchvision_vgg_keys(fake, prefix)
        assert got.keys() == want.keys() and f"{prefix}.5.bias" in got
        assert all(got[k] is want[k] for k in got)


@pytest.mark.parametrize("train", [False, True])
def test_gp_vgg_matches_jax(train):
    args = _args()
    jnet = jm.GP_VGG(args)
    flat = _flat(jnet)
    assert flat["vgg.34.weight"].shape == (512, 512, 3, 3)
    tnet = _port(tm.GP_VGG(args, device="cpu",
                           generator=GEN().manual_seed(0)), flat)
    x = _posters(2)
    ctx = Ctx(train=train, rng=Rng(0))
    want = _outs(jnet(_tree(flat), ctx, jnp.asarray(x)))
    tnet.train(train)
    with torch.no_grad():
        got = _outs(tnet(torch.from_numpy(x)))
    assert [g.shape for g in got] == [(2, 512)] * 4 + [(2, 23)]
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, what=f"output {i}")
    if train:
        after = flatten_tree(apply_updates(_tree(flat), ctx.updates))
        for k in ("bn4.running_mean", "bn4.running_var"):
            _close(tnet.state_dict()[k].numpy(), after[k], what=k)
        assert int(tnet.state_dict()["bn4.num_batches_tracked"]) == 1


# --------------------------------------------------------------------------
# the five nets of --model
# --------------------------------------------------------------------------
# --text_first_hidden shared where the nets allow it: fewer shapes for XLA
# to compile
NETS = [
    ("SimpleVTNet", dict(channels=4), 192, 3),
    ("VGGVTNet", {}, 256, 3),
    # the central classifier is 384 wide (x2 under cat): the text net's
    # second output at --text_first_hidden 192 ('13,25' taps gp2, gp5)
    ("SimpleVT_CentralNet", dict(channels=4, fusingmix="13,25"), 192, 3),
    ("SimpleVT_CentralNet", dict(channels=4, fusingmix="11,23",
                                 fusetype="wsum"), 128, 3),
    ("VGGT_CentralNet", {}, 256, 3),
    ("VGGT_CentralNet", dict(fusingmix="11,24", fusetype="wsum"), 128, 3),
    ("VGGT_CentralNetV2", {}, 256, 3),
    ("VGGT_CentralNetV2", dict(fusingmix="12,24", fusetype="wsum"), 128, 3),
]


@pytest.mark.parametrize("name, kw, tfh, n_out", NETS,
                         ids=[f"{n}-{k.get('fusetype', 'cat')}"
                              for n, k, _, _ in NETS])
def test_nets_match_jax(name, kw, tfh, n_out):
    args = _args(**kw)
    jnet = getattr(jm, name)(args, tfh, 3)
    flat = _flat(jnet)
    tnet = _port(getattr(tm, name)(args, tfh, 3, device="cpu",
                                   generator=GEN().manual_seed(0)), flat)
    text, image = _text(2), _posters(2)
    want = _outs(jnet(_tree(flat), Ctx(), jnp.asarray(text),
                      jnp.asarray(image)))
    tnet.eval()
    with torch.no_grad():
        got = _outs(tnet(torch.from_numpy(text), torch.from_numpy(image)))
    central = "Central" in name
    assert len(got) == len(want) == (3 if central else 1)
    assert got[-1].shape == (2, 23)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, what=f"{name} output {i}")
    assert tnet.central_params() == jnet.central_params()
    if name == "VGGT_CentralNetV2":
        assert flat["alpha1_feat1"].shape == (1, 512)
        assert flat["alpha_conv1"].shape == (1, args.channels)
        assert not flat["alpha1_feat1"].any()
    elif central:
        assert flat["alpha1_feat1"].shape == (1,)


@pytest.mark.parametrize("name", ["VGGT_CentralNet", "VGGT_CentralNetV2"])
def test_vgg_centralnets_need_text_first_hidden_256(name):
    """At the CLI's default --text_first_hidden 512 the text net's second
    output is 1024 wide against the 512-d taps: JAX fails at the first
    forward, the port at construction, naming the flag."""
    args = _args()
    jnet = getattr(jm, name)(args, 512, 3)
    with pytest.raises(TypeError):      # traced, not run
        jax.eval_shape(lambda: jnet(jnet.init(0), Ctx(), jnp.asarray(
            _text(2)), jnp.asarray(_posters(2))))
    with pytest.raises(ValueError, match="--text_first_hidden 512"):
        getattr(tm, name)(args, 512, 3, device="cpu",
                          generator=GEN().manual_seed(0))


# --------------------------------------------------------------------------
# loss and metric
# --------------------------------------------------------------------------
@pytest.mark.parametrize("stable", [False, True])
def test_weighted_bce_matches_jax(stable):
    rs = np.random.RandomState(0)
    logits = (rs.randn(5, 8) * 4).astype(np.float32)
    logits[0, :4] = [20.0, 20.0, -110.0, -110.0]
    targets = (rs.rand(5, 8) > 0.5).astype(np.float32)
    targets[0, :4] = [1.0, 0.0, 1.0, 0.0]
    want = np.asarray(JF.weighted_bce_elements(
        jnp.asarray(logits), jnp.asarray(targets), 2.0, stable=stable))
    got = TF.weighted_bce_elements(torch.from_numpy(logits),
                                   torch.from_numpy(targets), 2.0,
                                   stable=stable).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    nan = np.zeros_like(got, bool)
    if not stable:
        # sigmoid(20) rounds to 1: 0 * log(0) for the positive label; at
        # -110 exp overflows: 0 * log(0) for the negative one
        nan[0, [0, 3]] = True
    np.testing.assert_array_equal(np.isnan(got), nan)
    ok = ~nan
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-6, atol=1e-6)
    mean = float(TF.weighted_bce_with_logits(torch.from_numpy(logits),
                                             torch.from_numpy(targets), 2.0,
                                             stable=stable))
    jmean = float(JF.weighted_bce_with_logits(
        jnp.asarray(logits), jnp.asarray(targets), 2.0, stable=stable))
    assert np.isnan(mean) == np.isnan(jmean) == (not stable)
    if stable:
        assert mean == pytest.approx(jmean, rel=1e-6)
        loss = tm.WeightedCrossEntropyWithLogits(2.0)(
            torch.from_numpy(logits[1:]), torch.from_numpy(targets[1:]))
        assert float(loss) == pytest.approx(float(np.mean(got[1:])),
                                            rel=1e-6)


def test_samples_f1_hand_count():
    y_true = np.array([[1, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 0],
                       [1, 1, 1, 1]], bool)
    y_pred = np.array([[1, 1, 0, 0], [0, 1, 0, 0], [1, 0, 0, 0],
                       [0, 0, 0, 0]], bool)
    # row F1s: p=1/2 r=1/2 -> 1/2; 1; no true labels -> 0; no preds -> 0
    assert tdata.samples_f1(y_true, y_pred) == 0.375
    assert jdata.samples_f1(y_true, y_pred) == 0.375
    rs = np.random.RandomState(0)
    a, b = rs.rand(50, 23) > 0.7, rs.rand(50, 23) > 0.6
    assert tdata.samples_f1(a, b) == jdata.samples_f1(a, b)


# --------------------------------------------------------------------------
# data and loader
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = tmp_path_factory.mktemp("mmimdb_data")
    for pkg, sub in ((jdata, "j"), (tdata, "t")):
        pkg.make_synthetic_mmimdb(str(root / sub), "train", n=8,
                                  feat_dim=300, seed=3)
    return root


def test_synthetic_store_matches_jax(stores):
    names = sorted(p.name for p in (stores / "j" / "train").iterdir())
    assert names == sorted(p.name for p in (stores / "t" / "train").iterdir())
    assert len(names) == 24
    for n in names:
        np.testing.assert_array_equal(np.load(stores / "t" / "train" / n),
                                      np.load(stores / "j" / "train" / n))
    assert tdata.SPLIT_SIZES == jdata.SPLIT_SIZES
    assert tdata.TEXT_PAD_VALUE == jdata.TEXT_PAD_VALUE == -10.0

    sample = tdata.MM_IMDB(str(stores / "t"), len_data=8)[2]
    norm = ([0.4, 0.5, 0.6], [0.2, 0.3, 0.25])
    chw = {**sample, "image": sample["image"].transpose(2, 1, 0)}
    for k, v in tdata.Normalize(*norm)(chw).items():
        np.testing.assert_array_equal(v, jdata.Normalize(*norm)(chw)[k])
    mine, want = (pkg.RandomModalityMuting(0.5, seed=4)
                  for pkg in (tdata, jdata))
    for _ in range(6):
        a, b = mine(sample), want(sample)
        for k in sample:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("average_text", [True, False])
def test_loader_batches_equal_jax(stores, average_text):
    loaders = []
    for pkg, sub in ((tdata, "t"), (jdata, "j")):
        ds = pkg.MM_IMDB(str(stores / sub), stage="train", feat_dim=300,
                         average_text=average_text, len_data=7)
        loaders.append(pkg.MMIMDBLoader(ds, 3, shuffle=True, seed=5))
    mine, want = loaders
    assert (len(mine), mine.dataset_size) == (3, 7)
    for _ in range(2):          # two epochs: the shuffle moves on
        got, exp = list(mine), list(want)
        assert len(got) == len(exp) == 3
        for g, w in zip(got, exp):
            assert set(g) == set(w) == {"image", "text", "label", "textlen",
                                        "_mask"}
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        last = got[-1]
        np.testing.assert_array_equal(last["_mask"], [1, 0, 0])
        assert last["image"].shape == (3, 3, 256, 160)
        np.testing.assert_array_equal(last["image"][2], last["image"][0])
        if average_text:
            assert last["text"].shape == (3, 300)
        else:
            t, n = last["text"], last["textlen"]
            assert t.shape[1] in (8, 16, 32) and t.shape[1] >= n.max()
            assert (t[0, n[0]:] == -10.0).all()
            assert (t[0, :n[0]] != -10.0).all()


# --------------------------------------------------------------------------
# one whole-net train step of the other nets, float64
# --------------------------------------------------------------------------
# (net, args, --text_first_hidden, init seed): SimpleVT_CentralNet's
# central conv1ds have 3 weights each; seed 0 draws conv2's all negative
# over conv1's nonnegative ReLU output, which leaves every gradient below
# the classifier's zero, so it runs from seed 5 (all six positive)
TRAIN_NETS = [
    ("VGGVTNet", {}, 256, 0),
    ("VGGT_CentralNet", {}, 256, 0),
    ("SimpleVT_CentralNet", dict(channels=4, fusingmix="13,25"), 192, 5),
    ("VGGT_CentralNet", dict(fusingmix="11,24", fusetype="wsum"), 128, 0),
]


# on 32x32 posters VGG-19's last block runs on 2x2 maps, max-pooled to the
# gp4 tap ahead of train-mode BatchNorms: its conv biases' gradients vanish
# (as conv 34's does in the V2 step, test_torch_found_mmimdb.py)
VGG_LAST_BLOCK_BIASES = {f"image_net.vgg.{i}.bias" for i in (28, 30, 32, 34)}


@pytest.mark.parametrize("name, kw, tfh, seed", TRAIN_NETS,
                         ids=[f"{n}-{k.get('fusetype', 'cat')}"
                              for n, k, _, _ in TRAIN_NETS])
def test_net_train_step_matches_jax_f64(name, kw, tfh, seed):
    """One whole-net train step (text-net dropout 0) on 4 posters in
    float64: the loss within 1e-12 relative, every gradient within 1e-9 of
    its tensor's max, the same dead parameters (no gradient in torch,
    exactly 0 in JAX) and the same BatchNorm statistics. A tensor whose
    gradient vanishes analytically (below 1e-12 of the step's largest in
    JAX: rounding noise) is named and must vanish in the port too."""
    args = _args(**kw)
    jnet = getattr(jm, name)(args, tfh, 3)
    flat = {k: np.asarray(v)
            for k, v in flatten_tree(jnet.init(seed)).items()}
    tnet = _port(getattr(tm, name)(args, tfh, 3, device="cpu",
                                   generator=GEN().manual_seed(0)), flat)
    _no_dropout(jnet, tnet)
    rs = np.random.RandomState(4)
    batch = {"text": _text(4).astype(np.float64),
             "image": _posters(4).astype(np.float64),
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
    set_trainable(tnet, None)
    tnet.train()
    opt = make_adam(tnet.parameters(), 1e-4)
    tloss = eng._train_step({k: torch.from_numpy(v) for k, v in
                             batch.items()}, opt, 1e-3)
    tgrads = {n: p.grad.numpy() for n, p in tnet.named_parameters()
              if p.grad is not None}
    np.testing.assert_allclose(float(tloss), jloss, rtol=1e-12)
    dead = set(jgrads) - set(tgrads)
    assert all(not jgrads[k].any() for k in dead)
    assert set(tgrads) <= set(jgrads) and "text_net.op1.lin.weight" in tgrads
    largest = max(np.abs(g).max() for g in jgrads.values())
    vanishing = {k for k in tgrads
                 if np.abs(jgrads[k]).max() < 1e-12 * largest}
    assert vanishing == (VGG_LAST_BLOCK_BIASES if "VGG" in name else set())
    for k in vanishing:
        assert np.abs(tgrads[k]).max() < 1e-12 * largest, k
    for k in set(tgrads) - vanishing:
        _close(tgrads[k], jgrads[k], (0, 1e-9), k)
    tafter = {k: v.numpy() for k, v in tnet.state_dict().items()}
    moved = 0
    for k, v in tafter.items():
        if k.endswith(("running_mean", "running_var")):
            layer = k.rsplit(".", 1)[0]
            scale = max(np.abs(jafter[f"{layer}.{s}"]).max()
                        for s in ("running_mean", "running_var"))
            np.testing.assert_allclose(v, jafter[k], rtol=0,
                                       atol=1e-9 * scale, err_msg=k)
            moved += not np.array_equal(v, flat[k])
    assert moved
