"""The AV-MNIST modules, JAX package against the port, on the CPU.

At --channels 4 on a few samples of 28x28 digits and 112x112 spectrograms,
with the JAX nets' initial weights carried into the port
(``state_dict_from_numpy``):

* GP_LeNet and GP_LeNet_Deeper: logits and every tap (gp1 pre-pool in
  GP_LeNet, post-pool in GP_LeNet_Deeper), in eval mode and in train mode
  with the BatchNorm running statistics they leave;
* the baselines: SimpleAVNet, SimpleAVNet_Deeper, and SimpleAV_CentralNet
  over both fusetypes and the three fusingmix values; ``fuse_features`` in
  every size case, the reference's a1-on-both-sides wsum included;
* Searchable_Audio_Image_Net for FOUND_CONFS 0-2, single and multitask:
  state_dict keys equal to the JAX tree's, the outputs equal;
* one train step of both phases through ``ClassifierEngine`` (AV-MNIST's
  (image, audio) order, the three-head multitask loss), in f32 and in f64;
* ``load_avmnist_arrays``, ``make_synthetic_avmnist``, the transforms and
  ``ArrayLoader`` (batches, masks, the padded last batch, the RNG state).

Tolerances: f32 forwards rtol 1e-4 and atol 1e-4 of each tensor's max
(XLA and oneDNN sum the convolutions in other orders); the f32 train step:
loss rtol 1e-4, gradients rtol 1e-4 / atol 1e-4 of max (a weight gradient
sums B*H*W terms); the f64 step: loss rtol 1e-12, gradients and BatchNorm
buffers within 1e-9 of each tensor's max. Data and loaders: exact.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import main_found_avmnist as jmain
from mfas_tpu.core import Ctx, Rng, flatten_tree, unflatten_tree
from mfas_tpu.core.module import apply_updates, merge
from mfas_tpu.data import avmnist as jdata
from mfas_tpu.data.loader import ArrayLoader as JArrayLoader
from mfas_tpu.engine.classifier import ClassifierEngine as JEngine
from mfas_tpu.engine.classifier import split_tree
from mfas_tpu.fusion import avmnist as jfav
from mfas_tpu.models import avmnist as jmav
from mfas_tpu_torch import main_found_avmnist as tmain
from mfas_tpu_torch.core.optim import make_adam
from mfas_tpu_torch.data import avmnist as tdata
from mfas_tpu_torch.data.loader import ArrayLoader
from mfas_tpu_torch.engine.classifier import (WEIGHT_DECAY, ClassifierEngine,
                                              set_trainable)
from mfas_tpu_torch.fusion import avmnist as tfav
from mfas_tpu_torch.models import avmnist as tmav
from mfas_tpu_torch.runtime.checkpoint import state_dict_from_numpy

CH = 4
GEN = torch.Generator


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
    d = dict(channels=CH, num_outputs=10, inner_representation_size=16,
             drpt=0.0, multitask=True, alphas=False, fusetype="cat",
             fusingmix="11,32,53")
    d.update(kw)
    return types.SimpleNamespace(**d)


def _inputs(n=4, seed=0):
    rs = np.random.RandomState(seed)
    image = rs.randn(n, 1, 28, 28).astype(np.float32)
    audio = (rs.rand(n, 1, 112, 112) * 0.1).astype(np.float32)
    label = rs.randint(0, 10, n).astype(np.int32)
    return image, audio, label


def _flat(jnet, seed=0):
    return {k: np.asarray(v) for k, v in flatten_tree(jnet.init(seed)).items()}


def _port(tnet, flat):
    assert set(tnet.state_dict()) == set(flat)
    tnet.load_state_dict(state_dict_from_numpy(flat), strict=True)
    return tnet


def _close(got, want, rel=(1e-4, 1e-4), what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=rel[0],
                               atol=rel[1] * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _outs(x):
    return [np.asarray(o.detach().numpy() if torch.is_tensor(o) else o)
            for o in (x if isinstance(x, (tuple, list)) else (x,))]


# --------------------------------------------------------------------------
# backbones
# --------------------------------------------------------------------------
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name, size, n_taps", [("GP_LeNet", 28, 3),
                                                ("GP_LeNet_Deeper", 112, 5)])
def test_backbone_taps_match_jax(name, size, n_taps, train):
    args = _args()
    jnet = getattr(jmav, name)(args, 1)
    flat = _flat(jnet)
    tnet = _port(getattr(tmav, name)(args, 1, device="cpu",
                                     generator=GEN().manual_seed(0)), flat)
    image, audio, _ = _inputs()
    x = image if size == 28 else audio
    ctx = Ctx(train=train, rng=Rng(0))
    want = _outs(jnet(unflatten_tree({k: jnp.asarray(v)
                                      for k, v in flat.items()}), ctx,
                      jnp.asarray(x)))
    tnet.train(train)
    with torch.no_grad():
        got = _outs(tnet(torch.from_numpy(x)))
    assert len(got) == len(want) == 1 + n_taps
    widths = [CH * 2 ** i for i in range(n_taps)]
    assert [g.shape for g in got] == [(4, 10)] + [(4, w) for w in widths]
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, what=f"{name} output {i}")
    if train:
        jafter = flatten_tree(apply_updates(
            unflatten_tree({k: jnp.asarray(v) for k, v in flat.items()}),
            ctx.updates))
        for k, v in tnet.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                _close(v.numpy(), jafter[k], what=k)
                assert not np.array_equal(v.numpy(), flat[k]), k
            elif k.endswith("num_batches_tracked"):
                assert int(v) == int(jafter[k]) == 1


def test_gp1_taps_follow_the_reference_quirks():
    """GP_LeNet's gp1 pools the pre-pool stage-1 map, GP_LeNet_Deeper's the
    post-pool one: checked against the stage's own activation."""
    args = _args()
    image, audio, _ = _inputs()
    for cls, x, pooled in ((tmav.GP_LeNet, image, False),
                           (tmav.GP_LeNet_Deeper, audio, True)):
        net = cls(args, 1, device="cpu", generator=GEN().manual_seed(0))
        net.eval()
        with torch.no_grad():
            t = torch.from_numpy(x)
            acti = torch.relu(net.bn1(net.conv1(t)))
            if pooled:
                acti = torch.nn.functional.max_pool2d(acti, 2)
            torch.testing.assert_close(net(t)[1], acti.mean(dim=(2, 3)))


# --------------------------------------------------------------------------
# baselines
# --------------------------------------------------------------------------
BASELINES = ([("SimpleAVNet", "cat", "11,32,53"),
              ("SimpleAVNet_Deeper", "cat", "11,32,53")]
             + [("SimpleAV_CentralNet", ft, mix) for ft in ("cat", "wsum")
                for mix in ("11,32,53", "11,22,33", "31,42,53")])


@pytest.mark.parametrize("name, fusetype, fusingmix", BASELINES)
def test_baselines_match_jax(name, fusetype, fusingmix):
    central = name.endswith("CentralNet")
    # the CentralNet's classifier is 96 or 384 wide (x2 under cat): the
    # widest fused taps at --channels 24
    args = _args(fusetype=fusetype, fusingmix=fusingmix,
                 channels=24 if central else CH)
    jnet = getattr(jmav, name)(args, 1, 1)
    flat = _flat(jnet)
    tnet = _port(getattr(tmav, name)(args, 1, 1, device="cpu",
                                     generator=GEN().manual_seed(0)), flat)
    image, audio, _ = _inputs(2)
    if central:     # pooled taps: their widths do not depend on the size
        audio = audio[:, :, :32, :32].copy()
    want = _outs(jnet(unflatten_tree({k: jnp.asarray(v)
                                      for k, v in flat.items()}), Ctx(),
                      jnp.asarray(audio), jnp.asarray(image)))
    tnet.eval()
    with torch.no_grad():
        got = _outs(tnet(torch.from_numpy(audio), torch.from_numpy(image)))
    assert len(got) == len(want) == (3 if central else 1)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, what=f"{name} output {i}")
    if central:
        assert set(tnet.central_params()) == set(jnet.central_params())


@pytest.mark.parametrize("fusetype", ["cat", "wsum"])
@pytest.mark.parametrize("w1, w2", [(6, 4), (4, 6), (5, 5)])
def test_fuse_features_matches_jax(fusetype, w1, w2):
    rs = np.random.RandomState(w1 * 10 + w2)
    f1, f2 = rs.randn(3, w1), rs.randn(3, w2)
    a1, a2 = rs.rand(1), rs.rand(1)
    want = np.asarray(jmav.fuse_features(*map(jnp.asarray, (f1, f2, a1, a2)),
                                         fusetype))
    got = tmav.fuse_features(*map(torch.from_numpy, (f1, f2, a1, a2)),
                             fusetype).numpy()
    _close(got, want, (1e-6, 1e-6))
    if fusetype == "wsum" and w1 == w2:       # a1 on both sides
        np.testing.assert_allclose(got, f1 * a1 + f2 * a1, rtol=1e-12)


# --------------------------------------------------------------------------
# the searchable net
# --------------------------------------------------------------------------
def _searchable(args, conf):
    jnet = jfav.Searchable_Audio_Image_Net(args, conf)
    flat = _flat(jnet)
    tnet = _port(tfav.Searchable_Audio_Image_Net(
        args, conf, device="cpu", generator=GEN().manual_seed(0)), flat)
    return jnet, flat, tnet


@pytest.mark.parametrize("multitask", [False, True])
@pytest.mark.parametrize("conf", sorted(jmain.FOUND_CONFS))
def test_searchable_net_matches_jax(conf, multitask):
    args = _args(multitask=multitask, drpt=0.4)
    configuration = tmain.FOUND_CONFS[conf]
    np.testing.assert_array_equal(configuration, jmain.FOUND_CONFS[conf])
    jnet, flat, tnet = _searchable(args, configuration)
    assert "alphas.0.alpha_x" in flat and not any(".2.running" in k
                                                   for k in flat)
    image, audio, _ = _inputs()
    want = _outs(jnet(unflatten_tree({k: jnp.asarray(v)
                                      for k, v in flat.items()}), Ctx(),
                      (jnp.asarray(image), jnp.asarray(audio))))
    tnet.eval()
    with torch.no_grad():
        got = _outs(tnet((torch.from_numpy(image), torch.from_numpy(audio))))
    assert len(got) == len(want) == (3 if multitask else 1)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (4, 10)
        _close(g, w, what=f"conf {conf} output {i}")
    assert tnet.central_params() == jnet.central_params()
    assert tfav.tap_sizes(args) == jfav.tap_sizes(args)
    assert (tfav.get_possible_layer_configurations(0)
            == jfav.get_possible_layer_configurations(0))


def test_feature_extractor_matches_jax():
    args = _args()
    jext = jfav.AVMnistFeatureExtractor(args)
    flat = _flat(jext)
    text = _port(tfav.AVMnistFeatureExtractor(
        args, device="cpu", generator=GEN().manual_seed(0)), flat)
    image, audio, _ = _inputs()
    ja, jb, jlb, jla = jext(unflatten_tree({k: jnp.asarray(v)
                                            for k, v in flat.items()}),
                            Ctx(), (jnp.asarray(image), jnp.asarray(audio)))
    text.eval()
    with torch.no_grad():
        ta, tb, tlb, tla = text((torch.from_numpy(image),
                                 torch.from_numpy(audio)))
    assert (len(ta), len(tb)) == (5, 3)
    for g, w in zip([*ta, *tb, tlb, tla], [*ja, *jb, jlb, jla]):
        _close(g.numpy(), w)


# --------------------------------------------------------------------------
# one train step, both phases, through the engine
# --------------------------------------------------------------------------
def _jax_step(jnet, flat, prefixes, batch, dtype):
    eng = JEngine(jnet, multitask=True, input_keys=("image", "audio"))
    tree = unflatten_tree({k: jnp.asarray(
        v.astype(dtype) if v.dtype == np.float32 else v)
        for k, v in flat.items()})
    trainable, frozen = split_tree(jnet, tree, prefixes)

    def f(tr, b):
        ctx = Ctx(train=True, rng=Rng(0))
        loss, _ = eng._forward(merge(tr, frozen), ctx, b)
        return loss, ctx.updates

    (loss, updates), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        trainable, {k: jnp.asarray(v) for k, v in batch.items()})
    after = flatten_tree(apply_updates(merge(trainable, frozen), updates))
    return (float(loss),
            {k: np.asarray(v) for k, v in flatten_tree(grads).items()
             if v is not None},
            {k: np.asarray(v) for k, v in after.items()})


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("phase", ["central", "whole"])
def test_train_step_matches_jax(phase, dtype):
    args = _args()
    jnet, flat, tnet = _searchable(args, tmain.FOUND_CONFS[0])
    prefixes = jnet.central_params() if phase == "central" else None
    image, audio, label = _inputs(6, seed=1)
    dt = np.dtype(dtype)
    batch = {"image": image.astype(dt), "audio": audio.astype(dt),
             "label": label, "_mask": np.ones(6, dt)}
    x64 = dtype == "float64"
    jax.config.update("jax_enable_x64", x64)
    try:
        jloss, jgrads, jafter = _jax_step(jnet, flat, prefixes, batch, dt)
    finally:
        jax.config.update("jax_enable_x64", False)

    if x64:
        tnet = tnet.double()
    eng = ClassifierEngine(tnet, "cpu", multitask=True,
                           input_keys=("image", "audio"))
    set_trainable(tnet, prefixes)
    tnet.train()
    opt = make_adam(tnet.parameters(), WEIGHT_DECAY)
    tloss, _ = eng._train_step({k: torch.from_numpy(v)
                                for k, v in batch.items()}, opt, 1e-3)
    tgrads = {n: p.grad.numpy() for n, p in tnet.named_parameters()
              if p.grad is not None}
    tafter = {k: v.numpy() for k, v in tnet.state_dict().items()}

    rel = (0, 1e-9) if x64 else (1e-4, 1e-4)
    np.testing.assert_allclose(float(tloss), jloss,
                               rtol=1e-12 if x64 else 1e-4)
    # --alphas off: JAX differentiates the unused gates to exactly 0, torch
    # leaves their grad None
    alphas = {k for k in jgrads if k.startswith("alphas.")}
    assert all(not jgrads[k].any() for k in alphas)
    assert set(tgrads) == set(jgrads) - alphas
    assert {v.dtype for v in tgrads.values()} == {dt}
    if phase == "central":
        assert all(k.startswith(("fusion_layers.", "central_classifier."))
                   for k in tgrads)
    else:
        assert "audnet.conv5.weight" in tgrads and "rgbnet.bn1.bias" in tgrads
    for k in tgrads:
        _close(tgrads[k], jgrads[k], rel, k)
    # the frozen backbones' BatchNorms still move their statistics
    for k in ("rgbnet.bn1.running_mean", "audnet.bn5.running_var"):
        _close(tafter[k], jafter[k], rel, k)
        assert not np.array_equal(tafter[k], flat[k])


# --------------------------------------------------------------------------
# data and loader
# --------------------------------------------------------------------------
def test_synthetic_store_and_arrays_match_jax(tmp_path):
    jdata.make_synthetic_avmnist(str(tmp_path / "j"), n_train=12, n_test=5,
                                 seed=3)
    tdata.make_synthetic_avmnist(str(tmp_path / "t"), n_train=12, n_test=5,
                                 seed=3)
    for rel in ("audio/train_data.npy", "images/test_data.npy",
                "train_labels.npy", "test_labels.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "t" / rel),
                                      np.load(tmp_path / "j" / rel))
    for stage in ("train", "test"):
        for normalize in (True, False):
            want = jdata.load_avmnist_arrays(str(tmp_path / "j"), stage,
                                             normalize)
            got = tdata.load_avmnist_arrays(str(tmp_path / "t"), stage,
                                            normalize)
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
    assert got["image"].shape == (5, 1, 28, 28)
    assert got["audio"].shape == (5, 1, 112, 112)

    jds = jdata.AVMnist(str(tmp_path / "j"),
                        transform=lambda s: jdata.Normalize()(
                            jdata.ToTensor()(s)))
    tds = tdata.AVMnist(str(tmp_path / "t"),
                        transform=lambda s: tdata.Normalize()(
                            tdata.ToTensor()(s)))
    assert len(tds) == len(jds) == 12
    for i in (0, 7):
        for k in ("image", "audio", "label"):
            np.testing.assert_array_equal(tds[i][k], jds[i][k])
    np.testing.assert_allclose(tds[3]["image"],
                               tdata.AVMnist(str(tmp_path / "t"))[3]["image"],
                               rtol=1e-6)
    batch = {k: v[:2] for k, v in got.items()}
    for seed in range(4):
        want = jdata.mute_modality(batch, 0.5, np.random.RandomState(seed))
        mine = tdata.mute_modality(batch, 0.5, np.random.RandomState(seed))
        for k in batch:
            np.testing.assert_array_equal(mine[k], want[k])
    for n in (64, 55000, 70000):
        rows = tdata.train_dev_split(n)
        assert rows == ((50000, 55000) if n >= 55000 else (56, 64))


@pytest.mark.parametrize("shuffle", [False, True])
def test_array_loader_matches_jax(shuffle):
    rs = np.random.RandomState(0)
    arrays = {"image": rs.randn(11, 1, 2, 2).astype(np.float32),
              "label": np.arange(11, dtype=np.int32)}
    idx = np.arange(1, 11)
    mine = ArrayLoader(arrays, 4, shuffle=shuffle, seed=5, indices=idx)
    want = JArrayLoader(arrays, 4, shuffle=shuffle, seed=5, indices=idx)
    assert (len(mine), mine.dataset_size) == (len(want), want.dataset_size)
    assert (len(mine), mine.dataset_size) == (3, 10)
    for _ in range(2):          # two epochs: the shuffle stream moves on
        got, exp = list(mine), list(want)
        assert len(got) == len(exp) == 3
        for g, w in zip(got, exp):
            assert set(g) == set(w) == {"image", "label", "_mask"}
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
        last = got[-1]
        np.testing.assert_array_equal(last["_mask"], [1, 1, 0, 0])
        assert (last["label"][2:] == last["label"][0]).all()
    st = mine.rng_state()
    for a, b in zip(st, want.rng_state()):
        np.testing.assert_array_equal(a, b)
    first = [b["label"] for b in mine]
    mine.set_rng_state(st)
    assert all((a == b).all() for a, b in zip([b["label"] for b in mine],
                                              first))
