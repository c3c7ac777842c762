"""The CIFAR modules, JAX package against the port, on the CPU.

With the JAX modules' initial weights carried into the port
(``state_dict_from_numpy``, strict keys), at --planes 4-8, --net_str 1 2 1:

* ``avg_pool2d`` in both padding modes (1e-6) and the 1x1 adaptive pool;
* each of the 10 ``CreateOp`` types in eval and train mode (1e-5 of max),
  with the BatchNorm statistics a train-mode forward leaves;
  ``FactorizedReduction``, ``AuxiliaryHead``, ``Cell`` and ``FixedCell``;
* ``Searchable_MicroCNN`` in search and fixed mode: strict keys, both
  outputs within 1e-5 of max, ``args.planes`` doubled in fixed mode; the
  search space and op labels;
* DropPath: a dropped output is zeros, the second path is kept whenever
  the first was dropped, eval mode is the identity, and the decision is a
  tensor drawn from the engine's generator;
* ``CifarLoader`` batches bitwise JAX's, with and without cutout, train and
  eval;
* one ``CifarEngine`` train step in float64, with and without
  ``use_intermediate``: the loss within 1e-10 relative, every gradient and
  BatchNorm statistic within 1e-9 of its tensor's max, the parameters after
  the Adam step within 1e-5 of lr (the JAX package computes Adam's bias
  corrections in float32: 1 - 0.999 rounds 1.3e-5 off, which moves each
  first update by ~6.4e-6 of itself), the dead parameters (no gradient in
  torch, exactly 0 in JAX) bitwise unchanged in both packages; and at
  DropPath keep ~1e-9 the dropped ops (all-zero gradients) unstepped in
  both, moments and step counts included;
* the weight-sharing store: JAX's keys, nested numpy trees, REPLACE
  semantics through ``CifarSearchTrainer``, loaded back by
  ``set_cifar_states``.
"""

import copy
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfas_tpu.core import Ctx, Rng, flatten_tree, unflatten_tree
from mfas_tpu.core import functional as JF
from mfas_tpu.core.module import apply_updates, merge
from mfas_tpu.core.optim import adam_init, adam_update
from mfas_tpu.data import cifar as jdata
from mfas_tpu.engine.cifar import CifarEngine as JEngine
from mfas_tpu.engine.classifier import split_tree
from mfas_tpu.fusion import cifar as jfc
from mfas_tpu.models import enas_cell as JE
from mfas_tpu.search import trainers as jtrainers
from mfas_tpu_torch.core import functional as TF
from mfas_tpu_torch.core import layers as TL
from mfas_tpu_torch.data import cifar as tdata
from mfas_tpu_torch.engine.cifar import CifarEngine
from mfas_tpu_torch.engine.classifier import WEIGHT_DECAY, set_trainable
from mfas_tpu_torch.fusion import cifar as tfc
from mfas_tpu_torch.models import enas_cell as TE
from mfas_tpu_torch.runtime.checkpoint import state_dict_from_numpy
from mfas_tpu_torch.search import trainers as ttrainers
from tests.test_torch_search_cli import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GEN = torch.Generator
KW = dict(device="cpu", generator=GEN().manual_seed(0))
CONF = np.array([[0, 1, -2, -1], [2, 3, -2, 0]])


def cifar_args(**kw):
    d = dict(num_outputs=10, planes=4, net_str=[1, 2, 1], img_size=32,
             drop_path=0.0, drop_prob=0.0, batchsize=8, epochs=1,
             eta_max=1e-3, eta_min=1e-6, Ti=1, Tm=2, verbose=False,
             weightsharing=False)
    d.update(kw)
    return types.SimpleNamespace(**d)


def _flat(jnet, seed=0):
    return {k: np.asarray(v) for k, v in flatten_tree(jnet.init(seed)).items()}


def _tree(flat):
    return unflatten_tree({k: jnp.asarray(v) for k, v in flat.items()})


def _port(tnet, flat):
    assert set(tnet.state_dict()) == set(flat)
    tnet.load_state_dict(state_dict_from_numpy(flat), strict=True)
    return tnet


def _close(got, want, rel=1e-5, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _x(n=2, c=4, hw=8, seed=0):
    return np.random.RandomState(seed).randn(n, c, hw, hw).astype(np.float32)


def _compare(jnet, tnet, flat, inputs, train, rel=1e-5):
    """Outputs (tuples flattened) and, in train mode, every BatchNorm
    statistic the forward leaves, within ``rel`` of the largest statistic
    of its layer (a layer whose input is centred keeps a running mean of
    rounding noise)."""
    ctx = Ctx(train=train, rng=Rng(0))
    want = jnet(_tree(flat), ctx, *[jnp.asarray(x) for x in inputs])
    TL.set_dropout_generator(tnet, GEN().manual_seed(1))
    tnet.train(train)
    with torch.no_grad():
        got = tnet(*[torch.from_numpy(x) for x in inputs])
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g.numpy(), w, rel, f"output {i}")
    if train:
        after = flatten_tree(apply_updates(_tree(flat), ctx.updates))
        moved = 0
        for k, v in tnet.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                layer = k.rsplit(".", 1)[0]
                scale = max(np.abs(after[f"{layer}.{s}"]).max()
                            for s in ("running_mean", "running_var"))
                np.testing.assert_allclose(v.numpy(), after[k], rtol=0,
                                           atol=rel * scale, err_msg=k)
                moved += not np.array_equal(v.numpy(), flat[k])
            elif k.endswith("num_batches_tracked"):
                assert int(v) == int(after[k]), k
        assert moved


# --------------------------------------------------------------------------
# pools and padding helpers
# --------------------------------------------------------------------------
@pytest.mark.parametrize("count_include_pad", [True, False])
def test_avg_pool2d_matches_jax(count_include_pad):
    x = _x(2, 3, 9)
    for k, s, p in ((3, 1, 1), (5, 2, 0), (1, 2, 0), (3, 2, 1)):
        want = np.asarray(JF.avg_pool2d(jnp.asarray(x), k, s, p,
                                        count_include_pad))
        got = TF.avg_pool2d(torch.from_numpy(x), k, s, p,
                            count_include_pad).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=f"{k} {s} {p}")
        layer = TL.AvgPool2d(k, stride=s, padding=p,
                             count_include_pad=count_include_pad)
        np.testing.assert_array_equal(layer(torch.from_numpy(x)).numpy(),
                                      got)
    # the padded 3x3 window at a corner holds 4 elements: /9 or /4
    corner = TF.avg_pool2d(torch.ones(1, 1, 4, 4), 3, 1, 1,
                           count_include_pad)[0, 0, 0, 0]
    assert float(corner) == pytest.approx(4 / 9 if count_include_pad else 1.0,
                                          rel=1e-6)
    np.testing.assert_allclose(
        TF.adaptive_avg_pool2d_1x1(torch.from_numpy(x)).numpy(),
        np.asarray(JF.adaptive_avg_pool2d_1x1(jnp.asarray(x))), rtol=1e-6)


# --------------------------------------------------------------------------
# ops, reductions, heads, cells
# --------------------------------------------------------------------------
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("conv_type", range(10))
def test_create_op_matches_jax(conv_type, train):
    jop = JE.CreateOp(conv_type, 4, 4)
    flat = _flat(jop)
    label = [k for k, v in TE.OP_NAMES.items() if v == conv_type][0]
    top = _port(TE.CreateOp(label, 4, 4, **KW), flat)
    if conv_type == 0:
        assert set(flat) >= {"0.0.weight", "0.1.running_mean"}
        assert isinstance(top[1], TL.Identity)
    _compare(jop, top, flat, [_x()], train)


def test_factorized_reduction_matches_jax():
    jnet = JE.FactorizedReduction(4, 8)
    flat = _flat(jnet)
    tnet = _port(TE.FactorizedReduction(4, 8, **KW), flat)
    assert {"path1.1.weight", "path2.1.weight", "bn.weight"} <= set(flat)
    for train in (False, True):
        _compare(jnet, tnet, flat, [_x(hw=9)], train)
    with torch.no_grad():
        out = tnet(torch.from_numpy(_x(hw=9)))
    assert out.shape == (2, 8, 5, 5)


def test_auxiliary_head_matches_jax():
    jnet = JE.AuxiliaryHead(10, 4)
    flat = _flat(jnet)
    tnet = _port(TE.AuxiliaryHead(10, 4, **KW), flat)
    for train in (False, True):
        _compare(jnet, tnet, flat, [_x(hw=8)], train)


@pytest.mark.parametrize("fixed", [False, True])
def test_cells_match_jax(fixed):
    conf = np.array([[0, 5, -2, -1], [8, 9, -1, 0], [6, 3, 1, -2]])
    labels = list(TE.OP_NAMES)
    args = cifar_args()
    jcls, tcls = (JE.FixedCell, TE.FixedCell) if fixed else (JE.Cell,
                                                            TE.Cell)
    jnet = jcls(labels, conf[:, :2], conf[:, 2:], args)
    flat = _flat(jnet)
    tnet = _port(tcls(labels, conf[:, :2], conf[:, 2:], args, **KW), flat)
    # blocks 0 and 1 feed later blocks: only block 2 is concatenated
    assert tnet.block_used == jnet.block_used == [True, True, False]
    assert tnet.num_concatenations == jnet.num_concatenations == 1
    for train in (False, True):
        _compare(jnet, tnet, flat, [_x(seed=1), _x(seed=2)], train)


# --------------------------------------------------------------------------
# the whole net
# --------------------------------------------------------------------------
def test_search_space_matches_jax():
    assert tfc.OPERATION_LABELS == jfc.OPERATION_LABELS
    for i in range(3):
        assert (tfc.get_possible_layer_configurations(i)
                == jfc.get_possible_layer_configurations(i))
    assert len(tfc.get_possible_layer_configurations(0)) == 80


@pytest.mark.parametrize("fixed", [False, True])
def test_micro_cnn_matches_jax(fixed):
    jargs, targs = cifar_args(planes=8), cifar_args(planes=8)
    jnet = jfc.Searchable_MicroCNN(jargs, CONF, fixed=fixed)
    flat = _flat(jnet, seed=3)
    tnet = _port(tfc.Searchable_MicroCNN(targs, CONF, fixed=fixed, **KW),
                 flat)
    assert targs.planes == jargs.planes == (16 if fixed else 8)
    assert "cell_array.0.blocks.0.op1.0.0.weight" in flat
    assert "pooled_layers.2.path2.1.weight" in flat
    x = np.random.RandomState(0).randn(4, 3, 32, 32).astype(np.float32)
    for train in (False, True):
        _compare(jnet, tnet, flat, [x], train)
    # every conv weight re-drawn with kaiming_uniform(a=0): bound
    # sqrt(6 / fan_in), above torch's default sqrt(1 / fan_in)
    w = tfc.Searchable_MicroCNN(cifar_args(planes=8), CONF, fixed=fixed,
                                **KW).input_conv[0].weight.detach()
    assert float(w.abs().max()) > np.sqrt(1 / 27)
    assert float(w.abs().max()) <= np.sqrt(6 / 27)


def test_droppath_semantics():
    dp = TE.DropPath(keep_prob=0.0).train()  # always drop
    x = torch.ones((2, 3))
    with pytest.raises(RuntimeError, match="generator"):
        dp(x)
    TL.set_dropout_generator(dp, GEN().manual_seed(0))
    out, dropped = dp(x)
    assert torch.is_tensor(dropped) and bool(dropped)
    np.testing.assert_array_equal(out.numpy(), 0.0)
    # but not when the sibling already dropped
    out2, _ = dp(x, other_dropped=torch.tensor(True))
    assert torch.all(out2 != 0.0)
    # eval mode: identity
    out3, d3 = dp.eval()(x)
    np.testing.assert_array_equal(out3.numpy(), x.numpy())
    assert not bool(d3)
    # keep 0.9: inverted scaling, one draw per call from the generator;
    # the second path of a block is never dropped with the first
    block = TE.CellBlock(0, 2, cifar_args(drop_path=0.1), **KW).train()
    gen = GEN().manual_seed(5)
    TL.set_dropout_generator(block, gen)
    kept, both = 0, 0
    y = torch.ones(1, 1)
    for _ in range(400):
        a, da = block.dp1(y)
        b, _ = block.dp2(y, da)
        kept += int(not bool(da))
        both += int(bool(da) and not b.any())
        assert float(a.max()) in (0.0, pytest.approx(1 / 0.9))
    assert both == 0 and 330 <= kept <= 390
    # a dropped op's gradient is zeros (torch.where), never None
    w = torch.ones(3, requires_grad=True)
    rare = TE.DropPath(keep_prob=1e-9).train()
    TL.set_dropout_generator(rare, GEN().manual_seed(0))
    out, dropped = rare(w * 2.0)
    assert bool(dropped)
    out.sum().backward()
    np.testing.assert_array_equal(w.grad.numpy(), 0.0)


# --------------------------------------------------------------------------
# the data pipeline
# --------------------------------------------------------------------------
@pytest.mark.parametrize("use_cutout", [False, True])
def test_cifar_loader_bitwise(tmp_path, use_cutout):
    tdata.make_synthetic_cifar(str(tmp_path / "t"), n_per_batch=12, seed=3)
    jdata.make_synthetic_cifar(str(tmp_path / "j"), n_per_batch=12, seed=3)
    for name in ("data_batch_1", "test_batch"):
        path = f"cifar-10-batches-py/{name}"
        assert (tmp_path / "t" / path).read_bytes() == \
            (tmp_path / "j" / path).read_bytes()
    arrays = tdata.load_cifar10_arrays(str(tmp_path / "t"))
    jarrays = jdata.load_cifar10_arrays(str(tmp_path / "t"))
    assert arrays["image"].shape == (60, 3, 32, 32)
    for k in arrays:
        np.testing.assert_array_equal(arrays[k], jarrays[k])
    assert tdata.train_split(60) == (54, 60)
    assert tdata.train_split(50000) == (45000, 50000)
    for train in (True, False):
        kw = dict(train=train, seed=2, indices=np.arange(5, 48),
                  use_cutout=use_cutout)
        got = tdata.CifarLoader(arrays, 16, **kw)
        want = jdata.CifarLoader(jarrays, 16, **kw)
        assert len(got) == 3 and got.dataset_size == 43
        for _ in range(2):      # two epochs: the RNG carries over
            for b, jb in zip(got, want, strict=True):
                assert b.keys() == jb.keys()
                for k in b:
                    assert b[k].dtype == jb[k].dtype, k
                    np.testing.assert_array_equal(b[k], jb[k], err_msg=k)
    if use_cutout:
        holes = tdata.cutout(arrays["image"][:2], np.random.RandomState(0))
        np.testing.assert_array_equal(holes, jdata.cutout(
            arrays["image"][:2], np.random.RandomState(0)))
        # one 16-pixel hole per image, clipped to at least 8 x 8
        assert (holes == 0).sum() >= 2 * 3 * 8 * 8


# --------------------------------------------------------------------------
# one engine step, float64
# --------------------------------------------------------------------------
def _batch(n=8, seed=4):
    rs = np.random.RandomState(seed)
    return {"image": rs.randn(n, 3, 32, 32),
            "label": rs.randint(0, 10, n).astype(np.int32),
            "_mask": np.array([1.0] * (n - 1) + [0.0])}


# the parameters that get no gradient: at --net_str 1 2 1 the reduction
# pools the input conv's output (pooled_layers.0) and no later cell reads
# it; the aux head is dead without use_intermediate
DEAD_FR = "pooled_layers.0."
# BatchNorm biases that reach the loss only as per-channel constants ahead
# of train-mode BatchNorms: every op starts with a 1x1 conv and a
# BatchNorm; a FactorizedReduction's shifted path on an even side never
# samples its zero padding, so it passes a constant on to its BatchNorm;
# the aux head pools without padding into a 1x1 conv and a BatchNorm. Their
# gradients vanish analytically and hold rounding noise (below 1e-12 of
# the largest in both packages), whose sign Adam's first step turns into
# +-lr: they are held to vanish, not compared after the step. The last
# cell's bias reaches the classifier and is compared.
VANISHING = {"input_conv.1.bias", "cell_array.0.dim_reduc.2.bias",
             "cell_array.1.dim_reduc.2.bias", "pooled_layers.1.bn.bias",
             "pooled_layers.2.bn.bias"}
LR = 1e-3


def _engine_step(use_intermediate, drop_path=0.0):
    """One f64 CifarEngine step in both packages from the same weights:
    (flat, JAX loss, grads and after, port loss, grads, after, optimizer
    state by name)."""
    jargs = cifar_args(drop_path=drop_path)
    targs = cifar_args(drop_path=drop_path)
    jnet = jfc.Searchable_MicroCNN(jargs, CONF, fixed=True)
    flat = _flat(jnet, seed=1)
    tnet = _port(tfc.Searchable_MicroCNN(targs, CONF, fixed=True, **KW),
                 flat).double()
    batch = _batch()

    jax.config.update("jax_enable_x64", True)
    try:
        jeng = JEngine(jnet, use_intermediate=use_intermediate)
        trainable, frozen = split_tree(jnet, unflatten_tree({
            k: jnp.asarray(v.astype(np.float64) if v.dtype == np.float32
                           else v) for k, v in flat.items()}))

        jb = {k: jnp.asarray(v) for k, v in batch.items()}

        def loss_fn(tr):
            ctx = Ctx(train=True, rng=Rng(0))
            loss, _ = jeng._forward(merge(tr, frozen), ctx, jb)
            return loss, ctx.updates

        # the JAX engine's step: its gradients, then its Adam mode for
        # whole-net training (per-leaf steps, disconnected leaves skipped)
        (jloss, updates), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(trainable)
        new_tr, _ = adam_update(
            trainable, grads, adam_init(trainable, per_leaf_step=True),
            jnp.float32(LR), weight_decay=WEIGHT_DECAY,
            skip_disconnected=True)
        jloss = float(jloss)
        jgrads = {k: np.asarray(v) for k, v in flatten_tree(grads).items()
                  if v is not None}
        jafter = {k: np.asarray(v) for k, v in flatten_tree(
            apply_updates(merge(new_tr, frozen), updates)).items()}
    finally:
        jax.config.update("jax_enable_x64", False)

    eng = CifarEngine(tnet, "cpu", use_intermediate=use_intermediate)
    set_trainable(tnet, None)
    tnet.train()
    opt = eng.make_optimizer()
    tloss, _ = eng._train_step({k: torch.from_numpy(v) for k, v in
                                batch.items()}, opt, LR)
    tafter = {k: v.numpy() for k, v in tnet.state_dict().items()}
    tgrads = {n: p.grad.numpy() for n, p in tnet.named_parameters()
              if p.grad is not None}
    tstate = {n: opt.state[p] for n, p in tnet.named_parameters()
              if p in opt.state}
    return flat, jloss, jgrads, jafter, float(tloss), tgrads, tafter, tstate


@pytest.mark.parametrize("use_intermediate", [False, True])
def test_engine_step_matches_jax_f64(use_intermediate):
    flat, jloss, jgrads, jafter, tloss, tgrads, tafter, _ = _engine_step(
        use_intermediate)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-10)
    dead = set(jgrads) - set(tgrads)
    want_dead = {k for k in jgrads if k.startswith(DEAD_FR)
                 or (not use_intermediate and k.startswith("aux_head."))}
    assert dead == want_dead and any(k.startswith(DEAD_FR) for k in dead)
    for k in dead:
        assert not jgrads[k].any(), k
        np.testing.assert_array_equal(tafter[k], flat[k], err_msg=k)
        np.testing.assert_array_equal(jafter[k], flat[k], err_msg=k)
    largest = max(np.abs(g).max() for g in jgrads.values())
    vanishing = {k for k in tgrads
                 if np.abs(jgrads[k]).max() < 1e-12 * largest}
    assert vanishing == VANISHING
    for k in vanishing:
        assert np.abs(tgrads[k]).max() < 1e-12 * largest, k
    for k, g in tgrads.items():
        if k not in vanishing:
            _close(g, jgrads[k], 1e-9, k)
            np.testing.assert_allclose(tafter[k], jafter[k], rtol=0,
                                       atol=1e-5 * LR, err_msg=k)
    for k, v in tafter.items():
        if k.endswith(("running_mean", "running_var")):
            layer = k.rsplit(".", 1)[0]
            scale = max(np.abs(jafter[f"{layer}.{s}"]).max()
                        for s in ("running_mean", "running_var"))
            np.testing.assert_allclose(v, jafter[k], rtol=0,
                                       atol=1e-9 * scale, err_msg=k)
        elif k.endswith("num_batches_tracked"):
            assert int(v) == int(jafter[k]) == 1, k
    assert not np.array_equal(tafter[f"{DEAD_FR}bn.running_var"],
                              flat[f"{DEAD_FR}bn.running_var"])


def test_engine_step_skips_dropped_paths_f64():
    """At keep_prob ~1e-9 every block's first path drops and its second is
    kept, whatever either package draws: the first ops' gradients are all
    zero, and both packages' Adam leaves them, their moments and their
    step counts as they were; every other parameter steps as in JAX."""
    flat, jloss, jgrads, jafter, tloss, tgrads, tafter, tstate = \
        _engine_step(True, drop_path=1.0 - 1e-9)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-10)
    dropped = {k for k in jgrads if ".op1." in k}
    assert len(dropped) == 3 * (3 + 6)     # per cell: identity, 3x3 conv
    for k in dropped:
        assert not jgrads[k].any() and not tgrads[k].any(), k
        np.testing.assert_array_equal(jafter[k], flat[k], err_msg=k)
        np.testing.assert_array_equal(tafter[k], flat[k], err_msg=k)
        assert float(tstate[k]["step"]) == 0.0, k
        for m in ("exp_avg", "exp_avg_sq"):
            assert not tstate[k][m].any(), (k, m)
    largest = max(np.abs(g).max() for g in jgrads.values())
    stepped = 0
    for k, g in tgrads.items():
        if k in dropped or np.abs(jgrads[k]).max() < 1e-12 * largest:
            continue
        _close(g, jgrads[k], 1e-9, k)
        np.testing.assert_allclose(tafter[k], jafter[k], rtol=0,
                                   atol=1e-5 * LR, err_msg=k)
        assert float(tstate[k]["step"]) == 1.0, k
        stepped += 1
    assert stepped > len(dropped)


# --------------------------------------------------------------------------
# the weight-sharing store
# --------------------------------------------------------------------------
def test_weight_sharing_store(tmp_path):
    args = cifar_args(weightsharing=True, epochs=1)
    jnet = jfc.Searchable_MicroCNN(copy.copy(args), CONF)
    jtree = jnet.init(0)
    tnet = _port(tfc.Searchable_MicroCNN(copy.copy(args), CONF, **KW),
                 {k: np.asarray(v) for k, v in flatten_tree(jtree).items()})
    store = ttrainers.get_cifar_states(tnet)
    jstore = jtrainers.get_cifar_states(jnet, jtree, {"stale": 1})
    assert store.keys() == jstore.keys()
    assert {"op1.I.block0.cell0", "op2.3x3 conv.block0.cell0",
            "op1.5x5 conv.block1.cell2", "input_conv", "classifier",
            "aux_classifier"} <= set(store)
    for key in store:
        got, want = flatten_tree(store[key]), flatten_tree(jstore[key])
        assert got.keys() == want.keys(), key
        for k in got:
            assert isinstance(got[k], np.ndarray)
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))

    # set_cifar_states loads every matching part of a fresh net
    other = tfc.Searchable_MicroCNN(copy.copy(args), CONF, device="cpu",
                                    generator=GEN().manual_seed(9))
    ttrainers.set_cifar_states(other, jstore)
    for k, v in other.state_dict().items():
        if not k.startswith("pooled_layers") and ".bn." not in k \
                and "dim_reduc" not in k:
            np.testing.assert_array_equal(
                v.numpy().astype(np.float32),
                tnet.state_dict()[k].numpy().astype(np.float32), err_msg=k)

    # REPLACE: after each candidate the store holds only its keys
    tdata.make_synthetic_cifar(str(tmp_path), n_per_batch=8)
    arrays = tdata.load_cifar10_arrays(str(tmp_path))
    loaders = {"train": tdata.CifarLoader(arrays, 8, train=True,
                                          indices=np.arange(0, 16)),
               "dev": tdata.CifarLoader(arrays, 8, indices=np.arange(16, 24))}
    trainer = ttrainers.CifarSearchTrainer(device="cpu")
    shared = {"stale": 1}
    confs = [np.array([[0, 1, -2, -1]]), np.array([[1, 2, -1, -2]])]
    loaded = []
    orig = ttrainers.set_cifar_states

    def spy(model, sd):
        loaded.append(set(sd))
        return orig(model, sd)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrainers, "set_cifar_states", spy)
        accs = trainer(confs, tfc.Searchable_MicroCNN, loaders, args,
                       state_dict=shared)
    assert len(accs) == 2 and all(0 <= a <= 1 for a in accs)
    assert trainer._seed == 2 and trainer.candidates_trained == 2
    assert loaded[0] == {"stale"}
    assert "op2.3x3 conv.block0.cell0" in loaded[1]
    last = tfc.Searchable_MicroCNN(copy.copy(args), confs[1], **KW)
    assert set(shared) == set(ttrainers.get_cifar_states(last))
    assert "op1.3x3 conv.block0.cell0" in shared
    assert "op1.I.block0.cell0" not in shared and "stale" not in shared
