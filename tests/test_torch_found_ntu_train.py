"""Found-NTU training, JAX package against the port, on the CPU.

A small found-conf-4 net (one block per ResNet stage at base width 8, HCN
over 32 frames, hidden 16, 3 classes) on a synthetic packed store. The port
gets the JAX net's initial weights. Dropout is off where the two packages
are compared (their random streams differ). The fusion head's BatchNorm1d
(--batchnorm) is compared in float64 on both sides: in f32 over a few clips
it is ill-conditioned, so summation order alone moves the head's gradients
by percents (the f32 comparisons run without it; the backbones' BatchNorms
stay in every comparison).

Tolerances, and why:
  * one train step: the loss, every gradient and the BatchNorm buffers
    within rtol 1e-4 (f32 convolutions summed in another order by XLA and
    oneDNN), gradients and buffers also atol 1e-4 of the tensor's max (a
    weight gradient or a batch mean sums B*T*H*W terms). The parameters
    after the step equal JAX's ``adam_update`` applied to the port's own
    gradients within
    float32 rounding (rtol 1e-5, atol 1e-7): a first Adam step moves a
    parameter by lr*g/(|g|+eps), so for gradients near eps=1e-8 it would
    turn their last-digit differences into whole fractions of lr;
  * --batchnorm in float64: see its test (1e-9 of each tensor's max);
  * bf16: the loss within 2e-3 relative (measured 4.4e-4). Gradients only
    norm-wise: in this small random net bf16 moves the backbone gradients
    by ~30% from f32 even inside JAX (max-pool ties and ReLU zeros route
    them elsewhere). Measured, the port's bf16 gradient of a tensor lies
    from JAX's bf16 one at a median 1.02x (at most 1.7x) JAX's own bf16
    error (its distance from JAX's f32 gradient), as two independent bf16
    roundings should (sqrt 2); each tensor is held to 2x that, or 1e-2,
    and the whole gradient to 0.5 from JAX's bf16 one (measured 0.351);
  * both CLIs, 1 + 2 epochs: the same printed accuracies and Model Acc, the
    printed epoch losses within rtol 1e-3;
  * a JAX-written train state: read and written back by the port, bitwise
    equal. Resumed in the port, against the JAX run that never stopped, at
    lr 1e-5: moments and BatchNorm buffers within rtol 1e-4 and atol 1e-4
    of the tensor's max; each parameter within the difference that
    gradients agreeing to 1e-4 of the largest sqrt(v) allow over 3 Adam
    steps, 6e-4*lr*max(sqrt v)/sqrt(v) (at most 10*lr), plus 4 ulp;
  * remat against no remat, resumed against uninterrupted, and the seeds:
    exact (port against port).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import main_found_ntu as jmain
from mfas_tpu.core import Ctx, Rng, flatten_tree, unflatten_tree
from mfas_tpu.core.module import apply_updates, merge
from mfas_tpu.core.optim import adam_init, adam_update
from mfas_tpu.core.sched import LRCosineAnnealingScheduler as JSched
from mfas_tpu.data import loader as jloader
from mfas_tpu.data import ntu as jntu
from mfas_tpu.data import ntu_pack as jpack
from mfas_tpu.engine.classifier import ClassifierEngine as JEngine
from mfas_tpu.engine.classifier import split_tree
from mfas_tpu.fusion.ntu import Searchable_Skeleton_Image_Net
from mfas_tpu.runtime import checkpoint as jckpt
from mfas_tpu_torch import main_found_ntu as tmain
from mfas_tpu_torch.core import functional as TF
from mfas_tpu_torch.core import layers as TL
from mfas_tpu_torch.core.optim import make_adam
from mfas_tpu_torch.core.sched import LRCosineAnnealingScheduler as TSched
from mfas_tpu_torch.data import loader as tloader
from mfas_tpu_torch.data import ntu as tntu
from mfas_tpu_torch.data import ntu_pack as tpack
from mfas_tpu_torch.engine.classifier import (TRAIN_SEED_OFFSET,
                                              WEIGHT_DECAY, ClassifierEngine,
                                              set_trainable)
from mfas_tpu_torch.runtime.checkpoint import (load_backbone,
                                               state_dict_from_numpy)
from mfas_tpu_torch.runtime.train_state import (load_train_state,
                                                save_train_state)

SPLITS = {"train": 5, "dev": 3, "test": 5}     # batches of 2: 3, 2, 3
PATHS = {"packed": "--device_input_normalize", "resident": "--hbm_resident"}
CONF4_NAME = "final_conf_[[3_1_1]_[1_3_0]_[1_1_1]_[3_3_0]]_"


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
def fx(tmp_path_factory):
    root = tmp_path_factory.mktemp("found_ntu_train")
    packed = root / "packed"
    for seed, (split, n) in enumerate(SPLITS.items()):
        tpack.make_synthetic_packed_ntu(str(packed / split), n=n, frames=6,
                                        h=32, w=32, skel_frames=40,
                                        num_classes=3, seed=seed)
    argv = ["--checkpointdir", str(root), "--packed_datadir", str(packed),
            "--conf", "4", "--num_outputs", "3", "--batchsize", "2",
            "--inner_representation_size", "16", "--vid_len", "4", "32",
            "--resnet3d_layers", "1", "1", "1", "1",
            "--resnet3d_base_width", "8", "--j", "2", "--random_backbones",
            "--drpt", "0"]
    args = tmain.parse_args(argv)
    jmodel = Searchable_Skeleton_Image_Net(args, jmain.FOUND_CONFS[4])
    flat = {k: np.asarray(v) for k, v in flatten_tree(jmodel.init(0)).items()}
    return dict(root=root, packed=packed, argv=argv, args=args,
                jmodel=jmodel, flat=flat, jax_steps={})


def _args(fx, *extra):
    return tmain.parse_args(fx["argv"] + list(extra))


_BUILD = tmain.build_model     # before any test patches it


def _port_model(args, flat):
    """The port's net holding the JAX net's weights."""
    model = _BUILD(args, tmain.FOUND_CONFS[4], "cpu")
    model.load_state_dict(state_dict_from_numpy(flat), strict=True)
    return model


def _tree(flat):
    return unflatten_tree({k: jnp.asarray(v) for k, v in flat.items()})


def _host_batch(fx, split="train", idx=(0, 1)):
    """Clips idx of a split through the eval transform, as a numpy batch."""
    ds = tpack.PackedNTU(str(fx["packed"] / split),
                         tntu.Compose([tntu.NormalizeLen((4, 32))]),
                         fx["args"], device_normalize=True)
    samples = [ds[i] for i in idx]
    batch = {k: np.stack([s[k] for s in samples])
             for k in ("rgb", "ske", "label")}
    batch["_mask"] = np.ones(len(idx), np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _port_engine(model, args, **kw):
    return ClassifierEngine(
        model, "cpu", multitask=args.multitask, input_keys=("rgb", "ske"),
        batch_prep=tpack.make_device_normalize_prep(kw.get("compute_dtype")),
        **kw)


def _jax_step(fx, prefixes, compute_dtype=None):
    """JAX's train step on _host_batch at lr 1e-3, unrolled and memoized
    per trainable set and dtype: (loss, grads, state after the step)."""
    key = (tuple(prefixes or ()), compute_dtype)
    if key in fx["jax_steps"]:
        return fx["jax_steps"][key]
    model = fx["jmodel"]
    eng = JEngine(model, multitask=True, input_keys=("rgb", "ske"),
                  batch_prep=jpack.make_device_normalize_prep(),
                  compute_dtype=compute_dtype)
    trainable, frozen = split_tree(model, _tree(fx["flat"]), prefixes)

    @jax.jit
    def loss_and_grads(tr, b):
        def f(tr):
            ctx = Ctx(train=True, rng=Rng(0))
            loss, _ = eng._forward(merge(tr, frozen), ctx, b)
            return loss, ctx.updates
        return jax.value_and_grad(f, has_aux=True)(tr)

    (loss, updates), grads = loss_and_grads(
        trainable, {k: jnp.asarray(v) for k, v in _host_batch(fx).items()})
    new_tr, _ = adam_update(trainable, grads, adam_init(trainable),
                            jnp.float32(1e-3), weight_decay=1e-4)
    after = flatten_tree(apply_updates(merge(new_tr, frozen), updates))
    grads = {k: np.asarray(v) for k, v in flatten_tree(grads).items()
             if v is not None}
    fx["jax_steps"][key] = out = (float(loss), grads, {
        k: np.asarray(v) for k, v in after.items()})
    return out


def _port_step(fx, args, prefixes, batch, eta, compute_dtype=None):
    model = _port_model(args, fx["flat"])
    eng = _port_engine(model, args, compute_dtype=compute_dtype)
    set_trainable(model, prefixes)
    model.train()
    opt = make_adam(model.parameters(), WEIGHT_DECAY)
    loss, _ = eng._train_step(_torch_batch(batch), opt, eta)
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()
             if p.grad is not None}
    after = {k: v.numpy() for k, v in model.state_dict().items()}
    return float(loss), grads, after, model


def _close_to_max(got, want, rel, err_msg):
    np.testing.assert_allclose(got, want, rtol=rel[0],
                               atol=rel[1] * np.abs(want).max(),
                               err_msg=err_msg)


# --------------------------------------------------------------------------
# one train step
# --------------------------------------------------------------------------
@pytest.mark.parametrize("phase", ["central", "whole"])
def test_train_step_matches_jax(fx, phase):
    args = fx["args"]
    prefixes = (fx["jmodel"].central_params() if phase == "central"
                else None)
    jloss, jgrads, jafter = _jax_step(fx, prefixes)
    tloss, tgrads, tafter, model = _port_step(fx, args, prefixes,
                                              _host_batch(fx), 1e-3)

    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    alphas = {k for k in jgrads if k.startswith("alphas.")}
    # --alphas off: the gates are out of the graph; torch leaves their grad
    # None, JAX differentiates them to exactly 0
    assert set(tgrads) == set(jgrads) - alphas
    assert all(not jgrads[k].any() for k in alphas)
    if phase == "central":
        assert not alphas and all(k.startswith(("fusion_layers.",
                                                "central_classifier."))
                                  for k in tgrads)
    for k in tgrads:
        _close_to_max(tgrads[k], jgrads[k], (1e-4, 1e-4), k)
    # the Adam step on the same gradients: JAX's update of the port's
    p0 = {k: jnp.asarray(fx["flat"][k]) for k in tgrads}
    want_p, _ = adam_update(p0, {k: jnp.asarray(g) for k, g in
                                 tgrads.items()},
                            adam_init(p0), jnp.float32(1e-3),
                            weight_decay=1e-4)
    for k, want in jafter.items():
        got = tafter[k]
        if k.startswith("alphas."):
            # expected difference: JAX moves the unused gates by weight
            # decay alone; torch never steps a grad-None parameter
            np.testing.assert_array_equal(got, fx["flat"][k])
            assert np.array_equal(want, fx["flat"][k]) == (phase == "central")
        elif k in tgrads:
            np.testing.assert_allclose(got, np.asarray(want_p[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        elif k.endswith("num_batches_tracked"):
            assert int(got) == int(want) == 1
        elif k.endswith(("running_mean", "running_var")):
            _close_to_max(got, want, (1e-4, 1e-4), k)
        else:       # frozen parameters stay put
            np.testing.assert_array_equal(got, fx["flat"][k])
            np.testing.assert_array_equal(want, fx["flat"][k])
    # the frozen backbones still updated their BatchNorm statistics
    assert not np.array_equal(tafter["rgbnet.cnn.bn1.running_mean"],
                              fx["flat"]["rgbnet.cnn.bn1.running_mean"])


@pytest.mark.parametrize("phase", ["central", "whole"])
def test_batchnorm_train_step_matches_jax_in_float64(fx, phase):
    """--batchnorm: the fusion head's BatchNorm1d in train mode, over all 5
    train clips, in float64 on both sides (in f32 its gradients move by
    percents with summation order alone). The loss within rtol 1e-12,
    every gradient and BatchNorm buffer within 1e-9 of the tensor's max
    (measured: 3e-11). The parameters after the Adam step within 1e-5 of
    lr: the JAX package computes Adam's bias corrections in float32
    (1 - 0.999 rounds 1.3e-5 off), which moves each update by ~6.7e-6 of
    itself; a lost or doubled step misses by ~lr."""
    args = _args(fx, "--batchnorm")
    jmodel = Searchable_Skeleton_Image_Net(args, jmain.FOUND_CONFS[4])
    flat = {k: np.asarray(v) for k, v in flatten_tree(jmodel.init(0)).items()}
    prefixes = jmodel.central_params() if phase == "central" else None
    host = _host_batch(fx, idx=range(SPLITS["train"]))
    rgb = tpack.make_device_normalize_prep(torch.float64)(
        {"rgb": torch.from_numpy(host["rgb"])})["rgb"].numpy()
    batch = dict(rgb=rgb, ske=host["ske"].astype(np.float64),
                 label=host["label"], _mask=host["_mask"].astype(np.float64))
    lr = 1e-3

    jax.config.update("jax_enable_x64", True)
    try:
        eng = JEngine(jmodel, multitask=True, input_keys=("rgb", "ske"))
        tree = unflatten_tree({k: jnp.asarray(
            v.astype(np.float64) if v.dtype == np.float32 else v)
            for k, v in flat.items()})
        trainable, frozen = split_tree(jmodel, tree, prefixes)

        def f(tr, b):
            ctx = Ctx(train=True, rng=Rng(0))
            loss, _ = eng._forward(merge(tr, frozen), ctx, b)
            return loss, ctx.updates

        (jloss, updates), jgrads = jax.jit(jax.value_and_grad(
            f, has_aux=True))(trainable,
                              {k: jnp.asarray(v) for k, v in batch.items()})
        new_tr, _ = adam_update(trainable, jgrads, adam_init(trainable),
                                jnp.float64(lr), weight_decay=WEIGHT_DECAY)
        jafter = {k: np.asarray(v) for k, v in flatten_tree(
            apply_updates(merge(new_tr, frozen), updates)).items()}
        jgrads = {k: np.asarray(v) for k, v in flatten_tree(jgrads).items()
                  if v is not None}
        jloss = float(jloss)
    finally:
        jax.config.update("jax_enable_x64", False)
    assert {v.dtype for v in jgrads.values()} == {np.dtype(np.float64)}

    model = _port_model(args, flat).double()
    eng = ClassifierEngine(model, "cpu", multitask=args.multitask,
                           input_keys=("rgb", "ske"))
    set_trainable(model, prefixes)
    model.train()
    opt = make_adam(model.parameters(), WEIGHT_DECAY)
    tloss, _ = eng._train_step(_torch_batch(batch), opt, lr)
    tgrads = {n: p.grad.numpy() for n, p in model.named_parameters()
              if p.grad is not None}
    tafter = {k: v.numpy() for k, v in model.state_dict().items()}

    np.testing.assert_allclose(float(tloss), jloss, rtol=1e-12)
    alphas = {k for k in jgrads if k.startswith("alphas.")}
    assert set(tgrads) == set(jgrads) - alphas
    assert "fusion_layers.0.2.weight" in tgrads     # the head's BatchNorm1d
    for k in tgrads:
        _close_to_max(tgrads[k], jgrads[k], (0, 1e-9), k)
    for k, want in jafter.items():
        got = tafter[k]
        if k.startswith("alphas."):
            np.testing.assert_array_equal(got, flat[k])
        elif k.endswith("num_batches_tracked"):
            assert int(got) == int(want) == 1
        elif k.endswith(("running_mean", "running_var")):
            _close_to_max(got, want, (0, 1e-9), k)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * lr,
                                       err_msg=k)
            assert np.array_equal(got, flat[k]) == (k not in tgrads), k
    # the head's BatchNorm1d moved its running statistics
    assert not np.array_equal(tafter["fusion_layers.0.2.running_mean"],
                              flat["fusion_layers.0.2.running_mean"])


def test_bf16_step_matches_jax(fx):
    args = _args(fx, "--bf16")
    jloss, jgrads, _ = _jax_step(fx, None, compute_dtype="bfloat16")
    _, jgrads32, _ = _jax_step(fx, None)
    model_dtypes = []
    model = _port_model(args, fx["flat"])
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: model_dtypes.append(out.dtype))
        for m in model.modules() if isinstance(m, TL._BatchNorm)]
    eng = _port_engine(model, args, compute_dtype=torch.bfloat16)
    set_trainable(model, None)
    model.train()
    opt = make_adam(model.parameters(), WEIGHT_DECAY)
    loss, _ = eng._train_step(_torch_batch(_host_batch(fx)), opt, 1e-3)
    for h in hooks:
        h.remove()
    # BatchNorm runs in the activation dtype: nothing goes back to f32
    assert model_dtypes and set(model_dtypes) == {torch.bfloat16}
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype in (torch.float32, torch.int64)
               for b in model.buffers())
    np.testing.assert_allclose(float(loss), jloss, rtol=2e-3)

    def dist(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    names = [n for n, p in model.named_parameters() if p.grad is not None]
    tgrads = {n: p.grad.numpy() for n, p in model.named_parameters()
              if p.grad is not None}
    for n in names:
        own = dist(jgrads[n], jgrads32[n])
        assert dist(tgrads[n], jgrads[n]) <= max(2 * own, 1e-2), n

    def whole(g):
        return np.concatenate([g[n].ravel() for n in names])

    # the whole gradient: measured 0.351 from JAX's bf16 one
    assert dist(whole(tgrads), whole(jgrads)) <= 0.5


# --------------------------------------------------------------------------
# remat, dropout and seeds (port against port, exact)
# --------------------------------------------------------------------------
def _train_steps(fx, args, remat, n_steps=2, seed=5):
    """n_steps whole-net train steps from the same start; returns what
    must be identical, and the calls a block conv and a skeleton dropout
    saw."""
    model = tmain.build_model(args, tmain.FOUND_CONFS[4], "cpu")
    eng = _port_engine(model, args, remat=remat)
    calls = {"conv": 0, "dropout": 0}
    model.rgbnet.cnn.layer1[0].conv1.register_forward_hook(
        lambda *a: calls.__setitem__("conv", calls["conv"] + 1))
    model.skenet.conv4[1].register_forward_hook(
        lambda *a: calls.__setitem__("dropout", calls["dropout"] + 1))
    set_trainable(model, None)
    model.train()
    eng.generator.manual_seed(seed)
    opt = make_adam(model.parameters(), WEIGHT_DECAY)
    losses = []
    for i in range(n_steps):
        batch = _torch_batch(_host_batch(fx, idx=(2 * i, 2 * i + 1)))
        losses.append(eng._train_step(batch, opt, 1e-3)[0])
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    state = {k: v.clone() for k, v in model.state_dict().items()}
    return losses, grads, state, eng.generator.get_state(), calls


def test_remat_equals_no_remat_exactly(fx):
    args = _args(fx, "--drpt", "0.3", "--batchnorm")
    plain = _train_steps(fx, args, remat=False)
    remat = _train_steps(fx, args, remat=True)
    # the recomputation really ran: every checkpointed segment twice
    assert plain[4] == {"conv": 2, "dropout": 2}
    assert remat[4] == {"conv": 4, "dropout": 4}
    for a, b in zip(plain[0], remat[0]):
        assert torch.equal(a, b)
    for part in (1, 2):
        assert plain[part].keys() == remat[part].keys()
        for k in plain[part]:
            assert torch.equal(plain[part][k], remat[part][k]), k
    # BatchNorm statistics moved once per step, not again in recomputation
    assert int(remat[2]["rgbnet.cnn.layer1.0.bn1.num_batches_tracked"]) == 2
    # the dropout stream goes on as if nothing had been recomputed
    assert torch.equal(plain[3], remat[3])


def test_dropout_draws_only_from_the_engine_generator(fx):
    args = _args(fx, "--drpt", "0.4")
    before = torch.random.get_rng_state()
    a = _train_steps(fx, args, remat=False, n_steps=1, seed=1)
    assert torch.equal(torch.random.get_rng_state(), before)
    b = _train_steps(fx, args, remat=False, n_steps=1, seed=1)
    c = _train_steps(fx, args, remat=False, n_steps=1, seed=2)
    assert torch.equal(a[0][0], b[0][0]) and not torch.equal(a[0][0],
                                                            c[0][0])
    with pytest.raises(RuntimeError, match="generator"):
        TL.Dropout(0.5).train()(torch.ones(4))
    with pytest.raises(ValueError, match="Generator"):
        TF.dropout(torch.ones(4), 0.5, None)


def test_training_seed_is_apart_from_the_init_seed(fx):
    args = fx["args"]
    model = tmain.build_model(args, tmain.FOUND_CONFS[4], "cpu")
    eng = _port_engine(model, args)
    assert all(m.generator is eng.generator for m in model.modules()
               if isinstance(m, TL._DropoutBase))
    loaders, sizes = _port_loaders(fx)
    eng.train_track_acc(None, loaders, sizes, TSched(1e-3, 1e-6, 5, 2, 3),
                        num_epochs=2, print_loss=False)
    assert tmain.INIT_SEED == 0
    assert eng.generator.initial_seed() == 0 + TRAIN_SEED_OFFSET + 1


# --------------------------------------------------------------------------
# resume
# --------------------------------------------------------------------------
def _port_loaders(fx, shuffle=False):
    """train/dev MapLoaders without augmentation; train unshuffled, so an
    interrupted run and a whole one see the same batches."""
    tfm = tntu.Compose([tntu.NormalizeLen((4, 32))])
    ld = {k: tloader.MapLoader(
        tpack.PackedNTU(str(fx["packed"] / k), tfm, fx["args"],
                        device_normalize=True), 2, shuffle=shuffle,
        num_workers=2) for k in ("train", "dev")}
    return ld, {k: v.dataset_size for k, v in ld.items()}


def _jax_loaders(fx):
    tfm = jntu.Compose([jntu.NormalizeLen((4, 32))])
    ld = {k: jloader.MapLoader(
        jpack.PackedNTU(str(fx["packed"] / k), tfm, fx["args"],
                        device_normalize=True), 2, num_workers=2)
        for k in ("train", "dev")}
    return ld, {k: v.dataset_size for k, v in ld.items()}


def _sched(sizes, eta_max=1e-3):
    """A warm-restart schedule over 1 epoch (Ti=1, Tm=2), batches of 2."""
    return (eta_max, eta_max * 1e-3, 1, 2, sizes["train"] / 2)


def test_interrupted_then_resumed_equals_uninterrupted(fx, tmp_path):
    # dropout on: the port seeds its dropout stream per epoch, so even
    # that resumes exactly
    args = _args(fx, "--drpt", "0.3", "--batchnorm")

    def run(epochs, path, resume=False):
        model = tmain.build_model(args, tmain.FOUND_CONFS[4], "cpu")
        eng = _port_engine(model, args)
        loaders, sizes = _port_loaders(fx)
        acc, best = eng.train_track_acc(None, loaders, sizes,
                                        TSched(*_sched(sizes)), epochs,
                                        print_loss=False, state_path=path,
                                        resume=resume)
        return acc, best

    whole, part = str(tmp_path / "whole.pt"), str(tmp_path / "part.pt")
    acc_w, best_w = run(3, whole)
    run(1, part)
    acc_r, best_r = run(3, part, resume=True)
    assert acc_r == acc_w
    for k in best_w:
        assert torch.equal(best_r[k], best_w[k]), k
    sw = torch.load(whole, weights_only=True)
    sr = torch.load(part, weights_only=True)
    assert sw.keys() == sr.keys()
    for k in sw:
        assert torch.equal(sw[k], sr[k]), k


def test_jax_written_train_state_resumes_in_port(fx, tmp_path):
    """JAX trains 2 epochs; JAX trains 1 epoch and stops. The port reads
    that state and writes it back bitwise unchanged, then resumes it for
    epoch 2, to the JAX run's state within the bounds below (the gates
    apart: see the step test).

    The schedule peaks at lr 1e-5 here. Adam moves an element by about lr
    whatever its gradient's size, so at lr 1e-3 the first resumed step
    turns noise-level gradient differences into parameter differences of
    up to 2*lr, and the next steps' gradients (max-pool and ReLU routing)
    drift by percents; at 1e-5 the three resumed steps stay on one path."""
    lr = 1e-5
    jeng = JEngine(fx["jmodel"], multitask=True, input_keys=("rgb", "ske"),
                   batch_prep=jpack.make_device_normalize_prep())
    tree = _tree(fx["flat"])
    whole, part = str(tmp_path / "jax_whole.pt"), str(tmp_path / "part.pt")
    for epochs, path in ((2, whole), (1, part)):
        loaders, sizes = _jax_loaders(fx)
        jeng.train_track_acc(tree, None, loaders, sizes,
                             JSched(*_sched(sizes, lr)), epochs,
                             print_loss=False, state_path=path)

    # every slot lands where the port's writer puts it back
    args = fx["args"]
    model = _port_model(args, fx["flat"])
    set_trainable(model, None)
    opt = make_adam(model.parameters(), WEIGHT_DECAY)
    sched = TSched(*_sched(sizes, lr))
    st = load_train_state(part, model=model, optimizer=opt, scheduler=sched)
    again = str(tmp_path / "again.pt")
    save_train_state(again, model=model, best_state=st["best_state"],
                     optimizer=opt, scheduler=sched, epoch=st["epoch"],
                     best_acc=st["best_acc"])
    written, back = jckpt.load(part), jckpt.load(again)
    assert written.keys() == back.keys()
    for k, w in written.items():
        np.testing.assert_array_equal(back[k], w, err_msg=k)

    model = _port_model(args, fx["flat"])
    eng = _port_engine(model, args)
    loaders, sizes = _port_loaders(fx)
    eng.train_track_acc(None, loaders, sizes, TSched(*_sched(sizes, lr)), 2,
                        print_loss=False, state_path=part, resume=True)

    want = jckpt.load(whole)
    got = {k: v.numpy() for k, v in torch.load(
        part, weights_only=True).items()}
    meta = [json.loads(bytes(m.tobytes()).decode())
            for m in (got.pop("meta"), want.pop("meta"))]
    assert meta[0] == meta[1] and meta[0]["epoch"] == 1
    # the JAX run keeps one shared step; the port, whose gates were never
    # stepped after the resume, writes one per parameter
    shared = int(want.pop("opt/step"))
    steps = {k[len("opt/step/"):]: int(got.pop(k)) for k in list(got)
             if k.startswith("opt/step/")}
    assert shared == 6 and steps and all(
        s == (shared - 3 if k.startswith("alphas.") else shared)
        for k, s in steps.items())
    assert got.keys() == want.keys()
    for k, w in want.items():
        if "/alphas." in k:
            continue
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == int(w), k
        elif k.startswith("opt/") or k.endswith(("running_mean",
                                                  "running_var")):
            _close_to_max(got[k], w, (1e-4, 1e-4), k)
        else:
            # a step moves an element by lr*m/(sqrt(v)+eps), so a gradient
            # difference dg moves it by up to ~2*lr*dg/sqrt(v). With dg at
            # the agreement floor (1e-4 of the tensor's largest sqrt(v)),
            # 3 steps bound the difference by 6e-4*lr*max(sqrt v)/sqrt(v),
            # never more than 10*lr, plus the parameters' f32 rounding. A
            # resume that lost the moments or the step count (Adam's bias
            # correction) would miss by a whole step, ~lr.
            s = np.sqrt(want["opt/v/" + k.split("/", 1)[1]])
            bound = np.minimum(6e-4 * lr * s.max() / np.maximum(s, 1e-30),
                               10 * lr) + 4 * np.spacing(np.abs(w))
            diff = np.abs(got[k] - w)
            assert np.all(diff <= bound), k


# --------------------------------------------------------------------------
# the command line
# --------------------------------------------------------------------------
def _epoch_lines(out):
    """[(phase, loss, acc)] of the printed epoch lines, and the named
    accuracy lines."""
    epochs, named = [], {}
    for ln in out.splitlines():
        parts = ln.split()
        if len(parts) == 5 and parts[1:4:2] == ["Loss:", "Acc:"]:
            epochs.append((parts[0], float(parts[2]), float(parts[4])))
        for key in ("Intermediate val accuracy: ", "Final val accuracy: ",
                    "Final test accuracy: ", "Model Acc: "):
            if ln.startswith(key):
                named[key] = float(ln[len(key):])
    return epochs, named


@pytest.mark.parametrize("path", list(PATHS))
def test_training_cli_matches_jax(fx, path, monkeypatch, capsys):
    argv = fx["argv"] + ["--epochs", "2", PATHS[path]]
    monkeypatch.setattr(sys, "argv", ["main_found_ntu.py", *argv])
    jmain.main()
    j_epochs, j_named = _epoch_lines(capsys.readouterr().out)

    monkeypatch.setattr(tmain, "build_model",
                        lambda args, conf, device: _port_model(args,
                                                               fx["flat"]))
    run = tmain.main(argv, device="cpu")
    out = capsys.readouterr().out
    t_epochs, t_named = _epoch_lines(out)
    assert len(j_epochs) == len(t_epochs) == 6      # 1 + 2 epochs x 2
    assert [e[0] for e in t_epochs] == [e[0] for e in j_epochs]
    assert [e[2] for e in t_epochs] == [e[2] for e in j_epochs]
    np.testing.assert_allclose([e[1] for e in t_epochs],
                               [e[1] for e in j_epochs], rtol=1e-3)
    assert t_named == j_named and len(t_named) == 4
    assert run.acc == j_named["Model Acc: "]
    for what in ("Phase 1 (central weights)", "Phase 2 (whole net)"):
        assert f"{what} train clips/s: " in out
    assert [r.train_clips for r in run.train] == [5, 10]


def test_cli_options_save_checkpoint_profile_and_resume(fx, tmp_path,
                                                        capsys):
    """--bf16 --remat --train_state --save_checkpoint --profile_dir on the
    resident path, then --resume: the saved file has the JAX name and
    loads with the JAX package's reader into its tree; the resume skips
    phase 1."""
    state = str(tmp_path / "state.pt")
    argv = fx["argv"] + ["--checkpointdir", str(tmp_path), "--hbm_resident",
                         "--epochs", "1", "--bf16", "--remat",
                         "--batchnorm", "--drpt", "0.2",
                         "--train_state", state]
    run = tmain.main(argv + ["--save_checkpoint", "--profile_dir",
                             str(tmp_path / "prof")], device="cpu")
    out = capsys.readouterr().out
    assert f"Saved {run.saved}" in out and "Model Acc: " in out
    assert os.path.basename(run.saved) == f"{CONF4_NAME}{run.acc}.checkpoint"
    flat = jckpt.load_state_dict(run.saved)
    mine = torch.load(run.saved, weights_only=True)
    assert flat.keys() == mine.keys()
    for k, v in mine.items():
        np.testing.assert_array_equal(flat[k], v.numpy(), err_msg=k)
    jargs = _args(fx, "--batchnorm", "--drpt", "0.2")
    jtemplate = Searchable_Skeleton_Image_Net(
        jargs, jmain.FOUND_CONFS[4]).init(0)
    jckpt.tree_from_state_dict(flat, jtemplate)        # strict keys
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert "Self CPU" in (tmp_path / "prof" / "ops.txt").read_text()
    assert len(run.train) == 2

    run2 = tmain.main(argv + ["--resume", "--epochs", "2"], device="cpu")
    out = capsys.readouterr().out
    assert "Resuming phase 2 from" in out
    assert "Pretraining central weights" not in out
    assert "Resuming training at epoch 1" in out
    assert len(run2.train) == 1 and np.isfinite(run2.acc)


def test_load_backbone(fx, tmp_path, capsys):
    args = fx["args"]
    ske = {k[len("skenet."):]: v for k, v in fx["flat"].items()
           if k.startswith("skenet.")}
    path = str(tmp_path / "ske.checkpoint")
    jckpt.save(ske, path)
    model = tmain.build_model(args, tmain.FOUND_CONFS[4], "cpu")
    load_backbone(path, model.skenet)
    for k, v in model.skenet.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ske[k])
    with pytest.raises(RuntimeError, match="Missing key"):
        load_backbone(path, model.rgbnet)
    missing = str(tmp_path / "nowhere.checkpoint")
    with pytest.raises(FileNotFoundError, match="--random_backbones"):
        load_backbone(missing, model.rgbnet)
    capsys.readouterr()
    for _ in range(2):
        load_backbone(missing, model.rgbnet, random_ok=True)
    assert capsys.readouterr().out.count("WARNING") == 1
