"""The population trainer and the NTU feature extractor: JAX package against
the port, on the CPU, at a small size (ResNet 1-1-1-1 at base width 8, HCN
over 32 frames, 32x32 clips, hidden 16).

* one population step, drpt 0, --batchnorm, alphas and the multitask loss,
  a ragged masked batch: the initial params are equal bitwise; the
  per-candidate loss, corrects, gradients and BatchNorm statistics agree
  within 1e-5 of each tensor's max; one Adam step in float64 agrees within
  1e-9 (absolute);
* the extractor's eval-mode taps and logits, through the inputs prep from
  uint8 clips, agree with ``NTUFeatureExtractor.apply`` within 1e-4 relative
  (+1e-5 of the tensor's max): convolution summation orders differ;
* train-mode features use batch statistics and leave every backbone buffer
  as it was;
* the feature bank in bf16 and int8, and ``bank_batch``, give the same
  accuracies as their JAX twins; with f32 features the per-batch path
  (``fused_epochs=False``) equals the fused one;
* weight sharing round-trips, with JAX's keys and layout.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfas_tpu.core import Ctx, flatten_tree
from mfas_tpu.core.sched import LRCosineAnnealingScheduler as JSched
from mfas_tpu.data import loader as jloader
from mfas_tpu.data import ntu as jntu
from mfas_tpu.data import ntu_pack as jpack
from mfas_tpu.fusion import ntu as jfntu
from mfas_tpu.search import population as jpop
from mfas_tpu_torch import main_searchable_ntu as tmain
from mfas_tpu_torch.core.optim import adam_init
from mfas_tpu_torch.core.sched import LRCosineAnnealingScheduler as TSched
from mfas_tpu_torch.data import loader as tloader
from mfas_tpu_torch.data import ntu as tntu
from mfas_tpu_torch.data import ntu_pack as tpack
from mfas_tpu_torch.fusion import ntu as tfntu
from mfas_tpu_torch.ops import input_kernels as tk
from mfas_tpu_torch.runtime.checkpoint import state_dict_from_numpy
from mfas_tpu_torch.search import population as tpop

SMALL = ["--num_outputs", "3", "--batchsize", "4",
         "--inner_representation_size", "16", "--vid_len", "4", "32",
         "--resnet3d_layers", "1", "1", "1", "1", "--resnet3d_base_width",
         "8", "--drpt", "0", "--j", "2"]
CONFS = [np.array([[3, 1, 0]]),
         np.array([[0, 2, 1], [2, 3, 0]]),
         np.array([[1, 0, 2], [3, 3, 1], [0, 1, 0]]),
         np.array([[2, 2, 1], [1, 0, 0], [3, 1, 2], [0, 3, 1]])]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: under a parallel test runner every split op
    waits on threads the other workers' processes hold."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small_args(extra=()):
    return tmain.parse_args([*SMALL, *extra])


def make_spec(module, args, **kw):
    ske, ims = tfntu.tap_sizes(args)
    return module.PopulationSpec(
        sizes_a=tuple(ske), sizes_b=tuple(ims),
        hidden=args.inner_representation_size, num_outputs=args.num_outputs,
        max_rows=4, **kw)


@contextlib.contextmanager
def jax_x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def jax_extractor(args):
    """The JAX extractor, its tree from init(0), and the same weights as a
    port extractor."""
    jx = jfntu.NTUFeatureExtractor(args)
    tree = jx.init(0)
    tx = tfntu.NTUFeatureExtractor(args, device="cpu",
                                   generator=torch.Generator().manual_seed(1))
    tx.load_state_dict(state_dict_from_numpy(
        {k: np.asarray(v) for k, v in flatten_tree(tree).items()}),
        strict=True)
    return jx, tree, tx


# --------------------------------------------------------------------------
# one population step
# --------------------------------------------------------------------------
def _step_inputs(spec, dtype=np.float32):
    """Padded taps of a ragged batch of 6 (4 real rows; the padding rows
    repeat row 0), labels, mask and the two backbones' logits."""
    rs = np.random.RandomState(5)
    B, n = 6, 4

    def taps(sizes, cmax):
        t = np.zeros((B, len(sizes), cmax), dtype)
        for i, c in enumerate(sizes):
            t[:, i, :c] = rs.randn(B, c) * (1.0 + i)
        return t

    fa, fb = taps(spec.sizes_a, spec.cmax_a), taps(spec.sizes_b, spec.cmax_b)
    lb = rs.randn(B, spec.num_outputs).astype(dtype)
    la = rs.randn(B, spec.num_outputs).astype(dtype)
    label = rs.randint(0, spec.num_outputs, B).astype(np.int32)
    for a in (fa, fb, lb, la, label):
        a[n:] = a[0]
    wmask = np.zeros(B, np.float32)
    wmask[:n] = 1.0
    return fa, fb, lb, la, label, wmask


def _jax_side(spec, batch, dtype):
    params, bn = jpop.init_population(CONFS, spec, seed=3)
    cast = (lambda x: jnp.asarray(x, dtype))
    params = {k: cast(v) for k, v in params.items()}
    bn = {k: cast(v) for k, v in bn.items()}
    conf = {k: jnp.asarray(v) for k, v in jpop.encode_confs(CONFS,
                                                            spec).items()}
    progs = jpop.population_programs(spec, None, None, None)
    fa, fb, lb, la, label, wmask = (jnp.asarray(x) for x in batch)
    rngs = jax.random.split(jax.random.PRNGKey(0), len(CONFS))

    def total(p):
        loss, corr, new_bn = progs._losses(p, bn, conf, fa, fb, lb, la, label,
                                           wmask, True, rngs)
        return jnp.sum(loss), (loss, corr, new_bn)

    (_, (loss, corr, new_bn)), grads = jax.value_and_grad(
        total, has_aux=True)(params)
    return params, bn, conf, progs, loss, corr, new_bn, grads


def _port_side(spec, batch, dtype):
    params, bn = tpop.init_population(CONFS, spec, seed=3, device="cpu")
    params = {k: v.detach().to(dtype).requires_grad_(True)
              for k, v in params.items()}
    bn = {k: v.to(dtype) for k, v in bn.items()}
    conf = tpop.conf_tensors(CONFS, spec, "cpu")
    tb = tuple(torch.from_numpy(x) for x in batch)
    loss, corr, new_bn = tpop.population_losses(spec, params, bn, conf, tb,
                                                True)
    loss.sum().backward()
    return params, bn, conf, tb, loss, corr, new_bn


def _max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def test_population_init_is_bitwise_jax():
    args = small_args()
    spec_j = make_spec(jpop, args, batchnorm=True, use_alphas=True)
    spec_t = make_spec(tpop, args, batchnorm=True, use_alphas=True)
    pj, bj = jpop.init_population(CONFS, spec_j, seed=11)
    pt, bt = tpop.init_population(CONFS, spec_t, seed=11, device="cpu")
    assert set(pj) == set(pt) and set(bj) == set(bt)
    for k in pj:
        np.testing.assert_array_equal(pt[k].detach().numpy(),
                                      np.asarray(pj[k]))
    for k, v in jpop.encode_confs(CONFS, spec_j).items():
        np.testing.assert_array_equal(tpop.encode_confs(CONFS, spec_t)[k], v)


def test_population_step_matches_jax():
    args = small_args()
    kw = dict(batchnorm=True, use_alphas=True, multitask=True, drpt=0.0)
    spec_j, spec_t = make_spec(jpop, args, **kw), make_spec(tpop, args, **kw)
    batch = _step_inputs(spec_t)
    _, _, _, _, lj, cj, bnj, gj = _jax_side(spec_j, batch, jnp.float32)
    pt, _, _, _, lt, ct, bnt = _port_side(spec_t, batch, torch.float32)
    assert _max_rel(lt.detach(), lj) <= 1e-5
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    for k in gj:
        assert _max_rel(pt[k].grad, gj[k]) <= 1e-5, k
    for k in bnj:
        assert _max_rel(bnt[k], bnj[k]) <= 1e-5, k
    # the padded rows and the masked rows of short confs get no gradient
    W = pt["W"].grad
    assert float(W[0, 1:].abs().max()) == 0.0
    assert float(W[0, 0, :, spec_t.sizes_a[3]:spec_t.cmax_a].abs().max()) == 0


def test_population_adam_step_f64_matches_jax():
    """One train step in float64. The JAX package rounds Adam's bias
    corrections to float32 (1 - 0.999 is off by 1.3e-5 relative there), so
    at lr 1e-3 the two updates would differ by ~6e-9; lr 1e-4 keeps that
    under the 1e-9 bound and leaves everything else exact to f64."""
    args = small_args()
    kw = dict(batchnorm=True, use_alphas=True, multitask=True, drpt=0.0)
    spec_j, spec_t = make_spec(jpop, args, **kw), make_spec(tpop, args, **kw)
    batch = _step_inputs(spec_t, np.float64)
    lr = 1e-4
    with jax_x64():
        pj, bj, conf, progs, *_ = _jax_side(spec_j, batch, jnp.float64)
        fa, fb, lb, la, label, wmask = (jnp.asarray(x) for x in batch)
        pj2, bj2, _, lossj, corrj = progs._train_step_impl(
            pj, bj, jpop.adam_init(pj), conf, fa, fb, lb, la, label, wmask,
            jnp.float64(lr), jax.random.PRNGKey(0))
        pj2 = {k: np.asarray(v) for k, v in pj2.items()}
        bj2 = {k: np.asarray(v) for k, v in bj2.items()}
    params, bn = tpop.init_population(CONFS, spec_t, seed=3, device="cpu")
    params = {k: v.detach().double().requires_grad_(True)
              for k, v in params.items()}
    bn = {k: v.double() for k, v in bn.items()}
    adam = adam_init(list(params.values()))
    tb = tuple(torch.from_numpy(x) for x in batch)
    bn2, losst, corrt = tpop.train_step(spec_t, params, bn, adam,
                                        tpop.conf_tensors(CONFS, spec_t,
                                                          "cpu"), tb, lr)
    np.testing.assert_allclose(losst.numpy(), np.asarray(lossj), rtol=1e-12)
    np.testing.assert_array_equal(corrt.numpy(), np.asarray(corrj))
    for k, v in pj2.items():
        np.testing.assert_allclose(params[k].detach().numpy(), v, rtol=0,
                                   atol=1e-9, err_msg=k)
    for k, v in bj2.items():
        np.testing.assert_allclose(bn2[k].numpy(), v, rtol=0, atol=1e-9)


# --------------------------------------------------------------------------
# features
# --------------------------------------------------------------------------
def _clips(n=3, seed=0):
    rs = np.random.RandomState(seed)
    rgb = rs.randint(0, 256, (n, 4, 32, 32, 3)).astype(np.uint8)
    ske = (rs.randn(n, 3, 32, 25, 2) * 0.3).astype(np.float32)
    return rgb, ske


def _close(got, want, what):
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    bound = 1e-4 * np.abs(want) + 1e-5 * np.abs(want).max()
    assert got.shape == want.shape and np.all(np.abs(got - want) <= bound), \
        (what, np.abs(got - want).max(), np.abs(want).max())


def test_extractor_eval_features_match_jax():
    args = small_args()
    jx, tree, tx = jax_extractor(args)
    rgb, ske = _clips()
    jprep = jpack.make_device_normalize_inputs_prep()
    ja, jb, jlb, jla = jx.apply(tree, Ctx(train=False),
                                jprep((jnp.asarray(rgb), jnp.asarray(ske))))
    spec = make_spec(tpop, args)
    trainer = tpop.PopulationTrainer(
        spec, tx, device="cpu",
        input_prep=tpack.make_device_normalize_inputs_prep())
    tk.reset_launch_counts()
    fa, fb, lb, la = trainer._features(
        (torch.from_numpy(rgb), torch.from_numpy(ske)), False)
    # a CPU tensor takes K1's plain version: no kernel launch is counted
    assert tk.launch_counts["u8_normalize"] == 0
    for i, c in enumerate(spec.sizes_a):
        _close(fa[:, i, :c], ja[i], f"ske tap {i}")
        assert int(torch.count_nonzero(fa[:, i, c:])) == 0
    for i, c in enumerate(spec.sizes_b):
        _close(fb[:, i, :c], jb[i], f"rgb tap {i}")
    _close(lb, jlb, "rgb logits")
    _close(la, jla, "ske logits")


def test_train_mode_features_leave_backbone_buffers():
    args = small_args(["--drpt", "0.5"])
    _, _, tx = jax_extractor(args)
    before = {k: v.clone() for k, v in tx.state_dict().items()}
    trainer = tpop.PopulationTrainer(
        make_spec(tpop, args, drpt=0.5), tx, device="cpu",
        input_prep=tpack.make_device_normalize_inputs_prep())
    inputs = tuple(torch.from_numpy(x) for x in _clips())
    trainer.generator.manual_seed(0)
    train = trainer._features(inputs, True)
    evals = trainer._features(inputs, False)
    assert float((train[2] - evals[2]).abs().max()) > 1e-3  # batch stats
    for k, v in tx.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert not any(p.requires_grad for p in tx.parameters())


# --------------------------------------------------------------------------
# feature banks against their JAX twins
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = tmp_path_factory.mktemp("search_pop")
    for seed, (split, n) in enumerate((("trainexp", 10), ("dev", 6))):
        tpack.make_synthetic_packed_ntu(str(root / split), n=n, frames=6,
                                        h=32, w=32, skel_frames=40,
                                        num_classes=3, seed=seed)
    return root


def _loaders(pkg_data, pkg_pack, pkg_loader, root, args):
    tv = pkg_data.Compose([pkg_data.NormalizeLen(args.vid_len)])
    tt = pkg_data.Compose([pkg_data.AugCrop(seed=0),
                           pkg_data.NormalizeLen(args.vid_len)])
    tr = pkg_pack.PackedNTU(str(root / "trainexp"), transform=tt, args=args,
                            device_normalize=True)
    dv = pkg_pack.PackedNTU(str(root / "dev"), transform=tv, args=args,
                            device_normalize=True)
    return {"train": pkg_loader.MapLoader(tr, 4, shuffle=True, seed=0,
                                          num_workers=2),
            "dev": pkg_loader.MapLoader(dv, 4, num_workers=2)}


BANK_CONFS = CONFS + [np.array([[1, 1, 0]]), np.array([[3, 2, 1], [0, 0, 0]])]


def _run_jax(store, args, feature_dtype, **kw):
    jx, tree, _ = jax_extractor(args)
    spec = make_spec(jpop, args, feature_dtype=feature_dtype)
    trainer = jpop.PopulationTrainer(
        spec, jx.apply, tree,
        input_prep=jpack.make_device_normalize_inputs_prep(), **kw)
    loaders = _loaders(jntu, jpack, jloader, store, args)
    sizes = {k: v.dataset_size for k, v in loaders.items()}
    accs, _, _ = trainer.train_population(
        BANK_CONFS, loaders, sizes, JSched(1e-3, 1e-6, 1, 2, 2.5), 2,
        ("rgb", "ske"), seed=4)
    return accs


def _run_port(store, args, feature_dtype, **kw):
    _, _, tx = jax_extractor(args)
    spec = make_spec(tpop, args, feature_dtype=feature_dtype)
    trainer = tpop.PopulationTrainer(
        spec, tx, device="cpu",
        input_prep=tpack.make_device_normalize_inputs_prep(
            torch.bfloat16 if feature_dtype else None), **kw)
    loaders = _loaders(tntu, tpack, tloader, store, args)
    sizes = {k: v.dataset_size for k, v in loaders.items()}
    accs, _, _ = trainer.train_population(
        BANK_CONFS, loaders, sizes, TSched(1e-3, 1e-6, 1, 2, 2.5), 2,
        ("rgb", "ske"), seed=4)
    return accs, trainer


@pytest.mark.parametrize("variant", ["bf16", "int8_bank_batch"])
def test_feature_bank_matches_jax(store, variant):
    args = small_args()
    kw = dict(cache_train_features=True)
    if variant == "int8_bank_batch":
        kw.update(int8_bank=True, bank_batch=8)
    want = _run_jax(store, args, "bfloat16", **kw)
    got, trainer = _run_port(store, args, "bfloat16", **kw)
    assert got == want
    bank = trainer._train_bank
    assert int(bank["label"].shape[0]) == 10
    assert bank["fa"].dtype == (torch.int8 if "int8" in variant
                                else torch.bfloat16)


def test_streamed_population_matches_jax(store):
    """The default search path: train-mode features every batch, dev
    features cached, f32."""
    args = small_args()
    assert _run_port(store, args, None)[0] == _run_jax(store, args, None)


def test_unfused_bank_path_equals_fused(store):
    args = small_args()
    kw = dict(cache_train_features=True)
    fused, _ = _run_port(store, args, None, **kw)
    unfused, trainer = _run_port(store, args, None, fused_epochs=False, **kw)
    assert unfused == fused
    assert trainer._dev_cache is not None and trainer._dev_bank is None


# --------------------------------------------------------------------------
# weight sharing
# --------------------------------------------------------------------------
def test_shared_states_roundtrip_with_jax_keys():
    args = small_args()
    spec_j = make_spec(jpop, args, batchnorm=True)
    spec_t = make_spec(tpop, args, batchnorm=True)
    params, bn = tpop.init_population(CONFS, spec_t, seed=2, device="cpu")
    rows = torch.from_numpy(tpop.encode_confs(CONFS, spec_t)["row_mask"]
                            )[..., None] > 0
    with torch.no_grad():    # non-trivial BatchNorm values on the real rows
        params["bn_scale"].copy_(torch.where(
            rows, torch.rand(rows.shape[:2] + (16,)) + 0.5, 1.0))
        bn["mean"].copy_(torch.where(rows, torch.randn(bn["mean"].shape),
                                     0.0))
    store_t = tpop.extract_shared_states(params, bn, CONFS, spec_t, {})
    store_j = jpop.extract_shared_states(
        {k: jnp.asarray(v.detach().numpy()) for k, v in params.items()},
        {k: jnp.asarray(v.numpy()) for k, v in bn.items()}, CONFS, spec_j, {})
    assert set(store_t) == set(store_j)
    assert len(store_t) == sum(len(c) for c in CONFS)
    for key, entry in store_j.items():
        flat_j = flatten_tree(entry)
        flat_t = flatten_tree(store_t[key])
        assert set(flat_t) == set(flat_j)
        for k, v in flat_j.items():
            np.testing.assert_array_equal(flat_t[k], np.asarray(v))

    fresh, fresh_bn = tpop.init_population(CONFS, spec_t, seed=9,
                                           device="cpu")
    back, back_bn = tpop.inject_shared_states(fresh, fresh_bn, CONFS, spec_t,
                                              store_t)
    for k in ("W", "b", "bn_scale", "bn_bias"):
        torch.testing.assert_close(back[k], params[k], rtol=0, atol=0)
    torch.testing.assert_close(back_bn["mean"], bn["mean"], rtol=0, atol=0)
    # a store with unknown keys leaves the population as initialized
    same, _ = tpop.inject_shared_states(fresh, fresh_bn, CONFS, spec_t,
                                        {"9.L_1_16.A_relu": {}})
    torch.testing.assert_close(same["W"], fresh["W"], rtol=0, atol=0)
