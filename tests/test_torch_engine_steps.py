"""The engines' train and eval steps and the streamed population steps over
several steps, JAX package against the port, on the CPU.

The JAX side is the jitted program the port's CUDA graphs stand for: the
engine's ``_train_step`` / ``_eval_step`` (mfas_tpu/engine/classifier.py)
and the population's ``train_step`` / ``eval_step``
(mfas_tpu/search/population.py). The port's side is the entry the loops
call, ``train_step`` / ``eval_step``, both eagerly and graphed through the
eager stand-in of tests/test_torch_step_graphs.py (the card's bookkeeping,
the CPU's arithmetic), from the JAX nets' initial weights.

* three engine train steps at falling learning rates, then an eval step,
  in float64: a small found-NTU net (--batchnorm, both phases), AV-MNIST's
  found net (both phases) and CIFAR's fixed net with --use_intermediate and
  DropPath at keep ~1e-9 (every block's first path drops whatever either
  package draws; dropout streams differ, so drop_prob is 0). The JAX
  package rounds Adam's bias corrections to float32, which puts each update
  ~6.7e-6 of itself off torch's: the first step's loss within 1e-10
  relative, the later ones' within 1e-5 (an update moves every parameter
  coherently, so the loss moves by that share of what the step changed:
  measured 1.8e-6), every step's corrects equal. Every parameter's move
  over the three steps within 1e-3 of the norm of JAX's move: an element
  whose gradient is near Adam's eps moves by lr*g/(|g|+eps), which turns
  gradients that agree to float64 rounding into up to ~lr of difference
  for that element (measured 6.6e-6 at summed rates of 2.1e-3, a few
  elements of a tensor); a lost or doubled step misses by ~30 %. BatchNorm
  statistics within 1e-5 of their layer's largest statistic: after the
  first step they follow those parameters (measured 2.3e-6, the NTU fusion
  head's BatchNorm1d). --alphas off: JAX moves the
  unused gates by weight decay, torch never steps them (grad None), so
  they are held as built in the port;
  CIFAR's dead and dropped parameters as built, the dropped ones with no
  Adam step and zero moments, the analytically vanishing biases (noise
  that Adam turns into +-lr) held to have moved by at most the summed
  rates. The eval step runs JAX's ``_eval_step`` on the port's weights
  after the steps: loss within 1e-10 relative, the same corrects;
* three streamed population steps (P=4, --batchnorm, alphas, multitask,
  drpt 0) through ``_StreamedSteps`` against JAX's ``train_step`` with its
  ``adam_update``, then ``eval_step``, in float32 at
  test_torch_search_population.py's tolerance: each step's and the eval
  step's corrects equal, the BatchNorm state within 1e-4 of each tensor's
  max (after the first step it follows the parameters: measured 2.3e-5),
  each parameter's move within 1e-2 of the norm of JAX's (in float32
  more elements sit near Adam's eps; the loss is held per step there).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfas_tpu.core import flatten_tree, unflatten_tree
from mfas_tpu.core.module import merge
from mfas_tpu.core.optim import adam_init
from mfas_tpu.engine.cifar import CifarEngine as JCifarEngine
from mfas_tpu.engine.classifier import ClassifierEngine as JEngine
from mfas_tpu.engine.classifier import split_tree
from mfas_tpu.fusion import cifar as jfc
from mfas_tpu.fusion.ntu import Searchable_Skeleton_Image_Net
from mfas_tpu.search import population as jpop
from mfas_tpu_torch import main_found_ntu as tmain
from mfas_tpu_torch.data import ntu_pack as tpack
from mfas_tpu_torch.engine.cifar import CifarEngine
from mfas_tpu_torch.engine.classifier import ClassifierEngine, set_trainable
from mfas_tpu_torch.fusion import cifar as tfc
from mfas_tpu_torch.search import population as tpop
from tests import test_torch_avmnist as av
from tests import test_torch_cifar as cf
from tests import test_torch_found_ntu_train as ntu
from tests import test_torch_search_population as sp
from tests.test_torch_found_ntu_train import fx  # noqa: F401
from tests.test_torch_step_graphs import eager_graphs  # noqa: F401

LRS = (1e-3, 7e-4, 4e-4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: under a parallel test runner every split op
    waits on threads the other workers' processes hold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _f64(flat):
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v
            for k, v in flat.items()}


def _jax_steps(jeng, jnet, flat, prefixes, batches, per_leaf=False):
    """The JAX engine's jitted train step over ``batches`` at LRS in
    float64: per-step (loss, corrects) and the flat state after."""
    with sp.jax_x64():
        tree = unflatten_tree({k: jnp.asarray(v)
                               for k, v in _f64(flat).items()})
        trainable, frozen = split_tree(jnet, tree, prefixes)
        opt = adam_init(trainable, per_leaf_step=per_leaf)
        out = []
        for b, lr in zip(batches, LRS):
            trainable, frozen, opt, loss, corr = jeng._train_step(
                trainable, frozen, opt,
                {k: jnp.asarray(v) for k, v in b.items()}, jnp.float32(lr),
                jax.random.PRNGKey(0))
            out.append((float(loss), float(corr)))
        after = {k: np.asarray(v) for k, v in
                 flatten_tree(merge(trainable, frozen)).items()}
    return out, after


def _jax_eval(jeng, jnet, state, batch):
    """JAX's jitted eval step on the port's state: (loss, corrects)."""
    with sp.jax_x64():
        tree = unflatten_tree({k: jnp.asarray(v) for k, v in state.items()})
        trainable, frozen = split_tree(jnet, tree, None)
        loss, corr = jeng._eval_step(
            trainable, frozen, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), float(corr)


def _port_steps(eng, model, prefixes, batches, dev, graphed):
    """The port's train_step over ``batches`` at LRS, then eval_step on
    ``dev``: per-step (loss, corrects), the state after, the dev (loss,
    corrects) and the optimizer."""
    eng.graphed = graphed
    set_trainable(model, prefixes)
    model.train()
    opt = eng.make_optimizer()
    out = []
    for b, lr in zip(batches, LRS):
        loss, corr = eng.train_step(
            {k: torch.from_numpy(np.array(v)) for k, v in b.items()}, opt, lr)
        out.append((float(loss), float(corr)))
    after = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    model.eval()
    dl, dc, _ = eng.eval_step({k: torch.from_numpy(np.array(v))
                               for k, v in dev.items()})
    return out, after, (float(dl), float(dc)), opt


def _compare(got, want, flat, skip=()):
    """(per-step, after) pairs of both packages, module docstring."""
    (gsteps, gafter), (wsteps, wafter) = got, want
    for i, ((gl, gc), (wl, wc)) in enumerate(zip(gsteps, wsteps)):
        np.testing.assert_allclose(gl, wl, rtol=1e-10 if i == 0 else 1e-5)
        assert gc == wc
    for k, w in wafter.items():
        g = gafter[k]
        if k in skip:
            continue
        if k.endswith("num_batches_tracked"):
            assert int(g) == int(w) == len(LRS), k
        elif k.endswith(("running_mean", "running_var")):
            layer = k.rsplit(".", 1)[0]
            scale = max(np.abs(wafter[f"{layer}.{s}"]).max()
                        for s in ("running_mean", "running_var"))
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * scale,
                                       err_msg=k)
        else:
            _moved_close(g, w, flat[k], 1e-3, k)


def _moved_close(got, want, start, rel, what):
    """How far the parameter moved in each package: the two moves within
    ``rel`` of the JAX move's norm."""
    got, want, start = (np.asarray(x, np.float64) for x in (got, want, start))
    moved = np.linalg.norm(want - start)
    assert np.linalg.norm(got - want) <= rel * moved, (
        what, np.linalg.norm(got - want), moved)


MODES = ["eager", "graphed"]


def _mode(request, mode):
    if mode == "graphed":
        request.getfixturevalue("eager_graphs")
    return mode == "graphed"


# --------------------------------------------------------------------------
# the engine's steps: found NTU, AV-MNIST, CIFAR
# --------------------------------------------------------------------------
def _ntu_batches(fx):
    """Three train batches of 2 clips and a dev batch of 3 (one padded),
    normalized clips in float64 (the input prep is held elsewhere)."""
    def batch(split, idx, mask):
        host = ntu._host_batch(fx, split, idx)
        rgb = tpack.make_device_normalize_prep(torch.float64)(
            {"rgb": torch.from_numpy(host["rgb"])})["rgb"].numpy()
        return dict(rgb=rgb, ske=host["ske"].astype(np.float64),
                    label=host["label"],
                    _mask=np.asarray(mask, np.float64))
    return ([batch("train", idx, [1, 1]) for idx in ((0, 1), (2, 3), (4, 0))],
            batch("dev", (0, 1, 2, 0), [1, 1, 1, 0]))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("phase", ["central", "whole"])
def test_ntu_engine_steps_match_jax(fx, request, phase, mode):
    graphed = _mode(request, mode)
    args = ntu._args(fx, "--batchnorm")
    jnet = Searchable_Skeleton_Image_Net(args, tmain.FOUND_CONFS[4])
    flat = {k: np.asarray(v) for k, v in flatten_tree(jnet.init(0)).items()}
    prefixes = jnet.central_params() if phase == "central" else None
    batches, dev = _ntu_batches(fx)
    jeng = JEngine(jnet, multitask=True, input_keys=("rgb", "ske"))
    want = _jax_steps(jeng, jnet, flat, prefixes, batches)
    model = ntu._port_model(args, flat).double()
    eng = ClassifierEngine(model, "cpu", multitask=True,
                           input_keys=("rgb", "ske"))
    steps, after, (dl, dc), _ = _port_steps(eng, model, prefixes, batches,
                                            dev, graphed)
    alphas = {k for k in flat if k.startswith("alphas.")}
    _compare((steps, after), want, flat, skip=alphas)
    for k in alphas:
        np.testing.assert_array_equal(after[k], flat[k])
    jl, jc = _jax_eval(jeng, jnet, after, dev)
    np.testing.assert_allclose(dl, jl, rtol=1e-10)
    assert dc == jc


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("phase", ["central", "whole"])
def test_avmnist_engine_steps_match_jax(request, phase, mode):
    graphed = _mode(request, mode)
    args = av._args()
    jnet, flat, tnet = av._searchable(args, tmain.FOUND_CONFS[0])
    prefixes = jnet.central_params() if phase == "central" else None

    def batch(seed, mask):
        image, audio, label = av._inputs(len(mask), seed=seed)
        return {"image": image.astype(np.float64),
                "audio": audio.astype(np.float64), "label": label,
                "_mask": np.asarray(mask, np.float64)}

    batches = [batch(s, [1] * 6) for s in (1, 2, 3)]
    dev = batch(4, [1, 1, 1, 1, 0])
    jeng = JEngine(jnet, multitask=True, input_keys=("image", "audio"))
    want = _jax_steps(jeng, jnet, flat, prefixes, batches)
    eng = ClassifierEngine(tnet.double(), "cpu", multitask=True,
                           input_keys=("image", "audio"))
    steps, after, (dl, dc), _ = _port_steps(eng, tnet, prefixes, batches,
                                            dev, graphed)
    alphas = {k for k in flat if k.startswith("alphas.")}
    _compare((steps, after), want, flat, skip=alphas)
    for k in alphas:
        np.testing.assert_array_equal(after[k], flat[k])
    jl, jc = _jax_eval(jeng, jnet, after, dev)
    np.testing.assert_allclose(dl, jl, rtol=1e-10)
    assert dc == jc


@pytest.mark.parametrize("mode", MODES)
def test_cifar_engine_steps_skip_dropped_paths(request, mode):
    graphed = _mode(request, mode)
    keep = dict(drop_path=1.0 - 1e-9)
    jnet = jfc.Searchable_MicroCNN(cf.cifar_args(**keep), cf.CONF,
                                   fixed=True)
    flat = cf._flat(jnet, seed=1)
    tnet = cf._port(tfc.Searchable_MicroCNN(
        cf.cifar_args(**keep), cf.CONF, fixed=True, **cf.KW), flat).double()
    batches = [cf._batch(seed=s) for s in (4, 5, 6)]
    dev = cf._batch(seed=7)
    jeng = JCifarEngine(jnet, use_intermediate=True)
    want = _jax_steps(jeng, jnet, flat, None, batches, per_leaf=True)
    eng = CifarEngine(tnet, "cpu", use_intermediate=True)
    steps, after, (dl, dc), opt = _port_steps(eng, tnet, None, batches, dev,
                                              graphed)
    dead = {k for k in flat if k.startswith(cf.DEAD_FR)
            and not k.endswith(("running_mean", "running_var",
                                "num_batches_tracked"))}
    dropped = {k for k in flat if ".op1." in k
               and not k.endswith(("running_mean", "running_var",
                                   "num_batches_tracked"))}
    assert dead and len(dropped) == 3 * (3 + 6)
    _compare((steps, after), want, flat,
             skip=dead | dropped | cf.VANISHING)
    state = {n: opt.state.get(p, {}) for n, p in tnet.named_parameters()}
    for k in dead | dropped:
        np.testing.assert_array_equal(after[k], flat[k], err_msg=k)
        np.testing.assert_array_equal(want[1][k], flat[k], err_msg=k)
    for k in dropped:
        assert float(state[k]["step"]) == 0.0, k
        assert not state[k]["exp_avg"].any(), k
        assert not state[k]["exp_avg_sq"].any(), k
    for k in dead:
        assert not state[k], k          # never had a gradient
    for k in cf.VANISHING:
        assert np.abs(after[k] - flat[k]).max() <= sum(LRS) * (1 + 1e-6)
    jl, jc = _jax_eval(jeng, jnet, after, dev)
    np.testing.assert_allclose(dl, jl, rtol=1e-10)
    assert dc == jc


# --------------------------------------------------------------------------
# the streamed population steps
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
def test_streamed_population_steps_match_jax(request, mode):
    graphed = _mode(request, mode)
    args = sp.small_args()
    kw = dict(batchnorm=True, use_alphas=True, multitask=True, drpt=0.0)
    spec_j, spec_t = sp.make_spec(jpop, args, **kw), sp.make_spec(
        tpop, args, **kw)
    batch = sp._step_inputs(spec_t)
    pj, bj, conf, progs, *_ = sp._jax_side(spec_j, batch, jnp.float32)
    start = {k: np.asarray(v) for k, v in pj.items()}
    opt = jpop.adam_init(pj)
    rs = np.random.RandomState(9)
    batches = []
    for _ in LRS:         # the same taps, a fresh masked row order
        order = rs.permutation(len(batch[0]))
        batches.append(tuple(x[order] for x in batch))
    jc = []
    for b, lr in zip(batches, LRS):
        pj, bj, opt, _, corr = progs.train_step(
            pj, bj, opt, conf, *(jnp.asarray(x) for x in b),
            jnp.float32(lr), jax.random.PRNGKey(0))
        jc.append(np.asarray(corr))
    jdev = progs.eval_step(pj, bj, conf, *(jnp.asarray(x) for x in batch))

    params, bn = tpop.init_population(sp.CONFS, spec_t, seed=3, device="cpu")
    tconf = tpop.conf_tensors(sp.CONFS, spec_t, "cpu")
    prog = tpop._StreamedSteps(spec_t, params, bn, tconf,
                               device=torch.device("cpu"), graphed=graphed)
    prog.load(params, bn, tconf)
    gen = torch.Generator().manual_seed(0)
    corr = []
    for b, lr in zip(batches, LRS):
        tb = tuple(torch.from_numpy(x) for x in b)
        prog.train_batch(tb[:4], tb[4], tb[5], lr, gen)
        corr.append(prog.counts("corr"))
    for c, w in zip(corr, jc):
        np.testing.assert_array_equal(c.numpy(), w)
    prog.eval_batch(tuple(torch.from_numpy(x) for x in batch))
    np.testing.assert_array_equal(prog.counts("dev_corr").numpy(),
                                  np.asarray(jdev[1]))
    got_p, got_bn = prog.state()
    for k, v in pj.items():
        _moved_close(got_p[k].detach().numpy(), v, start[k], 1e-2, k)
    for k, v in bj.items():
        assert sp._max_rel(got_bn[k], v) <= 1e-4, k
