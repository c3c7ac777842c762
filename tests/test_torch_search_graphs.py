"""The search's single-dispatch programs, JAX package against the port, on
the CPU, where the port runs their step functions eagerly (the plain
versions of its CUDA graphs):

* the surrogate's padded, masked fit: 50 epochs over four length groups of
  unequal size from the JAX initial weights; the padded arrays are JAX's
  bitwise, the loss, every parameter and the predictions (``eval_models``,
  ``eval_model``) within 1e-5 of each tensor's max, the Adam moments within
  1e-4 (the test says why); a JAX-written Adam
  state loads into the port's and both fits continue alike;
* the fused bank epoch (``_FusedEpochs``) against JAX's ``train_epoch`` /
  ``eval_epoch`` over two epochs with BatchNorm, alphas and the multitask
  loss, in float64: parameters, BatchNorm state and Adam moments within
  1e-9, the correct counts equal;
* with dropout, the fused epoch draws the per-step loop's masks from the
  trainer's generator and leaves it in the same state; the per-step loop
  steps the same ``adam_update``, so in float64 at small learning rates the
  parameters and BatchNorm state agree within 1e-9;
* a cached program reloaded with a second population starts that
  population afresh (zeroed Adam state), bitwise a new program's;
* a --cache_features --batchnorm search interrupted after its first step
  and resumed ends as the uninterrupted one.
"""

import contextlib
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfas_tpu.core import flatten_tree
from mfas_tpu.search import population as jpop
from mfas_tpu.search.surrogate import SimpleRecurrentSurrogate as JSurrogate
from mfas_tpu_torch import main_searchable_ntu as tmain
from mfas_tpu_torch.core.optim import adam_init
from mfas_tpu_torch.search import population as tpop
from mfas_tpu_torch.search import searcher as tsearcher
from mfas_tpu_torch.search import surrogate as tsur
from tests.test_torch_search_ntu import _pairs, _steps_saved, write_store

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: under a parallel test runner every split op
    waits on threads the other workers' processes hold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, what, tol=TOL):
    got = np.asarray(got.detach().cpu() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (what, err)


# --------------------------------------------------------------------------
# the surrogate
# --------------------------------------------------------------------------
def _recording(fn, calls):
    def wrapped(*a, **k):
        calls.append([np.asarray(x) for x in a])
        return fn(*a, **k)
    return wrapped


def _groups(rs, sizes):
    """One (L, N, 3) conf group per (L, N) and its (N, 1) accuracies."""
    confs = [np.stack([rs.randint(0, 4, (L, n)), rs.randint(0, 4, (L, n)),
                       rs.randint(0, 2, (L, n))], -1).astype(np.float32)
             for L, n in sizes]
    accs = [rs.uniform(0.1, 0.9, (n, 1)).astype(np.float32)
            for _, n in sizes]
    return confs, accs


def _surrogates():
    js = JSurrogate(100, 3, 100, seed=0, max_seq_len=4)
    ts = tsur.SimpleRecurrentSurrogate(100, 3, 100, max_seq_len=4,
                                       device="cpu")
    ts.load_numpy(jax.tree_util.tree_map(np.asarray, js.params))
    return js, ts


def _check_params(ts, js):
    for k, v in flatten_tree(js.params).items():
        _close(ts.net.state_dict()[k], v, k)


def test_padded_surrogate_fit_matches_jax():
    js, ts = _surrogates()
    calls = []
    js._fit_scan = _recording(js._fit_scan, calls)
    dc, da = _groups(np.random.RandomState(4),
                     [(1, 5), (2, 19), (3, 3), (4, 11)])
    lj = js.fit(dc, da, num_epochs=50, lr=1e-3)
    lt = ts.fit(dc, da, num_epochs=50, lr=1e-3)
    # JAX's padded arrays: (G, Lp=4, B=32, 3), lengths, targets, masks
    seqs, lengths, tgts, masks = tsur.pad_groups(dc, da, 4)
    assert seqs.shape == (4, 4, 32, 3)
    for got, want in zip((seqs, lengths, tgts, masks), calls[0][2:6]):
        np.testing.assert_array_equal(got, want)
    assert abs(lt - lj) <= TOL * abs(lj)
    _check_params(ts, js)
    # the moments average gradients in which the padded batch's summation
    # order shows: the LSTM biases' first moment, a sum of cancelling
    # terms, sits 1.1e-5 of its max from JAX's, the parameters 1.2e-6
    opt = ts.opt_state_numpy()
    assert int(opt["step"]) == int(np.asarray(js.opt_state["step"])) == 200
    for k in ("m", "v"):
        for name, v in flatten_tree(js.opt_state[k]).items():
            _close(flatten_tree(opt[k])[name], v, f"{k} {name}", 1e-4)


def test_padded_predictions_match_jax():
    js, ts = _surrogates()
    dc, da = _groups(np.random.RandomState(5), [(2, 9), (4, 6)])
    js.fit(dc, da, num_epochs=3, lr=1e-2)
    ts.fit(dc, da, num_epochs=3, lr=1e-2)
    rs = np.random.RandomState(6)
    confs = [np.stack([rs.randint(0, 4, L), rs.randint(0, 4, L),
                       rs.randint(0, 2, L)], 1) for L in (1, 3, 2, 4, 1)]
    calls = []
    js._predict = _recording(js._predict, calls)
    _close(ts.eval_models(confs), js.eval_models(confs), "eval_models")
    seq, lengths = tsur.pad_confs([c.astype(np.float32) for c in confs], 4)
    assert seq.shape == (4, 8, 3)
    np.testing.assert_array_equal(seq, calls[0][1])
    np.testing.assert_array_equal(lengths, calls[0][2])
    for c in confs[:2]:
        _close(ts.eval_model(c), js.eval_model(c), "eval_model")
    assert ts.eval_models([]) == []


def test_jax_adam_state_continues_in_port():
    """A search state carries the JAX layout: the port loads JAX's Adam
    moments and step into its own and the next fit agrees."""
    js, _ = _surrogates()
    dc, da = _groups(np.random.RandomState(7), [(1, 7), (3, 4)])
    js.fit(dc, da, num_epochs=5, lr=1e-3)
    ts = tsur.SimpleRecurrentSurrogate(100, 3, 100, max_seq_len=4,
                                       device="cpu")
    assert ts.opt_state_numpy() is None
    tree = jax.tree_util.tree_map(np.asarray, js.opt_state)
    ts.load_numpy(jax.tree_util.tree_map(np.asarray, js.params), tree)
    back = ts.opt_state_numpy()
    assert back["step"].dtype == np.int32 and int(back["step"]) == 10
    for k in ("m", "v"):
        for name, v in flatten_tree(tree[k]).items():
            np.testing.assert_array_equal(flatten_tree(back[k])[name], v)
    lj = js.fit(dc, da, num_epochs=4, lr=1e-3)
    lt = ts.fit(dc, da, num_epochs=4, lr=1e-3)
    assert abs(lt - lj) <= TOL * abs(lj)
    _check_params(ts, js)


# --------------------------------------------------------------------------
# the fused bank epoch
# --------------------------------------------------------------------------
CONFS = [np.array([[1, 0, 0]]),
         np.array([[0, 1, 1], [1, 1, 0]]),
         np.array([[1, 1, 2], [0, 0, 1], [1, 0, 0]]),
         np.array([[0, 0, 2], [1, 1, 1]]),
         np.array([[1, 0, 1]])]
SIZES = dict(sizes_a=(3, 5), sizes_b=(4, 6), hidden=8, num_outputs=3,
             max_rows=3)


def _bank(rs, n):
    def taps(sizes):
        t = np.zeros((n, len(sizes), max(sizes)), np.float32)
        for i, c in enumerate(sizes):
            t[:, i, :c] = rs.randn(n, c)
        return t
    return {"fa": taps(SIZES["sizes_a"]), "fb": taps(SIZES["sizes_b"]),
            "lb": rs.randn(n, 3).astype(np.float32),
            "la": rs.randn(n, 3).astype(np.float32),
            "label": rs.randint(0, 3, n).astype(np.int32)}


def _port_bank(bank):
    return {k: torch.from_numpy(v.astype(np.int64) if k == "label" else v)
            for k, v in bank.items()}


def _plans(rs, n, bs, epochs):
    out = []
    for e in range(epochs):
        take, wm = tpop.PopulationTrainer._epoch_index_plan(n, bs, rs)
        etas = (1e-2 * (0.5 ** e)
                * np.linspace(1.0, 0.5, take.shape[0])).astype(np.float32)
        out.append((take, wm, etas))
    return out


def _port_program(spec, confs, bank, dev_bank, seed=3, bs=4, dev_bs=3):
    params, bn = tpop.init_population(confs, spec, seed=seed, device="cpu")
    conf = tpop.conf_tensors(confs, spec, "cpu")
    prog = tpop._FusedEpochs(spec, params, bn, conf, bank, dev_bank, bs,
                             dev_bs, device=torch.device("cpu"),
                             graphed=False)
    prog.load(params, bn, conf, bank, dev_bank)
    return prog, params, bn, conf


@contextlib.contextmanager
def jax_x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _f64(tree):
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v
            for k, v in tree.items()}


def test_fused_epoch_matches_jax_train_and_eval_epoch():
    """Two epochs in float64 (Adam turns f32 gradient rounding into ~lr
    differences wherever a gradient nearly vanishes): both packages round
    only the bias corrections and the learning rates to float32, so the
    parameters, BatchNorm state and moments agree within 1e-9 (absolute),
    test_torch_search_population.py's bound for an f64 Adam step."""
    kw = dict(batchnorm=True, use_alphas=True, multitask=True, drpt=0.0)
    spec_j = jpop.PopulationSpec(**SIZES, **kw)
    spec_t = tpop.PopulationSpec(**SIZES, **kw)
    rs = np.random.RandomState(11)
    bank, dev_bank = _f64(_bank(rs, 10)), _f64(_bank(rs, 7))
    plans = _plans(rs, 10, 4, 2)
    dev_take, dev_wm = tpop.PopulationTrainer._epoch_index_plan(7, 3)
    p0, bn0 = (_f64(_numpy_tree(t))
               for t in jpop.init_population(CONFS, spec_j, seed=3))

    with jax_x64():
        progs = jpop.population_programs(spec_j, None, None, None)
        params = {k: jnp.asarray(v) for k, v in p0.items()}
        bn = {k: jnp.asarray(v) for k, v in bn0.items()}
        opt = jpop.adam_init(params)
        conf = {k: jnp.asarray(v)
                for k, v in jpop.encode_confs(CONFS, spec_j).items()}
        jb = {k: jnp.asarray(v) for k, v in bank.items()}
        jdb = {k: jnp.asarray(v) for k, v in dev_bank.items()}
        want = []
        for take, wm, etas in plans:
            params, bn, opt, corr = progs.train_epoch(
                params, bn, opt, conf, jb, jnp.asarray(take),
                jnp.asarray(wm), jnp.asarray(etas), jax.random.PRNGKey(0))
            dev = progs.eval_epoch(params, bn, conf, jdb,
                                   jnp.asarray(dev_take), jnp.asarray(dev_wm))
            want.append((np.asarray(corr), np.asarray(dev)))
        params, bn = _numpy_tree(params), _numpy_tree(bn)
        opt = {k: _numpy_tree(opt[k]) for k in ("m", "v")}

    tp = {k: torch.from_numpy(v) for k, v in p0.items()}
    tbn = {k: torch.from_numpy(v) for k, v in bn0.items()}
    conf = tpop.conf_tensors(CONFS, spec_t, "cpu")
    tb, tdb = _port_bank(bank), _port_bank(dev_bank)
    prog = tpop._FusedEpochs(spec_t, tp, tbn, conf, tb, tdb, 4, 3,
                             device=torch.device("cpu"), graphed=False)
    prog.load(tp, tbn, conf, tb, tdb)
    gen = torch.Generator().manual_seed(0)
    for (take, wm, etas), (corr, dev) in zip(plans, want):
        np.testing.assert_array_equal(
            prog.train_epoch(take, wm, etas, gen).numpy(), corr)
        np.testing.assert_array_equal(prog.eval_epoch().numpy(), dev)
    got_p, got_bn = prog.state()
    assert got_p["W"].dtype == torch.float64
    for got, ref in ((got_p, params), (got_bn, bn),
                     *((dict(zip(got_p, prog.st["adam"][k])), opt[k])
                       for k in ("m", "v"))):
        for k, v in ref.items():
            np.testing.assert_allclose(got[k].detach().numpy(), v, rtol=0,
                                       atol=1e-9, err_msg=k)
    assert int(prog.st["adam"]["step"]) == 6


def _numpy_tree(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def test_fused_epoch_draws_the_per_step_loops_dropout():
    """Float64 at learning rates near 1e-5: both paths step
    ``adam_update`` (the per-step loop at the float32-rounded rate, the
    epoch at its float32 plan), while one dropout mask drawn differently
    would move a parameter by ~lr."""
    spec = tpop.PopulationSpec(**SIZES, batchnorm=True, use_alphas=True,
                               drpt=0.5)
    rs = np.random.RandomState(12)
    bank = _port_bank(_f64(_bank(rs, 10)))
    dev_bank = _port_bank(_f64(_bank(rs, 7)))
    (take, wm, etas), = _plans(rs, 10, 4, 1)
    etas = (etas * 1e-3).astype(np.float32)
    params, bn = tpop.init_population(CONFS, spec, seed=3, device="cpu")
    params = {k: v.detach().double().requires_grad_()
              for k, v in params.items()}
    bn = {k: v.double() for k, v in bn.items()}
    conf = tpop.conf_tensors(CONFS, spec, "cpu")
    prog = tpop._FusedEpochs(spec, params, bn, conf, bank, dev_bank, 4, 3,
                             device=torch.device("cpu"), graphed=False)
    prog.load(params, bn, conf, bank, dev_bank)
    g_fused = torch.Generator().manual_seed(5)
    corr = prog.train_epoch(take, wm, etas, g_fused).clone()
    got_p, got_bn = prog.state()

    trainer = tpop.PopulationTrainer(spec, torch.nn.Sequential(),
                                     device="cpu")
    adam = adam_init(list(params.values()))
    g_loop = torch.Generator().manual_seed(5)
    terms = []
    for take_s, wm_s, eta in zip(take, wm, etas):
        bn, _, c = tpop.train_step(spec, params, bn, adam, conf,
                                   trainer._bank_batch(bank, take_s, wm_s),
                                   float(eta), g_loop)
        terms.append(c)
    assert torch.equal(g_fused.get_state(), g_loop.get_state())
    np.testing.assert_array_equal(corr.numpy(), sum(terms).numpy())
    for got, ref in ((got_p, params), (got_bn, bn)):
        for k, v in ref.items():
            np.testing.assert_allclose(got[k].detach().numpy(),
                                       v.detach().numpy(), rtol=0,
                                       atol=1e-9, err_msg=k)


def test_cached_program_restarts_each_population():
    spec = tpop.PopulationSpec(**SIZES, batchnorm=True)
    rs = np.random.RandomState(13)
    bank, dev_bank = _port_bank(_bank(rs, 10)), _port_bank(_bank(rs, 7))
    (take, wm, etas), = _plans(rs, 10, 4, 1)
    first = [CONFS[i] for i in (0, 2, 4, 1, 3)]

    def load(prog, confs, seed):
        params, bn = tpop.init_population(confs, spec, seed=seed,
                                          device="cpu")
        prog.load(params, bn, tpop.conf_tensors(confs, spec, "cpu"), bank,
                  dev_bank, bank_key="bank")
        prog.train_epoch(take, wm, etas, torch.Generator().manual_seed(1))
        return prog.eval_epoch().clone(), prog.state()

    params, bn = tpop.init_population(first, spec, seed=1, device="cpu")
    conf = tpop.conf_tensors(first, spec, "cpu")
    prog = tpop.fused_epochs(spec, params, bn, conf, bank, dev_bank, 4, 3,
                             device="cpu")
    assert tpop.fused_epochs(spec, params, bn, conf, bank, dev_bank, 4, 3,
                             device="cpu") is prog
    assert tpop.fused_epochs(spec, params, bn, conf, bank, dev_bank, 5, 3,
                             device="cpu") is not prog
    load(prog, first, 1)
    dev, (p, b) = load(prog, CONFS, 2)
    fresh, *_ = _port_program(spec, CONFS, bank, dev_bank, seed=2)
    dev_f, (p_f, b_f) = load(fresh, CONFS, 2)
    assert torch.equal(dev, dev_f)
    for k in p:
        assert torch.equal(p[k], p_f[k]), k
    for k in b:
        assert torch.equal(b[k], b_f[k]), k


# --------------------------------------------------------------------------
# a search state across the fused epochs and the padded fits
# --------------------------------------------------------------------------
SMALL = ["--num_outputs", "3", "--batchsize", "4", "--vid_len", "4", "32",
         "--resnet3d_layers", "1", "1", "1", "1", "--resnet3d_base_width",
         "8", "--j", "2", "--epochs", "2", "--epochs_surrogate", "3",
         "--num_samples", "3", "--device_input_normalize",
         "--random_backbones", "--no-verbose", "--seed", "0",
         "--cache_features", "--batchnorm", "--search_iterations", "2",
         "--max_fusions", "2"]


def test_crash_resumed_bank_search_equals_uninterrupted(tmp_path,
                                                        monkeypatch):
    write_store(tmp_path)
    base = ["--packed_datadir", str(tmp_path / "packed"), "--checkpointdir",
            str(tmp_path), *SMALL]
    saved = _steps_saved(monkeypatch, tsearcher)
    full = tmain.main(base + ["--search_state", str(tmp_path / "full.pkl")],
                      device="cpu")
    assert len(saved) == 4 and full.candidates == 32 + 3 * 3
    resume = str(tmp_path / "resume.pkl")
    shutil.copy(saved[0], resume)
    argv = base + ["--search_state", resume, "--resume_search"]
    argv[argv.index("--seed") + 1] = "7"
    resumed = tmain.main(argv, device="cpu")
    assert resumed.candidates == 3 * 3
    assert _pairs(resumed.data) == _pairs(full.data)
    st_full = tsearcher.ModelSearcher.load_state(saved[3])
    st_res = tsearcher.ModelSearcher.load_state(resume)
    for k in ("m", "v"):
        for name, v in flatten_tree(st_full["surrogate_opt_state"][k]
                                    ).items():
            np.testing.assert_array_equal(
                flatten_tree(st_res["surrogate_opt_state"][k])[name], v)
