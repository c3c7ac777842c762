"""The search's host sampler, LSTM and surrogate: JAX package against the
port, on the CPU.

* tools: bit-exact on the global numpy RNG (the same confs and the same RNG
  state after), merge/temperature/get_k_best equal, k=0 and an empty store
  give nothing;
* LSTM, the surrogate's prediction over mixed lengths and one 50-epoch fit:
  with the JAX weights carried across, within 1e-5 (absolute, on values of
  order 1), and the Adam state converts both ways;
* the surrogate's initial weights come from its seed, not the global RNG.
"""

import types

import numpy as np
import pytest
import torch

import mfas_tpu.search.tools as jtools
from mfas_tpu.core import Ctx, flatten_tree
from mfas_tpu.core.rnn import LSTM as JLSTM
from mfas_tpu.search.surrogate import SimpleRecurrentSurrogate as JSurrogate
from mfas_tpu.search.surrogate import SurrogateDataloader as JData
import mfas_tpu_torch.search.tools as ttools
from mfas_tpu_torch.core.rnn import LSTM
from mfas_tpu_torch.runtime.checkpoint import state_dict_from_numpy
from mfas_tpu_torch.search.surrogate import SimpleRecurrentSurrogate
from mfas_tpu_torch.search.surrogate import SurrogateDataloader

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: under a parallel test runner every split op
    waits on threads the other workers' processes hold."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _confs(rs, n, L):
    return [np.stack([rs.randint(0, 4, L), rs.randint(0, 4, L),
                      rs.randint(0, 2, L)], 1) for _ in range(n)]


def _both(fn_j, fn_t, seed=3):
    """Run fn_j and fn_t from the same global numpy state; returns both
    results and both RNG states after."""
    np.random.seed(seed)
    a = fn_j()
    sa = np.random.get_state()
    np.random.seed(seed)
    b = fn_t()
    sb = np.random.get_state()
    return a, b, sa, sb


@pytest.mark.parametrize("temperature", [10.0, 1.3, 0.2])
def test_sample_k_configurations_bit_exact(temperature):
    rs = np.random.RandomState(0)
    confs = _confs(rs, 32, 2)
    accs = list(rs.uniform(0.1, 0.9, 32))
    a, b, sa, sb = _both(
        lambda: jtools.sample_k_configurations(confs, accs, 15, temperature),
        lambda: ttools.sample_k_configurations(confs, accs, 15, temperature))
    assert [c.tobytes() for c in a] == [c.tobytes() for c in b]
    assert sa[1].tobytes() == sb[1].tobytes() and sa[2] == sb[2]


def test_merge_temperature_and_k_best():
    rs = np.random.RandomState(1)
    unfold = [[a, b, n] for a in range(4) for b in range(4) for n in range(2)]
    first_j = jtools.merge_unfolded_with_sampled([], unfold, 0)
    first_t = ttools.merge_unfolded_with_sampled([], unfold, 0)
    assert [c.tobytes() for c in first_j] == [c.tobytes() for c in first_t]
    prev = _confs(rs, 3, 2)
    for layer in (1, 2):      # row substitution, then a new row appended
        mj = jtools.merge_unfolded_with_sampled(prev, unfold, layer)
        mt = ttools.merge_unfolded_with_sampled(prev, unfold, layer)
        assert [c.tobytes() for c in mj] == [c.tobytes() for c in mt]
    with pytest.raises(ValueError):
        ttools.merge_unfolded_with_sampled([], unfold, 1)

    args = types.SimpleNamespace(initial_temperature=10.0,
                                 final_temperature=0.2, temperature_decay=4.0)
    for it in range(12):
        assert (jtools.compute_temperature(it, args)
                == ttools.compute_temperature(it, args))

    jd, td = JData(), SurrogateDataloader()
    for k in (0, 3):
        for store in (jd, td):
            assert store.get_k_best(k)[0] == []        # empty store
    confs, accs = _confs(rs, 9, 1) + _confs(rs, 6, 2), rs.uniform(0, 1, 15)
    for c, a in zip(confs, accs):
        jd.add_datum(c, float(a))
        td.add_datum(c, float(a))
    jd.add_datum(confs[0], 2.0)          # a duplicate keeps the max
    td.add_datum(confs[0], 2.0)
    assert td.state() == jd.state()
    assert td.get_k_best(0)[0] == [] and len(td.get_k_best(0)[2]) == 0
    for k in (1, 5, 40):
        kj, kt = jd.get_k_best(k), td.get_k_best(k)
        assert [c.tobytes() for c in kj[0]] == [c.tobytes() for c in kt[0]]
        assert kj[1] == kt[1]
    (cj, aj), (ct, at) = jd.get_data(), td.get_data()
    for gj, gt in zip(cj + aj, ct + at):
        np.testing.assert_array_equal(gj, gt)
    assert SurrogateDataloader.from_state(jd.state()).state() == jd.state()


def test_lstm_matches_jax():
    jl = JLSTM(7, 11)
    tree = jl.init(0)
    tl = LSTM(7, 11, device="cpu", generator=torch.Generator().manual_seed(0))
    assert set(tl.state_dict()) == set(flatten_tree(tree))
    tl.load_state_dict(state_dict_from_numpy(flatten_tree(tree)), strict=True)
    x = np.random.RandomState(0).randn(4, 5, 7).astype(np.float32)
    outs_j, (h_j, c_j) = jl.apply(tree, Ctx(), x)
    with torch.no_grad():
        outs_t, (h_t, c_t) = tl(torch.from_numpy(x))
    for a, b in ((outs_j, outs_t), (h_j, h_t), (c_j, c_t)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=TOL)


def test_lstm_init_from_generator_not_global_rng():
    torch.manual_seed(1)
    a = LSTM(3, 5, device="cpu", generator=torch.Generator().manual_seed(7))
    torch.manual_seed(2)
    b = LSTM(3, 5, device="cpu", generator=torch.Generator().manual_seed(7))
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k])
        assert v.abs().max() <= 1 / np.sqrt(5)


def _surrogates():
    js = JSurrogate(100, 3, 100, seed=0, max_seq_len=4)
    ts = SimpleRecurrentSurrogate(100, 3, 100, device="cpu")
    params = {k: np.asarray(v) for k, v in flatten_tree(js.params).items()}
    # the port's own init: U(-0.1, 0.1) Linear weights, biases 1.8
    sd = ts.net.state_dict()
    assert set(sd) == set(params)
    assert torch.all(sd["hid2val.bias"] == 1.8)
    assert sd["embedding.0.weight"].abs().max() <= 0.1
    ts.load_numpy(ts_tree(js.params))
    return js, ts


def ts_tree(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def test_surrogate_predict_and_fit_match_jax():
    js, ts = _surrogates()
    rs = np.random.RandomState(2)
    confs = _confs(rs, 5, 1) + _confs(rs, 4, 3) + _confs(rs, 3, 2)
    pj = js.eval_models(confs)
    pt = ts.eval_models(confs)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=TOL)
    assert abs(ts.eval_models([confs[6]])[0] - pj[6]) <= TOL

    data = SurrogateDataloader()
    for c in confs:
        data.add_datum(c, float(rs.uniform(0.2, 0.8)))
    dc, da = data.get_data()
    lj = js.fit(dc, da, num_epochs=50, lr=1e-3)
    lt = ts.fit(dc, da, num_epochs=50, lr=1e-3)
    assert abs(lt - lj) <= TOL
    np.testing.assert_allclose(ts.eval_models(confs), js.eval_models(confs),
                               rtol=0, atol=TOL)

    # the Adam state in the JAX layout, and back: a second fit continues
    # from the same moments in both packages
    opt = ts.opt_state_numpy()
    assert int(opt["step"]) == int(np.asarray(js.opt_state["step"])) == 150
    fresh = SimpleRecurrentSurrogate(100, 3, 100, device="cpu")
    fresh.load_numpy(ts_tree(js.params), ts_tree(js.opt_state))
    l2j = js.fit(dc, da, num_epochs=2, lr=1e-3)
    l2t = fresh.fit(dc, da, num_epochs=2, lr=1e-3)
    assert abs(l2t - l2j) <= TOL
    for k, v in flatten_tree(js.params).items():
        np.testing.assert_allclose(fresh.net.state_dict()[k].numpy(),
                                   np.asarray(v), rtol=0, atol=TOL)
