"""The search's CUDA graphs on the card, held against the eager calls of the
same step functions (mfas_tpu_torch/search/{surrogate,population}.py).
Every test here needs a CUDA device and skips without one. This file
imports neither JAX nor the JAX package, so it also runs where they are not
installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_graphs.py
"""

import numpy as np
import pytest
import torch

from mfas_tpu_torch.runtime import graphs
from mfas_tpu_torch.search import population as tpop
from mfas_tpu_torch.search import surrogate as tsur

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    graphs.reset_graph_counts()
    return torch.device("cuda")


def _groups(rs, sizes):
    confs = [np.stack([rs.randint(0, 4, (L, n)), rs.randint(0, 4, (L, n)),
                       rs.randint(0, 2, (L, n))], -1).astype(np.float32)
             for L, n in sizes]
    accs = [rs.uniform(0.1, 0.9, (n, 1)).astype(np.float32)
            for _, n in sizes]
    return confs, accs


def _twin(surrogate):
    twin = tsur.SimpleRecurrentSurrogate(*surrogate.shape,
                                         max_seq_len=surrogate.max_seq_len,
                                         device=surrogate.device)
    twin.load_numpy(surrogate.params_numpy(), surrogate.opt_state_numpy())
    return twin


def test_graphed_surrogate_fit_and_predict_equal_eager(cuda):
    dc, da = _groups(np.random.RandomState(0),
                     [(1, 32), (2, 15), (3, 15), (4, 40)])
    graphed = tsur.SimpleRecurrentSurrogate(100, 3, 100, device=cuda)
    graphed.fit(dc, da, num_epochs=1, lr=1e-3)     # an Adam state to carry
    eager = _twin(graphed)
    loss = graphed.fit(dc, da, num_epochs=50, lr=1e-3)
    data = [torch.as_tensor(a, device=cuda)
            for a in tsur.pad_groups(dc, da, 4)]
    lr = torch.tensor(1e-3, device=cuda)
    for _ in range(50):
        want = tsur.fit_epoch(eager.net, eager.adam, data, lr)
    assert loss == float(want)
    for (k, v), w in zip(graphed.net.state_dict().items(),
                         eager.net.state_dict().values()):
        assert torch.equal(v, w), k
    for k in ("m", "v"):
        for a, b in zip(graphed.adam[k], eager.adam[k]):
            assert torch.equal(a, b), k
    assert int(graphed.adam["step"]) == int(eager.adam["step"]) == 204

    confs = [c[:, i] for c in dc for i in range(c.shape[1])]
    got = graphed.eval_models(confs)
    seq, lengths = tsur.pad_confs(confs, 4)
    with torch.no_grad():
        out = eager.net(torch.as_tensor(seq, device=cuda),
                        torch.as_tensor(lengths, device=cuda))
    assert got == out[:len(confs), 0].tolist()
    counts = graphs.GRAPH_COUNTS
    assert counts["surrogate_fit"]["replays"] == 51
    assert counts["surrogate_predict"] == {"captures": 1, "replays": 1}


def test_fresh_surrogate_recaptures_nothing(cuda):
    dc, da = _groups(np.random.RandomState(1), [(1, 5), (2, 3)])
    for _ in range(2):
        s = tsur.SimpleRecurrentSurrogate(100, 3, 100, device=cuda)
        s.fit(dc, da, num_epochs=3, lr=1e-3)
        s.eval_models([c[:, 0] for c in dc])
    counts = graphs.GRAPH_COUNTS
    assert counts["surrogate_fit"]["replays"] == 6
    assert counts["surrogate_fit"]["captures"] <= 1
    assert counts["surrogate_predict"]["captures"] <= 1


SIZES = dict(sizes_a=(3, 5), sizes_b=(4, 6), hidden=8, num_outputs=3,
             max_rows=3)
CONFS = [np.array([[1, 0, 0]]), np.array([[0, 1, 1], [1, 1, 0]]),
         np.array([[1, 1, 2], [0, 0, 1], [1, 0, 0]])]


def _bank(rs, n, device):
    def taps(sizes):
        t = np.zeros((n, len(sizes), max(sizes)), np.float32)
        for i, c in enumerate(sizes):
            t[:, i, :c] = rs.randn(n, c)
        return torch.as_tensor(t, device=device)
    return {"fa": taps(SIZES["sizes_a"]), "fb": taps(SIZES["sizes_b"]),
            "lb": torch.as_tensor(rs.randn(n, 3), dtype=torch.float32,
                                  device=device),
            "la": torch.as_tensor(rs.randn(n, 3), dtype=torch.float32,
                                  device=device),
            "label": torch.as_tensor(rs.randint(0, 3, n), device=device)}


def test_graphed_fused_epoch_equals_eager(cuda):
    spec = tpop.PopulationSpec(**SIZES, batchnorm=True, use_alphas=True,
                               multitask=True, drpt=0.5)
    rs = np.random.RandomState(2)
    bank, dev_bank = _bank(rs, 10, cuda), _bank(rs, 7, cuda)
    params, bn = tpop.init_population(CONFS, spec, seed=3, device=cuda)
    conf = tpop.conf_tensors(CONFS, spec, cuda)
    runs = []
    for graphed in (True, False):
        prog = tpop._FusedEpochs(spec, params, bn, conf, bank, dev_bank, 4,
                                 3, device=cuda, graphed=graphed)
        prog.load(params, bn, conf, bank, dev_bank)
        gen = torch.Generator(device=cuda).manual_seed(4)
        plan_rs = np.random.RandomState(5)
        corrs = []
        for epoch in range(2):
            take, wm = tpop.PopulationTrainer._epoch_index_plan(10, 4,
                                                                plan_rs)
            etas = np.full(take.shape[0], 1e-2 / (epoch + 1), np.float32)
            corrs.append(prog.train_epoch(take, wm, etas, gen).clone())
            corrs.append(prog.eval_epoch().clone())
        runs.append((prog.state(), corrs, gen.get_state()))
    (pg, bg), cg, sg = runs[0]
    (pe, be), ce, se = runs[1]
    for k in pg:
        assert torch.equal(pg[k], pe[k]), k
    for k in bg:
        assert torch.equal(bg[k], be[k]), k
    for a, b in zip(cg, ce):
        assert torch.equal(a, b)
    assert torch.equal(sg, se)
    assert graphs.GRAPH_COUNTS["population_train_epoch"] == {
        "captures": 1, "replays": 2}
    assert graphs.GRAPH_COUNTS["population_eval_epoch"] == {
        "captures": 1, "replays": 2}
