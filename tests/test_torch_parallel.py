"""mfas_tpu_torch/parallel/mesh.py against the JAX package's
mfas_tpu/parallel/mesh.py, on the CPU.

Ranks are gloo processes spawned with torch.multiprocessing and joined
through a file store (tests/torch_ranks.py); the cases of this file run in
one spawn of two ranks. Checked:
  * the partial ``--dist_*`` flags stop with JAX's ValueError, and nothing
    configured is a no-op (tests/test_multihost.py:157-167);
  * ``require_shared_seed`` forces --seed 0 with more than one process;
    ``require_resume_agreement`` raises on the rank that disagrees with
    rank 0, with JAX's message; only rank 0 writes the train state, the
    search state and the jsonl;
  * ``gather_rows`` over a row-split store equals plain indexing, exactly,
    in uint8 and int8 and for a (sample, frame) pick; the byte-SUM
    all-gather is exact in float64, bfloat16 and int64; ``all_reduce_grads``
    sums and leaves grad-None parameters alone;
  * a BatchNorm3d over two ranks' rows, forward and backward, equals JAX's
    BatchNorm on the whole batch in float64 within 1e-12 (outputs, input
    and parameter gradients, running statistics), also under remat, which
    re-issues the collective in the recomputation;
  * the population heads' masked two-pass statistics over a ragged masked
    batch split over two ranks: losses, corrects, gradients and BatchNorm
    statistics equal JAX's whole-batch step in float64 within 1e-12 of each
    tensor's max.
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mfas_tpu.core import Ctx
from mfas_tpu.core import layers as JL
from mfas_tpu.parallel.mesh import initialize_from_args as jinit
from mfas_tpu.search import population as jpop
from mfas_tpu_torch.parallel import mesh as pm
from mfas_tpu_torch.search import population as tpop
from tests.test_torch_search_population import (CONFS, _jax_side,
                                                _step_inputs, jax_x64,
                                                make_spec, small_args)
from tests.torch_ranks import run_ranks


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: under a parallel test runner every split op
    waits on threads the other workers' processes hold."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_partial_dist_flags_rejected():
    args = types.SimpleNamespace(dist_coordinator=None,
                                 dist_num_processes=2, dist_process_id=0)
    with pytest.raises(ValueError, match="dist_coordinator") as mine:
        pm.initialize_from_args(args)
    with pytest.raises(ValueError) as want:
        jinit(args)
    assert str(mine.value) == str(want.value)
    # and stays a clean no-op when nothing is configured
    pm.initialize_from_args(types.SimpleNamespace())
    assert not pm.dist.is_initialized()
    assert pm.data_group_from_args(
        types.SimpleNamespace(use_dataparallel=True)) is None
    assert pm.is_primary_process()


def test_require_shared_seed_without_a_group():
    args = types.SimpleNamespace(seed=None, dist_coordinator=None)
    pm.require_shared_seed(args)
    assert args.seed is None                  # one process: left alone
    args = types.SimpleNamespace(seed=None, dist_coordinator="h:1")
    pm.require_shared_seed(args)
    assert args.seed == 0
    args = types.SimpleNamespace(seed=7, dist_coordinator="h:1")
    pm.require_shared_seed(args)
    assert args.seed == 7


def _bn_inputs():
    rs = np.random.RandomState(3)
    # 6 rows of a (B, C, T, H, W) activation: 3 per rank
    x = rs.randn(6, 4, 2, 3, 3) * 2.0 + 1.5
    return {"x": x, "gy": rs.randn(*x.shape), "w": rs.uniform(0.5, 1.5, 4),
            "b": rs.randn(4) * 0.1}


def _jax_bn(inp):
    """tanh(BatchNorm3d(x)) on the whole batch, its VJP and its running
    statistics, in float64."""
    with jax_x64():
        bn = JL.BatchNorm3d(4)
        tree = {"weight": jnp.asarray(inp["w"]),
                "bias": jnp.asarray(inp["b"]),
                "running_mean": jnp.zeros(4, jnp.float64),
                "running_var": jnp.ones(4, jnp.float64),
                "num_batches_tracked": jnp.asarray(0, jnp.int32)}

        def f(x, w, b):
            return jnp.tanh(bn({**tree, "weight": w, "bias": b},
                               Ctx(train=True), x))

        y, vjp = jax.vjp(f, jnp.asarray(inp["x"]), tree["weight"],
                         tree["bias"])
        dx, dw, db = vjp(jnp.asarray(inp["gy"]))
        ctx = Ctx(train=True)
        bn(tree, ctx, jnp.asarray(inp["x"]))
        upd = ctx.updates
        return {"y": np.asarray(y), "dx": np.asarray(dx),
                "dw": np.asarray(dw), "db": np.asarray(db),
                "mean": np.asarray(upd["running_mean"]),
                "var": np.asarray(upd["running_var"])}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    rs = np.random.RandomState(0)
    args = small_args()
    spec_t = make_spec(tpop, args, batchnorm=True, use_alphas=True,
                       multitask=True, drpt=0.0)
    inputs = {
        "u8": rs.randint(0, 256, (7, 3, 4)).astype(np.uint8),
        "i8": rs.randint(-127, 128, (7, 5)).astype(np.int8),
        "clips": rs.randint(0, 256, (7, 4, 2, 2, 3)).astype(np.uint8),
        "frames": rs.randint(0, 4, (6, 3)),
        "idx": np.array([6, 0, 3, 3, 5, 1]),
        "f64": rs.randn(6, 3),
        "spec": spec_t, "confs": CONFS,
        "batch": _step_inputs(spec_t, np.float64),
        **_bn_inputs(),
    }
    out = run_ranks(2, ["primitives", "roles", "batchnorm",
                        "population_stats"], inputs,
                    tmp_path_factory.mktemp("two_ranks"))
    return inputs, out


def test_gather_rows_and_all_gather_are_exact(two_ranks):
    inp, out = two_ranks
    idx = inp["idx"]
    for r in out:
        got = r["primitives"]
        for name in ("u8", "i8"):
            assert got["gather_" + name].dtype == inp[name].dtype
            np.testing.assert_array_equal(got["gather_" + name],
                                          inp[name][idx])
        np.testing.assert_array_equal(
            got["gather_frames"], inp["clips"][idx[:, None], inp["frames"]])
        np.testing.assert_array_equal(got["allgather_f64"], inp["f64"])
        np.testing.assert_array_equal(
            got["allgather_bf16"],
            pm.torch.from_numpy(inp["f64"]).bfloat16().float().numpy())
        np.testing.assert_array_equal(got["allgather_i64"], inp["idx"])
        a, b, c = got["grads"]
        np.testing.assert_array_equal(a, [3.0, 3.0, 3.0])
        np.testing.assert_array_equal(b, [30.0, 30.0])
        assert c is None


def test_roles_seed_resume_agreement_and_primary_writes(two_ranks):
    _, out = two_ranks
    assert [r["roles"]["primary"] for r in out] == [True, False]
    assert [r["roles"]["seed"] for r in out] == [0, 0]
    # only rank 0's files exist, seen alike from both ranks
    for r in out:
        assert r["roles"]["files"] == ["log.0.jsonl", "search.0.pkl",
                                       "state.0.pt"]
    assert out[0]["roles"]["disagreement"] is None
    msg = out[1]["roles"]["disagreement"]
    assert msg.startswith("resume disagreement: process 1 resolved resume "
                          "point [1, 4] but process 0 resolved [0, 4]")


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_batchnorm_over_two_ranks_is_the_whole_batch_f64(two_ranks, remat):
    inp, out = two_ranks
    want = _jax_bn(inp)
    got = [r["batchnorm"][remat] for r in out]
    for k in ("y", "dx"):
        assert _rel(np.concatenate([g[k] for g in got]), want[k]) <= 1e-12, k
    for g in got:
        for k in ("dw", "db", "mean", "var"):
            assert _rel(g[k], want[k]) <= 1e-12, k
    # both ranks hold the same reduced gradients and statistics
    for k in ("dw", "db", "mean", "var"):
        np.testing.assert_array_equal(got[0][k], got[1][k])
    if remat:   # the recomputation re-issued the collective, same result
        for k, v in out[0]["batchnorm"][False].items():
            np.testing.assert_array_equal(got[0][k], v, err_msg=k)


def test_population_masked_statistics_over_two_ranks_f64(two_ranks):
    inp, out = two_ranks
    args = small_args()
    spec_j = make_spec(jpop, args, batchnorm=True, use_alphas=True,
                       multitask=True, drpt=0.0)
    with jax_x64():
        _, _, _, _, lj, cj, bnj, gj = _jax_side(spec_j, inp["batch"],
                                                jnp.float64)
        lj, cj = np.asarray(lj), np.asarray(cj)
        bnj = {k: np.asarray(v) for k, v in bnj.items()}
        gj = {k: np.asarray(v) for k, v in gj.items()}
    # rank 0 holds three real rows, rank 1 one real and two padded ones
    assert inp["batch"][5].tolist() == [1, 1, 1, 1, 0, 0]
    for r in out:
        got = r["population_stats"]
        assert _rel(got["loss"], lj) <= 1e-12
        np.testing.assert_array_equal(got["corr"], cj)
        for k in gj:
            assert _rel(got["grads"][k], gj[k]) <= 1e-12, k
        for k in bnj:
            assert _rel(got["bn"][k], bnj[k]) <= 1e-12, k
