"""The port's population trainer on a (pop=2, data=2) layout of four gloo
ranks against the JAX trainer on ``Mesh((2, 4), ("pop", "data"))`` and
against the port on one rank, on the CPU (the port of
tests/test_population_mesh.py:20-134).

One spawn of four ranks (tests/torch_ranks.py) runs every variant on the
AV-MNIST extractor (the JAX init weights) with four confs, 2 epochs at
batch 8:
  * the per-batch path: train-mode features of each rank's rows;
  * the fused feature bank (float32);
  * the bank split by rows over the data group (``shard_feature_bank``),
    in bfloat16 and int8, on 21 samples (11 bank rows per rank).
Every rank returns the same accuracies and parameters, which equal the
one-rank port's and JAX's on its mesh (accuracies within 1e-6, parameters
within tests/test_population_mesh.py's rtol 1e-4, atol 1e-5).
"""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from mfas_tpu.core import flatten_tree
from mfas_tpu.core.sched import FixedScheduler
from mfas_tpu.data.loader import ArrayLoader
from mfas_tpu.search.population import PopulationSpec as JSpec
from mfas_tpu.search.population import PopulationTrainer as JTrainer
from mfas_tpu_torch.search.population import PopulationSpec as TSpec
from tests.test_avmnist_vertical import make_args, synthetic_avmnist
from tests.test_population_trainer import build
from tests.torch_ranks import population_run, run_ranks

CONFS = [np.array([[4, 2, 0]]), np.array([[0, 0, 1]]),
         np.array([[2, 1, 0], [4, 2, 0]]), np.array([[1, 1, 1]])]

VARIANTS = {
    "per_batch": dict(data="n32", feature_dtype=None,
                      cache_train_features=False),
    "fused_bank": dict(data="n32", feature_dtype=None,
                       cache_train_features=True, fused_epochs=True),
    "sharded_bank_bf16": dict(data="n21", feature_dtype="bfloat16",
                              cache_train_features=True, fused_epochs=True,
                              shard_feature_bank=True),
    "sharded_bank_int8": dict(data="n21", feature_dtype=None,
                              cache_train_features=True, fused_epochs=True,
                              shard_feature_bank=True, int8_bank=True),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: under a parallel test runner every split op
    waits on threads the other workers' processes hold."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(n):
    # float32, as JAX places synthetic_avmnist's float64 images
    return {k: v.astype(np.float32) if v.dtype == np.float64 else v
            for k, v in synthetic_avmnist(n).items()}


def _spec(cls, args, feature_dtype):
    spec, _, _ = build(args)
    return cls(sizes_a=spec.sizes_a, sizes_b=spec.sizes_b,
               hidden=spec.hidden, num_outputs=spec.num_outputs,
               max_rows=spec.max_rows, feature_dtype=feature_dtype)


def _jax_run(inp, variant):
    kw = dict(VARIANTS[variant])
    data = inp["data"][kw.pop("data")]
    spec = _spec(JSpec, inp["args"], kw.pop("feature_dtype"))
    _, extractor, btree = build(inp["args"])
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("pop", "data"))
    loaders = {"train": ArrayLoader(data, 8, shuffle=True, seed=1),
               "dev": ArrayLoader(data, 8)}
    sizes = {k: v.dataset_size for k, v in loaders.items()}
    trainer = JTrainer(spec, extractor.apply, btree, mesh=mesh, **kw)
    accs, params, _ = trainer.train_population(
        CONFS, loaders, sizes, FixedScheduler(1e-3), num_epochs=2,
        input_keys=("image", "audio"), seed=0)
    return accs, {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    args = make_args(drpt=0.0)
    _, _, btree = build(args)
    variants = {}
    for name, kw in VARIANTS.items():
        kw = dict(kw)
        kw["spec"] = _spec(TSpec, args, kw.pop("feature_dtype"))
        variants[name] = kw
    inputs = {"args": args, "confs": CONFS, "variants": variants,
              "data": {"n32": _data(32), "n21": _data(21)},
              "btree": {k: np.asarray(v)
                        for k, v in flatten_tree(btree).items()}}
    out = run_ranks(4, ["population"], inputs,
                    tmp_path_factory.mktemp("population"))
    return inputs, [r["population"] for r in out]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_population_on_pop_data_layout_matches(runs, variant):
    inp, out = runs
    got = [r[variant] for r in out]
    for r in got[1:]:           # every rank ends with the whole population
        assert r["accs"] == got[0]["accs"]
        for k, v in got[0]["params"].items():
            np.testing.assert_array_equal(r["params"][k], v, err_msg=k)
    assert got[0]["params"]["W"].shape[0] == len(CONFS)
    one = population_run(inp, variant)
    accs_j, params_j = _jax_run(inp, variant)
    np.testing.assert_allclose(got[0]["accs"], one["accs"], atol=1e-6)
    np.testing.assert_allclose(got[0]["accs"], accs_j, atol=1e-6)
    for k, v in params_j.items():
        np.testing.assert_allclose(got[0]["params"][k], one["params"][k],
                                   rtol=1e-4, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(got[0]["params"][k], v, rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    if VARIANTS[variant].get("shard_feature_bank"):
        rows = got[0]["bank_rows"]
        # 21 samples over data=2: 11 feature rows per rank, every label
        assert rows["label"] == 21
        assert {v for k, v in rows.items() if k != "label"} == {11}
        if VARIANTS[variant].get("int8_bank"):
            assert rows["fa_scale"] == 11
