"""The resident NTU store under a data group of two gloo ranks, replicated
and sharded, against the one-device reads of the port and of the JAX
package, on the CPU (the port of tests/test_resident.py:129).

Every batch of the resident train loader (10 samples, batch 8, AugCrop) is
placed with the rank's rows and read by ``make_resident_prep``: on a
replicated store each rank reads its rows through the K2 wrapper
(``u8_gather_normalize``); on a store split by samples (5 rows per rank)
through ``gather_rows`` and the K1 wrapper (``u8_normalize``), K2 turned
off with a warning. The kernels' plain versions run on the CPU. Both
ranks' rows together equal the one-device port bitwise, and JAX's
single-device read within test_resident.py's rtol/atol 1e-6.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mfas_tpu.data.resident import (ResidentLoader as JLoader,
                                    ResidentNTUStore as JStore,
                                    make_resident_prep as jprep)
from tests.test_resident import VID_LEN, _pack, _tfms
from tests.torch_ranks import resident_batches, run_ranks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = _pack(tmp_path_factory.mktemp("resident"))
    inputs = {"root": root, "vid_len": VID_LEN}
    out = run_ranks(2, ["resident"], inputs,
                    tmp_path_factory.mktemp("resident_ranks"))
    return inputs, [r["resident"] for r in out]


def _jax_batches(root):
    prep = jax.jit(jprep())
    loader = JLoader(JStore(root), 8, transform=_tfms()["train"],
                     shuffle=True, seed=9)
    out = []
    for b in loader:
        got = prep({k: v if isinstance(v, jax.Array) else jnp.asarray(v)
                    for k, v in b.items()})
        out.append((np.asarray(got["rgb"]), np.asarray(got["ske"])))
    return out


@pytest.mark.parametrize("layout", ["replicated", "sharded"])
def test_resident_store_over_two_ranks(runs, layout):
    inp, out = runs
    one = resident_batches(inp, None, False)
    want = _jax_batches(inp["root"])
    assert len(one["batches"]) == len(want) == 2
    got = [r[layout] for r in out]
    for step, (o, w) in enumerate(zip(one["batches"], want)):
        for i, name in enumerate(("rgb", "ske")):
            rows = np.concatenate([g["batches"][step][i] for g in got])
            np.testing.assert_array_equal(rows, o[i], err_msg=name)
            np.testing.assert_allclose(rows, w[i], rtol=1e-6, atol=1e-6,
                                       err_msg=name)
    for g in got:
        if layout == "replicated":
            assert g["store_rows"] == 10
            assert g["calls"] == {"u8_normalize": 0,
                                  "u8_gather_normalize": 2}
        else:
            assert g["store_rows"] == 5
            assert g["calls"] == {"u8_normalize": 2,
                                  "u8_gather_normalize": 0}
    assert any("unsharded store" in w for w in out[0]["warned"])
