"""The port's last public leftovers against their JAX counterparts, on the
CPU (``SimpleRecurrentSurrogate.eval_model`` is held in
test_torch_search_graphs.py):

* ``models/enas_cell.py::SeparableConv``: the JAX tree loads with strict
  keys; eval- and train-mode outputs and the BatchNorm statistics within
  1e-5 of their max (convolution summation order);
* ``Tensor1DLateralPadding`` and ``ChannelPadding``: bitwise;
* ``core/init.py::torch_default_weight``: the two packages draw from
  different generators, so the draws are held to the same law:
  U(-1/sqrt(fan_in), 1/sqrt(fan_in)), mean and variance within four
  standard errors; the port's comes from its generator alone.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfas_tpu.core import Ctx
from mfas_tpu.core import init as JI
from mfas_tpu.models import enas_cell as JE
from mfas_tpu_torch.core import init as TI
from mfas_tpu_torch.models import enas_cell as TE
from tests.test_torch_cifar import KW, _compare, _flat, _port, _x
from tests.test_torch_search_cli import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("train", [False, True])
def test_separable_conv_matches_jax(train):
    jnet = JE.SeparableConv(4, 6, 3)
    flat = _flat(jnet)
    tnet = _port(TE.SeparableConv(4, 6, 3, **KW), flat)
    assert {"op.0.weight", "op.2.running_var", "op.6.weight"} <= set(flat)
    assert tnet.op[2].eps == tnet.op[6].eps == 1e-3
    _compare(jnet, tnet, flat, [_x(c=4, hw=7)], train)


def test_paddings_match_jax():
    x2 = np.random.RandomState(1).randn(2, 5).astype(np.float32)
    x4 = np.random.RandomState(2).randn(2, 3, 4, 4).astype(np.float32)
    for jmod, tmod, x in ((JE.Tensor1DLateralPadding(3),
                           TE.Tensor1DLateralPadding(3), x2),
                          (JE.ChannelPadding(2), TE.ChannelPadding(2), x4)):
        want = np.asarray(jmod({}, Ctx(), jnp.asarray(x)))
        got = tmod(torch.from_numpy(x)).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_torch_default_weight_matches_jax_law():
    shape = (96, 32, 3, 3)
    bound = 1.0 / math.sqrt(32 * 9)     # kaiming_uniform(a=sqrt(5))
    want = np.asarray(JI.torch_default_weight(jax.random.PRNGKey(0), shape))
    got = TI.torch_default_weight(torch.Generator().manual_seed(0), shape,
                                  "cpu")
    again = TI.torch_default_weight(torch.Generator().manual_seed(0), shape,
                                    "cpu")
    assert torch.equal(got, again) and got.dtype == torch.float32
    n = got.numel()
    for x in (got.numpy(), want):
        assert x.shape == shape
        assert np.abs(x).max() <= bound and np.abs(x).max() > 0.99 * bound
        assert abs(x.mean()) <= 4 * bound / math.sqrt(3 * n)
        # Var(U^2) = bound^4 (1/5 - 1/9): the variance's standard error
        assert abs(x.var() - bound ** 2 / 3) <= 4 * bound ** 2 * math.sqrt(
            (1 / 5 - 1 / 9) / n)
