"""The rest of the JAX package's core library in the port, each against its
JAX twin on the same numpy inputs: core/layers.py (Tanh, ELU, AvgPool3d,
AdaptiveAvgPool2d, GlobalPooling1D, Flatten, AlphaVectorMultiplication,
ParamList, Activ with its learned-beta Swish), core/functional.py
(avg_pool3d, global_avg_pool1d, mse), core/init.py (ones,
torch_default_weight, hcn_conv_weight, orthogonal: the same distribution,
since the packages draw from different generators). Values and input
gradients within 1e-5 of the reference's max.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfas_tpu.core import Ctx, flatten_tree
from mfas_tpu.core import functional as JF
from mfas_tpu.core import init as JI
from mfas_tpu.core import layers as JL
from mfas_tpu_torch.core import functional as TF
from mfas_tpu_torch.core import init as TI
from mfas_tpu_torch.core import layers as TL
from mfas_tpu_torch.runtime.checkpoint import state_dict_from_numpy

TOL = 1e-5


def randn(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= TOL * scale, what


def _pair(jfn, tfn, x):
    """Values and d sum(out^2)/dx of a JAX and a torch function of x."""
    jx = jnp.asarray(x)
    jout = jfn(jx)
    jg = jax.grad(lambda a: jnp.sum(jfn(a) ** 2))(jx)
    tx = torch.from_numpy(x).requires_grad_(True)
    tout = tfn(tx)
    (tout ** 2).sum().backward()
    return (np.asarray(jout), np.asarray(jg),
            tout.detach().numpy(), tx.grad.numpy())


def _check_pair(jfn, tfn, x, what):
    jout, jg, tout, tg = _pair(jfn, tfn, x)
    close(tout, jout, f"{what} value")
    close(tg, jg, f"{what} grad")


STATELESS = {
    "Tanh": (JL.Tanh(), TL.Tanh(), (3, 7)),
    "ELU": (JL.ELU(), TL.ELU(), (3, 7)),
    "AvgPool3d": (JL.AvgPool3d((4, 7, 7)), TL.AvgPool3d((4, 7, 7)),
                  (2, 3, 4, 7, 7)),
    "AvgPool3d_s": (JL.AvgPool3d(2, 1, 1), TL.AvgPool3d(2, 1, 1),
                    (2, 3, 4, 5, 5)),
    "AdaptiveAvgPool2d": (JL.AdaptiveAvgPool2d(), TL.AdaptiveAvgPool2d(),
                          (2, 3, 5, 6)),
    "GlobalPooling1D": (JL.GlobalPooling1D(), TL.GlobalPooling1D(),
                        (2, 3, 9)),
    "Flatten": (JL.Flatten(), TL.Flatten(), (2, 3, 4, 5)),
}


@pytest.mark.parametrize("name", list(STATELESS))
def test_stateless_layer_matches_jax(name):
    j, t, shape = STATELESS[name]
    _check_pair(lambda a: j({}, Ctx(), a), t, randn(*shape), name)


def test_adaptive_avg_pool_refuses_other_sizes():
    with pytest.raises(ValueError, match="only"):
        TL.AdaptiveAvgPool2d((2, 2))


FUNCTIONAL = {
    "avg_pool3d": (lambda a: JF.avg_pool3d(a, (2, 3, 3), (1, 2, 2), 1),
                   lambda a: TF.avg_pool3d(a, (2, 3, 3), (1, 2, 2), 1),
                   (2, 3, 4, 7, 7)),
    "global_avg_pool1d": (JF.global_avg_pool1d, TF.global_avg_pool1d,
                          (3, 4, 10)),
    "mse": (lambda a: JF.mse(a, jnp.asarray(randn(3, 5, seed=1))),
            lambda a: TF.mse(a, torch.from_numpy(randn(3, 5, seed=1))),
            (3, 5)),
}


@pytest.mark.parametrize("name", list(FUNCTIONAL))
def test_functional_matches_jax(name):
    jfn, tfn, shape = FUNCTIONAL[name]
    _check_pair(jfn, tfn, randn(*shape), name)


def test_alpha_vector_multiplication_matches_jax():
    j = JL.AlphaVectorMultiplication(7)
    t = TL.AlphaVectorMultiplication(7, device="cpu")
    tree = j.init(0)
    assert set(t.state_dict()) == set(flatten_tree(tree)) == {"alpha"}
    tree["alpha"] = jnp.asarray(randn(1, 7, seed=2))
    t.load_state_dict(state_dict_from_numpy(flatten_tree(tree)))
    x = randn(3, 7)
    _check_pair(lambda a: j(tree, Ctx(), a), t, x, "AlphaVector")
    # and the gradient of the gate itself
    ga = jax.grad(lambda al: jnp.sum(j({"alpha": al}, Ctx(),
                                       jnp.asarray(x)) ** 2))(tree["alpha"])
    t.zero_grad()
    (t(torch.from_numpy(x)) ** 2).sum().backward()
    close(t.alpha.grad.numpy(), ga, "alpha grad")


def test_param_list_keys_and_values():
    shapes = [(1,), (2, 3), (4,)]
    j = JL.ParamList(shapes)
    t = TL.ParamList(shapes, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    tree = j.init(0)
    assert list(t.state_dict()) == list(flatten_tree(tree)) == ["0", "1",
                                                                "2"]
    for p, s in zip(t, shapes):
        assert tuple(p.shape) == s
        assert 0.0 <= float(p.detach().min()) <= float(p.detach().max()) < 1
    t.load_state_dict(state_dict_from_numpy(flatten_tree(tree)))
    for i in range(3):
        np.testing.assert_array_equal(t[i].detach().numpy(),
                                      np.asarray(j(tree, Ctx(), i)))


@pytest.mark.parametrize("name", ["LeakyReLU", "ELU", "ReLU", "Tanh",
                                  "Sigmoid", "Swish"])
def test_activ_matches_jax(name):
    j, t = JL.Activ(name), TL.Activ(name, device="cpu")
    tree = j.init(0)
    assert set(t.state_dict()) == set(flatten_tree(tree))
    t.load_state_dict(state_dict_from_numpy(flatten_tree(tree)))
    x = randn(3, 7, seed=1)
    _check_pair(lambda a: j(tree, Ctx(), a), t, x, name)
    if name == "Swish":
        assert float(t.beta) == float(tree["beta"][0]) == 0.5
        gb = jax.grad(lambda b: jnp.sum(j({"beta": b}, Ctx(),
                                          jnp.asarray(x)) ** 2))(tree["beta"])
        t.zero_grad()
        (t(torch.from_numpy(x)) ** 2).sum().backward()
        close(t.beta.grad.numpy(), gb, "Swish beta grad")


def test_activ_unknown_name_warns_and_passes_through(capsys):
    t = TL.Activ("Mish", device="cpu")
    assert "NOT DEFINED" in capsys.readouterr().out
    x = torch.from_numpy(randn(2, 3))
    assert torch.equal(t(x), x)


def _draw(which, shape):
    """(JAX sample, port sample) of initializer ``which``."""
    j = getattr(JI, which)(jax.random.PRNGKey(0), shape)
    t = getattr(TI, which)(torch.Generator().manual_seed(0), shape, "cpu")
    return np.asarray(j, np.float64), t.double().numpy()


@pytest.mark.parametrize("shape", [(64, 25, 3, 3), (512, 1024)],
                         ids=["conv", "linear"])
@pytest.mark.parametrize("which", ["torch_default_weight",
                                   "hcn_conv_weight"])
def test_uniform_initializers_share_the_bound(which, shape):
    """U(-b, b) in both, with the same b (torch's fan convention; the HCN
    conv's quirky fans): both samples reach within 1 % of b, never past
    it, and their variances are b^2/3 within 5 %."""
    j, t = _draw(which, shape)
    assert t.shape == j.shape == shape and t.dtype == j.dtype
    if which == "torch_default_weight":
        fan_in = math.prod(shape[1:])
        bound = math.sqrt(6.0 / ((1 + 5.0) * fan_in))
    else:
        fan_in = math.prod(shape[1:4])
        fan_out = shape[0] * math.prod(shape[2:4])
        bound = math.sqrt(6.0 / (fan_in + fan_out))
    for a in (j, t):
        assert np.abs(a).max() <= bound * (1 + 1e-6)
        assert np.abs(a).max() >= bound * 0.99
        assert abs(a.var() / (bound ** 2 / 3) - 1) < 0.05


def test_ones():
    j, t = _draw("ones", (3, 4))
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("shape", [(6, 4), (4, 6), (2, 3, 5), (3, 3)])
def test_orthogonal_matches_jax_structure(shape):
    """Rows or columns, whichever are fewer, orthonormal, over the matrix of
    prod(shape[:-1]) rows and shape[-1] columns (JAX's column axis -1)."""
    j, t = _draw("orthogonal", shape)
    assert t.shape == j.shape == shape
    for a in (j, t):
        m = a.reshape(-1, shape[-1])
        gram = m.T @ m if m.shape[0] >= m.shape[1] else m @ m.T
        np.testing.assert_allclose(gram, np.eye(gram.shape[0]), atol=1e-5)
    with pytest.raises(ValueError, match="2D"):
        TI.orthogonal(torch.Generator(), (5,), "cpu")
