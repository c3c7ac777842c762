"""Layers and functional ops of the port (mfas_tpu_torch/core) against the
JAX package's, with the same weights (JAX init -> state_dict_from_numpy) and
the same numpy inputs.

Tolerance for f32 outputs: rtol 1e-4 / atol 1e-5, because XLA on the CPU and
oneDNN sum convolutions in different orders.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mfas_tpu.core import Ctx, flatten_tree
from mfas_tpu.core import functional as JF
from mfas_tpu.core import layers as JL
from mfas_tpu_torch.core import functional as TF
from mfas_tpu_torch.core import layers as TL
from mfas_tpu_torch.runtime.checkpoint import state_dict_from_numpy

RTOL, ATOL = 1e-4, 1e-5


def close(jax_out, torch_out, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(torch_out.detach().numpy(),
                               np.asarray(jax_out), rtol=rtol, atol=atol)


def port(jax_layer, torch_layer, seed=0):
    """Init the JAX layer and load its tree into the torch layer."""
    tree = jax_layer.init(seed)
    torch_layer.load_state_dict(state_dict_from_numpy(flatten_tree(tree)),
                                strict=True)
    return tree


def kw(seed=1):
    return dict(device="cpu", generator=torch.Generator().manual_seed(seed))


def randn(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_linear():
    j, t = JL.Linear(12, 7), TL.Linear(12, 7, **kw())
    tree = port(j, t)
    x = randn(4, 12)
    close(j(tree, Ctx(), jnp.asarray(x)), t(torch.from_numpy(x)))


CONV2D = {
    "k3_s2_p1": dict(kernel_size=3, stride=2, padding=1),
    "k3x1_p1x0": dict(kernel_size=(3, 1), padding=(1, 0)),
    "k1_nobias": dict(kernel_size=1, bias=False),
}


@pytest.mark.parametrize("cfg", list(CONV2D), ids=list(CONV2D))
def test_conv2d(cfg):
    j = JL.Conv2d(3, 5, **CONV2D[cfg])
    t = TL.Conv2d(3, 5, **CONV2D[cfg], **kw())
    tree = port(j, t)
    x = randn(2, 3, 9, 11)
    close(j(tree, Ctx(), jnp.asarray(x)), t(torch.from_numpy(x)))


CONV3D = {
    "k3_s122_p1": dict(kernel_size=3, stride=(1, 2, 2), padding=1),
    "k1_s122": dict(kernel_size=1, stride=(1, 2, 2), bias=False),
    "k3_dil": dict(kernel_size=3, padding=1, dilation=(1, 2, 2)),
}


@pytest.mark.parametrize("cfg", list(CONV3D), ids=list(CONV3D))
def test_conv3d(cfg):
    j = JL.Conv3d(4, 6, **CONV3D[cfg])
    t = TL.Conv3d(4, 6, **CONV3D[cfg], **kw())
    tree = port(j, t)
    x = randn(2, 4, 3, 8, 8)
    close(j(tree, Ctx(), jnp.asarray(x)), t(torch.from_numpy(x)))


@pytest.mark.parametrize("k,s,p", [(2, None, 0), (3, 2, 1)],
                         ids=["k2", "k3_s2_p1"])
def test_max_pool2d(k, s, p):
    x = randn(2, 3, 9, 8)
    j = JL.MaxPool2d(k, s, p)
    close(j({}, Ctx(), jnp.asarray(x)),
          TL.MaxPool2d(k, s, p)(torch.from_numpy(x)), rtol=0, atol=0)


def test_interpolate_bilinear_upsampling():
    """hcn_motion's (T-1) -> T resample: jax.image.resize(linear) and torch
    bilinear align_corners=False agree when upsampling."""
    x = randn(2, 6, 31, 25)
    close(JF.interpolate_bilinear(jnp.asarray(x), (32, 25)),
          TF.interpolate_bilinear(torch.from_numpy(x), (32, 25)))


@pytest.mark.parametrize("src,dst", [((32, 32), (28, 28)),
                                     ((16, 16), (14, 14))],
                         ids=["32to28", "16to14"])
def test_interpolate_bilinear_downsampling(src, dst):
    """CentralNet at 224 px aligns the skeleton maps to the video's by
    downsampling: jax.image.resize(linear, antialias=False) and torch
    bilinear agree there too."""
    x = randn(1, 512, *src)
    close(JF.interpolate_bilinear(jnp.asarray(x), dst),
          TF.interpolate_bilinear(torch.from_numpy(x), dst), rtol=0,
          atol=2e-6 * np.abs(x).max())


@pytest.mark.parametrize("shape", [(3, 5, 4, 4), (3, 5, 2, 3, 4), (3, 5)],
                         ids=["4d", "5d", "2d"])
def test_global_avg_pool2d(shape):
    x = randn(*shape)
    close(JF.global_avg_pool2d(jnp.asarray(x)),
          TF.global_avg_pool2d(torch.from_numpy(x)))


def test_cross_entropy_masked():
    logits = randn(5, 7)
    labels = np.array([0, 6, 3, 3, 1], np.int32)
    mask = np.array([1, 1, 1, 0, 0], np.float32)
    for w in (None, mask):
        close(JF.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                               None if w is None else jnp.asarray(w)),
              TF.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels),
                               None if w is None else torch.from_numpy(w)))


BN = {1: (JL.BatchNorm1d, TL.BatchNorm1d, (6, 4)),
      2: (JL.BatchNorm2d, TL.BatchNorm2d, (3, 4, 5, 5)),
      3: (JL.BatchNorm3d, TL.BatchNorm3d, (2, 4, 3, 5, 5))}


def _bn_pair(nd):
    jcls, tcls, shape = BN[nd]
    j, t = jcls(4), tcls(4, device="cpu")
    rs = np.random.RandomState(nd)
    tree = {"weight": jnp.asarray(rs.uniform(0.5, 1.5, 4), jnp.float32),
            "bias": jnp.asarray(rs.randn(4) * 0.1, jnp.float32),
            "running_mean": jnp.asarray(rs.randn(4) * 0.3, jnp.float32),
            "running_var": jnp.asarray(rs.uniform(0.5, 2.0, 4), jnp.float32),
            "num_batches_tracked": jnp.asarray(3, jnp.int32)}
    t.load_state_dict(state_dict_from_numpy(tree), strict=True)
    x = (rs.randn(*shape) * 2.0 + 1.5).astype(np.float32)
    return j, t, tree, x


@pytest.mark.parametrize("nd", [1, 2, 3])
def test_batchnorm_eval_uses_running_stats(nd):
    j, t, tree, x = _bn_pair(nd)
    t.eval()
    close(j(tree, Ctx(train=False), jnp.asarray(x)), t(torch.from_numpy(x)))


@pytest.mark.parametrize("nd", [1, 2, 3])
def test_batchnorm_train_batch_stats_and_running_update(nd):
    j, t, tree, x = _bn_pair(nd)
    ctx = Ctx(train=True)
    want = j(tree, ctx, jnp.asarray(x))
    t.train()
    close(want, t(torch.from_numpy(x)))
    for leaf in ("running_mean", "running_var"):
        close(ctx.updates[leaf], getattr(t, leaf), rtol=1e-5, atol=1e-6)
    assert int(t.num_batches_tracked) == int(ctx.updates["num_batches_tracked"])
    assert t.num_batches_tracked.dtype == torch.int64


def test_alpha_scalar_multiplication():
    j = JL.AlphaScalarMultiplication(3, 4)
    t = TL.AlphaScalarMultiplication(3, 4, **kw())
    tree = {"alpha_x": jnp.asarray([0.37], jnp.float32)}
    t.load_state_dict(state_dict_from_numpy(tree), strict=True)
    a, b = randn(2, 3), randn(2, 4, seed=1)
    ja, jb = j(tree, Ctx(), jnp.asarray(a), jnp.asarray(b))
    ta, tb = t(torch.from_numpy(a), torch.from_numpy(b))
    close(ja, ta)
    close(jb, tb)


@pytest.mark.parametrize("name", ["ReLU", "Sigmoid", "LeakyReLU"])
def test_activations(name):
    x = randn(4, 9)
    close(getattr(JL, name)()({}, Ctx(), jnp.asarray(x)),
          getattr(TL, name)()(torch.from_numpy(x)))


def test_dropout_layers_are_identity_in_eval_and_scale_in_train():
    x = torch.ones(64, 8, 3, 3)
    g = torch.Generator().manual_seed(0)
    for layer in (TL.Dropout(0.5), TL.Dropout2d(0.5)):
        TL.set_dropout_generator(layer, g)
        layer.eval()
        assert torch.equal(layer(x), x)
        layer.train()
        y = layer(x)
        assert set(torch.unique(y).tolist()) <= {0.0, 2.0}
    # Dropout2d zeroes whole channels on rank >= 3
    layer = TL.Dropout2d(0.5).train()
    TL.set_dropout_generator(layer, g)
    y = layer(x)
    per_channel = y.reshape(64, 8, -1)
    assert torch.all(per_channel.amin(-1) == per_channel.amax(-1))
