"""The convolution and pooling formulation options of the port
(mfas_tpu_torch/core/functional.py: conv_channels_last, conv3d_as_2d,
conv1x1_as_matmul, pool_as_slices, pool_separable) against the JAX
package's same option and against the port's default, on the cases of
tests/test_core_layers.py, in values and in the gradients of sum(out**2)
with respect to the input and the weight (jax.grad and autograd): within
1e-5 of the reference's max. Also the options' bookkeeping: the setters,
``layout_options`` and ``OPTION_CALLS``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfas_tpu.core import functional as JF
from mfas_tpu_torch.core import functional as TF

TOL = 1e-5      # of the reference's max |value|

SETTERS = {
    "conv_channels_last": (JF.set_conv_channels_last,
                           TF.set_conv_channels_last),
    "conv3d_as_2d": (JF.set_conv3d_as_2d, TF.set_conv3d_as_2d),
    "conv1x1_as_matmul": (JF.set_conv1x1_as_matmul,
                          TF.set_conv1x1_as_matmul),
    "pool_as_slices": (JF.set_pool_as_slices, TF.set_pool_as_slices),
    "pool_separable": (JF.set_pool_separable, TF.set_pool_separable),
}


def _rand(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def _conv_cases():
    rs = np.random.RandomState(0)
    cases = {
        # tests/test_core_layers.py::test_conv_channels_last_matches_nchw
        "chlast_conv2d_s2p1": ("conv_channels_last", "conv2d",
                               _rand(rs, 2, 3, 13, 11),
                               _rand(rs, 5, 3, 3, 3), _rand(rs, 5),
                               dict(stride=2, padding=1)),
        "chlast_conv3d_s122p1": ("conv_channels_last", "conv3d",
                                 _rand(rs, 2, 3, 4, 9, 9),
                                 _rand(rs, 5, 3, 3, 3, 3), None,
                                 dict(stride=(1, 2, 2), padding=1)),
    }
    # ::test_conv3d_as_2d_matches_native, the temporal-stride-2 conv last
    # (outside the guard: the native conv)
    rs = np.random.RandomState(0)
    x = _rand(rs, 2, 4, 5, 9, 9)
    ws = [_rand(rs, 6, 4, 3, 3, 3), _rand(rs, 6, 4, 3, 3, 3),
          _rand(rs, 6, 4, 1, 1, 1), _rand(rs, 6, 4, 1, 1, 1)]
    b = _rand(rs, 6)
    for w, name, stride, pad in zip(ws, ("k3_s122", "k3_s1", "k1_s122",
                                         "k1_s1"),
                                    ((1, 2, 2), 1, (1, 2, 2), 1),
                                    (1, 1, 0, 0)):
        cases[f"3das2d_{name}"] = ("conv3d_as_2d", "conv3d", x, w, b,
                                   dict(stride=stride, padding=pad))
    cases["3das2d_stride2_native"] = ("conv3d_as_2d", "conv3d", x,
                                      _rand(rs, 6, 4, 3, 3, 3), None,
                                      dict(stride=(2, 2, 2), padding=1))
    # ::test_conv3d_1x1_matmul_path_matches_native
    rs = np.random.RandomState(1)
    x, w, b = _rand(rs, 2, 8, 4, 6, 6), _rand(rs, 5, 8, 1, 1, 1), _rand(rs, 5)
    for name, stride in (("s1", 1), ("s122", (1, 2, 2)), ("s222", (2, 2, 2))):
        cases[f"matmul_{name}"] = ("conv1x1_as_matmul", "conv3d", x, w, b,
                                   dict(stride=stride))
    return cases


CONV_CASES = _conv_cases()
# ::test_pool_as_slices_matches_reduce_window and
# ::test_max_pool_separable_matches_default_and_torch
POOLS = (("k3_s2_p1", 3, 2, 1), ("k2_s2_p0", 2, 2, 0),
         ("k3x2_s1x2_p1x0", (3, 2), (1, 2), (1, 0)))
POOL_CASES = {
    **{f"{opt}_{name}": (opt, (2, 3, 13, 11), 2, k, s, p)
       for opt in ("pool_as_slices", "pool_separable")
       for name, k, s, p in POOLS},
    "pool_separable_17x19": ("pool_separable", (2, 3, 17, 19), 7, 3, 2, 1),
}


def _jax_with(option, fn):
    """fn() with the JAX package's ``option`` on, put back off after (the
    JAX setters are process globals)."""
    jset = SETTERS[option][0]
    jset(True)
    try:
        return fn()
    finally:
        jset(False)


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= TOL * np.abs(want).max(), (
        f"{what}: max abs err {err}, max |ref| {np.abs(want).max()}")


def _torch_conv(fn, x, w, b, kw, option=None):
    """-> (out, d sum(out^2)/dx, d/dw) of the port's conv, ``option`` on."""
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    bt = None if b is None else torch.from_numpy(b)
    with TF.layout_options(**({option: True} if option else {})):
        out = getattr(TF, fn)(xt, wt, bt, **kw)
    (out ** 2).sum().backward()
    return [t.detach().numpy() for t in (out, xt.grad, wt.grad)]


def _jax_conv(fn, x, w, b, kw, option):
    f = getattr(JF, fn)
    jb = None if b is None else jnp.asarray(b)

    def run():
        out = f(jnp.asarray(x), jnp.asarray(w), jb, **kw)
        gx, gw = jax.grad(lambda xx, ww: jnp.sum(f(xx, ww, jb, **kw) ** 2),
                          argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
        return [np.asarray(a) for a in (out, gx, gw)]

    return _jax_with(option, run)


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv_option_matches_jax_and_default(case):
    option, fn, x, w, b, kw = CONV_CASES[case]
    before = TF.OPTION_CALLS[option]
    got = _torch_conv(fn, x, w, b, kw, option)
    took = TF.OPTION_CALLS[option] - before
    # the stride-2 temporal conv is outside conv3d_as_2d's guard (as in
    # JAX): the native conv runs, and the option's count stays
    assert took == (0 if case == "3das2d_stride2_native" else 1)
    want_jax = _jax_conv(fn, x, w, b, kw, option)
    default = _torch_conv(fn, x, w, b, kw)
    for what, g, j, d in zip(("value", "grad x", "grad w"), got, want_jax,
                             default):
        _close(g, j, f"{case} {what} vs JAX's option")
        _close(g, d, f"{case} {what} vs the port's default")


def test_channels_last_leaves_the_output_channels_last():
    rs = np.random.RandomState(2)
    x = torch.from_numpy(_rand(rs, 2, 4, 3, 6, 6))
    w = torch.from_numpy(_rand(rs, 5, 4, 3, 3, 3))
    with TF.layout_options(conv_channels_last=True):
        out3 = TF.conv3d(x, w, padding=1)
        out2 = TF.conv2d(x[:, :, 0], w[:, :, 0], padding=1)
    assert out3.shape == (2, 5, 3, 6, 6)
    assert out3.is_contiguous(memory_format=torch.channels_last_3d)
    assert out2.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("case", list(POOL_CASES))
def test_pool_option_matches_jax_and_default(case):
    option, shape, seed, k, s, p = POOL_CASES[case]
    x = _rand(np.random.RandomState(seed), *shape)

    def torch_pool(on):
        xt = torch.from_numpy(x).requires_grad_(True)
        with TF.layout_options(**({option: True} if on else {})):
            out = TF.max_pool2d(xt, k, s, p)
        (out ** 2).sum().backward()
        return out.detach().numpy(), xt.grad.numpy()

    def jax_pool():
        out = JF.max_pool2d(jnp.asarray(x), k, s, p)
        g = jax.grad(lambda a: jnp.sum(JF.max_pool2d(a, k, s, p) ** 2))(
            jnp.asarray(x))
        return np.asarray(out), np.asarray(g)

    got, default = torch_pool(True), torch_pool(False)
    want = _jax_with(option, jax_pool)
    # values are exact (a maximum of the same elements); the random inputs
    # have no tied window maxima, so every gradient goes to one element
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0], default[0])
    _close(got[1], want[1], f"{case} grad vs JAX's option")
    _close(got[1], default[1], f"{case} grad vs the port's default")


def test_options_under_the_jax_names_and_environment(monkeypatch):
    """The setters flip the module globals JAX's names have; the
    environment variables are read at import; layout_options restores
    every option, also when its block raises."""
    names = ("CONV_CHANNELS_LAST", "CONV3D_AS_2D", "CONV1X1_AS_MATMUL",
             "POOL_AS_SLICES", "POOL_SEPARABLE")
    assert all(hasattr(JF, n) and hasattr(TF, n) for n in names)
    assert set(TF.option_values()) == set(SETTERS)
    before = TF.option_values()
    with pytest.raises(RuntimeError):
        with TF.layout_options(conv_channels_last=True, pool_separable=True):
            assert TF.CONV_CHANNELS_LAST and TF.POOL_SEPARABLE
            raise RuntimeError("inside")
    assert TF.option_values() == before
    with pytest.raises(ValueError, match="unknown layout options"):
        with TF.layout_options(channels_last=True):
            pass

    import importlib
    for n in names:
        monkeypatch.setenv(f"MFAS_{n}", "1")
    try:
        importlib.reload(TF)
        assert all(TF.option_values().values())
    finally:
        for n in names:
            monkeypatch.delenv(f"MFAS_{n}")
        importlib.reload(TF)
    assert TF.option_values() == before


def test_default_visual_path_is_already_ndhwc():
    """Without the option the video backbone already runs channels-last:
    Visual permutes its (B,T,H,W,C) clip to an NDHWC-strided (B,C,T,H,W)
    view, the frame-wise stem reads it as NHWC, and the convolutions keep
    their input's memory format, so every stage map is NDHWC (what
    --conv_channels_last adds is the weights' layout)."""
    import types

    from mfas_tpu_torch.models.ntu import Visual

    args = types.SimpleNamespace(num_outputs=5, vid_len=(4, 32),
                                 resnet3d_layers=(1, 1, 1, 1),
                                 resnet3d_base_width=8)
    net = Visual(args, device="cpu",
                 generator=torch.Generator().manual_seed(0)).eval()
    clip = torch.from_numpy(_rand(np.random.RandomState(3), 2, 4, 32, 32, 3))
    with torch.no_grad():
        maps = net(clip)[:4]
    assert TF.option_values()["conv_channels_last"] is False
    for fm in maps:
        assert fm.is_contiguous(memory_format=torch.channels_last_3d)
        assert not fm.is_contiguous()

