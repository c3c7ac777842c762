"""2D -> 3D inflation (mfas_tpu_torch/models/inflate.py) and the inflated
ResNet-50 template (models/resnet3d.py::inflated_resnet50) against the JAX
package on the CPU:

* ``inflate_weight`` in both modes equals JAX's bitwise, and both refuse an
  unknown mode;
* ``inflate_resnet_state`` over one fabricated 2D state equals JAX's key for
  key and bit for bit (``fc.*`` dropped, f64 cast to f32, a key the 2D state
  lacks kept from the template) and reports the same keys;
* ``inflated_resnet50``'s state_dict has the keys and shapes of JAX's
  ``flatten_tree(inflated_resnet50().init(0))`` (from ``jax.eval_shape``,
  so no ResNet-50 is computed in JAX);
* a center-inflated net computes every frame of a time-replicated clip as
  it computes the single frame (at layers [1,1,1,1], width 16, 32 px; the
  tolerance of tests/test_ntu_models.py's JAX test).
"""

import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from mfas_tpu.core.module import flatten_tree
from mfas_tpu.models import inflate as jinflate
from mfas_tpu.models.resnet3d import inflated_resnet50 as jax_resnet50
from mfas_tpu_torch.models import inflate as tinflate
from mfas_tpu_torch.models.resnet3d import ResNet3D, inflated_resnet50


def small_template():
    net = ResNet3D((1, 1, 1, 1), base_width=16, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    return net, net.state_dict()


def fabricate_2d(template, seed=0):
    """A torchvision-layout 2D state for ``template``: the 3D convs' time
    axis dropped, conv weights He-scaled by fan-in, BatchNorm near the
    identity, ``fc.*`` added."""
    rs = np.random.RandomState(seed)
    flat = {}
    for k, v in template.items():
        shape = tuple(v.shape)
        if v.dim() >= 4:
            o, i, kh, kw = shape[0], shape[1], shape[-2], shape[-1]
            flat[k] = (rs.randn(o, i, kh, kw) * np.sqrt(2.0 / (i * kh * kw))
                       ).astype(np.float32)
        elif k.endswith("num_batches_tracked"):
            flat[k] = np.asarray(7, np.int64)
        elif k.endswith("running_var"):
            flat[k] = (1 + 0.1 * rs.rand(*shape)).astype(np.float32)
        elif k.endswith("weight"):
            flat[k] = (1 + 0.1 * rs.randn(*shape)).astype(np.float32)
        else:
            flat[k] = (0.1 * rs.randn(*shape)).astype(np.float32)
    flat["fc.weight"] = rs.randn(10, 128).astype(np.float32)
    flat["fc.bias"] = rs.randn(10).astype(np.float32)
    return flat


def _same(port, want):
    """A port tensor and a JAX-side array: the same dtype and bits."""
    got = port.numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["center", "mean"])
@pytest.mark.parametrize("kt", [3, 4])
def test_inflate_weight_matches_jax(mode, kt):
    w2d = np.random.RandomState(kt).randn(6, 5, 3, 3).astype(np.float32)
    got = tinflate.inflate_weight(torch.from_numpy(w2d), kt, mode)
    _same(got, jinflate.inflate_weight(w2d, kt, mode))
    # numpy arrays are accepted too
    _same(tinflate.inflate_weight(w2d, kt, mode),
          jinflate.inflate_weight(w2d, kt, mode))


def test_inflate_weight_refuses_unknown_mode():
    w2d = np.zeros((2, 2, 3, 3), np.float32)
    for fn in (jinflate.inflate_weight, tinflate.inflate_weight):
        with pytest.raises(ValueError, match="unknown inflation mode"):
            fn(w2d, 3, "nearest")


@pytest.mark.parametrize("mode", ["center", "mean"])
def test_inflate_resnet_state_matches_jax(mode):
    _, template = small_template()
    flat2d = fabricate_2d(template)
    flat2d["bn1.weight"] = flat2d["bn1.weight"].astype(np.float64)
    flat2d["extra.weight"] = np.ones(3, np.float32)     # no 3D destination
    del flat2d["layer2.0.bn2.bias"]                     # kept from template
    np_template = {k: v.numpy() for k, v in template.items()}

    out_j, out_t = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out_j):
        want = jinflate.inflate_resnet_state(flat2d, np_template, mode,
                                             verbose=True)
    with contextlib.redirect_stdout(out_t):
        got = tinflate.inflate_resnet_state(flat2d, template, mode,
                                            verbose=True)
    assert out_t.getvalue() == out_j.getvalue() == \
        "extra.weight cannot be init from ImageNet weights\n"
    assert set(got) == set(want) == set(template)
    for k in got:
        _same(got[k], want[k])
    assert got["bn1.weight"].dtype == torch.float32
    assert torch.equal(got["layer2.0.bn2.bias"], template["layer2.0.bn2.bias"])
    w = got["layer1.0.conv2.weight"]
    assert w.shape == (16, 16, 3, 3, 3)
    if mode == "center":
        assert not w[:, :, 0].any() and not w[:, :, 2].any()
        _same(w[:, :, 1], flat2d["layer1.0.conv2.weight"])


def test_inflated_resnet50_layout_matches_jax():
    net = jax_resnet50()
    want = {k: tuple(v.shape)
            for k, v in flatten_tree(jax.eval_shape(lambda: net.init(0))
                                     ).items()}
    got = {k: tuple(v.shape) for k, v in inflated_resnet50(
        device="cpu", generator=torch.Generator().manual_seed(0)
    ).state_dict().items()}
    assert got == want
    assert len(got) == 318
    # torchvision's layout: counters on every BatchNorm, the projection
    # shortcut as downsample.0 (conv) and downsample.1 (BatchNorm)
    assert got["bn1.num_batches_tracked"] == ()
    assert got["layer1.0.downsample.0.weight"] == (256, 64, 1, 1, 1)
    assert got["layer4.0.downsample.1.running_var"] == (2048,)
    assert got["conv1.weight"] == (64, 3, 7, 7)
    assert got["layer3.5.conv2.weight"] == (256, 256, 3, 3, 3)


def test_center_inflated_net_is_framewise():
    net, template = small_template()
    flat2d = fabricate_2d(template)
    inflated = tinflate.inflate_resnet_state(flat2d, template)
    assert "fc.weight" not in inflated
    net.load_state_dict(inflated, strict=True)
    net.eval()
    frame = torch.from_numpy(
        np.random.RandomState(2).randn(1, 3, 1, 32, 32).astype(np.float32))
    clip = frame.repeat(1, 1, 2, 1, 1)
    with torch.no_grad():
        fms_clip, fms_single = net(clip), net(frame)
    for fc, fs in zip(fms_clip, fms_single):
        np.testing.assert_allclose(fc[:, :, 0].numpy(), fs[:, :, 0].numpy(),
                                   rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(fc[:, :, 0].numpy(), fc[:, :, 1].numpy(),
                                   rtol=2e-3, atol=2e-4)
