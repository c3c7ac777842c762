"""NTU models of the port (mfas_tpu_torch/models, mfas_tpu_torch/fusion)
against the JAX package's, with the same weights (JAX init, BatchNorm
statistics perturbed, -> state_dict_from_numpy) and the same numpy inputs.

Small sizes: ResNet3D (1,1,1,1) at base width 8, 32x32 frames, skeleton
windows 8 and 32, batch 2-3, eval mode. Tolerance for f32 outputs: rtol 1e-4
/ atol 1e-5 (XLA on the CPU and oneDNN sum convolutions in different
orders).
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import main_found_ntu as jmain
from mfas_tpu.core import Ctx, flatten_tree, unflatten_tree
from mfas_tpu.core.module import Rng
from mfas_tpu.fusion import ntu as jfusion
from mfas_tpu.models import ntu as jntu
from mfas_tpu_torch.fusion import ntu as tfusion
from mfas_tpu_torch.models import ntu as tntu
from mfas_tpu_torch.runtime.checkpoint import state_dict_from_numpy

RTOL, ATOL = 1e-4, 1e-5


def ntu_args(**kw):
    d = dict(num_outputs=60, vid_len=(2, 32), drpt=0.0,
             resnet3d_layers=(1, 1, 1, 1), resnet3d_base_width=8,
             inner_representation_size=16, batchnorm=True, alphas=True,
             multitask=True)
    d.update(kw)
    return types.SimpleNamespace(**d)


def perturbed(tree, seed=0):
    """BatchNorm statistics and affine away from their 1/0 init, so eval
    mode exercises them."""
    rs = np.random.RandomState(seed)
    flat = {}
    for k, v in flatten_tree(tree).items():
        v = np.asarray(v)
        if k.endswith("running_mean"):
            v = (rs.randn(*v.shape) * 0.1).astype(np.float32)
        elif k.endswith("running_var"):
            v = rs.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith("num_batches_tracked"):
            v = np.asarray(7, v.dtype)
        elif ("bn" in k or k.startswith("fusion_layers")) and v.ndim == 1 \
                and k.endswith("weight"):
            v = rs.uniform(0.5, 1.5, v.shape).astype(np.float32)
        flat[k] = v
    return flat


def carry(jax_model, torch_model, seed=0):
    """Init the JAX model, perturb it, load it into the torch model."""
    flat = perturbed(jax_model.init(seed), seed)
    torch_model.load_state_dict(state_dict_from_numpy(flat), strict=True)
    torch_model.eval()
    return unflatten_tree({k: jnp.asarray(v) for k, v in flat.items()})


def gen():
    return dict(device="cpu", generator=torch.Generator().manual_seed(0))


def close(jax_out, torch_out):
    np.testing.assert_allclose(torch_out.detach().numpy(), np.asarray(jax_out),
                               rtol=RTOL, atol=ATOL)


def skeleton_input(n, window, seed=0):
    """(N, 3, T, 25, M=2) with the two persons different, so a wrong person
    fold shows."""
    return np.random.RandomState(seed).randn(n, 3, window, 25, 2).astype(
        np.float32)


def test_visual_all_six_outputs():
    args = ntu_args()
    j, t = jntu.Visual(args), tntu.Visual(args, **gen())
    tree = carry(j, t)
    x = np.random.RandomState(1).randn(2, 2, 32, 32, 3).astype(np.float32)
    want = jax.jit(lambda tr, v: j(tr, Ctx(train=False), v))(
        tree, jnp.asarray(x))
    with torch.no_grad():
        got = t(torch.from_numpy(x))
    assert len(got) == len(want) == 6
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape
        close(w, g)


def test_hcn_motion():
    x = skeleton_input(2, 32)
    close(jntu.hcn_motion(jnp.asarray(x)), tntu.hcn_motion(torch.from_numpy(x)))


@pytest.mark.parametrize("window", [8, 32])
def test_skeleton_taps_and_logits(window):
    args = ntu_args(vid_len=(2, window))
    j, t = jntu.Skeleton(args), tntu.Skeleton(args, **gen())
    tree = carry(j, t)
    x = skeleton_input(3, window, seed=window)
    hidden, logits = jax.jit(lambda tr, v: j(tr, Ctx(train=False), v))(
        tree, jnp.asarray(x))
    with torch.no_grad():
        t_hidden, t_logits = t(torch.from_numpy(x))
    assert len(t_hidden) == len(hidden) == 8
    for w, g in zip(hidden, t_hidden):
        assert tuple(g.shape) == w.shape
        close(w, g)
    close(logits, t_logits)


@pytest.mark.parametrize("conf", sorted(jmain.FOUND_CONFS))
def test_searchable_net_found_confs(conf):
    args = ntu_args()
    configuration = jmain.FOUND_CONFS[conf]
    j = jfusion.Searchable_Skeleton_Image_Net(args, configuration)
    t = tfusion.Searchable_Skeleton_Image_Net(args, configuration, **gen())
    tree = carry(j, t, seed=conf)
    rs = np.random.RandomState(conf)
    rgb = rs.randn(2, 2, 32, 32, 3).astype(np.float32)
    ske = skeleton_input(2, 32, seed=conf + 10)
    want = jax.jit(lambda tr, a, b: j(tr, Ctx(train=False), (a, b)))(
        tree, jnp.asarray(rgb), jnp.asarray(ske))
    with torch.no_grad():
        got = t((torch.from_numpy(rgb), torch.from_numpy(ske)))
    assert len(got) == len(want) == 3     # (fused, visual, skeleton) logits
    for w, g in zip(want, got):
        close(w, g)
    assert t.central_params() == j.central_params()


@pytest.mark.parametrize("batchnorm,drpt", [(True, 0.4), (False, 0.0)])
def test_full_width_state_dict_keys_and_shapes(batchnorm, drpt):
    """The reference ResNet-50 (3,4,6,3) at base width 64: the port's
    state_dict keys are flatten_tree of the JAX tree letter for letter, with
    the same shapes (JAX side traced with eval_shape, no weights drawn)."""
    args = ntu_args(resnet3d_layers=(3, 4, 6, 3), resnet3d_base_width=64,
                    vid_len=(8, 32), inner_representation_size=128,
                    batchnorm=batchnorm, drpt=drpt)
    conf = jmain.FOUND_CONFS[4]
    j = jfusion.Searchable_Skeleton_Image_Net(args, conf)
    j.finalize()
    shapes = flatten_tree(jax.eval_shape(lambda k: j._init(Rng(k)),
                                         jax.random.PRNGKey(0)))
    t = tfusion.Searchable_Skeleton_Image_Net(args, conf, **gen())
    sd = t.state_dict()
    assert set(sd) == set(shapes)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(shapes[k].shape), k
    for k in ("rgbnet.cnn.layer1.0.conv1.weight", "skenet.conv1.0.weight",
              "rgbnet.cnn.layer4.2.bn3.running_var", "alphas.3.alpha_x"):
        assert k in sd
    assert ("fusion_layers.0.2.running_mean" in sd) == batchnorm
    assert sum(v.numel() for v in sd.values()) == sum(
        int(np.prod(s.shape)) for s in shapes.values())


def test_layer_confs_and_tap_sizes():
    from mfas_tpu.fusion import layers as jlayers
    from mfas_tpu_torch.fusion import layers as tlayers
    assert (tfusion.get_possible_layer_configurations()
            == jfusion.get_possible_layer_configurations())
    for w in (8, 32):
        args = ntu_args(vid_len=(8, w))
        assert tfusion.tap_sizes(args) == jfusion.tap_sizes(args)
    with pytest.raises(ValueError):
        tfusion.tap_sizes(ntu_args(vid_len=(8, 16)))
    for key in [(0, 12, 8, 0), (3, 2560, 256, 1), (1, 9, 4, 2)]:
        assert tlayers.shared_weight_key(*key) == jlayers.shared_weight_key(*key)
