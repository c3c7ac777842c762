"""The NTU fusion baselines of the port (mfas_tpu_torch/models/ntu.py:
LateFusion, GMU, CentralNet) against the JAX package's, at JAX's own test
geometry (tests/test_ntu_baselines.py): the full-width ResNet-50 at 64 px
and 2 frames, CentralNet at the reference's 224 px with 1 frame (its
central column's 4/2 convolutions and 7x7 average pool need it), HCN over
32 skeleton frames. GMU and CentralNet hard-wire ResNet-50's widths (2048,
512), so the shrink knobs cannot be used.

Weights come from JAX's init(0) through state_dict_from_numpy, so the keys
must equal JAX's flatten_tree keys. The eval forward agrees within 1e-5 of
the logits' max (f32; XLA and oneDNN sum convolutions in other orders).
tests/test_torch_ntu_baselines_train.py holds a train step of each.
"""

import copy
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mfas_tpu.core import Ctx, flatten_tree
from mfas_tpu.models import ntu as JN
from mfas_tpu_torch.models import ntu as TN
from mfas_tpu_torch.runtime.checkpoint import state_dict_from_numpy

EVAL_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: under a parallel test runner every split op
    waits on threads the other workers' processes hold."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def ntu_args(**kw):
    d = dict(num_outputs=60, vid_len=(2, 32), drpt=0.2, num_classes=60)
    d.update(kw)
    return types.SimpleNamespace(**d)


def _inputs(frames, img, seed=0):
    rs = np.random.RandomState(seed)
    rgb = rs.randn(1, frames, img, img, 3).astype(np.float32)
    ske = rs.randn(1, 3, 32, 25, 2).astype(np.float32)
    return rgb, ske


# name -> (vid_len, img)
GEOMETRY = {"LateFusion": ((2, 32), 64), "GMU": ((2, 32), 64),
            "CentralNet": ((1, 32), 224)}


def _pair(name, **kw):
    """(JAX net, its init(0) tree, the port's net holding those weights,
    the inputs)."""
    vid_len, img = GEOMETRY[name]
    args = ntu_args(vid_len=vid_len, **kw)
    jnet = getattr(JN, name)(args)
    tree = jnet.init(0)
    tnet = getattr(TN, name)(args, device="cpu",
                             generator=torch.Generator().manual_seed(1))
    flat = flatten_tree(tree)
    assert list(tnet.state_dict()) == list(flat)
    assert all(tuple(v.shape) == tuple(flat[k].shape)
               for k, v in tnet.state_dict().items())
    tnet.load_state_dict(state_dict_from_numpy(flat), strict=True)
    return jnet, tree, tnet, _inputs(vid_len[0], img)


def _max_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max(), np.abs(want).max()


@pytest.mark.parametrize("name", list(GEOMETRY))
def test_eval_forward_matches_jax(name):
    jnet, tree, tnet, (rgb, ske) = _pair(name)
    want = np.asarray(jnet(tree, Ctx(train=False),
                           (jnp.asarray(rgb), jnp.asarray(ske))))
    tnet.eval()
    with torch.no_grad():
        got = tnet((torch.from_numpy(rgb), torch.from_numpy(ske))).numpy()
    assert got.shape == (1, 60)
    err, scale = _max_err(got, want)
    assert err <= EVAL_TOL * scale, (name, err, scale)


def test_gmu_gate_is_sized_from_the_out7_tap():
    """256*(32//16)^2 = 1024 at the default window; the reference's
    hard-wired 256 at a window of 16."""
    for window, width in ((32, 1024), (16, 256)):
        sd = TN.GMU(ntu_args(vid_len=(2, window)), device="cpu",
                    generator=torch.Generator().manual_seed(0)).state_dict()
        assert sd["skel_redu.0.weight"].shape == (128, width)
        assert sd["ponderation.0.weight"].shape == (1, 2048 + width)


def test_gmu_uses_out7_tap_not_fc7():
    """tests/test_ntu_baselines.py::test_gmu_uses_out7_tap_not_fc7 in the
    port: zeroing the skeleton's fc7/fc8 weights leaves the output as it
    was (the gate reads the pre-fc7 map out7), zeroing conv6 changes it.
    The gate's visual columns are zeroed first, as there: random ResNet
    activations saturate the sigmoid and drown the skeleton branch."""
    _, _, net, (rgb, ske) = _pair("GMU", drpt=0.0)
    net.eval()
    with torch.no_grad():
        net.ponderation[0].weight[:, :2048] = 0.0
    inputs = (torch.from_numpy(rgb), torch.from_numpy(ske))

    def out_with(zeroed):
        n = copy.deepcopy(net)
        with torch.no_grad():
            for key in zeroed:
                n.get_parameter(key).zero_()
            return n(inputs).numpy()

    base = out_with([])
    np.testing.assert_array_equal(
        out_with(["skeleton.fc8.weight", "skeleton.fc7.0.weight"]), base)
    assert not np.allclose(out_with(["skeleton.conv6.0.weight"]), base)
