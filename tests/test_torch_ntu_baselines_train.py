"""One train-mode step of the port's NTU fusion baselines (LateFusion,
GMU, CentralNet) against the JAX package's, in float64 with --drpt 0, at
JAX's test geometry with JAX's init(0) weights (the helpers of
tests/test_torch_ntu_baselines.py): LateFusion and GMU over every
parameter, CentralNet over central_params(). The loss agrees within 1e-12
relative, every gradient within 1e-9 of its tensor's max and the BatchNorm
statistics within 1e-9 of theirs; the gradients that vanish are named.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfas_tpu.core import Ctx, flatten_tree, merge
from mfas_tpu.core import functional as JF
from mfas_tpu.engine.classifier import split_tree
from mfas_tpu_torch.core.layers import set_dropout_generator
from mfas_tpu_torch.engine.classifier import set_trainable
from tests.test_torch_ntu_baselines import GEOMETRY, _max_err, _pair

GRAD_TOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: under a parallel test runner every split op
    waits on threads the other workers' processes hold."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


# parameters outside the loss's graph: no gradient in the port (grad
# None), an all-zero one in JAX. GMU reads the skeleton's out7 and the
# video's pooled embedding, not their heads; CentralNet creates four alphas
# per list and uses three (as the reference)
UNUSED = {"LateFusion": (),
          "GMU": ("skeleton.fc7.0.weight", "skeleton.fc7.0.bias",
                  "skeleton.fc8.weight", "skeleton.fc8.bias",
                  "visual.classifier.weight", "visual.classifier.bias"),
          "CentralNet": ("alphas_a.3", "alphas_v.3", "alphas_c.3")}
# CentralNet's gradients that vanish analytically, held below 1e-12 of
# the largest gradient on both sides: alphas_c.0 weighs the central
# column's starting maps, which are zeros; a conv bias ahead of a
# train-mode BatchNorm is taken out with the batch mean (rounding noise)
VANISHING = ("alphas_c.0", "central_conv.0.0.bias", "central_conv.1.0.bias")


@pytest.mark.parametrize("name", list(GEOMETRY))
def test_train_step_f64_matches_jax(name):
    jnet, tree, tnet, (rgb, ske) = _pair(name, drpt=0.0)
    label = np.array([7])
    prefixes = (tnet.central_params() if name == "CentralNet" else None)

    jax.config.update("jax_enable_x64", True)
    try:
        tree64 = _f64(tree)
        trainable, frozen = split_tree(jnet, tree64, prefixes)
        inputs = (jnp.asarray(rgb, jnp.float64), jnp.asarray(ske, jnp.float64))

        def loss_fn(tr):
            ctx = Ctx(train=True)
            out = jnet(merge(tr, frozen), ctx, inputs)
            return JF.cross_entropy(out, jnp.asarray(label)), ctx.updates

        (jloss, updates), jgrads = jax.value_and_grad(
            loss_fn, has_aux=True)(trainable)
        jloss = float(jloss)
        # the frozen half's leaves are None in JAX's split trees
        jgrads = {k: np.asarray(v) for k, v in flatten_tree(jgrads).items()
                  if v is not None}
        updates = {k: np.asarray(v) for k, v in updates.items()}
    finally:
        jax.config.update("jax_enable_x64", False)

    tnet.double().train()
    set_dropout_generator(tnet, torch.Generator().manual_seed(0))
    set_trainable(tnet, prefixes)
    out = tnet((torch.from_numpy(rgb).double(),
                torch.from_numpy(ske).double()))
    loss = torch.nn.functional.cross_entropy(out, torch.from_numpy(label))
    loss.backward()

    assert abs(loss.item() - jloss) <= 1e-12 * abs(jloss)
    tgrads = {k: p.grad for k, p in tnet.named_parameters()
              if p.requires_grad}
    assert set(tgrads) == set(jgrads)
    for key, want in jgrads.items():
        if key in UNUSED[name]:
            assert tgrads[key] is None and not want.any(), key
            continue
        assert tgrads[key] is not None, key
        if name == "CentralNet" and key in VANISHING:
            largest = max(np.abs(g).max() for g in jgrads.values())
            assert max(np.abs(want).max(),
                       tgrads[key].abs().max().item()) <= 1e-12 * largest
            continue
        err, scale = _max_err(tgrads[key].numpy(), want)
        assert scale > 0 and err <= GRAD_TOL * scale, (key, err, scale)
    # the BatchNorm statistics of the step, backbones' included
    buffers = dict(tnet.named_buffers())
    stats = [k for k in updates if not k.endswith("num_batches_tracked")]
    assert stats and set(updates) <= set(buffers)
    for key in stats:
        err, scale = _max_err(buffers[key].numpy(), updates[key])
        assert err <= GRAD_TOL * scale, (key, err, scale)
