"""The port's scheduler and Adam against the JAX package's, on the CPU.

* The cosine warm-restart scheduler is the same float64 host code: its eta
  trace through three warm restarts, and its state after a round trip
  through the other package's scheduler, are equal (==).
* ``make_adam`` (torch.optim.Adam, coupled weight decay 1e-4) and
  ``set_lr`` follow JAX's ``adam_update`` over 5 steps of a varying learning
  rate, in the shared-step mode (every parameter has a gradient at every
  step) and in the per-leaf transient-disconnect mode (one parameter's grad
  is None, in JAX zero, for its first 2 steps). torch divides by
  sqrt(v)/sqrt(bc2) + eps where JAX takes sqrt(v/bc2) + eps, so the
  parameters agree to float32 rounding: rtol 1e-5, atol 1e-7.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mfas_tpu.core import optim as joptim
from mfas_tpu.core import sched as jsched
from mfas_tpu_torch.core import optim as toptim
from mfas_tpu_torch.core import sched as tsched

# eta_max, eta_min, Ti, Tm, batches per epoch: restarts after 4, 8 and 16
# more steps' worth of epochs (Ti 1 -> 2 -> 4 -> 8)
SCHED = (1e-3, 1e-6, 1, 2, 4)


def _trace(s, n):
    return [s.step() for _ in range(n)]


def test_cosine_scheduler_trace_through_three_warm_restarts():
    j = jsched.LRCosineAnnealingScheduler(*SCHED)
    t = tsched.LRCosineAnnealingScheduler(*SCHED)
    jt, tt = _trace(j, 40), _trace(t, 40)
    assert tt == jt
    restarts = sum(a <= SCHED[1] + 1e-10 for a in tt)
    assert restarts == 3 and t.Ti == j.Ti == 8
    assert t.state_dict() == j.state_dict()


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_scheduler_state_round_trip(direction):
    src_cls, dst_cls = ((jsched, tsched) if direction == "jax_to_torch"
                        else (tsched, jsched))
    src = src_cls.LRCosineAnnealingScheduler(*SCHED)
    _trace(src, 11)
    dst = dst_cls.LRCosineAnnealingScheduler(1.0, 0.5, 9, 9, 9)
    dst.load_state_dict(src.state_dict())
    assert dst.state_dict() == src.state_dict()
    assert _trace(dst, 20) == _trace(src, 20)


def test_fixed_scheduler():
    j, t = jsched.FixedScheduler(3e-4), tsched.FixedScheduler(3e-4)
    assert _trace(t, 3) == _trace(j, 3) == [3e-4] * 3
    t2 = tsched.FixedScheduler(1.0)
    t2.load_state_dict(j.state_dict())
    assert t2.eta == t2.lr == 3e-4


def test_set_lr_rounds_eta_to_float32():
    p = torch.nn.Parameter(torch.zeros(2))
    opt = toptim.make_adam([p], 1e-4)
    toptim.set_lr(opt, 0.1)
    assert opt.param_groups[0]["lr"] == float(np.float32(0.1)) != 0.1


def test_make_adam_takes_only_trainable_parameters():
    a = torch.nn.Parameter(torch.zeros(2))
    b = torch.nn.Parameter(torch.zeros(2), requires_grad=False)
    opt = toptim.make_adam([a, b], weight_decay=1e-4)
    (group,) = opt.param_groups
    assert group["params"] == [a]
    assert (group["betas"], group["eps"], group["weight_decay"]) == (
        (0.9, 0.999), 1e-8, 1e-4)


@pytest.mark.parametrize("mode", ["shared_step", "per_leaf_disconnect"])
def test_adam_matches_jax_adam_update(mode):
    rs = np.random.RandomState(0)
    init = {"a": rs.randn(3, 4).astype(np.float32),
            "b": rs.randn(5).astype(np.float32)}
    names = sorted(init)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in init.items()}
    opt = toptim.make_adam([tp[k] for k in names], weight_decay=1e-4)
    per_leaf = mode == "per_leaf_disconnect"
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = joptim.adam_init(jp, per_leaf_step=per_leaf)
    sched = tsched.LRCosineAnnealingScheduler(1e-2, 1e-5, 1, 2, 3)

    for step in range(5):
        eta = sched.step()
        grads = {k: rs.randn(*v.shape).astype(np.float32)
                 for k, v in init.items()}
        connected = {"a": True, "b": not per_leaf or step >= 2}
        opt.zero_grad(set_to_none=True)
        for k in names:
            if connected[k]:
                tp[k].grad = torch.from_numpy(grads[k].copy())
        toptim.set_lr(opt, eta)
        opt.step()
        jgrads = {k: jnp.asarray(grads[k] if connected[k]
                                 else np.zeros_like(grads[k]))
                  for k in names}
        jp, state = joptim.adam_update(jp, jgrads, state, jnp.float32(eta),
                                       weight_decay=1e-4,
                                       skip_disconnected=per_leaf)
        for k in names:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{k} step {step}")
    steps = {k: int(opt.state[tp[k]]["step"]) for k in names}
    if per_leaf:
        assert steps == {k: int(state["step"][k]) for k in names} == {
            "a": 5, "b": 3}
    else:
        assert steps == {"a": 5, "b": 5} and int(state["step"]) == 5
