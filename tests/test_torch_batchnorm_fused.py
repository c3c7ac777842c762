"""The fused BatchNorm's CPU side (mfas_tpu_torch/ops/batchnorm.py): the
wrapper's plain version with its (+ residual, ReLU) epilogue is bitwise the
composition ``_BatchNorm`` ran before the kernels; the closed-form backward
that the CUDA kernels implement equals autograd of the plain forward in
float64, one rank and two gloo ranks; the layout and the argument checks
the kernels' wrapper makes before any launch. The kernels themselves run
in tests/test_torch_cuda_batchnorm.py, on the card.
"""

import numpy as np
import pytest
import torch

from mfas_tpu_torch.core import layers as TL
from mfas_tpu_torch.ops import batchnorm as tbn
from tests.torch_ranks import run_ranks

SHAPES = {1: (6, 4), 2: (3, 4, 5, 5), 3: (2, 4, 3, 5, 5)}
EPILOGUES = {"none": (False, False), "relu": (False, True),
             "residual_relu": (True, True)}


def _module(nd, dtype=torch.float32, seed=0):
    bn = getattr(TL, f"BatchNorm{nd}d")(4, device="cpu")
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rs.uniform(0.5, 1.5, 4)))
        bn.bias.copy_(torch.from_numpy(rs.randn(4) * 0.1))
        bn.running_mean.copy_(torch.from_numpy(rs.randn(4) * 0.3))
        bn.running_var.copy_(torch.from_numpy(rs.uniform(0.5, 2.0, 4)))
        bn.num_batches_tracked.fill_(3)
    return bn.to(dtype)


def _input(nd, dtype, seed):
    rs = np.random.RandomState(seed)
    return torch.from_numpy(rs.randn(*SHAPES[nd]) * 2.0 + 1.5).to(dtype)


def _composition(bn, x):
    """``_BatchNorm.forward`` as it was before the fused kernels."""
    shape = [1] * x.dim()
    shape[1] = -1
    if bn.training:
        axes = [i for i in range(x.dim()) if i != 1]
        xs = x if x.dtype == torch.float64 else x.float()
        sums = torch.stack([
            xs.sum(dim=axes), xs.square().sum(dim=axes),
            xs.new_full((x.shape[1],), x.numel() // x.shape[1])])
        s, s2, n = sums.unbind(0)
        mean = s / n
        var = torch.clamp(s2 / n - mean.square(), min=0.0)
        if bn.update_running_stats:
            with torch.no_grad():
                m = bn.momentum
                bn.running_mean.mul_(1 - m).add_(m * mean)
                bn.running_var.mul_(1 - m).add_(
                    m * (var * (n / torch.clamp(n - 1, min=1))))
                bn.num_batches_tracked.add_(1)
        mean, var = mean.to(x.dtype), var.to(x.dtype)
    else:
        mean = bn.running_mean.to(x.dtype)
        var = bn.running_var.to(x.dtype)
    inv = torch.rsqrt(var.reshape(shape) + bn.eps).to(x.dtype)
    out = (x - mean.reshape(shape)) * inv
    return (out * bn.weight.to(x.dtype).reshape(shape)
            + bn.bias.to(x.dtype).reshape(shape))


@pytest.mark.parametrize("epilogue", list(EPILOGUES))
@pytest.mark.parametrize("update", [True, False], ids=["update", "frozen"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("nd", [1, 2, 3])
def test_plain_wrapper_is_bitwise_the_old_composition(nd, train, update,
                                                      epilogue):
    with_res, relu = EPILOGUES[epilogue]
    for dtype in (torch.float32, torch.bfloat16):
        got_bn, want_bn = _module(nd), _module(nd)
        for m in (got_bn, want_bn):
            m.train(train)
            m.update_running_stats = update
        x = _input(nd, dtype, seed=nd)
        res = _input(nd, dtype, seed=10 + nd) if with_res else None
        counts = dict(tbn.launch_counts)
        got = got_bn(x, residual=res, relu=relu)
        want = _composition(want_bn, x)
        if with_res:
            want = want + res
        if relu:
            want = torch.relu(want)
        assert got.dtype == dtype
        assert torch.equal(got, want)
        for k, v in want_bn.state_dict().items():
            assert torch.equal(got_bn.state_dict()[k], v), k
        assert tbn.launch_counts == counts      # the CPU launches nothing


def _clamped_channel(x, c):
    """Channel c of x set to a large value plus small noise, whose one-pass
    variance rounds below zero: the forward's clamp takes effect there
    while xhat is far from zero, so the variance term would show."""
    noise = torch.from_numpy(
        np.random.RandomState(7).randn(*x[:, c].shape)) * 1e-5
    for v in np.linspace(1e4, 2e4, 300):
        x[:, c] = v + noise
        if bool(tbn.batch_statistics_plain(x)[3][c]):
            return x
    raise AssertionError("no value rounds the variance below zero")


def _closed_form_case(nd, train, epilogue, clamp, seed=0):
    """(autograd of batch_norm_plain, batch_norm_backward_plain), each
    (dx, dweight, dbias, dresidual), float64."""
    with_res, relu = EPILOGUES[epilogue]
    bn = _module(nd, torch.float64, seed)
    bn.train(train)
    x = _input(nd, torch.float64, seed=20 + nd)
    if clamp:
        x = _clamped_channel(x, 2)
    res = _input(nd, torch.float64, seed=30 + nd) if with_res else None
    dy = _input(nd, torch.float64, seed=40 + nd)
    return _both_backwards(bn, x, res, dy, relu, train, group=None)


def _both_backwards(bn, x, res, dy, relu, train, group):
    if train:
        mean, var, n, clamped = tbn.batch_statistics_plain(x, group)
    else:
        mean, var = bn.running_mean.double(), bn.running_var.double()
        n, clamped = None, None
    inv = torch.rsqrt(var + bn.eps)
    leaves = [x.clone().requires_grad_(), bn.weight, bn.bias]
    if res is not None:
        leaves.append(res.clone().requires_grad_())
    bn.group = group
    y = bn(leaves[0], residual=leaves[3] if res is not None else None,
           relu=relu)
    grads = torch.autograd.grad(y, leaves, dy)
    closed = tbn.batch_norm_backward_plain(
        dy, x, y.detach(), mean, inv, bn.weight.detach(), n, clamped,
        training=train, relu=relu, group=group)
    if res is None:
        closed = closed[:3]
    return ([g.detach().numpy() for g in grads],
            [c.detach().numpy() for c in closed])


def _within(a, b, tol=1e-10):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() <= tol * max(1.0, np.abs(b).max())


@pytest.mark.parametrize("epilogue", list(EPILOGUES))
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("nd", [1, 2, 3])
def test_closed_form_backward_is_autograd_of_the_plain_forward(nd, train,
                                                               epilogue):
    auto, closed = _closed_form_case(nd, train, epilogue, clamp=False)
    assert len(auto) == len(closed)
    for name, a, c in zip(("dx", "dweight", "dbias", "dresidual"), auto,
                          closed):
        assert _within(c, a), name


@pytest.mark.parametrize("epilogue", list(EPILOGUES))
@pytest.mark.parametrize("nd", [2, 3])
def test_closed_form_backward_drops_the_variance_term_where_clamped(
        nd, epilogue):
    auto, closed = _closed_form_case(nd, True, epilogue, clamp=True)
    for name, a, c in zip(("dx", "dweight", "dbias", "dresidual"), auto,
                          closed):
        assert _within(c, a), name


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    rs = np.random.RandomState(3)
    inputs = {"x": rs.randn(4, 3, 2, 5, 5) * 2.0 + 1.0,
              "res": rs.randn(4, 3, 2, 5, 5),
              "dy": rs.randn(4, 3, 2, 5, 5),
              "w": rs.uniform(0.5, 1.5, 3), "b": rs.randn(3) * 0.1}
    out = run_ranks(2, ["batchnorm_closed_form"], inputs,
                    tmp_path_factory.mktemp("bn_two_ranks"))
    return inputs, [r["batchnorm_closed_form"] for r in out]


@pytest.mark.parametrize("epilogue", list(EPILOGUES))
def test_closed_form_backward_over_two_gloo_ranks(two_ranks, epilogue):
    """Each rank's closed form equals its autograd under the group (the
    statistics and the backward's [sum g, sum g*xhat] SUMmed over it), and
    the ranks' dx together equal the one-rank closed form's on the whole
    batch."""
    inp, ranks = two_ranks
    for r in ranks:
        auto, closed = r[epilogue]
        for name, a, c in zip(("dx", "dweight", "dbias", "dresidual"), auto,
                              closed):
            assert _within(c, a), name
    with_res, relu = EPILOGUES[epilogue]
    bn = TL.BatchNorm3d(3, device="cpu").double()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inp["w"]))
        bn.bias.copy_(torch.from_numpy(inp["b"]))
    whole = _both_backwards(
        bn, torch.from_numpy(inp["x"]),
        torch.from_numpy(inp["res"]) if with_res else None,
        torch.from_numpy(inp["dy"]), relu, True, group=None)[1]
    assert _within(np.concatenate([r[epilogue][1][0] for r in ranks]),
                   whole[0])
    assert _within(ranks[0][epilogue][1][1] + ranks[1][epilogue][1][1],
                   whole[1])


@pytest.mark.parametrize("case", ["contiguous_5d", "contiguous_4d", "bn1d",
                                  "channels_last_4d", "channels_last_3d",
                                  "one_by_one", "frames_first", "hw_swapped",
                                  "one_channel"])
def test_layout_of_what_the_kernels_take(case):
    x5 = torch.zeros(2, 3, 4, 5, 6)
    shapes = {
        "contiguous_5d": (x5, (2, 3, 120)),
        "contiguous_4d": (torch.zeros(2, 3, 7, 7), (2, 3, 49)),
        "bn1d": (torch.zeros(20, 256), (20, 256, 1)),
        "channels_last_4d": (torch.zeros(2, 3, 7, 5).contiguous(
            memory_format=torch.channels_last), (70, 3, 1)),
        "channels_last_3d": (x5.contiguous(
            memory_format=torch.channels_last_3d), (240, 3, 1)),
        "one_by_one": (torch.zeros(4, 8, 1, 1), (4, 8, 1)),
        # (N, T, C, H, W) in memory, as 3D convolutions run as 2D ones give
        "frames_first": (torch.zeros(2, 4, 3, 5, 6).transpose(1, 2),
                         (8, 3, 30)),
        "hw_swapped": (torch.zeros(2, 3, 4, 5).transpose(2, 3), (2, 3, 20)),
        "one_channel": (torch.zeros(4, 1, 3, 3).transpose(2, 3), (1, 1, 36)),
    }
    x, want = shapes[case]
    assert tbn.layout(x) == want


def test_layout_raises_on_gaps_and_overlaps():
    x = torch.zeros(2, 3, 4, 5)
    for bad in (x[:, :, ::2], x[:, :2], torch.zeros(2, 3, 1, 5).expand(
            2, 3, 4, 5), torch.zeros(5)):
        with pytest.raises(ValueError):
            tbn.layout(bad)


@pytest.mark.parametrize("shape,width,want", [
    ((160, 64, 16384), 8, 33),      # ResNet-50's stem, bf16
    ((20, 256, 32768), 8, 9),       # layer1, bf16
    ((20, 2048, 512), 8, 1),        # layer4: a block a channel
    ((128, 128, 49), 1, 6),         # AV-MNIST's 7x7 stage, element units
    ((20, 256, 1), 1, 1),           # BatchNorm1d (packed)
    ((160 * 128 * 128, 64, 1), 8, 2112),   # the stem bf16, channels-last
    ((20 * 8 * 64 * 64, 64, 1), 8, 1280),  # layer1 bf16, channels-last
    ((20 * 8 * 8 * 8, 2048, 1), 8, 80),    # layer4 bf16, channels-last
])
def test_stats_splits_follow_the_shape(shape, width, want):
    assert tbn.stats_splits(*shape, width) == want


def test_require_raises_before_any_launch():
    C = 4
    x = torch.zeros(2, C, 3, 3)
    w, b = torch.ones(C), torch.zeros(C)
    rm, rv = torch.zeros(C), torch.ones(C)
    nbt = torch.zeros((), dtype=torch.long)
    assert tbn._require(x, w, b, rm, rv, nbt, None) == (2, C, 9)
    bad = [
        (x.half(), w, b, rm, rv, nbt, None),                  # dtype
        (x[:, :, ::2], w, b, rm, rv, nbt, None),              # a gap
        (x, torch.ones(C + 1), b, rm, rv, nbt, None),         # weight shape
        (x, w, b, rm, rv, nbt.int(), None),                   # counter dtype
        (x, w, b, rm, rv, nbt, torch.zeros(2, C, 3, 4)),      # residual
        (x, w, b, rm, rv, nbt, x.double()),                   # its dtype
    ]
    for args in bad:
        with pytest.raises(ValueError):
            tbn._require(*args)


def _eval_op(bn, x, res, relu):
    return tbn.batch_norm_eval(x, bn.weight, bn.bias, bn.running_mean,
                               bn.running_var, res, bn.eps, relu)


@pytest.mark.parametrize("epilogue", list(EPILOGUES))
@pytest.mark.parametrize("nd", [1, 2, 3])
def test_eval_op_off_the_card_is_the_plain_version(nd, epilogue):
    """mfas::batch_norm_eval on a CPU tensor (an artifact exported on the
    card and served on the CPU runs it so) is bitwise the wrapper's eval
    forward; its record holds the per-channel mean, inverse deviation,
    weight and bias as that forward rounded them."""
    with_res, relu = EPILOGUES[epilogue]
    for dtype in (torch.float32, torch.bfloat16, torch.float64):
        bn = _module(nd).eval()
        x = _input(nd, dtype, seed=nd)
        res = _input(nd, dtype, seed=10 + nd) if with_res else None
        y, coef = _eval_op(bn, x, res, relu)
        assert torch.equal(y, bn(x, residual=res, relu=relu))
        rows = (bn.running_mean, torch.rsqrt(
            bn.running_var.to(dtype) + bn.eps), bn.weight, bn.bias)
        for got, want in zip(coef[:4], rows):
            assert torch.equal(got, want.to(dtype).to(coef.dtype))


@pytest.mark.parametrize("epilogue", list(EPILOGUES))
@pytest.mark.parametrize("nd", [1, 2, 3])
def test_eval_op_backward_is_autograd_of_the_plain_forward(nd, epilogue):
    """The op's registered backward (the closed form off the card) against
    autograd of batch_norm_plain in eval mode, float64; a second backward
    through it raises instead of giving nothing."""
    with_res, relu = EPILOGUES[epilogue]
    bn = _module(nd, torch.float64).eval()
    x = _input(nd, torch.float64, seed=20 + nd)
    res = _input(nd, torch.float64, seed=30 + nd) if with_res else None
    dy = _input(nd, torch.float64, seed=40 + nd)
    grads = []
    for fn in ("op", "plain"):
        leaves = [x.clone().requires_grad_(), bn.weight, bn.bias]
        if with_res:
            leaves.append(res.clone().requires_grad_())
        r = leaves[3] if with_res else None
        y = (_eval_op(bn, leaves[0], r, relu)[0] if fn == "op" else
             tbn.batch_norm_plain(leaves[0], bn.weight, bn.bias,
                                  bn.running_mean, bn.running_var, None,
                                  training=False, momentum=bn.momentum,
                                  eps=bn.eps, residual=r, relu=relu))
        grads.append(torch.autograd.grad(y, leaves, dy))
    for name, a, c in zip(("dx", "dweight", "dbias", "dresidual"), *grads):
        assert _within(a.numpy(), c.numpy()), name
    xs = x.clone().requires_grad_()
    g, = torch.autograd.grad(_eval_op(bn, xs, None, relu)[0].square().sum(),
                             xs, create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(g.sum(), xs)


class _EvalOpNet(torch.nn.Module):
    """A BatchNorm through the op, as ``batch_norm`` calls it for a card
    tensor in eval mode, and through the module's own CPU path."""

    def __init__(self):
        super().__init__()
        self.a, self.b = _module(2, seed=1), _module(2, seed=2)

    def forward(self, x):
        y = _eval_op(self.a, x, None, True)[0]
        return self.b(y, residual=x, relu=True)


def test_export_records_the_eval_op(tmp_path):
    """torch.export records mfas::batch_norm_eval as one node (a CPU
    tensor's BatchNorm as the plain composition), and the saved artifact,
    reloaded through runtime/export.py at another batch size, gives the
    eager forward bitwise."""
    from mfas_tpu_torch.runtime.export import load_exported, save_exported

    net = _EvalOpNet().eval()
    path = str(tmp_path / "bn.pt2")
    save_exported(path, net, (_input(2, torch.float32, seed=1),),
                  dynamic_batch=True)
    exp = load_exported(path, "cpu")
    ops = [n.target for n in exp.program.graph.nodes
           if n.op == "call_function"]
    assert ops.count(torch.ops.mfas.batch_norm_eval.default) == 1
    assert torch.ops.aten.rsqrt.default in ops
    x = torch.from_numpy(np.random.RandomState(5).randn(7, 4, 5, 5)).float()
    with torch.no_grad():
        assert torch.equal(exp.call(x), net(x))
