"""The fused BatchNorm kernels on the card (mfas_tpu_torch/csrc/batchnorm.cu
through ops/batchnorm.py), held against the plain version at the main
paths' shapes: every distinct BatchNorm shape of ResNet-50 at B=20 (8
frames of 256x256), of both AV-MNIST LeNets at B=128, and BatchNorm1d
(20, 256); float32 and bfloat16, contiguous, channels-last and frames
before channels, train and eval, forward and backward. Also: the launch counts of a whole step, a
captured replay bitwise the eager call, the raise on what the kernels do
not take, and (printed) the kernels' time beside the plain version's, the
library's ``torch.nn.functional.batch_norm`` and the least time from
bytes. Every test here needs a CUDA device and skips without one. This
file imports neither JAX nor the JAX package, so it also runs where they
are not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda -s \\
        tests/test_torch_cuda_batchnorm.py
"""

import json
import statistics

import numpy as np
import pytest
import torch

from mfas_tpu_torch.core import layers as TL
from mfas_tpu_torch.models.resnet3d import ResNet3D
from mfas_tpu_torch.ops import batchnorm as tbn
from mfas_tpu_torch.runtime import graphs

pytestmark = pytest.mark.cuda

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
HBM_BYTES_PER_S = 3.35e12

# (shape, epilogue): ResNet-50's BatchNorms at B=20, 8 x 256x256 (the stem
# is frame-wise 2D over B*T = 160 frames), both LeNets' at B=128, and the
# fusion head's BatchNorm1d; "res" is the residual + ReLU epilogue
SHAPES = {
    "r50_stem": ((160, 64, 128, 128), "none"),
    "r50_l1_bn1": ((20, 64, 8, 64, 64), "relu"),
    "r50_l1_bn3": ((20, 256, 8, 64, 64), "res"),
    "r50_l1_down": ((20, 256, 8, 64, 64), "none"),
    "r50_l2_bn1_first": ((20, 128, 8, 64, 64), "relu"),
    "r50_l2_bn2": ((20, 128, 8, 32, 32), "relu"),
    "r50_l2_bn3": ((20, 512, 8, 32, 32), "res"),
    "r50_l3_bn1_first": ((20, 256, 8, 32, 32), "relu"),
    "r50_l3_bn2": ((20, 256, 8, 16, 16), "relu"),
    "r50_l3_bn3": ((20, 1024, 8, 16, 16), "res"),
    "r50_l4_bn1_first": ((20, 512, 8, 16, 16), "relu"),
    "r50_l4_bn2": ((20, 512, 8, 8, 8), "relu"),
    "r50_l4_bn3": ((20, 2048, 8, 8, 8), "res"),
    "lenet_28": ((128, 32, 28, 28), "relu"),
    "lenet_14": ((128, 64, 14, 14), "relu"),
    "lenet_7": ((128, 128, 7, 7), "relu"),
    "deeper_112": ((128, 32, 112, 112), "relu"),
    "deeper_56": ((128, 64, 56, 56), "relu"),
    "deeper_28": ((128, 128, 28, 28), "relu"),
    "deeper_14": ((128, 256, 14, 14), "relu"),
    "deeper_7": ((128, 512, 7, 7), "relu"),
    "head_bn1d": ((20, 256), "none"),
}
# the found NTU net's frames arrive channels-last and cuDNN keeps the
# layout, so ResNet-50's BatchNorms run channels-last on the main path
CHANNELS_LAST = [k for k in SHAPES if k.startswith("r50")] + ["lenet_14",
                                                               "deeper_7"]
# how a test lays its activations out in memory: contiguous, channels-last,
# or frames before channels ((N, T, C, H, W) in memory, as the 3D
# convolutions run as 2D ones, core/functional.py::set_conv3d_as_2d, give)
LAYOUTS = {
    "contiguous": lambda t: t.contiguous(),
    "channels_last": lambda t: t.contiguous(
        memory_format=torch.channels_last if t.dim() == 4
        else torch.channels_last_3d),
    "frames_first": lambda t: t.transpose(1, 2).contiguous().transpose(1, 2),
}
# the forward's error against float64 may exceed the plain version's by
# half again and this much (of the reference's largest magnitude): a
# bfloat16 ulp at 1, float32's rounding; the backward's, which rounds once
# from float32 registers, lies within TOL_BWD of float64
FLOOR_FWD = {torch.float64: 1e-12, torch.float32: 1e-6,
             torch.bfloat16: 2.0 ** -8}
TOL_BWD = {torch.float64: 1e-9, torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tbn.reset_launch_counts()
    yield torch.device("cuda")
    torch.cuda.empty_cache()


def _inputs(shape, dtype, device, seed, lay="contiguous"):
    """x like a convolution's output (a per-channel offset and scale), a
    residual, an output gradient, and the module's parameters."""
    g = torch.Generator(device=device).manual_seed(seed)
    C = shape[1]
    cshape = [1, C] + [1] * (len(shape) - 2)
    off = torch.randn(cshape, generator=g, device=device)
    scale = torch.rand(cshape, generator=g, device=device) * 2 + 0.25
    x = torch.randn(shape, generator=g, device=device) * scale + off
    res = torch.randn(shape, generator=g, device=device)
    dy = torch.randn(shape, generator=g, device=device)
    w = torch.rand(C, generator=g, device=device) + 0.5
    b = torch.randn(C, generator=g, device=device) * 0.1
    rm = torch.randn(C, generator=g, device=device) * 0.3
    rv = torch.rand(C, generator=g, device=device) + 0.5
    cast = [LAYOUTS[lay](t.to(dtype)) for t in (x, res, dy)]
    # float32 parameters, as under bf16 autocast; float64 ones for float64
    # input, as a model moved to float64 holds
    pdt = torch.float64 if dtype == torch.float64 else torch.float32
    return (*cast, *(t.to(pdt) for t in (w, b, rm, rv)))


def _state(rm, rv):
    return [rm.clone(), rv.clone(), torch.zeros((), dtype=torch.long,
                                                device=rm.device)]


def _run(fn, x, res, dy, w, b, state, train, relu, with_res):
    """fn's forward and backward -> (y, dx, dw, db, dres, state)."""
    leaves = [x.detach().clone().requires_grad_(),
              w.detach().clone().requires_grad_(),
              b.detach().clone().requires_grad_()]
    if with_res:
        leaves.append(res.detach().clone().requires_grad_())
    y = fn(leaves[0], leaves[1], leaves[2], *state, training=train,
           momentum=0.1, eps=1e-5, residual=leaves[3] if with_res else None,
           relu=relu)
    grads = torch.autograd.grad(y, leaves, dy)
    return y.detach(), grads, state


def _err(a, ref):
    ref = ref.double()
    return float((a.double() - ref).abs().max() / ref.abs().max())


def _check_case(shape, epilogue, dtype, device, train, lay, seed):
    relu, with_res = epilogue != "none", epilogue == "res"
    x, res, dy, w, b, rm, rv = _inputs(shape, dtype, device, seed, lay)
    before = dict(tbn.launch_counts)
    yk, gk, sk = _run(tbn.batch_norm, x, res, dy, w, b, _state(rm, rv),
                      train, relu, with_res)
    torch.cuda.synchronize()
    added = {k: v - before[k] for k, v in tbn.launch_counts.items()}
    assert added == {"stats": int(train), "finalize": 1, "apply": 1,
                     "grad_stats": 1, "grad_finalize": 1, "grad_input": 1}
    assert yk.dtype == dtype and yk.stride() == x.stride()
    yp, _, sp = _run(tbn.batch_norm_plain, x, res, dy, w, b, _state(rm, rv),
                     train, relu, with_res)
    s64 = [t.double() for t in _state(rm, rv)]
    s64[2] = s64[2].long()
    y64, _, _ = _run(tbn.batch_norm_plain, x.double(), res.double(),
                     dy.double(), w.double(), b.double(), s64, train, relu,
                     with_res)
    # forward: no further from float64 than the plain version, give or
    # take rounding
    assert _err(yk, y64) <= 1.5 * _err(yp, y64) + FLOOR_FWD[dtype]
    # the running statistics as the plain version moves them
    for got, want in zip(sk[:2], sp[:2]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert int(sk[2]) == int(sp[2]) == int(train)
    # backward: float64's closed form under the kernel's own ReLU mask (a
    # y within rounding of 0 may fall on either side), and the forward's
    # statistics as it rounded them
    x64 = x.double()
    if train:
        mean, var, n, clamped = tbn.batch_statistics_plain(x64)
    else:
        mean, var, n, clamped = rm.double(), rv.double(), None, None
    mean = mean.to(dtype).double()
    inv = torch.rsqrt(var.to(dtype).double() + 1e-5).to(dtype).double()
    want = tbn.batch_norm_backward_plain(
        dy.double(), x64, yk.double(), mean, inv, w.to(dtype).double(), n,
        clamped, training=train, relu=relu)
    for name, got, ref in zip(("dx", "dweight", "dbias"), gk, want):
        assert _err(got, ref) <= TOL_BWD[dtype], name
    if with_res:   # dy where the kernel's own output is positive, exactly
        assert torch.equal(gk[3], torch.where(yk <= 0, torch.zeros_like(dy),
                                              dy))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", list(SHAPES))
def test_kernels_against_the_plain_version(cuda, case, dt, train):
    shape, epilogue = SHAPES[case]
    _check_case(shape, epilogue, DTYPES[dt], cuda, train, "contiguous",
                seed=len(case))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", CHANNELS_LAST)
def test_kernels_channels_last(cuda, case, dt, train):
    shape, epilogue = SHAPES[case]
    _check_case(shape, epilogue, DTYPES[dt], cuda, train, "channels_last",
                seed=7)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", ["r50_l1_bn1", "r50_l3_bn3"])
def test_kernels_frames_first(cuda, case, dt):
    shape, epilogue = SHAPES[case]
    _check_case(shape, epilogue, DTYPES[dt], cuda, True, "frames_first",
                seed=8)


def test_float64_and_unaligned_rows(cuda):
    """float64 (the card-against-CPU checks' dtype), and planes of 7x7 and
    3x7, whose rows take the one-element path."""
    for shape in ((4, 6, 8, 8), (6, 5, 7, 7)):
        _check_case(shape, "res", torch.float64, cuda, True, "contiguous",
                    seed=3)
    for dt in DTYPES.values():
        _check_case((6, 5, 3, 7), "relu", dt, cuda, True, "contiguous",
                    seed=4)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_launches_cover_every_batchnorm_of_a_step(cuda, dt):
    """A small inflated ResNet's train step: one apply and one grad_input
    launch for each BatchNorm call, the plain version nowhere."""
    net = ResNet3D((1, 1, 1, 1), 8, device=cuda,
                   generator=torch.Generator().manual_seed(0))
    calls = []
    for m in net.modules():
        if isinstance(m, TL._BatchNorm):
            m.register_forward_hook(lambda *a: calls.append(1))
    x = torch.randn(2, 3, 4, 32, 32, device=cuda)
    with torch.autocast("cuda", dtype=torch.bfloat16,
                        enabled=dt == "bf16"):
        out = net(x)
    sum(o.float().square().mean() for o in out).backward()
    torch.cuda.synchronize()
    n = len(calls)
    assert n == sum(isinstance(m, TL._BatchNorm) for m in net.modules())
    assert tbn.launch_counts == {"stats": n, "finalize": n, "apply": n,
                                 "grad_stats": n, "grad_finalize": n,
                                 "grad_input": n}


@pytest.mark.parametrize("lay", ["contiguous", "channels_last"])
def test_captured_replay_is_bitwise_the_eager_call(cuda, lay):
    """A BatchNorm3d with the residual epilogue, forward and backward,
    captured (runtime/graphs.py) and replayed against the same calls made
    eagerly on a twin: outputs, gradients and running statistics bitwise,
    and each replay counts the launches one call makes."""
    shape = (4, 64, 4, 16, 16)
    x, res, dy, *_ = _inputs(shape, torch.bfloat16, cuda, seed=11, lay=lay)
    twins = [TL.BatchNorm3d(64, device=cuda) for _ in range(2)]

    def step(bn):
        xs = x.detach().requires_grad_()
        rs = res.detach().requires_grad_()
        with torch.autocast("cuda", dtype=torch.bfloat16):
            y = bn(xs, residual=rs, relu=True)
        grads = torch.autograd.grad(y, (xs, bn.weight, bn.bias, rs), dy)
        return (y, *grads)

    graph = graphs.capture("bn", lambda: step(twins[0]))
    tbn.reset_launch_counts()
    graph.replay()
    torch.cuda.synchronize()
    assert tbn.launch_counts == {"stats": 1, "finalize": 1, "apply": 1,
                                 "grad_stats": 1, "grad_finalize": 1,
                                 "grad_input": 1}
    for _ in range(graphs.WARMUP_CALLS + 1):
        want = step(twins[1])
    torch.cuda.synchronize()
    for got, ref in zip(graph.out, want):
        assert torch.equal(got, ref)
    for k, v in twins[1].state_dict().items():
        assert torch.equal(twins[0].state_dict()[k], v), k


def test_eval_replay_and_export_run_the_kernels(cuda, tmp_path):
    """Eval mode goes through the op mfas::batch_norm_eval: a captured
    replay of a small inflated ResNet's eval forward is bitwise its eager
    call; torch.export on the card records one op node for each BatchNorm
    (and no plain composition), and the reloaded artifact on the card runs
    the kernels, bitwise the eager forward, at another batch size."""
    from mfas_tpu_torch.runtime.export import load_exported, save_exported

    net = ResNet3D((1, 1, 1, 1), 8, device=cuda,
                   generator=torch.Generator().manual_seed(0))
    for m in net.modules():
        if isinstance(m, TL._BatchNorm):
            with torch.no_grad():
                m.running_mean.uniform_(-0.5, 0.5)
                m.running_var.uniform_(0.5, 2.0)
    net.eval()
    n = sum(isinstance(m, TL._BatchNorm) for m in net.modules())
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(2, 3, 4, 32, 32, device=cuda, generator=g)
    with torch.no_grad():
        graph = graphs.capture("bn_eval", lambda: net(x)[0])
        tbn.reset_launch_counts()
        graph.replay()
        want = net(x)[0]
    torch.cuda.synchronize()
    assert torch.equal(graph.out, want)
    assert tbn.launch_counts == {"stats": 0, "finalize": 2 * n,
                                 "apply": 2 * n, "grad_stats": 0,
                                 "grad_finalize": 0, "grad_input": 0}

    class First(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.net = net

        def forward(self, x):
            return self.net(x)[0]

    path = str(tmp_path / "net.pt2")
    save_exported(path, First(), (x,), dynamic_batch=True)
    exp = load_exported(path, "cuda")
    ops = [nd.target for nd in exp.program.graph.nodes
           if nd.op == "call_function"]
    assert ops.count(torch.ops.mfas.batch_norm_eval.default) == n
    assert torch.ops.aten.rsqrt.default not in ops
    x3 = torch.randn(3, 3, 4, 32, 32, device=cuda, generator=g)
    tbn.reset_launch_counts()
    got = exp.call(x3)
    torch.cuda.synchronize()
    assert tbn.launch_counts["apply"] == tbn.launch_counts["finalize"] == n
    with torch.no_grad():
        assert torch.equal(got, net(x3)[0])


def test_unsupported_input_raises(cuda):
    bn = TL.BatchNorm2d(4, device=cuda)
    x = torch.randn(2, 4, 5, 6, device=cuda)
    for bad in (x.half(), x[:, :, ::2]):
        with pytest.raises(ValueError):
            bn(bad)
    with pytest.raises(ValueError):     # a residual of another dtype
        bn(x, residual=x.double())
    assert sum(tbn.launch_counts.values()) == 0


def test_residual_of_another_layout_is_laid_out_as_x(cuda):
    """A channels-last residual beside a contiguous x: the same output and
    gradients, bitwise, as the residual laid out as x."""
    x, res, dy, *_ = _inputs((4, 16, 3, 8, 8), torch.float32, cuda, seed=12)
    outs = []
    for r in (res, LAYOUTS["channels_last"](res)):
        bn = TL.BatchNorm3d(16, device=cuda)
        xs, rs = x.clone().requires_grad_(), r.clone().requires_grad_()
        y = bn(xs, residual=rs, relu=True)
        outs.append((y, *torch.autograd.grad(y, (xs, rs), dy)))
    for got, want in zip(*outs):
        assert torch.equal(got, want)


def _replay_ms(fn, reps=10):
    """Median of ``reps`` CUDA-event timings of a replay of fn() captured
    as a CUDA graph (runtime/graphs.py): the device's time, without the
    host's."""
    graph = graphs.capture("bn_time", fn)
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", ["r50_l1_bn3", "r50_l3_bn3"])
def test_time_against_plain_and_library(cuda, case, dt):
    """Prints one JSON line: forward, backward and both, in us, for the
    kernels, the plain version, and the library's
    torch.nn.functional.batch_norm + residual + ReLU (a yardstick the port
    never calls), each from graph replays in the found NTU net's
    channels-last layout, with the least time from bytes at 3.35 TB/s (x,
    the residual and y once forward; dy, x, y, dx and the residual's
    gradient once backward)."""
    shape, _ = SHAPES[case]
    dtype = DTYPES[dt]
    x, res, dy, w, b, rm, rv = _inputs(shape, dtype, cuda, seed=1,
                                       lay="channels_last")
    leaves = [t.requires_grad_() for t in (x, w, b, res)]
    state = _state(rm, rv)

    def library(x, w, b, rm, rv, nbt, *, training, momentum, eps, residual,
                relu):
        y = torch.nn.functional.batch_norm(x, rm, rv, w, b, training,
                                           momentum, eps)
        return torch.relu(y + residual)

    out = {"case": case, "dtype": dt, "shape": list(shape),
           "layout": "channels_last_3d",
           "device": torch.cuda.get_device_name(0),
           "bytes_least_us": 1e6 * 8 * x.numel() * x.element_size()
           / HBM_BYTES_PER_S}
    for name, fn in (("kernel", tbn.batch_norm),
                     ("plain", tbn.batch_norm_plain), ("library", library)):
        def fwd():
            return fn(x, w, b, *state, training=True, momentum=0.1,
                      eps=1e-5, residual=res, relu=True)

        def both():
            return torch.autograd.grad(fwd(), leaves, dy)

        f_ms, t_ms = _replay_ms(fwd), _replay_ms(both)
        out[name] = {"fwd_us": 1e3 * f_ms, "bwd_us": 1e3 * (t_ms - f_ms),
                     "total_us": 1e3 * t_ms}
        torch.cuda.empty_cache()
    print("BN_TIME " + json.dumps(out))
    assert np.isfinite(out["kernel"]["total_us"])
