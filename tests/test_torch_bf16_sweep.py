"""python -m mfas_tpu_torch.tools.bf16_sweep, on the CPU at a tiny size
(2 frames of 32 px, one block per ResNet stage at base width 8, the
variants' batches over 16, one timed call):
the JAX tool's 12 variants, each with the JAX tool's batch, precision and
options (read off the JAX tool's main with its build and timer stubbed),
its JSON keys, each option's formulation taken by the variants that name
it and by no other, and each variant's first-step loss against its
precision's default variant at the same batch: within 1e-5 relative in
f32 (the same math summed in another order), 2e-3 in bf16 (autocast
rounds each formulation's products and sums apart; measured 1.6e-4).
"""

import contextlib
import importlib.util
import io
import json
import os
import sys

import pytest

from mfas_tpu_torch.tools import bf16_sweep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(img=32, arch=dict(resnet3d_layers=(1, 1, 1, 1),
                              resnet3d_base_width=8, vid_len=(2, 32)),
            iters=1)
# the tiny run's batches: the variants' 16, 32 and 64 over 16
TINY_BATCH = 16
OPTION_OF = {"chlast": "conv_channels_last", "3das2d": "conv3d_as_2d",
             "seppool": "pool_separable"}


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_bf16_sweep", os.path.join(ROOT, "tools", "bf16_sweep.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: this tiny net's ops are far too small to split,
    and under a parallel test runner every split op waits on threads the
    other workers' processes hold."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_variants():
    """{name: (B, img, compute dtype, channels_last, conv3d_as_2d,
    pool_separable)} as the JAX tool's main builds them, and its JSON."""
    mod = _jax_tool()
    built = []
    mod._enable_cache = lambda: None
    mod.build_step = lambda *a: a
    mod._timeit = lambda a: built.append(a) or 1.0
    argv = sys.argv
    sys.argv = ["bf16_sweep.py"]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            mod.main()
    finally:
        sys.argv = argv
    printed = json.loads(buf.getvalue().splitlines()[-1])
    return dict(zip(printed, built)), printed


@pytest.fixture(scope="module")
def sweep():
    variants = bf16_sweep.VARIANTS
    bf16_sweep.VARIANTS = tuple((name, B // TINY_BATCH, *rest)
                                for name, B, *rest in variants)
    try:
        return bf16_sweep.main([], device="cpu", **TINY)
    finally:
        bf16_sweep.VARIANTS = variants


def test_variants_are_the_jax_tools(jax_variants):
    want, _ = jax_variants
    assert [v[0] for v in bf16_sweep.VARIANTS] == list(want)
    for name, B, bf16, cl, as2d, psep in bf16_sweep.VARIANTS:
        jB, img, dt, jcl, jas2d, jpsep = want[name]
        assert (B, bf16, cl, as2d, psep) == (jB, dt == "bfloat16", jcl,
                                             jas2d, jpsep), name
        assert img == bf16_sweep.IMG == 256


def test_sweep_runs_every_variant_with_the_jax_json(sweep, jax_variants,
                                                    capsys):
    _, jax_json = jax_variants
    assert set(sweep) == set(jax_json)
    for name, r in sweep.items():
        assert set(r) >= set(jax_json[name]) == {"step_s", "clips_per_s"}
        assert r["step_s"] > 0 and r["clips_per_s"] > 0
        assert r["peak_bytes"] is None      # no card


@pytest.mark.parametrize("name", [v[0] for v in bf16_sweep.VARIANTS])
def test_variant_takes_its_options_and_keeps_the_loss(sweep, name):
    r = sweep[name]
    named = {OPTION_OF[t] for t in name.split("_")[2:] if t in OPTION_OF}
    for option in OPTION_OF.values():
        assert (r["option_calls"].get(option, 0) > 0) == (option in named), \
            (option, r["option_calls"])
    base = f"{name.split('_')[0]}_{name.split('_')[1]}"
    if base in sweep and base != name:
        tol = 2e-3 if r["bf16"] else 1e-5
        want = sweep[base]["first_loss"]
        assert abs(r["first_loss"] - want) <= tol * abs(want), (
            name, r["first_loss"], want)


def test_named_variants_only_and_unknown_names(capsys, monkeypatch):
    """Only the named variants run; TF32 is off while they run and as it
    was after."""
    import torch

    seen = []
    run = bf16_sweep.run_variant
    monkeypatch.setattr(bf16_sweep, "run_variant", lambda *a, **k: (
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)), run(*a, **k))[1])
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    out = bf16_sweep.main(["f32_B16"], device="cpu", **TINY)
    assert seen == [(False, False)] and torch.backends.cudnn.allow_tf32
    assert list(out) == ["f32_B16"]
    printed = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert list(printed) == ["f32_B16"]
    with pytest.raises(SystemExit, match="unknown variants"):
        bf16_sweep.main(["f32_B8"], device="cpu", **TINY)
