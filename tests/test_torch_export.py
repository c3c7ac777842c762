"""Serving export and batch prediction, JAX package against the port, on the
CPU: mfas_tpu_torch.runtime.export and the tools export_model and predict
against mfas_tpu/runtime/export.py and tools/{export_model,predict}.py.

Per vertical, at the widths of tests/test_export.py:130-147, one checkpoint
written by the JAX codec is exported by both tools with --polymorphic_batch:
  * the port's artifact (--check run at batch 2) against JAX's ``.call`` on
    the same random inputs at B = 1 and 5, within rtol 1e-5 / atol 1e-6
    (f32 convolutions summed in another order by XLA and oneDNN);
  * both predict tools over one store whose last batch is ragged: the same
    samples, logits within rtol 1e-5 / atol 1e-5, the same printed metric.
--bf16 (AV-MNIST): an f32 interface, within 0.05 of the f32 artifact but
not equal to it, and under 0.75 of its size. That runs at the found CLI's
widths (--channels 32, hidden 256), not tests/test_export.py:176's
--channels 4: a .pt2 also holds the graph (~330 KB of JSON for this net),
which outweighs --channels 4's weights (the bf16 artifact is then 0.89 of
the f32 one), where a StableHLO artifact is mostly its constants.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from mfas_tpu.core import flatten_tree
from mfas_tpu.runtime import checkpoint as jckpt
from mfas_tpu.runtime.export import load_exported as jload
from mfas_tpu_torch.data import avmnist as tavmnist
from mfas_tpu_torch.data import cifar as tcifar
from mfas_tpu_torch.data import ntu_pack as tpack
from mfas_tpu_torch.runtime.export import load_exported
from mfas_tpu_torch.tools import export_model as texport
from mfas_tpu_torch.tools import predict as tpredict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: under a parallel test runner every split op
    waits on threads the other workers' processes hold."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_tool(name):
    """tools/<name>.py of the JAX package as a module, its compile cache
    hook a no-op (the tests keep their own XLA cache)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _no_compile_cache_hook(monkeypatch):
    from mfas_tpu.runtime import compile_cache
    monkeypatch.setattr(compile_cache, "enable_persistent_compilation_cache",
                        lambda *a, **k: None)


# vertical -> (tool flags, per-sample input shapes, outputs); the widths of
# tests/test_export.py:130-147, MM-IMDB's posters at 32x48
CASES = {
    "ntu": (["--conf", "0", "--vid_len", "2", "32", "--vid_dim", "32",
             "--inner_representation_size", "8",
             "--resnet3d_layers", "1", "1", "1", "1",
             "--resnet3d_base_width", "8"],
            ((2, 32, 32, 3), (3, 32, 25, 2)), 60),
    "avmnist": (["--conf", "0", "--channels", "4",
                 "--inner_representation_size", "8"],
                ((1, 28, 28), (1, 112, 112)), 10),
    "mmimdb": (["--model", "simplevt", "--text_first_hidden", "8",
                "--channels", "4", "--image_size", "32", "48"],
               ((300,), (3, 32, 48)), 23),
    "cifar": (["--planes", "8", "--net_str", "1", "1", "2"],
              ((3, 32, 32),), 10),
}


def _write_jax_checkpoint(vertical, flags, path, seed=3):
    """The JAX tool's model for these flags, init(seed), BatchNorm running
    statistics moved off their init, saved by the JAX codec."""
    jtool = _jax_tool("export_model")
    args = texport.parse_args([vertical, "--out", "x", *flags])
    model = {"ntu": jtool._ntu, "avmnist": jtool._avmnist,
             "mmimdb": jtool._mmimdb, "cifar": jtool._cifar}[vertical](
                 args)[0]
    rs = np.random.RandomState(seed)
    flat = {}
    for k, v in flatten_tree(model.init(seed)).items():
        v = np.asarray(v)
        if k.endswith("running_mean"):
            v = (rs.randn(*v.shape) * 0.1).astype(np.float32)
        elif k.endswith("running_var"):
            v = rs.uniform(0.5, 1.5, v.shape).astype(np.float32)
        flat[k] = v
    jckpt.save(flat, str(path))


def _write_store(vertical, root):
    """A store of 5 test samples for predict (ragged at batch 2)."""
    if vertical == "ntu":
        tpack.make_synthetic_packed_ntu(str(root / "test"), n=5, frames=4,
                                        h=32, w=32, skel_frames=40,
                                        num_classes=60, seed=4)
    elif vertical == "avmnist":
        tavmnist.make_synthetic_avmnist(str(root), n_train=4, n_test=5)
    elif vertical == "cifar":
        tcifar.make_synthetic_cifar(str(root), n_per_batch=5)
    else:
        rs = np.random.RandomState(5)
        base = root / "test"
        base.mkdir(parents=True)
        for i in range(5):
            # stored (H, W, 3) = (48, 32, 3): the loader yields (3, 32, 48)
            np.save(base / f"image_{i:06}.npy",
                    rs.rand(48, 32, 3).astype(np.float32))
            lab = np.zeros(23, np.float32)
            lab[rs.randint(0, 23, 2)] = 1.0
            np.save(base / f"label_{i:06}.npy", lab)
            np.save(base / f"text_{i:06}.npy",
                    rs.randn(rs.randint(5, 30), 300).astype(np.float32))


def _predict_flags(vertical, root):
    if vertical == "ntu":
        return ["--packed_datadir", str(root), "--vid_len", "2", "32",
                "--num_workers", "2"]
    extra = ["--len_data", "5"] if vertical == "mmimdb" else []
    return ["--datadir", str(root), *extra]


def _metric_line(out):
    return [ln for ln in out.splitlines()
            if ln.startswith(("top-1 accuracy:", "samples-F1:"))]


@pytest.mark.parametrize("vertical", list(CASES))
def test_export_and_predict_match_jax(tmp_path, vertical, capsys):
    flags, per_sample, n_out = CASES[vertical]
    _write_jax_checkpoint(vertical, flags, tmp_path / "net.checkpoint")
    common = [vertical, *flags, "--test_cp", "net.checkpoint",
              "--checkpointdir", str(tmp_path), "--polymorphic_batch"]
    jart, tart = str(tmp_path / "m.stablehlo"), str(tmp_path / "m.pt2")
    _jax_tool("export_model").main(common + ["--out", jart])
    rec = texport.main(common + ["--out", tart, "--check"], device="cpu")
    out = capsys.readouterr().out
    assert "check OK: reloaded artifact ran on cpu, output shape " \
        f"(2, {n_out})" in out
    assert rec["bytes"] == os.path.getsize(tart) and rec["shapes"][0][0] == "b"

    jexp, texp = jload(jart), load_exported(tart, "cpu")
    rs = np.random.RandomState(0)
    for B in (1, 5):
        inputs = [rs.randn(B, *s).astype(np.float32) for s in per_sample]
        want = np.asarray(jexp.call(*inputs))
        got = texp.call(*inputs).numpy()
        assert got.shape == want.shape == (B, n_out)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(
            texp.module()(*map(torch.from_numpy, inputs)).numpy(), got)

    store = tmp_path / "store"
    _write_store(vertical, store)
    pflags = _predict_flags(vertical, store) + ["--batchsize", "2"]
    jpreds, tpreds = str(tmp_path / "j.npy"), str(tmp_path / "t.npy")
    _jax_tool("predict").main([vertical, "--artifact", jart, "--out",
                               jpreds, *pflags])
    jline = _metric_line(capsys.readouterr().out)
    res = tpredict.main([vertical, "--artifact", tart, "--out", tpreds,
                         *pflags], device="cpu")
    tline = _metric_line(capsys.readouterr().out)
    assert len(jline) == 1 and tline == jline
    want, got = np.load(jpreds), np.load(tpreds)
    assert got.shape == want.shape == (5, n_out) and res["samples"] == 5
    np.testing.assert_array_equal(res["logits"], got)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_bf16_artifact(tmp_path):
    flags = ["--conf", "0"]
    _write_jax_checkpoint("avmnist", flags, tmp_path / "net.checkpoint")
    outs = {}
    for tag, extra in (("f32", []), ("bf16", ["--bf16"])):
        outs[tag] = str(tmp_path / f"m_{tag}.pt2")
        texport.main(["avmnist", *flags, "--test_cp", "net.checkpoint",
                      "--checkpointdir", str(tmp_path), "--batch", "2",
                      "--out", outs[tag], *extra], device="cpu")
    rs = np.random.RandomState(2)
    image = rs.randn(2, 1, 28, 28).astype(np.float32)
    audio = rs.randn(2, 1, 112, 112).astype(np.float32)
    want = load_exported(outs["f32"]).call(image, audio).numpy()
    got = load_exported(outs["bf16"]).call(image, audio)
    assert got.dtype == torch.float32                 # interface stays f32
    got = got.numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05)
    assert not np.allclose(got, want, rtol=1e-7, atol=1e-7)  # really bf16
    size_f32, size_bf16 = (os.path.getsize(outs[k]) for k in ("f32", "bf16"))
    assert size_bf16 < 0.75 * size_f32, (size_bf16, size_f32)
    # the weights are stored in bf16, the BatchNorm statistics in f32
    prog = load_exported(outs["bf16"]).program
    dtypes = {k.rsplit(".", 1)[-1]: v.dtype
              for k, v in prog.state_dict.items()}
    assert dtypes["weight"] == torch.bfloat16
    assert dtypes["running_mean"] == dtypes["running_var"] == torch.float32


def test_fixed_batch_and_random_init(tmp_path, capsys):
    """Without --polymorphic_batch the artifact takes --batch; --random_init
    bakes in the found CLI's initial weights (no checkpoint); --platforms
    is parsed and does not change the artifact."""
    out = str(tmp_path / "c.pt2")
    texport.main(["cifar", "--planes", "8", "--net_str", "1", "1", "2",
                  "--random_init", "--batch", "3", "--platforms", "cuda",
                  "--out", out, "--check"], device="cpu")
    assert "check OK" in capsys.readouterr().out
    exp = load_exported(out)
    assert exp.call(torch.zeros(3, 3, 32, 32)).shape == (3, 10)
    with pytest.raises(Exception):
        exp.call(torch.zeros(2, 3, 32, 32))
    with pytest.raises(SystemExit, match="--test_cp"):
        texport.main(["cifar", "--out", out], device="cpu")


def test_tools_need_cuda_from_the_command_line(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        texport.main(["cifar", "--random_init", "--out",
                      str(tmp_path / "x.pt2")])
    with pytest.raises(SystemExit, match="CUDA"):
        tpredict.main(["cifar", "--artifact", str(tmp_path / "x.pt2")])


def test_parsers_have_the_jax_tools_flags_and_defaults():
    """The JAX tools parse inside main(); their flags are read from the
    source's add_argument calls through a recording parser."""
    import argparse

    def signature(tool_main, *argv):
        seen = []
        orig = argparse.ArgumentParser.parse_args

        def spy(self, args=None, namespace=None):
            seen.append(self)
            raise SystemExit(0)

        argparse.ArgumentParser.parse_args = spy
        try:
            with pytest.raises(SystemExit):
                tool_main(*argv)
        finally:
            argparse.ArgumentParser.parse_args = orig
        return {tuple(a.option_strings) or (a.dest,): (
            a.dest, a.default, a.nargs, a.type, a.choices)
            for a in seen[-1]._actions if a.dest != "help"}

    for name, tmod in (("export_model", texport), ("predict", tpredict)):
        jsig = signature(_jax_tool(name).main, [])
        tsig = signature(tmod.parse_args, [])
        assert tsig == jsig, name
    from mfas_tpu_torch.tools import pack_ntu as tpack_tool
    assert signature(tpack_tool.parse_args, []) == signature(
        _jax_tool("pack_ntu").main)
