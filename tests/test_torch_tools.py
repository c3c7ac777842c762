"""The port's operator tools (mfas_tpu_torch/tools/{convert_torchvision,
search_report,parity_kit,profile_step}.py) against the JAX package's
tools/ on the CPU:

* convert_torchvision: on one fabricated torchvision-layout file each, the
  port's CLI and the JAX tool write the same keys and bit-equal tensors
  (resnet50_inflate in center and mean mode, vgg19_trunk); each package's
  reader loads the other's output; the port's output loads strictly into
  ``inflated_resnet50`` and, for VGG-19, into the MM-IMDB trunk, equal to
  what ``main_found_mmimdb --vgg_cp`` loads from the source file;
* search_report: over the --search_state and --jsonl_log of a tiny port
  AV-MNIST search (tests/test_search_report.py's flags) and over a state
  the JAX searcher wrote, the port's report prints the JAX report's lines,
  and its listing is the one the search CLI printed;
* parity_kit: --synthetic is READY (rc 0) with the port's commands; missing
  checkpoints give rc 1 with [FAIL] and [missing], no paths rc 2, as the
  JAX kit; checkpoints written by the JAX codec from JAX's tree pass the
  port's shape check, and a tensor of the wrong shape fails it by name;
* profile_step runs on the CPU at B=2, 32 px and stops without CUDA from
  the command line; ``runtime/profiler.py::profile_summary`` reads a fixed
  chrome trace exactly.
"""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import types
import zipfile

import numpy as np
import pytest
import torch

from mfas_tpu.fusion.ntu import Searchable_Skeleton_Image_Net as JNet
from mfas_tpu.runtime import checkpoint as jckpt
from mfas_tpu.search import searcher as jsearcher
from mfas_tpu.search.surrogate import SurrogateDataloader as JData
from mfas_tpu_torch import main_found_mmimdb as mmain
from mfas_tpu_torch import main_searchable_avmnist as smain
from mfas_tpu_torch.data.avmnist import make_synthetic_avmnist
from mfas_tpu_torch.main_found_ntu import FOUND_CONFS
from mfas_tpu_torch.models.resnet3d import inflated_resnet50
from mfas_tpu_torch.models.vgg import vgg19_features
from mfas_tpu_torch.runtime import checkpoint as tckpt
from mfas_tpu_torch.runtime.profiler import profile_summary
from mfas_tpu_torch.tools import (convert_torchvision, parity_kit,
                                  profile_step, search_report)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_tool(name):
    """The JAX package's tools/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def printed(fn, *a, **k):
    """(fn's result, what it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        r = fn(*a, **k)
    return r, buf.getvalue()


def same(port, jax_flat):
    """A port state dict and a JAX-codec one: the same keys, dtypes and
    bits."""
    assert set(port) == set(jax_flat)
    for k, v in port.items():
        want = np.asarray(jax_flat[k])
        assert v.numpy().dtype == want.dtype, k
        np.testing.assert_array_equal(v.numpy(), want)


# ----------------------------------------------------------- convert_torchvision
@pytest.fixture(scope="module")
def resnet50_2d(tmp_path_factory):
    """A torchvision-layout ResNet-50 file (torch.save, zip): the inflated
    template's keys with the 3D convs' time axis dropped, int64
    ``num_batches_tracked`` and ``fc.*``."""
    g = torch.Generator().manual_seed(0)
    flat = {}
    for k, v in inflated_resnet50(
            device="cpu", generator=torch.Generator().manual_seed(1)
    ).state_dict().items():
        if v.dim() == 5:
            flat[k] = torch.randn(v.shape[0], v.shape[1], *v.shape[3:],
                                  generator=g)
        elif k.endswith("num_batches_tracked"):
            flat[k] = torch.tensor(5, dtype=torch.int64)
        else:
            flat[k] = torch.randn(v.shape, generator=g)
    flat["fc.weight"] = torch.randn(1000, 2048, generator=g)
    flat["fc.bias"] = torch.randn(1000, generator=g)
    path = tmp_path_factory.mktemp("resnet50") / "resnet50-2d.pth"
    torch.save(flat, str(path))
    return str(path), flat


@pytest.mark.parametrize("mode", ["center", "mean"])
def test_resnet50_inflate_matches_jax_tool(resnet50_2d, tmp_path, mode):
    src, flat = resnet50_2d
    jdst, tdst = str(tmp_path / "jax.ckpt"), str(tmp_path / "port.ckpt")
    _, jout = printed(jax_tool("convert_torchvision").resnet50_inflate,
                      src, jdst, mode)
    _, tout = printed(convert_torchvision.main,
                      ["resnet50_inflate", "--src", src, "--dst", tdst,
                       "--inflation", mode])
    assert jout == f"wrote 318 tensors to {jdst}\n"
    assert tout == f"wrote 318 tensors to {tdst}\n"
    got = tckpt.load_state_dict(tdst)
    same(got, jckpt.load_state_dict(jdst))
    # each package's reader loads the other's output
    same(tckpt.load_state_dict(jdst), jckpt.load_state_dict(tdst))

    net = inflated_resnet50(device="cpu",
                            generator=torch.Generator().manual_seed(2))
    net.load_state_dict(got, strict=True)
    w2d, w = flat["layer2.1.conv2.weight"], got["layer2.1.conv2.weight"]
    assert w.shape == (128, 128, 3, 3, 3)
    if mode == "center":
        assert torch.equal(w[:, :, 1], w2d)
        assert not w[:, :, 0].any() and not w[:, :, 2].any()
    else:
        for t in range(3):
            assert torch.equal(w[:, :, t], w2d / 3)
    assert torch.equal(got["conv1.weight"], flat["conv1.weight"])
    assert got["bn1.num_batches_tracked"].item() == 5


def test_vgg19_trunk_matches_jax_tool_and_loads_into_mmimdb(tmp_path):
    trunk = vgg19_features(device="cpu",
                           generator=torch.Generator().manual_seed(0))
    flat = {f"features.{k}": v for k, v in trunk.state_dict().items()}
    flat["classifier.6.weight"] = torch.randn(1000, 4096)
    flat["classifier.6.bias"] = torch.randn(1000)
    src = str(tmp_path / "vgg19.pth")
    torch.save(flat, src)
    jdst, tdst = str(tmp_path / "jax.ckpt"), str(tmp_path / "port.ckpt")
    _, jout = printed(jax_tool("convert_torchvision").vgg19_trunk, src, jdst)
    _, tout = printed(convert_torchvision.main,
                      ["vgg19_trunk", "--src", src, "--dst", tdst])
    assert jout == f"wrote 32 tensors to {jdst}\n"
    assert tout == f"wrote 32 tensors to {tdst}\n"
    got = tckpt.load_state_dict(tdst)
    same(got, jckpt.load_state_dict(jdst))
    same(tckpt.load_state_dict(jdst), jckpt.load_state_dict(tdst))
    assert set(got) == {"vgg." + k[len("features."):] for k in flat
                        if k.startswith("features.")}

    # strict into the MM-IMDB trunk, equal to what --vgg_cp's loader puts
    # there from the torchvision file
    args = mmain.parse_args(["--text_first_hidden", "256"])
    a, b = (mmain.build_model(args, "cpu") for _ in range(2))
    a.image_net.vgg.load_state_dict(
        {k[len("vgg."):]: v for k, v in got.items()}, strict=True)
    mmain.load_vgg_trunk(b, src)
    want = b.image_net.vgg.state_dict()
    for k, v in a.image_net.vgg.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_vgg19_trunk_without_features_stops_as_jax(tmp_path):
    src = str(tmp_path / "not_vgg.pth")
    torch.save({"conv1.weight": torch.zeros(2, 3, 3, 3)}, src)
    for fn in (jax_tool("convert_torchvision").vgg19_trunk,
               convert_torchvision.vgg19_trunk):
        with pytest.raises(SystemExit, match="no features.. keys found"):
            fn(src, str(tmp_path / "out.ckpt"))
    # the module entry point exits non-zero, naming the problem
    run = subprocess.run(
        [sys.executable, "-m", "mfas_tpu_torch.tools.convert_torchvision",
         "vgg19_trunk", "--src", src, "--dst", str(tmp_path / "x.ckpt")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert run.returncode == 1
    assert "no features.* keys found" in run.stderr
    assert not (tmp_path / "x.ckpt").exists()


# ----------------------------------------------------------- search_report
def _listing(text):
    return text.split("Now listing best architectures\n")[1].splitlines()


@pytest.fixture(scope="module")
def port_search(tmp_path_factory):
    """A tiny port AV-MNIST search with --search_state and --jsonl_log."""
    d = tmp_path_factory.mktemp("search")
    make_synthetic_avmnist(str(d / "data"), n_train=48, n_test=16)
    state, jsonl = str(d / "search.pkl"), str(d / "search.jsonl")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run, out = printed(smain.main, [
            "--datadir", str(d / "data"), "--checkpointdir", str(d),
            "--channels", "4", "--batchsize", "16", "--epochs", "1",
            "--inner_representation_size", "8", "--max_fusions", "2",
            "--search_iterations", "1", "--num_samples", "2",
            "--epochs_surrogate", "2", "--random_backbones", "--seed", "0",
            "--search_state", state, "--jsonl_log", jsonl], device="cpu")
    finally:
        torch.set_num_threads(n)
    return state, jsonl, out


def test_search_report_matches_jax_over_a_port_search(port_search):
    state, jsonl, cli_out = port_search
    argv = ["--search_state", state, "--jsonl", jsonl]
    _, got = printed(search_report.main, argv)
    _, want = printed(jax_tool("search_report").main, argv)
    assert got == want
    assert f"search state: {state}\n" in got
    assert "unique (conf, acc) entries" in got
    assert "  epnas_step: 2\n" in got
    # the default --top 5 lists what the search CLI printed
    assert _listing(got.split("telemetry:")[0]) == _listing(cli_out)
    assert len(_listing(cli_out)) == 5

    _, top3 = printed(search_report.main, ["--search_state", state,
                                           "--top", "3"])
    _, jtop3 = printed(jax_tool("search_report").main,
                       ["--search_state", state, "--top", "3"])
    assert top3 == jtop3 and len(_listing(top3)) == 3


def test_search_report_reads_a_jax_written_state(tmp_path):
    jsonl, path = str(tmp_path / "j.jsonl"), str(tmp_path / "j.pkl")
    data = JData()
    rs = np.random.RandomState(0)
    for i in range(6):
        data.add_datum(rs.randint(0, 4, (1 + i % 2, 3)), float(rs.rand()))
    s = jsearcher.ModelSearcher(types.SimpleNamespace(), jsonl_log=jsonl)
    s._log_event(kind="epnas_step", si=0, progression=1, temperature=0.25,
                 n_scored=6, surrogate_size=len(data))
    s._save_state(path, data, 0.25, 0, 1,
                  [np.array([[1, 2, 0]]), np.array([[3, 0, 1]])], None,
                  shared_weights={"fusion.0.weight": np.zeros((2, 2))})
    argv = ["--search_state", path, "--jsonl", jsonl, "--top", "4"]
    _, got = printed(search_report.main, argv)
    _, want = printed(jax_tool("search_report").main, argv)
    assert got == want
    assert "  last sampled K: 2 confs\n" in got
    assert "  weight-sharing store: 1 keys\n" in got
    assert len(_listing(got.split("telemetry:")[0])) == 4


def test_search_report_needs_a_file():
    with pytest.raises(SystemExit) as e:
        printed(search_report.main, [])
    assert e.value.code == 2


# ----------------------------------------------------------- parity_kit
TINY = ["--resnet3d_layers", "1", "1", "1", "1", "--resnet3d_base_width",
        "16", "--num_outputs", "3", "--inner_representation_size", "8",
        "--no_batchnorm", "--vid_len", "2", "32"]


def test_parity_kit_synthetic_ready(tmp_path):
    rc, out = printed(parity_kit.main, ["--synthetic", str(tmp_path)])
    assert rc == 0, out
    assert "[READY] all preconditions pass" in out
    assert "[ok] all released checkpoints load and shape-match" in out
    assert ("python -m mfas_tpu_torch.main_found_ntu --datadir "
            f"{tmp_path} --checkpointdir {tmp_path / 'checkpoints'} "
            "--test_cp best_3_1_1_1_3_0_1_1_1_3_3_0_0.9134.checkpoint "
            "--conf 4 --inner_representation_size 8") in out
    assert "python -m mfas_tpu_torch.tools.pack_ntu --datadir" in out
    assert "--hbm_resident --bf16" in out
    assert "python -m mfas_tpu_torch.main_searchable_ntu" in out
    assert "--cache_features" in out
    assert "main_found_ntu.py" not in out
    # the skeleton checkpoint is in the legacy stream, the others zip
    cdir = tmp_path / "checkpoints"
    assert not zipfile.is_zipfile(cdir / parity_kit.SKE_CP)
    assert zipfile.is_zipfile(cdir / parity_kit.RGB_CP)


def test_parity_kit_not_ready_like_jax(tmp_path):
    (tmp_path / "nturgbd_rgb").mkdir()
    argv = ["--datadir", str(tmp_path), "--checkpointdir", str(tmp_path),
            *TINY]
    rc, out = printed(parity_kit.main, argv)
    jrc, jout = printed(jax_tool("parity_kit").main, argv)
    assert rc == jrc == 1, out
    for mark in ("[FAIL]", "[missing]", "[NOT READY]"):
        assert mark in out and mark in jout
    assert printed(parity_kit.main, [])[0] == \
        printed(jax_tool("parity_kit").main, [])[0] == 2


def _jax_checkpoints(cdir, args):
    tree = JNet(parity_kit._model_args(args), FOUND_CONFS[args.conf]).init(0)
    for name, sub in ((parity_kit.BEST_CP, tree),
                      (parity_kit.RGB_CP, tree["rgbnet"]),
                      (parity_kit.SKE_CP, tree["skenet"])):
        jckpt.save(jckpt.state_dict_from_tree(sub), str(cdir / name))


def test_parity_kit_takes_jax_written_checkpoints(tmp_path):
    parity_kit.write_ntu_fixture(str(tmp_path))
    cdir = tmp_path / "checkpoints"
    cdir.mkdir()
    args = parity_kit._parse(TINY)
    _jax_checkpoints(cdir, args)
    argv = ["--datadir", str(tmp_path), "--checkpointdir", str(cdir), *TINY]
    rc, out = printed(parity_kit.main, argv)
    jrc, _ = printed(jax_tool("parity_kit").main, argv)
    assert rc == jrc == 0, out
    assert out.count("all shapes match the model") == 3

    # a tensor of the wrong shape fails the check, by name
    path = str(cdir / parity_kit.BEST_CP)
    flat = jckpt.load_state_dict(path)
    flat["central_classifier.weight"] = np.zeros((4, 8), np.float32)
    jckpt.save(flat, path)
    lines = []
    assert not parity_kit.check_checkpoints(str(cdir), args, out=lines.append)
    bad = [ln for ln in lines if ln.startswith("[FAIL] full net")]
    assert len(bad) == 1
    assert "('central_classifier.weight', (4, 8), (3, 8))" in bad[0]
    rc, _ = printed(parity_kit.main, argv)
    jrc, _ = printed(jax_tool("parity_kit").main, argv)
    assert rc == jrc == 1


# ----------------------------------------------------------- profile_step
@pytest.mark.parametrize("what,extra", [("found_train", []),
                                        ("visual_fwd", []),
                                        ("visual_fwd", ["--bf16"])],
                         ids=["found_train", "visual_fwd",
                              "visual_fwd_bf16"])
def test_profile_step_runs_on_cpu(what, extra):
    r, out = printed(profile_step.main, ["--what", what, "--batch", "2",
                                         "--img", "32", *extra],
                     device="cpu")
    assert "ms/iter" in out and "0 kernels/iter" in out
    assert r["wall_ms"] > 0 and r["kernels_per_iter"] == 0
    assert r["busy_ms"] == 0.0 and r["top_ms"] == []
    ops = r["by_op_ms"]
    assert all(n.startswith("aten::") for n, _, _ in ops)
    assert 0 < len(ops) <= profile_step.TOP_OPS
    assert [ms for _, ms, _ in ops] == sorted((ms for _, ms, _ in ops),
                                              reverse=True)
    assert all(0 < s <= 1 for _, _, s in ops)
    assert r["bf16"] == bool(extra) and r["device"] == "cpu"


def test_profile_step_needs_cuda_from_the_command_line():
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        profile_step.main(["--what", "visual_fwd"])


LONG = "void cutlass::Kernel2<cutlass_80_wmma_tensorop_s161616gemm_" + "x" * 80


def test_profile_summary_reads_a_fixed_trace(tmp_path):
    def k(name, ts, dur):
        return {"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                "dur": dur, "pid": 0, "tid": 7}

    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv3d", "ts": 0,
         "dur": 1000, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 90, "dur": 5, "pid": 1, "tid": 1},
        {"ph": "M", "name": "process_name", "pid": 0, "args": {}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 50,
         "dur": 500, "pid": 0, "tid": 8},
        k("sm90_xmma_fprop_implicit_gemm_f32", 100, 50),   # [100, 150]
        k("void at::native::vectorized_elementwise_kernel", 120, 10),
        k("cudnn_wgrad_kernel", 160, 40),                  # [160, 200]
        k("void at::native::reduce_kernel<512>", 190, 30),  # [190, 220]
        k("multi_tensor_apply_kernel", 300, 20),           # [300, 320]
        k("my_custom_kernel", 305, 5),
        k("u8_norm_frames", 400, 10),                      # [400, 410]
        k("sm90_xmma_fprop_implicit_gemm_f32", 410, 30),   # [410, 440]
        k(LONG, 500, 6),                                   # [500, 506]
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    p = profile_summary(str(path), steps=2)
    per = 2000.0
    assert p["kernels_per_step"] == 4.5
    assert p["device_busy_ms"] == 176 / per
    assert p["span_ms"] == 406 / per
    assert p["busy_share"] == 176 / 406
    assert list(p["by_class_ms"].items()) == [
        ("conv_fwd", 80 / per), ("conv_wgrad", 40 / per),
        ("reduce", 30 / per), ("adam", 20 / per), ("elementwise", 10 / per),
        ("input_K1_K2", 10 / per), ("matmul", 6 / per), ("other", 5 / per)]
    assert p["top_ms"] == [
        ["sm90_xmma_fprop_implicit_gemm_f32", 80 / per],
        ["cudnn_wgrad_kernel", 40 / per],
        ["void at::native::reduce_kernel<512>", 30 / per],
        ["multi_tensor_apply_kernel", 20 / per],
        ["void at::native::vectorized_elementwise_kernel", 10 / per],
        ["u8_norm_frames", 10 / per],
        [LONG[:70], 6 / per],
        ["my_custom_kernel", 5 / per]]

    path.write_text(json.dumps({"traceEvents": events[:4]}))
    assert profile_summary(str(path)) == {"kernels": 0}
