"""Found AV-MNIST training, JAX CLI against the port's, on the CPU.

Found conf 0 at --channels 4, hidden 16, --batchsize 8, --drpt 0 (the two
packages' dropout streams differ) on a synthetic store of 48 train samples
(42 train and 6 dev rows) and 8 test samples; the port's net gets the JAX
net's initial weights (``state_dict_from_numpy``):

* both CLIs, phase 1 and 2 epochs of phase 2: the same printed accuracies,
  the printed epoch losses within rtol 1e-3 (f32 convolutions summed in
  another order, then three Adam epochs at lr 1e-3), the same Model Acc;
* --save_checkpoint writes the JAX CLI's file name, which the JAX package's
  ``load_state_dict`` reads into its own net (strict keys, equal values);
  --test_cp of that file prints the same Model Acc in both CLIs without
  training; --profile_dir writes its trace;
* the CLI stops without CUDA, on an unknown --conf and on the flags it does
  not carry; its parser is the JAX CLI's.
"""

import os
import sys

import numpy as np
import pytest
import torch

import main_found_avmnist as jmain
from mfas_tpu.core import flatten_tree
from mfas_tpu.data.avmnist import make_synthetic_avmnist
from mfas_tpu.fusion.avmnist import Searchable_Audio_Image_Net
from mfas_tpu.runtime import checkpoint as jckpt
from mfas_tpu_torch import main_found_avmnist as tmain
from mfas_tpu_torch.runtime.checkpoint import state_dict_from_numpy
from tests.test_torch_found_ntu_train import _epoch_lines

ARGV = ["--conf", "0", "--channels", "4", "--batchsize", "8",
        "--inner_representation_size", "16", "--drpt", "0"]
CONF0_NAME = "final_avmnist_conf_[[4_2_1]_[4_2_0]]_"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: under a parallel test runner every split op
    waits on threads the other workers' processes hold."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    root = tmp_path_factory.mktemp("found_avmnist")
    make_synthetic_avmnist(str(root / "data"), n_train=48, n_test=8)
    argv = ["--datadir", str(root / "data"), "--checkpointdir", str(root),
            *ARGV]
    args = tmain.parse_args(argv)
    jmodel = Searchable_Audio_Image_Net(args, jmain.FOUND_CONFS[0])
    flat = {k: np.asarray(v) for k, v in flatten_tree(jmodel.init(0)).items()}
    return dict(root=root, argv=argv, args=args, flat=flat)


_BUILD = tmain.build_model     # before any test patches it


def _jax_weights(monkeypatch, flat):
    def build(args, conf, device):
        model = _BUILD(args, conf, device)
        model.load_state_dict(state_dict_from_numpy(flat), strict=True)
        return model

    monkeypatch.setattr(tmain, "build_model", build)


def _jax_cli(monkeypatch, capsys, argv):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["main_found_avmnist.py", *argv])
        jmain.main()
    return capsys.readouterr().out


def test_training_cli_matches_jax(fx, monkeypatch, capsys, tmp_path):
    argv = fx["argv"] + ["--epochs", "2"]
    j_epochs, j_named = _epoch_lines(_jax_cli(monkeypatch, capsys, argv))

    _jax_weights(monkeypatch, fx["flat"])
    run = tmain.main(argv + ["--save_checkpoint", "--profile_dir",
                             str(tmp_path / "prof")], device="cpu")
    out = capsys.readouterr().out
    t_epochs, t_named = _epoch_lines(out)
    assert len(j_epochs) == len(t_epochs) == 6      # 1 + 2 epochs x 2
    assert [e[0] for e in t_epochs] == [e[0] for e in j_epochs]
    assert [e[2] for e in t_epochs] == [e[2] for e in j_epochs]
    np.testing.assert_allclose([e[1] for e in t_epochs],
                               [e[1] for e in j_epochs], rtol=1e-3)
    for key in ("Final val accuracy: ", "Model Acc: "):
        assert t_named[key] == j_named[key]
    assert run.acc == j_named["Model Acc: "]
    assert [r.train_clips for r in run.train] == [42, 84]
    assert run.eval.clips == 8
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0

    # the checkpoint: the JAX name, read by the JAX package into its net
    assert f"Saved {run.saved}" in out
    assert os.path.basename(run.saved) == f"{CONF0_NAME}{run.acc}.checkpoint"
    flat = jckpt.load_state_dict(run.saved)
    mine = torch.load(run.saved, weights_only=True)
    assert flat.keys() == mine.keys() == fx["flat"].keys()
    for k, v in mine.items():
        np.testing.assert_array_equal(flat[k], v.numpy(), err_msg=k)
    jckpt.tree_from_state_dict(flat, Searchable_Audio_Image_Net(
        fx["args"], jmain.FOUND_CONFS[0]).init(0))        # strict keys

    # --test_cp: no training, the same Model Acc in both CLIs
    test_cp = ["--test_cp", os.path.basename(run.saved)]
    monkeypatch.undo()
    again = tmain.main(fx["argv"] + test_cp, device="cpu")
    out = capsys.readouterr().out
    assert again.train == [] and "Pretraining" not in out
    assert again.acc == run.acc
    _, j_named = _epoch_lines(_jax_cli(monkeypatch, capsys,
                                       fx["argv"] + test_cp))
    assert j_named["Model Acc: "] == run.acc


def test_backbone_checkpoints(fx, tmp_path, capsys):
    """--rgb_cp/--audio_cp load into the backbones; a missing one stops the
    run unless --random_backbones; no flag keeps the initial weights."""
    from mfas_tpu_torch.runtime import checkpoint as tckpt

    rgb = {k[len("rgbnet."):]: v for k, v in fx["flat"].items()
           if k.startswith("rgbnet.")}
    jckpt.save(rgb, str(tmp_path / "rgb.checkpoint"))
    loaded = {}

    def spy(path, module, random_ok=False):
        loaded[os.path.basename(path)] = random_ok
        return orig(path, module, random_ok)

    orig = tckpt.load_backbone
    argv = fx["argv"] + ["--checkpointdir", str(tmp_path), "--epochs", "1",
                         "--no-verbose"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tckpt, "load_backbone", spy)
        with pytest.raises(FileNotFoundError, match="--random_backbones"):
            tmain.main(argv + ["--rgb_cp", "rgb.checkpoint", "--audio_cp",
                               "none.checkpoint"], device="cpu")
        run = tmain.main(argv + ["--rgb_cp", "rgb.checkpoint", "--audio_cp",
                                 "none.checkpoint", "--random_backbones"],
                         device="cpu")
        assert loaded == {"rgb.checkpoint": True, "none.checkpoint": True}
        loaded.clear()
        tmain.main(argv, device="cpu")
        assert loaded == {}
    assert np.isfinite(run.acc) and "WARNING" in capsys.readouterr().out


# the multi-GPU flags are ported (parallel/mesh.py; two ranks in
# tests/test_torch_parallel_cli.py): on a card-less command line they stop
# for want of CUDA like any other, and a --dist_* trio that cannot form a
# group stops with a ValueError naming the missing flag
@pytest.mark.parametrize("extra, what", [
    ([], "needs a CUDA device"),
    (["--use_dataparallel"], "needs a CUDA device"),
    (["--dist_coordinator", "localhost:1234"], "dist_num_processes"),
    (["--dist_process_id", "1"], "dist_coordinator"),
])
def test_cli_guards(fx, extra, what, monkeypatch):
    if what.startswith("dist_"):
        with pytest.raises(ValueError, match=what):
            tmain.main(fx["argv"] + extra, device="cpu")
    else:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(SystemExit) as e:
            tmain.main(fx["argv"] + extra)
        assert what in str(e.value)
    with pytest.raises(SystemExit, match="--conf must be one of"):
        tmain.main(fx["argv"] + ["--conf", "3"], device="cpu")


def test_parser_matches_the_jax_cli(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["main_found_avmnist.py"])
    got = vars(tmain.parse_args([]))
    assert got == vars(jmain.parse_args())
    assert (got["epochs"], got["Ti"], got["drpt"], got["multitask"],
            got["inner_representation_size"]) == (70, 5, 0.4, True, 256)
    assert not tmain.parse_args(["--no-multitask"]).multitask
