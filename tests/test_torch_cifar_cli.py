"""The CIFAR command lines, JAX package against the port, on the CPU
(the search's whole runs are in test_torch_cifar_search.py).

A synthetic store (``make_synthetic_cifar``, 16 images per file: 72 train,
8 dev and 16 test images) at --planes 4 --net_str 1 2 1 --batchsize 8 with
--drop_path 0 --drop_prob 0 (the two packages' dropout streams differ):

* ``main_found_cifar`` with --use_intermediate --cutout for 2 epochs, the
  port's net with the JAX net's initial weights: the same printed dev and
  test accuracies (counts of argmax hits, compared exactly), the epoch
  losses within rtol 1e-3 (f32 convolutions summed in another order, then
  18 Adam steps); --save_checkpoint writes the JAX CLI's file name, which
  the JAX package reads into its own net; --epochs 0 returns the best-dev
  start, -1.0; --profile_dir writes its trace;
* the parsers are the JAX CLIs' (the found CLI adds --profile_dir); both
  CLIs stop without CUDA and on --use_dataparallel and --dist_*.
"""

import os
import sys

import numpy as np
import pytest
import torch

import main_found_cifar as jfound
import main_searchable_cifar as jsearch
from mfas_tpu.core import flatten_tree
from mfas_tpu.data.cifar import make_synthetic_cifar
from mfas_tpu.fusion import cifar as jfc
from mfas_tpu.runtime import checkpoint as jckpt
from mfas_tpu_torch import main_found_cifar as tfound
from mfas_tpu_torch import main_searchable_cifar as tsearch
from mfas_tpu_torch.runtime.checkpoint import state_dict_from_numpy
from tests.test_torch_found_ntu_train import _epoch_lines
from tests.test_torch_search_cli import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL = ["--planes", "4", "--net_str", "1", "2", "1", "--batchsize", "8",
         "--drop_path", "0", "--drop_prob", "0"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cifar_cli")
    make_synthetic_cifar(str(root), n_per_batch=16, seed=1)
    return root


# --------------------------------------------------------------------------
# found training
# --------------------------------------------------------------------------
def test_found_cli_matches_jax(root, monkeypatch, capsys, tmp_path):
    argv = ["--data_dir", str(root), "--checkpointdir", str(tmp_path),
            *SMALL, "--epochs", "2", "--use_intermediate", "--cutout"]
    conf = tfound.parse_conf(tfound.parse_args(argv).conf)
    jnet = jfc.Searchable_MicroCNN(tfound.parse_args(argv), conf, fixed=True)
    jtree = jnet.init(0)
    flat = {k: np.asarray(v) for k, v in flatten_tree(jtree).items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["main_found_cifar.py", *argv])
        jfound.main()
    j_epochs, j_named = _epoch_lines(capsys.readouterr().out)

    build = tfound.build_model

    def jax_weights(args, configuration, device):
        model = build(args, configuration, device)
        model.load_state_dict(state_dict_from_numpy(flat), strict=True)
        return model

    monkeypatch.setattr(tfound, "build_model", jax_weights)
    run = tfound.main(argv + ["--save_checkpoint"], device="cpu")
    out = capsys.readouterr().out
    t_epochs, t_named = _epoch_lines(out)
    assert len(t_epochs) == len(j_epochs) == 4
    assert [e[0] for e in t_epochs] == ["train", "dev"] * 2
    assert [e[2] for e in t_epochs] == [e[2] for e in j_epochs]
    np.testing.assert_allclose([e[1] for e in t_epochs],
                               [e[1] for e in j_epochs], rtol=1e-3)
    assert t_named["Model Acc: "] == j_named["Model Acc: "] == run.acc
    assert [r.train_clips for r in run.train] == [144]
    assert run.eval.clips == 16 and run.train_peak_bytes == [None]

    # the JAX name, read by the JAX package into its own net
    assert os.path.basename(run.saved) == \
        f"cifar_micro_{run.acc:.4f}.checkpoint"
    assert f"Saved {run.saved}" in out
    loaded = jckpt.load_state_dict(run.saved)
    assert loaded.keys() == flat.keys()
    jckpt.tree_from_state_dict(loaded, jtree)       # strict keys
    for k, v in torch.load(run.saved, weights_only=True).items():
        np.testing.assert_array_equal(loaded[k], v.numpy(), err_msg=k)

    # --epochs 0: no dev epoch, the -1.0 start comes back; --profile_dir
    # traces the test pass
    monkeypatch.undo()
    zero = tfound.main(argv[:-4] + ["--epochs", "0", "--no-verbose",
                                    "--profile_dir", str(tmp_path / "prof")],
                       device="cpu")
    assert zero.train[0].best_acc == -1.0 and zero.train[0].epochs == []
    assert 0.0 <= zero.acc <= 1.0
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


# --------------------------------------------------------------------------
# parsers and guards
# --------------------------------------------------------------------------
@pytest.mark.parametrize("tmod, jmod, extra", [
    (tfound, jfound, {"profile_dir": ""}),
    (tsearch, jsearch, {}),
])
def test_parser_matches_the_jax_cli(tmod, jmod, extra, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["main.py"])
    got = vars(tmod.parse_args([]))
    assert got == {**vars(jmod.parse_args()), **extra}
    assert (got["planes"], got["net_str"], got["batchsize"],
            got["drop_path"], got["drop_prob"]) == \
        (36, [1, 1, 2, 1, 1, 2, 1, 1], 128, 0.1, 0.2)


# the multi-GPU flags are ported (parallel/mesh.py; CifarEngine on two
# ranks in tests/test_torch_engine_parallel.py): on a card-less command
# line they stop for want of CUDA like any other, and a --dist_* trio that
# cannot form a group stops with a ValueError naming the missing flag
@pytest.mark.parametrize("extra, what", [
    ([], "needs a CUDA device"),
    (["--use_dataparallel"], "needs a CUDA device"),
    (["--dist_coordinator", "localhost:1234"], "dist_num_processes"),
    (["--dist_num_processes", "2"], "dist_coordinator"),
])
@pytest.mark.parametrize("tmod", [tfound, tsearch], ids=["found", "search"])
def test_cli_guards(root, tmod, extra, what, monkeypatch):
    if what.startswith("dist_"):
        with pytest.raises(ValueError, match=what):
            tmod.main(["--data_dir", str(root), *extra], device="cpu")
    else:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(SystemExit) as e:
            tmod.main(["--data_dir", str(root), *extra])
        assert what in str(e.value)
