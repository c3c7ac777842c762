"""--conv_channels_last in the port's found-NTU CLI
(mfas_tpu_torch/main_found_ntu.py), on the CPU, against the run without it
and against the JAX CLI with the same flag.

A small found-conf-4 net (one block per ResNet stage at base width 8, HCN
over 32 frames, hidden 16, 3 classes, --drpt 0) on a synthetic packed
store; the port gets the JAX net's initial weights. Tolerances:
  * --test_cp: the same Model Acc as the run without the flag and as JAX's
    run with it; the fused logits within 1e-5 of their max of the run
    without it (NHWC convolutions sum in another order);
  * training, 1 + 2 epochs: the same printed accuracies and Model Acc as
    both, the printed epoch losses within rtol 1e-5 of the run without the
    flag and 1e-3 of JAX's (as tests/test_torch_found_ntu_train.py);
  * --save_checkpoint and --train_state write contiguous tensors: under
    --test_cp the checkpoint equals the one written without the flag bit
    for bit and loads into JAX's tree; a resumed train state hands Adam
    moments in the parameters' memory format.
The flag holds the option for the call only: it is off again after main,
also when main raises.
"""

import sys

import numpy as np
import pytest
import torch

import main_found_ntu as jmain
from mfas_tpu.core import flatten_tree
from mfas_tpu.core import functional as JF
from mfas_tpu.fusion.ntu import Searchable_Skeleton_Image_Net
from mfas_tpu.runtime import checkpoint as jckpt
from mfas_tpu_torch import main_found_ntu as tmain
from mfas_tpu_torch.core import functional as TF
from mfas_tpu_torch.core.layers import to_channels_last
from mfas_tpu_torch.core.optim import make_adam
from mfas_tpu_torch.core.sched import LRCosineAnnealingScheduler
from mfas_tpu_torch.data import ntu_pack as tpack
from mfas_tpu_torch.engine.classifier import valid_rows
from mfas_tpu_torch.runtime.checkpoint import state_dict_from_numpy
from mfas_tpu_torch.runtime.train_state import (load_train_state,
                                                save_train_state)

SPLITS = {"train": 5, "dev": 3, "test": 5}     # batches of 2: 3, 2, 3
FLAG = "--conv_channels_last"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: this tiny net's ops are far too small to split,
    and under a parallel test runner every split op waits on threads the
    other workers' processes hold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    root = tmp_path_factory.mktemp("channels_last")
    packed = root / "packed"
    for seed, (split, n) in enumerate(SPLITS.items()):
        tpack.make_synthetic_packed_ntu(str(packed / split), n=n, frames=6,
                                        h=32, w=32, skel_frames=40,
                                        num_classes=3, seed=seed)
    argv = ["--checkpointdir", str(root), "--packed_datadir", str(packed),
            "--conf", "4", "--num_outputs", "3", "--batchsize", "2",
            "--inner_representation_size", "16", "--vid_len", "4", "32",
            "--resnet3d_layers", "1", "1", "1", "1",
            "--resnet3d_base_width", "8", "--j", "2", "--random_backbones",
            "--drpt", "0", "--hbm_resident"]
    args = tmain.parse_args(argv)
    jmodel = Searchable_Skeleton_Image_Net(args, jmain.FOUND_CONFS[4])
    flat = {k: np.asarray(v) for k, v in flatten_tree(jmodel.init(0)).items()}
    jckpt.save(flat, str(root / "net.checkpoint"))
    return dict(root=root, argv=argv, flat=flat)


@pytest.fixture
def jax_weights(fx, monkeypatch):
    """The port's CLI builds the JAX net's initial weights; JAX's
    process-wide channels-last flag is put back after the test."""
    build = tmain.build_model

    def built(args, conf, device):
        model = build(args, conf, device)
        model.load_state_dict(state_dict_from_numpy(fx["flat"]), strict=True)
        return model

    monkeypatch.setattr(tmain, "build_model", built)
    monkeypatch.setattr(JF, "CONV_CHANNELS_LAST", JF.CONV_CHANNELS_LAST)


def _jax_cli(argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["main_found_ntu.py", *argv])
    jmain.main()
    return capsys.readouterr().out


def _lines(out):
    """[(phase, loss, acc)] of the printed epoch lines, and Model Acc."""
    epochs, acc = [], None
    for ln in out.splitlines():
        parts = ln.split()
        if len(parts) == 5 and parts[1:4:2] == ["Loss:", "Acc:"]:
            epochs.append((parts[0], float(parts[2]), float(parts[4])))
        if ln.startswith("Model Acc: "):
            acc = float(ln[len("Model Acc: "):])
    return epochs, acc


def test_test_cp_matches_plain_and_jax(fx, jax_weights, monkeypatch, capsys,
                                       tmp_path):
    argv = fx["argv"] + ["--test_cp", "net.checkpoint"]
    before = TF.OPTION_CALLS["conv_channels_last"]
    run = tmain.main(argv + [FLAG, "--save_checkpoint", "--checkpointdir",
                             str(fx["root"])], device="cpu")
    assert TF.OPTION_CALLS["conv_channels_last"] > before
    assert not TF.CONV_CHANNELS_LAST
    capsys.readouterr()
    plain = tmain.main(argv, device="cpu")
    capsys.readouterr()
    _, jacc = _lines(_jax_cli(argv + [FLAG], monkeypatch, capsys))
    assert run.acc == plain.acc == jacc
    got, ref = valid_rows(run.eval), valid_rows(plain.eval)
    assert got.shape == (5, 3)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()

    # the checkpoint written under the flag: contiguous, the loaded
    # weights bit for bit, and JAX's reader takes it into its tree
    mine = torch.load(run.saved, weights_only=True)
    assert set(mine) == set(fx["flat"])
    for k, v in mine.items():
        assert v.is_contiguous(), k
        np.testing.assert_array_equal(v.numpy(), fx["flat"][k], err_msg=k)
    flat = jckpt.load_state_dict(run.saved)
    jckpt.tree_from_state_dict(flat, Searchable_Skeleton_Image_Net(
        tmain.parse_args(argv), jmain.FOUND_CONFS[4]).init(0))


def test_training_matches_plain_and_jax(fx, jax_weights, monkeypatch,
                                        capsys):
    argv = fx["argv"] + ["--epochs", "2"]
    run = tmain.main(argv + [FLAG], device="cpu")
    t_epochs, t_acc = _lines(capsys.readouterr().out)
    plain = tmain.main(argv, device="cpu")
    p_epochs, p_acc = _lines(capsys.readouterr().out)
    j_epochs, j_acc = _lines(_jax_cli(argv + [FLAG], monkeypatch, capsys))
    assert len(t_epochs) == len(p_epochs) == len(j_epochs) == 6
    for other, rtol in ((p_epochs, 1e-5), (j_epochs, 1e-3)):
        assert [e[0] for e in t_epochs] == [e[0] for e in other]
        assert [e[2] for e in t_epochs] == [e[2] for e in other]
        np.testing.assert_allclose([e[1] for e in t_epochs],
                                   [e[1] for e in other], rtol=rtol)
    assert run.acc == t_acc == p_acc == j_acc == plain.acc


def test_flag_is_put_back_when_main_raises(fx):
    with pytest.raises(FileNotFoundError):
        tmain.main(fx["argv"] + [FLAG, "--test_cp", "missing.checkpoint"],
                   device="cpu")
    assert not TF.CONV_CHANNELS_LAST


def test_train_state_is_contiguous_and_resumes_channels_last(fx, tmp_path):
    """A channels-last model's train state holds contiguous tensors equal
    to the model's; resumed into a channels-last model, every 4-D and 5-D
    Adam moment takes its parameter's memory format."""
    args = tmain.parse_args(fx["argv"])

    def channels_last_model():
        model = tmain.build_model(args, tmain.FOUND_CONFS[4], "cpu")
        to_channels_last(model)
        return model

    model = channels_last_model()
    w = model.rgbnet.cnn.layer1[0].conv2.weight
    assert w.is_contiguous(memory_format=torch.channels_last_3d)
    assert not w.is_contiguous()
    opt = make_adam(model.parameters(), 0.0)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    sched = LRCosineAnnealingScheduler(1e-3, 1e-6, 5, 2, 3)
    path = str(tmp_path / "state.pt")
    save_train_state(path, model=model, best_state=model.state_dict(),
                     optimizer=opt, scheduler=sched, epoch=0, best_acc=0.5)
    flat = torch.load(path, weights_only=True)
    for k, v in model.state_dict().items():
        assert flat[f"model/{k}"].is_contiguous(), k
        assert torch.equal(flat[f"model/{k}"], v), k

    fresh = channels_last_model()
    opt2 = make_adam(fresh.parameters(), 0.0)
    load_train_state(path, model=fresh, optimizer=opt2, scheduler=sched)
    formats = {4: torch.channels_last, 5: torch.channels_last_3d}
    n = 0
    for p in fresh.parameters():
        if p.dim() in formats:
            for key in ("exp_avg", "exp_avg_sq"):
                assert opt2.state[p][key].is_contiguous(
                    memory_format=formats[p.dim()])
                n += 1
    assert n > 0
