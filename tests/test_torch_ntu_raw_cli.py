"""Both NTU command lines at their default input paths, JAX package against
the port, on the CPU (needs cv2 for the AVI fixture):

* ``main_found_ntu --test_cp`` on a JAX-written checkpoint via the raw
  --datadir and via a --packed_datadir store normalized on the host: the
  Model Acc JAX prints, and the fused logits of the test split within rtol
  1e-4 / atol 1e-5 (f32 convolutions summed in another order by XLA and
  oneDNN), with no K1 launch;
* one training run on --datadir at --drpt 0 from JAX's initial weights: the
  printed epoch accuracies equal and the losses within 1e-4 relative;
* ``main_searchable_ntu`` on --datadir, cut as tests/test_torch_search_cli.py
  cuts it, with JAX's backbones and surrogate weights: the first step's 32
  accuracies equal, the same confs sampled for the second step and the same
  top-5.
"""

import random
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import main_found_ntu as jmain
from mfas_tpu.core import Ctx, flatten_tree, unflatten_tree
from mfas_tpu.fusion.ntu import Searchable_Skeleton_Image_Net
from mfas_tpu.runtime import checkpoint as jckpt
from mfas_tpu.search.searchers import NTUSearcher as JNTUSearcher
from mfas_tpu.search.surrogate import SimpleRecurrentSurrogate as JSurrogate
from mfas_tpu_torch import main_found_ntu as tmain
from mfas_tpu_torch import main_searchable_ntu as smain
from mfas_tpu_torch.data import ntu_pack as tpack
from mfas_tpu_torch.engine.classifier import valid_rows
from mfas_tpu_torch.ops import input_kernels as tk
from mfas_tpu_torch.runtime.checkpoint import state_dict_from_numpy
from mfas_tpu_torch.search import searchers as tsearchers
from tests.test_torch_found_ntu_train import _epoch_lines
from tests.test_torch_search_ntu import _Recorder, _pairs, write_backbones

cv2 = pytest.importorskip("cv2")

from tests.test_integration_ntu_cli import build_ntu_fixture  # noqa: E402

SMALL = ["--conf", "4", "--num_outputs", "3", "--batchsize", "2",
         "--inner_representation_size", "16", "--batchnorm",
         "--vid_len", "4", "32", "--resnet3d_layers", "1", "1", "1", "1",
         "--resnet3d_base_width", "8", "--j", "2"]


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
    """subjects 1 (train), 2 (dev), 3 (test), 3 actions each: 3 clips per
    split, so the last batch of 2 is ragged; the packed store of the same
    clips; a JAX-written checkpoint of the small conf-4 net with moved
    BatchNorm statistics."""
    root = tmp_path_factory.mktemp("ntu_raw_cli")
    raw = root / "raw"
    build_ntu_fixture(raw, subjects=(1, 2, 3), n_actions=3, frames=12)
    args = tmain.parse_args(["--datadir", str(raw)] + SMALL)
    for split in ("train", "dev", "test"):
        tpack.pack_ntu(str(raw), str(root / "packed" / split), split,
                       args=args, verbose=False)
    model = Searchable_Skeleton_Image_Net(args, jmain.FOUND_CONFS[4])
    rs = np.random.RandomState(0)
    flat = {}
    for k, v in flatten_tree(model.init(0)).items():
        v = np.asarray(v)
        if k.endswith("running_mean"):
            v = (rs.randn(*v.shape) * 0.1).astype(np.float32)
        elif k.endswith("running_var"):
            v = rs.uniform(0.5, 1.5, v.shape).astype(np.float32)
        flat[k] = v
    jckpt.save(flat, str(root / "net.checkpoint"))
    tree = unflatten_tree({k: jnp.asarray(v) for k, v in flat.items()})
    return dict(root=root, raw=raw, model=model, tree=tree)


INPUTS = {"datadir": lambda fx: ["--datadir", str(fx["raw"])],
          "packed_host": lambda fx: ["--packed_datadir",
                                     str(fx["root"] / "packed")]}


def _jax_fused_logits(fx, argv, monkeypatch):
    """JAX's fused logits (valid rows) over JAX's own test loader: float
    clips normalized on the host, no batch prep."""
    monkeypatch.setattr(sys, "argv", ["main_found_ntu.py", *argv])
    args = jmain.parse_args()
    model = fx["model"]

    @jax.jit
    def fused(tree, rgb, ske):
        return model.apply(tree, Ctx(train=False), (rgb, ske))[0]

    rows = []
    for batch in jmain.get_dataloaders(args)["test"]:
        mask = np.asarray(batch["_mask"])
        out = fused(fx["tree"], jnp.asarray(batch["rgb"]),
                    jnp.asarray(batch["ske"]))
        rows.append(np.asarray(out)[mask > 0])
    return np.concatenate(rows).astype(np.float64)


@pytest.mark.parametrize("inputs", list(INPUTS))
def test_test_cp_matches_jax(fx, inputs, monkeypatch, capsys):
    argv = INPUTS[inputs](fx) + ["--checkpointdir", str(fx["root"]),
                                 "--test_cp", "net.checkpoint", *SMALL]
    monkeypatch.setattr(sys, "argv", ["main_found_ntu.py", *argv])
    jmain.main()
    _, j_named = _epoch_lines(capsys.readouterr().out)
    jax_logits = _jax_fused_logits(fx, argv, monkeypatch)

    tk.reset_launch_counts()
    run = tmain.main(argv, device="cpu")
    _, t_named = _epoch_lines(capsys.readouterr().out)
    assert run.acc == j_named["Model Acc: "] == t_named["Model Acc: "]
    assert run.eval.clips == 3
    got = valid_rows(run.eval)
    assert got.shape == (3, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, jax_logits, rtol=1e-4, atol=1e-5)
    assert tk.launch_counts == {"u8_normalize": 0, "u8_gather_normalize": 0}


def test_training_on_datadir_matches_jax(fx, monkeypatch, capsys):
    # without --batchnorm: the fusion head's BatchNorm1d over 2 clips is
    # ill-conditioned in f32 (tests/test_torch_found_ntu_train.py)
    argv = INPUTS["datadir"](fx) + [
        "--checkpointdir", str(fx["root"]),
        *[a for a in SMALL if a != "--batchnorm"], "--epochs", "1",
        "--drpt", "0", "--random_backbones"]
    monkeypatch.setattr(sys, "argv", ["main_found_ntu.py", *argv])
    jmain.main()
    j_epochs, j_named = _epoch_lines(capsys.readouterr().out)

    jmodel = Searchable_Skeleton_Image_Net(jmain.parse_args(),
                                           jmain.FOUND_CONFS[4])
    flat = {k: np.asarray(v) for k, v in
            flatten_tree(jmodel.init(0)).items()}
    build = tmain.build_model

    def jax_init(args, conf, device):
        model = build(args, conf, device)
        model.load_state_dict(state_dict_from_numpy(flat), strict=True)
        return model

    monkeypatch.setattr(tmain, "build_model", jax_init)
    run = tmain.main(argv, device="cpu")
    t_epochs, t_named = _epoch_lines(capsys.readouterr().out)
    assert len(j_epochs) == len(t_epochs) == 4     # 1 + 1 epochs x 2
    assert [e[0] for e in t_epochs] == [e[0] for e in j_epochs]
    assert [e[2] for e in t_epochs] == [e[2] for e in j_epochs]
    np.testing.assert_allclose([e[1] for e in t_epochs],
                               [e[1] for e in j_epochs], rtol=1e-4)
    assert t_named == j_named
    assert [r.train_clips for r in run.train] == [3, 3]


class _CliRecorder(_Recorder):
    """A recorder the search CLI can also read the trainer's counts
    through."""

    def __getattr__(self, name):
        return getattr(self.inner, name)


SEARCH = ["--num_outputs", "4", "--batchsize", "4", "--vid_len", "4", "32",
          "--resnet3d_layers", "1", "1", "1", "1", "--resnet3d_base_width",
          "8", "--drpt", "0", "--j", "2", "--search_iterations", "1",
          "--max_fusions", "2", "--num_samples", "3", "--epochs", "1",
          "--epochs_surrogate", "3", "--no-verbose", "--seed", "0",
          "--ske_cp", "ske.checkpoint", "--rgb_cp", "rgb.checkpoint"]


def test_search_on_datadir_matches_jax(tmp_path, monkeypatch, capsys):
    # trainexp subjects 1 and 4, dev subjects 2 and 5: 8 clips each, every
    # one of the 4 classes twice in dev
    build_ntu_fixture(tmp_path, subjects=(1, 2, 4, 5), n_actions=4,
                      frames=12)
    argv = ["--datadir", str(tmp_path), "--checkpointdir", str(tmp_path),
            *SEARCH]
    args = smain.parse_args(argv)
    write_backbones(tmp_path, args)

    np.random.seed(0)
    random.seed(0)
    jsearcher = JNTUSearcher(args)
    jrec = _Recorder(jsearcher.train_fn)
    jsearcher.train_fn = jrec
    jdata = jsearcher.search()
    params = jax.tree_util.tree_map(
        np.asarray, JSurrogate(100, 3, 100, max_seq_len=2).params)

    recs = []
    init = tsearchers.NTUSearcher.__init__

    def with_jax_surrogate(self, *a, **k):
        init(self, *a, **k)
        self.surrogate.load_numpy(params)
        self.train_fn = _CliRecorder(self.train_fn)
        recs.append(self.train_fn)

    monkeypatch.setattr(tsearchers.NTUSearcher, "__init__",
                        with_jax_surrogate)
    tk.reset_launch_counts()
    random.seed(0)
    run = smain.main(argv, device="cpu")
    assert "Search complete" in capsys.readouterr().out
    calls, jcalls = recs[0].calls, jrec.calls
    assert len(calls) == len(jcalls) == 2
    assert [c.tobytes() for c in calls[0][0]] == \
        [c.tobytes() for c in jcalls[0][0]]
    assert calls[0][1] == [float(np.float32(a)) for a in jcalls[0][1]]
    assert len(set(calls[0][1])) > 1
    assert [c.tobytes() for c in calls[1][0]] == \
        [c.tobytes() for c in jcalls[1][0]]
    assert _pairs(run.data) == _pairs(jdata)
    confs, accs, _ = jdata.get_k_best(5)
    assert sorted((c.tobytes(), a) for c, a in run.top) == \
        sorted((c.tobytes(), a) for c, a in zip(confs, accs))
    assert tk.launch_counts == {"u8_normalize": 0, "u8_gather_normalize": 0}
