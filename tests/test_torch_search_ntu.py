"""The whole NTU search, JAX package against the port, on the CPU.

Both packages' ``NTUSearcher(args).search()`` run on one synthetic packed
store (trainexp 12, dev 6 clips of 32x32), with the same numpy seed, the
same backbone checkpoints (written by the JAX package's codec) and the
surrogate's JAX initial weights carried into the port, at --drpt 0,
--search_iterations 1 --max_fusions 2 --num_samples 3 --epochs 1
--epochs_surrogate 5, f32 features streamed in train mode:

* the first step's 32 accuracies are equal;
* the confs sampled for the second step and the final top-5 are identical;
* a --search_state that the JAX package wrote after the first step resumes
  in the port and ends where the uninterrupted JAX search ended.
"""

import random
import shutil

import numpy as np
import pytest
import torch

import jax

from mfas_tpu.core import flatten_tree
from mfas_tpu.fusion import ntu as jfntu
from mfas_tpu.runtime import checkpoint as jckpt
from mfas_tpu.search import searcher as jsearcher
from mfas_tpu.search.searchers import NTUSearcher as JNTUSearcher
from mfas_tpu.search.surrogate import SimpleRecurrentSurrogate as JSurrogate
from mfas_tpu_torch import main_searchable_ntu as tmain
from mfas_tpu_torch.data import ntu_pack as tpack
from mfas_tpu_torch.search import searcher as tsearcher
from mfas_tpu_torch.search.searchers import NTUSearcher

SEARCH = ["--num_outputs", "3", "--batchsize", "4",
          "--vid_len", "4", "32", "--resnet3d_layers", "1", "1", "1", "1",
          "--resnet3d_base_width", "8", "--drpt", "0", "--j", "2",
          "--search_iterations", "1", "--max_fusions", "2",
          "--num_samples", "3", "--epochs", "1", "--epochs_surrogate", "5",
          "--device_input_normalize", "--no-verbose",
          "--ske_cp", "ske.checkpoint", "--rgb_cp", "rgb.checkpoint"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: under a parallel test runner every split op
    waits on threads the other workers' processes hold."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_store(root, splits=(("trainexp", 12), ("dev", 6))):
    for seed, (split, n) in enumerate(splits):
        tpack.make_synthetic_packed_ntu(str(root / "packed" / split), n=n,
                                        frames=6, h=32, w=32, skel_frames=40,
                                        num_classes=3, seed=seed)


def write_backbones(root, args):
    """The JAX extractor's init(0) backbones as torch-format checkpoints."""
    tree = jfntu.NTUFeatureExtractor(args).init(0)
    for name, attr in (("ske", "skenet"), ("rgb", "rgbnet")):
        flat = {k: np.asarray(v) for k, v in flatten_tree(tree[attr]).items()}
        jckpt.save(flat, str(root / f"{name}.checkpoint"))


class _Recorder:
    """A train_fn wrapper that keeps ``_seed`` on the wrapped trainer (the
    searcher saves and restores it) and records each call."""

    def __init__(self, inner):
        self.inner, self.calls = inner, []

    @property
    def _seed(self):
        return self.inner._seed

    @_seed.setter
    def _seed(self, v):
        self.inner._seed = v

    def __call__(self, confs, *a, **k):
        accs = self.inner(confs, *a, **k)
        self.calls.append(([np.asarray(c).copy() for c in confs],
                           [float(x) for x in accs]))
        return accs


def _pairs(s_data):
    out = set()
    for L, entries in s_data.state():
        for conf, acc in entries:
            out.add((np.asarray(conf).tobytes(), acc))
    return out


def _steps_saved(monkeypatch, module):
    """Copy the search state after every step to '<path>.step<n>'."""
    orig = module.ModelSearcher._save_state
    saved = []

    def save(self, path, *a, **k):
        orig(self, path, *a, **k)
        if path:
            copy = f"{path}.step{len(saved)}"
            shutil.copy(path, copy)
            saved.append(copy)

    monkeypatch.setattr(module.ModelSearcher, "_save_state", save)
    return saved


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX search, uninterrupted, with its per-step states."""
    root = tmp_path_factory.mktemp("search_ntu")
    write_store(root)
    argv = ["--packed_datadir", str(root / "packed"), "--checkpointdir",
            str(root), *SEARCH]
    args = tmain.parse_args(argv + ["--search_state",
                                    str(root / "jax_state.pkl")])
    write_backbones(root, args)
    mp = pytest.MonkeyPatch()
    try:
        saved = _steps_saved(mp, jsearcher)
        np.random.seed(0)
        random.seed(0)
        searcher = JNTUSearcher(args)
        rec = _Recorder(searcher.train_fn)
        searcher.train_fn = rec
        data = searcher.search()
    finally:
        mp.undo()
    surrogate = JSurrogate(100, 3, 100, max_seq_len=2)
    params = jax.tree_util.tree_map(np.asarray, surrogate.params)
    return dict(root=root, argv=argv, data=data, calls=rec.calls,
                saved=saved, surrogate_params=params)


def _port_search(argv, surrogate_params=None, seed=0):
    args = tmain.parse_args(argv)
    np.random.seed(seed)
    random.seed(seed)
    searcher = NTUSearcher(args, device="cpu")
    if surrogate_params is not None:
        searcher.surrogate.load_numpy(surrogate_params)
    rec = _Recorder(searcher.train_fn)
    searcher.train_fn = rec
    return searcher, searcher.search(), rec.calls


def _top5(data):
    confs, accs, _ = data.get_k_best(min(5, len(data)))
    return sorted((c.tobytes(), a) for c, a in zip(confs, accs))


def test_whole_search_matches_jax(jax_run):
    searcher, data, calls = _port_search(jax_run["argv"],
                                         jax_run["surrogate_params"])
    jcalls = jax_run["calls"]
    assert len(calls) == len(jcalls) == 2
    (c0, a0), (jc0, ja0) = calls[0], jcalls[0]
    assert len(c0) == 32
    assert [c.tobytes() for c in c0] == [c.tobytes() for c in jc0]
    assert a0 == [float(np.float32(a)) for a in ja0]
    assert len(set(a0)) > 1          # the step tells the confs apart
    # given equal accuracies, the same confs are sampled and trained next
    assert [c.tobytes() for c in calls[1][0]] == \
        [c.tobytes() for c in jcalls[1][0]]
    assert calls[1][1] == jcalls[1][1]
    assert _pairs(data) == _pairs(jax_run["data"])
    assert _top5(data) == _top5(jax_run["data"])
    # the frozen backbones kept their weights and statistics (the rgb net's
    # BatchNorm buffers included) through the train-mode feature passes
    for name, net in (("ske", searcher.extractor.skenet),
                      ("rgb", searcher.extractor.rgbnet)):
        want = torch.load(jax_run["root"] / f"{name}.checkpoint",
                          weights_only=True)
        state = net.state_dict()
        assert set(state) == set(want)
        for k, v in state.items():
            assert torch.equal(v, want[k].to(v.dtype)), k
    assert any(k.endswith("running_var") for k in state)


def test_jax_search_state_resumes_in_port(jax_run, capsys):
    state = str(jax_run["root"] / "resume_from_jax.pkl")
    shutil.copy(jax_run["saved"][0], state)        # after step (0, 0)
    searcher, data, calls = _port_search(
        jax_run["argv"] + ["--search_state", state, "--resume_search"],
        seed=7)
    # only step (0, 1) ran, on the confs JAX's surrogate state samples
    assert len(calls) == 1
    assert [c.tobytes() for c in calls[0][0]] == \
        [c.tobytes() for c in jax_run["calls"][1][0]]
    assert calls[0][1] == jax_run["calls"][1][1]
    assert _pairs(data) == _pairs(jax_run["data"])
    st = tsearcher.ModelSearcher.load_state(state)
    assert (st["si"], st["progression_index"]) == (0, 1)
    assert st["trainer_seed"] == 2
