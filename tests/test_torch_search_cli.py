"""The port's search CLI on the CPU (``main(argv, device="cpu")``) at a
small size:

* a search interrupted after its first step and resumed in a fresh process
  (another numpy seed) ends as the uninterrupted one, dropout on; the
  --jsonl_log holds one event per EPNAS step;
* --sequential_candidates and --weightsharing each run a step (over 6 of
  the 32 one-row confs, each trained through the engine); the
  weight-sharing store holds the JAX package's keys;
* --cache_features builds its bank once for the whole search;
* ``train_track_acc(seed=...)``: two candidates draw different dropout
  masks, and the default seed is the found CLI's (its losses unchanged);
* the CLI stops without CUDA and on the flags it does not carry yet.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from mfas_tpu_torch import main_found_ntu as fmain
from mfas_tpu_torch import main_searchable_ntu as tmain
from mfas_tpu_torch.core.sched import LRCosineAnnealingScheduler
from mfas_tpu_torch.engine.classifier import (TRAIN_SEED_OFFSET,
                                              ClassifierEngine)
from mfas_tpu_torch.fusion import ntu as tfntu
from mfas_tpu_torch.ops import input_kernels as tk
from mfas_tpu_torch.search import searcher as tsearcher
from mfas_tpu_torch.search import trainers as ttrainers
from tests.test_torch_search_ntu import _pairs, _steps_saved, write_store

SMALL = ["--num_outputs", "3", "--batchsize", "4", "--vid_len", "4", "32",
         "--resnet3d_layers", "1", "1", "1", "1", "--resnet3d_base_width",
         "8", "--j", "2", "--epochs", "1", "--epochs_surrogate", "3",
         "--num_samples", "3", "--device_input_normalize",
         "--random_backbones", "--no-verbose", "--seed", "0"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("search_cli")
    write_store(root)
    return root


def argv_of(root, *extra):
    return ["--packed_datadir", str(root / "packed"), "--checkpointdir",
            str(root), *SMALL, *extra]


def test_resumed_search_reproduces_uninterrupted(root, monkeypatch):
    state = str(root / "full.pkl")
    saved = _steps_saved(monkeypatch, tsearcher)
    steps = ["--search_iterations", "2", "--max_fusions", "2"]
    log = root / "search.jsonl"
    full = tmain.main(argv_of(root, *steps, "--search_state", state,
                              "--jsonl_log", str(log)), device="cpu")
    assert len(saved) == 4
    assert full.candidates == 32 + 3 * 3
    assert set(full.split) == {"sampler", "features", "population steps",
                               "surrogate"}
    events = [json.loads(line) for line in log.read_text().splitlines()]
    assert [(e["kind"], e["si"], e["progression"]) for e in events] == \
        [("epnas_step", si, p) for si in range(2) for p in range(2)]

    resume = str(root / "resume.pkl")
    shutil.copy(saved[0], resume)
    argv = argv_of(root, *steps, "--search_state", resume, "--resume_search")
    argv[argv.index("--seed") + 1] = "7"     # a fresh process's own seed
    resumed = tmain.main(argv, device="cpu")
    assert resumed.candidates == 3 * 3
    assert _pairs(resumed.data) == _pairs(full.data)
    assert [(c.tobytes(), a) for c, a in resumed.top] == \
        [(c.tobytes(), a) for c, a in full.top]


# the one-row confs a sequential first step trains here: 6 of the 32
# [ske tap, rgb tap, activation] rows, every tap and both activations
FIRST_STEP = [[0, 0, 0], [1, 2, 1], [2, 3, 0], [3, 1, 0], [3, 1, 1],
              [1, 0, 1]]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the searches run thousands of tiny ops, which
    several test workers' thread pools on the same cores slow down by an
    order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("flag", ["--sequential_candidates",
                                  "--weightsharing"])
def test_sequential_paths_run_one_step(root, flag, monkeypatch,
                                       one_torch_thread):
    stores = []
    orig = ttrainers.SequentialSearchTrainer.__call__

    def spy(self, *a, state_dict=None, **k):
        out = orig(self, *a, state_dict=state_dict, **k)
        stores.append(state_dict)
        return out

    monkeypatch.setattr(ttrainers.SequentialSearchTrainer, "__call__", spy)
    monkeypatch.setattr(tfntu, "get_possible_layer_configurations",
                        lambda progression_index=None: FIRST_STEP)
    run = tmain.main(argv_of(root, flag, "--search_iterations", "1",
                             "--max_fusions", "1", "--batchnorm"),
                     device="cpu")
    assert run.candidates == len(FIRST_STEP) and len(stores) == 1
    assert set(run.split) == {"sampler", "sequential candidates",
                              "surrogate"}
    accs = [a for _, a in run.top]
    assert len(accs) == 5 and all(0.0 <= a <= 1.0 for a in accs)
    if flag == "--weightsharing":
        # one key '0.L_{in}_16.A_{act}' per distinct tap-pair width and
        # activation trained, each with the Linear and the BatchNorm state
        ske, ims = tfntu.tap_sizes(tmain.parse_args(SMALL))
        keys = {f"0.L_{ske[a] + ims[b]}_16.A_{('relu', 'sigmoid')[act]}"
                for a, b, act in FIRST_STEP}
        store = stores[0]
        assert set(store) == keys
        entry = store["0.L_640_16.A_relu"]
        assert entry["0"]["weight"].shape == (16, 640)
        assert set(entry["2"]) == {"weight", "bias", "running_mean",
                                   "running_var", "num_batches_tracked"}


def test_cache_features_extracts_once(root):
    tk.reset_launch_counts()
    calls = {"n": 0}
    from mfas_tpu_torch.search import population as tpop
    orig = tpop.PopulationTrainer._features

    def count(self, inputs, train):
        calls["n"] += 1
        assert not train
        return orig(self, inputs, train)

    tpop.PopulationTrainer._features = count
    try:
        run = tmain.main(argv_of(root, "--cache_features", "--batchnorm",
                                 "--search_iterations", "1",
                                 "--max_fusions", "3"), device="cpu")
    finally:
        tpop.PopulationTrainer._features = orig
    assert run.candidates == 32 + 2 * 3
    assert calls["n"] == 3 + 2      # trainexp 12 and dev 6 at batch 4
    # CPU tensors take K1's plain version: nothing is counted
    assert tk.launch_counts["u8_normalize"] == 0


def test_train_seed_draws_per_candidate(root):
    """Two candidates of the sequential trainer draw different dropout
    masks (seeds self._seed + TRAIN_SEED_OFFSET); the default seed is
    TRAIN_SEED_OFFSET, so the found CLI's draws are unchanged."""
    args = fmain.parse_args(["--packed_datadir", str(root / "packed"),
                             "--device_input_normalize", "--num_outputs",
                             "3", "--batchsize", "4", "--vid_len", "4", "32",
                             "--resnet3d_layers", "1", "1", "1", "1",
                             "--resnet3d_base_width", "8", "--j", "2",
                             "--inner_representation_size", "16",
                             "--drpt", "0.5", "--conf", "4", "--epochs", "1",
                             "--no-verbose"])
    from mfas_tpu_torch.data import ntu as d
    from mfas_tpu_torch.data.loader import MapLoader
    from mfas_tpu_torch.data.ntu_pack import (PackedNTU,
                                              make_device_normalize_prep)

    def losses(seed):
        loaders = {k: MapLoader(PackedNTU(
            str(root / "packed" / s), d.Compose([d.NormalizeLen(
                args.vid_len)]), args, device_normalize=True), 4,
            shuffle=False, num_workers=2)
            for k, s in (("train", "trainexp"), ("dev", "dev"))}
        model = fmain.build_model(args, fmain.FOUND_CONFS[4], "cpu")
        engine = ClassifierEngine(model, "cpu", multitask=args.multitask,
                                  input_keys=("rgb", "ske"),
                                  batch_prep=make_device_normalize_prep())
        kw = {} if seed is None else {"seed": seed}
        engine.train_track_acc(
            model.central_params(), loaders,
            {k: v.dataset_size for k, v in loaders.items()},
            LRCosineAnnealingScheduler(1e-3, 1e-6, 1, 2, 3), 1,
            print_loss=False, **kw)
        return [e["loss"] for e in engine.train_records[-1].epochs]

    assert ttrainers.TRAIN_SEED_OFFSET == TRAIN_SEED_OFFSET
    first, second = (losses(s + TRAIN_SEED_OFFSET) for s in (1, 2))
    assert first[0] != second[0]              # train losses: other masks
    assert losses(None) == losses(TRAIN_SEED_OFFSET)


# the multi-GPU flags are ported (parallel/mesh.py): on a card-less command
# line they stop for want of CUDA like any other, and a partial --dist_*
# trio stops with the JAX package's ValueError before anything runs
@pytest.mark.parametrize("extra, item", [
    ([], None),
    (["--use_dataparallel"], None),
    (["--shard_feature_bank"], None),
    # a group it cannot form (no --dist_num_processes) fails
    (["--dist_coordinator", "localhost:1234"], "dist_num_processes"),
    (["--dist_process_id", "0"], "dist_coordinator"),
])
def test_cli_guards(root, extra, item, monkeypatch):
    if item:
        with pytest.raises(ValueError, match=item):
            tmain.main(argv_of(root, *extra), device="cpu")
        return
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        tmain.main(argv_of(root, *extra))
    assert "needs a CUDA device" in str(e.value)


@pytest.mark.parametrize("drop", ["--packed_datadir",
                                  "--device_input_normalize"])
def test_cli_stops_without_packed_device_input(root, drop):
    """Both other inputs are ported (tests/test_torch_ntu_raw_cli.py):
    without --packed_datadir the CLI reads the raw layout under --datadir
    (here the missing default data/NTU/), without --device_input_normalize
    the packed store is normalized on the host and K1 has no place."""
    from mfas_tpu_torch.search.searchers import NTUSearcher

    argv = argv_of(root)
    i = argv.index(drop)
    del argv[i:i + (2 if drop == "--packed_datadir" else 1)]
    if drop == "--packed_datadir":
        with pytest.raises(FileNotFoundError, match="nturgbd_rgb"):
            tmain.main(argv, device="cpu")
        return
    searcher = NTUSearcher(tmain.parse_args(argv), device="cpu")
    for loader in searcher.dataloaders.values():
        assert not loader.dataset.device_normalize
    batch = next(iter(searcher.dataloaders["train"]))
    assert batch["rgb"].dtype == np.float32
    assert searcher.train_fn.trainer.input_prep is None


def test_parser_defaults_are_the_reference_search():
    a = tmain.parse_args([])
    assert (a.inner_representation_size, a.batchsize, a.epochs,
            a.num_samples, a.search_iterations, a.max_progression_levels,
            a.epochs_surrogate, a.drpt, a.initial_temperature,
            a.final_temperature) == (16, 20, 3, 15, 3, 4, 50, 0.5, 10.0, 0.2)
    assert tuple(a.vid_len) == (8, 32) and tuple(a.resnet3d_layers) == \
        (3, 4, 6, 3) and a.resnet3d_base_width == 64
