"""Several gloo ranks on the CPU for the data-parallel tests of
mfas_tpu_torch (tests/test_torch_*parallel*.py).

``run_ranks(world, cases, inputs, tmp)`` spawns ``world`` processes with
``torch.multiprocessing`` (start method spawn); they join one gloo group
through a ``file://`` store in ``tmp`` (no port is needed), run every named
case of ``CASES`` in turn on the inputs the parent pickled, and pickle each
case's result back, one file per rank. This module imports torch, numpy and
mfas_tpu_torch only: the children never load JAX (tests/conftest.py does).
The parent compares the results with the JAX package.
"""

from __future__ import annotations

import os
import pickle
import types

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from mfas_tpu_torch.parallel import mesh as pm


def run_ranks(world, cases, inputs, tmp, timeout=600):
    """-> [{case: result} for each rank]."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    ctx = mp.start_processes(_child, args=(world, tuple(cases), tmp),
                             nprocs=world, join=False, start_method="spawn")
    while not ctx.join(timeout=timeout):
        pass
    out = []
    for rank in range(world):
        with open(os.path.join(tmp, f"result.{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _child(rank, world, cases, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        tmp, "store"), world_size=world, rank=rank)
    try:
        with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        res = {c: CASES[c](inputs, tmp) for c in cases}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"result.{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def _world():
    return dist.group.WORLD if dist.is_initialized() else None


def _np(t):
    return t.detach().cpu().numpy()


def _state(model):
    return {k: _np(v).copy() for k, v in model.state_dict().items()}


# --------------------------------------------------------------------------
# parallel/mesh.py primitives and process roles
# --------------------------------------------------------------------------
def case_primitives(inp, tmp):
    g = _world()
    idx = torch.as_tensor(inp["idx"])
    out = {}
    for name in ("u8", "i8"):
        local = torch.from_numpy(pm.split_rows(inp[name], g))
        out["gather_" + name] = _np(pm.gather_rows(local, idx, g))
    # a (sample, frame) pick as the sharded resident store reads clips
    local = torch.from_numpy(pm.split_rows(inp["clips"], g))
    t = torch.as_tensor(inp["frames"])
    out["gather_frames"] = _np(pm.gather_rows(
        local, idx, g, lambda st, rows: st[rows[:, None], t]))
    rows = pm.row_slice(inp["f64"].shape[0], g)
    out["allgather_f64"] = _np(pm.all_gather_rows(
        torch.from_numpy(inp["f64"][rows]), g))
    out["allgather_bf16"] = _np(pm.all_gather_rows(
        torch.from_numpy(inp["f64"][rows]).bfloat16(), g).float())
    out["allgather_i64"] = _np(pm.all_gather_rows(
        torch.from_numpy(inp["idx"][pm.row_slice(6, g)]), g))
    # all_reduce_grads: SUM over ranks, grad-None parameters left alone
    a = torch.nn.Parameter(torch.zeros(3, dtype=torch.float64))
    b = torch.nn.Parameter(torch.zeros(2))
    c = torch.nn.Parameter(torch.zeros(2))
    a.grad = torch.full((3,), float(dist.get_rank() + 1), dtype=torch.float64)
    b.grad = torch.full((2,), 10.0 * (dist.get_rank() + 1))
    pm.all_reduce_grads([a, b, c], g)
    out["grads"] = (_np(a.grad), _np(b.grad), c.grad)
    return out


def case_roles(inp, tmp):
    from mfas_tpu_torch.core.optim import make_adam
    from mfas_tpu_torch.core.sched import FixedScheduler
    from mfas_tpu_torch.runtime.train_state import save_train_state
    from mfas_tpu_torch.search.searcher import ModelSearcher
    from mfas_tpu_torch.search.surrogate import SurrogateDataloader

    rank = dist.get_rank()
    out = {"primary": pm.is_primary_process()}
    args = types.SimpleNamespace(seed=None, dist_coordinator=None)
    pm.require_shared_seed(args)
    out["seed"] = args.seed
    # every rank asks for its own file: only rank 0's may appear
    lin = torch.nn.Linear(2, 2)
    opt = make_adam(lin.parameters(), 0.0)
    save_train_state(os.path.join(tmp, f"state.{rank}.pt"), model=lin,
                     best_state=lin.state_dict(), optimizer=opt,
                     scheduler=FixedScheduler(1e-3), epoch=0, best_acc=0.0)
    searcher = ModelSearcher(types.SimpleNamespace(),
                             jsonl_log=os.path.join(tmp, f"log.{rank}.jsonl"))
    searcher._log_event(kind="step")
    searcher._save_state(os.path.join(tmp, f"search.{rank}.pkl"),
                         SurrogateDataloader(), 1.0, 0, 0, [], None)
    dist.barrier()
    out["files"] = sorted(f for f in os.listdir(tmp)
                          if f.startswith(("state.", "log.", "search.")))
    pm.require_resume_agreement((3, 4))           # agree: no error
    try:
        pm.require_resume_agreement((rank, 4))
        out["disagreement"] = None
    except RuntimeError as e:
        out["disagreement"] = str(e)
    return out


def case_batchnorm(inp, tmp):
    """A BatchNorm3d over this rank's rows, forward and backward, with and
    without remat (core/remat.py), in float64."""
    from mfas_tpu_torch.core.layers import BatchNorm3d, set_data_group
    from mfas_tpu_torch.core.remat import enable_remat

    g = _world()
    rows = pm.row_slice(inp["x"].shape[0], g)
    out = {}
    for remat in (False, True):
        bn = BatchNorm3d(inp["x"].shape[1], device="cpu").double()
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(inp["w"]))
            bn.bias.copy_(torch.from_numpy(inp["b"]))
        seg = torch.nn.Sequential(bn, torch.nn.Tanh())
        set_data_group(seg, g)
        if remat:
            enable_remat([seg])
        x = torch.from_numpy(inp["x"][rows]).requires_grad_()
        y = seg(x)
        (y * torch.from_numpy(inp["gy"][rows])).sum().backward()
        pm.all_reduce_grads(bn.parameters(), g)
        out[remat] = {"y": _np(y), "dx": _np(x.grad),
                      "dw": _np(bn.weight.grad), "db": _np(bn.bias.grad),
                      "mean": _np(bn.running_mean),
                      "var": _np(bn.running_var)}
    return out


def case_population_stats(inp, tmp):
    """One population forward and backward over this rank's rows of a
    ragged masked batch, --batchnorm, in float64."""
    from mfas_tpu_torch.search import population as tpop

    g = _world()
    spec = inp["spec"]
    params, bn = tpop.init_population(inp["confs"], spec, seed=3,
                                      device="cpu")
    params = {k: v.detach().double().requires_grad_(True)
              for k, v in params.items()}
    bn = {k: v.double() for k, v in bn.items()}
    conf = tpop.conf_tensors(inp["confs"], spec, "cpu")
    rows = pm.row_slice(inp["batch"][0].shape[0], g)
    tb = tuple(torch.from_numpy(x[rows]) for x in inp["batch"])
    loss, corr, new_bn = tpop.population_losses(spec, params, bn, conf, tb,
                                                True, group=g)
    loss.sum().backward()
    pm.all_reduce_grads(params.values(), g)
    return {"loss": _np(pm.reduce_sum(loss, g)),
            "corr": _np(pm.reduce_sum(corr, g)),
            "bn": {k: _np(v) for k, v in new_bn.items()},
            "grads": {k: _np(v.grad) for k, v in params.items()}}


# --------------------------------------------------------------------------
# engines
# --------------------------------------------------------------------------
def avmnist_engine_run(inp, group, state_path=None, epochs=2, resume=False):
    """ClassifierEngine on the AV-MNIST found net (the JAX init weights in
    ``inp["flat"]``), ``epochs`` epochs of a fixed lr at batch 8."""
    from mfas_tpu_torch.core.sched import FixedScheduler
    from mfas_tpu_torch.data.loader import ArrayLoader
    from mfas_tpu_torch.engine.classifier import ClassifierEngine
    from mfas_tpu_torch.fusion import avmnist as fa
    from mfas_tpu_torch.runtime.checkpoint import state_dict_from_numpy

    net = fa.Searchable_Audio_Image_Net(
        inp["args"], inp["conf"], device="cpu",
        generator=torch.Generator().manual_seed(0))
    net.load_state_dict(state_dict_from_numpy(inp["flat"]), strict=True)
    loaders = {"train": ArrayLoader(inp["data"], 8, shuffle=False),
               "dev": ArrayLoader(inp["data"], 8)}
    sizes = {k: v.dataset_size for k, v in loaders.items()}
    eng = ClassifierEngine(net, "cpu", input_keys=("image", "audio"),
                           group=group)
    acc, _ = eng.train_track_acc(None, loaders, sizes, FixedScheduler(1e-3),
                                 num_epochs=epochs, print_loss=False,
                                 state_path=state_path, resume=resume)
    return {"acc": acc, "state": _state(net),
            "epochs": eng.train_records[-1].epochs}


def case_engine_avmnist(inp, tmp):
    return avmnist_engine_run(inp, _world())


def case_engine_resume(inp, tmp):
    """Three epochs straight, and one epoch with a train state then a
    resume to three, both under the data group."""
    g = _world()
    state = os.path.join(tmp, "train_state.pt")
    full = avmnist_engine_run(inp, g, epochs=3)
    avmnist_engine_run(inp, g, state_path=state, epochs=1)
    resumed = avmnist_engine_run(inp, g, state_path=state, epochs=3,
                                 resume=True)
    return {"full": full, "resumed": resumed}


def mmimdb_engine_run(inp, group):
    from mfas_tpu_torch.core.sched import LRCosineAnnealingScheduler
    from mfas_tpu_torch.data.mm_imdb import MM_IMDB, MMIMDBLoader
    from mfas_tpu_torch.engine.mmimdb import MMIMDBEngine
    from mfas_tpu_torch.models import mm_imdb as M
    from mfas_tpu_torch.runtime.checkpoint import state_dict_from_numpy

    model = M.SimpleVTNet(types.SimpleNamespace(num_outputs=5, channels=4),
                          8, 3, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    model.load_state_dict(state_dict_from_numpy(inp["flat"]), strict=True)
    loaders, sizes = {}, {}
    for stage, n in (("train", 16), ("dev", 8), ("test", 8)):
        ds = MM_IMDB(inp["root"], stage=stage, feat_dim=300,
                     average_text=True, len_data=n)
        loaders[stage] = MMIMDBLoader(ds, 8, shuffle=(stage == "train"),
                                      seed=0)
        sizes[stage] = len(ds)
    eng = MMIMDBEngine(model, "cpu", group=group)
    sched = LRCosineAnnealingScheduler(1e-3, 1e-6, 1, 2, sizes["train"] / 8)
    f1, _ = eng.train_track_f1(None, {k: loaders[k] for k in ("train",
                                                              "dev")},
                               sizes, sched, num_epochs=2)
    test_f1 = eng.test_track_f1(loaders["test"])
    return {"f1": f1, "test_f1": test_f1, "state": _state(model),
            "logits": [_np(x) for x in eng.last_eval.fused_logits],
            "epochs": eng.train_records[-1].epochs}


def case_engine_mmimdb(inp, tmp):
    return mmimdb_engine_run(inp["mmimdb"], _world())


def cifar_engine_step(inp, group):
    """One float64 CifarEngine step (tests/test_torch_cifar.py::
    _engine_step's port side) on this rank's rows."""
    from mfas_tpu_torch.engine.cifar import CifarEngine
    from mfas_tpu_torch.engine.classifier import place_batch, set_trainable
    from mfas_tpu_torch.fusion import cifar as tfc
    from mfas_tpu_torch.runtime.checkpoint import state_dict_from_numpy

    net = tfc.Searchable_MicroCNN(inp["args"], inp["conf"], fixed=True,
                                  device="cpu",
                                  generator=torch.Generator().manual_seed(0))
    net.load_state_dict(state_dict_from_numpy(inp["flat"]), strict=True)
    net = net.double()
    eng = CifarEngine(net, "cpu", group=group)
    set_trainable(net, None)
    net.train()
    opt = eng.make_optimizer()
    loss, _ = eng._train_step(place_batch(inp["batch"], "cpu", group), opt,
                              inp["lr"])
    return {"loss": float(pm.reduce_sum(loss, group)), "after": _state(net),
            "grads": {n: _np(p.grad) for n, p in net.named_parameters()
                      if p.grad is not None}}


def case_engine_cifar(inp, tmp):
    return cifar_engine_step(inp["cifar"], _world())


# --------------------------------------------------------------------------
# the population trainer on a (pop, data) layout
# --------------------------------------------------------------------------
def population_run(inp, variant, group=None, pop_group=None):
    from mfas_tpu_torch.core.sched import FixedScheduler
    from mfas_tpu_torch.data.loader import ArrayLoader
    from mfas_tpu_torch.fusion import avmnist as fa
    from mfas_tpu_torch.runtime.checkpoint import state_dict_from_numpy
    from mfas_tpu_torch.search.population import PopulationTrainer

    kw = dict(inp["variants"][variant])
    data = inp["data"][kw.pop("data")]
    spec = kw.pop("spec")
    ext = fa.AVMnistFeatureExtractor(
        inp["args"], device="cpu", generator=torch.Generator().manual_seed(0))
    ext.load_state_dict(state_dict_from_numpy(inp["btree"]), strict=True)
    loaders = {"train": ArrayLoader(data, 8, shuffle=True, seed=1),
               "dev": ArrayLoader(data, 8)}
    sizes = {k: v.dataset_size for k, v in loaders.items()}
    trainer = PopulationTrainer(spec, ext, device="cpu", group=group,
                                pop_group=pop_group, **kw)
    accs, params, _ = trainer.train_population(
        inp["confs"], loaders, sizes, FixedScheduler(1e-3), num_epochs=2,
        input_keys=("image", "audio"), seed=0)
    out = {"accs": accs, "params": {k: _np(v) for k, v in params.items()}}
    bank = trainer._train_bank
    if bank is not None:
        out["bank_rows"] = {k: int(v.shape[0]) for k, v in bank.items()}
    return out


def case_population(inp, tmp):
    pop_group, data_group = pm.pop_data_groups(2, 2)
    return {v: population_run(inp, v, data_group, pop_group)
            for v in inp["variants"]}


# --------------------------------------------------------------------------
# the resident store, replicated and sharded
# --------------------------------------------------------------------------
def resident_batches(inp, group, shard):
    """(rgb, ske) of every batch of the resident train loader (this rank's
    rows), and the calls of each kernel wrapper (their plain versions run
    on the CPU, so the wrappers are counted at the call)."""
    from mfas_tpu_torch.data import ntu as d
    from mfas_tpu_torch.data.resident import (ResidentLoader,
                                              ResidentNTUStore,
                                              make_resident_prep)
    from mfas_tpu_torch.engine.classifier import place_batch
    from mfas_tpu_torch.ops import input_kernels as k

    calls = {"u8_normalize": 0, "u8_gather_normalize": 0}
    real = {n: getattr(k, n) for n in calls}

    def counted(name):
        def f(*a, **kw):
            calls[name] += 1
            return real[name](*a, **kw)
        return f

    tfm = d.Compose([d.AugCrop(), d.NormalizeLen(inp["vid_len"])])
    store = ResidentNTUStore(inp["root"], "cpu",
                             shard=group if shard else None)
    loader = ResidentLoader(store, 8, transform=tfm, shuffle=True, seed=9)
    out = []
    try:
        for n in calls:
            setattr(k, n, counted(n))
        prep = make_resident_prep(fuse_gather=True, store=store)
        for batch in loader:
            got = prep(place_batch(batch, "cpu", group))
            out.append((_np(got["rgb"]), _np(got["ske"])))
    finally:
        for n in calls:
            setattr(k, n, real[n])
    return {"batches": out, "calls": dict(calls),
            "store_rows": int(store.rgb_dev.shape[0])}


def case_resident(inp, tmp):
    import warnings
    g = _world()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sharded = resident_batches(inp, g, True)
    return {"replicated": resident_batches(inp, g, False),
            "sharded": sharded,
            "warned": [str(w.message) for w in caught]}


# --------------------------------------------------------------------------
# a command line
# --------------------------------------------------------------------------
def found_avmnist_cli(argv, flat):
    """``main_found_avmnist.main(argv, device="cpu")`` with the net's
    initial weights from ``flat`` (the JAX net's)."""
    from mfas_tpu_torch import main_found_avmnist as tmain
    from mfas_tpu_torch.runtime.checkpoint import state_dict_from_numpy

    build = tmain.build_model

    def with_weights(args, conf, device):
        model = build(args, conf, device)
        model.load_state_dict(state_dict_from_numpy(flat), strict=True)
        return model

    tmain.build_model = with_weights
    try:
        run = tmain.main(argv, device="cpu")
    finally:
        tmain.build_model = build
    return {"acc": run.acc, "epochs": [r.epochs for r in run.train],
            "saved": run.saved}


def case_cli_avmnist(inp, tmp):
    return found_avmnist_cli(inp["argv"], inp["flat"])


CASES = {name[len("case_"):]: fn for name, fn in globals().items()
         if name.startswith("case_")}
