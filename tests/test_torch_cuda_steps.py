"""The per-batch steps' CUDA graphs on the card, held against the eager
steps from the same state (mfas_tpu_torch/engine/classifier.py,
engine/cifar.py, search/population.py). Every test here needs a CUDA device
and skips without one. This file imports neither JAX nor the JAX package,
so it also runs where they are not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_steps.py

cuDNN runs deterministically here (``torch.backends.cudnn.deterministic``),
so the graphed and the eager steps are held bitwise: parameters, buffers,
Adam state, generator state, losses, corrects and eval logits.
"""

import types

import numpy as np
import pytest
import torch

from mfas_tpu_torch import main_found_ntu as tmain
from mfas_tpu_torch.data import ntu_pack as tpack
from mfas_tpu_torch.data.ntu import Compose, NormalizeLen
from mfas_tpu_torch.data.resident import ResidentLoader, ResidentNTUStore
from mfas_tpu_torch.engine.cifar import CifarEngine
from mfas_tpu_torch.engine.classifier import place_batch, set_trainable
from mfas_tpu_torch.ops import input_kernels as tk
from mfas_tpu_torch.runtime import graphs
from mfas_tpu_torch.runtime.train_state import (load_train_state,
                                                save_train_state)
from mfas_tpu_torch.search import population as tpop

pytestmark = pytest.mark.cuda

SMALL_NTU = ["--conf", "4", "--num_outputs", "3", "--batchsize", "2",
             "--inner_representation_size", "16", "--vid_len", "4", "32",
             "--resnet3d_layers", "1", "1", "1", "1",
             "--resnet3d_base_width", "8", "--random_backbones",
             "--drpt", "0.3", "--batchnorm", "--hbm_resident"]
LRS = (1e-3, 7e-4, 4e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    graphs.reset_graph_counts()
    tk.reset_launch_counts()
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = flags


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    root = tmp_path_factory.mktemp("cuda_steps") / "packed"
    for seed, split in enumerate(("train", "dev")):
        tpack.make_synthetic_packed_ntu(str(root / split), n=6, frames=6,
                                        h=32, w=32, skel_frames=40,
                                        num_classes=3, seed=seed)
    return root


def _ntu_engine(packed, device, *extra, seed=3):
    args = tmain.parse_args(["--packed_datadir", str(packed), *SMALL_NTU,
                             *extra])
    model = tmain.build_model(args, tmain.FOUND_CONFS[4], device)
    engine = tmain.make_engine(model, args, device)
    engine.generator.manual_seed(seed)
    return args, model, engine


def _ntu_batches(packed, args, device):
    out = []
    for split in ("train", "dev"):
        store = ResidentNTUStore(str(packed / split), device, args=args)
        loader = ResidentLoader(store, 2, Compose([NormalizeLen((4, 32))]))
        out.append([place_batch(b, device) for b in loader])
    return out


def _run(engine, model, batches, dev, prefixes=None):
    set_trainable(model, prefixes)
    model.train()
    opt = engine.make_optimizer()
    out = [engine.train_step(b, opt, lr) for b, lr in zip(batches, LRS)]
    model.eval()
    logits = [engine.eval_step(b)[2] for b in dev]
    return out, logits, opt


def _same(a, b):
    """Two (engine, model, run) triples hold the same state bitwise."""
    (ea, ma, (outa, la, opta)), (eb, mb, (outb, lb, optb)) = a, b
    for (x, y), (u, v) in zip(outa, outb):
        assert torch.equal(x, u) and torch.equal(y, v)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)
    for (k, x), y in zip(ma.state_dict().items(), mb.state_dict().values()):
        assert torch.equal(x, y), k
    for p, q in zip(ma.parameters(), mb.parameters()):
        sa, sb = opta.state.get(p, {}), optb.state.get(q, {})
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    assert torch.equal(ea.generator.get_state(), eb.generator.get_state())


@pytest.mark.parametrize("phase", ["central", "whole"])
def test_ntu_resident_step_graphed_equals_eager(cuda, packed, phase):
    """K2 inside the graphed step, the resident stores passed through;
    one K2 launch per replayed batch."""
    args, model, engine = _ntu_engine(packed, cuda)
    train, dev = _ntu_batches(packed, args, cuda)
    prefixes = model.central_params() if phase == "central" else None
    tk.reset_launch_counts()
    graphed = (engine, model, _run(engine, model, train, dev, prefixes))
    assert engine.graphed
    assert tk.launch_counts == {"u8_normalize": 0,
                                "u8_gather_normalize": len(train) + len(dev)}
    assert graphs.GRAPH_COUNTS["ClassifierEngine_train"] == {
        "captures": 1, "replays": len(train)}
    _, model2, engine2 = _ntu_engine(packed, cuda)
    engine2.graphed = False
    _same(graphed, (engine2, model2, _run(engine2, model2, train, dev,
                                          prefixes)))


def test_ntu_bf16_step_graphed_equals_eager(cuda, packed):
    """--bf16: autocast without its weight cache inside the graph, K2
    writing bf16 clips."""
    args, model, engine = _ntu_engine(packed, cuda, "--bf16")
    train, dev = _ntu_batches(packed, args, cuda)
    graphed = (engine, model, _run(engine, model, train, dev))
    _, model2, engine2 = _ntu_engine(packed, cuda, "--bf16")
    engine2.graphed = False
    _same(graphed, (engine2, model2, _run(engine2, model2, train, dev)))


def _cifar(device):
    from mfas_tpu_torch.fusion import cifar as tfc
    args = types.SimpleNamespace(
        num_outputs=10, planes=4, net_str=[1, 2, 1], img_size=32,
        drop_path=0.4, drop_prob=0.3)
    conf = np.array([[0, 1, -2, -1], [2, 3, -2, 0]])
    model = tfc.Searchable_MicroCNN(args, conf, fixed=True, device=device,
                                    generator=torch.Generator().manual_seed(0))
    engine = CifarEngine(model, device, use_intermediate=True)
    engine.generator.manual_seed(5)
    return engine, model


def test_cifar_step_graphed_equals_eager(cuda):
    """DropPath and dropout draw from the registered generator inside the
    graph; the zero-gradient skip decides there."""
    rs = np.random.RandomState(0)

    def batch():
        return {"image": torch.tensor(rs.randn(8, 3, 32, 32),
                                      dtype=torch.float32, device=cuda),
                "label": torch.tensor(rs.randint(0, 10, 8), device=cuda),
                "_mask": torch.ones(8, device=cuda)}

    train, dev = [batch() for _ in LRS], [batch()]
    engine, model = _cifar(cuda)
    graphed = (engine, model, _run(engine, model, train, dev))
    engine2, model2 = _cifar(cuda)
    engine2.graphed = False
    _same(graphed, (engine2, model2, _run(engine2, model2, train, dev)))
    assert graphs.GRAPH_COUNTS["CifarEngine_train"]["captures"] == 1


def test_old_train_state_resumes_into_capturable_adam(cuda, packed,
                                                      tmp_path):
    """A state written with torch's lazy, non-capturable Adam (every card
    run before the graphs) loads into the capturable one before the
    capture; the graphed steps then equal eager ones from the same load."""
    from mfas_tpu_torch.core.optim import make_adam
    from mfas_tpu_torch.core.sched import FixedScheduler
    from mfas_tpu_torch.engine.classifier import WEIGHT_DECAY

    args, model, engine = _ntu_engine(packed, cuda)
    train, dev = _ntu_batches(packed, args, cuda)
    set_trainable(model, None)
    model.train()
    old = make_adam(model.parameters(), WEIGHT_DECAY)
    engine.graphed = False
    engine._train_step(train[0], old, 1e-3)
    path = str(tmp_path / "st.pt")
    save_train_state(path, model=model, best_state=model.state_dict(),
                     optimizer=old, scheduler=FixedScheduler(1e-3), epoch=0,
                     best_acc=0.0)
    runs = []
    for graphed in (True, False):
        _, m, e = _ntu_engine(packed, cuda)
        set_trainable(m, None)
        opt = e.make_optimizer()
        load_train_state(path, model=m, optimizer=opt,
                         scheduler=FixedScheduler(1e-3))
        assert all(st["step"].device.type == "cuda"
                   for st in opt.state.values())
        e.graphed = graphed
        m.train()
        out = [e.train_step(b, opt, lr) for b, lr in zip(train[1:], LRS)]
        runs.append((m, opt, out))
    (ma, oa, outa), (mb, ob, outb) = runs
    for (x, y), (u, v) in zip(outa, outb):
        assert torch.equal(x, u) and torch.equal(y, v)
    for (k, x), y in zip(ma.state_dict().items(), mb.state_dict().values()):
        assert torch.equal(x, y), k
    stepped = 0
    for p, q in zip(ma.parameters(), mb.parameters()):
        assert (p in oa.state) == (q in ob.state)
        if p in oa.state:       # the unused gates never get a gradient
            assert float(oa.state[p]["step"]) == float(
                ob.state[q]["step"]) == 1 + len(train[1:])
            stepped += 1
    assert stepped


def test_streamed_search_steps_graphed_equal_eager(cuda):
    """The train-mode features (K1 inside) and the population's train and
    eval steps, graphed against their eager calls, from the same state."""
    from mfas_tpu_torch.fusion.ntu import NTUFeatureExtractor, tap_sizes
    args = tmain.parse_args(["--packed_datadir", "unused", *SMALL_NTU])
    extractor = NTUFeatureExtractor(args, device=cuda,
                                    generator=torch.Generator().manual_seed(1))
    ske, ims = tap_sizes(args)
    spec = tpop.PopulationSpec(sizes_a=tuple(ske), sizes_b=tuple(ims),
                               hidden=16, num_outputs=3, max_rows=4,
                               batchnorm=True, use_alphas=True,
                               multitask=True, drpt=0.3)
    confs = [np.array([[3, 1, 0]]), np.array([[0, 2, 1], [2, 3, 0]])]
    rs = np.random.RandomState(2)
    batches = [(torch.tensor(rs.randint(0, 256, (3, 4, 32, 32, 3)),
                             dtype=torch.uint8, device=cuda),
                torch.tensor(rs.randn(3, 3, 32, 25, 2) * 0.3,
                             dtype=torch.float32, device=cuda),
                torch.tensor(rs.randint(0, 3, 3), device=cuda),
                torch.ones(3, device=cuda)) for _ in LRS]
    prep = tpack.make_device_normalize_inputs_prep()
    results = []
    for graphed in (True, False):
        trainer = tpop.PopulationTrainer(spec, extractor, device=cuda,
                                         input_prep=prep)
        assert trainer.graphed
        trainer.generator.manual_seed(7)
        params, bn = tpop.init_population(confs, spec, seed=3, device=cuda)
        conf = tpop.conf_tensors(confs, spec, cuda)
        prog = tpop._StreamedSteps(spec, params, bn, conf, device=cuda,
                                   graphed=graphed)
        prog.load(params, bn, conf)
        tk.reset_launch_counts()
        feats = []
        for rgb, ske_, label, w in batches:
            f = (trainer.streamed_features((rgb, ske_)) if graphed
                 else trainer._features((rgb, ske_), True))
            feats.append(f)
            prog.train_batch(f, label, w, 1e-3, trainer.generator)
        assert tk.launch_counts["u8_normalize"] == len(batches)
        prog.eval_batch((*feats[0], batches[0][2], batches[0][3]))
        results.append((feats, prog.state(), prog.counts("corr"),
                        prog.counts("dev_corr"),
                        trainer.generator.get_state()))
    (fa, (pa, ba), ca, da, ga), (fb, (pb, bb), cb, db, gb) = results
    for x, y in zip(fa, fb):
        for u, v in zip(x, y):
            assert torch.equal(u, v)
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    for k in ba:
        assert torch.equal(ba[k], bb[k]), k
    assert torch.equal(ca, cb) and torch.equal(da, db)
    assert torch.equal(ga, gb)
    counts = graphs.GRAPH_COUNTS
    assert counts["population_features"] == {"captures": 1, "replays": 3}
    assert counts["population_train_step"] == {"captures": 1, "replays": 3}
    assert counts["population_eval_step"] == {"captures": 1, "replays": 1}
