"""The last per-batch programs' CUDA graphs on the card, held against their
eager steps from the same state: ``MMIMDBEngine``'s train and eval steps
(one graph per text length), the ``--remat`` train step (the segments'
recomputation inside the graph) and the bank's per-step loop
(``--cache_features --no_fused_epochs``). Every test here needs a CUDA
device and skips without one. This file imports neither JAX nor the JAX
package, so it also runs where they are not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_graph_leftovers.py

cuDNN runs deterministically here (``torch.backends.cudnn.deterministic``),
so the graphed and the eager steps are held bitwise, dropout on.
"""

import numpy as np
import pytest
import torch
from torch import nn

from mfas_tpu_torch import main_found_mmimdb as tmmain
from mfas_tpu_torch import main_found_ntu as tmain
from mfas_tpu_torch.core import layers as L
from mfas_tpu_torch.core.sched import FixedScheduler
from mfas_tpu_torch.data import loader as tloader
from mfas_tpu_torch.data import ntu as tntu
from mfas_tpu_torch.data import ntu_pack as tpack
from mfas_tpu_torch.data.mm_imdb import TEXT_PAD_VALUE
from mfas_tpu_torch.engine.classifier import snapshot
from mfas_tpu_torch.engine.mmimdb import MMIMDBEngine
from mfas_tpu_torch.fusion.ntu import NTUFeatureExtractor, tap_sizes
from mfas_tpu_torch.models import mm_imdb as tm
from mfas_tpu_torch.ops import input_kernels as tk
from mfas_tpu_torch.runtime import graphs
from mfas_tpu_torch.search import population as tpop
from tests.test_torch_cuda_steps import (LRS, SMALL_NTU,  # noqa: F401
                                         _ntu_batches, _ntu_engine, _run,
                                         _same, cuda, packed)

pytestmark = pytest.mark.cuda


# --------------------------------------------------------------------------
# --remat
# --------------------------------------------------------------------------
@pytest.mark.parametrize("phase", ["central", "whole"])
def test_ntu_remat_step_graphed_equals_eager(cuda, packed, phase):
    """K2 inside the graphed remat step, once per replayed batch; the
    recomputation reuses the first run's dropout masks (--drpt 0.3)."""
    args, model, engine = _ntu_engine(packed, cuda, "--remat")
    train, dev = _ntu_batches(packed, args, cuda)
    prefixes = model.central_params() if phase == "central" else None
    tk.reset_launch_counts()
    graphed = (engine, model, _run(engine, model, train, dev, prefixes))
    assert engine.graphed
    assert tk.launch_counts == {"u8_normalize": 0,
                                "u8_gather_normalize": len(train) + len(dev)}
    assert graphs.GRAPH_COUNTS["ClassifierEngine_train"] == {
        "captures": 1, "replays": len(train)}
    _, model2, engine2 = _ntu_engine(packed, cuda, "--remat")
    engine2.graphed = False
    _same(graphed, (engine2, model2, _run(engine2, model2, train, dev,
                                          prefixes)))


# --------------------------------------------------------------------------
# MMIMDBEngine
# --------------------------------------------------------------------------
class PaddedNet(nn.Module):
    """A padded-sequence MM-IMDB net: SimpleRecurrentModel over the padded
    GloVe rows (lengths from the -10 fill) plus a linear head on the
    poster's mean colour; ``dead`` is returned first and never reaches the
    loss (the engine takes the last output)."""

    def __init__(self, args, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.text = tm.SimpleRecurrentModel(args, 8, 300, **kw)
        self.image = L.Linear(3, args.num_outputs, **kw)
        self.dead = L.Linear(3, args.num_outputs, **kw)

    def forward(self, text, image):
        lengths = (text != TEXT_PAD_VALUE).any(-1).sum(1)
        pooled = image.mean(dim=(2, 3))
        return self.dead(pooled), self.text(text, lengths) + self.image(
            pooled)


def padded_batches(lengths, device, B=4, poster=(8, 8), seed=0):
    """Batches of B samples whose text pads to each of ``lengths`` rows:
    posters (B, 3, *poster), one genre of 23 per sample."""
    rs = np.random.RandomState(seed)
    out = []
    for T in lengths:
        text = np.full((B, T, 300), TEXT_PAD_VALUE, np.float32)
        for i, n in enumerate(rs.randint(max(1, T // 2), T + 1, B)):
            text[i, :n] = rs.randn(n, 300)
        label = np.zeros((B, 23), np.float32)
        label[np.arange(B), rs.randint(0, 23, B)] = 1.0
        out.append({k: torch.from_numpy(v).to(device) for k, v in dict(
            text=text, image=rs.rand(B, 3, *poster).astype(np.float32),
            label=label, textlen=(text[..., 0] != TEXT_PAD_VALUE).sum(
                1).astype(np.int32), _mask=np.ones(B, np.float32)).items()})
    return out


def _mm_steps(model, engine, batches, prefixes=None):
    from mfas_tpu_torch.engine.classifier import set_trainable

    set_trainable(model, prefixes)
    model.train()
    opt = engine.make_optimizer()
    losses = [engine.train_step(b, opt, lr)[0] for b, lr in zip(
        batches, LRS * len(batches))]
    model.eval()
    return losses, [engine.eval_step(b) for b in batches], opt


def _mm_same(a, b):
    (ma, ea, (la, va, oa)), (mb, eb, (lb, vb, ob)) = a, b
    for x, y in zip(la, lb):
        assert torch.equal(x, y)
    for (x, px), (y, py) in zip(va, vb):
        assert torch.equal(x, y) and torch.equal(px, py)
    for (k, x), y in zip(ma.state_dict().items(), mb.state_dict().values()):
        assert torch.equal(x, y), k
    for p, q in zip(ma.parameters(), mb.parameters()):
        sa, sb = oa.state.get(p, {}), ob.state.get(q, {})
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    assert torch.equal(ea.generator.get_state(), eb.generator.get_state())


def _simplevt(device):
    args = tmmain.parse_args(["--model", "simplevt", "--channels", "4",
                              "--text_first_hidden", "8"])
    model = tmmain.build_model(args, device)
    engine = MMIMDBEngine(model, device)
    engine.generator.manual_seed(3)
    return model, engine


@pytest.mark.parametrize("phase", ["central", "whole"])
def test_mmimdb_steps_graphed_equal_eager(cuda, phase):
    """SimpleVTNet (MaxOut_MLP's dropout on) at averaged text, 32x32
    posters: one train graph, one eval graph; the dead heads keep no
    gradient and stay as built."""
    rs = np.random.RandomState(1)
    batches = [{"text": torch.tensor(rs.randn(8, 300), dtype=torch.float32,
                                     device=cuda),
                "image": torch.tensor(rs.rand(8, 3, 32, 32),
                                      dtype=torch.float32, device=cuda),
                "label": torch.tensor(rs.rand(8, 23) < 0.1,
                                      dtype=torch.float32, device=cuda),
                "_mask": torch.ones(8, device=cuda)} for _ in range(3)]
    model, engine = _simplevt(cuda)
    start = snapshot(model)
    prefixes = model.central_params() if phase == "central" else None
    assert engine.graphed
    run = _mm_steps(model, engine, batches, prefixes)
    assert graphs.GRAPH_COUNTS == {
        "MMIMDBEngine_train": {"captures": 1, "replays": 3},
        "MMIMDBEngine_eval": {"captures": 1, "replays": 3}}
    dead = [n for n, p in model.named_parameters()
            if p.requires_grad and p.grad is None]
    assert dead or phase == "central"
    for n in dead:
        assert torch.equal(model.state_dict()[n], start[n]), n
    model2, engine2 = _simplevt(cuda)
    engine2.graphed = False
    _mm_same((model, engine, run), (model2, engine2, _mm_steps(
        model2, engine2, batches, prefixes)))


def _padded(device, state=None):
    args = tmmain.parse_args([])
    net = PaddedNet(args, device, torch.Generator().manual_seed(0))
    if state is not None:
        net.load_state_dict(state)
    engine = MMIMDBEngine(net, device)
    engine.generator.manual_seed(3)
    return net, engine


def test_mmimdb_two_text_lengths_graphed_equal_eager(cuda):
    """Lengths 8 and 16 alternating: two train graphs alive on one set of
    gradients, two eval graphs, the dead head without a gradient."""
    batches = padded_batches((8, 16, 8, 16, 16, 8), cuda)
    net, engine = _padded(cuda)
    start = snapshot(net)
    run = _mm_steps(net, engine, batches)
    prog = engine._programs["train"]
    assert len(prog) == 2
    assert all(p.grad is g for p, g in prog._held.items())
    assert net.dead.weight.grad is None
    assert torch.equal(net.dead.weight, start["dead.weight"])
    assert graphs.GRAPH_COUNTS == {
        "MMIMDBEngine_train": {"captures": 2, "replays": 6},
        "MMIMDBEngine_eval": {"captures": 2, "replays": 6}}
    net2, engine2 = _padded(cuda, start)
    engine2.graphed = False
    _mm_same((net, engine, run), (net2, engine2, _mm_steps(net2, engine2,
                                                           batches)))


# --------------------------------------------------------------------------
# the bank's per-step loop
# --------------------------------------------------------------------------
def test_bank_per_step_loop_graphed_equals_eager(cuda, packed):
    """--cache_features --no_fused_epochs at P=3 (--batchnorm, drpt 0.3):
    the bank built once through K1, the train steps and dev steps replayed
    per batch; accuracies, parameters and BatchNorm state bitwise the eager
    per-step loop's."""
    args = tmain.parse_args(["--packed_datadir", str(packed), *SMALL_NTU])
    ske, ims = tap_sizes(args)
    spec = tpop.PopulationSpec(sizes_a=tuple(ske), sizes_b=tuple(ims),
                               hidden=16, num_outputs=3, max_rows=4,
                               batchnorm=True, drpt=0.3)
    confs = [np.array([[3, 1, 0]]), np.array([[0, 2, 1], [2, 3, 0]]),
             np.array([[1, 0, 2], [3, 3, 1], [0, 1, 0]])]
    results = []
    for graphed in (True, False):
        tk.reset_launch_counts()
        graphs.reset_graph_counts()
        extractor = NTUFeatureExtractor(
            args, device=cuda, generator=torch.Generator().manual_seed(1))
        trainer = tpop.PopulationTrainer(
            spec, extractor, device=cuda, cache_train_features=True,
            fused_epochs=False,
            input_prep=tpack.make_device_normalize_inputs_prep())
        trainer.graphed = graphed
        loaders = {}
        for split, tf in (("train", [tntu.AugCrop(seed=0)]), ("dev", [])):
            ds = tpack.PackedNTU(str(packed / split), transform=tntu.Compose(
                [*tf, tntu.NormalizeLen(args.vid_len)]), args=args,
                device_normalize=True)
            loaders[split] = tloader.MapLoader(ds, 4, shuffle=split == "train",
                                               seed=0, num_workers=2)
        sizes = {k: v.dataset_size for k, v in loaders.items()}
        results.append(trainer.train_population(
            confs, loaders, sizes, FixedScheduler(1e-3), 2, ("rgb", "ske"),
            seed=4))
        # the bank and the dev features: one K1 launch per loader batch
        assert tk.launch_counts["u8_normalize"] == 2 + 2
        if graphed:
            assert graphs.GRAPH_COUNTS == {
                "population_train_step": {"captures": 1, "replays": 2 * 2},
                "population_eval_step": {"captures": 1, "replays": 2 * 2}}
        else:
            assert graphs.GRAPH_COUNTS == {}
    (ga, gp, gb), (ea, ep, eb) = results
    assert ga == ea
    for got, want in ((gp, ep), (gb, eb)):
        for k in want:
            assert torch.equal(got[k], want[k]), k
