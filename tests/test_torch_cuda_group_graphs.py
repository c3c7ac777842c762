"""The engines' CUDA graphs under a one-rank NCCL data group, on the card:
the captured train step holds the gradients' all-reduce and the synced
BatchNorm's, forward and backward, and K2 on the resident store. The test
needs a CUDA device and skips without one. This file imports neither JAX
nor the JAX package, so it also runs where they are not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_group_graphs.py

The group is joined through a ``file://`` store in the test's temporary
directory and left at the end. cuDNN runs deterministically here, so the
graphed, the eager and the group-less steps are held bitwise.
"""

import pytest
import torch.distributed as dist

from mfas_tpu_torch import main_found_ntu as tmain
from mfas_tpu_torch.data.ntu import Compose, NormalizeLen
from mfas_tpu_torch.data.resident import ResidentLoader, ResidentNTUStore
from mfas_tpu_torch.engine.classifier import place_batch
from mfas_tpu_torch.ops import input_kernels as tk
from mfas_tpu_torch.runtime import graphs
from tests.test_torch_cuda_steps import (SMALL_NTU, _run, _same,  # noqa
                                         cuda, packed)

pytestmark = pytest.mark.cuda


@pytest.fixture
def nccl_group(cuda, tmp_path):
    dist.init_process_group("nccl", init_method="file://" + str(
        tmp_path / "store"), world_size=1, rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _engine(packed, device, group):
    args = tmain.parse_args(["--packed_datadir", str(packed), *SMALL_NTU])
    model = tmain.build_model(args, tmain.FOUND_CONFS[4], device)
    engine = tmain.make_engine(model, args, device, group)
    engine.generator.manual_seed(3)
    return args, model, engine


def _batches(packed, args, device, group):
    out = []
    for split in ("train", "dev"):
        store = ResidentNTUStore(str(packed / split), device, args=args)
        loader = ResidentLoader(store, 2, Compose([NormalizeLen((4, 32))]))
        out.append([place_batch(b, device, group) for b in loader])
    return out


def test_ntu_step_graphed_under_nccl_group(cuda, packed, nccl_group):
    assert graphs.graphable(cuda, nccl_group)
    args, model, engine = _engine(packed, cuda, nccl_group)
    assert engine.graphed
    train, dev = _batches(packed, args, cuda, nccl_group)
    assert all("_count" in b for b in train)
    tk.reset_launch_counts()
    graphed = (engine, model, _run(engine, model, train, dev))
    assert tk.launch_counts == {"u8_normalize": 0,
                                "u8_gather_normalize": len(train) + len(dev)}
    assert graphs.GRAPH_COUNTS == {
        "ClassifierEngine_train": {"captures": 1, "replays": len(train)},
        "ClassifierEngine_eval": {"captures": 1, "replays": len(dev)}}
    _, model2, engine2 = _engine(packed, cuda, nccl_group)
    engine2.graphed = False
    _same(graphed, (engine2, model2, _run(engine2, model2, train, dev)))
    # at world 1 the group's collectives are the identity: the graphed
    # steps equal the group-less ones
    _, model3, engine3 = _engine(packed, cuda, None)
    train3, dev3 = _batches(packed, args, cuda, None)
    _same(graphed, (engine3, model3, _run(engine3, model3, train3, dev3)))
