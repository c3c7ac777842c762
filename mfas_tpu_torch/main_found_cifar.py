#!/usr/bin/env python3
"""Train and test a found CIFAR micro-cell architecture on the card (port
of main_found_cifar.py; same flags and defaults).

    python -m mfas_tpu_torch.main_found_cifar --data_dir data/cifar10/ \\
        --conf '0,1,-2,-1;2,3,-2,0' [--use_intermediate] [--cutout]

builds the found net in fixed mode (cells concat their unused blocks and
reduce them with a 1x1 conv; --planes doubles at every reduction of
--net_str, 36 -> 72 -> 144 at the defaults), trains it for --epochs epochs
with Adam on the per-batch cosine schedule (Ti 5, Tm 2), keeps the best dev
state and evaluates it on the test split. --use_intermediate adds the
auxiliary head's loss, weighted 0.4; --cutout adds Cutout to the train
crops and flips. The store is a local ``cifar-10-batches-py`` directory:
train[0:45000] trains, train[45000:50000] is dev (the last n//10 images
of a smaller store), test_batch tests. Options: --save_checkpoint (the
JAX CLI's name ``cifar_micro_<acc>.checkpoint`` in --checkpointdir),
--profile_dir D.

From the command line the device is CUDA and the run fails without it;
``main(argv, device="cpu")`` runs the same path on the CPU.
``--use_dataparallel`` under ``torchrun`` or the ``--dist_*`` trio (one
process per GPU) splits every batch by rows over the processes;
only process 0 writes files (parallel/mesh.py).
"""

import argparse
import os
import time

import numpy as np

from mfas_tpu_torch.parallel import mesh as pm
from mfas_tpu_torch.parallel.mesh import add_dist_args
from mfas_tpu_torch.runtime.cli import cli_device


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Found micro-cell training.')
    parser.add_argument('--checkpointdir', type=str, default='checkpoints/')
    parser.add_argument('--data_dir', type=str, default='data/cifar10/')
    parser.add_argument('--num_outputs', type=int, default=10)
    parser.add_argument('--batchsize', type=int, default=128)
    parser.add_argument('--planes', type=int, default=36)
    parser.add_argument('--net_str', type=int, nargs='+',
                        default=[1, 1, 2, 1, 1, 2, 1, 1])
    parser.add_argument('--img_size', type=int, default=32)
    parser.add_argument('--drop_path', type=float, default=0.1)
    parser.add_argument('--drop_prob', type=float, default=0.2)
    parser.add_argument('--epochs', type=int, default=120)
    parser.add_argument('--eta_max', type=float, default=0.001)
    parser.add_argument('--eta_min', type=float, default=0.000001)
    parser.add_argument('--Ti', type=int, default=5)
    parser.add_argument('--Tm', type=int, default=2)
    parser.add_argument('--use_intermediate', action='store_true', default=False,
                        help='add the 0.4-weighted auxiliary-head loss')
    parser.add_argument('--cutout', action='store_true', default=False)
    parser.add_argument('--use_dataparallel', action='store_true', default=False)
    parser.add_argument('--no-verbose', dest='verbose', action='store_false',
                        default=True)
    parser.add_argument('--conf', type=str,
                        default='0,1,-2,-1;2,3,-2,0',
                        help="rows 'op1,op2,conn1,conn2' separated by ';'")
    parser.add_argument('--save_checkpoint', action='store_true', default=False)
    # additive flag (not in the reference)
    parser.add_argument('--profile_dir', type=str, default='')
    add_dist_args(parser)
    return parser.parse_args(argv)


# the initial weights' seed (the JAX CLI's model.init(0)); dropout and
# DropPath draw from the engine's generator, seeded apart from it
INIT_SEED = 0


def parse_conf(conf):
    """'op1,op2,conn1,conn2;...' -> (rows, 4) int array."""
    return np.asarray([[int(v) for v in row.split(',')]
                       for row in conf.split(';')])


def build_model(args, configuration, device):
    """The found net (fixed mode; doubles args.planes at each reduction)
    with its initial weights drawn from INIT_SEED."""
    import torch

    from mfas_tpu_torch.fusion.cifar import Searchable_MicroCNN

    return Searchable_MicroCNN(
        args, configuration, fixed=True, device=device,
        generator=torch.Generator().manual_seed(INIT_SEED))


def get_dataloaders(args):
    """train / dev rows of the train store and the test store."""
    from mfas_tpu_torch.data.cifar import (CifarLoader, load_cifar10_arrays,
                                           train_split)

    train_arrays = load_cifar10_arrays(args.data_dir, train=True)
    test_arrays = load_cifar10_arrays(args.data_dir, train=False)
    split, hi = train_split(train_arrays["image"].shape[0])
    return {
        "train": CifarLoader(train_arrays, args.batchsize, train=True,
                             indices=np.arange(0, split),
                             use_cutout=args.cutout),
        "dev": CifarLoader(train_arrays, args.batchsize,
                           indices=np.arange(split, hi)),
        "test": CifarLoader(test_arrays, args.batchsize),
    }


def main(argv=None, device=None):
    """-> main_found_ntu.py::FoundRun."""
    from mfas_tpu_torch.core.sched import LRCosineAnnealingScheduler
    from mfas_tpu_torch.engine.cifar import CifarEngine
    from mfas_tpu_torch.main_found_ntu import FoundRun, train_phase
    from mfas_tpu_torch.parallel.mesh import is_primary_process
    from mfas_tpu_torch.runtime import checkpoint as ckpt
    from mfas_tpu_torch.runtime.profiler import maybe_profile

    print("Training found CIFAR micro-cell network")
    args = parse_args(argv)
    device = cli_device(device, "mfas_tpu_torch.main_found_cifar", args)
    pm.initialize_from_args(args, device)
    group = pm.data_group_from_args(args)
    print("The configuration of this run is:")
    print(args)

    model = build_model(args, parse_conf(args.conf), device)
    loaders = get_dataloaders(args)
    sizes = {k: v.dataset_size for k, v in loaders.items()}
    engine = CifarEngine(model, device, use_intermediate=args.use_intermediate,
                         group=group)
    sched = LRCosineAnnealingScheduler(args.eta_max, args.eta_min, args.Ti,
                                       args.Tm, sizes["train"] / args.batchsize)
    start = time.time()
    with maybe_profile(args.profile_dir, device):
        _, peak = train_phase(
            engine, "Found net", None,
            {k: loaders[k] for k in ("train", "dev")}, sizes, sched,
            num_epochs=args.epochs, print_loss=args.verbose)
        test_acc = engine.test_track_acc(loaders["test"], sizes["test"])
    elapsed = time.time() - start
    record = engine.last_eval
    print('Training in {:.0f}m {:.0f}s'.format(elapsed // 60, elapsed % 60))
    print('Eval clips/s: {:.1f} ({} clips on {})'.format(
        record.clips / record.seconds, record.clips, device))
    print('Model Acc: {}'.format(test_acc))

    saved = None
    if args.save_checkpoint and is_primary_process():
        saved = os.path.join(args.checkpointdir,
                             f"cifar_micro_{test_acc:.4f}.checkpoint")
        ckpt.save(model.state_dict(), saved)
        print('Saved ' + saved)
    return FoundRun(acc=test_acc, eval=record, train=engine.train_records,
                    train_peak_bytes=[peak], saved=saved)


if __name__ == "__main__":
    main()
