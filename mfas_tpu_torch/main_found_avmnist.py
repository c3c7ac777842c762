#!/usr/bin/env python3
"""Train and test a found AV-MNIST fusion architecture on the card (port of
main_found_avmnist.py; same flags and defaults).

    python -m mfas_tpu_torch.main_found_avmnist --datadir data/avmnist/ \\
        --conf 0

trains the found net (GP_LeNet on the 28x28 digits, GP_LeNet_Deeper on the
112x112 spectrograms, --channels 32) in two phases, as the NTU CLI does:
one epoch of the central weights only (fusion layers and classifier, the
backbones frozen but in train mode), then the whole net for --epochs epochs
with a fresh Adam and schedule; each phase keeps its best dev state. The
dev split is train[50000:55000] (the last n//8 rows of a smaller store).
``--test_cp net.checkpoint`` skips training and evaluates a full checkpoint.
The backbones start from --rgb_cp/--audio_cp in --checkpointdir when given
(a missing file is an error unless --random_backbones); otherwise they keep
their initial weights. Options: --save_checkpoint, --profile_dir D.

From the command line the device is CUDA and the run fails without it;
``main(argv, device="cpu")`` runs the same path on the CPU.
``--use_dataparallel`` under ``torchrun`` or the ``--dist_*`` trio (one
process per GPU) splits every batch by rows over the processes;
only process 0 writes files (parallel/mesh.py).
"""

import argparse
import os
import re
import time

import numpy as np

from mfas_tpu_torch.parallel import mesh as pm
from mfas_tpu_torch.parallel.mesh import add_dist_args
from mfas_tpu_torch.runtime.cli import cli_device


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Modality optimization.')
    parser.add_argument('--checkpointdir', type=str, default='checkpoints/')
    parser.add_argument('--datadir', type=str, default='data/avmnist/')
    parser.add_argument('--audio_cp', type=str, default='')
    parser.add_argument('--rgb_cp', type=str, default='')
    parser.add_argument('--test_cp', type=str, default='')
    parser.add_argument('--num_outputs', type=int, default=10)
    parser.add_argument('--channels', type=int, default=32)
    parser.add_argument('--batchsize', type=int, default=128)
    parser.add_argument('--inner_representation_size', type=int, default=256)
    parser.add_argument('--epochs', type=int, default=70)
    parser.add_argument('--eta_max', type=float, default=0.001)
    parser.add_argument('--eta_min', type=float, default=0.000001)
    parser.add_argument('--Ti', type=int, default=5)
    parser.add_argument('--Tm', type=int, default=2)
    parser.add_argument('--use_dataparallel', action='store_true', default=False)
    parser.add_argument('--j', dest='num_workers', type=int, default=16)
    parser.add_argument('--no-verbose', dest='verbose', action='store_false',
                        default=True)
    parser.add_argument('--no-multitask', dest='multitask',
                        action='store_false', default=True)
    parser.add_argument('--alphas', action='store_true', default=False)
    parser.add_argument('--batchnorm', action='store_true', default=False)
    parser.add_argument("--drpt", action="store", default=0.4, dest="drpt",
                        type=float)
    parser.add_argument('--conf', type=int, help='conf to train', default=0)
    # additive flags (not in the reference)
    parser.add_argument('--random_backbones', action='store_true', default=False)
    parser.add_argument('--save_checkpoint', action='store_true', default=False)
    parser.add_argument('--profile_dir', type=str, default='')
    add_dist_args(parser)
    return parser.parse_args(argv)


# found architectures from the MFAS paper's AV-MNIST experiments (rows are
# [audio_idx, image_idx, activation]); conf 0 is the common strong choice
FOUND_CONFS = {
    0: np.array([[4, 2, 1], [4, 2, 0]]),
    1: np.array([[0, 0, 1], [4, 2, 0], [4, 2, 1]]),
    2: np.array([[4, 2, 1]]),
}

# the initial weights' seed (the JAX CLI's model.init(0)); dropout draws
# from the engine's generator, seeded apart from it
INIT_SEED = 0


def get_dataloaders(args):
    """train / dev rows of the train store (data/avmnist.py::
    train_dev_split) and the test store, as ArrayLoaders."""
    from mfas_tpu_torch.data.avmnist import (load_avmnist_arrays,
                                             train_dev_split)
    from mfas_tpu_torch.data.loader import ArrayLoader

    train_arrays = load_avmnist_arrays(args.datadir, "train")
    test_arrays = load_avmnist_arrays(args.datadir, "test")
    dev_lo, dev_hi = train_dev_split(train_arrays["image"].shape[0])
    return {
        "train": ArrayLoader(train_arrays, args.batchsize, shuffle=True,
                             indices=np.arange(0, dev_lo)),
        "dev": ArrayLoader(train_arrays, args.batchsize,
                           indices=np.arange(dev_lo, dev_hi)),
        "test": ArrayLoader(test_arrays, args.batchsize),
    }


def build_model(args, configuration, device):
    """The found net with its initial weights drawn from INIT_SEED."""
    import torch

    from mfas_tpu_torch.fusion.avmnist import Searchable_Audio_Image_Net

    return Searchable_Audio_Image_Net(
        args, configuration, device=device,
        generator=torch.Generator().manual_seed(INIT_SEED))


def checkpoint_filename(args, configuration, modelacc):
    """The JAX CLI's name for --save_checkpoint (main_found_avmnist.py:156-160)."""
    confstr = re.sub(r"_\n ", "_",
                     np.array2string(configuration, separator='_'))
    return os.path.join(args.checkpointdir, "final_avmnist_conf_" + confstr
                        + "_" + str(modelacc) + ".checkpoint")


def main(argv=None, device=None):
    """-> main_found_ntu.py::FoundRun."""
    from mfas_tpu_torch.engine.classifier import ClassifierEngine
    from mfas_tpu_torch.main_found_ntu import FoundRun, train_model
    from mfas_tpu_torch.parallel.mesh import is_primary_process
    from mfas_tpu_torch.runtime import checkpoint as ckpt
    from mfas_tpu_torch.runtime.profiler import maybe_profile

    print("Training found AV-MNIST network")
    args = parse_args(argv)
    device = cli_device(device, "mfas_tpu_torch.main_found_avmnist", args)
    pm.initialize_from_args(args, device)
    group = pm.data_group_from_args(args)
    print("The configuration of this run is:")
    print(args)

    if args.conf not in FOUND_CONFS:
        raise SystemExit(f"--conf must be one of {sorted(FOUND_CONFS)} "
                         f"(got {args.conf})")
    configuration = FOUND_CONFS[args.conf]
    model = build_model(args, configuration, device)
    if args.test_cp:
        full = os.path.join(args.checkpointdir, args.test_cp)
        model.load_state_dict(ckpt.load_state_dict(full), strict=True)
    else:
        for attr, cp in (("rgbnet", args.rgb_cp), ("audnet", args.audio_cp)):
            if cp:
                ckpt.load_backbone(os.path.join(args.checkpointdir, cp),
                                   getattr(model, attr),
                                   random_ok=args.random_backbones)

    dataloaders = get_dataloaders(args)
    engine = ClassifierEngine(model, device, multitask=args.multitask,
                              input_keys=("image", "audio"), group=group)
    start_time = time.time()
    with maybe_profile(args.profile_dir, device):
        modelacc, peaks = train_model(engine, model, configuration,
                                      dataloaders, args)
    elapsed = time.time() - start_time
    record = engine.last_eval
    print('Training in {:.0f}m {:.0f}s'.format(elapsed // 60, elapsed % 60))
    print('Eval clips/s: {:.1f} ({} clips on {})'.format(
        record.clips / record.seconds, record.clips, device))
    print('Model Acc: {}'.format(modelacc))

    saved = None
    if args.save_checkpoint and is_primary_process():
        saved = checkpoint_filename(args, configuration, modelacc)
        ckpt.save(model.state_dict(), saved)
        print('Saved ' + saved)
    return FoundRun(acc=modelacc, eval=record, train=engine.train_records,
                    train_peak_bytes=peaks, saved=saved)


if __name__ == "__main__":
    main()
