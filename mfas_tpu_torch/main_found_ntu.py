#!/usr/bin/env python3
"""Train and test a found NTU fusion architecture on the card (port of
main_found_ntu.py; same flags and defaults).

    python -m mfas_tpu_torch.main_found_ntu --packed_datadir packed/ \\
        --hbm_resident --conf 4 --batchnorm --random_backbones

trains the found net in two phases (reference :94-157) and evaluates it on
the test split: one epoch of the central weights only (fusion layers and
classifier, backbones frozen but in train mode) from the per-batch cosine
schedule, then the whole net for --epochs epochs with a fresh Adam and
schedule; each phase keeps its best dev state. ``--test_cp net.checkpoint``
skips training and evaluates a full checkpoint (``torch.save`` of a
state_dict, or the JAX package's checkpoint writer). The backbones come from
--ske_cp/--rgb_cp in --checkpointdir, or stay random with
--random_backbones. Options: --bf16 (autocast compute, f32 parameters and
Adam), --remat (recompute activations in backward), --conv_channels_last
(the model's convolution weights and activations in NHWC / NDHWC memory
format, core/functional.py; the checkpoints written stay contiguous),
--train_state F [--resume] (per-epoch resumable state; a resume skips
phase 1), --save_checkpoint, --profile_dir D.

The input comes from the raw NTU layout under --datadir (AVIs decoded by
cv2, skeletons parsed by the native C++ reader; the default), or from a
packed store under --packed_datadir (subdirs train/dev/test, written by
``python -m mfas_tpu_torch.tools.pack_ntu``): normalized on the host by the
native reader (the default), streamed as raw uint8 clips normalized on the
card (``--device_input_normalize``, kernel K1), or copied to the card once
and gathered there (``--hbm_resident``, kernel K2).

Several GPUs (parallel/mesh.py): ``--use_dataparallel`` under ``torchrun
--nproc_per_node N`` or with the ``--dist_coordinator host:port
--dist_num_processes N --dist_process_id i`` trio (one process per GPU)
splits every batch by rows over the N processes; ``--shard_resident_store``
splits the ``--hbm_resident`` store's samples over them too (the batch is
then read by a gather over the group and K1). Every process prints the same
numbers; only process 0 writes ``--save_checkpoint`` and the train state.

From the command line the device is CUDA and the run fails without it;
``main(argv, device="cpu")`` runs the same path on the CPU with the kernels'
plain versions.
"""

import argparse
import dataclasses
import os
import re
import time

import numpy as np

from mfas_tpu_torch.parallel import mesh as pm
from mfas_tpu_torch.parallel.mesh import add_dist_args
from mfas_tpu_torch.runtime.cli import cli_device


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Modality optimization.")
    parser.add_argument('--checkpointdir', type=str, help='output base dir',
                        default='checkpoints/')
    parser.add_argument('--datadir', type=str, help='data directory',
                        default='data/NTU/')
    parser.add_argument('--ske_cp', type=str,
                        help='Skeleton net checkpoint (in checkpointdir)',
                        default='skeleton_32frames_85.24.checkpoint')
    parser.add_argument('--rgb_cp', type=str,
                        help='RGB net checkpoint (in checkpointdir)',
                        default='rgb_8frames_83.91.checkpoint')
    parser.add_argument('--test_cp', type=str,
                        help='Full net checkpoint (in checkpointdir)', default='')
    parser.add_argument('--num_outputs', type=int, help='output dimension', default=60)
    parser.add_argument('--batchsize', type=int, help='batch size', default=20)
    parser.add_argument('--inner_representation_size', type=int,
                        help='output size of mixing linear layers', default=256)
    parser.add_argument('--epochs', type=int, help='training epochs', default=70)
    parser.add_argument('--eta_max', type=float, help='eta max', default=0.001)
    parser.add_argument('--eta_min', type=float, help='eta min', default=0.000001)
    parser.add_argument('--Ti', type=int, help='epochs Ti', default=5)
    parser.add_argument('--Tm', type=int, help='epochs multiplier Tm', default=2)
    parser.add_argument('--use_dataparallel', help='Use several GPUs',
                        action='store_true', dest='use_dataparallel', default=False)
    parser.add_argument('--j', dest='num_workers', type=int,
                        help='Dataloader CPUS', default=16)
    parser.add_argument('--modality', type=str, help='', default='both')
    parser.add_argument('--no-verbose', help='verbose', action='store_false',
                        dest='verbose', default=True)
    parser.add_argument('--weightsharing', help='Weight sharing',
                        action='store_true', default=False)
    parser.add_argument('--no-multitask', dest='multitask', help='Multitask loss',
                        action='store_false', default=True)
    parser.add_argument('--alphas', help='Use alphas', action='store_true',
                        default=False)
    parser.add_argument('--batchnorm', help='Use batch norm', action='store_true',
                        dest='batchnorm', default=False)
    parser.add_argument("--vid_dim", action="store", default=256, dest="vid_dim",
                        help="frame side dimension (square image assumed) ")
    parser.add_argument("--vid_fr", action="store", default=30, dest="vi_fr",
                        help="video frame rate")
    parser.add_argument("--vid_len", action="store", default=(8, 32),
                        dest="vid_len", type=int, nargs='+',
                        help="length of video, as a tuple of two lengths, "
                             "(rgb len, skel len)")
    parser.add_argument("--drpt", action="store", default=0.4, dest="drpt",
                        type=float, help="dropout")
    parser.add_argument('--no_bad_skel', action="store_true",
                        help='Remove the 300 bad samples, espec. useful to evaluate',
                        default=False)
    parser.add_argument("--no_norm", action="store_true", default=False,
                        dest="no_norm", help="Not normalizing the skeleton")
    parser.add_argument('--conf', type=int, help='conf to train', default=1)
    # additive flags (not in the reference)
    parser.add_argument('--random_backbones', action='store_true', default=False,
                        help='smoke-run without pretrained backbone checkpoints')
    parser.add_argument('--save_checkpoint', action='store_true', default=False,
                        help='save the final model (conf+acc filename, torch format)')
    parser.add_argument('--profile_dir', type=str, default='',
                        help='capture a profiler trace here')
    parser.add_argument('--bf16', action='store_true', default=False,
                        help='bfloat16 compute (float32 params/optimizer)')
    parser.add_argument('--remat', action='store_true', default=False,
                        help='recompute the forward in backward (saves memory)')
    parser.add_argument('--conv_channels_last', action='store_true',
                        default=False,
                        help='convolutions in NHWC/NDHWC memory format '
                             '(cuDNN\'s native layout); parameters keep '
                             'their torch shapes')
    parser.add_argument('--packed_datadir', type=str, default='',
                        help='directory of packed stores, subdirs '
                             'train/dev/test; bypasses AVI decode')
    parser.add_argument('--device_input_normalize', action='store_true',
                        default=False,
                        help='ship raw uint8 clips and normalize them on the '
                             'card (kernel K1; needs --packed_datadir)')
    parser.add_argument('--hbm_resident', action='store_true', default=False,
                        help='copy the packed store to device memory once; '
                             'batches become index plans and the gather + '
                             'temporal resample + normalize run on the card '
                             '(kernel K2; needs --packed_datadir)')
    parser.add_argument('--shard_resident_store', action='store_true',
                        default=False,
                        help='with --hbm_resident on several devices: split '
                             'the store over them')
    parser.add_argument('--resnet3d_layers', type=int, nargs=4,
                        default=(3, 4, 6, 3), metavar='N',
                        help='blocks per inflated-ResNet stage (shrink knob '
                             'for tests/small deployments; the reference '
                             'architecture is 3 4 6 3)')
    parser.add_argument('--resnet3d_base_width', type=int, default=64,
                        help='inflated-ResNet stem width (shrink knob; '
                             'reference 64 — tap widths scale with it)')
    parser.add_argument('--train_state', type=str, default='',
                        help='per-epoch resumable training state path')
    parser.add_argument('--resume', action='store_true', default=False,
                        help='resume from --train_state if present')
    add_dist_args(parser)
    return parser.parse_args(argv)


# found architectures (reference main_found_ntu.py:173-182)
FOUND_CONFS = {
    0: np.array([[2, 2, 0], [1, 0, 1], [3, 2, 0], [3, 1, 1]]),
    1: np.array([[3, 0, 0], [1, 3, 0], [1, 1, 1], [3, 3, 0]]),
    2: np.array([[3, 2, 0], [2, 3, 1], [0, 1, 1], [3, 0, 0]]),
    3: np.array([[1, 1, 1], [3, 2, 0], [0, 1, 1], [3, 0, 0]]),
    4: np.array([[3, 1, 1], [1, 3, 0], [1, 1, 1], [3, 3, 0]]),
}

# the initial weights' seed (the JAX CLI's model.init(0)); dropout draws
# from the engine's generator, seeded apart from it
INIT_SEED = 0


def get_dataloaders(args, device, group=None):
    from mfas_tpu_torch.data import ntu as d
    from mfas_tpu_torch.data.loader import MapLoader

    tfm_val = d.Compose([d.NormalizeLen(args.vid_len)])
    tfm_tra = d.Compose([d.AugCrop(), d.NormalizeLen(args.vid_len)])

    if args.hbm_resident:
        if not args.packed_datadir:
            raise SystemExit('--hbm_resident needs --packed_datadir (build '
                             'one with mfas_tpu_torch.tools.pack_ntu)')
        from mfas_tpu_torch.data.resident import (ResidentLoader,
                                                  ResidentNTUStore)
        shard = group if args.shard_resident_store else None
        return {k: ResidentLoader(
            ResidentNTUStore(os.path.join(args.packed_datadir, k), device,
                             args=args, shard=shard),
            args.batchsize, transform=(tfm_tra if k == 'train' else tfm_val),
            shuffle=(k == 'train'))
            for k in ('train', 'dev', 'test')}

    if args.packed_datadir:
        from mfas_tpu_torch.data.ntu_pack import PackedNTU
        datasets = {
            k: PackedNTU(os.path.join(args.packed_datadir, k),
                         transform=(tfm_tra if k == 'train' else tfm_val),
                         args=args,
                         device_normalize=args.device_input_normalize)
            for k in ('train', 'dev', 'test')
        }
    else:
        # vid_dim/vi_fr forwarded, as the JAX CLI does
        datasets = {
            k: d.NTU(args.datadir,
                     transform=(tfm_tra if k == 'train' else tfm_val),
                     stage=k, vid_dim=int(args.vid_dim),
                     vid_fr=int(args.vi_fr), args=args)
            for k in ('train', 'dev', 'test')
        }
    return {k: MapLoader(v, args.batchsize, shuffle=(k == 'train'),
                         num_workers=args.num_workers)
            for k, v in datasets.items()}


def build_model(args, configuration, device):
    """The found net with its initial weights drawn from INIT_SEED."""
    import torch

    from mfas_tpu_torch.fusion.ntu import Searchable_Skeleton_Image_Net

    return Searchable_Skeleton_Image_Net(
        args, configuration, device=device,
        generator=torch.Generator().manual_seed(INIT_SEED))


def make_engine(model, args, device, group=None, store=None):
    """The classifier engine with this run's batch prep (K1 or K2, in the
    compute dtype), precision, remat and data group. Host-normalized clips
    (raw AVI or the packed store's default) are float32: the prep only
    casts them, and K1 launches only on --device_input_normalize's uint8
    clips. ``store``: a resident split's store (a sharded one turns K2
    off)."""
    import torch

    from mfas_tpu_torch.engine.classifier import ClassifierEngine

    compute_dtype = torch.bfloat16 if args.bf16 else None
    if args.hbm_resident:
        from mfas_tpu_torch.data.resident import make_resident_prep
        batch_prep = make_resident_prep(no_norm=args.no_norm,
                                        fuse_gather=True,
                                        compute_dtype=compute_dtype,
                                        store=store)
    else:
        if args.device_input_normalize and not args.packed_datadir:
            print('WARNING: --device_input_normalize needs --packed_datadir '
                  '(mfas_tpu_torch.tools.pack_ntu) — ignored; this run '
                  'normalizes on the host')
        from mfas_tpu_torch.data.ntu_pack import make_device_normalize_prep
        batch_prep = make_device_normalize_prep(compute_dtype)
    return ClassifierEngine(model, device, multitask=args.multitask,
                            input_keys=("rgb", "ske"), batch_prep=batch_prep,
                            compute_dtype=compute_dtype, remat=args.remat,
                            group=group)


def train_phase(engine, what, *args, **kw):
    """One ``engine.train_track_acc`` call; prints its train clips/s and,
    on the card, the peak allocated memory of the call, which it returns
    beside the call's result."""
    import torch

    cuda = engine.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(engine.device)
    result = engine.train_track_acc(*args, **kw)
    peak = torch.cuda.max_memory_allocated(engine.device) if cuda else None
    record = engine.train_records[-1]
    if record.train_seconds:
        print("{} train clips/s: {:.2f} ({} clips in {:.3f} s on {}{})".format(
            what, record.train_clips / record.train_seconds,
            record.train_clips, record.train_seconds, engine.device,
            "" if peak is None else
            ", peak {:.2f} GiB allocated".format(peak / 2**30)))
    return result, peak


def train_model(engine, model, configuration, dataloaders, args,
                state_path=None, resume=False):
    """The two training phases (unless --test_cp), then the test split;
    returns the test accuracy and the peak allocated device memory of each
    training phase run (main_found_ntu.py:190-264). With ``state_path``
    phase 2 writes its per-epoch train state there, and ``resume`` resumes
    from it (skipping phase 1) when it exists."""
    from mfas_tpu_torch.core.sched import LRCosineAnnealingScheduler

    sizes = {k: dl.dataset_size for k, dl in dataloaders.items()}
    trainval = {k: dataloaders[k] for k in ('train', 'dev')}
    peaks = []
    if args.test_cp == '':
        nbpe = sizes['train'] / args.batchsize

        resuming = resume and state_path and os.path.exists(state_path)
        if resuming:
            # phase 2's resume load replaces the whole training state, so
            # the phase-1 central pretrain would be an epoch of wasted work
            if args.verbose:
                print('Resuming phase 2 from ' + state_path
                      + ' (central pretrain skipped)')
        else:
            if args.verbose:
                print('Pretraining central weights: ')
                print(configuration)
            scheduler = LRCosineAnnealingScheduler(
                args.eta_max, args.eta_min, args.Ti, args.Tm, nbpe)
            (interm_acc, _), peak = train_phase(
                engine, "Phase 1 (central weights)", model.central_params(),
                trainval, sizes, scheduler, num_epochs=1,
                print_loss=args.verbose)
            peaks.append(peak)
            if args.verbose:
                print('Intermediate val accuracy: ' + str(interm_acc))

        scheduler = LRCosineAnnealingScheduler(
            args.eta_max, args.eta_min, args.Ti, args.Tm, nbpe)
        (best_acc, _), peak = train_phase(
            engine, "Phase 2 (whole net)", None, trainval, sizes, scheduler,
            num_epochs=args.epochs, print_loss=args.verbose,
            state_path=state_path, resume=resume)
        peaks.append(peak)
        if args.verbose:
            print('Final val accuracy: ' + str(best_acc))

    test = dataloaders['test']
    test_acc = engine.test_track_acc(test, sizes['test'])
    if args.verbose:
        print('Final test accuracy: ' + str(test_acc))
    return test_acc, peaks


def checkpoint_filename(args, configuration, modelacc):
    """The JAX CLI's name for --save_checkpoint (main_found_ntu.py:317-326)."""
    confstr = np.array2string(configuration, precision=1, separator='_',
                              suppress_small=True)
    confstr = re.sub(r"_\n ", "_", confstr)
    return os.path.join(args.checkpointdir, "final_conf_" + confstr + "_"
                        + str(modelacc) + ".checkpoint")


@dataclasses.dataclass
class FoundRun:
    """What ``main`` returns: the test accuracy, the test pass's
    EvalRecord, one TrainRecord per training phase run and that phase's
    peak allocated device memory (None off the card), and the path
    --save_checkpoint wrote (or None)."""
    acc: float
    eval: object
    train: list
    train_peak_bytes: list
    saved: str | None = None


def main(argv=None, device=None):
    """The CLI. --conv_channels_last holds the option for this call only
    (the JAX CLI sets it for the rest of the process)."""
    from mfas_tpu_torch.core.functional import layout_options

    print("Training found NTU network")
    args = parse_args(argv)
    device = cli_device(device, "mfas_tpu_torch.main_found_ntu", args)
    options = {"conv_channels_last": True} if args.conv_channels_last else {}
    with layout_options(**options):
        return _main(args, device)


def _main(args, device):
    from mfas_tpu_torch.core.layers import to_channels_last
    from mfas_tpu_torch.parallel.mesh import is_primary_process
    from mfas_tpu_torch.runtime import checkpoint as ckpt
    from mfas_tpu_torch.runtime.profiler import maybe_profile

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
        ckpt.load_backbone(os.path.join(args.checkpointdir, args.ske_cp),
                           model.skenet, random_ok=args.random_backbones)
        ckpt.load_backbone(os.path.join(args.checkpointdir, args.rgb_cp),
                           model.rgbnet, random_ok=args.random_backbones)
    if args.conv_channels_last:
        # once, so no step copies a weight (gradients and Adam's moments
        # take the parameters' strides)
        to_channels_last(model)

    dataloaders = get_dataloaders(args, device, group)
    engine = make_engine(model, args, device, group,
                         getattr(dataloaders["train"], "store", None))
    start_time = time.time()
    with maybe_profile(args.profile_dir, device):
        modelacc, peaks = train_model(engine, model, configuration,
                                      dataloaders, args,
                                      args.train_state or None, args.resume)
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
