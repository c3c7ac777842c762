#!/usr/bin/env python3
"""Evaluate a found NTU fusion architecture on the card (port of
main_found_ntu.py's --test_cp path; same flags and defaults).

    python -m mfas_tpu_torch.main_found_ntu --test_cp net.checkpoint \\
        --checkpointdir ckpt/ --packed_datadir packed/ --hbm_resident \\
        --conf 4 --batchnorm

loads a full checkpoint (``torch.save(model.state_dict())`` or the JAX
package's checkpoint writer) into a freshly built model on the card and
prints ``Model Acc: <float>`` for the test split. The input comes from a
packed store (subdirs train/dev/test), either streamed as raw uint8 clips
normalized on the card (``--device_input_normalize``, kernel K1) or copied to
the card once and gathered there (``--hbm_resident``, kernel K2).

From the command line the device is CUDA and the run fails without it;
``main(argv, device="cpu")`` runs the same path on the CPU with the kernels'
plain versions. Flags whose feature is not ported yet stop the run and name
their ROADMAP.md item.
"""

import argparse
import os
import time

import numpy as np


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
                        help='TPU convolution layout toggle of the JAX '
                             'package; not carried by this port')
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
    parser.add_argument('--dist_coordinator', type=str, default=None,
                        help='multi-host: host:port of process 0')
    parser.add_argument('--dist_num_processes', type=int, default=None)
    parser.add_argument('--dist_process_id', type=int, default=None)
    return parser.parse_args(argv)


# found architectures (reference main_found_ntu.py:173-182)
FOUND_CONFS = {
    0: np.array([[2, 2, 0], [1, 0, 1], [3, 2, 0], [3, 1, 1]]),
    1: np.array([[3, 0, 0], [1, 3, 0], [1, 1, 1], [3, 3, 0]]),
    2: np.array([[3, 2, 0], [2, 3, 1], [0, 1, 1], [3, 0, 0]]),
    3: np.array([[1, 1, 1], [3, 2, 0], [0, 1, 1], [3, 0, 0]]),
    4: np.array([[3, 1, 1], [1, 3, 0], [1, 1, 1], [3, 3, 0]]),
}

_TRAINING = "ROADMAP.md §1 'Found-architecture training'"
_NATIVE_IO = "ROADMAP.md §1 'NTU raw-AVI and native IO path'"
_RUNTIME = "ROADMAP.md §1 'Checkpoints, export and profiling'"
_MULTI_GPU = "ROADMAP.md §1 'Multi-GPU'"


def _reject_unported(args):
    """Stop on a flag whose feature the port does not have yet."""
    dist = any(getattr(args, k) is not None for k in
               ("dist_coordinator", "dist_num_processes", "dist_process_id"))
    packed_host_norm = (args.packed_datadir and not args.hbm_resident
                        and not args.device_input_normalize)
    checks = [
        (not args.test_cp, "training (a run without --test_cp)", _TRAINING),
        (args.bf16, "--bf16", _TRAINING),
        (args.remat, "--remat", _TRAINING),
        (args.train_state or args.resume, "--train_state/--resume",
         _TRAINING),
        (args.save_checkpoint, "--save_checkpoint", _RUNTIME),
        (args.profile_dir, "--profile_dir", _RUNTIME),
        (args.use_dataparallel, "--use_dataparallel", _MULTI_GPU),
        (dist, "--dist_*", _MULTI_GPU),
        (args.shard_resident_store, "--shard_resident_store", _MULTI_GPU),
        (not args.packed_datadir, "the raw-AVI --datadir input (no "
         "--packed_datadir)", _NATIVE_IO),
        (packed_host_norm, "--packed_datadir normalized on the host (neither "
         "--device_input_normalize nor --hbm_resident)", _NATIVE_IO),
    ]
    for bad, what, item in checks:
        if bad:
            raise SystemExit(f"{what} is not ported to mfas_tpu_torch yet: "
                             f"see {item}")
    if args.conv_channels_last:
        raise SystemExit("--conv_channels_last is a TPU convolution layout "
                         "toggle of the JAX package; mfas_tpu_torch does not "
                         "carry it (ROADMAP.md §1, 'Not ported')")


def get_dataloaders(args, device):
    from mfas_tpu_torch.data import ntu as d
    from mfas_tpu_torch.data.loader import MapLoader

    tfm_val = d.Compose([d.NormalizeLen(args.vid_len)])
    tfm_tra = d.Compose([d.AugCrop(), d.NormalizeLen(args.vid_len)])
    if not args.packed_datadir:
        raise SystemExit(f"the raw-AVI --datadir input is not ported yet: "
                         f"see {_NATIVE_IO}")

    if args.hbm_resident:
        from mfas_tpu_torch.data.resident import (ResidentLoader,
                                                  ResidentNTUStore)
        return {k: ResidentLoader(
            ResidentNTUStore(os.path.join(args.packed_datadir, k), device,
                             args=args),
            args.batchsize, transform=(tfm_tra if k == 'train' else tfm_val),
            shuffle=(k == 'train'))
            for k in ('train', 'dev', 'test')}

    from mfas_tpu_torch.data.ntu_pack import PackedNTU
    datasets = {
        k: PackedNTU(os.path.join(args.packed_datadir, k),
                     transform=(tfm_tra if k == 'train' else tfm_val),
                     args=args, device_normalize=args.device_input_normalize)
        for k in ('train', 'dev', 'test')
    }
    return {k: MapLoader(v, args.batchsize, shuffle=(k == 'train'),
                         num_workers=args.num_workers)
            for k, v in datasets.items()}


def evaluate(model, dataloaders, args, device):
    """The test split's accuracy; returns (acc, engine.last_eval)."""
    from mfas_tpu_torch.engine.classifier import ClassifierEngine

    if args.hbm_resident:
        from mfas_tpu_torch.data.resident import make_resident_prep
        batch_prep = make_resident_prep(no_norm=args.no_norm, fuse_gather=True)
    else:
        from mfas_tpu_torch.data.ntu_pack import make_device_normalize_prep
        batch_prep = make_device_normalize_prep()
    engine = ClassifierEngine(model, device, multitask=args.multitask,
                              input_keys=("rgb", "ske"),
                              batch_prep=batch_prep)
    test = dataloaders['test']
    test_acc = engine.test_track_acc(test, test.dataset_size)
    if args.verbose:
        print('Final test accuracy: ' + str(test_acc))
    return test_acc, engine.last_eval


def main(argv=None, device=None):
    """Returns (test accuracy, the EvalRecord of the test pass)."""
    import torch

    from mfas_tpu_torch.fusion.ntu import Searchable_Skeleton_Image_Net
    from mfas_tpu_torch.runtime.checkpoint import load_state_dict

    print("Evaluating found NTU network")
    args = parse_args(argv)
    _reject_unported(args)
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("mfas_tpu_torch.main_found_ntu needs a CUDA "
                             "device")
        device = "cuda"
    device = torch.device(device)
    print("The configuration of this run is:")
    print(args)

    if args.conf not in FOUND_CONFS:
        raise SystemExit(f"--conf must be one of {sorted(FOUND_CONFS)} "
                         f"(got {args.conf})")
    configuration = FOUND_CONFS[args.conf]
    model = Searchable_Skeleton_Image_Net(
        args, configuration, device=device,
        generator=torch.Generator().manual_seed(0))
    full = os.path.join(args.checkpointdir, args.test_cp)
    model.load_state_dict(load_state_dict(full), strict=True)

    dataloaders = get_dataloaders(args, device)
    start_time = time.time()
    modelacc, record = evaluate(model, dataloaders, args, device)
    elapsed = time.time() - start_time
    print('Evaluation in {:.0f}m {:.0f}s'.format(elapsed // 60, elapsed % 60))
    print('Eval clips/s: {:.1f} ({} clips on {})'.format(
        record.clips / record.seconds, record.clips, device))
    print('Model Acc: {}'.format(modelacc))
    return modelacc, record


if __name__ == "__main__":
    main()
