#!/usr/bin/env python3
"""Train and test an MM-IMDB image+text fusion network on the card (port of
main_found_mmimdb.py; same flags and defaults).

    python -m mfas_tpu_torch.main_found_mmimdb --datadir data/mmimdb_np/ \\
        --text_first_hidden 256

trains --model (default vggt_centralnet_v2: a VGG-19 poster trunk, the
maxout text net over the mean GloVe vector and a gated CentralNet) for
--epochs epochs on the train split, keeping the best dev samples-F1 state,
and prints the test split's samples-F1. The VGG CentralNets need
``2 * --text_first_hidden <= 512``, which the CLI's default 512 breaks (in
the JAX package too): pass --text_first_hidden 256. ``--test_cp F`` skips
training and evaluates a full checkpoint; ``--vgg_cp F`` loads torchvision
vgg19 weights into the trunk; ``--central_only`` trains the central
(fusion) parameters only; ``--save_checkpoint`` writes
``mmimdb_<model>_<f1>.checkpoint``.

From the command line the device is CUDA and the run fails without it;
``main(argv, device="cpu")`` runs the same path on the CPU.
``--use_dataparallel`` under ``torchrun`` or the ``--dist_*`` trio (one
process per GPU) splits every batch by rows over the processes;
only process 0 writes files (parallel/mesh.py).
"""

import argparse
import os
import time

from mfas_tpu_torch.parallel import mesh as pm
from mfas_tpu_torch.parallel.mesh import add_dist_args
from mfas_tpu_torch.runtime.cli import cli_device


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='MM-IMDB fusion.')
    parser.add_argument('--checkpointdir', type=str, default='checkpoints/')
    parser.add_argument('--datadir', type=str, default='data/mmimdb_np/')
    parser.add_argument('--test_cp', type=str, default='')
    parser.add_argument('--vgg_cp', type=str, default='',
                        help='torchvision vgg19 checkpoint for the GP_VGG trunk')
    parser.add_argument('--model', type=str, default='vggt_centralnet_v2',
                        choices=['simplevt', 'vggvt', 'simplevt_centralnet',
                                 'vggt_centralnet', 'vggt_centralnet_v2'])
    parser.add_argument('--num_outputs', type=int, default=23)
    parser.add_argument('--channels', type=int, default=512)
    parser.add_argument('--text_first_hidden', type=int, default=512)
    parser.add_argument('--fusingmix', type=str, default='13,24')
    parser.add_argument('--fusetype', type=str, default='cat')
    parser.add_argument('--pos_weight', type=float, default=2.0)
    parser.add_argument('--th_fscore', type=float, default=0.3)
    parser.add_argument('--stable_bce', action='store_true', default=False,
                        help='exact logsumexp BCE instead of the reference '
                             'formula (which overflow-NaNs at |logit|~90)')
    parser.add_argument('--batchsize', type=int, default=64)
    parser.add_argument('--epochs', type=int, default=50)
    parser.add_argument('--eta_max', type=float, default=0.001)
    parser.add_argument('--eta_min', type=float, default=0.000001)
    parser.add_argument('--Ti', type=int, default=5)
    parser.add_argument('--Tm', type=int, default=2)
    parser.add_argument('--feat_dim', type=int, default=300,
                        help='GloVe feature dimension of the text npy files')
    parser.add_argument('--average_text',
                        action=argparse.BooleanOptionalAction,
                        default=True,
                        help='mean-pool the GloVe sequence to one 300-d vector; --no-average_text feeds the padded (T, 300) sequence path')
    parser.add_argument('--train_size', type=int, default=None)
    parser.add_argument('--dev_size', type=int, default=None)
    parser.add_argument('--test_size', type=int, default=None)
    parser.add_argument('--central_only', action='store_true', default=False,
                        help='train only central_params (frozen backbones)')
    parser.add_argument('--no-verbose', dest='verbose', action='store_false',
                        default=True)
    parser.add_argument('--save_checkpoint', action='store_true', default=False)
    parser.add_argument('--use_dataparallel', action='store_true',
                        default=False,
                        help='batch-shard over a mesh of all visible '
                             'devices (the DataParallel equivalent)')
    add_dist_args(parser)
    return parser.parse_args(argv)


# the initial weights' seed (the JAX CLI's model.init(0)); dropout draws
# from the engine's generator, seeded apart from it
INIT_SEED = 0


def build_model(args, device):
    """--model with its initial weights drawn from INIT_SEED."""
    import torch

    from mfas_tpu_torch.models import mm_imdb as M

    cls = {'simplevt': M.SimpleVTNet, 'vggvt': M.VGGVTNet,
           'simplevt_centralnet': M.SimpleVT_CentralNet,
           'vggt_centralnet': M.VGGT_CentralNet,
           'vggt_centralnet_v2': M.VGGT_CentralNetV2}[args.model]
    return cls(args, args.text_first_hidden, 3, device=device,
               generator=torch.Generator().manual_seed(INIT_SEED))


def load_vgg_trunk(model, path):
    """torchvision vgg19 weights ('features.N.*') into the model's VGG
    trunk, strict keys."""
    from mfas_tpu_torch.models.vgg import remap_torchvision_vgg_keys
    from mfas_tpu_torch.runtime import checkpoint as ckpt

    vgg = getattr(getattr(model, "image_net", None), "vgg", None)
    if vgg is None:
        raise SystemExit("--vgg_cp: this --model has no VGG trunk")
    flat = remap_torchvision_vgg_keys(ckpt.load_state_dict(path))
    vgg.load_state_dict({k[len("vgg."):]: v for k, v in flat.items()},
                        strict=True)


def main(argv=None, device=None):
    """-> main_found_ntu.py::FoundRun, with the test samples-F1 as its
    ``acc``."""
    import torch

    from mfas_tpu_torch.core.sched import LRCosineAnnealingScheduler
    from mfas_tpu_torch.data.mm_imdb import MM_IMDB, MMIMDBLoader
    from mfas_tpu_torch.engine.mmimdb import MMIMDBEngine
    from mfas_tpu_torch.main_found_ntu import FoundRun
    from mfas_tpu_torch.parallel.mesh import is_primary_process
    from mfas_tpu_torch.runtime import checkpoint as ckpt

    print("Training MM-IMDB fusion network")
    args = parse_args(argv)
    device = cli_device(device, "mfas_tpu_torch.main_found_mmimdb", args)
    pm.initialize_from_args(args, device)
    group = pm.data_group_from_args(args)
    print("The configuration of this run is:")
    print(args)

    if not args.average_text:
        raise SystemExit(
            "--no-average_text: every CLI --model choice consumes a "
            "mean-pooled 300-d text vector; the padded (T, 300) sequence "
            "path is a library-level capability (data.mm_imdb collate + "
            "models.mm_imdb.SimpleRecurrentModel)")
    model = build_model(args, device)
    if args.vgg_cp:
        load_vgg_trunk(model, os.path.join(args.checkpointdir, args.vgg_cp))
        print("Loaded VGG19 trunk from", args.vgg_cp)
    if args.test_cp:
        model.load_state_dict(ckpt.load_state_dict(
            os.path.join(args.checkpointdir, args.test_cp)), strict=True)

    loaders, sizes = {}, {}
    for stage, size in (("train", args.train_size), ("dev", args.dev_size),
                        ("test", args.test_size)):
        ds = MM_IMDB(args.datadir, stage=stage, feat_dim=args.feat_dim,
                     average_text=args.average_text, len_data=size)
        loaders[stage] = MMIMDBLoader(ds, args.batchsize,
                                      shuffle=(stage == "train"))
        sizes[stage] = len(ds)

    engine = MMIMDBEngine(model, device, pos_weight=args.pos_weight,
                          th_fscore=args.th_fscore,
                          stable_bce=args.stable_bce, group=group)
    cuda = device.type == "cuda"
    peaks = []
    start = time.time()
    if not args.test_cp:
        sched = LRCosineAnnealingScheduler(args.eta_max, args.eta_min,
                                           args.Ti, args.Tm,
                                           sizes["train"] / args.batchsize)
        prefixes = model.central_params() if args.central_only else None
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        best_f1, _ = engine.train_track_f1(
            prefixes, {k: loaders[k] for k in ("train", "dev")}, sizes,
            sched, num_epochs=args.epochs, verbose=args.verbose)
        peaks.append(torch.cuda.max_memory_allocated(device) if cuda
                     else None)
        print('Best dev F1: {}'.format(best_f1))

    test_f1 = engine.test_track_f1(loaders["test"])
    elapsed = time.time() - start
    record = engine.last_eval
    print('Training in {:.0f}m {:.0f}s'.format(elapsed // 60, elapsed % 60))
    print('Eval samples/s: {:.1f} ({} samples on {})'.format(
        record.clips / record.seconds, record.clips, device))
    print('Model F1: {}'.format(test_f1))

    saved = None
    if args.save_checkpoint and is_primary_process():
        saved = os.path.join(args.checkpointdir,
                             f"mmimdb_{args.model}_{test_f1:.4f}.checkpoint")
        ckpt.save(model.state_dict(), saved)
        print('Saved ' + saved)
    return FoundRun(acc=test_f1, eval=record, train=engine.train_records,
                    train_peak_bytes=peaks, saved=saved)


if __name__ == "__main__":
    main()
