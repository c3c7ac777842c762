#!/usr/bin/env python3
"""MFAS search on AV-MNIST on the card (port of main_searchable_avmnist.py;
same flags and defaults). Prints the top-5 architectures found.

    python -m mfas_tpu_torch.main_searchable_avmnist --datadir data/avmnist/ \\
        --random_backbones [--randsearch]

runs the EPNAS loop over the 30 one-row unfoldings (audio tap, image tap,
activation) of GP_LeNet_Deeper (spectrograms) and GP_LeNet (digits) at
--channels 32, or with --randsearch the uniform random baseline:
--search_iterations x --max_fusions iterations of --num_samples confs of
random depth. Candidates train together as a population over
frozen-backbone features, extracted every batch with the backbones in train
mode, or once into a device bank with --cache_features (bf16 unless
--f32_features; --int8_feature_bank); --sequential_candidates or
--weightsharing train them one at a time. --search_state F
[--resume_search] makes either search resumable after every step. The
search trains on train[0:50000] and ranks on train[50000:55000] (the last
n//8 rows of a smaller store). The backbones come from --rgb_cp/--audio_cp
in --checkpointdir, or stay random with --random_backbones. --seed seeds
both numpy's and Python's RNGs (the random search draws depths from the
latter).

From the command line the device is CUDA and the run fails without it;
``main(argv, device="cpu")`` runs the same path on the CPU.
``--use_dataparallel`` under ``torchrun`` or the ``--dist_*`` trio (one
process per GPU) splits every batch by rows over the processes;
``--shard_feature_bank`` with ``--cache_features`` splits the bank's rows
over them; only process 0 writes files (parallel/mesh.py).
"""

import argparse

from mfas_tpu_torch.parallel import mesh as pm
from mfas_tpu_torch.parallel.mesh import add_dist_args
from mfas_tpu_torch.runtime.cli import cli_device


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Modality optimization.')
    parser.add_argument('--checkpointdir', type=str, help='output base dir',
                        default='checkpoints/')
    parser.add_argument('--datadir', type=str, help='data directory',
                        default='data/avmnist/')
    parser.add_argument('--audio_cp', type=str,
                        help='Audio net checkpoint (in checkpointdir)', default='')
    parser.add_argument('--rgb_cp', type=str,
                        help='Image net checkpoint (in checkpointdir)', default='')
    parser.add_argument('--num_outputs', type=int, help='output dimension',
                        default=10)
    parser.add_argument('--channels', type=int,
                        help='LeNet base channel width', default=32)
    parser.add_argument('--batchsize', type=int, help='batch size', default=128)
    parser.add_argument('--inner_representation_size', type=int,
                        help='output size of mixing linear layers', default=16)
    parser.add_argument('--epochs', type=int, help='training epochs', default=3)
    parser.add_argument('--lr_surrogate', type=float, default=0.001)
    parser.add_argument('--epochs_surrogate', type=int, default=50)
    parser.add_argument('--eta_max', type=float, help='eta max', default=0.001)
    parser.add_argument('--eta_min', type=float, help='eta min', default=0.000001)
    parser.add_argument('--Ti', type=int, help='epochs Ti', default=1)
    parser.add_argument('--Tm', type=int, help='epochs multiplier Tm', default=2)
    parser.add_argument('--use_dataparallel', action='store_true', default=False)
    parser.add_argument('--num_workers', '--j', type=int, default=16)
    parser.add_argument('--max_fusions', type=int, dest="max_progression_levels",
                        default=4)
    parser.add_argument('--search_iterations', type=int, default=3)
    parser.add_argument('--num_samples', type=int, default=15)
    parser.add_argument('--initial_temperature', type=float, default=10.0)
    parser.add_argument('--final_temperature', type=float, default=0.2)
    parser.add_argument('--temperature_decay', type=float, default=4.0)
    parser.add_argument('--no-verbose', dest='verbose', action='store_false',
                        default=True)
    parser.add_argument('--weightsharing', action='store_true', default=False)
    parser.add_argument('--population_weightsharing', action='store_true',
                        default=False,
                        help='approximate weight sharing inside the fast '
                             'population trainer')
    parser.add_argument('--cache_features', action='store_true', default=False,
                        help='device-resident train-feature bank: extract '
                             'frozen-backbone features once (eval mode) and '
                             'gather shuffled batches from the bank every '
                             'epoch/population')
    parser.add_argument('--bf16_features', action='store_true', default=False,
                        help='bfloat16 frozen-backbone features during search '
                             '(the default whenever --cache_features is on; '
                             'this flag forces bf16 even without the bank)')
    parser.add_argument('--f32_features', action='store_true', default=False,
                        help='force float32 frozen-backbone features, '
                             'overriding the bf16-under---cache_features '
                             'default')
    parser.add_argument('--shard_feature_bank', action='store_true',
                        default=False,
                        help='with --cache_features on several devices: '
                             'shard the bank rows over them')
    parser.add_argument('--int8_feature_bank', action='store_true',
                        default=False,
                        help='with --cache_features: store the bank '
                             'symmetric-int8 with per-row f32 scales (2x '
                             'the bank capacity of the bf16 default)')
    parser.add_argument('--bank_batch', type=int, default=None,
                        help='target sample count for the eval-mode '
                             'feature-extraction passes (feature bank '
                             'build + dev features): consecutive loader '
                             'batches are concatenated up to this size '
                             'before the backbone forward (features are '
                             'identical)')
    parser.add_argument('--no_fused_epochs', action='store_true',
                        default=False,
                        help='with --cache_features, run each epoch per '
                             'loader batch with a dev-feature cache instead '
                             'of the fused loop over the train and dev banks')
    parser.add_argument('--alphas', action='store_true', default=False)
    parser.add_argument('--batchnorm', action='store_true', default=False)
    parser.add_argument('--multitask', action='store_true', default=False)
    parser.add_argument('--randsearch', action='store_true', default=False,
                        help='uniform random search baseline instead of EPNAS')
    parser.add_argument("--drpt", action="store", default=0.5, dest="drpt",
                        type=float)
    # additive flags (not in the reference)
    parser.add_argument('--seed', type=int, default=None)
    parser.add_argument('--sequential_candidates', action='store_true',
                        default=False)
    parser.add_argument('--random_backbones', action='store_true', default=False)
    parser.add_argument('--search_state', type=str, default='')
    parser.add_argument('--resume_search', action='store_true', default=False)
    parser.add_argument('--jsonl_log', type=str, default='')
    add_dist_args(parser)
    return parser.parse_args(argv)


def main(argv=None, device=None):
    """-> search/searcher.py::SearchRun."""
    from mfas_tpu_torch.search.searcher import run_search
    from mfas_tpu_torch.search.searchers import AVMNISTSearcher

    args = parse_args(argv)
    device = cli_device(device, "mfas_tpu_torch.main_searchable_avmnist", args)
    pm.initialize_from_args(args, device)
    pm.require_shared_seed(args)
    group = pm.data_group_from_args(args)
    return run_search(args, "AV-MNIST", device,
                      lambda timer: AVMNISTSearcher(
                          args, device=device, group=group,
                          jsonl_log=args.jsonl_log or None, timer=timer))


if __name__ == "__main__":
    main()
