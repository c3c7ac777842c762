#!/usr/bin/env python3
"""MFAS search on NTU on the card (port of main_searchable_ntu.py; same
flags and defaults). Prints the top-5 architectures found.

    python -m mfas_tpu_torch.main_searchable_ntu --packed_datadir packed/ \\
        --device_input_normalize --random_backbones

runs the EPNAS loop: --search_iterations x --max_fusions progressive steps;
the first step trains all 32 one-row confs, every later one trains the
--num_samples confs temperature-sampled from the LSTM surrogate's scores,
and the surrogate refits on every trained conf. Candidates train together
as a population over frozen-backbone features, extracted every batch with
the backbones in train mode, or once into a device bank with
--cache_features (bf16 unless --f32_features; --int8_feature_bank);
--sequential_candidates or --weightsharing train them one at a time.
--search_state F [--resume_search] makes the search resumable after every
step. The input is the raw NTU layout under --datadir (cv2 decode, native
C++ skeleton reader; the default) or a packed store under --packed_datadir
with the subdirs trainexp/ and dev/, normalized on the host by the native
reader, or with --device_input_normalize streamed as uint8 clips that
kernel K1 normalizes on the card. The backbones come from
--ske_cp/--rgb_cp in --checkpointdir, or stay random with
--random_backbones.

From the command line the device is CUDA and the run fails without it;
``main(argv, device="cpu")`` runs the same path on the CPU with the kernels'
plain versions. ``--use_dataparallel`` under ``torchrun`` or the
``--dist_*`` trio (one process per GPU) splits every batch by rows over the
processes; ``--shard_feature_bank`` with ``--cache_features`` splits the
bank's rows over them; only process 0 writes the search state and the jsonl
(parallel/mesh.py).
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
                        default='data/NTU/')
    parser.add_argument('--ske_cp', type=str,
                        help='Skeleton net checkpoint (in checkpointdir)',
                        default='skeleton_32frames_83.42')
    parser.add_argument('--rgb_cp', type=str,
                        help='RGB net checkpoint (in checkpointdir)',
                        default='rgb_8frames_82.14')
    parser.add_argument('--num_outputs', type=int, help='output dimension',
                        default=60)
    parser.add_argument('--batchsize', type=int, help='batch size', default=20)
    parser.add_argument('--inner_representation_size', type=int,
                        help='output size of mixing linear layers', default=16)
    parser.add_argument('--epochs', type=int, help='training epochs', default=3)
    parser.add_argument('--lr_surrogate', type=float,
                        help='learning rate surrogate', default=0.001)
    parser.add_argument('--epochs_surrogate', type=int,
                        help='num of epochs for surrogate', default=50)
    parser.add_argument('--eta_max', type=float, help='eta max', default=0.001)
    parser.add_argument('--eta_min', type=float, help='eta min', default=0.000001)
    parser.add_argument('--Ti', type=int, help='epochs Ti', default=1)
    parser.add_argument('--Tm', type=int, help='epochs multiplier Tm', default=2)
    parser.add_argument('--use_dataparallel', help='Use several GPUs',
                        action='store_true', default=False)
    parser.add_argument('--num_workers', '--j', type=int,
                        help='Dataloader CPUS', default=16)
    parser.add_argument('--modality', type=str, help='', default='both')
    parser.add_argument('--max_fusions', type=int, dest="max_progression_levels",
                        help='max fusions', default=4)
    parser.add_argument('--search_iterations', type=int, help='epnas iterations',
                        default=3)
    parser.add_argument('--num_samples', type=int,
                        help='number of samples to train at each explo step (K)',
                        default=15)
    parser.add_argument('--initial_temperature', type=float,
                        help='initial sampling temperature', default=10.0)
    parser.add_argument('--final_temperature', type=float,
                        help='final sampling temperature', default=0.2)
    parser.add_argument('--temperature_decay', type=float,
                        help='temperature decay (sigma)', default=4.0)
    parser.add_argument('--no-verbose', help='verbose', dest='verbose',
                        action='store_false', default=True)
    parser.add_argument('--weightsharing', help='Weight sharing',
                        action='store_true', default=False)
    parser.add_argument('--population_weightsharing', action='store_true',
                        default=False,
                        help='approximate weight sharing inside the fast '
                             'population trainer (default: sharing uses the '
                             'faithful sequential candidate loop)')
    parser.add_argument('--alphas', help='Use alphas', action='store_true',
                        default=False)
    parser.add_argument('--batchnorm', help='Use batch norm', action='store_true',
                        default=False)
    parser.add_argument('--multitask', help='Multitask loss', action='store_true',
                        default=False)
    parser.add_argument("--vid_dim", action="store", default=256, dest="vid_dim",
                        help="frame side dimension (square image assumed) ")
    parser.add_argument("--vid_fr", action="store", default=30, dest="vi_fr",
                        help="video frame rate")
    parser.add_argument("--vid_len", action="store", default=(8, 32),
                        dest="vid_len", type=int, nargs='+',
                        help="length of video, as a tuple of two lengths, "
                             "(rgb len, skel len)")
    parser.add_argument("--drpt", action="store", default=0.5, dest="drpt",
                        type=float, help="dropout")
    parser.add_argument('--no_bad_skel', action="store_true",
                        help='Remove the 300 bad samples, espec. useful to evaluate',
                        default=False)
    parser.add_argument("--no_norm", action="store_true", default=False,
                        dest="no_norm", help="Not normalizing the skeleton")
    # additive flags (not in the reference)
    parser.add_argument('--seed', type=int, default=None,
                        help='seed the global numpy RNG (sampler)')
    parser.add_argument('--sequential_candidates', action='store_true',
                        default=False,
                        help='train candidates one at a time (reference loop)')
    parser.add_argument('--random_backbones', action='store_true', default=False,
                        help='smoke-run without pretrained backbone checkpoints')
    parser.add_argument('--resnet3d_layers', type=int, nargs=4,
                        default=(3, 4, 6, 3), metavar='N',
                        help='blocks per inflated-ResNet stage (shrink knob '
                             'for tests/small deployments; the reference '
                             'architecture is 3 4 6 3)')
    parser.add_argument('--resnet3d_base_width', type=int, default=64,
                        help='inflated-ResNet stem width (shrink knob; '
                             'reference 64 — tap widths scale with it)')
    parser.add_argument('--search_state', type=str, default='',
                        help='persist resumable search state to this path')
    parser.add_argument('--resume_search', action='store_true', default=False,
                        help='resume from --search_state if it exists')
    parser.add_argument('--bf16_features', action='store_true', default=False,
                        help='bfloat16 frozen-backbone features during search '
                             '(the default whenever --cache_features is on; '
                             'this flag forces bf16 even without the bank)')
    parser.add_argument('--f32_features', action='store_true', default=False,
                        help='force float32 frozen-backbone features, '
                             'overriding the bf16-under---cache_features '
                             'default')
    parser.add_argument('--cache_features', action='store_true', default=False,
                        help='device-resident train-feature bank: extract '
                             'frozen-backbone features once (eval mode), '
                             'gather shuffled batches from the bank every '
                             'epoch/population — no backbone forward after '
                             'the first pass (freezes the augmentation draw; '
                             'candidate scoring only)')
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
    parser.add_argument('--packed_datadir', type=str, default='',
                        help='packed stores with subdirs trainexp/dev; '
                             'bypasses AVI decode')
    parser.add_argument('--device_input_normalize', action='store_true',
                        default=False,
                        help='with --packed_datadir: ship raw uint8 clips '
                             'and normalize them on the card (kernel K1)')
    parser.add_argument('--jsonl_log', type=str, default='',
                        help='append structured search telemetry here')
    add_dist_args(parser)
    return parser.parse_args(argv)


def main(argv=None, device=None):
    """-> search/searcher.py::SearchRun."""
    from mfas_tpu_torch.search.searcher import run_search
    from mfas_tpu_torch.search.searchers import NTUSearcher

    args = parse_args(argv)
    device = cli_device(device, "mfas_tpu_torch.main_searchable_ntu", args)
    pm.initialize_from_args(args, device)
    pm.require_shared_seed(args)
    group = pm.data_group_from_args(args)
    return run_search(args, "NTU", device,
                      lambda timer: NTUSearcher(
                          args, device=device, group=group,
                          jsonl_log=args.jsonl_log or None, timer=timer))


if __name__ == "__main__":
    main()
