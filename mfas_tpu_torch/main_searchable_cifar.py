#!/usr/bin/env python3
"""EPNAS micro-cell search on CIFAR-10 on the card (port of
main_searchable_cifar.py; same flags and defaults). Prints the top-5
architectures found.

    python -m mfas_tpu_torch.main_searchable_cifar --data_dir data/cifar10/

searches conf rows [op1, op2, conn1, conn2] of ENAS micro-cells: the first
step trains each of the 80 one-block confs as a whole network of
--net_str cells at --planes channels (search mode: cells sum their unused
blocks), one at a time for --epochs epochs; later steps rank the unfolded
confs with the LSTM surrogate and train the --num_samples confs sampled.
The store is a local ``cifar-10-batches-py`` directory; the search trains on
train[0:45000] and ranks on train[45000:50000] (the last n//10 images of a
smaller store), both with the train transforms. --weightsharing passes op
weights from each candidate to the next by op type, block and cell.
--search_state F [--resume_search] makes the search resumable after every
step. --seed seeds numpy's and Python's RNGs.

From the command line the device is CUDA and the run fails without it;
``main(argv, device="cpu")`` runs the same path on the CPU.
``--use_dataparallel`` under ``torchrun`` or the ``--dist_*`` trio (one
process per GPU) splits every batch by rows over the processes;
only process 0 writes files (parallel/mesh.py).
"""

import argparse

from mfas_tpu_torch.parallel import mesh as pm
from mfas_tpu_torch.parallel.mesh import add_dist_args
from mfas_tpu_torch.runtime.cli import cli_device


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Micro-cell search.')
    parser.add_argument('--checkpointdir', type=str, default='checkpoints/')
    parser.add_argument('--data_dir', type=str, default='data/cifar10/')
    parser.add_argument('--num_outputs', type=int, default=10)
    parser.add_argument('--batchsize', type=int, default=128)
    parser.add_argument('--planes', type=int, default=36,
                        help='channels per cell op')
    parser.add_argument('--net_str', type=int, nargs='+',
                        default=[1, 1, 2, 1, 1, 2, 1, 1],
                        help='cell stack; 2 marks a reduction point')
    parser.add_argument('--img_size', type=int, default=32)
    parser.add_argument('--drop_path', type=float, default=0.1)
    parser.add_argument('--drop_prob', type=float, default=0.2)
    parser.add_argument('--epochs', type=int, default=3)
    parser.add_argument('--lr_surrogate', type=float, default=0.001)
    parser.add_argument('--epochs_surrogate', type=int, default=50)
    parser.add_argument('--eta_max', type=float, default=0.001)
    parser.add_argument('--eta_min', type=float, default=0.000001)
    parser.add_argument('--Ti', type=int, default=1)
    parser.add_argument('--Tm', type=int, default=2)
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
    parser.add_argument('--seed', type=int, default=None)
    parser.add_argument('--search_state', type=str, default='')
    parser.add_argument('--resume_search', action='store_true', default=False)
    parser.add_argument('--jsonl_log', type=str, default='')
    add_dist_args(parser)
    return parser.parse_args(argv)


def main(argv=None, device=None):
    """-> search/searcher.py::SearchRun."""
    from mfas_tpu_torch.search.searcher import run_search
    from mfas_tpu_torch.search.searchers import CifarSearcher

    args = parse_args(argv)
    device = cli_device(device, "mfas_tpu_torch.main_searchable_cifar", args)
    pm.initialize_from_args(args, device)
    pm.require_shared_seed(args)
    group = pm.data_group_from_args(args)
    return run_search(args, "CIFAR-10", device,
                      lambda timer: CifarSearcher(
                          args, device=device, group=group,
                          jsonl_log=args.jsonl_log or None, timer=timer))


if __name__ == "__main__":
    main()
