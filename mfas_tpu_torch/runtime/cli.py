"""What the port's command lines share: the device they run on, the
multi-host flags they accept, and the stop on a flag whose feature is not
ported yet."""

from __future__ import annotations

MULTI_GPU = "ROADMAP.md §1 'Multi-GPU'"


def cli_device(device, prog):
    """``device`` as a torch.device; None (the command line) means CUDA, and
    the run stops without it."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit(f"{prog} needs a CUDA device")
        device = "cuda"
    return torch.device(device)


def add_dist_args(parser):
    parser.add_argument('--dist_coordinator', type=str, default=None,
                        help='multi-host: host:port of process 0')
    parser.add_argument('--dist_num_processes', type=int, default=None)
    parser.add_argument('--dist_process_id', type=int, default=None)


def dist_requested(args):
    return any(getattr(args, k) is not None for k in
               ("dist_coordinator", "dist_num_processes", "dist_process_id"))


def reject_unported(checks):
    """checks: (bad, what, ROADMAP item) triples; stop on the first bad."""
    for bad, what, item in checks:
        if bad:
            raise SystemExit(f"{what} is not ported to mfas_tpu_torch yet: "
                             f"see {item}")
