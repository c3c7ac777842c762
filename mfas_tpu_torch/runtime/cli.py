"""The device the port's command lines run on."""

from __future__ import annotations


def cli_device(device, prog, args=None):
    """``device`` as a torch.device; None (the command line) means CUDA, and
    the run stops without it. A process of a multi-process run drives the
    GPU of its local rank (``parallel/mesh.py::local_cuda_index``)."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit(f"{prog} needs a CUDA device")
        from mfas_tpu_torch.parallel.mesh import local_cuda_index
        index = local_cuda_index(args)
        if index is None:
            device = "cuda"
        else:
            torch.cuda.set_device(index)
            device = f"cuda:{index}"
    return torch.device(device)
