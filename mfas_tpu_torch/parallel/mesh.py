"""Data parallelism over ``torch.distributed`` (port of
mfas_tpu/parallel/mesh.py).

One process per GPU. Every process feeds the identical seeded loader
stream; a batch is split by rows on the host (``shard_batch``) before the
host-to-device copy, so rank r of D trains on rows [r*B/D, (r+1)*B/D) of
the global batch B. Parameters stay replicated: every rank starts from the
same seeded weights and takes the same Adam step on the SUM of the ranks'
gradients (``all_reduce_grads``). Each rank's loss is its share of the
global masked mean, ``sum(w*nll)_rank / max(sum(w)_global, 1)``, so the
D-rank step equals the one-rank step on the global batch, also on a ragged
padded last batch. Train-mode BatchNorm reduces its sums over the group
(``core/layers.py::set_data_group``), the JAX package's statistics over the
whole sharded batch.

The process group is explicit: engines, trainers and stores take a
``group`` (a ``torch.distributed`` ProcessGroup, or None for one rank) and
hand it down; nothing reads a global "current mesh". The collectives are
``all_reduce``, ``broadcast`` and ``barrier`` only, so the same code runs
on NCCL across GPUs and on gloo, with CUDA tensors staged through the host
or with CPU tensors. An all-gather is a zero-filled SUM ``all_reduce`` of
the bytes (``all_gather_rows``), exact for every dtype, and a gather from a
store whose rows are split over the group is a masked local gather and the
same byte SUM (``gather_rows``).

``initialize_from_args`` joins the group of the ``--dist_coordinator
host:port --dist_num_processes N --dist_process_id i`` flags (N counts
processes, one per GPU, where the JAX package counts hosts), or the one
``torchrun`` describes in ``RANK``/``WORLD_SIZE``; a group the caller has
already initialised is used as it is.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import threading

import numpy as np
import torch
import torch.distributed as dist


# --------------------------------------------------------------------------
# initialisation and process roles
# --------------------------------------------------------------------------
def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, device=None):
    """Join the default process group (NCCL for a CUDA ``device``, gloo
    otherwise); a no-op when one exists or nothing asks for one."""
    if coordinator_address is None and (num_processes is not None
                                        or process_id is not None):
        # without the coordinator each process would silently run a
        # standalone single-process job: wrong results, no error
        raise ValueError(
            "--dist_num_processes/--dist_process_id require "
            "--dist_coordinator host:port (process 0's address)")
    if dist.is_initialized():
        return
    backend = ("nccl" if device is not None
               and torch.device(device).type == "cuda" else "gloo")
    if coordinator_address is None:
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        return
    if num_processes is None or process_id is None:
        raise ValueError(
            "--dist_coordinator needs --dist_num_processes (one process per "
            "GPU) and this process's --dist_process_id")
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id))


def initialize_from_args(args, device=None):
    """CLI hook for the ``--dist_*`` flags; call once in ``main`` after the
    device is known (``runtime/cli.py::cli_device``)."""
    initialize_distributed(getattr(args, "dist_coordinator", None),
                           getattr(args, "dist_num_processes", None),
                           getattr(args, "dist_process_id", None),
                           device=device)


def add_dist_args(parser):
    """The multi-process flag trio, shared by every CLI."""
    parser.add_argument('--dist_coordinator', type=str, default=None,
                        help='host:port of process 0; run one process per '
                             'GPU with the same flags')
    parser.add_argument('--dist_num_processes', type=int, default=None,
                        help='processes in all, one per GPU')
    parser.add_argument('--dist_process_id', type=int, default=None,
                        help="this process's rank")


def local_cuda_index(args=None):
    """The GPU this process drives: ``LOCAL_RANK`` under torchrun, else the
    process's rank (``--dist_process_id`` or the caller's group) modulo the
    visible GPUs; None for a single-process run."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    rank = getattr(args, "dist_process_id", None)
    if rank is None and dist.is_initialized():
        rank = dist.get_rank()
    if rank is None:
        return None
    return int(rank) % max(torch.cuda.device_count(), 1)


def world_size():
    return dist.get_world_size() if dist.is_initialized() else 1


def data_group_from_args(args):
    """The CLIs' DataParallel gate: the whole world as the data group under
    ``--use_dataparallel`` with more than one process, else None (one rank
    runs the plain program, as the JAX package's no-mesh path)."""
    if getattr(args, "use_dataparallel", False) and world_size() > 1:
        return dist.group.WORLD
    return None


def barrier():
    """Wait for every process of the default group (none without one):
    after rank 0 writes a file the others may read back."""
    if world_size() > 1:
        dist.barrier()


def is_primary_process():
    """True on the one process that writes shared artifacts (checkpoints,
    train and search state, jsonl): rank 0, or a run without a group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def require_shared_seed(args):
    """A multi-process search must sample the same trajectory on every
    process; an unseeded numpy stream is per-process entropy. Forces
    ``--seed 0`` (with a notice) when the run has more than one process
    and no seed was given."""
    multi = (getattr(args, "dist_coordinator", None) is not None
             or world_size() > 1)
    if multi and getattr(args, "seed", None) is None:
        args.seed = 0
        if is_primary_process():
            print("multi-host search without --seed: forcing --seed 0 so "
                  "every process samples the identical trajectory")


def require_resume_agreement(resume_point):
    """Every process must resolve the same resume point: state files are
    written by rank 0 alone and may be host-local, and a process that
    starts over while the others skip ahead issues other collectives and
    hangs the group. Broadcasts rank 0's point and raises on a mismatch;
    a no-op with one process."""
    if world_size() == 1:
        return
    mine = torch.as_tensor(np.asarray(resume_point, np.int64).ravel())
    lead = _on_backend_device(mine.clone())
    dist.broadcast(lead, src=0)
    lead = lead.cpu()
    if not torch.equal(mine, lead):
        raise RuntimeError(
            f"resume disagreement: process {dist.get_rank()} resolved "
            f"resume point {mine.tolist()} but process 0 resolved "
            f"{lead.tolist()} — the state file must be visible to every "
            "host (shared filesystem, or copy it to each host's path)")


def _on_backend_device(t):
    """``t`` where the default group's backend takes it (NCCL: the GPU)."""
    if dist.get_backend() == "nccl":
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    return t


# --------------------------------------------------------------------------
# group helpers and batch placement
# --------------------------------------------------------------------------
def group_rank(group):
    return 0 if group is None else dist.get_rank(group=group)


def group_size(group):
    return 1 if group is None else dist.get_world_size(group=group)


def row_slice(n, group):
    """This rank's rows of a leading dim ``n`` split over ``group``."""
    d, r = group_size(group), group_rank(group)
    return slice(r * n // d, (r + 1) * n // d)


def shard_batch(batch, group):
    """This rank's rows of every host array of a batch dict (tensors, e.g.
    the resident store riding along, pass through untouched). The group
    size must divide the batch: loaders pad to full batches, so a batch
    size that is a multiple of it is enough."""
    if group is None:
        return batch
    d = group_size(group)
    out = {}
    for k, v in batch.items():
        if torch.is_tensor(v):
            out[k] = v
            continue
        if v.shape[0] % d:
            raise ValueError(
                f"--batchsize {v.shape[0]} does not divide over the {d} "
                "data-parallel processes: use a multiple of "
                f"{d}")
        out[k] = v[row_slice(v.shape[0], group)]
        if _VERIFY_LOG:
            _log_batch_checksum(v)
    return out


def replicate(tensors, group):
    """Broadcast ``tensors`` in place from the group's first rank to the
    others (parameters and buffers that must start equal)."""
    if group is None:
        return
    src = dist.get_global_rank(group, 0)
    for t in tensors:
        dist.broadcast(t.data, src=src, group=group)


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------
class AllReduceSum(torch.autograd.Function):
    """SUM over ``group`` whose backward SUMs the upstream gradient: each
    rank's loss depends on the reduced value, so the gradient of the
    summed loss with respect to a rank's input is the sum of the ranks'
    gradients (SyncBatchNorm's backward)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x, group):
    """Differentiable SUM over ``group``; ``x`` itself without one."""
    if group is None:
        return x
    return AllReduceSum.apply(x, group)


def reduce_sum(x, group):
    """A SUM over ``group`` of a value outside autograd (losses, corrects);
    ``x`` itself without one."""
    if group is None:
        return x
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=group)
    return y


def all_reduce_grads(params, group):
    """SUM the ``.grad`` of every parameter that has one over ``group``,
    through one flat buffer per dtype. Every rank runs the same graph, so
    the set of parameters with a gradient is the same on every rank."""
    if group is None:
        return
    by_dtype = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


def _byte_sum(x, group):
    """SUM ``x`` over ``group`` as raw bytes: exact for any dtype when at
    most one rank holds a nonzero byte at each position."""
    b = x.contiguous().view(torch.uint8)
    dist.all_reduce(b, group=group)
    return b.view(x.dtype)


def all_gather_rows(x, group):
    """The (D*b, ...) concatenation of every rank's (b, ...) ``x`` in rank
    order, on every rank: each writes its rows into zeros and the byte SUM
    assembles them (gloo has no all_gather for CUDA tensors)."""
    if group is None:
        return x
    d, r = group_size(group), group_rank(group)
    b = x.shape[0]
    out = x.new_zeros((d * b,) + tuple(x.shape[1:]))
    out[r * b:(r + 1) * b] = x
    return _byte_sum(out, group)


def gather_rows(local, idx, group, index=None):
    """Rows ``idx`` (global row numbers) of a store whose rows are split
    over ``group``, rank r holding rows [r*m, (r+1)*m) as ``local`` (m
    rows, zero-padded at the end), assembled on every rank: each rank
    gathers the rows it owns, writes zeros elsewhere, and a byte SUM over
    the group assembles the batch exactly. ``index(local, rows)``
    optionally replaces the row gather, e.g. ``lambda st, rows:
    st[rows[:, None], t]`` for a frame pick; ``rows`` are the clamped local
    row numbers. Without a group, a plain gather."""
    def take(rows):
        return (local.index_select(0, rows) if index is None
                else index(local, rows))

    if group is None:
        return take(idx)
    m, r = local.shape[0], group_rank(group)
    lo = r * m
    mine = (idx >= lo) & (idx < lo + m)
    got = take((idx - lo).clamp(0, m - 1))
    mask = mine.reshape(mine.shape + (1,) * (got.dim() - 1))
    got = torch.where(mask, got, torch.zeros((), dtype=got.dtype,
                                             device=got.device))
    return _byte_sum(got, group)


def split_rows(x, group):
    """This rank's [r*n/D, (r+1)*n/D) rows of ``x`` zero-padded to a
    multiple of D rows (how a sharded store holds its part)."""
    d = group_size(group)
    n = x.shape[0]
    m = -(-n // d)
    lo = group_rank(group) * m
    part = x[lo:min(lo + m, n)]
    if part.shape[0] < m:
        pad = np.zeros((m - part.shape[0],) + tuple(x.shape[1:]), x.dtype)
        part = np.concatenate([np.asarray(part), pad])
    return np.asarray(part)


# --------------------------------------------------------------------------
# the population trainer's (pop, data) layout
# --------------------------------------------------------------------------
def pop_data_groups(pop, data):
    """Ranks laid out as a (pop, data) grid, rank = p * data + d: returns
    (pop_group, data_group) of this rank, the ranks of its grid column and
    of its grid row (None for an axis of size 1). Every rank calls
    ``dist.new_group`` for every group, in the same order."""
    world = world_size()
    if pop * data != world:
        raise ValueError(f"a ({pop}, {data}) layout needs {pop * data} "
                         f"processes, the group has {world}")
    me = dist.get_rank() if dist.is_initialized() else 0
    data_groups = [dist.new_group([p * data + d for d in range(data)])
                   if data > 1 else None for p in range(pop)]
    pop_groups = [dist.new_group([p * data + d for p in range(pop)])
                  if pop > 1 else None for d in range(data)]
    return pop_groups[me % data], data_groups[me // data]


# --------------------------------------------------------------------------
# MFAS_VERIFY_GLOBAL_BATCHES=<dir>: every process appends (seq, shape,
# dtype, sha1) of each global host array it shards to
# <dir>/batches.<rank>.jsonl; diff the files to check that every process
# fed the identical stream. Checksumming is local, so the check issues no
# collective from the prefetch thread.
# --------------------------------------------------------------------------
_VERIFY_LOG = os.environ.get("MFAS_VERIFY_GLOBAL_BATCHES", "")
_verify_seq = itertools.count()
_verify_lock = threading.Lock()


def _log_batch_checksum(x):
    rec = {"seq": next(_verify_seq), "shape": list(x.shape),
           "dtype": str(x.dtype),
           "sha1": hashlib.sha1(np.ascontiguousarray(x).tobytes())
           .hexdigest()}
    rank = dist.get_rank() if dist.is_initialized() else 0
    path = os.path.join(_VERIFY_LOG, f"batches.{rank}.jsonl")
    with _verify_lock:
        os.makedirs(_VERIFY_LOG, exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
