"""Resumable training state (port of mfas_tpu/runtime/train_state.py).

One ``torch.save`` file in the JAX package's key layout, so a state written
by either package resumes in the other (the JAX codec writes the same zip
container, mfas_tpu/runtime/checkpoint.py):

  model/<key>     the model's state_dict
  best/<key>      the best-dev state so far
  opt/m/<name>    Adam first moments, one per trainable parameter
  opt/v/<name>    Adam second moments
  opt/step        the step count shared by every parameter (a scalar), or
  opt/step/<name> one per parameter where they differ
  meta            JSON bytes (a uint8 tensor): epoch, best_acc, scheduler

A trainable parameter that Adam never stepped (its grad was always None)
is written with zero moments and left out of the step counts; on loading,
a parameter whose moments are all zero gets no optimizer state, as in a
torch run where it was never stepped.
"""

from __future__ import annotations

import json
import os

import torch


def _named_trainable(model, optimizer):
    name_of = {id(p): n for n, p in model.named_parameters()}
    return [(name_of[id(p)], p) for g in optimizer.param_groups
            for p in g["params"]]


def _cpu(t):
    """A contiguous CPU copy (a channels-last tensor is written in the
    layout every reader expects)."""
    return t.detach().to("cpu", copy=True).contiguous()


def save_train_state(path, *, model, best_state, optimizer, scheduler, epoch,
                     best_acc):
    """Write the state (rank 0 alone under a process group: every rank
    holds the same one, and two writers would race on ``path``); every rank
    returns once the file is whole."""
    from mfas_tpu_torch.parallel.mesh import barrier, is_primary_process
    if is_primary_process():
        _write_train_state(path, model=model, best_state=best_state,
                           optimizer=optimizer, scheduler=scheduler,
                           epoch=epoch, best_acc=best_acc)
    barrier()


def _write_train_state(path, *, model, best_state, optimizer, scheduler,
                       epoch, best_acc):
    flat = {f"model/{k}": _cpu(v) for k, v in model.state_dict().items()}
    flat.update({f"best/{k}": _cpu(v) for k, v in best_state.items()})
    steps = {}
    for name, p in _named_trainable(model, optimizer):
        st = optimizer.state.get(p, {})
        for key, slot in (("m", "exp_avg"), ("v", "exp_avg_sq")):
            flat[f"opt/{key}/{name}"] = _cpu(st[slot]) if st else \
                torch.zeros(p.shape, dtype=p.dtype)
        steps[name] = int(st["step"]) if st else 0
    stepped = {s for s in steps.values() if s}
    if len(stepped) <= 1:
        flat["opt/step"] = torch.tensor(max(stepped, default=0))
    else:
        flat.update({f"opt/step/{n}": torch.tensor(s)
                     for n, s in steps.items()})
    meta = {"epoch": int(epoch), "best_acc": float(best_acc),
            "scheduler": scheduler.state_dict()}
    flat["meta"] = torch.tensor(list(json.dumps(meta).encode()),
                                dtype=torch.uint8)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(flat, tmp)
    os.replace(tmp, path)    # a crash mid-write leaves the last state whole


def load_train_state(path, *, model, optimizer, scheduler):
    """Restores the model, the optimizer's moments and steps and the
    scheduler in place. Returns {"best_state", "epoch", "best_acc"}, the
    best state on the model's device."""
    flat = torch.load(path, map_location="cpu", weights_only=True)
    meta = json.loads(bytes(flat["meta"].tolist()).decode())
    scheduler.load_state_dict(meta["scheduler"])
    keys = list(model.state_dict())
    model.load_state_dict({k: flat[f"model/{k}"] for k in keys}, strict=True)
    device = next(model.parameters()).device
    best = {k: flat[f"best/{k}"].to(device) for k in keys}

    state = {}
    for i, (name, p) in enumerate(_named_trainable(model, optimizer)):
        # the moments take the parameter's device and memory format
        m, v = (torch.empty_like(p).copy_(flat[f"opt/{key}/{name}"])
                for key in ("m", "v"))
        step = flat.get("opt/step", flat.get(f"opt/step/{name}"))
        if step is None:
            raise KeyError(f"{path}: no opt/step for {name}")
        if m.any() or v.any():
            state[i] = {"step": torch.tensor(float(step)), "exp_avg": m,
                        "exp_avg_sq": v}
    sd = optimizer.state_dict()
    sd["state"] = state
    optimizer.load_state_dict(sd)    # moves the moments to each param
    return {"best_state": best, "epoch": meta["epoch"],
            "best_acc": meta["best_acc"]}
