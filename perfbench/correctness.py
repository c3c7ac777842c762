"""What decides ``correct`` in a training cell: the frozen reference takes
the program's first three steps from the same weights, rows, learning
rates and dropout stream, each step from the parameters the program held
before it, and the numbers below compare the two.

  * ``loss_gap``: the largest relative gap between the program's and the
    reference's loss over the three steps;
  * ``grad_gap``: the first gradient as Adam receives it (weight decay
    added), by the worst leaf: the gap between the two norms of a leaf
    over the reference's norm of that leaf or of the median leaf,
    whichever is larger; ``head_grad_gap`` the same over the output
    layers' leaves alone;
  * ``change_gap``: the same for each leaf's change in each of the three
    steps, worst leaf and step (the reference's Adam keeps its own
    moments, from its own gradients).

The first step starts from the weights made from the seed on both sides.
Steps 2 and 3 start from the program's parameters: run free, the two
sides part by round-off that the net amplifies about ten-thousandfold in
two steps (PERF.md), and no limit could tell a fault from it. Each step's
change checks what following skips, the carry from one step to the next.

Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of the gradient and change numbers (they move by
round-off alone; the unused alpha gates have none). A step that leaves
its state unchanged reads a change gap of 1.

Each cell's ``limits/<cell>.json`` names the numbers it compares and
their limits (PERF.md gives the readings each was set from); the ``_med``
variants (the median leaf's gap) are reported beside them.

The reference can stand in the program's place: computed in a lower
precision than the configuration's (the control), or with a fault planted
(``half``: half of each batch left out, the mean over the rest; ``label``:
one label of each batch altered), run free; the sound reference then
follows its parameters as it follows the program's.
"""

from __future__ import annotations

import statistics
import sys

import torch

from perfbench.harness import reference_module
from perfbench.reference import _plain as P
from perfbench.weights import make_weights, sub_seed

CHECK_STEPS = 3
NEGLIGIBLE = 1e-3
# the control: the precision below each configuration's
CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def reference_readings(cell, seed, device, ctx, follow=None,
                       precision="float32", fault=None, perturb=False,
                       steps=CHECK_STEPS):
    """The reference's losses, first-gradient norms and each step's change
    norms (``change``: ``<leaf>@<step>``). ``ctx``: the run's
    ``dropout_seed`` and ``n_train``. With ``follow`` (another run's
    readings) each step after the first starts from that run's parameters
    (its ``states``); without, the reference runs free and records its own
    states, and its change over the steps (``drift``). ``perturb``: every
    weight moved by one part in 10**7 first (the witness that round-off
    alone parts two free runs)."""
    cfg, traffic = cell.cfg, cell.traffic
    ref = reference_module(cfg["reference"])
    adapter = cell.module("adapters", cfg["adapter"])
    raw = adapter.make_raw(cfg, traffic, seed, device)
    specs = ref.param_specs(cfg)
    w0 = make_weights(specs, seed, device)
    names = P.trained_names(specs)
    if perturb:
        gen = torch.Generator(device=device).manual_seed(
            sub_seed(seed, "perturb"))
        for n in names:
            sign = torch.randint(0, 2, w0[n].shape, generator=gen,
                                 device=device) * 2.0 - 1.0
            w0[n] = w0[n] * (1.0 + 1e-7 * sign)
    params = {n: (t.clone().requires_grad_(True) if n in names else t)
              for n, t in w0.items()}
    batches = ref.train_batches(raw, cfg, steps)
    etas = P.cosine_etas(float(cfg["eta_max"]), float(cfg["eta_min"]),
                         float(cfg["Ti"]),
                         ctx["n_train"] / int(cfg["batchsize"]), steps)
    mask_dtype = (torch.bfloat16 if traffic["precision"] == "bfloat16"
                  else torch.float32)
    masks = P.MaskStream(
        torch.Generator(device=device).manual_seed(ctx["dropout_seed"]),
        mask_dtype)
    m = {n: torch.zeros_like(params[n]) for n in names}
    v = {n: torch.zeros_like(params[n]) for n in names}
    losses, grad, change, states = [], {}, {}, []
    with P.Precision(precision) as prec:
        for s, batch in enumerate(batches):
            with torch.no_grad():
                if s and follow is not None:
                    for n in names:
                        params[n].copy_(follow["states"][s - 1][n])
                elif s:
                    states.append({n: params[n].detach().to("cpu",
                                                            copy=True)
                                   for n in names})
                before = {n: params[n].detach().clone() for n in names}
            inputs, label, mask = ref.inputs(raw, batch, device)
            if fault == "label":
                label = label.clone()
                label[0] = (label[0] + 1) % int(cfg["num_outputs"])
            elif fault == "half":
                mask = mask.clone()
                mask[len(mask) // 2:] = 0.0
            elif fault is not None:
                raise ValueError(f"unknown fault {fault!r}")
            outs = ref.forward(params, inputs, cfg, masks, prec)
            loss = sum(P.masked_ce(o.float(), label, mask) for o in outs)
            leaves = [params[n] for n in names]
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            losses.append(float(loss.detach()))
            with torch.no_grad():
                for n, p, g in zip(names, leaves, grads):
                    if g is None:       # unused: torch's Adam skips it
                        if s == 0:
                            grad[n] = 0.0
                    else:
                        g = g + P.WEIGHT_DECAY * p
                        if s == 0:
                            grad[n] = float(g.double().norm())
                        P.adam_step(p, g, m[n], v[n], s + 1, etas[s])
                    change[f"{n}@{s + 1}"] = float(
                        (p.detach().double() - before[n].double()).norm())
            del outs, loss, grads, before
    out = {"losses": losses, "grad": grad, "change": change,
           "heads": [n for n in names if n.startswith(ref.HEADS)]}
    if follow is None:
        out["states"] = states
        out["drift"] = {n: float((params[n].detach().double()
                                  - w0[n].double()).norm()) for n in names}
    return out


def _leaf(key):
    return key.split("@")[0]


def gaps(prog, ref):
    """-> ({name: value}, {name: worst leaf or step}) for every number this
    module can compare: ``loss_gap`` (worst of the steps), ``loss1_gap``
    (the first step), ``grad_gap`` / ``change_gap`` (worst leaf, and step),
    ``grad_gap_med`` / ``change_gap_med`` (the median's gap) and
    ``head_grad_gap`` (the worst of the output layers' leaves, the
    reference's ``HEADS``, against the same median); ``drift_gap`` where
    both ran free (each leaf's change over all the steps). The loss
    numbers only where the readings hold losses."""
    out, worst = {}, {}
    if "losses" in prog:
        loss = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                      ref["losses"])]
        out.update(loss_gap=max(loss), loss1_gap=loss[0])
        worst["loss_gap"] = f"step {loss.index(out['loss_gap']) + 1}"
    med_all = statistics.median(ref["grad"].values())
    keep = {n for n, g in ref["grad"].items() if g >= NEGLIGIBLE * med_all}
    keys = [("grad", "grad_gap"), ("change", "change_gap")]
    if "drift" in prog and "drift" in ref:
        keys.append(("drift", "drift_gap"))
    for key, name in keys:
        kept = [k for k in ref[key] if _leaf(k) in keep]
        med = statistics.median(ref[key][k] for k in kept)
        by_leaf = {k: abs(prog[key].get(k, 0.0) - ref[key][k])
                   / max(ref[key][k], med) for k in kept}
        worst[name] = max(by_leaf, key=by_leaf.get)
        out[name] = by_leaf[worst[name]]
        out[name + "_med"] = statistics.median(by_leaf.values())
        if key == "grad":
            heads = {n: by_leaf[n] for n in ref["heads"] if n in by_leaf}
            worst["head_grad_gap"] = max(heads, key=heads.get)
            out["head_grad_gap"] = heads[worst["head_grad_gap"]]
    return out, worst


def judge(cell, values, worst=None):
    """-> (checks for the result line, correct): each number the cell's
    limits file names, beside its limit; the worst leaves to stderr."""
    for name in sorted(worst or {}):
        print(f"perfbench: {name} {values[name]!r} worst at {worst[name]}",
              file=sys.stderr)
    if not cell.limits:
        print("perfbench: no limits for this cell", file=sys.stderr)
    checks = {name: {"value": values[name], "limit": limit}
              for name, limit in cell.limits.items()}
    correct = bool(checks) and all(c["value"] <= c["limit"]
                                   for c in checks.values())
    return checks, correct


def training_context(cell, seed):
    """The dropout seed and train-split size of a training cell's run,
    from the seed and the cell's files alone."""
    cfg, traffic = cell.cfg, cell.traffic
    n_train = (int(cfg["split"][0]) if "split" in cfg
               else int(traffic["store_clips"]["train"]))
    return {"dropout_seed": sub_seed(seed, "dropout") >> 20,
            "n_train": n_train}
