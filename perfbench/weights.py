"""Seeds and initial weights, made from ``--seed`` alone.

The weights follow a reference's parameter specifications
(``reference/_plain.py``): one uniform draw on the device for every random
leaf together, from a generator seeded from the run's seed, then each leaf
scaled to its bound (He-uniform weights, fan-in biases); BatchNorm scales
and running variances are ones, shifts, means and counters zeros. The same
seed gives the same tensors, which both the program and the reference are
handed.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def sub_seed(seed, purpose):
    """A 63-bit seed for one use (``purpose``: a short string) of the
    run's ``--seed``, which may be any non-negative whole number."""
    words = [int(seed) >> (32 * i) & 0xFFFFFFFF
             for i in range(max(1, (int(seed).bit_length() + 31) // 32))]
    words += [ord(c) for c in purpose]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def make_weights(specs, seed, device):
    """{name: tensor} for every entry of ``specs`` (reference
    ``param_specs``), on ``device``, float32 (int64 counters)."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed,
                                                              "weights"))
    n_rand = sum(math.prod(shape) for _, shape, kind, _ in specs
                 if kind in ("w", "b"))
    flat = torch.empty(n_rand, device=device).uniform_(-1.0, 1.0,
                                                       generator=gen)
    out, off = {}, 0
    for name, shape, kind, fan_in in specs:
        n = math.prod(shape)
        if kind in ("w", "b"):
            bound = (math.sqrt(6.0 / fan_in) if kind == "w"
                     else 1.0 / math.sqrt(fan_in))
            out[name] = flat[off:off + n].reshape(shape) * bound
            off += n
        elif kind == "one":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zero":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "count":
            out[name] = torch.zeros(shape, dtype=torch.long, device=device)
        else:
            raise ValueError(f"{name}: unknown parameter kind {kind!r}")
    return out
