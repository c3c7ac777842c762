"""Per-batch LR schedulers (port of mfas_tpu/core/sched.py, verbatim).

The reference's formulas (models/auxiliary/scheduler.py:12-62), kept on the
host in float64 Python so the warm-restart trace matches step for step. The
engine sets the optimizer's learning rate from ``step()`` before every
optimizer step.
"""

from __future__ import annotations

import numpy as np


class LRCosineAnnealingScheduler:
    """eta = eta_min + 0.5*(eta_max-eta_min)*(1+cos(pi*Tcur/Ti)), Tcur in
    epochs (iteration_counter/num_batches_per_epoch); warm restart with
    Ti *= Tm when eta <= eta_min + 1e-10 (scheduler.py:25-40)."""

    def __init__(self, eta_max, eta_min, Ti, Tmultiplier, num_batches_per_epoch):
        self.eta_min = eta_min
        self.eta_max = eta_max
        self.Ti = Ti
        self.Tcur = 0.0
        self.nbpe = num_batches_per_epoch
        self.iteration_counter = 0.0
        self.eta = eta_max
        self.Tm = Tmultiplier

    def _compute_rule(self):
        self.eta = self.eta_min + 0.5 * (self.eta_max - self.eta_min) * (
            1 + np.cos(np.pi * self.Tcur / self.Ti))
        return self.eta

    def step(self):
        self.Tcur = self.iteration_counter / self.nbpe
        self.iteration_counter = self.iteration_counter + 1.0
        eta = self._compute_rule()
        if eta <= self.eta_min + 1e-10:
            self.Tcur = 0
            self.Ti = self.Ti * self.Tm
            self.iteration_counter = 0
        return eta

    # state persistence (resumable runs, runtime/train_state.py)
    def state_dict(self):
        return {"eta_min": self.eta_min, "eta_max": self.eta_max, "Ti": self.Ti,
                "Tcur": self.Tcur, "nbpe": self.nbpe,
                "iteration_counter": self.iteration_counter, "eta": self.eta,
                "Tm": self.Tm}

    def load_state_dict(self, d):
        for k, v in d.items():
            setattr(self, k, v)


class FixedScheduler:
    def __init__(self, lr):
        self.lr = lr
        self.eta = lr

    def step(self):
        return self.lr

    def state_dict(self):
        return {"lr": self.lr}

    def load_state_dict(self, d):
        self.lr = d["lr"]
        self.eta = self.lr
