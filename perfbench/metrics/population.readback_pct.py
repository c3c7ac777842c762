"""population.readback_pct: the share of the traced search window in the
span "population.readback" (mfas_tpu_torch/search/population.py::
PopulationTrainer.train_population's ``record``: each phase's accuracy
reduction and its device->host copy)."""

from perfbench import spans


def read(outcome):
    return spans.host_pct(outcome, "population.readback")
