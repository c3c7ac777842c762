"""population.setup_pct: the share of the traced search window in the span
"population.setup" (mfas_tpu_torch/search/population.py::
PopulationTrainer.train_population: the population's init, its conf
tensors, its program built and loaded before the first epoch, and its state
taken out after the last)."""

from perfbench import spans


def read(outcome):
    return spans.host_pct(outcome, "population.setup")
