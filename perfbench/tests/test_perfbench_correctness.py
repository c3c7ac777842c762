"""``correct`` on the CPU at a tiny size: a sound run passes, and a run of
the whole harness with the timed path broken underneath comes out not
correct, once for each fault a training or search cell can have (a step
that leaves its state unchanged, half of each batch left out with the mean
over the rest, a label altered where the batch is made). The card's own
check, of the control, is ``test_perfbench_control.py``."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from perfbench.tests.conftest import tiny_cell


def _run(cell, seed=20250101):
    drv = cell.module("drivers", cell.traffic["driver"])
    return drv.run(cell, seed=seed, seconds=0.5, trace=False,
                   t_start=time.perf_counter(), device="cpu")


@pytest.mark.parametrize("name", ["avmnist_found_train",
                                  "ntu_found_train_f32",
                                  "ntu_search_streamed"])
def test_sound_run_is_correct(name):
    out = _run(tiny_cell(name))
    assert out.correct, out.checks
    assert min(out.end_to_end.values()) >= 0 and out.attempted > 0


def _fault_state_unchanged(monkeypatch):
    from mfas_tpu_torch.engine.classifier import ClassifierEngine

    monkeypatch.setattr(ClassifierEngine, "_optimizer_step",
                        lambda self, optimizer: None)


def _fault_half_batch(monkeypatch):
    from mfas_tpu_torch.engine import classifier

    real = classifier.F.cross_entropy

    def half(logits, labels, weights=None, count=None):
        w = weights.clone()
        w[len(w) // 2:] = 0.0
        return real(logits, labels, w, None)

    monkeypatch.setattr(classifier.F, "cross_entropy", half)


def _fault_label(monkeypatch):
    from mfas_tpu_torch.engine import classifier

    real = classifier.place_batch

    def altered(batch, device, group=None):
        batch = dict(batch)
        label = np.array(batch["label"])
        label[0] = (label[0] + 1) % 5
        batch["label"] = label
        return real(batch, device, group)

    monkeypatch.setattr(classifier, "place_batch", altered)


def _search_state_unchanged(monkeypatch):
    from mfas_tpu_torch.search import population

    monkeypatch.setattr(population, "adam_update", lambda *a, **k: None)


def _search_half_batch(monkeypatch):
    from mfas_tpu_torch.search import population

    real = population._masked_ce

    def half(logits, label, w, count=None):
        w = w.clone()
        w[len(w) // 2:] = 0.0
        return real(logits, label, w, None)

    monkeypatch.setattr(population, "_masked_ce", half)


def _search_label(monkeypatch):
    from mfas_tpu_torch.search import population

    real = population.pm.shard_batch

    def altered(batch, group):
        batch = dict(batch)
        label = np.array(batch["label"])
        label[0] = (label[0] + 1) % 5
        batch["label"] = label
        return real(batch, group)

    monkeypatch.setattr(population.pm, "shard_batch", altered)


FAULTS = {"state_unchanged": _fault_state_unchanged,
          "half_batch": _fault_half_batch,
          "label_altered": _fault_label}
SEARCH_FAULTS = {"state_unchanged": _search_state_unchanged,
                 "half_batch": _search_half_batch,
                 "label_altered": _search_label}


@pytest.mark.parametrize("name", ["avmnist_found_train",
                                  "ntu_found_train_f32"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_step_is_not_correct(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = _run(tiny_cell(name))
    assert not out.correct, out.checks
    failed = [k for k, c in out.checks.items() if c["value"] > c["limit"]]
    assert failed, out.checks


@pytest.mark.parametrize("fault", sorted(SEARCH_FAULTS))
def test_broken_search_step_is_not_correct(fault, monkeypatch):
    SEARCH_FAULTS[fault](monkeypatch)
    out = _run(tiny_cell("ntu_search_streamed"))
    assert not out.correct, out.checks
    assert [k for k, c in out.checks.items() if c["value"] > c["limit"]]


def test_dropout_stream_is_the_programs():
    """The reference's masks are the program's draws: with the same
    generator state a train-mode skeleton forward agrees bitwise."""
    from perfbench.reference import _plain as P
    from perfbench.reference import ntu_i3d50_hcn as ref
    from perfbench.weights import make_weights

    cell = tiny_cell("ntu_found_train_f32")
    cfg = cell.cfg
    adapter = cell.module("adapters", cfg["adapter"])
    weights = make_weights(ref.param_specs(cfg), 7, torch.device("cpu"))
    from mfas_tpu_torch import main_found_ntu as mf
    from mfas_tpu_torch.core.layers import set_dropout_generator

    args = mf.parse_args(list(cfg["argv"]))
    model = mf.build_model(args, mf.FOUND_CONFS[args.conf], "cpu")
    model.load_state_dict(weights, strict=True)
    model.train()
    set_dropout_generator(model, torch.Generator().manual_seed(3))
    raw = adapter.make_raw(cfg, cell.traffic, 7, torch.device("cpu"))
    batch = ref.train_batches(raw, cfg, 1)[0]
    (clips, ske), _, _ = ref.inputs(raw, batch, torch.device("cpu"))
    with torch.no_grad():
        taps, logits = model.skenet(ske)
        want_taps, want = ref.skeleton(
            weights, ske, cfg, P.MaskStream(torch.Generator().manual_seed(3)),
            P.FLOAT32)
    assert torch.equal(logits, want)
    for a, b in zip(taps[-4:], want_taps):
        assert torch.equal(a, b)
