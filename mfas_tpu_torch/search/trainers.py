"""Candidate trainers: the ``train_sampled_fun`` implementations handed to
the searcher (port of mfas_tpu/search/trainers.py).

  * ``PopulationSearchTrainer`` (default): all K candidates train together
    in one batched step over frozen-backbone features (search/population.py).
  * ``SequentialSearchTrainer``: one candidate at a time, each a fresh
    ``Searchable_Skeleton_Image_Net`` with the searcher's backbone weights,
    trained through ``engine/classifier.py::ClassifierEngine`` on its central
    weights; the weight-sharing path.
  * ``CifarSearchTrainer``: CIFAR's whole-net candidates, one at a time,
    through ``engine/cifar.py::CifarEngine``; under ``--weightsharing`` op
    weights pass between candidates by op type (``get_cifar_states``).

Each takes the data ``group`` of ``--use_dataparallel`` (parallel/mesh.py)
and hands it to its engine or population trainer.

Shared weights are stored as nested dicts of numpy arrays, the layout of
the JAX package (and of ``population.extract_shared_states``), keyed
'{i}.L_{in}_{out}.A_{act}' -> {"0": {weight, bias}, "2": {BatchNorm}} for
the fusion layers, 'op{1,2}.{type}.block{b}.cell{c}', 'input_conv',
'classifier' and 'aux_classifier' for CIFAR's nets.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from mfas_tpu_torch.core.sched import LRCosineAnnealingScheduler
from mfas_tpu_torch.engine.cifar import CifarEngine
# TRAIN_SEED_OFFSET, the offset between a candidate's init seed and its
# dropout seed, lives with the engine that seeds dropout
from mfas_tpu_torch.engine.classifier import (TRAIN_SEED_OFFSET,
                                              ClassifierEngine)
from mfas_tpu_torch.fusion.layers import shared_weight_key
from mfas_tpu_torch.runtime.checkpoint import flatten_tree, nest_tree
from mfas_tpu_torch.search.population import PopulationTrainer


def _numpy_tree(module):
    """``module``'s state as a nested tree of numpy arrays."""
    return nest_tree({k: v.detach().cpu().numpy().copy()
                      for k, v in module.state_dict().items()})


def _load_numpy_tree(module, tree):
    """Load a nested tree of arrays (``_numpy_tree``'s layout, or the JAX
    package's) into ``module`` with strict keys."""
    module.load_state_dict({k: torch.as_tensor(np.array(v))
                            for k, v in flatten_tree(tree).items()},
                           strict=True)


def _layer_key(model, idx):
    lin = model.fusion_layers[idx][0]
    return shared_weight_key(idx, lin.weight.shape[1], lin.weight.shape[0],
                             model.conf[idx][2])


def get_central_states(model, state_dict, verbose=True):
    """Store each fusion layer's state under its shape/activation key."""
    for idx in range(len(model.fusion_layers)):
        name = _layer_key(model, idx)
        if verbose:
            print(("Updating" if name in state_dict else "Creating")
                  + " shared weight with ID: {}".format(name))
        state_dict[name] = _numpy_tree(model.fusion_layers[idx])
    return state_dict


def set_central_states(model, state_dict, verbose=True):
    """Load stored fusion-layer states into ``model`` where keys match."""
    for idx in range(len(model.fusion_layers)):
        name = _layer_key(model, idx)
        if name in state_dict:
            _load_numpy_tree(model.fusion_layers[idx], state_dict[name])
            if verbose:
                print("Loaded shared weight with ID: {}".format(name))


class SequentialSearchTrainer:
    """One candidate at a time, like the reference loop."""

    def __init__(self, backbone_states: dict, input_keys, *, device,
                 batch_prep=None, timer=None, group=None):
        """backbone_states: attribute name -> state_dict, e.g.
        {'rgbnet': ..., 'skenet': ...}, loaded into every candidate.
        batch_prep: the engine's on-device batch transform (K1)."""
        self.backbone_states = backbone_states
        self.input_keys = tuple(input_keys)
        self.device = torch.device(device)
        self._seed = 0      # +1 per candidate; a search state keeps it
        self.batch_prep = batch_prep
        self.timer = timer
        self.group = group
        self.candidates_trained = 0

    def __call__(self, sampled_configurations, searchable_type, dataloaders,
                 args, device=None, state_dict=None):
        state_dict = {} if state_dict is None else state_dict
        sizes = {k: dl.dataset_size for k, dl in dataloaders.items()}
        nbpe = sizes["train"] / args.batchsize

        accs = []
        for configuration in sampled_configurations:
            self._seed += 1
            model = searchable_type(
                args, configuration, device=self.device,
                generator=torch.Generator().manual_seed(self._seed))
            for attr, state in self.backbone_states.items():
                getattr(model, attr).load_state_dict(state, strict=True)
            if args.weightsharing:
                set_central_states(model, state_dict, verbose=args.verbose)

            if args.verbose:
                print("Now training: ")
                print(configuration)

            engine = ClassifierEngine(model, self.device,
                                      multitask=args.multitask,
                                      input_keys=self.input_keys,
                                      batch_prep=self.batch_prep,
                                      group=self.group)
            scheduler = LRCosineAnnealingScheduler(
                args.eta_max, args.eta_min, args.Ti, args.Tm, nbpe)
            with (self.timer.section("sequential candidates")
                  if self.timer is not None else contextlib.nullcontext()):
                best_acc, _ = engine.train_track_acc(
                    model.central_params(), dataloaders, sizes, scheduler,
                    num_epochs=args.epochs,
                    seed=self._seed + TRAIN_SEED_OFFSET,
                    print_loss=args.verbose)
            # train_track_acc leaves the model in its best-dev state
            if args.weightsharing:
                get_central_states(model, state_dict, verbose=args.verbose)
            accs.append(float(best_acc))
            self.candidates_trained += 1
        return accs


class PopulationSearchTrainer:
    """All candidates at once over shared frozen-backbone features."""

    def __init__(self, spec, extractor, input_keys, *, device,
                 sequential_fallback=None, input_prep=None,
                 cache_features=False, fused_epochs=True, bank_batch=None,
                 int8_bank=False, timer=None, group=None,
                 shard_feature_bank=False):
        self.spec = spec
        self.input_keys = tuple(input_keys)
        self._seed = 0      # +1 per population; a search state keeps it
        self.trainer = PopulationTrainer(
            spec, extractor, device=device, input_prep=input_prep,
            cache_train_features=cache_features, fused_epochs=fused_epochs,
            bank_batch=bank_batch, int8_bank=int8_bank, timer=timer,
            group=group, shard_feature_bank=shard_feature_bank)
        self.sequential_fallback = sequential_fallback
        self.candidates_trained = 0

    def __call__(self, sampled_configurations, searchable_type, dataloaders,
                 args, device=None, state_dict=None):
        shared = None
        if args.weightsharing:
            if args.population_weightsharing:
                # approximate mode: inject before / extract after the whole
                # population
                shared = state_dict if state_dict is not None else {}
            else:
                # faithful path: sequential candidate-to-candidate sharing
                if self.sequential_fallback is None:
                    raise ValueError(
                        "weightsharing requires a sequential fallback trainer")
                # ONE candidate-seed counter: a resumed search restores
                # _seed on this wrapper, so the fallback consumes it
                fb = self.sequential_fallback
                fb._seed = self._seed
                before = fb.candidates_trained
                try:
                    return fb(sampled_configurations, searchable_type,
                              dataloaders, args, device,
                              state_dict=state_dict)
                finally:
                    self._seed = fb._seed
                    self.candidates_trained += fb.candidates_trained - before

        sizes = {k: dl.dataset_size for k, dl in dataloaders.items()}
        scheduler = LRCosineAnnealingScheduler(
            args.eta_max, args.eta_min, args.Ti, args.Tm,
            sizes["train"] / args.batchsize)
        if args.verbose:
            print("Now training population of {} candidates:".format(
                len(sampled_configurations)))
            for c in sampled_configurations:
                print(np.asarray(c).tolist())
        self._seed += 1
        accs, _, _ = self.trainer.train_population(
            sampled_configurations, dataloaders, sizes, scheduler,
            num_epochs=args.epochs, input_keys=self.input_keys,
            seed=self._seed, verbose=args.verbose, shared_state_dict=shared)
        self.candidates_trained += len(sampled_configurations)
        return accs


# --------------------------------------------------------------------------
# CIFAR: whole-net candidates (reference models/search/cifar_searchable.py:
# 21-114)
# --------------------------------------------------------------------------
def _cifar_parts(model):
    """(store key, submodule) of every part the CIFAR store shares: each
    block's two ops under 'op{1,2}.{type}.block{b}.cell{c}', then
    input_conv, classifier and the aux head under 'aux_classifier' (the
    attribute the reference's get_states meant; its model calls it
    aux_head)."""
    parts = []
    for c, cell in enumerate(model.cell_array):
        for b, block in enumerate(cell.blocks):
            parts.append((f"op1.{block.op1_type}.block{b}.cell{c}",
                          block.op1))
            parts.append((f"op2.{block.op2_type}.block{b}.cell{c}",
                          block.op2))
    return parts + [("input_conv", model.input_conv),
                    ("classifier", model.classifier),
                    ("aux_classifier", model.aux_head)]


def get_cifar_states(model):
    """A fresh store of ``model``'s shared parts, nested numpy trees in the
    JAX layout. The reference's get_states rebinds its store to a new dict
    (cifar_searchable.py:83-85), so the caller REPLACES its store with this
    one: it holds only the last candidate's keys."""
    return {key: _numpy_tree(m) for key, m in _cifar_parts(model)}


def set_cifar_states(model, state_dict):
    """Load every stored part whose key ``model`` has."""
    for key, m in _cifar_parts(model):
        if key in state_dict:
            _load_numpy_tree(m, state_dict[key])


class CifarSearchTrainer:
    """Whole-network training of one candidate at a time (no frozen
    backbone, so the population trainer does not apply): a fresh
    ``Searchable_MicroCNN`` per conf, initial weights from the seed counter
    (+1 per candidate; a search state keeps it), trained by ``CifarEngine``
    with dropout and DropPath at ``seed + TRAIN_SEED_OFFSET``."""

    def __init__(self, *, device, timer=None, group=None):
        self.device = torch.device(device)
        self._seed = 0
        self.timer = timer
        self.group = group
        self.candidates_trained = 0

    def build_model(self, searchable_type, args, configuration):
        """The candidate at the current seed."""
        return searchable_type(
            args, configuration, device=self.device,
            generator=torch.Generator().manual_seed(self._seed))

    def __call__(self, sampled_configurations, searchable_type, dataloaders,
                 args, device=None, state_dict=None):
        state_dict = {} if state_dict is None else state_dict
        sizes = {k: dl.dataset_size for k, dl in dataloaders.items()}
        nbpe = sizes["train"] / args.batchsize

        accs = []
        for configuration in sampled_configurations:
            self._seed += 1
            model = self.build_model(searchable_type, args, configuration)
            if args.weightsharing:
                set_cifar_states(model, state_dict)
            if args.verbose:
                print("Now training: ")
                print(configuration)

            engine = CifarEngine(model, self.device, group=self.group)
            scheduler = LRCosineAnnealingScheduler(
                args.eta_max, args.eta_min, args.Ti, args.Tm, nbpe)
            with (self.timer.section("whole-net candidates")
                  if self.timer is not None else contextlib.nullcontext()):
                best_acc, _ = engine.train_track_acc(
                    None, dataloaders, sizes, scheduler,
                    num_epochs=args.epochs,
                    seed=self._seed + TRAIN_SEED_OFFSET,
                    print_loss=args.verbose)
            # train_track_acc leaves the model in its best-dev state
            if args.weightsharing:
                new_states = get_cifar_states(model)
                state_dict.clear()
                state_dict.update(new_states)
            accs.append(float(best_acc))
            self.candidates_trained += 1
        return accs
