"""Search-space exploration primitives (port of mfas_tpu/search/tools.py).

Host numpy with the reference's formulas and RNG call order (the global
``np.random`` stream, and the stdlib ``random`` stream for the random
search's depth draws), so a seeded search samples the same confs in both
packages. Only candidate training runs on the device.
"""

from __future__ import annotations

import random

import numpy as np


def predict_accuracies_with_surrogate(configurations, surrogate):
    """Surrogate scores for a conf list, batched into one forward (the
    same values as one call per conf)."""
    return surrogate.eval_models(configurations)


def update_surrogate_dataloader(surrogate_dataloader, configurations, accuracies):
    for conf, acc in zip(configurations, accuracies):
        surrogate_dataloader.add_datum(np.asarray(conf), float(acc))


def train_surrogate(surrogate, surrogate_dataloader, args):
    """Retrain the surrogate on all collected (conf, acc) pairs; returns the
    final step's loss."""
    confs, accs = surrogate_dataloader.get_data()
    return surrogate.fit(confs, accs, num_epochs=args.epochs_surrogate,
                         lr=args.lr_surrogate)


def sample_k_configurations(configurations, accuracies_, k, temperature):
    """Temperature-sharpened sampling without replacement, p ∝ acc^(1/T),
    from the global numpy RNG."""
    accuracies = np.array(accuracies_)
    p = accuracies / accuracies.sum()
    powered = pow(p, 1.0 / temperature)
    p = powered / powered.sum()

    indices = np.random.choice(len(configurations), k, replace=False, p=p)
    return [configurations[i] for i in indices]


def sample_k_configurations_uniform(configurations, k):
    indices = np.random.choice(len(configurations), k)
    return [configurations[i] for i in indices]


def merge_unfolded_with_sampled(previous_top_k_configurations,
                                unfolded_configurations, layer):
    """Unfold step of the progressive search: row-substitute when layer <
    len(prev), else append the new row; the very first call expands each
    single row into a (1,3) conf."""
    merged = []
    if not previous_top_k_configurations:
        if layer != 0:
            raise ValueError(
                "merge_unfolded_with_sampled: no previous configurations "
                "but layer != 0")
        for unfolded_conf in unfolded_configurations:
            merged.append(np.expand_dims(np.asarray(unfolded_conf), 0))
    else:
        for prev_conf in previous_top_k_configurations:
            for unfolded_conf in unfolded_configurations:
                if layer < len(prev_conf):
                    new_conf = np.copy(prev_conf)
                    new_conf[layer] = unfolded_conf
                else:
                    new_conf = np.concatenate(
                        [prev_conf, np.expand_dims(np.asarray(unfolded_conf), 0)], 0)
                merged.append(new_conf)
    return merged


def sample_k_configurations_directly(k, max_progression_levels,
                                     get_possible_layer_configurations_fun,
                                     legacy_bug=False):
    """Random-search sampler: each conf's depth from ``random.randint``,
    each row uniform from its layer's space. The reference indexes the
    space with a stale loop variable, so every layer draws from the last
    layer's space; ``legacy_bug=True`` reproduces that."""
    configurations = []
    possible = [get_possible_layer_configurations_fun(layer)
                for layer in range(max_progression_levels)]
    stale = max_progression_levels - 1

    for _ in range(k):
        num_layers_sample = random.randint(1, max_progression_levels)
        conf = []
        for layer in range(num_layers_sample):
            idx = stale if legacy_bug else layer
            conf.append(sample_k_configurations_uniform(possible[idx], 1))
        configurations.append(np.array(conf)[:, 0, :])
    return configurations


def compute_temperature(iteration, args):
    """(T0-Tf)*exp(-(it+1)^2/sigma^2)+Tf."""
    return (args.initial_temperature - args.final_temperature) * np.exp(
        -(iteration + 1.0) ** 2 / args.temperature_decay ** 2
    ) + args.final_temperature
