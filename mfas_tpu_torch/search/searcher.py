"""SMBO/EPNAS search loop and the random-search baseline (port of
mfas_tpu/search/searcher.py: ``_epnas``, ``_randsearch``).

The control flow is the reference's, down to its temperature iteration index
``si * search_iterations + progression_index``. After every step the search
state can be written to ``--search_state`` so a crashed search resumes:
a pickle of plain Python and numpy values only (the surrogate's parameters
and Adam state in the JAX package's layout, the shared weights, the
candidate-seed counter, both RNG streams and the loaders' RNG states), so a
state written by the JAX package resumes here and the other way round.
Under a process group only rank 0 writes the state and the jsonl (every
rank holds the same ones), and a resume must resolve the same point on
every rank (parallel/mesh.py::require_resume_agreement).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pickle
import random
import time

import numpy as np

import mfas_tpu_torch.search.tools as tools
from mfas_tpu_torch.parallel.mesh import (barrier, is_primary_process,
                                          require_resume_agreement)
from mfas_tpu_torch.search.surrogate import SurrogateDataloader


class ModelSearcher:
    def __init__(self, args, jsonl_log=None, timer=None):
        self.args = args
        self._jsonl = jsonl_log
        self.timer = timer

    def search(self):
        raise NotImplementedError

    def _section(self, name, host_only=False):
        return (self.timer.section(name, host_only)
                if self.timer is not None else contextlib.nullcontext())

    def _log_event(self, **event):
        if self._jsonl and is_primary_process():
            with open(self._jsonl, "a") as f:
                f.write(json.dumps(event, default=_np_default) + "\n")

    # ----- checkpointing
    def _save_state(self, path, s_data, temperature, si, progression_index,
                    sampled_k_confs, surrogate, shared_weights=None,
                    trainer=None, dataloaders=None):
        """Write the search state (rank 0 alone); every rank returns once
        the file is whole, so a resume in the same job reads this step's."""
        if not path:
            return
        if is_primary_process():
            self._write_state(path, s_data, temperature, si,
                              progression_index, sampled_k_confs, surrogate,
                              shared_weights, trainer, dataloaders)
        barrier()

    @staticmethod
    def _write_state(path, s_data, temperature, si, progression_index,
                     sampled_k_confs, surrogate, shared_weights, trainer,
                     dataloaders):
        state = {
            "surrogate_data": s_data.state(),
            "np_random_state": np.random.get_state(),
            "py_random_state": random.getstate(),
            "temperature": temperature,
            "si": si,
            "progression_index": progression_index,
            "sampled_k_confs": [np.asarray(c) for c in sampled_k_confs],
            "surrogate_params": (surrogate.params_numpy()
                                 if surrogate is not None else None),
            # what a resumed run needs to replay the uncrashed one: the
            # weight-sharing store, the surrogate's Adam moments, the
            # candidate-seed counter and the loaders' RNG positions
            "shared_weights": shared_weights,
            "surrogate_opt_state": (surrogate.opt_state_numpy()
                                    if surrogate is not None else None),
            "trainer_seed": getattr(trainer, "_seed", None),
            "loader_rng_states": (
                {name: ld.rng_state() for name, ld in dataloaders.items()
                 if hasattr(ld, "rng_state")} if dataloaders else None),
        }
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(state, f)
        os.replace(tmp, path)

    @staticmethod
    def load_state(path):
        with open(path, "rb") as f:
            return pickle.load(f)

    @staticmethod
    def _restore(st, trainer, dataloaders):
        """What both searches resume from: the sampler RNGs, the trainer's
        seed counter and the loaders' RNG positions are set back; returns
        the surrogate's data and the weight-sharing store."""
        np.random.set_state(st["np_random_state"])
        if st.get("py_random_state") is not None:
            random.setstate(st["py_random_state"])
        if st.get("trainer_seed") is not None and hasattr(trainer, "_seed"):
            trainer._seed = st["trainer_seed"]
        for name, s in (st.get("loader_rng_states") or {}).items():
            ld = (dataloaders or {}).get(name)
            if ld is not None and hasattr(ld, "set_rng_state"):
                ld.set_rng_state(s)
        shared = st.get("shared_weights")
        return (SurrogateDataloader.from_state(st["surrogate_data"]),
                {} if shared is None else shared)

    def _epnas(self, model_type, surrogate_dict, dataloaders,
               dataset_searchmethods, device=None):
        surrogate = surrogate_dict["model"]
        s_data = SurrogateDataloader()

        train_sampled_models = dataset_searchmethods["train_sampled_fun"]
        get_possible_layer_configurations = \
            dataset_searchmethods["get_layer_confs"]

        temperature = self.args.initial_temperature
        sampled_k_confs = []
        shared_weights = {}
        state_path = self.args.search_state

        # crash resume: restore the sampler RNGs, the surrogate's data,
        # parameters and Adam state, the temperature and the progress, then
        # skip the completed steps
        resume_after = (-1, -1)
        if (self.args.resume_search and state_path
                and os.path.exists(state_path)):
            st = self.load_state(state_path)
            s_data, shared_weights = self._restore(st, train_sampled_models,
                                                   dataloaders)
            temperature = st["temperature"]
            sampled_k_confs = [np.asarray(c) for c in st["sampled_k_confs"]]
            if st.get("surrogate_params") is not None:
                surrogate.load_numpy(st["surrogate_params"],
                                     st.get("surrogate_opt_state"))
            resume_after = (st["si"], st["progression_index"])
            if self.args.verbose:
                print("Resuming search after iteration {} step {}".format(
                    *resume_after))
        if self.args.resume_search:
            require_resume_agreement(resume_after)

        for si in range(self.args.search_iterations):
            if self.args.verbose:
                print(50 * "=")
                print("Search iteration {}/{} ".format(
                    si, self.args.search_iterations))

            for progression_index in range(self.args.max_progression_levels):
                if (si, progression_index) <= resume_after:
                    continue  # completed before the crash
                if self.args.verbose:
                    print(25 * "-")
                    print("Progressive step {}/{} ".format(
                        progression_index, self.args.max_progression_levels))

                # 1-2. unfold this fusion level and merge with the top-K
                with self._section("sampler", host_only=True):
                    list_possible_layer_confs = \
                        get_possible_layer_configurations(progression_index)
                    all_configurations = tools.merge_unfolded_with_sampled(
                        sampled_k_confs, list_possible_layer_confs,
                        progression_index)

                # 3. score: train for real on the very first step, else
                #    predict with the surrogate
                first_step = (si + progression_index == 0)
                if first_step:
                    all_accuracies = train_sampled_models(
                        all_configurations, model_type, dataloaders,
                        self.args, device, state_dict=shared_weights)
                    tools.update_surrogate_dataloader(
                        s_data, all_configurations, all_accuracies)
                    with self._section("surrogate"):
                        err = tools.train_surrogate(surrogate, s_data,
                                                    self.args)
                    if self.args.verbose:
                        print("Trained architectures: ")
                        print(list(zip(all_configurations, all_accuracies)))
                else:
                    with self._section("surrogate"):
                        all_accuracies = \
                            tools.predict_accuracies_with_surrogate(
                                all_configurations, surrogate)
                    if self.args.verbose:
                        print("Predicted accuracies: ")
                        print(list(zip(all_configurations, all_accuracies)))

                # 4. temperature-sample K; train them for real when scored
                #    by the surrogate, then refresh the surrogate
                with self._section("sampler", host_only=True):
                    sampled_k_confs = tools.sample_k_configurations(
                        all_configurations, all_accuracies,
                        self.args.num_samples, temperature)
                if first_step:
                    if self.args.verbose:
                        with self._section("surrogate"):
                            estimated = \
                                tools.predict_accuracies_with_surrogate(
                                    all_configurations, surrogate)
                        diff = np.abs(np.array(estimated)
                                      - np.array(all_accuracies))
                        print("Error on accuracies = {}".format(diff))
                else:
                    sampled_k_accs = train_sampled_models(
                        sampled_k_confs, model_type, dataloaders, self.args,
                        device, state_dict=shared_weights)
                    tools.update_surrogate_dataloader(
                        s_data, sampled_k_confs, sampled_k_accs)
                    with self._section("surrogate"):
                        err = tools.train_surrogate(surrogate, s_data,
                                                    self.args)
                    if self.args.verbose:
                        print("Trained architectures: ")
                        print(list(zip(sampled_k_confs, sampled_k_accs)))
                        print("with surrogate error: {}".format(err))

                # 5. temperature decay, with the reference's iteration index
                iteration = (si * self.args.search_iterations
                             + progression_index)
                temperature = tools.compute_temperature(iteration, self.args)
                if self.args.verbose:
                    print("Temperature is being set to {}".format(
                        temperature))

                self._log_event(
                    kind="epnas_step", si=si, progression=progression_index,
                    temperature=float(temperature),
                    n_scored=len(all_configurations),
                    surrogate_size=len(s_data))
                self._save_state(state_path, s_data, temperature, si,
                                 progression_index, sampled_k_confs,
                                 surrogate, shared_weights=shared_weights,
                                 trainer=train_sampled_models,
                                 dataloaders=dataloaders)

        return s_data

    def _randsearch(self, model_type, dataloaders, dataset_searchmethods,
                    device=None):
        """Uniform random baseline: --search_iterations x --max_fusions
        iterations, each training --num_samples confs drawn by
        ``tools.sample_k_configurations_directly``. Resumes as ``_epnas``
        does (both RNG streams, the loaders' RNG, the trainer's seed
        counter, the shared weights)."""
        s_data = SurrogateDataloader()
        train_sampled_models = dataset_searchmethods["train_sampled_fun"]
        get_possible_layer_configurations = \
            dataset_searchmethods["get_layer_confs"]
        shared_weights = {}
        state_path = self.args.search_state

        resume_after = -1
        if (self.args.resume_search and state_path
                and os.path.exists(state_path)):
            st = self.load_state(state_path)
            s_data, shared_weights = self._restore(st, train_sampled_models,
                                                   dataloaders)
            resume_after = st["si"]
            if self.args.verbose:
                print(f"Resuming random search after iteration "
                      f"{resume_after}")
        if self.args.resume_search:
            require_resume_agreement((resume_after,))

        total = self.args.search_iterations * self.args.max_progression_levels
        for si in range(total):
            if si <= resume_after:
                continue
            if self.args.verbose:
                print(50 * "=")
                print("Random Search iteration {}/{} ".format(si, total))

            with self._section("sampler", host_only=True):
                sampled_k_confs = tools.sample_k_configurations_directly(
                    self.args.num_samples, self.args.max_progression_levels,
                    get_possible_layer_configurations)
            sampled_k_accs = train_sampled_models(
                sampled_k_confs, model_type, dataloaders, self.args, device,
                state_dict=shared_weights)
            tools.update_surrogate_dataloader(s_data, sampled_k_confs,
                                              sampled_k_accs)
            if self.args.verbose:
                print("Trained architectures: ")
                print(list(zip(sampled_k_confs, sampled_k_accs)))
            self._log_event(kind="randsearch_step", si=si,
                            surrogate_size=len(s_data))
            self._save_state(state_path, s_data, 0.0, si, -1, sampled_k_confs,
                             surrogate=None, shared_weights=shared_weights,
                             trainer=train_sampled_models,
                             dataloaders=dataloaders)
        return s_data


@dataclasses.dataclass
class SearchRun:
    """What a search CLI's ``main`` returns: the surrogate's dataset of
    trained confs, the top-5 (conf, acc) pairs printed, the search's wall
    seconds and their split by section (runtime/profiler.py::SectionTimer),
    and the count of candidates trained."""
    data: object
    top: list
    seconds: float
    split: dict
    candidates: int


def run_search(args, name, device, make_searcher):
    """The search CLIs' body: seed both sampler streams from --seed, build
    the searcher (``make_searcher(timer)``), search, and print the time
    split, the candidates per hour and the top-5."""
    from mfas_tpu_torch.runtime.profiler import SectionTimer

    if args.seed is not None:
        np.random.seed(args.seed)
        random.seed(args.seed)
    timer = SectionTimer(device)
    searcher = make_searcher(timer)

    print(f"MFAS for {name} Started!!!!")
    start_time = time.time()
    surrogate_data = searcher.search()
    elapsed = time.time() - start_time
    print('Search complete in {:.0f}m {:.0f}s'.format(elapsed // 60,
                                                      elapsed % 60))
    candidates = searcher.train_fn.candidates_trained
    split = dict(timer.seconds)
    print('Search time split (s): {}; {} candidates trained, {:.1f} '
          'candidates/hour on {}'.format(
              ", ".join(f"{k} {v:.3f}" for k, v in split.items()),
              candidates, candidates / elapsed * 3600.0, device))

    # tiny runs can finish with fewer than 5 unique confs in the store
    k_best, k_accs, _ = surrogate_data.get_k_best(
        min(5, len(surrogate_data)))
    print('Now listing best architectures')
    for conf, acc in zip(k_best, k_accs):
        print(conf.tolist(), acc)
    return SearchRun(data=surrogate_data, top=list(zip(k_best, k_accs)),
                     seconds=elapsed, split=split, candidates=candidates)


def _np_default(o):
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (np.integer, np.floating)):
        return o.item()
    raise TypeError(type(o))
