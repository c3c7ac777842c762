"""The NTU EPNAS search through the port's ``main_searchable_ntu`` (the
system under test): its ``NTUSearcher`` at the configuration's search flags
(``cfg["search"]``), streamed train-mode features with K1 as the input prep,
the backbones' weights made on the card from the seed.

The store is ``ntu_found``'s, written under ``TMPDIR`` with the splits the
traffic names (``trainexp`` and ``dev``). Its dev split holds one clip of
each class: random backbones pool nearly the same features from every clip,
so a candidate predicts about one class for all of dev, and only with every
class present does each candidate score above 0, which the sampler's
acc^(1/T) draw of --num_samples of the first step's 32 confs needs.
"""

from __future__ import annotations

import types

from perfbench.adapters.ntu_found import make_data, make_raw  # noqa: F401


def search_cfg(cfg):
    """The configuration with its search settings in place."""
    return {**cfg, **cfg["search"]}


def build(cfg, traffic, data, weights, device, timer):
    """The program: the searcher (backbone weights loaded) and its args."""
    from mfas_tpu_torch import main_searchable_ntu as ms
    from mfas_tpu_torch.search.searchers import NTUSearcher

    sc = search_cfg(cfg)
    args = ms.parse_args(list(sc["argv"]) + ["--packed_datadir", data["dir"]])
    want = {k: sc[k] for k in ("num_outputs", "batchsize",
                               "inner_representation_size", "drpt",
                               "batchnorm", "epochs", "eta_max", "eta_min",
                               "Ti", "Tm", "search_iterations",
                               "num_samples")}
    want["vid_len"] = tuple(sc["vid_len"])
    want["max_progression_levels"] = sc["max_fusions"]
    got = {k: (tuple(getattr(args, k)) if k == "vid_len"
               else getattr(args, k)) for k in want}
    if got != want:
        raise ValueError(f"the CLI's arguments {got} are not the "
                         f"configuration's {want}")
    searcher = NTUSearcher(args, device=device, timer=timer)
    searcher.extractor.load_state_dict(weights, strict=True)
    return types.SimpleNamespace(args=args, searcher=searcher)
