"""The NTU searcher (port of mfas_tpu/search/searchers.py::NTUSearcher):
wires the packed NTU stores, the backbones and the candidate trainer into
the EPNAS loop.

Candidates train as populations (search/population.py) unless
``--sequential_candidates``; ``--weightsharing`` without
``--population_weightsharing`` trains them one at a time too. The input is
the packed store's trainexp/dev splits, streamed as raw uint8 clips that
kernel K1 normalizes on the device.
"""

from __future__ import annotations

import os

import torch

from mfas_tpu_torch.data import ntu as ntu_data
from mfas_tpu_torch.data.loader import MapLoader
from mfas_tpu_torch.fusion import ntu as f_ntu
from mfas_tpu_torch.runtime import checkpoint as ckpt
from mfas_tpu_torch.search.population import PopulationSpec
from mfas_tpu_torch.search.searcher import ModelSearcher
from mfas_tpu_torch.search.surrogate import SimpleRecurrentSurrogate
from mfas_tpu_torch.search.trainers import (PopulationSearchTrainer,
                                            SequentialSearchTrainer)

# the extractor's initial weights (--random_backbones), as the JAX
# searcher's extractor.init(0)
BACKBONE_SEED = 0


def _feature_dtype(args):
    """Frozen-backbone feature dtype of the population trainer: bfloat16
    whenever --cache_features builds the bank (or with --bf16_features),
    unless --f32_features."""
    if args.f32_features:
        return None
    if args.bf16_features or args.cache_features:
        return "bfloat16"
    return None


class NTUSearcher(ModelSearcher):
    """trainexp for search training, dev for ranking (reference
    models/searchable.py:233-260)."""

    def __init__(self, args, *, device, jsonl_log=None, timer=None):
        super().__init__(args, jsonl_log=jsonl_log, timer=timer)
        from mfas_tpu_torch.data.ntu_pack import (
            PackedNTU, make_device_normalize_inputs_prep,
            make_device_normalize_prep)

        self.device = torch.device(device)
        tfm_val = ntu_data.Compose([ntu_data.NormalizeLen(args.vid_len)])
        tfm_tra = ntu_data.Compose([
            ntu_data.AugCrop(seed=0),
            ntu_data.NormalizeLen(args.vid_len)])
        ds_train = PackedNTU(os.path.join(args.packed_datadir, "trainexp"),
                             transform=tfm_tra, args=args,
                             device_normalize=True)
        ds_dev = PackedNTU(os.path.join(args.packed_datadir, "dev"),
                           transform=tfm_val, args=args,
                           device_normalize=True)
        self.dataloaders = {
            "train": MapLoader(ds_train, args.batchsize, shuffle=True,
                               seed=0, num_workers=args.num_workers),
            "dev": MapLoader(ds_dev, args.batchsize,
                             num_workers=args.num_workers),
        }

        extractor = f_ntu.NTUFeatureExtractor(
            args, device=self.device,
            generator=torch.Generator().manual_seed(BACKBONE_SEED))
        for attr, cp in (("skenet", args.ske_cp), ("rgbnet", args.rgb_cp)):
            ckpt.load_backbone(
                os.path.join(args.checkpointdir, cp) if cp else "",
                getattr(extractor, attr), random_ok=args.random_backbones)
        self.extractor = extractor
        # what each sequential candidate loads into its backbones
        backbone_states = {attr: getattr(extractor, attr).state_dict()
                           for attr in ("rgbnet", "skenet")}

        feature_dtype = _feature_dtype(args)
        sizes_ske, sizes_ims = f_ntu.tap_sizes(args)
        spec = PopulationSpec(
            sizes_a=tuple(sizes_ske), sizes_b=tuple(sizes_ims),
            hidden=args.inner_representation_size,
            num_outputs=args.num_outputs,
            max_rows=args.max_progression_levels, batchnorm=args.batchnorm,
            drpt=args.drpt, use_alphas=args.alphas, multitask=args.multitask,
            feature_dtype=feature_dtype)

        seq = SequentialSearchTrainer(
            backbone_states, ("rgb", "ske"), device=self.device,
            batch_prep=make_device_normalize_prep(), timer=timer)
        if args.sequential_candidates:
            self.train_fn = seq
        else:
            self.train_fn = PopulationSearchTrainer(
                spec, extractor, ("rgb", "ske"), device=self.device,
                sequential_fallback=seq,
                input_prep=make_device_normalize_inputs_prep(
                    torch.bfloat16 if feature_dtype else None),
                cache_features=args.cache_features,
                fused_epochs=not args.no_fused_epochs,
                bank_batch=args.bank_batch,
                int8_bank=args.int8_feature_bank,
                timer=timer)
        self.surrogate = SimpleRecurrentSurrogate(100, 3, 100,
                                                  device=self.device)

    def search(self):
        methods = {"train_sampled_fun": self.train_fn,
                   "get_layer_confs": f_ntu.get_possible_layer_configurations}
        return self._epnas(f_ntu.Searchable_Skeleton_Image_Net,
                           {"model": self.surrogate}, self.dataloaders, methods,
                           self.device)
