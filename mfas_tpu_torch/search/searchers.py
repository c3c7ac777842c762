"""The NTU, AV-MNIST and CIFAR searchers (port of
mfas_tpu/search/searchers.py): wire the data, the backbones and the
candidate trainer into the EPNAS loop (or, for AV-MNIST with
``--randsearch``, the random search).

Candidates train as populations (search/population.py) unless
``--sequential_candidates``; ``--weightsharing`` without
``--population_weightsharing`` trains them one at a time too. NTU's input is
the trainexp/dev splits of the raw layout (--datadir) or of a packed store,
normalized on the host, or streamed from the packed store as raw uint8 clips
that kernel K1 normalizes on the device (--device_input_normalize);
AV-MNIST's is float32 arrays in host memory, split into train and dev rows. CIFAR has no backbone: each
candidate is a whole micro-cell net trained on its own
(``CifarSearchTrainer``).

``group`` (parallel/mesh.py): the data group of ``--use_dataparallel``,
handed to the candidate trainers; with ``--shard_feature_bank`` the
population trainer's feature banks are split by rows over it.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mfas_tpu_torch.data import ntu as ntu_data
from mfas_tpu_torch.data.avmnist import load_avmnist_arrays, train_dev_split
from mfas_tpu_torch.data.cifar import (CifarLoader, load_cifar10_arrays,
                                       train_split)
from mfas_tpu_torch.data.loader import ArrayLoader, MapLoader
from mfas_tpu_torch.fusion import avmnist as f_avmnist
from mfas_tpu_torch.fusion import cifar as f_cifar
from mfas_tpu_torch.fusion import ntu as f_ntu
from mfas_tpu_torch.runtime import checkpoint as ckpt
from mfas_tpu_torch.search.population import PopulationSpec
from mfas_tpu_torch.search.searcher import ModelSearcher
from mfas_tpu_torch.search.surrogate import SimpleRecurrentSurrogate
from mfas_tpu_torch.search.trainers import (CifarSearchTrainer,
                                            PopulationSearchTrainer,
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


def _load_backbones(args, extractor, checkpoints):
    """checkpoints: (attribute, file in --checkpointdir or '') pairs; each
    backbone loads its file (or keeps its initial weights under
    --random_backbones) -> attribute -> state_dict, what every sequential
    candidate loads into its backbones."""
    for attr, cp in checkpoints:
        ckpt.load_backbone(
            os.path.join(args.checkpointdir, cp) if cp else "",
            getattr(extractor, attr), random_ok=args.random_backbones)
    return {attr: getattr(extractor, attr).state_dict()
            for attr, _ in checkpoints}


def _candidate_trainer(args, spec, extractor, backbone_states, input_keys,
                       device, timer, batch_prep=None, input_prep=None,
                       group=None):
    """The sequential trainer under --sequential_candidates, else the
    population trainer with the sequential one as its weight-sharing
    fallback."""
    seq = SequentialSearchTrainer(backbone_states, input_keys, device=device,
                                  batch_prep=batch_prep, timer=timer,
                                  group=group)
    if args.sequential_candidates:
        return seq
    return PopulationSearchTrainer(
        spec, extractor, input_keys, device=device, sequential_fallback=seq,
        input_prep=input_prep, cache_features=args.cache_features,
        fused_epochs=not args.no_fused_epochs, bank_batch=args.bank_batch,
        int8_bank=args.int8_feature_bank, timer=timer, group=group,
        shard_feature_bank=args.shard_feature_bank)


class NTUSearcher(ModelSearcher):
    """trainexp for search training, dev for ranking (reference
    models/searchable.py:233-260)."""

    def __init__(self, args, *, device, jsonl_log=None, timer=None,
                 group=None):
        super().__init__(args, jsonl_log=jsonl_log, timer=timer)
        self.device = torch.device(device)
        tfm_val = ntu_data.Compose([ntu_data.NormalizeLen(args.vid_len)])
        tfm_tra = ntu_data.Compose([
            ntu_data.AugCrop(seed=0),
            ntu_data.NormalizeLen(args.vid_len)])

        dev_norm = bool(args.device_input_normalize and args.packed_datadir)
        if args.device_input_normalize and not dev_norm:
            print("WARNING: --device_input_normalize needs --packed_datadir "
                  "(mfas_tpu_torch.tools.pack_ntu) — ignored; this run "
                  "normalizes on the host")
        if args.packed_datadir:
            from mfas_tpu_torch.data.ntu_pack import PackedNTU
            ds_train = PackedNTU(
                os.path.join(args.packed_datadir, "trainexp"),
                transform=tfm_tra, args=args, device_normalize=dev_norm)
            ds_dev = PackedNTU(os.path.join(args.packed_datadir, "dev"),
                               transform=tfm_val, args=args,
                               device_normalize=dev_norm)
        else:
            vd, vf = int(args.vid_dim), int(args.vi_fr)
            ds_train = ntu_data.NTU(args.datadir, transform=tfm_tra,
                                    stage="trainexp", vid_dim=vd, vid_fr=vf,
                                    args=args)
            ds_dev = ntu_data.NTU(args.datadir, transform=tfm_val,
                                  stage="dev", vid_dim=vd, vid_fr=vf,
                                  args=args)
        self.dataloaders = {
            "train": MapLoader(ds_train, args.batchsize, shuffle=True,
                               seed=0, num_workers=args.num_workers),
            "dev": MapLoader(ds_dev, args.batchsize,
                             num_workers=args.num_workers),
        }

        extractor = f_ntu.NTUFeatureExtractor(
            args, device=self.device,
            generator=torch.Generator().manual_seed(BACKBONE_SEED))
        backbone_states = _load_backbones(
            args, extractor,
            (("skenet", args.ske_cp), ("rgbnet", args.rgb_cp)))
        self.extractor = extractor

        feature_dtype = _feature_dtype(args)
        sizes_ske, sizes_ims = f_ntu.tap_sizes(args)
        spec = PopulationSpec(
            sizes_a=tuple(sizes_ske), sizes_b=tuple(sizes_ims),
            hidden=args.inner_representation_size,
            num_outputs=args.num_outputs,
            max_rows=args.max_progression_levels, batchnorm=args.batchnorm,
            drpt=args.drpt, use_alphas=args.alphas, multitask=args.multitask,
            feature_dtype=feature_dtype)

        # host-normalized clips are float32 and go to the backbones as they
        # are (the population trainer casts them to the feature dtype); K1
        # runs only on the uint8 clips of --device_input_normalize
        batch_prep = input_prep = None
        if dev_norm:
            from mfas_tpu_torch.data.ntu_pack import (
                make_device_normalize_inputs_prep, make_device_normalize_prep)
            batch_prep = make_device_normalize_prep()
            input_prep = make_device_normalize_inputs_prep(
                torch.bfloat16 if feature_dtype else None)
        self.train_fn = _candidate_trainer(
            args, spec, extractor, backbone_states, ("rgb", "ske"),
            self.device, timer, batch_prep=batch_prep, input_prep=input_prep,
            group=group)
        self.surrogate = SimpleRecurrentSurrogate(100, 3, 100,
                                                  device=self.device)

    def search(self):
        methods = {"train_sampled_fun": self.train_fn,
                   "get_layer_confs": f_ntu.get_possible_layer_configurations}
        return self._epnas(f_ntu.Searchable_Skeleton_Image_Net,
                           {"model": self.surrogate}, self.dataloaders, methods,
                           self.device)


class AVMNISTSearcher(ModelSearcher):
    """train[0:50000] for search training, train[50000:55000] as dev
    (reference models/searchable.py:184-224)."""

    def __init__(self, args, *, device, jsonl_log=None, timer=None,
                 group=None):
        super().__init__(args, jsonl_log=jsonl_log, timer=timer)
        self.device = torch.device(device)
        arrays = load_avmnist_arrays(args.datadir, "train")
        dev_lo, dev_hi = train_dev_split(arrays["image"].shape[0])
        self.dataloaders = {
            "train": ArrayLoader(arrays, args.batchsize, shuffle=True,
                                 seed=0, indices=np.arange(0, dev_lo)),
            "dev": ArrayLoader(arrays, args.batchsize,
                               indices=np.arange(dev_lo, dev_hi)),
        }

        extractor = f_avmnist.AVMnistFeatureExtractor(
            args, device=self.device,
            generator=torch.Generator().manual_seed(BACKBONE_SEED))
        backbone_states = _load_backbones(
            args, extractor,
            (("rgbnet", args.rgb_cp), ("audnet", args.audio_cp)))
        self.extractor = extractor

        sizes_aud, sizes_ims = f_avmnist.tap_sizes(args)
        spec = PopulationSpec(
            sizes_a=tuple(sizes_aud), sizes_b=tuple(sizes_ims),
            hidden=args.inner_representation_size,
            num_outputs=args.num_outputs,
            max_rows=args.max_progression_levels, batchnorm=False,
            drpt=args.drpt, use_alphas=args.alphas, multitask=args.multitask,
            feature_dtype=_feature_dtype(args))

        self.train_fn = _candidate_trainer(
            args, spec, extractor, backbone_states, ("image", "audio"),
            self.device, timer, group=group)
        self.surrogate = SimpleRecurrentSurrogate(100, 3, 100,
                                                  device=self.device)

    def search(self):
        methods = {"train_sampled_fun": self.train_fn,
                   "get_layer_confs":
                       f_avmnist.get_possible_layer_configurations}
        model_type = f_avmnist.Searchable_Audio_Image_Net
        if self.args.randsearch:
            return self._randsearch(model_type, self.dataloaders, methods,
                                    self.device)
        return self._epnas(model_type, {"model": self.surrogate},
                           self.dataloaders, methods, self.device)


class CifarSearcher(ModelSearcher):
    """CIFAR-10 train[0:45000] for search training, train[45000:50000] as
    dev (the last n//10 rows of a smaller store), the 4-feature surrogate,
    whole-net candidates (reference models/searchable.py:270-317). Both
    loaders take the TRAIN transforms, as the reference builds both from
    the train-transform dataset (:294-297)."""

    def __init__(self, args, *, device, jsonl_log=None, timer=None,
                 group=None):
        super().__init__(args, jsonl_log=jsonl_log, timer=timer)
        self.device = torch.device(device)
        arrays = load_cifar10_arrays(args.data_dir, train=True)
        split, hi = train_split(arrays["image"].shape[0])
        self.dataloaders = {
            "train": CifarLoader(arrays, args.batchsize, train=True, seed=0,
                                 indices=np.arange(0, split)),
            "dev": CifarLoader(arrays, args.batchsize, train=True, seed=1,
                               indices=np.arange(split, hi)),
        }
        self.train_fn = CifarSearchTrainer(device=self.device, timer=timer,
                                           group=group)
        self.surrogate = SimpleRecurrentSurrogate(100, 4, 100,
                                                  device=self.device)

    def search(self):
        methods = {"train_sampled_fun": self.train_fn,
                   "get_layer_confs":
                       f_cifar.get_possible_layer_configurations}
        return self._epnas(f_cifar.Searchable_MicroCNN,
                           {"model": self.surrogate}, self.dataloaders,
                           methods, self.device)
