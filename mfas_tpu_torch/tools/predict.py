"""Offline batch inference: drive an exported ``torch.export`` artifact
(mfas_tpu_torch.tools.export_model) over a dataset split and write its
predictions (port of tools/predict.py; same flags and defaults).

    # NTU test split of a packed store through an exported conf-4 net
    python -m mfas_tpu_torch.tools.predict ntu --artifact ntu_conf4.pt2 \\
        --packed_datadir data/NTU_packed --batchsize 20 --out preds.npy

    # AV-MNIST
    python -m mfas_tpu_torch.tools.predict avmnist --artifact av.pt2 \\
        --datadir data/avmnist --out preds.npy

NTU reads the raw layout (--datadir) or a packed store (--packed_datadir),
both normalized on the host, as the JAX tool does. Prints the split's
metric when labels are present (top-1 accuracy; MM-IMDB: samples-F1 at
sigmoid > 0.3, the reference's protocol) and saves the fused logits, the
padding rows of a ragged last batch dropped, as an .npy. The artifact's
batch dimension must match --batchsize unless it was exported with
--polymorphic_batch.

From the command line the artifact runs on CUDA, and the run fails without
it; ``main(argv, device="cpu")`` runs it on the CPU.
"""

import argparse
import os
import time

import numpy as np

# (input batch keys in artifact call order)
INPUT_KEYS = {
    "ntu": ("rgb", "ske"),
    "avmnist": ("image", "audio"),
    "mmimdb": ("text", "image"),
    "cifar": ("image",),
}


def _ntu_loader(args):
    from mfas_tpu_torch.data import ntu as d
    from mfas_tpu_torch.data.loader import MapLoader

    tfm_val = d.Compose([d.NormalizeLen(tuple(args.vid_len))])
    if args.packed_datadir:
        from mfas_tpu_torch.data.ntu_pack import PackedNTU
        ds = PackedNTU(os.path.join(args.packed_datadir, args.split),
                       transform=tfm_val, args=args)
    else:
        ds = d.NTU(args.datadir, transform=tfm_val, stage=args.split,
                   vid_dim=args.vid_dim, vid_fr=args.vid_fr, args=args)
    return MapLoader(ds, args.batchsize, num_workers=args.num_workers)


def _avmnist_loader(args):
    from mfas_tpu_torch.data.avmnist import load_avmnist_arrays
    from mfas_tpu_torch.data.loader import ArrayLoader

    stage = "test" if args.split == "test" else "train"
    return ArrayLoader(load_avmnist_arrays(args.datadir, stage),
                       args.batchsize)


def _mmimdb_loader(args):
    from mfas_tpu_torch.data.mm_imdb import MM_IMDB, MMIMDBLoader

    ds = MM_IMDB(args.datadir, stage=args.split, feat_dim=args.feat_dim,
                 average_text=True, len_data=args.len_data)
    return MMIMDBLoader(ds, args.batchsize)


def _cifar_loader(args):
    from mfas_tpu_torch.data.cifar import CifarLoader, load_cifar10_arrays

    arrays = load_cifar10_arrays(args.datadir, train=args.split != "test")
    return CifarLoader(arrays, args.batchsize, train=False)


LOADERS = {"ntu": _ntu_loader, "avmnist": _avmnist_loader,
           "mmimdb": _mmimdb_loader, "cifar": _cifar_loader}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("vertical", choices=("ntu", "avmnist", "mmimdb", "cifar"))
    p.add_argument("--artifact", type=str, required=True,
                   help="a .pt2 from mfas_tpu_torch.tools.export_model")
    p.add_argument("--out", type=str, default="",
                   help="write the fused logits here (.npy)")
    p.add_argument("--split", type=str, default="test")
    p.add_argument("--batchsize", type=int, default=8)
    p.add_argument("--datadir", type=str, default="")
    p.add_argument("--packed_datadir", type=str, default="",
                   help="ntu: packed store (mfas_tpu_torch.tools.pack_ntu) "
                        "instead of AVIs")
    p.add_argument("--vid_len", type=int, nargs="+", default=[8, 32])
    p.add_argument("--vid_dim", type=int, default=256)
    p.add_argument("--vid_fr", type=int, default=30,
                   help="ntu: frame rate of the AVI directory "
                        "(avi_{dim}x{dim}_{fr}); main_found_ntu's --vid_fr")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--feat_dim", type=int, default=300)
    p.add_argument("--len_data", type=int, default=None,
                   help="mmimdb: override the split's sample count "
                        "(default: the reference split sizes)")
    p.add_argument("--modality", type=str, default="both")
    p.add_argument("--no_norm", action="store_true", default=False)
    p.add_argument("--no_bad_skel", action="store_true", default=False)
    args = p.parse_args(argv)
    args.vid_len = tuple(args.vid_len)
    return args


def main(argv=None, device=None):
    """-> {"logits", "labels", "metric", "value", "samples", "seconds"}:
    the fused logits of the valid rows, their labels (or None), the printed
    metric's name and value, and the wall time of the pass."""
    from mfas_tpu_torch.runtime.cli import cli_device
    from mfas_tpu_torch.runtime.export import load_exported

    args = parse_args(argv)
    device = cli_device(device, "mfas_tpu_torch.tools.predict")
    exp = load_exported(args.artifact, device)
    loader = LOADERS[args.vertical](args)
    keys = INPUT_KEYS[args.vertical]

    logits_parts, labels_parts = [], []
    t0 = time.time()
    for batch in loader:
        inputs = tuple(np.asarray(batch[k], np.float32) for k in keys)
        out = exp.call(*inputs).float().cpu().numpy()
        keep = np.asarray(batch["_mask"]) > 0
        logits_parts.append(out[keep])
        if "label" in batch:
            labels_parts.append(np.asarray(batch["label"])[keep])
    seconds = time.time() - t0
    logits = np.concatenate(logits_parts, axis=0)
    n = len(logits)
    print(f"predicted {n} samples in {seconds:.2f} s "
          f"({n / seconds:.1f} samples/s on {device})")

    labels = metric = value = None
    if labels_parts:
        labels = np.concatenate(labels_parts, axis=0)
        if args.vertical == "mmimdb":
            from mfas_tpu_torch.data.mm_imdb import samples_f1
            pred = (1.0 / (1.0 + np.exp(-logits)) > 0.3).astype(np.float32)
            metric, value = "samples-F1", samples_f1(labels, pred)
            print(f"samples-F1: {value:.6f}  ({n} samples)")
        else:
            metric = "top-1 accuracy"
            value = float((logits.argmax(axis=1) == labels).mean())
            print(f"top-1 accuracy: {value:.6f}  ({n} samples)")

    if args.out:
        np.save(args.out, logits)
        print(f"wrote {logits.shape} logits -> {args.out}")
    return {"logits": logits, "labels": labels, "metric": metric,
            "value": value, "samples": n, "seconds": seconds}


if __name__ == "__main__":
    main()
