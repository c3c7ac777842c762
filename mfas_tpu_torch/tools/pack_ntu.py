"""One-time NTU packing (port of tools/pack_ntu.py; same flags and
defaults): decode every AVI of the raw layout once into the store that
--packed_datadir reads (mfas_tpu_torch.data.ntu_pack), in the JAX
package's layout.

    python -m mfas_tpu_torch.tools.pack_ntu --datadir .../NTU \\
        --out .../NTU_packed --stages train dev test trainexp

Needs cv2 (the AVI decode); runs on the host only.
"""

import argparse
import os
import types


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--datadir", required=True,
                        help="raw NTU root (nturgbd_rgb/, nturgbd_skeletons/)")
    parser.add_argument("--out", required=True, help="output root")
    parser.add_argument("--stages", nargs="+",
                        default=["train", "dev", "test"],
                        choices=["train", "trainexp", "dev", "test"])
    parser.add_argument("--frames", type=int, default=24,
                        help="decoded frames per clip (reference load_video "
                             "default)")
    parser.add_argument("--max_skel_frames", type=int, default=300)
    parser.add_argument("--vid_dim", type=int, default=256)
    parser.add_argument("--vid_fr", type=int, default=30)
    parser.add_argument("--no_bad_skel", action="store_true", default=False)
    return parser.parse_args(argv)


def main(argv=None):
    """-> {stage: samples packed}."""
    from mfas_tpu_torch.data.ntu_pack import pack_ntu

    args = parse_args(argv)
    ds_args = types.SimpleNamespace(modality="both", no_norm=False,
                                    no_bad_skel=args.no_bad_skel)
    counts = {}
    for stage in args.stages:
        out = os.path.join(args.out, stage)
        print(f"packing stage {stage} -> {out}")
        counts[stage] = n = pack_ntu(
            args.datadir, out, stage, args=ds_args, frames=args.frames,
            max_skel_frames=args.max_skel_frames, vid_dim=args.vid_dim,
            vid_fr=args.vid_fr)
        print(f"  {n} samples")
    return counts


if __name__ == "__main__":
    main()
