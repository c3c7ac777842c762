"""Offline pretrained-weight converters: torchvision model-zoo files -> the
port's checkpoints (port of tools/convert_torchvision.py; same modes and
flags).

    # 2D ResNet-50 -> center-inflated 3D video backbone
    python -m mfas_tpu_torch.tools.convert_torchvision resnet50_inflate \\
        --src resnet50-19c8e357.pth --dst rgb_backbone_init.checkpoint

    # VGG-19 features -> the GP_VGG trunk's keys
    python -m mfas_tpu_torch.tools.convert_torchvision vgg19_trunk \\
        --src vgg19-dcbb9e9d.pth --dst vgg19_trunk.checkpoint

Run it wherever the torchvision files exist; torchvision itself is not
needed. Both modes read through runtime/checkpoint.py::load_state_dict (the
zip and the legacy stream that torchvision's .pth files use, a
``module.`` prefix stripped) and write through ``save``, which the JAX
package's reader also reads. The conversion is a host transform that does
no device work, as the JAX tool's is, so it runs on the CPU.
"""

import argparse
import sys


def resnet50_inflate(src, dst, inflation="center"):
    import torch

    from mfas_tpu_torch.models.inflate import inflate_resnet_state
    from mfas_tpu_torch.models.resnet3d import inflated_resnet50
    from mfas_tpu_torch.runtime import checkpoint as ckpt

    flat2d = ckpt.load_state_dict(src)
    template = inflated_resnet50(
        device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
    inflated = inflate_resnet_state(flat2d, template, inflation=inflation,
                                    verbose=True)
    ckpt.save(inflated, dst)
    print(f"wrote {len(inflated)} tensors to {dst}")


def vgg19_trunk(src, dst):
    from mfas_tpu_torch.models.vgg import remap_torchvision_vgg_keys
    from mfas_tpu_torch.runtime import checkpoint as ckpt

    flat = ckpt.load_state_dict(src)
    remapped = remap_torchvision_vgg_keys(flat, prefix="vgg")
    if not remapped:
        sys.exit("no features.* keys found — is this a torchvision VGG?")
    ckpt.save(remapped, dst)
    print(f"wrote {len(remapped)} tensors to {dst}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("mode", choices=["resnet50_inflate", "vgg19_trunk"])
    parser.add_argument("--src", required=True)
    parser.add_argument("--dst", required=True)
    parser.add_argument("--inflation", default="center",
                        choices=["center", "mean"])
    args = parser.parse_args(argv)
    if args.mode == "resnet50_inflate":
        resnet50_inflate(args.src, args.dst, args.inflation)
    else:
        vgg19_trunk(args.src, args.dst)


if __name__ == "__main__":
    main()
