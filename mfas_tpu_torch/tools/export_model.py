"""Export a found architecture's eval forward as a ``torch.export`` serving
artifact (port of tools/export_model.py; same flags and defaults).

    # NTU found net (conf table 0..4 as in main_found_ntu.py)
    python -m mfas_tpu_torch.tools.export_model ntu --conf 4 \\
        --test_cp best.checkpoint --checkpointdir ckpts --out ntu_conf4.pt2 \\
        --polymorphic_batch --check

    # AV-MNIST found net
    python -m mfas_tpu_torch.tools.export_model avmnist --conf 0 \\
        --test_cp m.checkpoint --checkpointdir ckpts --out av.pt2

The artifact holds the weights of --test_cp (a ``torch.save`` state_dict or
the JAX package's checkpoint writer), or the found CLI's initial weights
with ``--random_init``. It reloads with
``mfas_tpu_torch.runtime.export.load_exported(path, device)``, or with
``torch.export.load`` once ``mfas_tpu_torch.ops.batchnorm`` is imported:
exported on the card, its BatchNorms are that module's op
``mfas::batch_norm_eval``, which runs the fused kernels there. The serving
surface is the fused logits: NTU and AV-MNIST take their inputs as one
tuple and CIFAR as one image batch, and return output 0; MM-IMDB takes
(text, image) and returns its last output.

From the command line the model is built and exported on CUDA, and the run
fails without it; ``main(argv, device="cpu")`` exports on the CPU.
"""

import argparse
import os
import time

import torch

# BatchNorm running statistics stay float32 under --bf16, as in the JAX
# package's cast_compute (mfas_tpu/core/module.py BN_BUFFERS)
BN_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def _ntu(args, device):
    from mfas_tpu_torch.main_found_ntu import FOUND_CONFS, build_model

    model = build_model(args, FOUND_CONFS[args.conf], device)
    B, (fr, wl) = args.batch, args.vid_len
    d = args.vid_dim
    return model, ((B, fr, d, d, 3), (B, 3, wl, 25, 2)), "tuple", 0


def _avmnist(args, device):
    from mfas_tpu_torch.main_found_avmnist import FOUND_CONFS, build_model

    model = build_model(args, FOUND_CONFS[args.conf], device)
    B = args.batch
    return model, ((B, 1, 28, 28), (B, 1, 112, 112)), "tuple", 0


def _mmimdb(args, device):
    from mfas_tpu_torch.main_found_mmimdb import build_model

    model = build_model(args, device)
    B = args.batch
    h, w = args.image_size
    # the MM-IMDB nets take (text, image) and return the fused logits last
    return model, ((B, args.feat_dim), (B, 3, h, w)), "splat", -1


def _cifar(args, device):
    from mfas_tpu_torch.main_found_cifar import build_model, parse_conf

    model = build_model(args, parse_conf(args.cifar_conf), device)
    B = args.batch
    return model, ((B, 3, args.img_size, args.img_size),), "splat", 0


BUILDERS = {"ntu": _ntu, "avmnist": _avmnist, "mmimdb": _mmimdb,
            "cifar": _cifar}


class ServingForward(torch.nn.Module):
    """The artifact's forward: the model in eval mode on float32 inputs,
    computing in ``compute_dtype`` when given (inputs cast inside, logits
    returned as float32), returning output ``out_index``."""

    def __init__(self, model, call_style, out_index, compute_dtype=None):
        super().__init__()
        self.model = model
        self.call_style = call_style
        self.out_index = out_index
        self.compute_dtype = compute_dtype

    def forward(self, *inputs):
        if self.compute_dtype is not None:
            inputs = tuple(x.to(self.compute_dtype) for x in inputs)
        out = (self.model(inputs) if self.call_style == "tuple"
               else self.model(*inputs))
        if isinstance(out, (tuple, list)):
            out = out[self.out_index]
        return out.float() if self.compute_dtype is not None else out


def cast_compute(model, dtype):
    """Cast every floating parameter and buffer of ``model`` to ``dtype`` in
    place, except the BatchNorm running statistics."""
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(
                model.named_buffers()):
            if t.is_floating_point() and \
                    name.rsplit(".", 1)[-1] not in BN_BUFFERS:
                t.data = t.data.to(dtype)
    return model


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("vertical",
                   choices=("ntu", "avmnist", "mmimdb", "cifar"))
    p.add_argument("--conf", type=int, default=0)
    p.add_argument("--test_cp", type=str, default="",
                   help="full found-model checkpoint to bake in")
    p.add_argument("--checkpointdir", type=str, default=".")
    p.add_argument("--random_init", action="store_true", default=False)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--polymorphic_batch", action="store_true", default=False,
                   help="export with a SYMBOLIC batch dimension: one "
                        "artifact serves any batch size")
    p.add_argument("--check", action="store_true", default=False,
                   help="after writing, reload the artifact and run it on "
                        "zero inputs at batch 2 on this run's device")
    p.add_argument("--platforms", type=str, default="cpu,tpu,cuda",
                   help="accepted so that the JAX tool's command lines carry "
                        "over, and unused: a .pt2 artifact is not lowered "
                        "per platform; load_exported places it on the "
                        "device its caller names")
    p.add_argument("--bf16", action="store_true", default=False,
                   help="store the weights as bfloat16 and run the forward "
                        "in bf16 (BatchNorm running stats stay f32, logits "
                        "return as f32): about half the artifact's size; "
                        "its input/output interface stays f32")
    # model hyperparameters (defaults = the found-CLI defaults)
    p.add_argument("--num_outputs", type=int, default=None)
    p.add_argument("--inner_representation_size", type=int, default=None)
    p.add_argument("--channels", type=int, default=None,
                   help="default: the vertical's found-CLI default")
    p.add_argument("--vid_len", type=int, nargs="+", default=[8, 32])
    p.add_argument("--vid_dim", type=int, default=256)
    p.add_argument("--resnet3d_layers", type=int, nargs=4, default=None,
                   help="blocks per ResNet3D stage (default 3 4 6 3 = "
                        "ResNet-50); the found-CLI shrink knob")
    p.add_argument("--resnet3d_base_width", type=int, default=None)
    p.add_argument("--drpt", type=float, default=0.0)
    p.add_argument("--batchnorm", action="store_true", default=False)
    p.add_argument("--alphas", action="store_true", default=False)
    p.add_argument("--multitask", action="store_true", default=False)
    # mmimdb
    p.add_argument("--model", type=str, default="vggt_centralnet_v2",
                   help="mmimdb model name (main_found_mmimdb choices)")
    p.add_argument("--text_first_hidden", type=int, default=512)
    p.add_argument("--fusingmix", type=str, default="13,24")
    p.add_argument("--fusetype", type=str, default="cat")
    p.add_argument("--feat_dim", type=int, default=300)
    p.add_argument("--image_size", type=int, nargs=2, default=[256, 160],
                   help="(h, w) of the artifact's image input; the default "
                        "is what the MM-IMDB loader yields (posters stored "
                        "(160, 256, 3), collated channel-first to "
                        "(B, 3, 256, 160))")
    # cifar (found mode: conf rows 'op1,op2,conn1,conn2' joined by ';')
    p.add_argument("--cifar_conf", type=str,
                   default="0,1,-2,-1;2,3,-2,0",
                   help="found-mode cell rows 'op1,op2,conn1,conn2' "
                        "joined by ';' (conn in [-2, block))")
    p.add_argument("--net_str", type=int, nargs="+", default=[1, 1, 2])
    p.add_argument("--planes", type=int, default=36)
    p.add_argument("--img_size", type=int, default=32)
    p.add_argument("--drop_prob", type=float, default=0.0)
    p.add_argument("--drop_path", type=float, default=0.0)
    args = p.parse_args(argv)
    args.vid_len = tuple(args.vid_len)
    # the shrink knobs stay absent unless given, so the models' defaults
    # (the full ResNet-50) hold
    if args.resnet3d_layers is not None:
        args.resnet3d_layers = tuple(args.resnet3d_layers)
    else:
        del args.resnet3d_layers
    if args.resnet3d_base_width is None:
        del args.resnet3d_base_width
    if args.num_outputs is None:
        args.num_outputs = {"ntu": 60, "avmnist": 10, "mmimdb": 23,
                            "cifar": 10}[args.vertical]
    if args.inner_representation_size is None:
        args.inner_representation_size = 256
    if args.channels is None:
        # the AV-MNIST found CLI's default 32, MM-IMDB's 512
        args.channels = 512 if args.vertical == "mmimdb" else 32
    args.num_classes = args.num_outputs
    return args


def main(argv=None, device=None):
    """-> {"path", "bytes", "seconds", "shapes"} of the written artifact."""
    from mfas_tpu_torch.runtime import checkpoint as ckpt
    from mfas_tpu_torch.runtime.cli import cli_device
    from mfas_tpu_torch.runtime.export import load_exported, save_exported

    args = parse_args(argv)
    device = cli_device(device, "mfas_tpu_torch.tools.export_model")
    model, shapes, call_style, out_index = BUILDERS[args.vertical](args,
                                                                   device)
    if not args.random_init:
        if not args.test_cp:
            raise SystemExit("pass --test_cp <checkpoint> or --random_init")
        model.load_state_dict(ckpt.load_state_dict(
            os.path.join(args.checkpointdir, args.test_cp)), strict=True)
    compute_dtype = None
    if args.bf16:
        compute_dtype = torch.bfloat16
        cast_compute(model, compute_dtype)
    serving = ServingForward(model, call_style, out_index, compute_dtype)

    if args.polymorphic_batch:
        # example batch 2: torch specializes a dimension seen at size 1
        shapes = tuple((2,) + tuple(s[1:]) for s in shapes)
    example = tuple(torch.zeros(s, device=device) for s in shapes)
    t0 = time.time()
    n = save_exported(args.out, serving, example,
                      dynamic_batch=args.polymorphic_batch)
    seconds = time.time() - t0
    shown = [("b",) + tuple(s[1:]) if args.polymorphic_batch else tuple(s)
             for s in shapes]
    print(f"exported {args.vertical} conf {args.conf} -> {args.out} "
          f"({n} bytes, inputs {shown}) in {seconds:.1f} s")

    if args.check:
        exp = load_exported(args.out, device)
        concrete = tuple((2,) + tuple(s[1:]) for s in shapes) \
            if args.polymorphic_batch else shapes
        out = exp.call(*(torch.zeros(s) for s in concrete))
        if not torch.isfinite(out).all():
            raise SystemExit(f"--check FAILED: non-finite outputs {out}")
        print(f"check OK: reloaded artifact ran on {device}, output shape "
              f"{tuple(out.shape)}")
    return {"path": args.out, "bytes": n, "seconds": seconds,
            "shapes": [list(s) for s in shown]}


if __name__ == "__main__":
    main()
