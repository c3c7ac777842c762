"""The found-NTU --test_cp slice, JAX package against the port, on the CPU.

A JAX-written checkpoint (mfas_tpu.runtime.checkpoint.save) of a small
found-conf-4 net and a synthetic packed store with a ragged last test batch
go through JAX's ``main_found_ntu.main`` and the port's
``mfas_tpu_torch.main_found_ntu.main(argv, device="cpu")``, on both input
paths (--device_input_normalize and --hbm_resident): the same Model Acc, and
the fused logits of the valid rows within rtol 1e-4 / atol 1e-5 (conv
summation order differs between XLA and oneDNN). The loaders of the two
packages yield the same batches, and the port's resident and streamed paths
agree: uint8 clips exactly, skeletons to 1e-6 (the resident path centres
the skeleton after the time resample, a different float association).
"""

import argparse
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import main_found_ntu as jmain
from mfas_tpu.core import Ctx, flatten_tree, unflatten_tree
from mfas_tpu.data import loader as jloader
from mfas_tpu.data import ntu as jntu
from mfas_tpu.data import ntu_pack as jpack
from mfas_tpu.data import resident as jres
from mfas_tpu.fusion.ntu import Searchable_Skeleton_Image_Net
from mfas_tpu.runtime import checkpoint as jckpt
from mfas_tpu_torch import main_found_ntu as tmain
from mfas_tpu_torch.data import loader as tloader
from mfas_tpu_torch.data import ntu as tntu
from mfas_tpu_torch.data import ntu_pack as tpack
from mfas_tpu_torch.data import resident as tres
from mfas_tpu_torch.engine.classifier import valid_rows
from mfas_tpu_torch.ops import input_kernels as tk

SPLITS = {"train": 3, "dev": 3, "test": 5}     # test: batches of 2, 2, 1
PATHS = {"packed": ["--device_input_normalize"], "resident": ["--hbm_resident"]}


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("found_ntu")
    packed = root / "packed"
    for seed, (split, n) in enumerate(SPLITS.items()):
        tpack.make_synthetic_packed_ntu(str(packed / split), n=n, frames=6,
                                        h=32, w=32, skel_frames=40,
                                        num_classes=3, seed=seed)
    argv = ["--checkpointdir", str(root), "--test_cp", "net.checkpoint",
            "--packed_datadir", str(packed), "--conf", "4",
            "--num_outputs", "3", "--batchsize", "2",
            "--inner_representation_size", "16", "--batchnorm",
            "--vid_len", "4", "32", "--resnet3d_layers", "1", "1", "1", "1",
            "--resnet3d_base_width", "8", "--j", "2"]
    args = tmain.parse_args(argv)
    model = Searchable_Skeleton_Image_Net(args, jmain.FOUND_CONFS[4])
    rs = np.random.RandomState(0)
    flat = {}
    for k, v in flatten_tree(model.init(0)).items():
        v = np.asarray(v)
        if k.endswith("running_mean"):
            v = (rs.randn(*v.shape) * 0.1).astype(np.float32)
        elif k.endswith("running_var"):
            v = rs.uniform(0.5, 1.5, v.shape).astype(np.float32)
        flat[k] = v
    jckpt.save(flat, str(root / "net.checkpoint"))
    tree = unflatten_tree({k: jnp.asarray(v) for k, v in flat.items()})
    return dict(root=root, packed=packed, argv=argv, model=model, tree=tree)


def _jax_test_cp(monkeypatch, capsys, argv):
    """JAX's CLI in-process -> its printed Model Acc."""
    monkeypatch.setattr(sys, "argv", ["main_found_ntu.py", *argv])
    jmain.main()
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith("Model Acc: ")]
    return float(line[-1].split(": ")[1])


def _jax_fused_logits(fx, argv, monkeypatch):
    """The fused logits (valid rows) of JAX's net over JAX's test loader,
    through the batch_prep its --test_cp path builds."""
    monkeypatch.setattr(sys, "argv", ["main_found_ntu.py", *argv])
    args = jmain.parse_args()
    if args.hbm_resident:
        prep = jres.make_resident_prep(no_norm=args.no_norm)
    else:
        prep = jpack.make_device_normalize_prep()
    model = fx["model"]

    @jax.jit
    def fused(tree, batch):
        b = prep(batch)
        return model.apply(tree, Ctx(train=False), (b["rgb"], b["ske"]))[0]

    rows = []
    for batch in jmain.get_dataloaders(args)["test"]:
        mask = np.asarray(batch["_mask"])
        batch = {k: v if isinstance(v, jax.Array) else jnp.asarray(v)
                 for k, v in batch.items()}
        rows.append(np.asarray(fused(fx["tree"], batch))[mask > 0])
    return np.concatenate(rows).astype(np.float64)


@pytest.mark.parametrize("path", list(PATHS))
def test_test_cp_slice_matches_jax(fixture, path, monkeypatch, capsys):
    argv = fixture["argv"] + PATHS[path]
    jax_acc = _jax_test_cp(monkeypatch, capsys, argv)
    jax_logits = _jax_fused_logits(fixture, argv, monkeypatch)

    tk.reset_launch_counts()
    acc, record = tmain.main(argv, device="cpu")
    out = capsys.readouterr().out
    assert f"Model Acc: {acc}" in out
    assert acc == jax_acc
    assert record.clips == SPLITS["test"]
    assert [m.tolist() for m in record.masks] == [[1, 1], [1, 1], [1, 0]]
    got = valid_rows(record)
    assert got.shape == (SPLITS["test"], 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, jax_logits, rtol=1e-4, atol=1e-5)
    # CPU tensors run the plain versions: no kernel launch
    assert tk.launch_counts == {"u8_normalize": 0, "u8_gather_normalize": 0}


def _tfm(kind, vid_len=(4, 32)):
    ntu = tntu if kind == "torch" else jntu
    return ntu.Compose([ntu.AugCrop(), ntu.NormalizeLen(vid_len)])


def test_packed_loader_batches_match_jax(fixture):
    """Shuffled train split through AugCrop: same order, same augmentation
    draws, same raw uint8 clips and skeletons."""
    d = str(fixture["packed"] / "train")
    args = argparse.Namespace(modality="both", no_norm=False)
    jl = jloader.MapLoader(jpack.PackedNTU(d, _tfm("jax"), args,
                                           device_normalize=True),
                           2, shuffle=True, num_workers=2)
    tl = tloader.MapLoader(tpack.PackedNTU(d, _tfm("torch"), args,
                                           device_normalize=True),
                           2, shuffle=True, num_workers=2)
    for _ in range(2):                       # two epochs: the RNG carries on
        jb, tb = list(jl), list(tl)
        assert len(jb) == len(tb) == 2
        for a, b in zip(jb, tb):
            assert a.keys() == b.keys()
            assert b["rgb"].dtype == np.uint8
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_resident_loader_batches_match_jax(fixture):
    """Shuffled, augmented resident index plans match JAX's exactly; the
    port's on-device prep matches JAX's (clips within the FMA rounding,
    skeletons to 1e-6)."""
    d = str(fixture["packed"] / "train")
    args = argparse.Namespace(modality="both")
    jl = jres.ResidentLoader(jres.ResidentNTUStore(d, args=args), 2,
                             _tfm("jax"), shuffle=True)
    tl = tres.ResidentLoader(tres.ResidentNTUStore(d, "cpu", args=args), 2,
                             _tfm("torch"), shuffle=True)
    jprep = jres.make_resident_prep()
    for a, b in zip(list(jl), list(tl)):
        for k in ("_idx", "label", "_mask", "rgb_t", "ske_lo", "ske_hi",
                  "ske_w"):
            np.testing.assert_array_equal(a[k], b[k])
        want = jprep({k: jnp.asarray(v) for k, v in a.items()})
        for fuse in (True, False):
            got = tres.make_resident_prep(fuse_gather=fuse)(
                {k: tloader.to_device(v, "cpu") for k, v in b.items()})
            np.testing.assert_allclose(got["rgb"].numpy(),
                                       np.asarray(want["rgb"]),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(got["ske"].numpy(),
                                       np.asarray(want["ske"]), atol=1e-6)


def test_port_resident_and_streamed_paths_agree(fixture):
    """The test split through the port's two input paths: the resident
    gather picks the streamed path's uint8 frames exactly; skeletons agree
    to 1e-6."""
    d = str(fixture["packed"] / "test")
    args = argparse.Namespace(modality="both", no_norm=False)
    tfm = tntu.Compose([tntu.NormalizeLen((4, 32))])
    streamed = tloader.MapLoader(tpack.PackedNTU(d, tfm, args,
                                                 device_normalize=True),
                                 2, num_workers=2)
    store = tres.ResidentNTUStore(d, "cpu", args=args)
    prep = tres.make_resident_prep()
    for s, r in zip(streamed, tres.ResidentLoader(store, 2, tfm)):
        idx, rgb_t = r["_idx"], r["rgb_t"]
        clips = store.rgb_dev.numpy()[idx[:, None], rgb_t]
        np.testing.assert_array_equal(clips, s["rgb"])
        ske = prep({k: tloader.to_device(v, "cpu") for k, v in r.items()})
        np.testing.assert_allclose(ske["ske"].numpy(), s["ske"], atol=1e-6)
        np.testing.assert_array_equal(r["label"], s["label"])
        np.testing.assert_array_equal(r["_mask"], s["_mask"])


def test_synthetic_store_is_the_jax_store(tmp_path):
    jpack.make_synthetic_packed_ntu(str(tmp_path / "j"), n=2, frames=3, h=8,
                                    w=8, skel_frames=5, seed=3)
    tpack.make_synthetic_packed_ntu(str(tmp_path / "t"), n=2, frames=3, h=8,
                                    w=8, skel_frames=5, seed=3)
    for f in ("rgb.npy", "ske.npy", "ske_len.npy", "labels.npy", "meta.json"):
        assert (tmp_path / "j" / f).read_bytes() == (tmp_path / "t" /
                                                     f).read_bytes()


# --------------------------------------------------------------------------
# the command line
# --------------------------------------------------------------------------
def _grab_parser(monkeypatch, parse):
    """Run ``parse`` with argparse's parse_args intercepted -> the parser."""
    grabbed = []
    orig = argparse.ArgumentParser.parse_args

    def spy(self, args=None, namespace=None):
        grabbed.append(self)
        return orig(self, [], namespace)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", spy)
    parse()
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", orig)
    return grabbed[-1]


def _signature(parser):
    return {tuple(a.option_strings): (a.dest, a.default, a.nargs, a.type,
                                      a.const, type(a).__name__)
            for a in parser._actions if a.option_strings != ["-h", "--help"]}


def test_parser_has_the_jax_option_strings_and_defaults(monkeypatch):
    jp = _grab_parser(monkeypatch, jmain.parse_args)
    tp = _grab_parser(monkeypatch, tmain.parse_args)
    assert _signature(tp) == _signature(jp)
    monkeypatch.setattr(sys, "argv", ["main_found_ntu.py"])
    assert vars(tmain.parse_args([])) == vars(jmain.parse_args())
    assert {k: v.tolist() for k, v in tmain.FOUND_CONFS.items()} == {
        k: v.tolist() for k, v in jmain.FOUND_CONFS.items()}


UNPORTED = {
    "training": [],
    "bf16": ["--test_cp", "x", "--packed_datadir", "p", "--hbm_resident",
             "--bf16"],
    "dataparallel": ["--test_cp", "x", "--packed_datadir", "p",
                     "--hbm_resident", "--use_dataparallel"],
    "dist": ["--test_cp", "x", "--packed_datadir", "p", "--hbm_resident",
             "--dist_num_processes", "2"],
    "raw_avi": ["--test_cp", "x"],
    "host_normalize": ["--test_cp", "x", "--packed_datadir", "p"],
    "channels_last": ["--test_cp", "x", "--packed_datadir", "p",
                      "--hbm_resident", "--conv_channels_last"],
    "save_checkpoint": ["--test_cp", "x", "--packed_datadir", "p",
                        "--hbm_resident", "--save_checkpoint"],
}


@pytest.mark.parametrize("case", list(UNPORTED))
def test_unported_flags_stop_and_name_the_roadmap_item(case):
    with pytest.raises(SystemExit, match="ROADMAP.md"):
        tmain.main(UNPORTED[case], device="cpu")


def test_command_line_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--test_cp", "x", "--packed_datadir", "p", "--hbm_resident"]
    with pytest.raises(SystemExit, match="CUDA"):
        tmain.main(argv)
