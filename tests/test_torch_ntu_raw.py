"""The raw NTU layout and the packed store, JAX package against the port, on
the CPU (needs cv2 for the AVI fixtures).

On a fixture built with tests/test_integration_ntu_cli.py::build_ntu_fixture
and the layouts of tests/test_data.py:
  * ``NTU``: the same rgb_list, ske_list and labels per split; seeded samples
    bitwise equal with and without AugCrop; the stem-pairing warning and
    drop; the --no_bad_skel filter;
  * ``pack_ntu``: the five files byte-equal to those JAX's pack_ntu writes;
  * host-normalized ``PackedNTU`` within 1e-6 of JAX's (the same C++ code;
    1e-6 allows for a numpy fallback on either side);
  * the host-normalized clip against K1's plain version on the uint8 clip
    within 1e-5 (the FMA-contracted host affine against torch's two
    roundings), as tests/test_native_io.py:71 holds JAX's two paths.
"""

import argparse
import types

import numpy as np
import pytest
import torch

from mfas_tpu.data import ntu as jntu
from mfas_tpu.data import ntu_pack as jpack
from mfas_tpu_torch.data import ntu as tntu
from mfas_tpu_torch.data import ntu_pack as tpack
from mfas_tpu_torch.ops import input_kernels as tk

cv2 = pytest.importorskip("cv2")

from tests.test_integration_ntu_cli import build_ntu_fixture  # noqa: E402

ARGS = types.SimpleNamespace(modality="both", no_norm=False,
                             no_bad_skel=False)
# subjects: 1 (train, trainexp), 2 (dev), 3 (test)
STAGES = ("train", "trainexp", "dev", "test")


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = tmp_path_factory.mktemp("ntu_raw")
    build_ntu_fixture(root, subjects=(1, 2, 3), n_actions=4, frames=12)
    return root


def _tfm(ntu, aug):
    ts = ([ntu.AugCrop(seed=3)] if aug else []) + [ntu.NormalizeLen((4, 16))]
    return ntu.Compose(ts)


@pytest.mark.parametrize("stage", STAGES)
def test_ntu_lists_match_jax(raw, stage):
    j = jntu.NTU(str(raw), stage=stage, args=ARGS, shuffle_seed=5)
    t = tntu.NTU(str(raw), stage=stage, args=ARGS, shuffle_seed=5)
    assert len(t) == len(j) == 4
    assert t.rgb_list == j.rgb_list and t.ske_list == j.ske_list
    assert t.labels == j.labels


@pytest.mark.parametrize("aug", [False, True])
def test_ntu_seeded_samples_bitwise_jax(raw, aug):
    j = jntu.NTU(str(raw), transform=_tfm(jntu, aug), stage="train",
                 args=ARGS)
    t = tntu.NTU(str(raw), transform=_tfm(tntu, aug), stage="train",
                 args=ARGS)
    for i in range(len(t)):
        a, b = j.getitem_seeded(i, 100 + i), t.getitem_seeded(i, 100 + i)
        assert a.keys() == b.keys()
        assert b["rgb"].dtype == np.float32 and b["rgb"].shape == (4, 32,
                                                                   32, 3)
        assert b["ske"].shape == (3, 16, 25, 2)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_load_video_legacy_quirk_and_raw_decode(raw):
    path = tntu.NTU(str(raw), stage="test", args=ARGS).rgb_list[0]
    for legacy in (False, True):
        got = tntu.load_video(path, vid_len=8, legacy_last_frame_zero=legacy)
        want = jntu.load_video(path, vid_len=8,
                               legacy_last_frame_zero=legacy)
        np.testing.assert_array_equal(got, want)
    assert np.all(got[-1] == 0)                  # the reference's quirk


def test_load_video_without_cv2_names_pack_ntu(monkeypatch):
    import builtins
    real = builtins.__import__

    def no_cv2(name, *a, **k):
        if name == "cv2":
            raise ImportError("no cv2")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(RuntimeError, match="cv2.*pack_ntu"):
        tntu.load_video("x.avi")


def _write_skeleton(path, frames=8):
    lines = [str(frames)]
    for _ in range(frames):
        lines += ["1", "pid 0 0 0 0 0 0 0 0 1", "25"]
        lines += ["0.5 0.5 0.5 0 0 0 0 0 0 0 0 2"] * 25
    path.write_text("\n".join(lines) + "\n")


def _write_avi(path, frames=8):
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 30,
                         (32, 32))
    for t in range(frames):
        vw.write(np.full((32, 32, 3), t * 10, np.uint8))
    vw.release()


def test_pairs_by_stem_warns_and_drops(tmp_path, capsys):
    rgb_dir = tmp_path / "nturgbd_rgb" / "avi_256x256_30"
    ske_dir = tmp_path / "nturgbd_skeletons"
    rgb_dir.mkdir(parents=True)
    ske_dir.mkdir(parents=True)
    names = ["S001C001P001R001A001", "S001C001P001R001A002",
             "S001C001P001R001A003"]
    for name in names:
        _write_avi(rgb_dir / f"{name}_rgb.avi")
    for name in names[1:]:
        _write_skeleton(ske_dir / f"{name}.skeleton")
    j = jntu.NTU(str(tmp_path), stage="train", args=ARGS)
    jout = capsys.readouterr().out
    t = tntu.NTU(str(tmp_path), stage="train", args=ARGS)
    tout = capsys.readouterr().out
    assert "no .skeleton pair" in tout and tout == jout
    assert len(t) == 2 and sorted(t.labels) == [2, 3]
    assert (t.rgb_list, t.ske_list, t.labels) == (j.rgb_list, j.ske_list,
                                                  j.labels)


def test_no_bad_skel_filter(tmp_path):
    bad = tntu.load_bad_skeleton_ids()
    assert bad == jntu.load_bad_skeleton_ids() and len(bad) == 302
    # one listed id of a train subject, one clip that is not listed
    listed = next(s for s in bad if int(s[9:12]) in tntu.SPLITS["train"])
    kept = listed[:16] + "A099"
    assert kept not in bad
    rgb_dir = tmp_path / "nturgbd_rgb" / "avi_256x256_30"
    ske_dir = tmp_path / "nturgbd_skeletons"
    rgb_dir.mkdir(parents=True)
    ske_dir.mkdir(parents=True)
    for name in (listed, kept):
        _write_avi(rgb_dir / f"{name}_rgb.avi")
        _write_skeleton(ske_dir / f"{name}.skeleton")
    filt = argparse.Namespace(modality="both", no_norm=False,
                              no_bad_skel=True)
    for args, want in ((ARGS, 2), (filt, 1)):
        j = jntu.NTU(str(tmp_path), stage="train", args=args)
        t = tntu.NTU(str(tmp_path), stage="train", args=args)
        assert len(t) == want
        assert (t.rgb_list, t.ske_list, t.labels) == (j.rgb_list,
                                                      j.ske_list, j.labels)
    assert t.labels == [99]


@pytest.fixture(scope="module")
def packed(raw, tmp_path_factory):
    out = tmp_path_factory.mktemp("ntu_packed")
    for pkg, ntu_pack in (("jax", jpack), ("torch", tpack)):
        n = ntu_pack.pack_ntu(str(raw), str(out / pkg / "test"), "test",
                              args=ARGS, frames=8, max_skel_frames=10,
                              verbose=False)
        assert n == 4
    return out


def test_pack_ntu_writes_the_jax_store_byte_for_byte(packed):
    for f in ("rgb.npy", "ske.npy", "ske_len.npy", "labels.npy",
              "meta.json"):
        assert (packed / "torch" / "test" / f).read_bytes() == \
            (packed / "jax" / "test" / f).read_bytes(), f
    assert np.load(packed / "torch" / "test" / "ske_len.npy").tolist() == \
        [10] * 4                      # 12 frames cut to max_skel_frames


@pytest.mark.parametrize("aug", [False, True])
def test_host_normalized_packed_matches_jax(packed, aug):
    d = str(packed / "torch" / "test")
    j = jpack.PackedNTU(d, _tfm(jntu, aug), ARGS)
    t = tpack.PackedNTU(d, _tfm(tntu, aug), ARGS)
    assert len(t) == len(j) == 4
    for i in range(len(t)):
        a, b = j.getitem_seeded(i, i), t.getitem_seeded(i, i)
        assert b["rgb"].dtype == np.float32
        assert b["rgb"].shape == (4, 32, 32, 3)
        np.testing.assert_allclose(b["rgb"], a["rgb"], rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(b["ske"], a["ske"])
        assert b["label"] == a["label"]


def test_host_normalized_and_k1_paths_agree(packed):
    d = str(packed / "torch" / "test")
    tfm = _tfm(tntu, False)
    host = tpack.PackedNTU(d, tfm, ARGS)
    dev = tpack.PackedNTU(d, tfm, ARGS, device_normalize=True)
    prep = tpack.make_device_normalize_prep()
    tk.reset_launch_counts()
    for i in range(len(host)):
        h, u = host[i], dev[i]
        assert u["rgb"].dtype == np.uint8
        got = prep({"rgb": torch.from_numpy(u["rgb"][None])})["rgb"][0]
        np.testing.assert_allclose(got.numpy(), h["rgb"], rtol=1e-5,
                                   atol=1e-5)
        # a host-normalized float clip passes the prep unchanged
        same = prep({"rgb": torch.from_numpy(h["rgb"][None])})["rgb"][0]
        np.testing.assert_array_equal(same.numpy(), h["rgb"])
    assert tk.launch_counts == {"u8_normalize": 0, "u8_gather_normalize": 0}
