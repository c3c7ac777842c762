"""The port's host IO library (mfas_tpu_torch/data/native.py and its copy of
data/cpp/mfas_io.cpp) against the JAX package's (mfas_tpu.data.native) on
the same files and arrays, on the CPU.

Tolerances, and why:
  * the C++ skeleton parser is the same source in both packages, so its
    output is bitwise JAX's; against the numpy parser ``get_3D_skeleton``
    (Python float() then a float32 store, where C++ uses strtof) it is held
    within rtol 1e-5 / atol 1e-6, as tests/test_native_io.py holds JAX's;
  * ``gather_normalize_u8`` within 1e-6 of the numpy version: under
    -march=native g++ may contract ``v * scale + bias`` into an FMA, one
    rounding where numpy's (v/255 - mean)/std takes three;
  * ``gather_f32`` is a copy: bitwise.
"""

import numpy as np
import pytest

from mfas_tpu.data import native as jnative
from mfas_tpu.data import ntu as jntu
from mfas_tpu_torch.data import native as tnative
from mfas_tpu_torch.data import ntu as tntu

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


def make_skeleton_file(path, num_frames=5, persons=2, seed=0):
    rs = np.random.RandomState(seed)
    lines = [str(num_frames)]
    vals = rs.randn(num_frames, persons, 25, 3).astype(np.float32)
    for t in range(num_frames):
        lines.append(str(persons))
        for p in range(persons):
            lines.append("pid 0 0 0 0 0 0 0 0 1")
            lines.append("25")
            for j in range(25):
                x, y, z = vals[t, p, j]
                lines.append(f"{x:.6f} {y:.6f} {z:.6f} 0 0 0 0 0 0 0 0 2")
    path.write_text("\n".join(lines) + "\n")
    return vals


def test_library_builds_into_the_build_dir():
    lib = tnative.get_lib()
    assert lib is not None, "g++ is present here: the library must build"
    path = tnative.library_path()
    assert path.exists() and path.parent.name == "mfas_tpu_torch"
    assert path.parent.parent.name == "build"


@pytest.mark.parametrize("persons", [1, 2, 3])
def test_parser_bitwise_jax_and_close_to_numpy(tmp_path, persons):
    p = tmp_path / "S001C001P001R001A001.skeleton"
    make_skeleton_file(p, num_frames=7, persons=persons, seed=persons)
    got, n = tnative.parse_skeleton(str(p), max_frames=7)
    want, jn = jnative.parse_skeleton(str(p), max_frames=7)
    assert n == jn == 7
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tntu.get_3D_skeleton(str(p)),
                                  jntu.get_3D_skeleton(str(p)))
    np.testing.assert_allclose(got, tntu.get_3D_skeleton(str(p)),
                               rtol=1e-5, atol=1e-6)
    numpy_out, numpy_n = tnative.parse_skeleton_numpy(str(p), 7)
    assert numpy_n == 7
    np.testing.assert_allclose(got, numpy_out, rtol=1e-5, atol=1e-6)


def test_parser_one_person_and_truncation_at_max_frames(tmp_path):
    p = tmp_path / "one.skeleton"
    make_skeleton_file(p, num_frames=10, persons=1)
    got, n = tnative.parse_skeleton(str(p), max_frames=4)
    want, _ = jnative.parse_skeleton(str(p), max_frames=4)
    assert n == 10
    assert got.shape == (3, 4, 25, 2)
    assert np.all(got[:, :, :, 1] == 0)          # absent person
    np.testing.assert_array_equal(got, want)
    longer, _ = tnative.parse_skeleton(str(p), max_frames=16)
    np.testing.assert_array_equal(longer[:, :4], got)
    assert np.all(longer[:, 10:] == 0)           # padded past the file


def test_truncated_file_raises(tmp_path):
    good = ("2\n" "1\n" "0 0 0 0 0 0 0 0 0 0\n"
            "25\n" + "0.1 0.2 0.3 0 0 0 0 0 0 0 0 0\n" * 25)
    f = tmp_path / "trunc.skeleton"
    f.write_text(good)                  # the second frame is missing
    with pytest.raises(IOError):
        tnative.parse_skeleton(str(f), 8)
    with pytest.raises(IOError):
        tnative.parse_skeleton(str(tmp_path / "absent.skeleton"), 8)


def test_gather_normalize_u8_matches_jax_and_numpy():
    rs = np.random.RandomState(0)
    base = rs.randint(0, 256, (10, 4, 6, 3), np.uint8)
    idx = np.array([3, 0, 7, 7])
    got = tnative.gather_normalize_u8(base, idx, MEAN, STD, num_threads=3)
    assert got.dtype == np.float32 and got.shape == (4, 4, 6, 3)
    np.testing.assert_array_equal(
        got, jnative.gather_normalize_u8(base, idx, MEAN, STD,
                                         num_threads=3))
    want = tnative.gather_normalize_u8_numpy(base, idx, MEAN, STD)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        want, (base[idx].astype(np.float32) / 255.0 - MEAN) / STD)
    with pytest.raises(IndexError):
        tnative.gather_normalize_u8(base, np.array([10]), MEAN, STD)


def test_gather_f32_bitwise():
    rs = np.random.RandomState(1)
    base = rs.randn(8, 5, 2).astype(np.float32)
    idx = np.array([7, 1, 1, 0])
    got = tnative.gather_f32(base, idx, num_threads=2)
    np.testing.assert_array_equal(got, base[idx])
    np.testing.assert_array_equal(got, jnative.gather_f32(base, idx))
    np.testing.assert_array_equal(tnative.gather_f32_numpy(base, idx),
                                  base[idx])


def test_numpy_fallback_warns_once(monkeypatch, capsys, tmp_path):
    """Without a toolchain the entry points run their numpy versions after
    one WARNING, and get_lib() says so with None."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_build_failed", False)
    monkeypatch.setattr(tnative, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path / "no_bin"))
    assert tnative.get_lib() is None
    assert tnative.get_lib() is None
    assert capsys.readouterr().out.count("WARNING: native mfas_io") == 1
    p = tmp_path / "f.skeleton"
    make_skeleton_file(p, num_frames=3)
    got, n = tnative.parse_skeleton(str(p), 5)
    assert n == 3
    np.testing.assert_array_equal(got[:, :3], tntu.get_3D_skeleton(str(p)))
    base = np.arange(24, dtype=np.uint8).reshape(2, 4, 3)
    np.testing.assert_array_equal(
        tnative.gather_normalize_u8(base, [1], MEAN, STD),
        tnative.gather_normalize_u8_numpy(base, [1], MEAN, STD))
