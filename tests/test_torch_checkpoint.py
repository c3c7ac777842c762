"""The port's checkpoint loader (mfas_tpu_torch/runtime/checkpoint.py::
load_state_dict, ``torch.load(weights_only=True)``) against the JAX
package's torch-free codec (mfas_tpu/runtime/checkpoint.py) in the cases of
tests/test_checkpoint.py: each file is read by both, and both give the same
keys, values and dtypes (or both refuse it)."""

import pickle
import zipfile

import ml_dtypes
import numpy as np
import pytest
import torch

from mfas_tpu.runtime import checkpoint as jckpt
from mfas_tpu_torch.runtime import checkpoint as tckpt


def make_torch_model():
    return torch.nn.Sequential(
        torch.nn.Conv2d(3, 4, 3, padding=1),
        torch.nn.BatchNorm2d(4),
        torch.nn.Linear(7, 5),
    )


def _same(port, jax_flat):
    assert set(port) == set(jax_flat)
    for k, v in port.items():
        assert isinstance(v, torch.Tensor), k
        want = np.asarray(jax_flat[k])
        if want.dtype == ml_dtypes.bfloat16:
            assert v.dtype == torch.bfloat16, k
            np.testing.assert_array_equal(v.float().numpy(),
                                          want.astype(np.float32))
        else:
            assert v.numpy().dtype == want.dtype, k
            np.testing.assert_array_equal(v.numpy(), want)


def _modern(path, sd):
    torch.save(sd, str(path))


def _legacy(path, sd):
    torch.save(sd, str(path), _use_new_zipfile_serialization=False)


def _prefixed(path, sd):
    torch.save({"module." + k: v for k, v in sd.items()}, str(path))


def _jax_written(path, sd):
    jckpt.save({k: v.numpy() for k, v in sd.items()}, str(path))


@pytest.mark.parametrize("write", [_modern, _legacy, _prefixed,
                                   _jax_written],
                         ids=["modern_zip", "legacy", "module_prefix",
                              "jax_codec"])
def test_reads_what_the_jax_codec_reads(tmp_path, write):
    sd = make_torch_model().state_dict()
    path = tmp_path / "m.checkpoint"
    write(path, sd)
    port = tckpt.load_state_dict(str(path))
    _same(port, jckpt.load_state_dict(str(path)))
    assert set(port) == set(sd)
    assert port["1.num_batches_tracked"].dtype == torch.int64
    make_torch_model().load_state_dict(port, strict=True)


def test_refuses_arbitrary_globals(tmp_path):
    class Evil:
        def __reduce__(self):
            import os
            return (os.system, ("echo pwned > " + str(tmp_path / "pwned"),))

    path = tmp_path / "evil.checkpoint"
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("archive/data.pkl", pickle.dumps({"x": Evil()}))
        z.writestr("archive/version", "3")
    with pytest.raises(Exception) as je:
        jckpt.load_state_dict(str(path))
    assert "disallowed global" in str(je.value)
    with pytest.raises(pickle.UnpicklingError):
        tckpt.load_state_dict(str(path))
    assert not (tmp_path / "pwned").exists()


def test_bf16_roundtrip(tmp_path):
    sd = {"w": np.arange(6, dtype=np.float32).reshape(2, 3)
          .astype(ml_dtypes.bfloat16),
          "b": np.ones((3,), np.float32)}
    path = tmp_path / "bf16.checkpoint"
    jckpt.save(sd, str(path))
    port = tckpt.load_state_dict(str(path))
    assert port["w"].dtype == torch.bfloat16
    _same(port, jckpt.load_state_dict(str(path)))
    # and the port's writer is read back by the JAX codec
    out = tmp_path / "port.checkpoint"
    tckpt.save(port, str(out))
    _same(port, jckpt.load_state_dict(str(out)))


def test_unwraps_the_training_wrapper(tmp_path):
    inner = {"lin.weight": np.ones((2, 2), np.float32),
             "lin.bias": np.zeros((2,), np.float32)}
    path = tmp_path / "wrapped.checkpoint"
    jckpt.save({"state_dict": inner, "epoch": 3}, str(path))
    port = tckpt.load_state_dict(str(path))
    assert set(port) == set(inner)
    _same(port, jckpt.load_state_dict(str(path)))


@pytest.mark.parametrize("obj", [
    {"model": {"lin.weight": np.ones((2, 2), np.float32)}, "epoch": 3},
    {"lin.weight": np.ones((2, 2), np.float32), "note": "trained"},
], ids=["nested_model", "string_entry"])
def test_refuses_non_tensor_entries(tmp_path, obj):
    """A checkpoint whose entries are not tensors is not a state_dict: both
    loaders refuse it and name the entry."""
    path = tmp_path / "other.checkpoint"
    jckpt.save(obj, str(path))
    bad = [k for k, v in obj.items() if not isinstance(v, (np.ndarray,
                                                           int))]
    with pytest.raises(ValueError, match="not tensors") as je:
        jckpt.load_state_dict(str(path))
    with pytest.raises(ValueError, match="not tensors") as te:
        tckpt.load_state_dict(str(path))
    for k in bad:
        assert repr(k) in str(te.value) and repr(k) in str(je.value)


def test_python_scalars_become_tensors(tmp_path):
    """A flat dict with a Python scalar beside the tensors loads in both
    packages, the scalar as a 0-d array / tensor."""
    path = tmp_path / "scalar.checkpoint"
    torch.save({"w": torch.ones(2), "step": 3, "lr": 0.5}, str(path))
    port = tckpt.load_state_dict(str(path))
    _same(port, jckpt.load_state_dict(str(path)))
    assert port["step"].item() == 3 and port["step"].dim() == 0
