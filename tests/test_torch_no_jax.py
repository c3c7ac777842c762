"""The port runs without JAX: importing every mfas_tpu_torch module, in a
fresh interpreter, loads neither jax nor the JAX package."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, json, pkgutil, sys
import mfas_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mfas_tpu_torch.__path__,
                                                "mfas_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "mfas_tpu"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_neither_jax_nor_mfas_tpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    res = json.loads(out.strip().splitlines()[-1])
    assert res["bad"] == []
    for name in ("mfas_tpu_torch.main_found_ntu",
                 "mfas_tpu_torch.ops.input_kernels",
                 "mfas_tpu_torch.data.resident",
                 "mfas_tpu_torch.engine.classifier",
                 "mfas_tpu_torch.main_searchable_ntu",
                 "mfas_tpu_torch.core.rnn",
                 "mfas_tpu_torch.search.tools",
                 "mfas_tpu_torch.search.surrogate",
                 "mfas_tpu_torch.search.population",
                 "mfas_tpu_torch.search.trainers",
                 "mfas_tpu_torch.search.searcher",
                 "mfas_tpu_torch.search.searchers",
                 "mfas_tpu_torch.models.avmnist",
                 "mfas_tpu_torch.fusion.avmnist",
                 "mfas_tpu_torch.data.avmnist",
                 "mfas_tpu_torch.data.loader",
                 "mfas_tpu_torch.runtime.cli",
                 "mfas_tpu_torch.main_searchable_avmnist",
                 "mfas_tpu_torch.main_found_avmnist",
                 "mfas_tpu_torch.core.functional",
                 "mfas_tpu_torch.core.layers",
                 "mfas_tpu_torch.models.vgg",
                 "mfas_tpu_torch.models.mm_imdb",
                 "mfas_tpu_torch.data.mm_imdb",
                 "mfas_tpu_torch.engine.mmimdb",
                 "mfas_tpu_torch.main_found_mmimdb",
                 "mfas_tpu_torch.models.enas_cell",
                 "mfas_tpu_torch.fusion.cifar",
                 "mfas_tpu_torch.engine.cifar",
                 "mfas_tpu_torch.data.cifar",
                 "mfas_tpu_torch.main_searchable_cifar",
                 "mfas_tpu_torch.main_found_cifar",
                 "mfas_tpu_torch.data.native",
                 "mfas_tpu_torch.data.ntu",
                 "mfas_tpu_torch.data.ntu_pack",
                 "mfas_tpu_torch.runtime.checkpoint",
                 "mfas_tpu_torch.runtime.export",
                 "mfas_tpu_torch.tools",
                 "mfas_tpu_torch.tools.pack_ntu",
                 "mfas_tpu_torch.tools.export_model",
                 "mfas_tpu_torch.tools.predict",
                 "mfas_tpu_torch.models.inflate",
                 "mfas_tpu_torch.tools.convert_torchvision",
                 "mfas_tpu_torch.tools.search_report",
                 "mfas_tpu_torch.tools.parity_kit",
                 "mfas_tpu_torch.tools.profile_step",
                 "mfas_tpu_torch.parallel",
                 "mfas_tpu_torch.parallel.mesh",
                 "mfas_tpu_torch.core.init",
                 "mfas_tpu_torch.models.ntu",
                 "mfas_tpu_torch.runtime.profiler",
                 "mfas_tpu_torch.runtime.train_state",
                 "mfas_tpu_torch.tools.bf16_sweep"):
        assert name in res["modules"]
