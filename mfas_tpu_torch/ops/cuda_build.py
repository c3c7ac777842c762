"""nvcc builds of the port's CUDA sources (``mfas_tpu_torch/csrc/*.cu``).

Each source has a plain C interface. It is compiled for ``sm_90a`` at first
use into ``build/mfas_tpu_torch/`` of the checkout, under a name that holds
the source's hash (an edited source builds anew), and loaded with ctypes.
nvcc's output (the ptxas register and spill report) is kept beside the
library as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mfas_tpu_torch"


class CudaLibrary:
    """``csrc/<stem>.cu`` as a ctypes library; ``declare(lib)`` sets the
    argument and return types of its entry points once it is loaded.
    ``variant`` names a build of the source with the nvcc ``defines`` (one
    library per activation dtype, say)."""

    def __init__(self, stem, declare, variant=None, defines=()):
        self.src = CSRC / f"{stem}.cu"
        self.name = stem if variant is None else f"{stem}_{variant}"
        self.defines = list(defines)
        self._declare = declare
        self._lib = None
        self._lock = threading.Lock()

    def path(self):
        digest = hashlib.sha256(self.src.read_bytes()).hexdigest()[:16]
        return BUILD_DIR / f"{self.name}_{digest}.so"

    def build_log(self):
        """nvcc's output for the current source, or None when it has not
        been built."""
        log = self.path().with_suffix(".log")
        return log.read_text() if log.exists() else None

    def _build(self, so):
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME is None:
            raise RuntimeError(f"nvcc not found: set CUDA_HOME to the CUDA "
                               f"toolkit to build {self.src}")
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"),
               "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               *self.defines, "-o", str(tmp), str(self.src)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              check=False)
        so.with_suffix(".log").write_text(
            " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half

    def load(self):
        """Build (when the source's hash has no library yet) and load the
        library; returns its ctypes handle."""
        with self._lock:
            if self._lib is None:
                so = self.path()
                if not so.exists():
                    self._build(so)
                lib = ctypes.CDLL(str(so))
                self._declare(lib)
                self._lib = lib
            return self._lib
