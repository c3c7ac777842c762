"""Published peaks of the card, the denominators of every MFU and roofline
share (NVIDIA H100 SXM data sheet, dense, at its 700 W power limit).

Float32 runs with TF32 off for matrix products and cuDNN (the benchmark
turns it off, as the configurations state float32), so its peak is the
non-tensor-core 67 TFLOP/s; bfloat16 autocast runs on the tensor cores.
"""

from __future__ import annotations

import subprocess

FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def power_limit_w():
    """The card's power limit in W from nvidia-smi, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True).stdout
        return float(out.splitlines()[0].strip())
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return None
