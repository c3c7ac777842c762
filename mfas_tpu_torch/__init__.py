"""PyTorch + CUDA port of mfas_tpu for NVIDIA Hopper (H100).

Each module mirrors its counterpart in ``mfas_tpu`` by path; parameter
``state_dict`` keys equal ``mfas_tpu.core.module.flatten_tree`` of the JAX
model, so weights move between the two packages without a remap. The two
Pallas input kernels of ``mfas_tpu/ops/input_kernels.py`` are CUDA C++
kernels here (``csrc/input_kernels.cu``). This package never imports JAX.
"""
