"""``repro_torch`` — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

Module names mirror the JAX package's so each counterpart is easy to find.
Importing this package loads neither JAX nor any ``repro`` module, and
builds no kernel: the CUDA sources under ``kernels/csrc`` are compiled on
first launch (``repro_torch.kernels._build``).
"""
