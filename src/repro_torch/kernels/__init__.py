"""Hand-written Hopper kernels of the port and their plain versions.

``ops`` is the dispatch surface: each wrapper runs its plain PyTorch
version for tensors on the CPU and launches its CUDA kernel for tensors on
a card (building it on first use), never falling back from one to the other.
"""
