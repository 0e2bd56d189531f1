"""Block-cyclic repack: the wrapper of ``csrc/blockcyclic.cu``.

Replaces the Pallas TPU kernel ``blockcyclic_repack``
(``repro/kernels/blockcyclic.py``): ``out[i] = src[idx[i]]`` for src
``(nblocks, block, width)`` of any dtype and idx ``(nout,)``; exact.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import repack_reference


def repack(src, idx):
    """Block gather; CPU tensors take the plain version.

    ``idx`` is host data (a sequence, numpy array or CPU tensor): on the
    card every index is range-checked here before it is uploaded."""
    if src.dim() != 3:
        raise ValueError(f"repack: src must be (nblocks, block, width), got "
                         f"{tuple(src.shape)}")
    if src.device.type == "cpu":
        return repack_reference(src, torch.as_tensor(np.asarray(idx),
                                                     dtype=torch.long))
    if src.device.type != "cuda":
        raise RuntimeError(f"repack: no kernel for {src.device}")
    if isinstance(idx, torch.Tensor) and idx.device.type != "cpu":
        raise ValueError("repack: idx must be host data (it is validated "
                         "before upload)")
    host = np.asarray(idx, dtype=np.int64).reshape(-1)
    nblocks = src.shape[0]
    if host.size and (host.min() < 0 or host.max() >= nblocks):
        raise IndexError(f"repack: index out of range [0, {nblocks})")
    if not src.is_contiguous():
        raise ValueError("repack: src must be contiguous")
    out = torch.empty((host.size,) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    dev_idx = torch.from_numpy(host.astype(np.int32)).to(src.device)
    block_bytes = src[0].numel() * src.element_size() if nblocks else 0
    vec16 = int(block_bytes % 16 == 0 and src.data_ptr() % 16 == 0
                and out.data_ptr() % 16 == 0)
    lib = _build.load()["blockcyclic"]
    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = lib.blockcyclic_repack(src.data_ptr(), out.data_ptr(),
                                 dev_idx.data_ptr(), host.size, block_bytes,
                                 vec16, stream)
    _build.check(err, "blockcyclic_repack")
    repack.launches += 1
    return out


#: kernel launches since the last reset (CPU calls are not launches)
repack.launches = 0
