"""Block-cyclic repack: the wrapper of ``csrc/blockcyclic.cu``.

Replaces the Pallas TPU kernel ``blockcyclic_repack``
(``repro/kernels/blockcyclic.py``): ``out[i] = src[idx[i]]`` for src
``(nblocks, block, width)`` of any dtype and idx ``(nout,)``; exact.

Two device paths (see the source): ``bulk`` (a ring of TMA bulk copies)
when the blocks and both base pointers are 16-byte aligned, else
``bytes``; ``repack.path_launches`` counts calls by path.  The indices
are range-checked on the host, then uploaded from pinned memory without
synchronising the stream.  A meta ``src`` (a dry run) gives the output's
shape and reports the gather's bytes (``kernels/meta.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import meta as _meta
from repro_torch.kernels.ref import repack_reference

#: path names, indexed by the flag the C entry point takes
PATHS = ("bytes", "bulk")

_copy_streams = {}          # device index -> the side stream of the uploads


def select_path(block_bytes: int, src_ptr: int, out_ptr: int) -> str:
    """Bulk copies need 16-byte sizes and addresses."""
    aligned = block_bytes % 16 == 0 and src_ptr % 16 == 0 and \
        out_ptr % 16 == 0
    return "bulk" if aligned else "bytes"


def _checked_index(idx, nblocks: int) -> np.ndarray:
    """``idx`` (host data) as int64, every index checked against
    ``nblocks``."""
    if isinstance(idx, torch.Tensor) and idx.device.type != "cpu":
        raise ValueError("repack: idx must be host data (it is validated "
                         "before upload)")
    host = np.asarray(idx, dtype=np.int64).reshape(-1)
    if host.size and (host.min() < 0 or host.max() >= nblocks):
        raise IndexError(f"repack: index out of range [0, {nblocks})")
    return host


def upload_index(idx, nblocks: int, device) -> torch.Tensor:
    """``idx`` (host data: a sequence, numpy array or CPU tensor) as int32
    on ``device``, after every index is checked against ``nblocks``.  The
    copy is asynchronous from pinned memory (:func:`_copy_async`), so the
    stream is not synchronised; PyTorch's caching host allocator keeps the
    pinned buffer until the copy has run."""
    host = _checked_index(idx, nblocks)
    pinned = torch.from_numpy(host.astype(np.int32)).pin_memory()
    return _copy_async(pinned, torch.device(device))


def _copy_async(pinned: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``pinned`` on ``device``, copied on a side stream that the current
    stream then waits for.  On the current stream itself the copy would
    queue behind the kernel before it, and the next kernel behind the copy:
    a bubble of one copy's latency between back-to-back repacks.  On the
    side stream it runs while that kernel does."""
    main = torch.cuda.current_stream(device)
    side = _copy_streams.get(device.index)
    if side is None:
        side = _copy_streams[device.index] = torch.cuda.Stream(device)
    with torch.cuda.stream(side):
        out = pinned.to(device, non_blocking=True)
    main.wait_stream(side)
    out.record_stream(main)                     # freed in main's order
    return out


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
    if src.device.type == "meta":
        n = len(_checked_index(idx, src.shape[0]))
        out = src.new_empty((n,) + tuple(src.shape[1:]))
        _meta.record("repack", 0, 2 * out.numel() * out.element_size())
        return out
    if src.device.type != "cuda":
        raise RuntimeError(f"repack: no kernel for {src.device}")
    if not src.is_contiguous():
        raise ValueError("repack: src must be contiguous")
    dev_idx = upload_index(idx, src.shape[0], src.device)
    out = torch.empty((dev_idx.numel(),) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    block_bytes = src[0].numel() * src.element_size() if src.shape[0] else 0
    if out.numel() == 0:                        # nothing to copy
        return out
    path = select_path(block_bytes, src.data_ptr(), out.data_ptr())
    lib = _build.load()["blockcyclic"]
    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = lib.blockcyclic_repack(src.data_ptr(), out.data_ptr(),
                                 dev_idx.data_ptr(), dev_idx.numel(),
                                 block_bytes, PATHS.index(path), stream)
    _build.check(err, "blockcyclic_repack")
    repack.launches += 1
    repack.path_launches[path] += 1
    return out


#: kernel launches since the last reset (CPU calls are not launches), in
#: all and by path
repack.launches = 0
repack.path_launches = dict.fromkeys(PATHS, 0)
