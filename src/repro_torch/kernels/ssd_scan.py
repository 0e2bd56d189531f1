"""Mamba2 SSD chunked scan: the wrapper of ``csrc/ssd_scan.cu``.

Replaces the Pallas TPU kernel ``ssd_scan_fwd``
(``repro/kernels/ssd_scan.py``) and computes what it computes, in the
model's layout: xdt ``(B, S, H, P)`` (already times dt), a ``(B, S, H)``
float32 (dt * A, negative), B and C ``(B, S, N)`` shared by every head,
chunks of ``chunk`` positions with ``S % chunk == 0``; returns y
``(B, S, H, P)`` in xdt's dtype.  Any strides with a contiguous last dim
are taken as they are (no transpose copy).

One C entry point, two device paths (see the source for their design):
``wgmma`` (bfloat16 on the tensor cores) for the shapes it takes, else
``fma`` (fp32 FMAs; every float32 call).  The wrapper makes that choice
(:func:`select_path`, a pure function of the dtype and the shapes) and
passes it to the entry point, which refuses a path that cannot take the
call; ``ssd_scan.path_launches`` counts calls by path.

There is no gradient through the kernel yet: K3 has no backward kernel
(ROADMAP.md §A.1/§B.5), so a call on a card that would need one raises
rather than return a y that autograd cannot see past.  CPU tensors take
the plain version, which autograd differentiates.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._grad import needs_grad
from repro_torch.kernels.ref import ssd_chunked_reference

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_P, _MAX_N = 64, 128
#: path names, indexed by the id the C entry point takes
PATHS = ("fma", "wgmma")
SUB = 64                    # kSub: rows per sub-chunk of the wgmma path

_fwd = None                 # the bound C function, looked up once


def select_path(dtype: torch.dtype, P: int, N: int, Q: int) -> str:
    """The path for xdt's dtype, head dim ``P``, state size ``N`` and
    chunk ``Q``: the tensor cores for bfloat16 when the chunk is whole
    64-row sub-chunks, fp32 FMAs otherwise (float32 never takes TF32)."""
    if dtype == torch.bfloat16 and Q % SUB == 0 and \
            P % 16 == 0 and 16 <= P <= _MAX_P and \
            N % 16 == 0 and 16 <= N <= _MAX_N:
        return "wgmma"
    return "fma"


def _check(xdt, a, bm, cm, chunk: int):
    if xdt.dim() != 4 or a.dim() != 3 or bm.dim() != 3 or cm.dim() != 3:
        raise ValueError("ssd_scan: xdt must be (B,S,H,P), a (B,S,H), "
                         "bm and cm (B,S,N)")
    B, S, H, P = xdt.shape
    N = bm.shape[-1]
    if tuple(a.shape) != (B, S, H) or tuple(bm.shape) != (B, S, N) or \
            tuple(cm.shape) != (B, S, N):
        raise ValueError(f"ssd_scan: shapes xdt{tuple(xdt.shape)} "
                         f"a{tuple(a.shape)} bm{tuple(bm.shape)} "
                         f"cm{tuple(cm.shape)}")
    if chunk <= 0 or S % chunk:
        raise ValueError(f"ssd_scan: sequence {S} is not a multiple of the "
                         f"chunk {chunk}")
    if xdt.dtype not in _DTYPES or bm.dtype != xdt.dtype or \
            cm.dtype != xdt.dtype or a.dtype != torch.float32:
        raise TypeError(f"ssd_scan: dtypes xdt {xdt.dtype}, a {a.dtype}, "
                        f"bm {bm.dtype}, cm {cm.dtype}; the kernel takes "
                        "float32 or bfloat16 xdt/bm/cm and float32 a")
    if not (xdt.device == a.device == bm.device == cm.device):
        raise ValueError("ssd_scan: inputs on different devices")


def ssd_scan(xdt, a, bm, cm, *, chunk: int = 256):
    """SSD sequence transform; CPU tensors take the plain chunked version.

    Raises where the Pallas wrapper asserts (``S % chunk``) and, on the
    card, when a gradient would be needed (no backward kernel yet) and
    where the chosen path's limits are not met: P and N multiples of 16,
    at most 64 and 128, every last dim contiguous, and on the wgmma path
    16-byte aligned rows of xdt, bm and cm."""
    global _fwd
    _check(xdt, a, bm, cm, chunk)
    if xdt.device.type == "cpu":
        return ssd_chunked_reference(xdt, a, bm, cm, chunk)
    if xdt.device.type != "cuda":
        raise RuntimeError(f"ssd_scan: no kernel for {xdt.device}")
    if needs_grad(xdt, a, bm, cm):
        raise RuntimeError("ssd_scan: no gradient on the card: K3 has no "
                           "backward kernel yet (ROADMAP.md §A.1/§B.5); "
                           "call it under torch.no_grad(), or train the SSM "
                           "family on the CPU")
    B, S, H, P = xdt.shape
    N = bm.shape[-1]
    if P % 16 or P > _MAX_P or N % 16 or N > _MAX_N:
        raise ValueError(f"ssd_scan: P={P}, N={N}; the kernel takes "
                         f"multiples of 16 up to {_MAX_P} and {_MAX_N}")
    if B > 65535:
        raise ValueError(f"ssd_scan: batch {B} > 65535")
    path = select_path(xdt.dtype, P, N, chunk)
    for name, t in (("xdt", xdt), ("bm", bm), ("cm", cm)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssd_scan: {name}'s last dim must be "
                             "contiguous")
        if path == "wgmma" and (t.data_ptr() % 16 or
                                any(s % 8 for s in t.stride()[:-1])):
            raise ValueError(f"ssd_scan: {name} must be 16-byte aligned "
                             "with strides in multiples of 16 bytes")
    y = torch.empty((B, S, H, P), dtype=xdt.dtype, device=xdt.device)
    if _fwd is None:
        _fwd = _build.load()["ssd_scan"].ssd_scan_fwd
    stream = torch.cuda.current_stream(xdt.device).cuda_stream
    err = _fwd(
        xdt.data_ptr(), a.data_ptr(), bm.data_ptr(), cm.data_ptr(),
        y.data_ptr(), PATHS.index(path), _DTYPES[xdt.dtype], B, S, H, P, N,
        chunk, *xdt.stride()[:3], *a.stride(), *bm.stride()[:2],
        *cm.stride()[:2], *y.stride()[:3], stream)
    _build.check(err, "ssd_scan_fwd")
    ssd_scan.launches += 1
    ssd_scan.path_launches[path] += 1
    return y


#: kernel launches since the last reset (CPU calls are not launches), in
#: all and by path
ssd_scan.launches = 0
ssd_scan.path_launches = dict.fromkeys(PATHS, 0)
