"""Mamba2 SSD chunked scan: the wrappers of ``csrc/ssd_scan.cu`` (forward)
and ``csrc/ssd_scan_bwd.cu`` (backward).

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

Training: when an input requires a gradient (and grad mode is on), a
call on a card goes through :class:`SSDScanFn`, whose forward launches
the same kernel and whose backward is the kernel of
``csrc/ssd_scan_bwd.cu`` (:func:`ssd_scan_bwd`), again with two paths:
``wgmma`` for the bfloat16 shapes :func:`select_bwd_path` names, ``fma``
otherwise (every float32 call), counted in ``ssd_scan_bwd.launches`` and
``.path_launches``.  CPU tensors take the plain version both ways:
autograd differentiates ``ssd_chunked_reference``.  Meta tensors (a dry
run's step) take neither: each call returns its outputs' shapes and
reports its work (``kernels/meta.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import meta as _meta
from repro_torch.kernels._grad import needs_grad
from repro_torch.kernels.ref import (ssd_chunked_backward_reference,
                                     ssd_chunked_reference)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_P, _MAX_N = 64, 128
#: path names, indexed by the id the C entry point takes
PATHS = ("fma", "wgmma")
#: the backward's paths, indexed by the id its C entry point takes
BWD_PATHS = ("fma", "wgmma")
SUB = 64                    # kSub: rows per sub-chunk of the wgmma path
_BWD_MAX_Q = 256            # the backward's wgmma path: at most 4 tiles

_fwd = None                 # the bound C function, looked up once
_bwd = None                 # the backward's library, loaded once


def select_path(dtype: torch.dtype, P: int, N: int, Q: int) -> str:
    """The path for xdt's dtype, head dim ``P``, state size ``N`` and
    chunk ``Q``: the tensor cores for bfloat16 when the chunk is whole
    64-row sub-chunks, fp32 FMAs otherwise (float32 never takes TF32)."""
    if dtype == torch.bfloat16 and Q % SUB == 0 and \
            P % 16 == 0 and 16 <= P <= _MAX_P and \
            N % 16 == 0 and 16 <= N <= _MAX_N:
        return "wgmma"
    return "fma"


def select_bwd_path(dtype: torch.dtype, P: int, N: int, Q: int) -> str:
    """The backward's path: the tensor cores for bfloat16 when the chunk is
    one to four whole 64-row tiles (the forward's condition, and Q at most
    256), fp32 FMAs otherwise (float32 never takes TF32)."""
    if select_path(dtype, P, N, Q) == "wgmma" and Q <= _BWD_MAX_Q:
        return "wgmma"
    return "fma"


def _check_aligned(tensors, who: str):
    """The wgmma paths' loads: 16-byte aligned rows (cp.async)."""
    for name, t in tensors:
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:-1]):
            raise ValueError(f"{who}: {name} must be 16-byte aligned with "
                             "strides in multiples of 16 bytes")


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


def _check_card(xdt, bm, cm, who: str):
    """What both kernels need beyond :func:`_check`: P and N multiples of
    16, at most 64 and 128, and xdt, bm and cm with a contiguous last
    dim."""
    P, N = xdt.shape[-1], bm.shape[-1]
    if P % 16 or P > _MAX_P or N % 16 or N > _MAX_N:
        raise ValueError(f"{who}: P={P}, N={N}; the kernel takes "
                         f"multiples of 16 up to {_MAX_P} and {_MAX_N}")
    for name, t in (("xdt", xdt), ("bm", bm), ("cm", cm)):
        if t.stride(-1) != 1:
            raise ValueError(f"{who}: {name}'s last dim must be contiguous")


def _launch_fwd(xdt, a, bm, cm, chunk: int):
    """K3's forward on a card, on the path :func:`select_path` names.  On
    meta tensors: y, empty, and the call's work reported, no launch."""
    global _fwd
    B, S, H, P = xdt.shape
    N = bm.shape[-1]
    _check_card(xdt, bm, cm, "ssd_scan")
    if xdt.is_meta:
        _meta.record("ssd_scan", *_meta.ssd_work(B, S, H, P, N, chunk,
                                                 xdt.element_size()))
        return torch.empty((B, S, H, P), dtype=xdt.dtype, device=xdt.device)
    if B > 65535:
        raise ValueError(f"ssd_scan: batch {B} > 65535")
    path = select_path(xdt.dtype, P, N, chunk)
    if path == "wgmma":
        _check_aligned((("xdt", xdt), ("bm", bm), ("cm", cm)), "ssd_scan")
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


def _bwd_lib():
    global _bwd
    if _bwd is None:
        _bwd = _build.load()["ssd_scan_bwd"]
    return _bwd


def bwd_workspace_floats(B: int, S: int, H: int, P: int, N: int, Q: int,
                         path: str) -> int:
    """fp32 scratch of one backward call on ``path``, as
    ``csrc/ssd_scan_bwd.cu`` lays it out (its
    ``ssd_scan_bwd_workspace_floats``; builds the kernels)."""
    return _bwd_lib().ssd_scan_bwd_workspace_floats(BWD_PATHS.index(path),
                                                    B, S, H, P, N, Q)


def ssd_scan_bwd(xdt, a, bm, cm, dy, *, chunk: int = 256):
    """Gradients (dxdt, da, dbm, dcm) of :func:`ssd_scan` from its inputs
    and ``dy`` (y's shape and dtype); da is float32, dB and dC summed over
    the heads.  CPU tensors take the plain version
    (``ssd_chunked_backward_reference``).  On a card: the launches of
    ``csrc/ssd_scan_bwd.cu`` on the path :func:`select_bwd_path` names
    (``BWD_KERNELS`` of them), one call counted; a ``dy`` whose last dim
    is not contiguous (autograd may hand one over) is copied to a
    contiguous one first, the other inputs are read through their
    strides.  Raises where the forward raises, and on the wgmma path for
    rows that are not 16-byte aligned."""
    _check(xdt, a, bm, cm, chunk)
    if dy.shape != xdt.shape or dy.dtype != xdt.dtype or \
            dy.device != xdt.device:
        raise ValueError(f"ssd_scan_bwd: dy{tuple(dy.shape)} {dy.dtype} "
                         f"must match xdt{tuple(xdt.shape)} {xdt.dtype}")
    if xdt.device.type == "cpu":
        return ssd_chunked_backward_reference(xdt, a, bm, cm, dy, chunk)
    if xdt.device.type not in ("cuda", "meta"):
        raise RuntimeError(f"ssd_scan_bwd: no kernel for {xdt.device}")
    B, S, H, P = xdt.shape
    N = bm.shape[-1]
    _check_card(xdt, bm, cm, "ssd_scan_bwd")
    if xdt.is_meta:
        _meta.record("ssd_scan_bwd", *_meta.ssd_work(
            B, S, H, P, N, chunk, xdt.element_size(), backward=True))
        return (torch.empty_like(xdt), torch.empty_like(a),
                torch.empty_like(bm), torch.empty_like(cm))
    if max(B, H, S // chunk) > 65535 or chunk > 4096:
        raise ValueError(f"ssd_scan_bwd: B={B}, H={H}, {S // chunk} chunks "
                         f"(at most 65535 each), chunk {chunk} (at most "
                         "4096)")
    if dy.stride(-1) != 1:
        dy = dy.contiguous()
    path = select_bwd_path(xdt.dtype, P, N, chunk)
    if path == "wgmma":
        _check_aligned((("xdt", xdt), ("bm", bm), ("cm", cm), ("dy", dy)),
                       "ssd_scan_bwd")
    dev = xdt.device
    dx = torch.empty((B, S, H, P), dtype=xdt.dtype, device=dev)
    da = torch.empty((B, S, H), dtype=torch.float32, device=dev)
    db = torch.empty((B, S, N), dtype=bm.dtype, device=dev)
    dc = torch.empty((B, S, N), dtype=cm.dtype, device=dev)
    n_ws = bwd_workspace_floats(B, S, H, P, N, chunk, path)
    ws = torch.empty(n_ws, dtype=torch.float32, device=dev)
    err = _bwd_lib().ssd_scan_bwd(
        xdt.data_ptr(), a.data_ptr(), bm.data_ptr(), cm.data_ptr(),
        dy.data_ptr(), dx.data_ptr(), da.data_ptr(), db.data_ptr(),
        dc.data_ptr(), ws.data_ptr(), n_ws, BWD_PATHS.index(path),
        _DTYPES[xdt.dtype], B, S, H, P, N, chunk, *xdt.stride()[:3],
        *a.stride(), *bm.stride()[:2], *cm.stride()[:2], *dy.stride()[:3],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ssd_scan_bwd")
    ssd_scan_bwd.launches += 1
    ssd_scan_bwd.path_launches[path] += 1
    return dx, da, db, dc


#: kernels one backward call launches, by path
BWD_KERNELS = {"fma": 7, "wgmma": 4}
#: backward calls since the last reset, in all and by path
ssd_scan_bwd.launches = 0
ssd_scan_bwd.path_launches = dict.fromkeys(BWD_PATHS, 0)


class SSDScanFn(torch.autograd.Function):
    """K3 with a gradient: the forward (the plain version for CPU tensors,
    the kernel on a card) saving its inputs, and :func:`ssd_scan_bwd`."""

    @staticmethod
    def forward(ctx, xdt, a, bm, cm, chunk):
        if xdt.device.type == "cpu":
            y = ssd_chunked_reference(xdt, a, bm, cm, chunk)
        else:
            y = _launch_fwd(xdt, a, bm, cm, chunk)
        ctx.save_for_backward(xdt, a, bm, cm)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        dx, da, db, dc = ssd_scan_bwd(*ctx.saved_tensors, dy,
                                      chunk=ctx.chunk)
        return dx, da, db, dc, None


def ssd_scan(xdt, a, bm, cm, *, chunk: int = 256):
    """SSD sequence transform; CPU tensors take the plain chunked version.

    Raises where the Pallas wrapper asserts (``S % chunk``) and, on the
    card, where the chosen path's limits are not met: P and N multiples of
    16, at most 64 and 128, every last dim contiguous, and on the wgmma
    path 16-byte aligned rows of xdt, bm and cm.  With a gradient to
    compute, :class:`SSDScanFn` (the backward kernel)."""
    _check(xdt, a, bm, cm, chunk)
    if xdt.device.type == "cpu":
        return ssd_chunked_reference(xdt, a, bm, cm, chunk)
    if xdt.device.type not in ("cuda", "meta"):
        raise RuntimeError(f"ssd_scan: no kernel for {xdt.device}")
    if needs_grad(xdt, a, bm, cm):
        return SSDScanFn.apply(xdt, a, bm, cm, chunk)
    return _launch_fwd(xdt, a, bm, cm, chunk)


#: kernel launches since the last reset (CPU calls are not launches), in
#: all and by path
ssd_scan.launches = 0
ssd_scan.path_launches = dict.fromkeys(PATHS, 0)
