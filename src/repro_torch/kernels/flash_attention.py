"""Flash attention: the wrappers of ``csrc/flash_attention.cu`` (forward)
and ``csrc/flash_attention_bwd.cu`` (backward).

Replaces the Pallas TPU kernel ``flash_attention_fwd``
(``repro/kernels/flash_attention.py``).  Contract: q ``(B, H, Sq, D)``,
k/v ``(B, Hkv, Sk, D)`` (any strides with a contiguous last dim), GQA
head ``h`` reading KV head ``h // (H / Hkv)``, scale ``D ** -0.5``,
optional causal mask and sliding window, top-left aligned or, with
``q_offset``, with query ``i`` at position ``q_offset + i`` (a sequence
shard's queries over the whole sequence's keys), optional ``kv_len``
valid keys; returns ``(B, H, Sq, D)`` in q's dtype, laid out in
memory as ``(B, Sq, H, D)`` so that the model's ``transpose(1, 2)`` back
to its layout is free.

One C entry point, three device paths (see the source for their design):
``split_decode`` when ``(H / Hkv) * Sq <= DECODE_ROWS`` (either dtype)
and no gradient is to be taken, else ``mma`` for bfloat16 and ``fma``
for float32.  The wrapper makes that
choice (:func:`select_path`, and :func:`decode_splits` for the split path's
launch), pure functions of the shapes, and passes it to the entry point,
which refuses a path whose kernels cannot take the call;
``flash_attention.path_launches`` counts calls by path,
``flash_attention.mask_launches`` by mask (:func:`mask_of`), and
:func:`mma_kernel_launches` the mma path's launches by kernel (block or
group), as the entry point chooses and counts them.

Training: when q, k or v requires a gradient (and grad mode is on), the
call goes through :class:`FlashAttentionFn`, whose forward launches K1
with its row log-sum-exp output (fma or mma path) and whose backward is
the kernel of ``csrc/flash_attention_bwd.cu`` (:func:`flash_attention_bwd`,
counted in ``flash_attention_bwd.launches``).  The backward has two
device paths, ``wgmma`` for bfloat16 and ``fma`` for float32, chosen by
:func:`select_bwd_path` and counted in ``flash_attention_bwd.path_launches``
(and by mask in ``flash_attention_bwd.mask_launches``).
CPU tensors take the plain version both ways: autograd differentiates
``attention_reference``.  Meta tensors (a dry run's step) take neither:
each call returns its outputs' shapes and reports its work
(``kernels/meta.py``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import meta as _meta
from repro_torch.kernels._grad import needs_grad
from repro_torch.kernels.ref import (attention_backward_reference,
                                     attention_lse_reference,
                                     attention_reference)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 80, 128)
#: path names, indexed by the id the C entry point takes
PATHS = ("fma", "mma", "split_decode")
#: the mma path's kernels, indexed as the C entry point counts them
MMA_KERNELS = ("block", "group")
#: the backward's path names, indexed by the id its C entry point takes
BWD_PATHS = ("fma", "wgmma")
#: the masks a call is counted under (:func:`mask_of`)
MASKS = ("causal", "kv_len", "square", "rect", "offset")
DECODE_ROWS = 16            # kDecodeRows: query rows per KV head, at most
TILE_K = 64                 # kTileK: keys per shared-memory tile
#: a split CTA's 4 warps take at most this many K/V tiles (two each)
SPLIT_MAX_TILES = 8

_fwd = None                 # the bound C functions, looked up once
_bwd = None
_sm_counts = {}
#: the split path's arrival counters, one int32 per (batch, KV head), by
#: (device, stream): zeros that every launch leaves zero again
_counters = {}


def select_path(dtype: torch.dtype, rows: int, with_lse: bool = False) -> str:
    """The path for ``rows = (H / Hkv) * Sq`` query rows per KV head; a
    call that needs the row log-sum-exp (training) never takes
    split_decode, which writes none: a sequence shard of a few rows runs
    on mma or fma."""
    if rows <= DECODE_ROWS and not with_lse:
        return "split_decode"
    return "mma" if dtype == torch.bfloat16 else "fma"


def mask_of(causal: bool, kv_len, sq: int, sk: int, q_offset=None) -> str:
    """The mask a call is counted under: ``offset`` (a query offset given:
    a sequence shard of sequence-parallel attention, its first shard's 0
    included), ``causal`` (with or without a window), ``kv_len`` (the
    first kv_len keys: a decode step over its cache), else every key,
    ``square`` when Sq = Sk (an encoder's self-attention; cross-attention
    over as many frames as tokens) and ``rect`` when not (cross-attention,
    its decode step included)."""
    if q_offset is not None:
        return "offset"
    if causal:
        return "causal"
    if kv_len is not None:
        return "kv_len"
    return "square" if sq == sk else "rect"


def select_bwd_path(dtype: torch.dtype) -> str:
    """The backward's path: the tensor cores for bfloat16, fp32 FMAs for
    float32 (which never takes TF32)."""
    return "wgmma" if dtype == torch.bfloat16 else "fma"


def decode_splits(bh: int, sk: int, sms: int) -> int:
    """Key splits of the split path for ``bh = B * Hkv`` and a buffer of
    ``sk`` keys on a card with ``sms`` SMs: as few as leave a CTA at most
    ``SPLIT_MAX_TILES`` tiles, more only while there are fewer CTAs than
    SMs; whole tiles per split, no empty split.  It does not depend on
    kv_len, so the launch stays the same as the cache fills."""
    tiles = max(1, -(-sk // TILE_K))
    want = max(-(-tiles // SPLIT_MAX_TILES), min(tiles, sms // bh))
    per = -(-tiles // max(1, want))             # tiles per split
    return -(-tiles // per)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be 4-d")
    B, H, Sq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if H % k.shape[1]:
        raise ValueError(f"flash_attention: H={H} not a multiple of "
                         f"Hkv={k.shape[1]}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; the kernel takes float32 or bfloat16")
    if D % 16:
        raise ValueError(f"flash_attention: head dim {D} is not a multiple "
                         "of 16")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):   # 16-byte vector loads
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s last dim must be "
                             "contiguous")
        if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:-1]):
            raise ValueError(f"flash_attention: {name} must be 16-byte "
                             "aligned with strides in multiples of 16 bytes")


def _sm_count(device) -> int:
    n = _sm_counts.get(device.index)
    if n is None:
        n = _sm_counts[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def _counter_block(device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    c = _counters.get(key)
    if c is None or c.numel() < n:
        c = _counters[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                         device=device)
    return c


def _offset(q_offset) -> int:
    """``q_offset`` as the kernels take it (None: 0); a non-negative int."""
    if q_offset is None:
        return 0
    if isinstance(q_offset, bool) or int(q_offset) != q_offset or \
            q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset!r} is not a "
                         "non-negative int")
    return int(q_offset)


def _launch_fwd(q, k, v, causal, window, kv_len, with_lse, q_offset=None):
    """K1 on a card; returns (out, lse or None).  On meta tensors: the
    same outputs, empty, and the call's work reported, no launch."""
    global _fwd
    _check(q, k, v)
    off = _offset(q_offset)
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if q.is_meta:
        _meta.record("flash_attention", *_meta.attention_work(
            B, H, Hkv, Sq, Sk, D, q.element_size(), causal, window,
            kv_len if isinstance(kv_len, int) else None, with_lse,
            q_offset=off))
        out = torch.empty((B, Sq, H, D), dtype=q.dtype,
                          device=q.device).permute(0, 2, 1, 3)
        return out, (torch.empty((B, H, Sq), dtype=torch.float32,
                                 device=q.device) if with_lse else None)
    kv_dev, kv_host = None, Sk
    if isinstance(kv_len, torch.Tensor):
        if kv_len.dtype != torch.int32 or kv_len.numel() != 1 or \
                kv_len.device != q.device:
            raise ValueError("flash_attention: a kv_len tensor must be one "
                             "int32 on q's device")
        kv_dev = kv_len.data_ptr()
    elif kv_len is not None:
        kv_host = int(kv_len)
    out = torch.empty((B, Sq, H, D), dtype=q.dtype,
                      device=q.device).permute(0, 2, 1, 3)
    rows = H // Hkv * Sq
    path = select_path(q.dtype, rows, with_lse)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws = counters = None
    nsplit = 0
    if path == "split_decode":
        nsplit = decode_splits(B * Hkv, Sk, _sm_count(q.device))
        if nsplit > 1 or q.dtype == torch.float32:   # the splits merge
            ws = torch.empty(B * Hkv * nsplit * rows * (D + 2),
                             dtype=torch.float32, device=q.device)
            counters = _counter_block(q.device, stream, B * Hkv)
    if _fwd is None:
        _fwd = _build.load()["flash_attention"].flash_attention_fwd
    err = _fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), kv_dev,
        PATHS.index(path), _DTYPES[q.dtype], B, H, Hkv, Sq, Sk, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        kv_host, int(bool(causal)), int(window), off, float(D ** -0.5),
        None if ws is None else ws.data_ptr(),
        None if counters is None else counters.data_ptr(), nsplit,
        None if lse is None else lse.data_ptr(), stream)
    _build.check(err, "flash_attention_fwd")
    flash_attention.launches += 1
    flash_attention.path_launches[path] += 1
    flash_attention.mask_launches[mask_of(causal, kv_len, Sq, Sk,
                                          q_offset)] += 1
    return out, lse


def mma_kernel_launches(reset: bool = False) -> dict:
    """The mma path's launches by kernel (:data:`MMA_KERNELS`) since the
    last reset, as ``csrc/flash_attention.cu`` counts them where it
    launches each; zeroed after the read when ``reset``.  All zero while
    no forward has launched in this process (nothing is built for it)."""
    out = (ctypes.c_longlong * len(MMA_KERNELS))()
    if _fwd is not None:
        _build.check(_build.load()["flash_attention"]
                     .flash_attention_mma_kernels(out, int(reset)),
                     "flash_attention_mma_kernels")
    return dict(zip(MMA_KERNELS, out))


def _aligned(t):
    """``t`` itself if the kernels can read it (contiguous last dim,
    16-byte rows), else a contiguous copy."""
    vec = 16 // t.element_size()
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and \
            all(s % vec == 0 for s in t.stride()[:-1]):
        return t
    return t.contiguous()


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True,
                        window: int = 0, q_offset=None):
    """Gradients (dq, dk, dv) of :func:`flash_attention` from the forward's
    output ``o`` and row log-sum-exp ``lse`` (B, H, Sq) fp32; CPU tensors
    take the plain version (``attention_backward_reference``).  On a card:
    the three launches of ``csrc/flash_attention_bwd.cu`` on the path
    :func:`select_bwd_path` names, one call counted; dq comes laid out as
    (B, Sq, H, D), dk / dv as (B, Sk, Hkv, D).  ``q_offset``: the
    forward's."""
    global _bwd
    off = _offset(q_offset)
    if q.device.type == "cpu":
        return attention_backward_reference(q, k, v, o, do, lse,
                                            causal=causal, window=window,
                                            q_offset=off)
    if q.device.type not in ("cuda", "meta"):
        raise RuntimeError(f"flash_attention_bwd: no kernel for {q.device}")
    _check(q, k, v)
    if q.is_meta:
        B, H, Sq, D = q.shape
        Hkv, Sk = k.shape[1], k.shape[2]
        _meta.record("flash_attention_bwd", *_meta.attention_work(
            B, H, Hkv, Sq, Sk, D, q.element_size(), causal, window,
            backward=True, q_offset=off))
        return tuple(torch.empty((B, s_, h_, D), dtype=q.dtype,
                                 device=q.device).permute(0, 2, 1, 3)
                     for s_, h_ in ((Sq, H), (Sk, Hkv), (Sk, Hkv)))
    o, do = _aligned(o), _aligned(do)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or \
            do.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: o{tuple(o.shape)} "
                         f"{o.dtype} and do{tuple(do.shape)} {do.dtype} must "
                         f"match q{tuple(q.shape)} {q.dtype}")
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 or \
            not lse.is_contiguous() or lse.device != q.device:
        raise ValueError("flash_attention_bwd: lse must be a contiguous "
                         f"float32 (B, H, Sq) = {(B, H, Sq)} on q's device")
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype,
                     device=q.device).permute(0, 2, 1, 3)
    dk, dv = (torch.empty((B, Sk, Hkv, D), dtype=q.dtype,
                          device=q.device).permute(0, 2, 1, 3)
              for _ in range(2))
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(*[
        s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]])
    path = select_bwd_path(q.dtype)
    if _bwd is None:
        _bwd = _build.load()["flash_attention_bwd"].flash_attention_bwd
    err = _bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
               do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
               dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
               BWD_PATHS.index(path), _DTYPES[q.dtype], B, H, Hkv, Sq, Sk, D,
               strides, int(bool(causal)), int(window), off,
               float(D ** -0.5),
               torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.path_launches[path] += 1
    flash_attention_bwd.mask_launches[mask_of(causal, None, Sq, Sk,
                                              q_offset)] += 1
    return dq, dk, dv


#: backward calls since the last reset (each one launches three kernels),
#: in all, by path and by mask
flash_attention_bwd.launches = 0
flash_attention_bwd.path_launches = dict.fromkeys(BWD_PATHS, 0)
flash_attention_bwd.mask_launches = dict.fromkeys(MASKS, 0)


def flash_attention_lse(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset=None):
    """(out, lse): K1's output and its row log-sum-exp (B, H, Sq) fp32,
    what the backward is given; CPU tensors take the plain versions."""
    if q.device.type == "cpu":
        off = _offset(q_offset)
        return (attention_reference(q, k, v, causal=causal, window=window,
                                    q_offset=off),
                attention_lse_reference(q, k, causal=causal, window=window,
                                        q_offset=off))
    if q.device.type not in ("cuda", "meta"):
        raise RuntimeError(f"flash_attention: no kernel for {q.device}")
    return _launch_fwd(q, k, v, causal, window, None, True, q_offset)


class FlashAttentionFn(torch.autograd.Function):
    """K1 with a gradient: the forward kernel (saving its row log-sum-exp)
    and the backward kernel, for tensors on a card."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset=None):
        out, lse = _launch_fwd(q, k, v, causal, window, None, True, q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.q_offset = causal, window, q_offset
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do, lse,
                                         causal=ctx.causal,
                                         window=ctx.window,
                                         q_offset=ctx.q_offset)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    kv_len=None, q_offset=None):
    """GQA softmax attention; CPU tensors take the plain version.

    ``kv_len``: None (all ``Sk`` keys), an int, or a 0-d int32 tensor on
    q's device (read by the kernel on the device: no host sync).  With a
    gradient to compute (training), :class:`FlashAttentionFn`; ``kv_len``
    is then refused: the backward kernel is for training shapes.
    ``q_offset``: a non-negative int, query ``i``'s position less ``i``
    (the contract of the reference's ``chunked_attention(q_offset=)``);
    a call given one is counted under the ``offset`` mask."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal=causal, window=window,
                                   kv_len=kv_len, q_offset=_offset(q_offset))
    if q.device.type not in ("cuda", "meta"):
        raise RuntimeError(f"flash_attention: no kernel for {q.device}")
    if needs_grad(q, k, v):
        if kv_len is not None:
            raise ValueError("flash_attention: no gradient with kv_len (the "
                             "backward kernel is for training shapes)")
        return FlashAttentionFn.apply(q, k, v, causal, window, q_offset)
    return _launch_fwd(q, k, v, causal, window, kv_len, False, q_offset)[0]


#: kernel launches since the last reset (CPU calls are not launches), in
#: all, by path and by mask (one count per call, whatever the path
#: launches)
flash_attention.launches = 0
flash_attention.path_launches = dict.fromkeys(PATHS, 0)
flash_attention.mask_launches = dict.fromkeys(MASKS, 0)
