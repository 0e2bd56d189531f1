"""Flash-attention forward: the wrapper of ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``flash_attention_fwd``
(``repro/kernels/flash_attention.py``).  Contract: q ``(B, H, Sq, D)``,
k/v ``(B, Hkv, Sk, D)`` (any strides with a contiguous last dim), GQA
head ``h`` reading KV head ``h // (H / Hkv)``, scale ``D ** -0.5``,
optional top-left-aligned causal mask and sliding window, optional
``kv_len`` valid keys; returns ``(B, H, Sq, D)`` in q's dtype, laid out in
memory as ``(B, Sq, H, D)`` so that the model's ``transpose(1, 2)`` back
to its layout is free.  See the source for the kernel's design.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_reference

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)


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
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {_HEAD_DIMS}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s last dim must be "
                             "contiguous")
    for name, t in (("k", k), ("v", v)):      # 16-byte vector loads
        if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:-1]):
            raise ValueError(f"flash_attention: {name} must be 16-byte "
                             "aligned with strides in multiples of 16 bytes")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    kv_len=None):
    """GQA softmax attention; CPU tensors take the plain version.

    ``kv_len``: None (all ``Sk`` keys), an int, or a 0-d int32 tensor on
    q's device (read by the kernel on the device: no host sync)."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal=causal, window=window,
                                   kv_len=kv_len)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for {q.device}")
    _check(q, k, v)
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
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
    lib = _build.load()["flash_attention"]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), kv_dev,
        _DTYPES[q.dtype], B, H, Hkv, Sq, Sk, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        kv_host, int(bool(causal)), int(window), float(D ** -0.5), stream)
    _build.check(err, "flash_attention_fwd")
    flash_attention.launches += 1
    return out


#: kernel launches since the last reset (CPU calls are not launches)
flash_attention.launches = 0
