"""Plain PyTorch versions of the port's kernels (port of
``repro/kernels/ref.py``): the CPU path of each wrapper and the ground
truth its CUDA kernel is held against on the card."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_reference(q, k, v, *, causal: bool = True, window: int = 0,
                        kv_len=None):
    """Naive softmax attention.  q: (B,H,Sq,D); k,v: (B,Hkv,Sk,D).

    ``kv_len`` (an int or a 0-d integer tensor) masks keys at positions
    ``>= kv_len`` as well, the decode step's filled cache prefix."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = H // Hkv
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (D ** -0.5)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= (qpos - kpos) < window
    if kv_len is not None:
        mask &= kpos < kv_len
    s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)


def repack_reference(src, idx):
    """out[i] = src[idx[i]]."""
    return src[idx]
