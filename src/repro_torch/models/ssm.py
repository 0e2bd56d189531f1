"""Mamba2 SSD (state-space duality) block of the port (port of
``repro/models/ssm.py``).

The full-sequence forward (``ssm_apply``) runs the SSD chunked scan through
kernel K3 (``repro_torch.kernels.ops.ssd_scan``), in place of the JAX
package's pure-jnp ``ssd_chunked`` scan, which the JAX package trains by
differentiating it through XLA.  Here training on a card takes K3's
autograd function: the forward kernel, and the backward kernel
(``csrc/ssd_scan_bwd.cu``) for dxdt, da, dB and dC; on the CPU autograd
differentiates the plain version.  The decode step (``ssm_decode_step``) is
the single-token recurrence, the SSM analogue of a KV cache, with no
kernel of its own.

``F.softplus`` switches to the identity above 20 (its default threshold)
where ``jax.nn.softplus`` keeps ``log1p(exp(x))``; the two differ there by
less than 1e-8.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ops import ssd_scan
from repro_torch.models.layers import rmsnorm
from repro_torch.models.params import ParamDef, torch_dtype


def ssm_schema(cfg: ArchConfig):
    if cfg.ssm is None:
        raise ValueError(f"{cfg.name} has no SSM config")
    d = cfg.d_model
    di = cfg.ssm_d_inner
    n = cfg.ssm.state_size
    h = cfg.ssm_num_heads
    w = cfg.ssm.conv_width
    pd = cfg.param_dtype
    return {
        "w_z": ParamDef((d, di), ("embed", "ssm_inner"), dtype=pd),
        "w_x": ParamDef((d, di), ("embed", "ssm_inner"), dtype=pd),
        "w_B": ParamDef((d, n), ("embed", "ssm_state"), dtype=pd),
        "w_C": ParamDef((d, n), ("embed", "ssm_state"), dtype=pd),
        "w_dt": ParamDef((d, h), ("embed", "ssm_heads"), dtype=pd),
        "conv_x": ParamDef((w, di), (None, "ssm_inner"), dtype=pd, scale=0.5),
        "conv_B": ParamDef((w, n), (None, "ssm_state"), dtype=pd, scale=0.5),
        "conv_C": ParamDef((w, n), (None, "ssm_state"), dtype=pd, scale=0.5),
        "dt_bias": ParamDef((h,), ("ssm_heads",), dtype=pd, init="zeros"),
        "A_log": ParamDef((h,), ("ssm_heads",), dtype=pd, init="small_a_log"),
        "D_skip": ParamDef((h,), ("ssm_heads",), dtype=pd, init="ones"),
        "norm": ParamDef((di,), ("ssm_inner",), dtype=pd, init="ones"),
        "w_out": ParamDef((di, d), ("ssm_inner", "embed"), dtype=pd,
                          init="scaled_normal"),
    }


def _causal_conv(x, w, state=None):
    """Depthwise causal conv. x: (B,S,C); w: (W,C); state: (B,W-1,C) or
    None.  Returns (out (B,S,C), the last W-1 inputs (B,W-1,C))."""
    W, S = w.shape[0], x.shape[1]
    if state is None:
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                     # (B, S+W-1, C)
    out = xp[:, 0:S] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + S] * w[i]
    return out, xp[:, -(W - 1):]


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int):
    """SSD sequence transform through kernel K3 (and, under autograd on a
    card, K3's backward kernel).

    x: (B,S,H,P); dt: (B,S,H) positive step sizes; A: (H,) negative decay
    rates; Bm, Cm: (B,S,N) shared across heads.  Returns y (B,S,H,P) in
    x's dtype.  Chunks of Q = min(chunk, S) positions; S % Q == 0.  (The
    reference also returns the final state and takes ``state0``; nothing on
    this path reads or passes them.)
    """
    S = x.shape[1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"ssd_chunked: sequence {S} is not a multiple of "
                         f"the chunk {Q}")
    a = (dt * A[None, None, :]).float()                 # (B,S,H) negative
    xdt = (x * dt[..., None]).to(x.dtype)               # (B,S,H,P)
    return ssd_scan(xdt, a, Bm, Cm, chunk=Q)


def _project(params, x, dt_):
    """The block's five input projections (z, x, B, C, dt)."""
    return tuple(x @ params[n].to(dt_) for n in
                 ("w_z", "w_x", "w_B", "w_C", "w_dt"))


def ssm_apply(params, x, cfg: ArchConfig):
    """Full Mamba2 block over a sequence from a zero state. x: (B,S,D)."""
    s = cfg.ssm
    dt_ = torch_dtype(cfg.dtype)
    H, P = cfg.ssm_num_heads, s.head_dim
    B_, S, _ = x.shape

    z, xs, Bm, Cm, dt = _project(params, x, dt_)
    xs, _ = _causal_conv(xs, params["conv_x"].to(dt_))
    Bm, _ = _causal_conv(Bm, params["conv_B"].to(dt_))
    Cm, _ = _causal_conv(Cm, params["conv_C"].to(dt_))
    xs, Bm, Cm = F.silu(xs), F.silu(Bm), F.silu(Cm)

    dt = F.softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())

    xh = xs.reshape(B_, S, H, P)
    y = ssd_chunked(xh, dt, A, Bm, Cm, chunk=s.chunk_size)
    y = y + xh * params["D_skip"].to(dt_)[None, None, :, None]
    y = y.reshape(B_, S, H * P)
    y = y * F.silu(z)
    y = rmsnorm({"scale": params["norm"]}, y, cfg.norm_eps)
    return y @ params["w_out"].to(dt_)


# ----------------------------------------------------------------------
# Decode path (single-token recurrence; the SSM analogue of a KV cache)
# ----------------------------------------------------------------------

def init_ssm_cache(cfg: ArchConfig, batch: int, device="cpu"):
    s = cfg.ssm
    H, P, N = cfg.ssm_num_heads, s.head_dim, s.state_size
    W = s.conv_width
    dt = torch_dtype(cfg.dtype)
    return {
        "state": torch.zeros((batch, H, P, N), dtype=torch.float32,
                             device=device),
        "conv_x": torch.zeros((batch, W - 1, cfg.ssm_d_inner), dtype=dt,
                              device=device),
        "conv_B": torch.zeros((batch, W - 1, N), dtype=dt, device=device),
        "conv_C": torch.zeros((batch, W - 1, N), dtype=dt, device=device),
    }


def ssm_decode_step(params, x, cfg: ArchConfig, cache):
    """x: (B, 1, D) -> (y (B,1,D), cache).

    The cache (``init_ssm_cache``'s leaves, or views of one layer of the
    model's stacked cache) is updated IN PLACE and returned; the JAX
    version returns new buffers."""
    s = cfg.ssm
    dt_ = torch_dtype(cfg.dtype)
    H, P = cfg.ssm_num_heads, s.head_dim
    B_ = x.shape[0]

    z, xs, Bm, Cm, dt = _project(params, x, dt_)
    xs, conv_x = _causal_conv(xs, params["conv_x"].to(dt_), cache["conv_x"])
    Bm, conv_B = _causal_conv(Bm, params["conv_B"].to(dt_), cache["conv_B"])
    Cm, conv_C = _causal_conv(Cm, params["conv_C"].to(dt_), cache["conv_C"])
    xs, Bm, Cm = F.silu(xs), F.silu(Bm), F.silu(Cm)

    dt = F.softplus(dt.float() + params["dt_bias"].float())[:, 0]  # (B,H)
    A = -torch.exp(params["A_log"].float())
    a = torch.exp(dt * A[None, :])                                  # (B,H)

    xh = xs.reshape(B_, H, P).float()
    xdt = xh * dt[..., None]
    state = cache["state"] * a[:, :, None, None] + torch.einsum(
        "bhp,bn->bhpn", xdt, Bm[:, 0].float())
    y = torch.einsum("bhpn,bn->bhp", state, Cm[:, 0].float())
    y = y + xh * params["D_skip"].float()[None, :, None]
    y = y.reshape(B_, 1, H * P).to(dt_)
    y = y * F.silu(z)
    y = rmsnorm({"scale": params["norm"]}, y, cfg.norm_eps)
    out = y @ params["w_out"].to(dt_)
    for name, new in (("state", state), ("conv_x", conv_x),
                      ("conv_B", conv_B), ("conv_C", conv_C)):
        cache[name].copy_(new)
    return out, cache
