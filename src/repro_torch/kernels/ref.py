"""Plain PyTorch versions of the port's kernels (port of
``repro/kernels/ref.py``): the CPU path of each wrapper and the ground
truth its CUDA kernel is held against on the card."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _attention_mask(Sq, Sk, *, causal, window, kv_len, device):
    """(Sq, Sk) bool: key j is valid for query i (top-left causal)."""
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= (qpos - kpos) < window
    if kv_len is not None:
        mask &= kpos < kv_len
    return mask


def _attention_scores(q, k, *, causal, window, kv_len=None):
    """fp32 scaled scores (B, H, Sq, Sk), masked entries -1e30, and the
    mask; k is repeated over the G query heads of each KV head."""
    D = q.shape[-1]
    k = k.repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (D ** -0.5)
    mask = _attention_mask(q.shape[2], k.shape[2], causal=causal,
                           window=window, kv_len=kv_len, device=q.device)
    return torch.where(mask[None, None], s, torch.full_like(s, NEG_INF)), mask


def attention_reference(q, k, v, *, causal: bool = True, window: int = 0,
                        kv_len=None):
    """Naive softmax attention.  q: (B,H,Sq,D); k,v: (B,Hkv,Sk,D).

    ``kv_len`` (an int or a 0-d integer tensor) masks keys at positions
    ``>= kv_len`` as well, the decode step's filled cache prefix."""
    s, _ = _attention_scores(q, k, causal=causal, window=window,
                             kv_len=kv_len)
    p = torch.softmax(s, dim=-1)
    v = v.repeat_interleave(q.shape[1] // v.shape[1], dim=1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)


def attention_lse_reference(q, k, *, causal: bool = True, window: int = 0):
    """The row log-sum-exp of the scaled, masked scores, (B, H, Sq) fp32:
    what the forward kernel writes beside its output for the backward."""
    s, _ = _attention_scores(q, k, causal=causal, window=window)
    return torch.logsumexp(s, dim=-1)


def attention_backward_reference(q, k, v, o, do, lse, *, causal: bool = True,
                                 window: int = 0):
    """Plain attention backward from the saved row log-sum-exp.

    P = exp(S - lse) on the valid keys (0 elsewhere), with S the scaled
    scores; dV = P^T dO; dS = P o (dO V^T - rowsum(dO o O)); dQ = dS K
    scale; dK = dS^T Q scale; dK and dV summed over the G query heads of
    each KV head.  fp32 throughout; returns (dq, dk, dv) in the inputs'
    dtypes.  A row with no valid key gets zero gradients."""
    B, H, Sq, D = q.shape
    Hkv = k.shape[1]
    g = H // Hkv
    scale = D ** -0.5
    s, mask = _attention_scores(q, k, causal=causal, window=window)
    p = torch.exp(s - lse.float()[..., None]) * mask[None, None]
    do32, o32 = do.float(), o.float()
    kr = k.float().repeat_interleave(g, dim=1)
    vr = v.float().repeat_interleave(g, dim=1)
    delta = (do32 * o32).sum(-1)                          # (B, H, Sq)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do32)
    dp = torch.einsum("bhqd,bhkd->bhqk", do32, vr)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    fold = lambda t: t.reshape(B, Hkv, g, *t.shape[2:]).sum(2)
    return dq.to(q.dtype), fold(dk).to(k.dtype), fold(dv).to(v.dtype)


def ssd_reference(xdt, a, bm, cm):
    """Sequential (per-token) SSD recurrence: the obviously-correct oracle.

    Model layout: xdt (B,S,H,P) pre-multiplied by dt; a (B,S,H) = dt*A;
    bm, cm (B,S,N).  state_t = state_{t-1} * exp(a_t) + xdt_t (outer) B_t;
    y_t = state_t @ C_t.  Returns y (B,S,H,P) in xdt's dtype.
    """
    B, S, H, P = xdt.shape
    N = bm.shape[-1]
    x, a = xdt.float(), a.float()
    b_, c_ = bm.float(), cm.float()
    state = torch.zeros((B, H, P, N), dtype=torch.float32, device=xdt.device)
    ys = []
    for t in range(S):
        state = state * torch.exp(a[:, t])[..., None, None] + \
            torch.einsum("bhp,bn->bhpn", x[:, t], b_[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", state, c_[:, t]))
    return torch.stack(ys, dim=1).to(xdt.dtype)


def ssd_chunked_reference(xdt, a, bm, cm, chunk: int):
    """The chunked SSD algorithm of the Pallas kernel ``_ssd_kernel``,
    vectorised over batch and heads; same layout and result as
    :func:`ssd_reference`.  Per chunk of Q = ``chunk`` positions: the
    cumsum of a; G = C B^T; L = exp(segsum) on the causal triangle (the
    exponent is masked, so no masked entry is ever exponentiated); y =
    (G o L) x + exp(cum) * C state^T; state <- state * exp(total) +
    sum_s exp(total - cum_s) x_s (outer) B_s.  ``S % chunk == 0``."""
    B, S, H, P = xdt.shape
    N = bm.shape[-1]
    Q = chunk
    if S % Q:
        raise ValueError(f"ssd: sequence {S} is not a multiple of the "
                         f"chunk {Q}")
    x, a = xdt.float(), a.float()
    b_, c_ = bm.float(), cm.float()
    causal = torch.ones((Q, Q), dtype=torch.bool,
                        device=xdt.device).tril()[None, :, :, None]
    state = torch.zeros((B, H, P, N), dtype=torch.float32, device=xdt.device)
    ys = []
    for c0 in range(0, S, Q):
        xc, ac = x[:, c0:c0 + Q], a[:, c0:c0 + Q]       # (B,Q,H,P), (B,Q,H)
        bc, cc = b_[:, c0:c0 + Q], c_[:, c0:c0 + Q]     # (B,Q,N)
        cum = torch.cumsum(ac, dim=1)                   # (B,Q,H)
        G = torch.einsum("bqn,bsn->bqs", cc, bc)        # (B,Q,Q)
        diff = cum[:, :, None, :] - cum[:, None, :, :]  # (B,Q,Q,H)
        L = torch.exp(diff.masked_fill(~causal, float("-inf")))
        y = torch.einsum("bqsh,bshp->bqhp", G[..., None] * L, xc)
        y = y + torch.einsum("bqn,bhpn,bqh->bqhp", cc, state, torch.exp(cum))
        total = cum[:, -1]                              # (B,H)
        decay = torch.exp(total[:, None, :] - cum)      # (B,Q,H)
        state = state * torch.exp(total)[..., None, None] + torch.einsum(
            "bqn,bqhp,bqh->bhpn", bc, xc, decay)
        ys.append(y)
    return torch.cat(ys, dim=1).to(xdt.dtype)


def ssd_chunked_backward_reference(xdt, a, bm, cm, dy, chunk: int):
    """Plain backward of :func:`ssd_chunked_reference` (zero initial state,
    final state discarded), from the explicit formulas, vectorised over
    batch, heads and chunks.  Per chunk, with cum the in-chunk cumsum of a,
    tot = cum[Q-1], L[q, s] = exp(cum_q - cum_s) on s <= q (the exponent
    masked, never exponentiated above the diagonal), G = C B^T, D[q, s] =
    dy_q . x_s, the chunk-start state S_in and the gradient dS_out of the
    chunk's final state::

        S_in(0) = 0,
        S_in(c+1) = exp(tot) S_in + sum_s exp(tot - cum_s) x_s (x) B_s
        dS_out(last) = 0,
        dS_out(c-1) = exp(tot) dS_out + sum_q exp(cum_q) dy_q (x) C_q
        dx_s  = sum_q (G o L)[q, s] dy_q + exp(tot - cum_s) dS_out B_s
        dC_q  = sum_s (D o L)[q, s] B_s + exp(cum_q) dy_q S_in
        dB_s  = sum_q (D o L)[q, s] C_q + exp(tot - cum_s) dS_out^T x_s
        dcum  = rowsum(W) - colsum(W) + exp(cum_q) dy_q . (S_in C_q) - V_q,
                W = G o L o D,  V_s = exp(tot - cum_s) x_s . (dS_out B_s),
                and at q = Q-1 also + sum_s V_s + exp(tot) <dS_out, S_in>
        da_t  = sum_{q >= t} dcum_q  (within the chunk)

    dB and dC are summed over the heads (B and C are shared by them).
    fp32 throughout (fp64 for fp64 inputs); returns (dxdt, da, dbm, dcm)
    in xdt's, fp32 (fp64), bm's and cm's dtypes."""
    B, S, H, P = xdt.shape
    N = bm.shape[-1]
    Q = chunk
    if S % Q:
        raise ValueError(f"ssd: sequence {S} is not a multiple of the "
                         f"chunk {Q}")
    nc = S // Q
    f = torch.float64 if xdt.dtype == torch.float64 else torch.float32
    x = xdt.to(f).reshape(B, nc, Q, H, P)
    g = dy.to(f).reshape(B, nc, Q, H, P)
    b_ = bm.to(f).reshape(B, nc, Q, N)
    c_ = cm.to(f).reshape(B, nc, Q, N)
    cum = torch.cumsum(a.to(f).reshape(B, nc, Q, H), dim=2)
    tot = cum[:, :, -1]                                   # (B, nc, H)
    e_tot = torch.exp(tot)
    e_cum = torch.exp(cum)                                # (B, nc, Q, H)
    decay = torch.exp(tot[:, :, None] - cum)              # exp(tot - cum_s)
    # chunk-start states, then the gradients of the chunks' final states
    local = torch.einsum("bcsn,bcshp,bcsh->bchpn", b_, x, decay)
    state = torch.zeros((B, H, P, N), dtype=f, device=xdt.device)
    s_in = []
    for c in range(nc):
        s_in.append(state)
        state = state * e_tot[:, c, :, None, None] + local[:, c]
    s_in = torch.stack(s_in, dim=1)                       # (B, nc, H, P, N)
    local = torch.einsum("bcqn,bcqhp,bcqh->bchpn", c_, g, e_cum)
    grad = torch.zeros((B, H, P, N), dtype=f, device=xdt.device)
    ds_out = [None] * nc
    for c in reversed(range(nc)):
        ds_out[c] = grad
        grad = grad * e_tot[:, c, :, None, None] + local[:, c]
    ds_out = torch.stack(ds_out, dim=1)                   # (B, nc, H, P, N)
    # within the chunks
    causal = torch.ones((Q, Q), dtype=torch.bool,
                        device=xdt.device).tril()[None, None, :, :, None]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Q,Q,H) q, s
    L = torch.exp(diff.masked_fill(~causal, float("-inf")))
    GL = torch.einsum("bcqn,bcsn->bcqs", c_, b_)[..., None] * L
    D = torch.einsum("bcqhp,bcshp->bcqsh", g, x)
    DL = D * L
    W = GL * D
    dS_B = torch.einsum("bchpn,bcsn->bcshp", ds_out, b_)  # dS_out B_s
    Sin_C = torch.einsum("bchpn,bcqn->bcqhp", s_in, c_)   # S_in C_q
    dx = torch.einsum("bcqsh,bcqhp->bcshp", GL, g) + decay[..., None] * dS_B
    dc = torch.einsum("bcqsh,bcsn->bcqn", DL, b_) + torch.einsum(
        "bcqh,bcqhp,bchpn->bcqn", e_cum, g, s_in)
    db = torch.einsum("bcqsh,bcqn->bcsn", DL, c_) + torch.einsum(
        "bcsh,bcshp,bchpn->bcsn", decay, x, ds_out)
    V = decay * (x * dS_B).sum(-1)                        # (B, nc, Q, H)
    dcum = W.sum(3) - W.sum(2) + e_cum * (g * Sin_C).sum(-1) - V
    dcum[:, :, -1] += V.sum(2) + e_tot * (ds_out * s_in).sum((-2, -1))
    da = dcum.flip(2).cumsum(2).flip(2)
    return (dx.reshape(B, S, H, P).to(xdt.dtype), da.reshape(B, S, H),
            db.reshape(B, S, N).to(bm.dtype), dc.reshape(B, S, N).to(cm.dtype))


def repack_reference(src, idx):
    """out[i] = src[idx[i]]."""
    return src[idx]
