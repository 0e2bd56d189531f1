"""Plain reference of a dense decoder-only LM's training steps (GQA
attention with rotary positions, RMSNorm, a SwiGLU MLP, tied embeddings,
the mean token cross-entropy over the physical vocabulary, AdamW with
global-norm clipping).

A frozen copy of the equations, in plain PyTorch: it imports nothing of
the program under test, and takes from it nothing but the results it
judges.  The benchmark makes the weights (:func:`make_params`) and the
batches (:func:`make_batch`) from the seed and hands the same to the
program and to :func:`train_steps`.

``precision="fp32"`` computes every operation in float32 with TF32 off.
``precision="fp8"`` is the control, the precision below the program's
bf16: every matrix product takes its operands rounded to float8 (e4m3,
one scale a tensor; its output gradient e5m2), with float32
accumulation and float32 everywhere else.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

#: rows of queries one attention block takes
Q_BLOCK = 1024
INIT_STD = 0.02


def sizes(cfg: Dict) -> Dict:
    """The equations' sizes, read from a configuration's Hugging Face
    keys; the vocabulary padded to a multiple of 128 rows, as the
    program lays its embedding out."""
    D, H, V = (cfg["hidden_size"], cfg["num_attention_heads"],
               cfg["vocab_size"])
    return {"num_layers": cfg["num_hidden_layers"], "d_model": D,
            "num_heads": H, "num_kv_heads": cfg["num_key_value_heads"],
            "head_dim": cfg.get("head_dim", D // H),
            "d_ff": cfg["intermediate_size"], "vocab_size": V,
            "vocab_phys": -(-V // 128) * 128,
            "rope_theta": cfg["rope_theta"], "norm_eps": cfg["rms_norm_eps"]}


def leaf_specs(m: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """``(path, shape, init)`` of every weight, in the order
    :func:`make_params` draws them.  Layer weights are stacked on a
    leading layer axis; the vocabulary is the physical (padded) one."""
    L, D, F = m["num_layers"], m["d_model"], m["d_ff"]
    H, Hk, hd, Vp = m["num_heads"], m["num_kv_heads"], m["head_dim"], \
        m["vocab_phys"]
    return [
        ("embed/embedding", (Vp, D), "normal"),
        ("ln_f/scale", (D,), "ones"),
        ("layers/ln1/scale", (L, D), "ones"),
        ("layers/attn/wq", (L, D, H, hd), "normal"),
        ("layers/attn/wk", (L, D, Hk, hd), "normal"),
        ("layers/attn/wv", (L, D, Hk, hd), "normal"),
        ("layers/attn/wo", (L, H, hd, D), "normal"),
        ("layers/ln2/scale", (L, D), "ones"),
        ("layers/mlp/wi_gate", (L, D, F), "normal"),
        ("layers/mlp/wi_up", (L, D, F), "normal"),
        ("layers/mlp/wo", (L, F, D), "normal"),
    ]


def make_params(m: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Float32 weights from ``seed``: one draw a leaf from one generator
    on ``device``, N(0, 0.02) matrices and unit norm scales.  The same
    seed gives the same weights, bit for bit."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for path, shape, init in leaf_specs(m):
        if init == "ones":
            out[path] = torch.ones(shape, dtype=torch.float32, device=device)
        else:
            out[path] = torch.randn(shape, generator=gen, dtype=torch.float32,
                                    device=device).mul_(INIT_STD)
    return out


def nest(flat: Dict[str, torch.Tensor]) -> Dict:
    """``{"a/b": t}`` -> ``{"a": {"b": t}}``."""
    out: Dict = {}
    for path, t in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return out


def make_batch(m: Dict, batch: int, seq_len: int, seed: int, step: int):
    """Step ``step``'s batch: uniform token ids over the true vocabulary,
    every row its own draw; labels are the tokens shifted by one."""
    rng = np.random.default_rng([seed, step])
    toks = rng.integers(0, m["vocab_size"], size=(batch, seq_len + 1),
                        dtype=np.int64).astype(np.int32)
    return {"tokens": np.ascontiguousarray(toks[:, :-1]),
            "labels": np.ascontiguousarray(toks[:, 1:]),
            "mask": np.ones((batch, seq_len), np.float32)}


# ----------------------------------------------------------------------
# the control's rounding
# ----------------------------------------------------------------------

def _fake_fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = torch.finfo(dtype).max / amax
    return (x * scale).to(dtype).to(torch.float32) / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        a8 = _fake_fp8(a, torch.float8_e4m3fn)
        b8 = _fake_fp8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(a8, b8)
        return a8 @ b8

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = _fake_fp8(g, torch.float8_e5m2)
        return g8 @ b8.transpose(-1, -2), a8.transpose(-1, -2) @ g8


def _mm(a, b, precision: str):
    if precision == "fp8":
        return _Fp8Matmul.apply(a, b)
    return a @ b


# ----------------------------------------------------------------------
# forward
# ----------------------------------------------------------------------

def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, theta: float):
    """x: (S, heads, hd); rotary positions 0..S-1, halves rotated."""
    S, _, hd = x.shape
    half = hd // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                        device=x.device) / half))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, precision: str):
    """Causal GQA attention of one sequence: q (H, S, hd), k/v (Hk, S,
    hd); query head h reads key head h // (H / Hk); scale hd ** -0.5.
    Queries go in blocks of ``Q_BLOCK``, each over its causal keys."""
    H, S, hd = q.shape
    g = H // k.shape[0]
    k = k.repeat_interleave(g, dim=0)
    v = v.repeat_interleave(g, dim=0)
    outs = []
    for i0 in range(0, S, Q_BLOCK):
        i1 = min(S, i0 + Q_BLOCK)
        s = _mm(q[:, i0:i1], k[:, :i1].transpose(1, 2), precision) \
            * hd ** -0.5
        qpos = torch.arange(i0, i1, device=q.device)[:, None]
        kpos = torch.arange(i1, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
        outs.append(_mm(torch.softmax(s, dim=-1), v[:, :i1], precision))
    return torch.cat(outs, dim=1)


def layer(x, w: Dict[str, torch.Tensor], m: Dict, precision: str):
    """One decoder block on one sequence x (S, D)."""
    S, D = x.shape
    H, Hk, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    h = rmsnorm(x, w["ln1"], m["norm_eps"])
    q = _mm(h, w["wq"].reshape(D, H * hd), precision).view(S, H, hd)
    k = _mm(h, w["wk"].reshape(D, Hk * hd), precision).view(S, Hk, hd)
    v = _mm(h, w["wv"].reshape(D, Hk * hd), precision).view(S, Hk, hd)
    q, k = rope(q, m["rope_theta"]), rope(k, m["rope_theta"])
    o = attention(q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1),
                  precision)
    x = x + _mm(o.transpose(0, 1).reshape(S, H * hd),
                w["wo"].reshape(H * hd, D), precision)
    h = rmsnorm(x, w["ln2"], m["norm_eps"])
    gate = _mm(h, w["wi_gate"], precision)
    up = _mm(h, w["wi_up"], precision)
    return x + _mm(torch.nn.functional.silu(gate) * up, w["wo_mlp"],
                   precision)


def _ce_sum(x, emb, ln_f, labels, eps, precision):
    x = rmsnorm(x, ln_f, eps)
    logits = _mm(x, emb.t(), precision)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[:, None].long())[:, 0]
    return torch.sum(logz - ll)


def row_loss(p: Dict[str, torch.Tensor], tokens, labels, m: Dict,
             precision: str):
    """Summed token cross-entropy of one sequence; each block and the
    loss head recompute in the backward (``torch.utils.checkpoint``).
    The stacked layer weights are unbound once, so that each one's
    gradient is stacked once."""
    x = p["embed/embedding"][tokens.long()]
    names = {"ln1": "layers/ln1/scale", "wq": "layers/attn/wq",
             "wk": "layers/attn/wk", "wv": "layers/attn/wv",
             "wo": "layers/attn/wo", "ln2": "layers/ln2/scale",
             "wi_gate": "layers/mlp/wi_gate", "wi_up": "layers/mlp/wi_up",
             "wo_mlp": "layers/mlp/wo"}
    per_layer = {k: p[path].unbind(0) for k, path in names.items()}
    for i in range(m["num_layers"]):
        w = {k: views[i] for k, views in per_layer.items()}
        x = checkpoint(layer, x, w, m, precision, use_reentrant=False)
    return checkpoint(_ce_sum, x, p["embed/embedding"], p["ln_f/scale"],
                      labels, m["norm_eps"], precision, use_reentrant=False)


def loss_and_grads(p: Dict[str, torch.Tensor], batch, m: Dict,
                   precision: str):
    """Mean token cross-entropy over the batch and its gradient, one
    sequence at a time, the gradients summed in place."""
    dev = p["embed/embedding"].device
    tokens = torch.from_numpy(batch["tokens"]).to(dev)
    labels = torch.from_numpy(batch["labels"]).to(dev)
    n = tokens.shape[0]
    denom = float(n * tokens.shape[1])
    leaves = {k: t.detach().requires_grad_() for k, t in p.items()}
    total = 0.0
    for r in range(n):
        loss = row_loss(leaves, tokens[r], labels[r], m, precision) / denom
        loss.backward()
        total += float(loss.detach())
        del loss
    grads = {k: t.grad if t.grad is not None else torch.zeros_like(t)
             for k, t in leaves.items()}
    return total, grads


# ----------------------------------------------------------------------
# AdamW
# ----------------------------------------------------------------------

def adamw(p, grads, mu, nu, count: int, o: Dict) -> float:
    """One AdamW update in place: global-norm clipping, bias correction,
    decoupled weight decay on every leaf of two or more dimensions.
    Returns the clipping's scale (the moments take the gradient times
    it)."""
    gnorm = math.sqrt(sum(float(torch.sum(g.double() ** 2))
                          for g in grads.values()))
    scale = min(1.0, o["clip_norm"] / (gnorm + 1e-9))
    b1, b2 = o["b1"], o["b2"]
    bc1, bc2 = 1 - b1 ** count, 1 - b2 ** count
    for k in p:
        g = grads[k] * scale
        mu[k].mul_(b1).add_((1 - b1) * g)
        nu[k].mul_(b2).add_((1 - b2) * g.square())
        step = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + o["eps"])
        if o["weight_decay"] and p[k].dim() >= 2:
            step = step + o["weight_decay"] * p[k]
        p[k].sub_(o["lr"] * step)
        del g, step
    return scale


def leaf_norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t, dtype=torch.float64))


#: entries of each leaf that the first gradient is compared at
SAMPLE = 1 << 20


def sample_index(m: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """For each leaf, the flat positions (``SAMPLE`` of them, or all of a
    smaller leaf) at which the first step's gradient is compared, drawn
    from the seed."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    out = {}
    for path, shape, _ in leaf_specs(m):
        n = math.prod(shape)
        out[path] = torch.arange(n, device=device) if n <= SAMPLE else \
            torch.randint(n, (SAMPLE,), generator=gen, device=device)
    return out


def train_steps(m: Dict, opt: Dict, seed: int, batches: List, device,
                precision: str = "fp32") -> Dict:
    """``len(batches)`` training steps from the seed's weights.  Returns
    each step's loss, each leaf's norm of the first step's clipped
    gradient and its entries at :func:`sample_index`'s positions, and
    each leaf's norm of its change over all the steps."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        p = make_params(m, seed, device)
        mu = {k: torch.zeros_like(t) for k, t in p.items()}
        nu = {k: torch.zeros_like(t) for k, t in p.items()}
        losses, grad_norms = [], {}
        for i, batch in enumerate(batches):
            loss, grads = loss_and_grads(p, batch, m, precision)
            losses.append(loss)
            with torch.no_grad():
                scale = adamw(p, grads, mu, nu, i + 1, opt)
            if i == 0:
                grad_norms = {k: leaf_norm(g) * scale
                              for k, g in grads.items()}
                idx = sample_index(m, seed, device)
                grad_sample = {k: (g.reshape(-1)[idx[k]] * scale).cpu()
                               for k, g in grads.items()}
            del grads
        del mu, nu
        p0 = make_params(m, seed, device)
        with torch.no_grad():
            change = {k: leaf_norm(p[k] - p0[k]) for k in p}
        return {"losses": losses, "grad_norms": grad_norms,
                "grad_sample": grad_sample, "change_norms": change}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
