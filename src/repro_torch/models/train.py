"""Loss, train step and serve / prefill step factories of the port (port
of ``repro/models/train.py``).

``TrainState`` is the *complete* job state: on a malleability resize the
whole tree is redistributed to the new mesh (DMRlib's "robust restart").
Its leaves flatten in ``jax.tree`` order — params, opt (mu, nu, count),
step, rng, data_cursor — so paths and checkpoint leaf order match the JAX
package's.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.models.layers import unembed
from repro_torch.models.params import torch_dtype
from repro_torch.optim.adamw import AdamW, OptState
from repro_torch.spans import span


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    step: torch.Tensor         # int32 scalar
    rng: torch.Tensor          # uint32 (2,): the JAX PRNG key data
    data_cursor: torch.Tensor  # int32 sample counter (data-pipeline state)


def init_state(cfg: ArchConfig, optimizer: AdamW, seed: int = 0,
               device="cpu") -> TrainState:
    """Parameters from a ``torch.Generator`` seeded with ``seed`` (numbers
    differ from ``jax.random``'s: parity tests carry JAX's state over with
    ``interop.train_state_from_numpy``); ``rng`` holds the bits of JAX's
    ``key_data(PRNGKey(seed + 1))``, threefry's ``[0, seed + 1]``."""
    device = torch.device(device)
    params = M.init_params(cfg, torch.Generator(device).manual_seed(seed),
                           device)
    zero = torch.zeros((), dtype=torch.int32, device=device)
    return TrainState(params=params, opt=optimizer.init(params),
                      step=zero.clone(),
                      rng=torch.tensor([0, seed + 1], dtype=torch.uint32,
                                       device=device),
                      data_cursor=zero.clone())


def abstract_state(cfg: ArchConfig, optimizer: AdamW) -> TrainState:
    """``init_state``'s tree as meta tensors, for the dry run: the same
    paths, shapes and dtypes, the moments in ``optimizer.moment_dtype``;
    nothing allocated.  (``rng`` is ``init_state``'s two uint32 words, as
    ``jax.eval_shape`` of the reference's ``init_state`` gives them.)"""
    params = M.abstract_params(cfg)
    mdt = torch_dtype(optimizer.moment_dtype)
    mom = lambda: T.tree_map(lambda p: torch.empty(p.shape, dtype=mdt,
                                                   device="meta"), params)
    scalar = lambda: torch.empty((), dtype=torch.int32, device="meta")
    return TrainState(
        params=params, opt=OptState(mu=mom(), nu=mom(), count=scalar()),
        step=scalar(), rng=torch.empty((2,), dtype=torch.uint32,
                                       device="meta"),
        data_cursor=scalar())


LOSS_CHUNK = 1024   # sequence chunk for the CE loss (0 => unchunked)


#: the profiler span each CE chunk's forward runs in (its recomputation in
#: the backward too); the autograd records of its backward carry its
#: operators' sequence numbers
CE_SPAN = "chunked_ce"
#: the profiler span of the optimizer's update: AdamW's global norm, clip,
#: moments and parameters
OPTIMIZER_SPAN = "train.optimizer"


def _ce_chunk(embed_params, x_c, labels_c, mask_c, cfg: ArchConfig):
    """Cross-entropy over one sequence chunk; logits never leave the chunk.
    ``logz`` runs over the physical (padded) vocab, as the reference's."""
    with span(CE_SPAN):
        logits = unembed(embed_params, x_c, cfg).float()
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels_c[..., None].long())[..., 0]
        return torch.sum((logz - ll) * mask_c)


def chunked_ce(embed_params, x, labels, mask, cfg: ArchConfig,
               chunk: int = LOSS_CHUNK):
    """Sum of masked CE without materializing (B, S, V) logits: the
    (B, c, V) logits of each chunk are recomputed in the backward
    (``torch.utils.checkpoint``), chunk sums added in order from 0.

    ``c`` is the largest divisor of S up to ``chunk``.  The reference
    takes ``chunk`` when it divides S and the whole sequence otherwise;
    the two agree whenever ``chunk`` divides S (every sequence but a
    vision model's text span: pixtral's 3840 of 4096 would otherwise put
    its (8, 3840, 131072) fp32 logits, 16 GB, on the card at once) and
    otherwise differ only in the order of the fp32 chunk sums."""
    S = x.shape[1]
    c = min(chunk, S) if chunk else S
    while S % c:
        c -= 1
    if S // c <= 1:
        return _ce_chunk(embed_params, x, labels, mask, cfg)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for s0 in range(0, S, c):
        sl = slice(s0, s0 + c)
        tot = tot + checkpoint(_ce_chunk, embed_params, x[:, sl],
                               labels[:, sl], mask[:, sl], cfg,
                               use_reentrant=False)
    return tot


def loss_fn(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor]):
    x, aux = M.forward_hidden(params, cfg, batch)
    labels, mask = batch["labels"], batch["mask"]
    if cfg.frontend is not None and cfg.frontend.kind == "vision":
        # hidden covers [patch prefix + text]; loss only on the text span
        x = x[:, cfg.frontend.tokens_per_sample:, :]
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = chunked_ce(params["embed"], x, labels, mask, cfg) / denom
    return loss + aux, {"ce_loss": loss, "aux_loss": aux}


def _value_and_grad(params, cfg: ArchConfig, batch):
    """(loss, metrics, grads in flatten order) of ``loss_fn``."""
    leaves = [p.detach().requires_grad_() for p in T.leaves(params)]
    loss, metrics = loss_fn(T.unflatten(params, leaves), cfg, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg: ArchConfig, optimizer: AdamW):
    """``train_step(state, batch) -> (state, metrics)``; batch: tensors on
    the state's device.  The optimizer writes the new parameters and
    moments into ``state``'s tensors (see ``optim.adamw``)."""
    mb = max(1, cfg.train_microbatches)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        B = batch["tokens"].shape[0]
        eff_mb = mb if (B % mb == 0 and B >= mb) else 1
        if eff_mb == 1:
            loss, metrics, grads = _value_and_grad(state.params, cfg, batch)
        else:
            # gradient accumulation in opt_moment_dtype, as the reference's,
            # into one buffer per leaf (in place: at mixtral's width a
            # second copy of the sums would not fit beside the state)
            acc_dt = torch_dtype(cfg.opt_moment_dtype)
            grads = [torch.zeros(p.shape, dtype=acc_dt, device=p.device)
                     for p in T.leaves(state.params)]
            losses, ms = [], []
            for j in range(eff_mb):
                one = {k: v.reshape(eff_mb, B // eff_mb, *v.shape[1:])[j]
                       for k, v in batch.items()}
                l, m, g = _value_and_grad(state.params, cfg, one)
                for a, gg in zip(grads, g):
                    a.add_(gg.to(acc_dt))
                del g
                losses.append(l)
                ms.append(m)
            for a in grads:
                a.div_(eff_mb)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        with span(OPTIMIZER_SPAN):
            new_params, new_opt, gnorm = optimizer.update(
                T.unflatten(state.params, list(grads)), state.opt,
                state.params)
        new_state = TrainState(
            params=new_params, opt=new_opt, step=state.step + 1,
            rng=state.rng, data_cursor=state.data_cursor + B)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm,
                       step=new_state.step)
        return new_state, metrics

    return train_step


def _mask_padded_vocab(logits, cfg: ArchConfig):
    """Physical vocab is padded to a shardable multiple; mask the pad ids."""
    v = logits.shape[-1]
    if v == cfg.vocab_size:
        return logits
    ids = torch.arange(v, device=logits.device)
    return logits.masked_fill(ids[None, :] >= cfg.vocab_size, float("-inf"))


def make_serve_step(cfg: ArchConfig):
    """One-token batched decode: (params, cache, tokens, index) ->
    (next tokens (B, 1) int32, cache)."""
    def serve_step(params, cache, tokens, cache_index):
        logits, cache = M.decode_step(params, cfg, tokens, cache, cache_index)
        masked = _mask_padded_vocab(logits[:, -1, :], cfg)
        next_tok = torch.argmax(masked, dim=-1).to(torch.int32)
        return next_tok[:, None], cache

    return serve_step


def prefill_logits(params, cfg: ArchConfig, batch):
    """Full-sequence forward; only the last position's logits (B, V_phys)."""
    x, _ = M.forward_hidden(params, cfg, batch)
    return unembed(params["embed"], x[:, -1:, :], cfg)[:, -1, :]


def make_prefill_step(cfg: ArchConfig):
    """Full-sequence forward -> greedy next token per sequence (B,) int32."""
    def prefill_step(params, batch):
        masked = _mask_padded_vocab(prefill_logits(params, cfg, batch), cfg)
        return torch.argmax(masked, dim=-1).to(torch.int32)

    return prefill_step
