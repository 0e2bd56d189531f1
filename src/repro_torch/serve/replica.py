"""Elastic LM serving: the decode path as a malleable job (port of
``make_decode_app`` / ``decode_demo`` in ``repro/serve/replica.py``).

:func:`make_decode_app` wraps prefill-by-decode plus greedy decode
(``make_serve_step`` and the decode cache of ``models/model.py``: a KV
cache, or an SSM state and conv tails) as a ``dmr.App`` whose resize
point is the decode-step boundary.  The state is
``{"params", "cache", "tok", "pos"}``; params move by the ``replicate``
pattern, the cache and the token column by ``default`` along their batch
axis — an inference server grows and shrinks mid-generation exactly the
way a training job does between steps.  Each decode step runs the whole
batch as one launch per operation whatever the worker count, so the tokens
are bit-identical across resizes.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core.params import MalleabilityParams
from repro_torch.parallel.mesh import Placement, logical_workers

__all__ = ["make_decode_app", "decode_demo"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_decode_app(cfg, *, batch: int, cache_len: int, seed: int = 0,
                    params=None):
    """The serving step as a ``dmr.App``: resize point = decode-step
    boundary.

    State tree: ``{"params", "cache", "tok", "pos"}``.  Params stay
    replicated (the ``{"params": "replicate"}`` pattern); cache leaves and
    ``tok`` are split along their batch axis over the whole mesh whenever
    ``batch`` divides the worker count.  ``params`` (e.g. from
    ``repro_torch.interop.params_from_numpy``) replaces the seeded init.
    ``step(state, i, feed)`` consumes ``feed`` (a ``(batch,)`` int array of
    prompt tokens) when given — prefill-by-decode — and the previous step's
    argmax otherwise; it returns ``(state, next_tokens)``.
    """
    from repro_torch import dmr
    from repro_torch.models import model as M
    from repro_torch.models.train import make_serve_step

    def _shardings(mesh):
        n = mesh.size

        def shard_batch(shape):
            if batch % n == 0:
                # cache leaves stack layers in front: batch sits at axis
                # 1 for (L, B, ...) leaves, axis 0 for (B, ...) leaves
                for ax in (1, 0):
                    if ax < len(shape) and shape[ax] == batch:
                        return Placement(mesh, ax)
            return Placement(mesh)

        # the cache's real shapes, allocated nowhere (the counterpart of
        # the reference's jax.eval_shape)
        cache_meta = M.init_cache(cfg, batch, cache_len, device="meta")
        return {
            "params": T.tree_map(lambda _: Placement(mesh),
                                 M.model_schema(cfg)),
            "cache": T.tree_map(lambda t: shard_batch(tuple(t.shape)),
                                cache_meta),
            "tok": shard_batch((batch, 1)),
            "pos": Placement(mesh),
        }

    def _init(mesh):
        dev = mesh.device
        if params is not None:
            p = T.tree_map(lambda t: t.to(dev), params)
        else:
            gen = torch.Generator(device=dev).manual_seed(seed)
            p = M.init_params(cfg, gen, dev)
        return {"params": p,
                "cache": M.init_cache(cfg, batch, cache_len, device=dev),
                "tok": torch.zeros((batch, 1), dtype=torch.int32, device=dev),
                "pos": torch.zeros((), dtype=torch.int32, device=dev)}

    def _step(mesh):
        # one closure per mesh: the runner swaps closures on resize
        dev = mesh.device
        serve_impl = make_serve_step(cfg)

        def step_fn(state, i, feed=None):
            tok = state["tok"]
            if feed is not None:
                tok = torch.as_tensor(np.asarray(feed, np.int32)).reshape(
                    batch, 1).to(dev)
            with torch.no_grad():
                nxt, cache = serve_impl(state["params"], state["cache"], tok,
                                        state["pos"])
            state = {"params": state["params"], "cache": cache, "tok": nxt,
                     "pos": state["pos"] + 1}
            return state, nxt

        return step_fn

    name = getattr(cfg, "name", "lm")
    return dmr.App(init=_init, shardings=_shardings, step=_step,
                   patterns={"params": "replicate"},
                   name=f"decode-{name}")


def decode_demo(arch, *, batch: int = 4, prompt_len: int = 16,
                decode_steps: int = 16, cache_len: int = 128,
                schedule: Optional[Dict[int, int]] = None,
                workers: int = 1, devices: Optional[List] = None,
                device=None, seed: int = 0, params=None) -> Dict:
    """Prefill + greedy decode under a ``MalleableRunner``, resizing at
    decode-step boundaries through ``dmr.reconfig``.

    ``arch`` is a config name (``get_config``) or an ``ArchConfig``, such
    as one cut in depth with ``dataclasses.replace``.  The pool is
    ``workers`` logical workers on ``device`` (``cuda`` unless given;
    raises when no card is present) or an explicit ``devices`` list.
    ``schedule`` is a ``{step: target_workers}`` dict (``dmr.connect``'s
    scripted form); the default resizes nobody.  Returns ``{"tokens":
    (batch, decode_steps) array, "events": [ResizeEvent...], "sizes":
    [(step, workers)...], "prefill_s", "decode_s"}``; the two times end
    with the device synchronised.
    """
    from repro_torch import dmr
    from repro_torch.configs import get_config

    cfg = get_config(arch) if isinstance(arch, str) else arch
    devices = list(devices) if devices is not None \
        else logical_workers(workers, device)
    dev = devices[0].device
    hi = 1 << (len(devices).bit_length() - 1)         # largest pow2 <= pool
    mparams = MalleabilityParams(1, hi, min(hi, max(1, hi // 2)))
    app = make_decode_app(cfg, batch=batch, cache_len=cache_len, seed=seed,
                          params=params)
    runner = dmr.MalleableRunner(app, mparams, rms=dict(schedule or {}),
                                 devices=devices[:hi])
    state = runner.init()

    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, (batch, prompt_len),
                           dtype=np.int32)
    sizes: List[Tuple[int, int]] = [(0, runner.current)]
    outs: List[torch.Tensor] = []
    _sync(dev)
    t0 = time.perf_counter()
    prefill_s = 0.0
    total = prompt_len + decode_steps
    for i in range(total):
        state = dmr.reconfig(runner, state, i)
        if sizes[-1][1] != runner.current:
            sizes.append((i, runner.current))
        feed = prompts[:, i] if i < prompt_len else None
        state, tok = runner.step(state, i, feed)
        if i >= prompt_len - 1:
            outs.append(tok[:, 0])
        if i == prompt_len - 1:
            _sync(dev)
            prefill_s = time.perf_counter() - t0
            t0 = time.perf_counter()
    _sync(dev)
    decode_s = time.perf_counter() - t0
    tokens = torch.stack(outs[:decode_steps], dim=1).cpu().numpy()
    return {"tokens": tokens, "events": list(runner.events),
            "sizes": sizes, "prefill_s": prefill_s, "decode_s": decode_s}
