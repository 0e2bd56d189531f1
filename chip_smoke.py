#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py          # from the root of a checkout

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, holds
each against its plain PyTorch version, then drives the port's serving path
at the full width and depth of ``granite-3-2b`` (40 layers, random weights
from a seed) and checks that it really ran through the kernels.  Phases:

1. device: ``nvidia-smi`` name and power limit, ``torch.cuda`` name;
2. build: compile every kernel (one nvcc per source, in parallel);
3. K1 flash attention against ``attention_reference``: the cases of the
   JAX package's kernel tests, then the slice's own bf16 shapes;
4. K2 block-cyclic repack against ``repack_reference``: the kernel tests'
   shapes, then a 4 -> 8 -> 2 block-cyclic redistribution of the fp32
   embedding table (49280 x 2048, block 64) through
   ``BlockCyclicPattern.host_redistribute`` — K2's own path;
5. the serving path: ``decode_demo`` (batch 16, prompt 256, 128 decoded
   tokens, cache 512, 8 workers) without and with a 4 -> 8 -> 2 resize
   schedule; tokens must agree and each run must launch K1 40 x 384 times;
6. prefill vs decode: ``make_prefill_step`` (K1 at Sq=256, causal) against
   the decode path's logits after the same 256 prompt tokens, in fp32
   (tight) and in bf16 (each against the fp32 logits);
7. where a decode step's time goes: ``make_serve_step`` at the path's
   shapes (cache index 383 of 512), an untimed warm-up, a window timed on
   the host clock, then a window of as many steps under ``torch.profiler``
   whose device busy time, idle share and largest device kernels all come
   from that one traced window;
8. one JSON line ``{"kernels": [...]}`` with each kernel's launches, error
   and times (kernel, plain version, bound, library yardstick) at the
   path's shapes, then the contract line ``{"ok": true, "device": ...}``.

Any failure exits non-zero before the last line; no phase is caught and
continued.  Needs a CUDA card; without one (or outside a checkout) it
exits 1 and prints no result.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
H100_FLOPS = {"bfloat16": 989e12,   # dense tensor-core peak
              "float32": 67e12}     # fp32 outside the tensor cores

DEVICE = "cuda:0"
ARCH = "granite-3-2b"
BATCH, PROMPT, DECODE, CACHE, WORKERS = 16, 256, 128, 512, 8
SCHEDULE = {272: 8, 320: 2}
PROFILE_WARMUP, PROFILE_STEPS, PROFILE_TOP = 5, 20, 8
TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # as the JAX kernel tests
#: prefill (K1 at Sq=256) vs decode (K1 at Sq=1 over the cache) logits after
#: the same 256 tokens.  In fp32 the two paths differ only in summation
#: order, through 40 layers: a tight check of the cache, positions and masks.
FP32_LOGITS_ATOL = 2e-3
#: each bf16 path against the fp32 logits: bf16 keeps 8 significant bits and
#: the two paths round in different places over 40 residual layers.  The
#: logits' standard deviation is ~0.9; a third of it still catches a wrong
#: cache, position or mask, which moves logits by about one deviation.
BF16_LOGITS_ATOL = 0.3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def phase(tag: str, **kv) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = flops / H100_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def main() -> None:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"missing package: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs a CUDA card")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run from a checkout")
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core.redistribute import blockcyclic_split
    from repro_torch.dmr import get_pattern
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.ref import attention_reference, repack_reference
    from repro_torch.models import model as M
    from repro_torch.models.train import (make_prefill_step, make_serve_step,
                                          prefill_logits)
    from repro_torch.serve import decode_demo

    dev = torch.device(DEVICE)

    # -- 1. device ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line)
    kind = torch.cuda.get_device_name(0)
    phase("device", name=repr(kind), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)

    # -- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    ops.build()
    regs = {n: [l.split("Used ")[1].split(",")[0] for l in
                _build.build_log(n).splitlines() if "Used " in l]
            for n in _build.SIGNATURES}
    phase("build", seconds=f"{time.perf_counter() - t0:.2f}",
          nvcc_seconds=f"{_build.last_build_s:.2f}",
          registers=json.dumps(regs, separators=(",", ":")))

    rng = np.random.default_rng(0)

    def rand(shape, dtype=torch.float32):
        x = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(x).to(dev, dtype)

    def check_close(out, exp, dtype: str, what: str) -> float:
        err = (out.float() - exp.float()).abs()
        tol = TOL[dtype]
        if bool((err > tol + tol * exp.float().abs()).any()):
            fail(f"{what}: max abs error {err.max().item():.3e} over the "
                 f"{dtype} tolerance {tol}")
        return err.max().item()

    # -- 3. K1 against its plain version ----------------------------------
    f32, bf16 = torch.float32, torch.bfloat16
    attn_cases = [(2, 4, 2, 256, 256, 64, True, 0, f32),
                  (1, 8, 8, 128, 128, 128, False, 0, f32),
                  (2, 4, 1, 256, 256, 64, True, 64, f32),
                  (1, 2, 2, 128, 128, 64, True, 0, bf16),
                  (1, 4, 2, 64, 64, 32, True, 0, f32)]
    decode_cases = [(3, 4, 2, 128, 64), (3, 4, 2, 256, 64), (3, 4, 2, 384, 64),
                    (5, 8, 1, 256, 64), (7, 2, 2, 192, 32), (1, 4, 4, 512, 128)]
    errs = {"float32": 0.0, "bfloat16": 0.0}
    for B, H, Hkv, Sq, Sk, D, causal, window, dt in attn_cases:
        q, k, v = rand((B, H, Sq, D), dt), rand((B, Hkv, Sk, D), dt), \
            rand((B, Hkv, Sk, D), dt)
        name = str(dt).split(".")[1]
        errs[name] = max(errs[name], check_close(
            ops.flash_attention(q, k, v, causal=causal, window=window),
            attention_reference(q, k, v, causal=causal, window=window),
            name, f"attn case {(B, H, Hkv, Sq, Sk, D, causal, window, name)}"))
    for B, H, Hkv, Sk, D in decode_cases:
        q, k, v = rand((B, H, 1, D)), rand((B, Hkv, Sk, D)), rand((B, Hkv, Sk, D))
        errs["float32"] = max(errs["float32"], check_close(
            ops.flash_attention(q, k, v, causal=False),
            attention_reference(q, k, v, causal=False), "float32",
            f"decode case {(B, H, Hkv, Sk, D)}"))
    qf, kf, vf = rand((2, 4, 256, 64)), rand((2, 4, 256, 64)), rand((2, 4, 256, 64))
    full = ops.flash_attention(qf, kf, vf, causal=True)
    for pos in (64, 128, 192):
        step = ops.flash_attention(qf[:, :, pos - 1:pos], kf[:, :, :pos],
                                   vf[:, :, :pos], causal=False)
        errs["float32"] = max(errs["float32"], check_close(
            step[:, :, 0], full[:, :, pos - 1], "float32",
            f"cache growth at {pos}"))
    # the slice's shapes, bf16: decode over valid lengths 1..512 in the
    # (B, S, Hkv, D) cache layout, and causal prefill Sq = Sk = 256
    cfg = get_config(ARCH)
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kc, vc = rand((BATCH, CACHE, Hkv, D), bf16), rand((BATCH, CACHE, Hkv, D), bf16)
    qd = rand((BATCH, 1, H, D), bf16)
    err_decode = 0.0
    for n in range(1, CACHE + 1):
        kv_len = torch.tensor(n, dtype=torch.int32, device=dev)
        args = (qd.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2))
        err_decode = max(err_decode, check_close(
            ops.flash_attention(*args, causal=False, kv_len=kv_len),
            attention_reference(*args, causal=False, kv_len=kv_len),
            "bfloat16", f"slice decode at kv_len {n}"))
    qp, kp, vp = rand((BATCH, PROMPT, H, D), bf16), \
        rand((BATCH, PROMPT, Hkv, D), bf16), rand((BATCH, PROMPT, Hkv, D), bf16)
    pargs = (qp.transpose(1, 2), kp.transpose(1, 2), vp.transpose(1, 2))
    err_prefill = check_close(ops.flash_attention(*pargs, causal=True),
                              attention_reference(*pargs, causal=True),
                              "bfloat16", "slice prefill")
    torch.cuda.synchronize()
    phase("K1", cases=len(attn_cases) + len(decode_cases) + 3,
          max_err_f32=f"{errs['float32']:.3e}",
          max_err_bf16=f"{errs['bfloat16']:.3e}",
          slice_decode_err=f"{err_decode:.3e}",
          slice_prefill_err=f"{err_prefill:.3e}",
          tol=json.dumps(TOL, separators=(",", ":")))

    # -- 4. K2 against its plain version ----------------------------------
    for nblocks, block, width, nout in [(16, 8, 32, 10), (8, 16, 16, 8),
                                        (32, 8, 128, 32)]:
        src = rand((nblocks, block, width))
        idx = rng.permutation(nblocks)[:nout]
        if not torch.equal(ops.repack(src, idx),
                           repack_reference(src, torch.from_numpy(idx).to(dev))):
            fail(f"repack {(nblocks, block, width, nout)} differs")
    vp_rows = M.model_schema(cfg)["embed"]["embedding"].shape
    table = torch.randn(vp_rows, generator=torch.Generator(dev).manual_seed(1),
                        device=dev)
    blk = 64
    parts4 = blockcyclic_split(table, 4, blk)
    pat = get_pattern(f"blockcyclic:{blk}")
    torch.cuda.synchronize()
    ops.reset_counts()
    parts8, st8 = pat.host_redistribute(parts4, 8)
    parts2, st2 = pat.host_redistribute(parts8, 2)
    torch.cuda.synchronize()
    repack_launches = ops.launch_counts()["repack"]
    for n, got in ((8, parts8), (2, parts2)):
        exp = blockcyclic_split(table, n, blk)
        if not all(torch.equal(a, b) for a, b in zip(got, exp)):
            fail(f"block-cyclic 4->8->2: the {n}-rank layout differs")
    nblk = vp_rows[0] // blk
    row_bytes = vp_rows[1] * table.element_size()
    g = np.arange(nblk)
    want = [int(((g % a) != (g % b)).sum()) * blk * row_bytes
            for a, b in ((4, 8), (8, 2))]
    if [st8.bytes_moved, st2.bytes_moved] != want:
        fail(f"bytes_moved {[st8.bytes_moved, st2.bytes_moved]} != {want}")
    if repack_launches != 2:
        fail(f"block-cyclic path launched K2 {repack_launches} times, not 2")
    phase("K2", table=tuple(vp_rows), table_mb=f"{table.nbytes / 1e6:.1f}",
          block=blk, exact=True, launches=repack_launches,
          bytes_moved=f"{st8.bytes_moved},{st2.bytes_moved}",
          seconds=f"{st8.seconds:.4f},{st2.seconds:.4f}")
    del parts4, parts8, parts2

    # -- 5. the serving path ----------------------------------------------
    runs = {}
    flash_path = []
    for label, schedule in (("static", None), ("elastic", SCHEDULE)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        ops.reset_counts()
        out = decode_demo(ARCH, batch=BATCH, prompt_len=PROMPT,
                          decode_steps=DECODE, cache_len=CACHE,
                          workers=WORKERS, device=dev, schedule=schedule,
                          seed=0)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        flash_path.append(counts["flash_attention"])
        want = cfg.num_layers * (PROMPT + DECODE)
        if counts["flash_attention"] != want:
            fail(f"{label} run launched K1 {counts['flash_attention']} "
                 f"times, not {want}")
        toks = out["tokens"]
        if toks.shape != (BATCH, DECODE) or toks.min() < 0 or \
                toks.max() >= cfg.vocab_size:
            fail(f"{label} run: tokens of shape {toks.shape} in "
                 f"[{toks.min()}, {toks.max()}]")
        runs[label] = out
        phase(f"path:{label}", prefill_s=f"{out['prefill_s']:.3f}",
              decode_ms_per_token=f"{out['decode_s'] / DECODE * 1e3:.3f}",
              flash_launches=counts["flash_attention"],
              peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
              sizes=json.dumps(out["sizes"], separators=(",", ":")))
        for ev in out["events"]:
            phase(f"path:{label}:resize", step=ev.step, action=ev.action,
                  sizes=f"{ev.from_procs}->{ev.to_procs}",
                  bytes_moved=ev.transfer.bytes_moved,
                  seconds=f"{ev.transfer.seconds:.4f}")
        del out
    ela = runs["elastic"]
    if not np.array_equal(runs["static"]["tokens"], ela["tokens"]):
        fail("tokens differ between the static and the elastic run")
    if [e.action for e in ela["events"]] != ["expand", "shrink"]:
        fail(f"resize actions {[e.action for e in ela['events']]}")
    phase("path", tokens_equal=True, actions="expand,shrink")

    # -- 6. prefill vs decode -----------------------------------------------
    torch.cuda.empty_cache()
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BATCH, PROMPT), dtype=np.int32)).to(dev)
    batch = {"tokens": prompts}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    V = cfg.vocab_size

    def decode_logits(c):
        cache = M.init_cache(c, BATCH, CACHE, device=dev)
        for i in range(PROMPT):
            logits, cache = M.decode_step(
                params, c, prompts[:, i:i + 1], cache,
                torch.tensor(i, dtype=torch.int32, device=dev))
        return logits[:, -1, :V].float()

    with torch.no_grad():
        ops.reset_counts()
        first = make_prefill_step(cfg)(params, batch)
        torch.cuda.synchronize()
        flash_prefill = ops.launch_counts()["flash_attention"]
        if flash_prefill != cfg.num_layers:
            fail(f"prefill launched K1 {flash_prefill} times, not "
                 f"{cfg.num_layers}")
        lp = prefill_logits(params, cfg, batch)[:, :V].float()
        ld = decode_logits(cfg)
        lp32 = prefill_logits(params, cfg32, batch)[:, :V].float()
        ld32 = decode_logits(cfg32)
    if not all(bool(torch.isfinite(t).all()) for t in (lp, ld, lp32, ld32)):
        fail("logits are not finite")
    gap32 = (lp32 - ld32).abs().max().item()
    err_p = (lp - lp32).abs().max().item()
    err_d = (ld - ld32).abs().max().item()
    if gap32 > FP32_LOGITS_ATOL:
        fail(f"fp32 prefill vs decode logits differ by {gap32:.3e} > "
             f"{FP32_LOGITS_ATOL}")
    if max(err_p, err_d) > BF16_LOGITS_ATOL:
        fail(f"bf16 logits off the fp32 ones by {max(err_p, err_d):.3e} > "
             f"{BF16_LOGITS_ATOL}")
    agree = (first.cpu().numpy() == runs["static"]["tokens"][:, 0]).mean()
    phase("prefill", flash_launches=flash_prefill,
          fp32_prefill_vs_decode=f"{gap32:.4e}", fp32_tol=FP32_LOGITS_ATOL,
          bf16_prefill_vs_fp32=f"{err_p:.4e}",
          bf16_decode_vs_fp32=f"{err_d:.4e}",
          bf16_prefill_vs_decode=f"{(lp - ld).abs().max().item():.4e}",
          bf16_tol=BF16_LOGITS_ATOL, logits_std=f"{lp32.std().item():.3f}",
          first_token_agreement=f"{agree:.3f}")

    # -- 7. where a decode step's time goes -------------------------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    serve = make_serve_step(cfg)
    cache = M.init_cache(cfg, BATCH, CACHE, device=dev)
    tok = prompts[:, :1]
    pos = torch.tensor(PROMPT + DECODE - 1, dtype=torch.int32, device=dev)

    def steps(n):
        nonlocal tok, cache
        with torch.no_grad():
            for _ in range(n):
                tok, cache = serve(params, cache, tok, pos)
        torch.cuda.synchronize()

    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                return getattr(e, attr)
        return 0.0

    steps(PROFILE_WARMUP)
    t0 = time.perf_counter()
    steps(PROFILE_STEPS)
    wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps(PROFILE_STEPS)
        traced_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    # device-side events only: an operator's own device time repeats the
    # time of the kernels it launched, which are listed as events too
    events = prof.key_averages()
    dev_events = sorted((e for e in events if e.device_type ==
                         DeviceType.CUDA and dev_us(e) > 0),
                        key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in dev_events) / 1e3 / PROFILE_STEPS
    if busy_ms <= 0:
        fail("the profiler saw no device time in the traced decode steps")
    top = [{"kernel": e.key[:80],
            "ms_per_step": dev_us(e) / 1e3 / PROFILE_STEPS,
            "calls_per_step": e.count / PROFILE_STEPS}
           for e in dev_events[:PROFILE_TOP]]
    phase("profile", cache_index=int(pos), steps=PROFILE_STEPS,
          untraced_ms_per_step=f"{wall_ms:.3f}",
          traced_ms_per_step=f"{traced_ms:.3f}",
          traced_device_busy_ms_per_step=f"{busy_ms:.3f}",
          traced_idle_share=f"{1 - busy_ms / traced_ms:.4f}",
          aten_ops_per_step=sum(e.count for e in events
                                if e.key.startswith("aten::"))
          / PROFILE_STEPS,
          top=json.dumps(top, separators=(",", ":")))
    del params, cache, prof, events

    # -- 8. kernels line: times at the path's shapes ------------------------
    kernels = []
    # K1 decode: the last step of the path (kv_len = 384 of a 512 cache)
    n = PROMPT + DECODE
    kv_len = torch.tensor(n, dtype=torch.int32, device=dev)
    args = (qd.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2))
    lib_args = (args[0], args[1][:, :, :n], args[2][:, :, :n])
    el = 2                                   # bf16 bytes
    b_dec, by_dec = bound_ms(
        el * (2 * BATCH * H * D + 2 * BATCH * Hkv * n * D),
        4 * BATCH * H * n * D, "bfloat16")
    kernels.append({
        "name": "flash_attention_fwd (decode, Sq=1)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:73",
        "launches": flash_path[0], "max_abs_err": err_decode,
        "ms": time_ms(lambda: ops.flash_attention(*args, causal=False,
                                                  kv_len=kv_len)),
        "plain_ms": time_ms(lambda: attention_reference(
            *args, causal=False, kv_len=kv_len), iters=20),
        "bound_ms": b_dec, "bound_by": by_dec,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            *lib_args, enable_gqa=True)),
        "shape": f"B={BATCH} H={H} Hkv={Hkv} D={D} kv_len={n} of {CACHE} bf16"})
    b_pre, by_pre = bound_ms(
        el * (2 * BATCH * PROMPT * H * D + 2 * BATCH * PROMPT * Hkv * D),
        4 * BATCH * H * D * (PROMPT * (PROMPT + 1) // 2), "bfloat16")
    kernels.append({
        "name": "flash_attention_fwd (prefill, causal)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:73",
        "launches": flash_prefill, "max_abs_err": err_prefill,
        "ms": time_ms(lambda: ops.flash_attention(*pargs, causal=True)),
        "plain_ms": time_ms(lambda: attention_reference(*pargs, causal=True),
                            iters=10),
        "bound_ms": b_pre, "bound_by": by_pre,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            *pargs, is_causal=True, enable_gqa=True)),
        "shape": f"B={BATCH} H={H} Hkv={Hkv} D={D} Sq=Sk={PROMPT} bf16"})
    # K2: the 4 -> 8 step of the block-cyclic path, one gather of the table
    from repro_torch.core.redistribute import blockcyclic_index
    counts4 = [(nblk + 3 - r) // 4 for r in range(4)]
    idx = np.concatenate(blockcyclic_index(counts4, 8))
    src = table.reshape(nblk, blk, vp_rows[1])
    idx_dev = torch.from_numpy(idx).to(dev)
    b_rep, by_rep = bound_ms(2 * table.nbytes + 4 * idx.size, 0, "float32")
    err_rep = (ops.repack(src, idx) - repack_reference(src, idx_dev)
               ).abs().max().item()
    if err_rep != 0.0:
        fail(f"repack of the table differs from its plain version by "
             f"{err_rep:.3e}")
    kernels.append({
        "name": "blockcyclic_repack", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/blockcyclic.cu",
        "replaces": "src/repro/kernels/blockcyclic.py:22",
        "launches": repack_launches, "max_abs_err": err_rep,
        "ms": time_ms(lambda: ops.repack(src, idx), iters=20),
        "plain_ms": time_ms(lambda: repack_reference(src, idx_dev), iters=20),
        "bound_ms": b_rep, "bound_by": by_rep,
        "library_ms": time_ms(lambda: torch.index_select(src, 0, idx_dev),
                              iters=20),
        "shape": f"src=({nblk},{blk},{vp_rows[1]}) fp32 idx={idx.size}"})
    print(json.dumps({"kernels": kernels, "card": smi_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
