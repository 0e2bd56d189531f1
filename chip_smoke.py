#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py          # from the root of a checkout

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (K1
flash attention and its backward, K2, K3 and its backward), holds each
against its plain PyTorch version, then drives the port's two serving
paths and its two training paths at full width with random weights from a
seed -- ``granite-3-2b`` (dense, K1; 10 of its 40 layers, see
``GRANITE_LAYERS``; training also at all 40), ``mamba2-370m`` (SSM, K3;
all 48 layers, serving and training) -- and checks that each really ran
through its kernels.  Phases:

1. device: ``nvidia-smi`` name and power limit, ``torch.cuda`` name;
2. build: compile every kernel (one nvcc per source, in parallel), and
   print ptxas's report of K1's, K2's and K3's kernels (registers, spills,
   static shared memory);
3. K1 flash attention against ``attention_reference``, each case also
   checking which of K1's three paths it took (``path_launches``): the
   cases of the JAX package's kernel tests; bf16 prefill on the mma path
   at head dims 16, 32, 64, 80 and 128, ragged, windowed, Sq < Sk causal,
   Hkv = H and Hkv = 1; then the slice's own bf16 shapes, and fp32 and
   bf16 decode at a kv_len inside the last key split;
3b. K1's backward (``flash_attention_bwd.cu``) against
   ``attention_backward_reference`` on dq, dk, dv from the forward's own
   output and row log-sum-exp: every head dim in fp32 and bf16, causal,
   windowed with Sq = Sk = 200, non-causal, each bf16 case on the wgmma
   path and each fp32 case on the fma path (``path_launches``); then the
   training shape (B=1 to bound the plain version's memory, H=32, Hkv=8,
   S=4096, D=64, bf16), run twice and equal bit for bit, and K1's forward
   output there against ``attention_reference``; the lse against the plain
   forward's;
4. K2 block-cyclic repack against ``repack_reference``: the kernel tests'
   shapes, then a 4 -> 8 -> 2 block-cyclic redistribution of the fp32
   embedding table (49280 x 2048, block 64) through
   ``BlockCyclicPattern.host_redistribute`` — K2's own path; every call
   on K2's bulk path (``path_launches``);
5. K3 SSD scan against ``ssd_reference`` (the sequential oracle) and
   ``ssd_chunked_reference`` (its own algorithm in plain PyTorch), each
   case also checking which of K3's two paths it took (``path_launches``):
   the cases of the JAX package's kernel tests, then the mamba2 path's
   shape (B=16, H=32, S=1024, P=64, N=128, Q=256) in bf16 (on the wgmma
   path) and in f32, the latter also at the decays of mamba2's random
   init;
5b. K3's backward (``ssd_scan_bwd.cu``) against
   ``ssd_chunked_backward_reference`` on dx, da, dB, dC (each held to a
   bound relative to its largest entry, ``SSD_BWD_TOL``), each case on the
   path its dtype and shapes select (``select_bwd_path``: bf16 on wgmma
   with whole 64-row tiles, up to four a chunk; else fma): the smoke
   config's scan, the JAX kernel tests' cases, a ragged chunk, bf16 on
   wgmma at three tiles a chunk, and the training shape (B=8, H=32,
   S=4096, P=64, N=128, Q=256) in bf16 and fp32, at mild decays and at
   mamba2's (in-chunk cumsums to ~-3e3);
   strided inputs equal to contiguous ones bit for bit; two runs at the
   training shape equal bit for bit; and K3's forward at the training
   shape (16 chunks of carried state) in bf16 on the wgmma path and in
   fp32, at mamba2's decays, against ``ssd_chunked_reference``
   (``SSD_CHUNKED_TOL``);
6. the granite serving path: ``decode_demo`` (batch 16, prompt 256, 128
   decoded tokens, cache 512, 8 workers) without and with a 4 -> 8 -> 2
   resize schedule; tokens must agree and each run must launch K1 once
   per layer per step (10 x 384 times), all on the split_decode path;
7. granite prefill vs decode: ``make_prefill_step`` (K1 at Sq=256,
   causal, on the mma path) against the decode path's logits after the
   same 256 prompt tokens, in fp32 (tight) and in bf16 (each against the
   fp32 logits);
8. where a granite decode step's time goes: ``make_serve_step`` at the
   path's shapes (cache index 383 of 512), an untimed warm-up, a window
   timed on the host clock, then a window of as many steps under
   ``torch.profiler`` whose device busy time, idle share and largest
   device kernels all come from that one traced window;
9. the mamba2 serving path: ``decode_demo`` at granite's batch, prompt,
   decode length, workers and resize schedule; tokens must agree, and the
   decode path (the SSM recurrence) launches neither K1 nor K3;
10. mamba2 prefill vs decode: ``make_prefill_step`` at B=16, S=1024 (four
    chunks, so the state is carried across chunks three times) must launch
    K3 once per layer, every launch on the wgmma path; fp32 full-sequence logits at every position against
    fp32 token-by-token decode logits (tight), bf16 prefill and decode each
    against fp32 (beside the fp32 model with bf16-rounded weights, the
    yardstick of how far bf16 rounding alone moves these logits); then one
    traced ``make_prefill_step`` whose top device kernels and K3 share of
    device time come from that one trace;
11. the granite training path (the paper's Listing 2): ``lm_train_app``
    under ``MalleableRunner`` at full width, 10 layers, ``train_4k``'s
    sequence of 4096 at global batch 8, bf16 compute over fp32 master
    weights and moments, remat; first the smoke model's step on the card
    against the CPU's; then 6 static steps and 6 elastic steps under
    ``{2: 8, 4: 2}`` (``tests/test_elastic.py``'s schedule) whose losses
    agree to 1e-4; every attention call on K1 (20 forward launches a step
    under remat, all on the mma path; 10 backward, all on wgmma), none on a
    plain version;
12. one traced 10-layer training step (the static run's next): device
    busy time, idle share, K1's forward and backward device time and
    share, the largest device operators;
13. the same training at all 40 layers: 2 static steps, s/step, peak GB,
    every backward call on wgmma (40 a step);
13b. the SSM training path: the ``mamba2-370m-smoke`` step on the card
    against the CPU's (loss and gradient norm, fp32), and the gradients
    of the leaves that take theirs only through K3's backward, each
    against the CPU's (``SSM_LEAF_TOL`` of its largest entry);
13c. ``mamba2-370m`` training at full width and all 48 layers, granite's
    settings (``train_4k``'s 4096 at global batch 8, bf16 over fp32
    master weights, remat, 8 workers, ``{2: 8, 4: 2}``): 6 static and 6
    elastic steps whose losses agree to 1e-4, s/step, tokens/s, peak GB;
    every scan on K3 (96 forward launches a step, all on wgmma; 48
    backward, all on wgmma), none on a plain version, no K1;
13d. one traced 48-layer step of the static run: device busy time, idle
    share, K3's forward and backward device time and share, the largest
    device operators;
14. one JSON line ``{"kernels": [...]}`` with each kernel's launches, error
    and times at the path's shapes: ``ms`` (CUDA events around 50
    back-to-back calls, host dispatch included), ``device_ms`` (the
    profiler's device time per call, device records only, taken right
    after phase 5: later in the process the profiler drops device
    records), the plain version's ``plain_ms``, the bound, and the library
    yardstick's ``library_ms`` and ``library_device_ms``.  K1's rows add
    ``device_ms_cold`` and ``library_device_ms_cold``, the same with each
    call on its own copy of the inputs, copies rotating through more bytes
    than the card's 50 MB L2 holds (back-to-back calls on one set of
    inputs find them in L2; a serving step finds them cold); K2's and K3's
    inputs alone outgrow L2.  K1 decode adds ``host_us``, the wrapper's
    host time per call; every row names the device path it timed.  K1
    has four rows: decode and prefill at the serving path's shapes, and
    its forward (with the lse, as training calls it) and backward at the
    training shape; K3 four, its forward at the prefill and at the
    training shape, and its backward at the training shape on both paths
    (bf16 on wgmma, the main path's; fp32 on fma, the smoke step's).  Then
    the contract line ``{"ok": true, ...}``.

Any failure exits non-zero before the last line; no phase is caught and
continued.  Needs a CUDA card; without one (or outside a checkout) it
exits 1 and prints no result.
"""
import dataclasses
import json
import os
import re
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
#: the granite path runs at full width and 10 of its 40 layers: with the
#: mamba2 path beside it, all 40 would put the script near half its time
#: limit on a slow host (the host sets the decode pace); K1's own checks
#: and times are at full width and unaffected
GRANITE_LAYERS = 10
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

#: K1's backward against its plain version: both fp32 from the same inputs
#: and lse, summation orders differ over up to G * S products per dk / dv
#: entry (1e-4); bf16 gradients are rounded once to 8 bits, as the
#: forward's 2e-2.  The lse (fp32 in both) is held to the fp32 bound.
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
BWD_TRAIN = (1, 32, 8, 4096, 64)    # B (cut to bound the plain version), H, Hkv, S, D
#: the training path: train_4k's sequence at a global batch cut from 256 to
#: 8 for one card; tests/test_elastic.py's malleability and schedule
TRAIN_SHAPE, TRAIN_BATCH, TRAIN_STEPS, DEPTH_STEPS = "train_4k", 8, 6, 2
TRAIN_PARAMS, TRAIN_SCHEDULE = (2, 8, 4), {2: 8, 4: 2}
#: elastic vs static losses at every step: tests/test_elastic.py's bound.
#: A resize copies the state; what may still differ is the order of the
#: embedding gradient's atomic adds (an accumulating index_put)
TRAIN_LOSS_TOL = 1e-4
PROFILE_TRAIN_TOP = 5

MAMBA = "mamba2-370m"               # serving runs at granite's batch, prompt,
M_PREFILL_S = 1024                  # decode length, workers and schedule
SSD_CASES = [  # (B, H, S, P, N, Q, dtype) -- tests/test_kernels.py
    (2, 4, 256, 32, 16, 64, "float32"), (1, 2, 128, 64, 128, 32, "float32"),
    (1, 2, 128, 32, 16, 128, "float32"), (2, 2, 64, 16, 16, 16, "bfloat16")]
SSD_SLICE = (16, 32, M_PREFILL_S, 64, 128, 256)   # B, H, S, P, N, Q
SSD_TOL = {"float32": 5e-4, "bfloat16": 3e-2}     # as the JAX kernel tests
#: K3 vs the chunked plain version: the same algorithm in fp32, differing
#: only in summation order.  The in-chunk cumsum's order matters most: at
#: mamba2's decays it reaches ~-3e3 (fp32 step 2.4e-4), which enters
#: exp(cum_q - cum_s) directly and moves y by ~1e-4 (phase 5 prints it as
#: model_decay_err_vs_chunked), so f32 keeps the oracle's 5e-4; in bf16
#: both round one fp32 value to 8 bits: one bf16 step (2^-7 relative)
SSD_CHUNKED_TOL = {"float32": 5e-4, "bfloat16": 1e-2}
#: mamba2 fp32 full-sequence logits (K3, chunked) vs the token-by-token
#: recurrence at every one of the 1024 positions: the same function in
#: fp32 through 48 layers.  The chunked algorithm (the Pallas contract, and
#: the JAX package's ssd_chunked) forms exp(cum_q - cum_s) from in-chunk
#: cumsums that reach ~-3e3 at this model's decays (A in [-16, -1]), so it
#: is ~1e-4 from the exact recurrence in y (phase 5: model_decay_err_f32),
#: 2.1e-3 in these logits after 48 layers in the chip runs.  The bound is
#: ~5x that and still ~1/60 of the logits' std (~0.64), which a wrong
#: carry, conv tail or chunk boundary moves by about one std.
M_FP32_LOGITS_ATOL = 1e-2
#: each mamba2 bf16 path against the fp32 logits, by the largest and the
#: root-mean-square gap.  This random-init model is sensitive to bf16
#: rounding wherever it happens: the fp32 model with its weights rounded
#: to bf16 (and nothing else) moves these logits by up to 0.59 (rms 0.085;
#: printed as fp32_bf16_weights), and computing in bf16 through 48 layers
#: by up to 1.04 (rms 0.16-0.17), prefill and decode alike, in the chip
#: runs.  So the largest gap is held to 2.0 (~3 std), which catches
#: overflow and blow-ups, and the rms gap to 0.4: a wrong state, conv tail
#: or chunk boundary decorrelates the logits, an rms gap of ~std * sqrt(2)
#: ~ 0.9.
M_BF16_LOGITS_MAX, M_BF16_LOGITS_RMS = 2.0, 0.4
#: K3's backward against its plain version, max |kernel - plain| over max
#: |plain| per output (da is a row sum minus a column sum that cancel, so
#: it is not held elementwise): in fp32 both sum in fp32 in other orders,
#: the plain version up to 5.2e-5 from the fp64 gradient in da at mamba2's
#: decays (tests/test_torch_ssm_train.py), so 1e-4, the bound the plain
#: version itself keeps to fp64; bf16 outputs are rounded once
#: (one bf16 step, at most 2^-7 relative), so 1e-2, which the bf16 wgmma
#: path's operand roundings keep to 0.34 of at worst at the training shape
#: (kernels/ssd_rounding.py, model_grads); da is fp32 for both dtypes and
#: keeps 1e-4
SSD_BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
#: the mamba2-smoke step's gradients of the leaves that take theirs only
#: through K3's backward (da, dB, dC), card against CPU, max |card - CPU|
#: over the leaf's largest entry.  Both are fp32 in other summation orders;
#: on the CPU, the plain backward's formulas in place of autograd move
#: these leaves by up to 3.1e-6 of their largest entry (A_log), and the
#: kernel is held to 1e-4 of its plain version (SSD_BWD_TOL), so 1e-4; a
#: wrong da, dB or dC moves them by O(1)
SSM_SCAN_LEAVES = ("A_log", "dt_bias", "w_dt", "w_B", "w_C", "conv_B",
                   "conv_C")
SSM_LEAF_TOL = 1e-4
#: K3's backward at the SSM training path's shape: B, H, S, P, N, Q
SSD_BWD_TRAIN = (TRAIN_BATCH, 32, 4096, 64, 128, 256)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def phase(tag: str, **kv) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def device_us(e) -> float:
    """An event's own device time (the attribute's name varies by torch
    version)."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, attr):
            return getattr(e, attr)
    return 0.0


def device_events(prof):
    """Device-side events only, largest first: an operator's own device
    time repeats the time of the kernels it launched, listed as events."""
    from torch.autograd import DeviceType
    return sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and device_us(e) > 0),
                  key=device_us, reverse=True)


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


def device_ms(calls, what: str, iters: int = 20) -> float:
    """Device time per call, from the profiler: the device records' own
    times summed over ``iters`` calls, gaps between them excluded.
    ``calls``: one callable, or a list of them taken in turn.  The profiler
    drops records now and then (a whole window, or part of one), so
    a window counts only if every record name in it appears a whole
    multiple of ``iters`` times, and only beside the next window when that
    one shows the same names and counts; the time is the mean of the two.
    After eight windows with no such pair the script fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    calls = calls if isinstance(calls, list) else [calls]

    def window():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                calls[i % len(calls)]()
            torch.cuda.synchronize()
        evs = device_events(prof)
        return ({e.key: e.count for e in evs},
                sum(device_us(e) for e in evs))

    for c in calls + calls[:2]:
        c()
    torch.cuda.synchronize()
    last = None
    for _ in range(8):
        counts, us = window()
        if not counts or any(n % iters for n in counts.values()):
            print(f"chip_smoke: {what}: {iters} calls left device records "
                  f"{ {k[:60]: n for k, n in counts.items()} }: taken again",
                  file=sys.stderr, flush=True)
            last = None
            continue
        if last is not None and last[0] == counts:
            ms = (us + last[1]) / 2e3 / iters
            print(f"[device_ms] {what}: {ms:.6f}", flush=True)
            return ms
        last = (counts, us)
    fail(f"{what}: the profiler dropped device records in eight windows")


def host_us(fn, iters: int = 200) -> float:
    """Host time per call of back-to-back calls that do not synchronise:
    what the wrapper costs the host (the device keeps up at these sizes)."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def ptxas_report(log: str) -> list:
    """ptxas's per-kernel report (``-Xptxas -v``): registers, spill bytes
    and static shared memory (the tiles and rings are dynamic shared
    memory, which ptxas does not see)."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            k = re.search(r"((?:attn|ssd_scan|ssd_bwd|repack)_[a-z_]*?"
                          r"kernel)(.*)", name)
            if not k:
                cur = None
                continue
            tail = k.group(2)
            args = ["bf16" if "nv_bfloat16" in tail else "f32"
                    if tail.startswith("If") or "EfE" in tail else ""]
            args = [a for a in args if a] + re.findall(r"Li(\d+)E", tail)
            cur = {"kernel": f"{k.group(1)}<{','.join(args)}>"}
            out.append(cur)
        elif cur is not None and "spill stores" in line:
            n = re.findall(r"(\d+) bytes", line)
            cur["stack"], cur["spill_st"], cur["spill_ld"] = map(int, n[:3])
        elif cur is not None and "Used " in line:
            cur["regs"] = int(re.search(r"Used (\d+) registers", line)[1])
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(sm[1]) if sm else 0
            cur = None
    return out


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

    from repro_torch import tree as T
    from repro_torch import dmr
    from repro_torch.configs import get_config, get_shape
    from repro_torch.core.lm_app import lm_train_app
    from repro_torch.core.redistribute import blockcyclic_split
    from repro_torch.dmr import get_pattern
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import blockcyclic as bc
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels.ref import (attention_backward_reference,
                                         attention_lse_reference,
                                         attention_reference,
                                         repack_reference,
                                         ssd_chunked_backward_reference,
                                         ssd_chunked_reference, ssd_reference)
    from repro_torch.models import model as M
    from repro_torch.models.train import (init_state, loss_fn,
                                          make_prefill_step, make_serve_step,
                                          make_train_step, prefill_logits)
    from repro_torch.optim import AdamW
    from repro_torch.parallel.mesh import logical_workers
    from repro_torch.serve import decode_demo

    dev = torch.device(DEVICE)
    t_start = time.perf_counter()
    marks = {}

    def mark(name: str) -> None:
        """Seconds since the start of the script at the end of a phase."""
        marks[name] = round(time.perf_counter() - t_start, 1)

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
    cfg = dataclasses.replace(get_config(ARCH), num_layers=GRANITE_LAYERS)
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    sms = fa._sm_count(dev)
    nsplit = fa.decode_splits(BATCH * Hkv, CACHE, sms)
    for tag, source in (("K1", "flash_attention"),
                        ("K1bwd", "flash_attention_bwd"),
                        ("K2", "blockcyclic"), ("K3", "ssd_scan"),
                        ("K3bwd", "ssd_scan_bwd")):
        report = ptxas_report(_build.build_log(source))
        if not report or any("regs" not in r for r in report):
            fail(f"no ptxas report for {tag}'s kernels: {report}")
        print(f"[ptxas:{tag}] " + json.dumps(report, separators=(",", ":")),
              flush=True)
        phase(f"ptxas:{tag}", kernels=len(report),
              max_regs=max(r["regs"] for r in report),
              spills=sum(r["spill_st"] + r["spill_ld"] for r in report))
    phase("K1:launch", sms=sms, decode_splits=nsplit)
    mark("build")

    rng = np.random.default_rng(0)

    def rand(shape, dtype=torch.float32):
        x = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(x).to(dev, dtype)

    def check_close(out, exp, dtype: str, what: str, tol=None) -> float:
        err = (out.float() - exp.float()).abs()
        tol = TOL[dtype] if tol is None else tol
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
    # bf16 prefill on the mma path: every head dim, then ragged Sq, a
    # window, Sq < Sk causal, Hkv = H and Hkv = 1 -- first at B * Hkv = 4
    # (the block kernel), then at B * Hkv >= 128 (the group kernel); fp32
    # D = 80 (fma path)
    prefill_cases = [(2, 8, 2, 256, 256, d, True, 0, bf16)
                     for d in fa.HEAD_DIMS] + [
        (2, 8, 2, 77, 77, 64, True, 0, bf16),
        (1, 8, 2, 200, 200, 128, True, 0, bf16),
        (2, 8, 2, 256, 256, 64, True, 64, bf16),
        (2, 8, 2, 100, 256, 64, True, 0, bf16),
        (2, 8, 8, 128, 128, 64, True, 0, bf16),
        (2, 8, 1, 128, 128, 80, True, 0, bf16),
        (2, 8, 2, 128, 128, 80, True, 0, f32)] + [
        (16, 32, 8, 256, 256, d, True, 0, bf16) for d in (16, 32, 80)] + [
        (16, 32, 8, 200, 200, 128, True, 0, bf16),
        (16, 32, 8, 256, 256, 64, True, 64, bf16),
        (16, 32, 8, 100, 256, 64, True, 0, bf16),
        (16, 8, 8, 130, 130, 64, False, 0, bf16),
        (132, 8, 1, 128, 128, 80, True, 0, bf16)]
    decode_cases = [(3, 4, 2, 128, 64), (3, 4, 2, 256, 64), (3, 4, 2, 384, 64),
                    (5, 8, 1, 256, 64), (7, 2, 2, 192, 32), (1, 4, 4, 512, 128),
                    (3, 4, 2, 200, 80)]
    errs = {"float32": 0.0, "bfloat16": 0.0}
    case_paths = dict.fromkeys(fa.PATHS, 0)

    def k1_case(q, k, v, what, **kw):
        """K1 against its plain version on one case; the call must take
        (and count) the path ``select_path`` names for its shape."""
        name = str(q.dtype).split(".")[1]
        path = fa.select_path(q.dtype, q.shape[1] // k.shape[1] * q.shape[2])
        before = dict(fa.flash_attention.path_launches)
        out = ops.flash_attention(q, k, v, **kw)
        moved = {p: n - before[p]
                 for p, n in fa.flash_attention.path_launches.items()}
        if moved != {p: int(p == path) for p in moved}:
            fail(f"{what}: path launches {moved}, not one on {path}")
        case_paths[path] += 1
        err = check_close(out, attention_reference(q, k, v, **kw), name,
                          what)
        errs[name] = max(errs[name], err)
        return out, err

    for B, H_, Hkv_, Sq, Sk, D_, causal, window, dt in \
            attn_cases + prefill_cases:
        q, k, v = rand((B, H_, Sq, D_), dt), rand((B, Hkv_, Sk, D_), dt), \
            rand((B, Hkv_, Sk, D_), dt)
        k1_case(q, k, v, f"attn case {(B, H_, Hkv_, Sq, Sk, D_, causal, window, dt)}",
                causal=causal, window=window)
    for B, H_, Hkv_, Sk, D_ in decode_cases:
        q, k, v = rand((B, H_, 1, D_)), rand((B, Hkv_, Sk, D_)), \
            rand((B, Hkv_, Sk, D_))
        k1_case(q, k, v, f"decode case {(B, H_, Hkv_, Sk, D_)}", causal=False)
    qf, kf, vf = rand((2, 4, 256, 64)), rand((2, 4, 256, 64)), rand((2, 4, 256, 64))
    full = ops.flash_attention(qf, kf, vf, causal=True)
    for pos in (64, 128, 192):
        step = ops.flash_attention(qf[:, :, pos - 1:pos], kf[:, :, :pos],
                                   vf[:, :, :pos], causal=False)
        errs["float32"] = max(errs["float32"], check_close(
            step[:, :, 0], full[:, :, pos - 1], "float32",
            f"cache growth at {pos}"))
    # the slice's shapes: fp32 and bf16 decode at a kv_len inside the last
    # key split, as a host int and as a device int32; then, in bf16, decode
    # over valid lengths 1..512 in the (B, S, Hkv, D) cache layout, and
    # causal prefill Sq = Sk = 256
    chunk = -(-max(1, -(-CACHE // fa.TILE_K)) // nsplit) * fa.TILE_K
    n_last = min(CACHE, (nsplit - 1) * chunk + chunk // 2 + 3)
    for dt in (f32, bf16):
        qs, ks, vs = rand((BATCH, 1, H, D), dt), rand((BATCH, CACHE, Hkv, D), dt), \
            rand((BATCH, CACHE, Hkv, D), dt)
        for kvl in (n_last, torch.tensor(n_last, dtype=torch.int32,
                                         device=dev)):
            k1_case(qs.transpose(1, 2), ks.transpose(1, 2), vs.transpose(1, 2),
                    f"decode in the last split, kv_len {n_last} {dt}",
                    causal=False, kv_len=kvl)
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
    phase("K1", cases=sum(case_paths.values()) + 3,
          paths=json.dumps(case_paths, separators=(",", ":")),
          last_split_kv_len=n_last,
          max_err_f32=f"{errs['float32']:.3e}",
          max_err_bf16=f"{errs['bfloat16']:.3e}",
          slice_decode_err=f"{err_decode:.3e}",
          slice_prefill_err=f"{err_prefill:.3e}",
          tol=json.dumps(TOL, separators=(",", ":")))
    mark("K1")

    # -- 3b. K1's backward against its plain version ----------------------
    bwd_err = {"float32": 0.0, "bfloat16": 0.0}
    lse_err = 0.0
    bwd_paths = dict.fromkeys(fa.BWD_PATHS, 0)
    bwd_path_of = {f32: "fma", bf16: "wgmma"}    # what each dtype must take

    def k1_bwd_case(B, H_, Hkv_, Sq, Sk, D_, causal, window, dt, what):
        """K1 forward with its lse, then the backward kernel (which must
        take and count its dtype's path), each against its plain version;
        returns the inputs, the forward and the gradients."""
        nonlocal lse_err
        name = str(dt).split(".")[1]
        q, k, v = rand((B, H_, Sq, D_), dt), rand((B, Hkv_, Sk, D_), dt), \
            rand((B, Hkv_, Sk, D_), dt)
        do = rand((B, H_, Sq, D_), dt)
        kw = dict(causal=causal, window=window)
        out, lse = fa.flash_attention_lse(q, k, v, **kw)
        lse_err = max(lse_err, check_close(
            lse, attention_lse_reference(q, k, **kw), "float32",
            f"{what} lse", BWD_TOL["float32"]))
        before = dict(fa.flash_attention_bwd.path_launches)
        got = ops.flash_attention_bwd(q, k, v, out, do, lse, **kw)
        moved = {p: n - before[p]
                 for p, n in fa.flash_attention_bwd.path_launches.items()}
        if moved != {p: int(p == bwd_path_of[dt]) for p in moved}:
            fail(f"{what}: backward path launches {moved}, not one on "
                 f"{bwd_path_of[dt]}")
        bwd_paths[bwd_path_of[dt]] += 1
        exp = attention_backward_reference(q, k, v, out, do, lse, **kw)
        for n_, a, b in zip(("dq", "dk", "dv"), got, exp):
            bwd_err[name] = max(bwd_err[name], check_close(
                a, b, name, f"{what} {n_}", BWD_TOL[name]))
        return (q, k, v, out, do, lse), got

    bwd_cases = [c + (dt,) for dt in (f32, bf16) for d in fa.HEAD_DIMS
                 for c in ((2, 8, 2, 256, 256, d, True, 0),
                           (1, 8, 2, 200, 200, d, True, 64),
                           (1, 4, 4, 130, 130, d, False, 0))]
    for case in bwd_cases:
        k1_bwd_case(*case, what=f"bwd case {case}")
    small_err = dict(bwd_err)
    tB, tH, tHkv, tS, tD = BWD_TRAIN
    bwd_err["bfloat16"] = 0.0
    targs_1, tgot = k1_bwd_case(tB, tH, tHkv, tS, tS, tD, True, 0, bf16,
                                f"bwd train shape {BWD_TRAIN}")
    err_bwd_train = bwd_err["bfloat16"]
    again = ops.flash_attention_bwd(*targs_1, causal=True)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(tgot, again)):
        fail("K1 backward: two runs on the same inputs differ")
    # K1's forward at the training shape (the same B=1 inputs), mma path
    err_fwd_train = check_close(
        targs_1[3], attention_reference(*targs_1[:3], causal=True),
        "bfloat16", f"K1 forward at the train shape {BWD_TRAIN}")
    phase("K1:bwd", cases=len(bwd_cases) + 1,
          paths=json.dumps(bwd_paths, separators=(",", ":")),
          max_err_f32=f"{small_err['float32']:.3e}",
          max_err_bf16=f"{max(small_err['bfloat16'], err_bwd_train):.3e}",
          train_shape=str(BWD_TRAIN).replace(" ", ""),
          train_shape_err=f"{err_bwd_train:.3e}", bitwise_repeatable=True,
          fwd_train_shape_err=f"{err_fwd_train:.3e}",
          lse_max_err=f"{lse_err:.3e}",
          tol=json.dumps(BWD_TOL, separators=(",", ":")))
    del targs_1, tgot, again
    torch.cuda.empty_cache()
    mark("K1_bwd")

    # -- 4. K2 against its plain version ----------------------------------
    ops.reset_counts()
    for nblocks, block, width, nout in [(16, 8, 32, 10), (8, 16, 16, 8),
                                        (32, 8, 128, 32)]:
        src = rand((nblocks, block, width))
        idx = rng.permutation(nblocks)[:nout]
        if not torch.equal(ops.repack(src, idx),
                           repack_reference(src, torch.from_numpy(idx).to(dev))):
            fail(f"repack {(nblocks, block, width, nout)} differs")
    if bc.repack.path_launches != {"bytes": 0, "bulk": 3}:
        fail(f"K2's aligned cases took paths {bc.repack.path_launches}, "
             "not bulk")
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
    repack_paths = dict(bc.repack.path_launches)
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
    if repack_launches != 2 or repack_paths != {"bytes": 0, "bulk": 2}:
        fail(f"block-cyclic path launched K2 {repack_launches} times on "
             f"paths {repack_paths}, not 2 on bulk")
    phase("K2", table=tuple(vp_rows), table_mb=f"{table.nbytes / 1e6:.1f}",
          block=blk, exact=True, launches=repack_launches,
          path_launches=json.dumps(repack_paths, separators=(",", ":")),
          bytes_moved=f"{st8.bytes_moved},{st2.bytes_moved}",
          seconds=f"{st8.seconds:.4f},{st2.seconds:.4f}")
    del parts4, parts8, parts2
    mark("K2")

    # -- 5. K3 against its plain versions ---------------------------------
    def ssd_inputs(B, H, S, P, N, decay, dt):
        """xdt (B,S,H,P), a (B,S,H) f32, bm, cm (B,S,N) as in the kernel
        tests; decay 0.02 keeps the state alive across chunks; "model"
        draws a = dt * A as mamba2's random init does (dt = softplus of a
        normal of std 0.64, A in [-16, -1]), whose in-chunk cumsums reach
        ~-3e3."""
        def scaled(shape, dtype):
            x = rng.standard_normal(shape).astype(np.float32) * 0.3
            return torch.from_numpy(x).to(dev, dtype)
        if decay == "model":
            dt_ = np.log1p(np.exp(0.64 * rng.standard_normal((B, S, H))))
            a = -dt_ * rng.uniform(1.0, 16.0, H)
        else:
            a = -np.abs(rng.standard_normal((B, S, H))) * decay
        return (scaled((B, S, H, P), dt),
                torch.from_numpy(a.astype(np.float32)).to(dev),
                scaled((B, S, N), dt), scaled((B, S, N), dt))

    ssd_err = {"float32": [0.0, 0.0], "bfloat16": [0.0, 0.0]}
    ssd_paths = dict.fromkeys(ss.PATHS, 0)

    def k3_call(xdt, a, bm, cm, chunk, what):
        """K3 on one case; the call must take (and count) the path
        ``select_path`` names for its dtype and shape."""
        path = ss.select_path(xdt.dtype, xdt.shape[-1], bm.shape[-1], chunk)
        before = dict(ss.ssd_scan.path_launches)
        out = ops.ssd_scan(xdt, a, bm, cm, chunk=chunk)
        moved = {p: n - before[p] for p, n in ss.ssd_scan.path_launches.items()}
        if moved != {p: int(p == path) for p in moved}:
            fail(f"{what}: K3 path launches {moved}, not one on {path}")
        ssd_paths[path] += 1
        return out, path

    for case in SSD_CASES:              # (H, B, ... stay granite's)
        *shape, cQ, name = case
        sargs = ssd_inputs(*shape, 0.4, getattr(torch, name))
        what = f"ssd case {case}"
        out, _ = k3_call(*sargs, cQ, what)
        ssd_err[name][0] = max(ssd_err[name][0], check_close(
            out, ssd_reference(*sargs), name, what, SSD_TOL[name]))
        ssd_err[name][1] = max(ssd_err[name][1], check_close(
            out, ssd_chunked_reference(*sargs, cQ), name,
            what + " (chunked)", SSD_CHUNKED_TOL[name]))
    sB, sH, sS, sP, sN, sQ = SSD_SLICE
    slice_err = {}
    for name, decay in (("float32", "model"), ("float32", 0.02),
                        ("bfloat16", 0.02)):    # the bf16 inputs are timed
        ssd_args = ssd_inputs(sB, sH, sS, sP, sN, decay, getattr(torch, name))
        out, path = k3_call(*ssd_args, sQ, f"ssd slice {name} decay {decay}")
        if name == "bfloat16" and path != "wgmma":
            fail(f"the slice's bf16 shape took K3's {path} path, not wgmma")
        slice_err[name if decay != "model" else "model_f32"] = (
            check_close(out, ssd_reference(*ssd_args), name,
                        f"ssd slice {name} decay {decay}", SSD_TOL[name]),
            check_close(out, ssd_chunked_reference(*ssd_args, sQ), name,
                        f"ssd slice {name} decay {decay} (chunked)",
                        SSD_CHUNKED_TOL[name]))
    torch.cuda.synchronize()
    del out
    phase("K3", cases=len(SSD_CASES) + 3,
          paths=json.dumps(ssd_paths, separators=(",", ":")),
          max_err_f32=f"{ssd_err['float32'][0]:.3e}",
          max_err_bf16=f"{ssd_err['bfloat16'][0]:.3e}",
          max_err_vs_chunked=f"{ssd_err['float32'][1]:.3e},"
                             f"{ssd_err['bfloat16'][1]:.3e}",
          slice=str(SSD_SLICE).replace(" ", ""),
          slice_err_f32=f"{slice_err['float32'][0]:.3e}",
          slice_err_bf16=f"{slice_err['bfloat16'][0]:.3e}",
          slice_err_vs_chunked=f"{slice_err['float32'][1]:.3e},"
                               f"{slice_err['bfloat16'][1]:.3e}",
          model_decay_err_f32=f"{slice_err['model_f32'][0]:.3e}",
          model_decay_err_vs_chunked=f"{slice_err['model_f32'][1]:.3e}",
          tol=json.dumps(SSD_TOL, separators=(",", ":")),
          tol_vs_chunked=json.dumps(SSD_CHUNKED_TOL, separators=(",", ":")))
    mark("K3")

    # -- 5b. K3's backward against its plain version ----------------------
    def rel_err(got, exp) -> float:
        if got.shape != exp.shape or got.dtype != exp.dtype or \
                not bool(torch.isfinite(got).all()):
            fail(f"K3 backward: {tuple(got.shape)} {got.dtype} (finite: "
                 f"{bool(torch.isfinite(got).all())}) for "
                 f"{tuple(exp.shape)} {exp.dtype}")
        return ((got.float() - exp.float()).abs().max() /
                exp.float().abs().max()).item()

    def ssd_bwd_inputs(B, H, S, P, N, decay, dt):
        return (*ssd_inputs(B, H, S, P, N, decay, dt),
                rand((B, S, H, P), dt))

    ssd_bwd_err = {"float32": [0.0] * 4, "bfloat16": [0.0] * 4}

    bwd_case_paths = dict.fromkeys(ss.BWD_PATHS, 0)

    def k3_bwd_case(args, chunk, what):
        """K3's backward (one launch counted, on the path its dtype and
        shapes select) against its plain version; returns the gradients
        and their errors (dx, da, dB, dC)."""
        name = str(args[0].dtype).split(".")[1]
        path = ss.select_bwd_path(args[0].dtype, args[0].shape[-1],
                                  args[2].shape[-1], chunk)
        before = dict(ss.ssd_scan_bwd.path_launches)
        got = ops.ssd_scan_bwd(*args, chunk=chunk)
        moved = {p: n_ - before[p]
                 for p, n_ in ss.ssd_scan_bwd.path_launches.items()}
        if moved != {p: int(p == path) for p in moved}:
            fail(f"{what}: K3 backward path launches {moved}, not one on "
                 f"{path}")
        bwd_case_paths[path] += 1
        exp = ssd_chunked_backward_reference(*args, chunk)
        errs_ = []
        for i, (g_, e_, o_) in enumerate(zip(got, exp, "xaBC")):
            err = rel_err(g_, e_)
            tol = SSD_BWD_TOL["float32" if o_ == "a" else name]
            if err > tol:
                fail(f"{what}: d{o_} off its plain version by {err:.3e} of "
                     f"its largest entry > {tol}")
            ssd_bwd_err[name][i] = max(ssd_bwd_err[name][i], err)
            errs_.append(err)
        del exp
        return got, errs_

    sm = get_config(f"{MAMBA}-smoke")
    bwd_table = [(2, sm.ssm_num_heads, 64, sm.ssm.head_dim,
                  sm.ssm.state_size, sm.ssm.chunk_size, 0.4, dt)
                 for dt in ("float32", "bfloat16")]          # the smoke scan
    bwd_table += [(*c[:6], 0.4, c[6]) for c in SSD_CASES]
    bwd_table += [(2, 3, 300, 32, 64, 100, 0.02, "bfloat16"),  # ragged tile
                  (1, 5, 576, 48, 96, 192, "model", "bfloat16"),  # 3 tiles
                  (16, 32, 1024, 64, 128, 256, "model", "float32")]
    for case in bwd_table:
        B, H_, S_, P_, N_, Q_, decay, name = case
        k3_bwd_case(ssd_bwd_inputs(B, H_, S_, P_, N_, decay,
                                   getattr(torch, name)), Q_,
                    f"ssd bwd case {case}")
    small_bwd_err = {k: list(v) for k, v in ssd_bwd_err.items()}
    bB, bH, bS, bP, bN, bQ = SSD_BWD_TRAIN
    train_bwd_err, train_fwd_err = {}, {}
    for name, decay in (("bfloat16", "model"), ("float32", "model"),
                        ("bfloat16", 0.02)):
        targs = ssd_bwd_inputs(bB, bH, bS, bP, bN, decay,
                               getattr(torch, name))
        if decay == "model":
            # K3's forward as the training path launches it: the state
            # carried across the 16 chunks of a 4096 sequence
            what = f"ssd fwd train shape {SSD_BWD_TRAIN} {name} decay model"
            out, path = k3_call(*targs[:4], bQ, what)
            if name == "bfloat16" and path != "wgmma":
                fail(f"{what}: took K3's {path} path, not wgmma")
            train_fwd_err[name] = check_close(
                out, ssd_chunked_reference(*targs[:4], bQ), name, what,
                SSD_CHUNKED_TOL[name])
            del out
        tgot, train_bwd_err[f"{name},{decay}"] = k3_bwd_case(
            targs, bQ, f"ssd bwd train shape {SSD_BWD_TRAIN} {name} "
            f"decay {decay}")
        want = "wgmma" if name == "bfloat16" else "fma"
        if ss.select_bwd_path(targs[0].dtype, bP, bN, bQ) != want:
            fail(f"K3 backward at the training shape in {name} does not "
                 f"take its {want} path")
        if (name, decay) == ("bfloat16", "model"):
            ssd_bwd_args = targs                  # timed in phase 14
            again = ops.ssd_scan_bwd(*targs, chunk=bQ)
            torch.cuda.synchronize()
            if not all(torch.equal(a_, b_) for a_, b_ in zip(tgot, again)):
                fail("K3 backward: two runs on the same inputs differ")
            del again
        del tgot, targs
    # strided: (B, H, S, P) views of xdt, a and dy, B and C cut from a
    # wider projection: the contiguous inputs' gradients bit for bit
    sargs = ssd_bwd_inputs(2, 4, 512, 64, 128, 0.02, bf16)
    tview = lambda t: t.transpose(1, 2).contiguous().transpose(1, 2)
    wide = torch.cat([sargs[2], sargs[3], sargs[2]], dim=-1)
    views = (tview(sargs[0]), tview(sargs[1]), wide[..., :128],
             wide[..., 128:256], tview(sargs[4]))
    if views[0].is_contiguous() or views[2].is_contiguous():
        fail("the strided K3 backward case's inputs are contiguous")
    if not all(torch.equal(a_, b_) for a_, b_ in zip(
            ops.ssd_scan_bwd(*views, chunk=256),
            ops.ssd_scan_bwd(*sargs, chunk=256))):
        fail("K3 backward on strided inputs differs from contiguous ones")
    del sargs, views, wide
    torch.cuda.synchronize()
    fmt = lambda v: ",".join(f"{x:.3e}" for x in v)
    phase("K3:bwd", cases=len(bwd_table) + 3,
          case_paths=json.dumps(bwd_case_paths, separators=(",", ":")),
          path_launches=json.dumps(ss.ssd_scan_bwd.path_launches,
                                   separators=(",", ":")),
          max_err_f32=fmt(small_bwd_err["float32"]),
          max_err_bf16=fmt(small_bwd_err["bfloat16"]),
          train_shape=str(SSD_BWD_TRAIN).replace(" ", ""),
          train_shape_err=json.dumps({k: fmt(v) for k, v in
                                      train_bwd_err.items()},
                                     separators=(",", ":")),
          train_shape_fwd_err=f"{train_fwd_err['float32']:.3e},"
                              f"{train_fwd_err['bfloat16']:.3e}",
          fwd_tol=json.dumps(SSD_CHUNKED_TOL, separators=(",", ":")),
          strided_bitwise_equal=True, bitwise_repeatable=True,
          err_order="dx,da,dB,dC",
          tol=json.dumps(SSD_BWD_TOL, separators=(",", ":")))
    torch.cuda.empty_cache()
    mark("K3_bwd")

    # -- device times for the kernels line (phase 14), taken here: late in
    # the process, after the long traced windows of phases 8 and 10, the
    # profiler drops device records --------------------------------------
    n = PROMPT + DECODE                       # K1 decode: the path's last step
    kv_len = torch.tensor(n, dtype=torch.int32, device=dev)
    args = (qd.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2))
    lib_args = (args[0], args[1][:, :, :n], args[2][:, :, :n])
    k1_dec = lambda: ops.flash_attention(*args, causal=False, kv_len=kv_len)
    sdpa_dec = lambda: F.scaled_dot_product_attention(*lib_args,
                                                      enable_gqa=True)
    k1_pre = lambda: ops.flash_attention(*pargs, causal=True)
    sdpa_pre = lambda: F.scaled_dot_product_attention(*pargs, is_causal=True,
                                                      enable_gqa=True)
    # K2: the 4 -> 8 step of the block-cyclic path, one gather of the table
    from repro_torch.core.redistribute import blockcyclic_index
    counts4 = [(nblk + 3 - r) // 4 for r in range(4)]
    idx = np.concatenate(blockcyclic_index(counts4, 8))
    src = table.reshape(nblk, blk, vp_rows[1])
    idx_dev = torch.from_numpy(idx).to(dev)
    k3 = lambda: ops.ssd_scan(*ssd_args, chunk=SSD_SLICE[5])
    # K3's backward at the SSM training path's shape (bf16, mamba2's
    # decays): ~0.3 GB of inputs a call, past L2 already; the L2-cold
    # window still rotates two copies
    k3_bwd = lambda: ops.ssd_scan_bwd(*ssd_bwd_args, chunk=bQ)
    # the same inputs in fp32, for the fma path's row (made anew in phase
    # 14, so that they are not held through the training phases)
    ssd_bwd_f32_args = tuple(t.float() for t in ssd_bwd_args)
    k3_bwd_f32 = lambda: ops.ssd_scan_bwd(*ssd_bwd_f32_args, chunk=bQ)
    k3_tfwd = lambda: ops.ssd_scan(*ssd_bwd_args[:4], chunk=bQ)
    k3_bwd_sets = [ssd_bwd_args, tuple(t.clone() for t in ssd_bwd_args)]
    # L2-cold K1 and SDPA: each call on its own copy of the inputs, the
    # copies rotating through 8 x 12.6 MB (decode reads 384 of 512 cached
    # keys) and 4 x 42 MB (prefill, output included), so each call's
    # inputs were last touched more than the 50 MB of L2 ago
    cold_dec = [tuple(t.clone() for t in (qd, kc, vc)) for _ in range(8)]
    cold_dec = [(q_.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2))
                for q_, k_, v_ in cold_dec]
    cold_pre = [tuple(t.clone() for t in (qp, kp, vp)) for _ in range(4)]
    cold_pre = [(q_.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2))
                for q_, k_, v_ in cold_pre]

    def cold(fn, copies):
        return [lambda a=a: fn(*a) for a in copies]

    # K1's backward at the training path's shape (B=8, S=4096, bf16, in
    # the model's (B, S, heads, D) layout): ~0.6 GB of inputs a call, far
    # past L2 already; the L2-cold window still rotates two copies.  SDPA's
    # backward (the library row) on the same inputs, from its own forward.
    def train_attn_inputs():
        q_, do_ = (rand((TRAIN_BATCH, tS, tH, tD), bf16).transpose(1, 2)
                   for _ in range(2))
        k_, v_ = (rand((TRAIN_BATCH, tS, tHkv, tD), bf16).transpose(1, 2)
                  for _ in range(2))
        o_, lse_ = fa.flash_attention_lse(q_, k_, v_, causal=True)
        return q_, k_, v_, o_, do_, lse_

    bwd_sets = [train_attn_inputs() for _ in range(2)]
    k1_bwd = lambda: ops.flash_attention_bwd(*bwd_sets[0], causal=True)
    # K1's forward as training calls it (with its lse), and SDPA's forward
    k1_tfwd = lambda: fa.flash_attention_lse(*bwd_sets[0][:3], causal=True)
    sdpa_tfwd = lambda: F.scaled_dot_product_attention(
        *bwd_sets[0][:3], is_causal=True, enable_gqa=True)
    sq_, sk_, sv_ = (t.detach().requires_grad_() for t in bwd_sets[0][:3])
    s_out = F.scaled_dot_product_attention(sq_, sk_, sv_, is_causal=True,
                                           enable_gqa=True)
    sdpa_bwd = lambda: torch.autograd.grad(s_out, (sq_, sk_, sv_),
                                           bwd_sets[0][4], retain_graph=True)
    dev_ms = {"K1 decode": device_ms(k1_dec, "K1 decode"),
              "SDPA decode": device_ms(sdpa_dec, "SDPA decode"),
              "K1 prefill": device_ms(k1_pre, "K1 prefill"),
              "SDPA prefill": device_ms(sdpa_pre, "SDPA prefill"),
              "K1 decode cold": device_ms(cold(
                  lambda q_, k_, v_: ops.flash_attention(
                      q_, k_, v_, causal=False, kv_len=kv_len), cold_dec),
                  "K1 decode, L2-cold", iters=24),
              "SDPA decode cold": device_ms(cold(
                  lambda q_, k_, v_: F.scaled_dot_product_attention(
                      q_, k_[:, :, :n], v_[:, :, :n], enable_gqa=True),
                  cold_dec), "SDPA decode, L2-cold", iters=24),
              "K1 prefill cold": device_ms(cold(
                  lambda q_, k_, v_: ops.flash_attention(
                      q_, k_, v_, causal=True), cold_pre),
                  "K1 prefill, L2-cold"),
              "SDPA prefill cold": device_ms(cold(
                  lambda q_, k_, v_: F.scaled_dot_product_attention(
                      q_, k_, v_, is_causal=True, enable_gqa=True),
                  cold_pre), "SDPA prefill, L2-cold"),
              "K2": device_ms(lambda: ops.repack(src, idx), "K2"),
              "index_select": device_ms(
                  lambda: torch.index_select(src, 0, idx_dev),
                  "index_select"),
              "K3": device_ms(k3, "K3", iters=5),
              "K3 train fwd": device_ms(k3_tfwd, "K3 forward, train shape",
                                        iters=8),
              "K3 bwd": device_ms(k3_bwd, "K3 backward", iters=4),
              "K3 bwd fp32": device_ms(k3_bwd_f32, "K3 backward, fp32",
                                       iters=4),
              "K3 bwd cold": device_ms(cold(
                  lambda *a_: ops.ssd_scan_bwd(*a_, chunk=bQ), k3_bwd_sets),
                  "K3 backward, L2-cold", iters=4),
              "K1 bwd": device_ms(k1_bwd, "K1 backward", iters=4),
              "K1 bwd cold": device_ms(cold(
                  lambda *a: ops.flash_attention_bwd(*a, causal=True),
                  bwd_sets), "K1 backward, L2-cold", iters=4),
              "SDPA bwd": device_ms(sdpa_bwd, "SDPA backward", iters=4),
              "K1 train fwd": device_ms(k1_tfwd, "K1 forward, train shape",
                                        iters=8),
              "SDPA train fwd": device_ms(sdpa_tfwd,
                                          "SDPA forward, train shape",
                                          iters=8)}
    del cold_dec, cold_pre, k3_bwd_sets, ssd_bwd_f32_args
    mark("device_ms")

    # -- 6. the granite serving path ----------------------------------------
    runs = {}
    flash_path = []
    for label, schedule in (("static", None), ("elastic", SCHEDULE)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        ops.reset_counts()
        out = decode_demo(cfg, batch=BATCH, prompt_len=PROMPT,
                          decode_steps=DECODE, cache_len=CACHE,
                          workers=WORKERS, device=dev, schedule=schedule,
                          seed=0)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        paths = dict(fa.flash_attention.path_launches)
        flash_path.append(counts["flash_attention"])
        want = cfg.num_layers * (PROMPT + DECODE)
        if counts["flash_attention"] != want:
            fail(f"{label} run launched K1 {counts['flash_attention']} "
                 f"times, not {want}")
        if paths != {"fma": 0, "mma": 0, "split_decode": want}:
            fail(f"{label} run's K1 paths {paths}: every decode step should "
                 "take split_decode")
        toks = out["tokens"]
        if toks.shape != (BATCH, DECODE) or toks.min() < 0 or \
                toks.max() >= cfg.vocab_size:
            fail(f"{label} run: tokens of shape {toks.shape} in "
                 f"[{toks.min()}, {toks.max()}]")
        runs[label] = out
        phase(f"path:{label}", prefill_s=f"{out['prefill_s']:.3f}",
              decode_ms_per_token=f"{out['decode_s'] / DECODE * 1e3:.3f}",
              flash_launches=counts["flash_attention"],
              path_launches=json.dumps(paths, separators=(",", ":")),
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
    mark("granite_path")

    # -- 7. granite prefill vs decode ---------------------------------------
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
        prefill_paths = dict(fa.flash_attention.path_launches)
        if flash_prefill != cfg.num_layers or \
                prefill_paths["mma"] != cfg.num_layers:
            fail(f"prefill launched K1 {flash_prefill} times on paths "
                 f"{prefill_paths}, not {cfg.num_layers} on mma")
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
          path_launches=json.dumps(prefill_paths, separators=(",", ":")),
          fp32_prefill_vs_decode=f"{gap32:.4e}", fp32_tol=FP32_LOGITS_ATOL,
          bf16_prefill_vs_fp32=f"{err_p:.4e}",
          bf16_decode_vs_fp32=f"{err_d:.4e}",
          bf16_prefill_vs_decode=f"{(lp - ld).abs().max().item():.4e}",
          bf16_tol=BF16_LOGITS_ATOL, logits_std=f"{lp32.std().item():.3f}",
          first_token_agreement=f"{agree:.3f}")
    mark("granite_prefill")

    # -- 8. where a granite decode step's time goes -------------------------
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

    steps(PROFILE_WARMUP)
    t0 = time.perf_counter()
    steps(PROFILE_STEPS)
    wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps(PROFILE_STEPS)
        traced_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    events = prof.key_averages()
    dev_events = device_events(prof)
    busy_ms = sum(device_us(e) for e in dev_events) / 1e3 / PROFILE_STEPS
    if busy_ms <= 0:
        fail("the profiler saw no device time in the traced decode steps")
    top = [{"kernel": e.key[:80],
            "ms_per_step": device_us(e) / 1e3 / PROFILE_STEPS,
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
    mark("granite_profile")

    # -- 9. the mamba2 serving path -----------------------------------------
    mcfg = get_config(MAMBA)
    mruns = {}
    for label, schedule in (("static", None), ("elastic", SCHEDULE)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        ops.reset_counts()
        out = decode_demo(MAMBA, batch=BATCH, prompt_len=PROMPT,
                          decode_steps=DECODE, cache_len=CACHE,
                          workers=WORKERS, device=dev, schedule=schedule,
                          seed=0)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        if counts["flash_attention"] or counts["ssd_scan"]:
            fail(f"mamba2 {label} decode launched {counts}: the SSM decode "
                 "step is the recurrence, with neither K1 nor K3")
        toks = out["tokens"]
        if toks.shape != (BATCH, DECODE) or toks.min() < 0 or \
                toks.max() >= mcfg.vocab_size:
            fail(f"mamba2 {label} run: tokens of shape {toks.shape} in "
                 f"[{toks.min()}, {toks.max()}]")
        mruns[label] = out
        phase(f"mamba2:{label}", prefill_s=f"{out['prefill_s']:.3f}",
              decode_ms_per_token=f"{out['decode_s'] / DECODE * 1e3:.3f}",
              launches=json.dumps(counts, separators=(",", ":")),
              peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
              sizes=json.dumps(out["sizes"], separators=(",", ":")))
        for ev in out["events"]:
            phase(f"mamba2:{label}:resize", step=ev.step, action=ev.action,
                  sizes=f"{ev.from_procs}->{ev.to_procs}",
                  bytes_moved=ev.transfer.bytes_moved,
                  seconds=f"{ev.transfer.seconds:.4f}")
        del out
    if not np.array_equal(mruns["static"]["tokens"],
                          mruns["elastic"]["tokens"]):
        fail("mamba2: tokens differ between the static and the elastic run")
    m_actions = [e.action for e in mruns["elastic"]["events"]]
    if m_actions != ["expand", "shrink"]:
        fail(f"mamba2 resize actions {m_actions}")
    phase("mamba2", tokens_equal=True, actions=",".join(m_actions))
    mark("mamba2_path")

    # -- 10. mamba2 prefill vs decode, and where the prefill's time goes ----
    torch.cuda.empty_cache()
    mparams = M.init_params(mcfg, torch.Generator(dev).manual_seed(0), dev)
    mprompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, mcfg.vocab_size, (BATCH, M_PREFILL_S), dtype=np.int32)).to(dev)
    mbatch = {"tokens": mprompts}
    mcfg32 = dataclasses.replace(mcfg, dtype="float32")
    MV = mcfg.vocab_size

    def m_decode_logits(c, full=None):
        """Last logits of the token-by-token decode over the prompt, and
        the largest gap to ``full`` (B, S, V) logits over every position."""
        cache = M.init_cache(c, BATCH, M_PREFILL_S, device=dev)
        gap = torch.zeros((), device=dev)
        for i in range(M_PREFILL_S):
            logits, cache = M.decode_step(
                mparams, c, mprompts[:, i:i + 1], cache,
                torch.tensor(i, dtype=torch.int32, device=dev))
            if full is not None:
                gap = torch.maximum(gap, (logits[:, -1, :MV].float() -
                                          full[:, i]).abs().max())
        return logits[:, -1, :MV].float(), gap.item()

    with torch.no_grad():
        torch.cuda.synchronize()
        ops.reset_counts()
        t0 = time.perf_counter()
        m_first = make_prefill_step(mcfg)(mparams, mbatch)
        torch.cuda.synchronize()
        m_prefill_s = time.perf_counter() - t0
        m_counts = ops.launch_counts()
        k3_prefill = m_counts["ssd_scan"]
        k3_prefill_paths = dict(ss.ssd_scan.path_launches)
        if k3_prefill != mcfg.num_layers or m_counts["flash_attention"] or \
                k3_prefill_paths != {"fma": 0, "wgmma": mcfg.num_layers}:
            fail(f"mamba2 prefill launched {m_counts} (K3 paths "
                 f"{k3_prefill_paths}), not K3 {mcfg.num_layers} times on "
                 "wgmma")
        mlp = prefill_logits(mparams, mcfg, mbatch)[:, :MV].float()
        full32 = M.forward(mparams, mcfg32, mbatch)[0][..., :MV]
        mlp32 = prefill_logits(mparams, mcfg32, mbatch)[:, :MV].float()
        rounded = T.tree_map(lambda t: t.bfloat16().float(), mparams)
        mlp32w = prefill_logits(rounded, mcfg32, mbatch)[:, :MV].float()
        del rounded
        mld32, m_gap_all = m_decode_logits(mcfg32, full32)
        del full32
        mld, _ = m_decode_logits(mcfg)
    if not all(bool(torch.isfinite(t).all()) for t in (mlp, mld, mlp32,
                                                        mld32)):
        fail("mamba2 logits are not finite")
    m_gap32 = (mlp32 - mld32).abs().max().item()

    def gap(a, b):
        d = (a - b).abs()
        return d.max().item(), d.square().mean().sqrt().item()

    m_err_p, m_rms_p = gap(mlp, mlp32)
    m_err_d, m_rms_d = gap(mld, mld32)
    m_err_w, m_rms_w = gap(mlp32w, mlp32)
    m_agree = (m_first == mld.argmax(-1)).float().mean().item()
    phase("mamba2:prefill", batch=BATCH, seq=M_PREFILL_S,
          chunks=M_PREFILL_S // mcfg.ssm.chunk_size, k3_launches=k3_prefill,
          k3_path_launches=json.dumps(k3_prefill_paths, separators=(",", ":")),
          prefill_s=f"{m_prefill_s:.3f}",
          fp32_prefill_vs_decode=f"{m_gap32:.4e}",
          fp32_all_positions=f"{m_gap_all:.4e}", fp32_tol=M_FP32_LOGITS_ATOL,
          bf16_prefill_vs_fp32=f"{m_err_p:.4e}",
          bf16_decode_vs_fp32=f"{m_err_d:.4e}",
          bf16_rms=f"{m_rms_p:.4e},{m_rms_d:.4e}",
          fp32_bf16_weights=f"{m_err_w:.4e}",
          fp32_bf16_weights_rms=f"{m_rms_w:.4e}",
          bf16_tol=f"{M_BF16_LOGITS_MAX},{M_BF16_LOGITS_RMS}",
          logits_std=f"{mlp32.std().item():.3f}",
          bf16_prefill_vs_decode_argmax_agreement=f"{m_agree:.3f}")
    if max(m_gap32, m_gap_all) > M_FP32_LOGITS_ATOL:
        fail(f"mamba2 fp32 prefill vs decode logits differ by "
             f"{max(m_gap32, m_gap_all):.3e} > {M_FP32_LOGITS_ATOL}")
    if max(m_err_p, m_err_d) > M_BF16_LOGITS_MAX or \
            max(m_rms_p, m_rms_d) > M_BF16_LOGITS_RMS:
        fail(f"mamba2 bf16 logits off the fp32 ones by "
             f"{max(m_err_p, m_err_d):.3e} (rms {max(m_rms_p, m_rms_d):.3e})"
             f" > {M_BF16_LOGITS_MAX} ({M_BF16_LOGITS_RMS})")
    with torch.no_grad():
        t0 = time.perf_counter()
        make_prefill_step(mcfg)(mparams, mbatch)
        torch.cuda.synchronize()
        m_wall_s = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            make_prefill_step(mcfg)(mparams, mbatch)
            torch.cuda.synchronize()
            m_traced_s = time.perf_counter() - t0
    dev_events = device_events(prof)
    m_busy_ms = sum(device_us(e) for e in dev_events) / 1e3
    k3_ms = sum(device_us(e) for e in dev_events if "ssd_scan" in e.key) / 1e3
    if m_busy_ms <= 0 or k3_ms <= 0:
        fail("the profiler saw no device time (or no K3) in the traced "
             "mamba2 prefill")
    top = [{"kernel": e.key[:80], "ms": device_us(e) / 1e3, "calls": e.count}
           for e in dev_events[:PROFILE_TOP]]
    phase("mamba2:profile", untraced_prefill_s=f"{m_wall_s:.3f}",
          traced_prefill_s=f"{m_traced_s:.3f}",
          traced_device_busy_ms=f"{m_busy_ms:.3f}",
          traced_idle_share=f"{1 - m_busy_ms / (m_traced_s * 1e3):.4f}",
          k3_ms=f"{k3_ms:.3f}", k3_share_of_device=f"{k3_ms / m_busy_ms:.4f}",
          top=json.dumps(top, separators=(",", ":")))
    del mparams, prof, mlp, mld, mlp32, mld32
    mark("mamba2_prefill")

    # -- 11. the granite training path (Listing 2) ---------------------------
    # first the smoke model's step on the card against the CPU's, fp32
    scfg = get_config(f"{ARCH}-smoke")
    sopt = AdamW(learning_rate=1e-3)
    sbatch = lm_train_app(scfg, dataclasses.replace(
        get_shape("smoke"), global_batch=8)).dataset.batch_at(0)
    smoke = {}
    for d in ("cpu", dev):
        st = T.tree_map(lambda t: t.to(d), init_state(scfg, sopt, 0))
        _, m = make_train_step(scfg, sopt)(
            st, {k_: torch.from_numpy(v_).to(d) for k_, v_ in sbatch.items()})
        smoke[str(d)] = (float(m["loss"]), float(m["grad_norm"]))
    (l_c, g_c), (l_g, g_g) = smoke["cpu"], smoke[str(dev)]
    if abs(l_g - l_c) > 1e-5 * abs(l_c) or abs(g_g - g_c) > 1e-4 * abs(g_c):
        fail(f"smoke train step: card loss {l_g} / grad norm {g_g} vs CPU "
             f"{l_c} / {g_c}")
    phase("train:smoke", loss_card=f"{l_g:.7f}", loss_cpu=f"{l_c:.7f}",
          grad_norm_card=f"{g_g:.6f}", grad_norm_cpu=f"{g_c:.6f}")

    tshape = dataclasses.replace(get_shape(TRAIN_SHAPE),
                                 global_batch=TRAIN_BATCH)
    tokens_per_step = TRAIN_BATCH * tshape.seq_len

    def train_run(c, schedule, steps):
        """``steps`` steps of ``lm_train_app`` on ``c`` (Listing 2's loop);
        kernel counts are zeroed just before the loop and read just after.
        Returns the runner, its state, losses, seconds per step, counts."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        app = lm_train_app(c, tshape, AdamW(learning_rate=1e-3), seed=0)
        runner = dmr.MalleableRunner(
            app, dmr.MalleabilityParams(*TRAIN_PARAMS),
            dmr.ScriptedRMS(schedule), devices=logical_workers(WORKERS, dev))
        state = runner.init()
        torch.cuda.synchronize()
        ops.reset_counts()
        losses, secs = [], []
        for i in range(steps):
            t0 = time.perf_counter()
            state = dmr.reconfig(runner, state, i)
            state, m = runner.step(state, i)
            losses.append(float(m["loss"]))        # waits for the step
            secs.append(time.perf_counter() - t0)
        L = c.num_layers
        fwd, bwd = 2 * L * steps, L * steps           # remat: twice
        if c.is_ssm:     # K3 forward on wgmma, its backward; no K1
            want = {"flash_attention": 0, "flash_attention_bwd": 0,
                    "ssd_scan": fwd, "ssd_scan_bwd": bwd}
            want_paths = {"ssd_scan": {"fma": 0, "wgmma": fwd},
                          "ssd_scan_bwd": {"fma": 0, "wgmma": bwd}}
        else:            # K1 forward on mma, its backward on wgmma; no K3
            want = {"flash_attention": fwd, "flash_attention_bwd": bwd,
                    "ssd_scan": 0, "ssd_scan_bwd": 0}
            want_paths = {"flash_attention": {"fma": 0, "mma": fwd,
                                              "split_decode": 0},
                          "flash_attention_bwd": {"fma": 0, "wgmma": bwd}}
        counts = dict(ops.launch_counts(), paths={
            k_: dict(ops.KERNELS[k_].path_launches) for k_ in want_paths})
        if {k_: counts[k_] for k_ in want} != want or \
                counts["paths"] != want_paths:
            fail(f"{L}-layer {c.name} training launched {counts}, not "
                 f"{want} on the paths {want_paths}")
        if not all(np.isfinite(losses)):
            fail(f"{L}-layer training losses {losses}")
        return runner, state, losses, secs, counts

    def step_s(secs):
        """Median seconds per step, the first (warm-up) step left out."""
        return float(np.median(secs[1:]))

    truns = {}
    for label, schedule in (("static", {}), ("elastic", TRAIN_SCHEDULE)):
        runner, state, losses, secs, counts = train_run(cfg, schedule,
                                                        TRAIN_STEPS)
        peak = torch.cuda.max_memory_allocated() / 1e9
        truns[label] = (runner, state, losses)
        phase(f"train:{label}", layers=cfg.num_layers,
              batch=TRAIN_BATCH, seq=tshape.seq_len,
              losses=",".join(f"{x:.6f}" for x in losses),
              step_s=",".join(f"{x:.3f}" for x in secs),
              s_per_step=f"{step_s(secs):.4f}",
              tokens_per_s=f"{tokens_per_step / step_s(secs):.0f}",
              k1_fwd_per_step=counts["flash_attention"] / TRAIN_STEPS,
              k1_bwd_per_step=counts["flash_attention_bwd"] / TRAIN_STEPS,
              peak_gb=f"{peak:.2f}",
              sizes=",".join(str(e.to_procs) for e in runner.events))
        for ev in runner.events:
            phase(f"train:{label}:resize", step=ev.step, action=ev.action,
                  sizes=f"{ev.from_procs}->{ev.to_procs}",
                  bytes_moved=ev.transfer.bytes_moved,
                  seconds=f"{ev.transfer.seconds:.4f}")
        if label == "elastic":
            del state
            truns[label] = (runner, None, losses)
    train_launches = counts["flash_attention_bwd"]
    train_fwd_launches = counts["flash_attention"]
    static_l, elastic_l = truns["static"][2], truns["elastic"][2]
    gap = max(abs(a - b) for a, b in zip(static_l, elastic_l))
    actions = [e.action for e in truns["elastic"][0].events]
    if gap > TRAIN_LOSS_TOL or actions != ["expand", "shrink"]:
        fail(f"elastic training: losses {elastic_l} vs static {static_l} "
             f"(gap {gap:.3e} > {TRAIN_LOSS_TOL}?), actions {actions}")
    phase("train", elastic_vs_static_max_gap=f"{gap:.3e}",
          tol=TRAIN_LOSS_TOL, actions=",".join(actions),
          state_gb=f"{sum(t.nbytes for t in T.leaves(truns['static'][1])) / 1e9:.2f}")
    mark("train")

    # -- 12. one traced training step of the static run ----------------------
    runner, state, _ = truns["static"]
    L = cfg.num_layers
    for attempt in range(4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, m = runner.step(state, TRAIN_STEPS + attempt)
            float(m["loss"])
            torch.cuda.synchronize()
            traced_s = time.perf_counter() - t0
        dev_events = device_events(prof)
        bwd_evs = [e for e in dev_events if "attn_bwd" in e.key]
        fwd_evs = [e for e in dev_events if "attn_" in e.key and
                   "attn_bwd" not in e.key]
        if sum(e.count for e in bwd_evs) == 3 * L and \
                sum(e.count for e in fwd_evs) == 2 * L:
            break
        print(f"chip_smoke: traced train step: the profiler kept "
              f"{sum(e.count for e in fwd_evs)} K1 forward and "
              f"{sum(e.count for e in bwd_evs)} backward records: taken "
              "again", file=sys.stderr, flush=True)
    else:
        fail("the profiler dropped K1's records in four traced train steps")
    t_busy = sum(device_us(e) for e in dev_events) / 1e3
    t_fwd = sum(device_us(e) for e in fwd_evs) / 1e3
    t_bwd = sum(device_us(e) for e in bwd_evs) / 1e3
    top = [{"kernel": e.key[:80], "ms": device_us(e) / 1e3, "calls": e.count}
           for e in dev_events[:PROFILE_TRAIN_TOP]]
    phase("train:profile", layers=L, traced_step_s=f"{traced_s:.4f}",
          device_busy_ms=f"{t_busy:.3f}",
          idle_share=f"{1 - t_busy / (traced_s * 1e3):.4f}",
          k1_fwd_ms=f"{t_fwd:.3f}", k1_fwd_share=f"{t_fwd / t_busy:.4f}",
          k1_bwd_ms=f"{t_bwd:.3f}", k1_bwd_share=f"{t_bwd / t_busy:.4f}",
          top=json.dumps(top, separators=(",", ":")))
    del runner, state, truns, prof, dev_events, bwd_evs, fwd_evs
    mark("train_profile")

    # -- 13. the training path at full depth ---------------------------------
    dcfg = get_config(ARCH)
    runner, state, losses, secs, counts = train_run(dcfg, {}, DEPTH_STEPS)
    phase("train:depth", layers=dcfg.num_layers,
          losses=",".join(f"{x:.6f}" for x in losses),
          step_s=",".join(f"{x:.3f}" for x in secs),
          s_per_step=f"{step_s(secs):.4f}",
          tokens_per_s=f"{tokens_per_step / step_s(secs):.0f}",
          k1_fwd_per_step=counts["flash_attention"] / DEPTH_STEPS,
          k1_bwd_per_step=counts["flash_attention_bwd"] / DEPTH_STEPS,
          state_gb=f"{sum(t.nbytes for t in T.leaves(state)) / 1e9:.2f}",
          peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    del runner, state
    torch.cuda.empty_cache()
    mark("train_depth")

    # -- 13b. the SSM training path: the smoke model's step, card vs CPU ----
    mscfg = get_config(f"{MAMBA}-smoke")
    msbatch = lm_train_app(mscfg, dataclasses.replace(
        get_shape("smoke"), global_batch=8)).dataset.batch_at(0)
    msmoke = {}
    for d in ("cpu", dev):
        st = T.tree_map(lambda t: t.to(d), init_state(mscfg, sopt, 0))
        ops.reset_counts()
        _, m = make_train_step(mscfg, sopt)(
            st, {k_: torch.from_numpy(v_).to(d) for k_, v_ in msbatch.items()})
        msmoke[str(d)] = (float(m["loss"]), float(m["grad_norm"]),
                          ops.launch_counts(),
                          dict(ss.ssd_scan_bwd.path_launches))
    (l_c, g_c, n_c, _), (l_g, g_g, n_g, p_g) = msmoke["cpu"], msmoke[str(dev)]
    m_smoke_fma_launches = p_g["fma"]             # fp32: K3 backward's fma

    def ssm_leaf_grads(d):
        """The smoke step's gradients of SSM_SCAN_LEAVES, on device d."""
        params = T.tree_map(lambda t: t.to(d), init_state(mscfg, sopt,
                                                          0).params)
        flat = T.flatten(params)
        leaves = [p_.detach().requires_grad_() for _, p_ in flat]
        loss, _ = loss_fn(T.unflatten(params, leaves), mscfg, {
            k_: torch.from_numpy(v_).to(d) for k_, v_ in msbatch.items()})
        pick = [i for i, (k_, _) in enumerate(flat)
                if k_.rsplit("/", 1)[-1] in SSM_SCAN_LEAVES]
        grads = torch.autograd.grad(loss, [leaves[i] for i in pick])
        return {flat[i][0]: g_.cpu() for i, g_ in zip(pick, grads)}

    leaf_c, leaf_g = ssm_leaf_grads("cpu"), ssm_leaf_grads(dev)
    if len(leaf_c) != len(SSM_SCAN_LEAVES):
        fail(f"mamba2 smoke: scan leaves {sorted(leaf_c)}")
    leaf_err = {}
    for k_, e_ in leaf_c.items():
        leaf_err[k_.rsplit("/", 1)[-1]] = err = (
            (leaf_g[k_] - e_).abs().max() / e_.abs().max()).item()
        if not err <= SSM_LEAF_TOL:
            fail(f"mamba2 smoke step: the card's gradient of {k_} is "
                 f"{err:.3e} of its largest entry off the CPU's "
                 f"(> {SSM_LEAF_TOL})")
    if n_c["ssd_scan"] or n_c["ssd_scan_bwd"] or \
            n_g["ssd_scan"] != mscfg.num_layers or \
            n_g["ssd_scan_bwd"] != mscfg.num_layers or \
            p_g != {"fma": mscfg.num_layers, "wgmma": 0}:
        fail(f"mamba2 smoke train step launched {n_g} on the card (K3 "
             f"backward by path {p_g}), {n_c} on the CPU")
    if abs(l_g - l_c) > 1e-5 * abs(l_c) or abs(g_g - g_c) > 1e-4 * abs(g_c):
        fail(f"mamba2 smoke train step: card loss {l_g} / grad norm {g_g} "
             f"vs CPU {l_c} / {g_c}")
    phase("mamba2:train:smoke", loss_card=f"{l_g:.7f}", loss_cpu=f"{l_c:.7f}",
          grad_norm_card=f"{g_g:.6f}", grad_norm_cpu=f"{g_c:.6f}",
          k3_launches=f"{n_g['ssd_scan']},{n_g['ssd_scan_bwd']}",
          k3_bwd_paths=json.dumps(p_g, separators=(",", ":")),
          scan_leaf_grad_err=json.dumps({k_: float(f"{v_:.3e}") for k_, v_
                                         in leaf_err.items()},
                                        separators=(",", ":")),
          scan_leaf_tol=SSM_LEAF_TOL)

    # -- 13c. mamba2 training at full width and depth ------------------------
    mtruns = {}
    for label, schedule in (("static", {}), ("elastic", TRAIN_SCHEDULE)):
        runner, state, losses, secs, counts = train_run(mcfg, schedule,
                                                        TRAIN_STEPS)
        peak = torch.cuda.max_memory_allocated() / 1e9
        mtruns[label] = (runner, state, losses)
        phase(f"mamba2:train:{label}", layers=mcfg.num_layers,
              batch=TRAIN_BATCH, seq=tshape.seq_len,
              losses=",".join(f"{x:.6f}" for x in losses),
              step_s=",".join(f"{x:.3f}" for x in secs),
              s_per_step=f"{step_s(secs):.4f}",
              tokens_per_s=f"{tokens_per_step / step_s(secs):.0f}",
              k3_fwd_per_step=counts["ssd_scan"] / TRAIN_STEPS,
              k3_bwd_per_step=counts["ssd_scan_bwd"] / TRAIN_STEPS,
              paths=json.dumps(counts["paths"], separators=(",", ":")),
              peak_gb=f"{peak:.2f}",
              sizes=",".join(str(e.to_procs) for e in runner.events))
        for ev in runner.events:
            phase(f"mamba2:train:{label}:resize", step=ev.step,
                  action=ev.action, sizes=f"{ev.from_procs}->{ev.to_procs}",
                  bytes_moved=ev.transfer.bytes_moved,
                  seconds=f"{ev.transfer.seconds:.4f}")
        if label == "elastic":
            del state
            mtruns[label] = (runner, None, losses)
        else:
            m_train_fwd_launches = counts["ssd_scan"]
            m_train_bwd_launches = counts["ssd_scan_bwd"]
    static_l, elastic_l = mtruns["static"][2], mtruns["elastic"][2]
    gap = max(abs(a - b) for a, b in zip(static_l, elastic_l))
    actions = [e.action for e in mtruns["elastic"][0].events]
    if gap > TRAIN_LOSS_TOL or actions != ["expand", "shrink"]:
        fail(f"mamba2 elastic training: losses {elastic_l} vs static "
             f"{static_l} (gap {gap:.3e} > {TRAIN_LOSS_TOL}?), actions "
             f"{actions}")
    phase("mamba2:train", elastic_vs_static_max_gap=f"{gap:.3e}",
          tol=TRAIN_LOSS_TOL, actions=",".join(actions),
          state_gb=f"{sum(t.nbytes for t in T.leaves(mtruns['static'][1])) / 1e9:.2f}")
    mark("mamba2_train")

    # -- 13d. one traced 48-layer mamba2 training step -----------------------
    runner, state, _ = mtruns["static"]
    L = mcfg.num_layers
    for attempt in range(4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, m = runner.step(state, TRAIN_STEPS + attempt)
            float(m["loss"])
            torch.cuda.synchronize()
            traced_s = time.perf_counter() - t0
        dev_events = device_events(prof)
        bwd_evs = [e for e in dev_events if "ssd_bwd" in e.key]
        fwd_evs = [e for e in dev_events if "ssd_scan" in e.key]
        if sum(e.count for e in bwd_evs) == ss.BWD_KERNELS["wgmma"] * L and \
                sum(e.count for e in fwd_evs) == 2 * L:
            break
        print(f"chip_smoke: traced mamba2 train step: the profiler kept "
              f"{sum(e.count for e in fwd_evs)} K3 forward and "
              f"{sum(e.count for e in bwd_evs)} backward records: taken "
              "again", file=sys.stderr, flush=True)
    else:
        fail("the profiler dropped K3's records in four traced mamba2 "
             "train steps")
    t_busy = sum(device_us(e) for e in dev_events) / 1e3
    t_fwd = sum(device_us(e) for e in fwd_evs) / 1e3
    t_bwd = sum(device_us(e) for e in bwd_evs) / 1e3
    top = [{"kernel": e.key[:80], "ms": device_us(e) / 1e3, "calls": e.count}
           for e in dev_events[:PROFILE_TRAIN_TOP]]
    phase("mamba2:train:profile", layers=L, traced_step_s=f"{traced_s:.4f}",
          device_busy_ms=f"{t_busy:.3f}",
          idle_share=f"{1 - t_busy / (traced_s * 1e3):.4f}",
          k3_fwd_ms=f"{t_fwd:.3f}", k3_fwd_share=f"{t_fwd / t_busy:.4f}",
          k3_bwd_ms=f"{t_bwd:.3f}", k3_bwd_share=f"{t_bwd / t_busy:.4f}",
          k3_bwd_ms_by_kernel=json.dumps(
              {re.search(r"ssd_bwd_(\w+?)_kernel", e.key)[1]: round(
                  device_us(e) / 1e3, 3) for e in bwd_evs},
              separators=(",", ":")),
          top=json.dumps(top, separators=(",", ":")))
    del runner, state, mtruns, prof, dev_events, bwd_evs, fwd_evs
    torch.cuda.empty_cache()
    mark("mamba2_train_profile")

    # -- 14. kernels line: times at the path's shapes -----------------------
    kernels = []
    # K1 decode: the last step of the path (kv_len = 384 of a 512 cache)
    el = 2                                   # bf16 bytes
    b_dec, by_dec = bound_ms(
        el * (2 * BATCH * H * D + 2 * BATCH * Hkv * n * D),
        4 * BATCH * H * n * D, "bfloat16")
    kernels.append({
        "name": "flash_attention_fwd (decode, Sq=1)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:73",
        "path": "split_decode",
        "launches": flash_path[0], "max_abs_err": err_decode,
        "ms": time_ms(k1_dec), "device_ms": dev_ms["K1 decode"],
        "device_ms_cold": dev_ms["K1 decode cold"],
        "host_us": host_us(k1_dec),
        "plain_ms": time_ms(lambda: attention_reference(
            *args, causal=False, kv_len=kv_len), iters=20),
        "bound_ms": b_dec, "bound_by": by_dec,
        "library_ms": time_ms(sdpa_dec),
        "library_device_ms": dev_ms["SDPA decode"],
        "library_device_ms_cold": dev_ms["SDPA decode cold"],
        "shape": f"B={BATCH} H={H} Hkv={Hkv} D={D} kv_len={n} of {CACHE} bf16"})
    b_pre, by_pre = bound_ms(
        el * (2 * BATCH * PROMPT * H * D + 2 * BATCH * PROMPT * Hkv * D),
        4 * BATCH * H * D * (PROMPT * (PROMPT + 1) // 2), "bfloat16")
    kernels.append({
        "name": "flash_attention_fwd (prefill, causal)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:73",
        "path": "mma",
        "launches": flash_prefill, "max_abs_err": err_prefill,
        "ms": time_ms(k1_pre), "device_ms": dev_ms["K1 prefill"],
        "device_ms_cold": dev_ms["K1 prefill cold"],
        "plain_ms": time_ms(lambda: attention_reference(*pargs, causal=True),
                            iters=10),
        "bound_ms": b_pre, "bound_by": by_pre,
        "library_ms": time_ms(sdpa_pre),
        "library_device_ms": dev_ms["SDPA prefill"],
        "library_device_ms_cold": dev_ms["SDPA prefill cold"],
        "shape": f"B={BATCH} H={H} Hkv={Hkv} D={D} Sq=Sk={PROMPT} bf16"})
    # K1's backward at the training path's shape: the function's own work is
    # five products over the causal pairs (S = Q K^T again, dV, dP, dQ, dK),
    # its bytes q, k, v, o, dO and lse read and dq, dk, dv written once
    pairs = tS * (tS + 1) // 2
    b_bwd, by_bwd = bound_ms(
        el * (4 * TRAIN_BATCH * tS * tH * tD + 4 * TRAIN_BATCH * tS * tHkv * tD)
        + 4 * TRAIN_BATCH * tH * tS,
        5 * 2 * TRAIN_BATCH * tH * tD * pairs, "bfloat16")

    def plain_bwd():
        """The plain backward one batch row at a time (its fp32 scores at
        B=8 would take ~100 GB)."""
        for b_ in range(TRAIN_BATCH):
            attention_backward_reference(
                *(t[b_:b_ + 1] for t in bwd_sets[0]), causal=True)

    # K1's forward at the training path's shape, as training calls it (with
    # its lse): two products over the causal pairs; q, k, v read, out and
    # lse written once
    b_tfwd, by_tfwd = bound_ms(
        el * 2 * TRAIN_BATCH * tS * (tH + tHkv) * tD
        + 4 * TRAIN_BATCH * tH * tS,
        2 * 2 * TRAIN_BATCH * tH * tD * pairs, "bfloat16")

    def plain_tfwd():
        """The plain forward one batch row at a time, as plain_bwd."""
        for b_ in range(TRAIN_BATCH):
            attention_reference(*(t[b_:b_ + 1] for t in bwd_sets[0][:3]),
                                causal=True)

    kernels.append({
        "name": "flash_attention_fwd (train, causal, with lse)",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:73",
        "path": "mma",
        "launches": train_fwd_launches, "max_abs_err": err_fwd_train,
        "ms": time_ms(k1_tfwd, iters=10, warmup=2),
        "device_ms": dev_ms["K1 train fwd"],
        "plain_ms": time_ms(plain_tfwd, iters=2, warmup=1),
        "bound_ms": b_tfwd, "bound_by": by_tfwd,
        "library_ms": time_ms(sdpa_tfwd, iters=10, warmup=2),
        "library_device_ms": dev_ms["SDPA train fwd"],
        "shape": f"B={TRAIN_BATCH} H={tH} Hkv={tHkv} D={tD} S={tS} causal "
                 "bf16"})
    kernels.append({
        "name": "flash_attention_bwd (train, causal)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:73",
        "replaces_note": "the gradient of K1; the JAX package has no Pallas "
                         "backward and differentiates chunked_attention "
                         "(src/repro/models/attention.py:99) through XLA",
        "path": "wgmma",
        "launches": train_launches, "max_abs_err": err_bwd_train,
        "ms": time_ms(k1_bwd, iters=5, warmup=1),
        "device_ms": dev_ms["K1 bwd"],
        "device_ms_cold": dev_ms["K1 bwd cold"],
        "plain_ms": time_ms(plain_bwd, iters=2, warmup=1),
        "bound_ms": b_bwd, "bound_by": by_bwd,
        "library_ms": time_ms(sdpa_bwd, iters=10, warmup=2),
        "library_device_ms": dev_ms["SDPA bwd"],
        "shape": f"B={TRAIN_BATCH} H={tH} Hkv={tHkv} D={tD} S={tS} causal "
                 "bf16"})
    del bwd_sets, s_out
    # K2: the 4 -> 8 step of the block-cyclic path, one gather of the table
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
        "path": "bulk",
        "launches": repack_launches, "max_abs_err": err_rep,
        "ms": time_ms(lambda: ops.repack(src, idx), iters=20),
        "device_ms": dev_ms["K2"],
        "plain_ms": time_ms(lambda: repack_reference(src, idx_dev), iters=20),
        "bound_ms": b_rep, "bound_by": by_rep,
        "library_ms": time_ms(lambda: torch.index_select(src, 0, idx_dev),
                              iters=20),
        "library_device_ms": dev_ms["index_select"],
        "shape": f"src=({nblk},{blk},{vp_rows[1]}) fp32 idx={idx.size}"})
    # K3: one layer of the mamba2 prefill, bf16 xdt/B/C and f32 a; the work
    # counts G = C B^T once per (b, chunk), as the Pallas contract allows,
    # over the causal pairs of each chunk
    def k3_fwd_bound(B, H, S, P, N, Q):
        nc = S // Q
        return bound_ms(
            2 * B * S * H * P * 2 + 4 * B * S * H + 2 * B * S * N * 2,
            nc * B * Q * Q * N + nc * B * H * (Q * Q * P + 4 * Q * P * N),
            "bfloat16")

    b_ssd, by_ssd = k3_fwd_bound(*SSD_SLICE)
    kernels.append({
        "name": "ssd_scan_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:59",
        "path": "wgmma",
        "launches": k3_prefill, "max_abs_err": slice_err["bfloat16"][0],
        "ms": time_ms(k3, iters=20), "device_ms": dev_ms["K3"],
        "plain_ms": time_ms(lambda: ssd_chunked_reference(*ssd_args, sQ),
                            iters=5, warmup=1),
        "bound_ms": b_ssd, "bound_by": by_ssd, "library_ms": None,
        "library_device_ms": None,
        "library_note": "no single PyTorch call computes an SSD chunked scan",
        "shape": f"B={sB} H={sH} S={sS} P={sP} N={sN} Q={sQ} bf16 xdt/B/C, "
                 "f32 a"})
    # K3's forward at the SSM training path's shape, as training launches it
    # (twice a layer under remat)
    b_k3t, by_k3t = k3_fwd_bound(*SSD_BWD_TRAIN)
    kernels.append({
        "name": "ssd_scan_fwd (train)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:59",
        "path": "wgmma",
        "launches": m_train_fwd_launches,
        "max_abs_err": train_fwd_err["bfloat16"],
        "ms": time_ms(k3_tfwd, iters=10, warmup=2),
        "device_ms": dev_ms["K3 train fwd"],
        "plain_ms": time_ms(lambda: ssd_chunked_reference(
            *ssd_bwd_args[:4], bQ), iters=2, warmup=1),
        "bound_ms": b_k3t, "bound_by": by_k3t, "library_ms": None,
        "library_device_ms": None,
        "library_note": "no single PyTorch call computes an SSD chunked scan",
        "shape": f"B={bB} H={bH} S={bS} P={bP} N={bN} Q={bQ} bf16 xdt/B/C, "
                 "f32 a, mamba2's decays"})
    # K3's backward at the SSM training path's shape: the work over the
    # causal pairs of each chunk (per batch, head and chunk: the local state
    # sums, three state-term products and D = dy x^T, dx, dC, dB over the
    # pairs; C B^T once per batch and chunk); xdt, dy, dx (bf16), a, da
    # (f32), B, C, dB, dC (bf16) read or written once
    nc_b, pairs_b = bS // bQ, bQ * (bQ + 1) // 2
    b_k3b, by_k3b = bound_ms(
        2 * 3 * bB * bS * bH * bP + 4 * 2 * bB * bS * bH +
        2 * 4 * bB * bS * bN,
        2 * (bB * bH * nc_b * (5 * bQ * bP * bN + pairs_b * (2 * bP + 2 * bN))
             + bB * nc_b * pairs_b * bN), "bfloat16")
    got = ops.ssd_scan_bwd(*ssd_bwd_args, chunk=bQ)
    exp = ssd_chunked_backward_reference(*ssd_bwd_args, bQ)
    err_k3b = max((g_.float() - e_.float()).abs().max().item()
                  for g_, e_ in zip(got, exp))
    del got, exp
    kernels.append({
        "name": "ssd_scan_bwd (train)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:59",
        "replaces_note": "the gradient of K3; the JAX package has no Pallas "
                         "backward and differentiates ssd_chunked "
                         "(src/repro/models/ssm.py:57) through XLA",
        "path": "wgmma",
        "launches": m_train_bwd_launches, "max_abs_err": err_k3b,
        "max_abs_err_note": "largest over dx, da, dB, dC; each is held to "
                            "SSD_BWD_TOL of its largest entry (phase 5b)",
        "ms": time_ms(k3_bwd, iters=5, warmup=1),
        "device_ms": dev_ms["K3 bwd"],
        "device_ms_cold": dev_ms["K3 bwd cold"],
        "plain_ms": time_ms(lambda: ssd_chunked_backward_reference(
            *ssd_bwd_args, bQ), iters=2, warmup=1),
        "bound_ms": b_k3b, "bound_by": by_k3b, "library_ms": None,
        "library_device_ms": None,
        "library_note": "no PyTorch call computes an SSD scan's gradient",
        "shape": f"B={bB} H={bH} S={bS} P={bP} N={bN} Q={bQ} bf16 "
                 "xdt/B/C/dy, f32 a, mamba2's decays"})
    # the same function in fp32 on the fma path (the fp32 smoke step's),
    # on the bf16 row's inputs widened: the same work at the fp32 FMA
    # peak, every tensor but a and da twice the bytes
    ssd_bwd_f32_args = tuple(t.float() for t in ssd_bwd_args)
    b_k3f, by_k3f = bound_ms(
        4 * 3 * bB * bS * bH * bP + 4 * 2 * bB * bS * bH +
        4 * 4 * bB * bS * bN,
        2 * (bB * bH * nc_b * (5 * bQ * bP * bN + pairs_b * (2 * bP + 2 * bN))
             + bB * nc_b * pairs_b * bN), "float32")
    got = ops.ssd_scan_bwd(*ssd_bwd_f32_args, chunk=bQ)
    exp = ssd_chunked_backward_reference(*ssd_bwd_f32_args, bQ)
    err_k3f = max((g_.float() - e_.float()).abs().max().item()
                  for g_, e_ in zip(got, exp))
    del got, exp
    kernels.append({
        "name": "ssd_scan_bwd (train, fp32)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:59",
        "replaces_note": "the gradient of K3 (as the row above), on its "
                         "fp32 path",
        "path": "fma",
        "launches": m_smoke_fma_launches,
        "launches_note": "the fp32 mamba2-370m-smoke step on the card "
                         "(phase 13b); the bf16 main path takes wgmma",
        "max_abs_err": err_k3f,
        "max_abs_err_note": "largest over dx, da, dB, dC; each is held to "
                            "SSD_BWD_TOL of its largest entry (phase 5b)",
        "ms": time_ms(k3_bwd_f32, iters=5, warmup=1),
        "device_ms": dev_ms["K3 bwd fp32"],
        "plain_ms": time_ms(lambda: ssd_chunked_backward_reference(
            *ssd_bwd_f32_args, bQ), iters=2, warmup=1),
        "bound_ms": b_k3f, "bound_by": by_k3f, "library_ms": None,
        "library_device_ms": None,
        "library_note": "no PyTorch call computes an SSD scan's gradient",
        "shape": f"B={bB} H={bH} S={bS} P={bP} N={bN} Q={bQ} fp32 "
                 "xdt/B/C/dy, f32 a, mamba2's decays"})
    del ssd_bwd_f32_args
    mark("kernels")
    phase("timing", **{k: f"{v:.1f}" for k, v in marks.items()})
    print(json.dumps({"kernels": kernels, "card": smi_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
