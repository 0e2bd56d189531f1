#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py          # from the root of a checkout

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (K1
flash attention and its backward, K2, K3 and its backward), holds each
against its plain PyTorch version, then drives the port's three families'
serving and training paths at full width with random weights from a
seed -- ``granite-3-2b`` (dense, K1; 10 of its 40 layers, see
``GRANITE_LAYERS``; training also at all 40), ``mamba2-370m`` (SSM, K3;
serving at 24 of its 48 layers, ``MAMBA_SERVE_LAYERS``, training at all
48), ``zamba2-2.7b`` (hybrid, K3 and K1
at G = 1, D = 80; all 54 layers, elastic training at 12) -- and checks
that each really ran through its kernels; then the paper's live
multi-tenant cluster (``dmr.Cluster``) on eight workers of the card, with
toy tenants and with six full-width ``mamba2-370m`` training tenants; then
the elastic serving fleet (``repro_torch.serve.ReplicaSet``) with live
``phi4-mini-3.8b`` decode replicas at full width and all 32 layers (K1 at
G = 3, D = 128), and phi4's prefill against its decode.
Phases:

1. device: ``nvidia-smi`` name and power limit, ``torch.cuda`` name;
2. build: compile every kernel (one nvcc per source, in parallel), and
   print ptxas's report of K1's, K2's and K3's kernels (registers, spills,
   static shared memory);
3. K1 flash attention against ``attention_reference``, each case also
   checking which of K1's three paths it took (``path_launches``): the
   cases of the JAX package's kernel tests; bf16 prefill on the mma path
   at head dims 16, 32, 64, 80 and 128, ragged, windowed, Sq < Sk causal,
   Hkv = H and Hkv = 1; then the slice's own bf16 shapes, and fp32 and
   bf16 decode at a kv_len inside the last key split; then zamba2's shared
   attention (bf16, B=16, H = Hkv = 32, D=80): decode over its 512-slot
   cache at six kv_lens up to 512 (384 the serving path's last) on
   split_decode, causal prefill at S=256 (the group kernel) and at S=1024
   (the block kernel) on mma, each kernel as the C entry point counts its
   launches (``flash_attention.mma_kernel_launches``);
3b. K1's backward (``flash_attention_bwd.cu``) against
   ``attention_backward_reference`` on dq, dk, dv from the forward's own
   output and row log-sum-exp: every head dim in fp32 and bf16, causal,
   windowed with Sq = Sk = 200, non-causal, each bf16 case on the wgmma
   path and each fp32 case on the fma path (``path_launches``); then the
   training shape (B=1 to bound the plain version's memory, H=32, Hkv=8,
   S=4096, D=64, bf16), run twice and equal bit for bit, and K1's forward
   output there against ``attention_reference``; the lse against the plain
   forward's; then zamba2's training shape (B=1, H = Hkv = 32, S=4096,
   D=80, bf16) the same way, twice, bit for bit;
3c. phi4:K1: K1 at phi4-mini's shapes, before any phi4 model phase (bf16,
   B=16, H=24, Hkv=8: G = 3, D=128): decode over its 512-slot cache at
   seven kv_lens (384 the serving path's last) on split_decode (3 of its
   16 rows), causal prefill at S=256 on mma's group kernel (4 key tiles,
   the most it holds at D = 128; counted by the C entry point); device
   times warm and L2-cold, SDPA
   beside each, the bounds (phase 15's two phi4 rows);
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
   init; then zamba2's prefill shape (B=16, H=80, S=1024, P=64, N=64,
   Q=256) in bf16 on wgmma against ``ssd_chunked_reference``;
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
   (``SSD_CHUNKED_TOL``); then zamba2's training shape (B=8, H=80,
   S=4096, P=64, N=64, Q=256) in bf16 on wgmma: the forward, and the
   backward at mamba2's decays and at mild ones, two runs bit for bit;
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
9. the mamba2 serving path at ``MAMBA_SERVE_LAYERS`` (24 of 48; so is
   phase 10): ``decode_demo`` at granite's batch, prompt,
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
13e. the zamba2 serving path at ``Z_SERVE_LAYERS`` (all 54): granite's
    ``decode_demo`` schedule; tokens must agree, and each run launches K1
    once per group per step (9 x 384), all on split_decode, and no K3;
13f. zamba2 prefill vs decode: ``make_prefill_step`` at B=16, S=1024 must
    launch K3 once per layer (54, wgmma) and K1 once per group (9, mma);
    then, at ``Z_CHECK_LAYERS`` (the first 24 layers of the same weights),
    fp32 full-sequence logits at every position against the fp32
    token-by-token decode, bf16 prefill and decode against fp32 (largest
    and rms gap, beside the fp32 model with bf16-rounded weights); one
    traced 54-layer prefill: K3's and K1's shares, the top device kernels;
13g. zamba2 training: the smoke step at two groups (4 layers, fp32) on
    the card against the CPU's, for loss, gradient norm and every leaf's
    gradient (``shared_attn`` among them); then ``Z_ELASTIC_LAYERS`` (12,
    two groups) at granite's training settings, 6 static and 6 elastic
    steps whose losses agree to 1e-4; per step K3 24 + 12 launches and K1
    4 + 2, on wgmma and mma / wgmma;
13h. zamba2 training at all 54 layers: 2 static steps, s/step, tokens/s,
    peak GB, K3 108 + 54 and K1 18 + 9 launches a step, none on a plain
    version; one traced step: device busy, idle share, K3's and K1's
    forward and backward shares, the largest device operators;
14. the paper's live grid on toy tenants (``benchmarks/live_cluster.py``'s:
    ``materialize_live("steady", n_jobs=6, max_steps=10)``, limits scaled
    to half of the eight-worker pool, arrivals over 10 ticks;
    static/rigid, ``algorithm2`` and ``throughput-greedy`` each rigid and
    moldable, and a ``decisions="cosim"`` replay with ``crosscheck``),
    each tenant an 840-float vector and a counter on its workers, under
    both engines (``Cluster``, ``ReferenceCluster``) with the live trail
    sanitizer on: the engines must agree, the card's runs must equal the
    same grid on CPU workers (records, resize events, trail, and every
    tenant's final vector and counter, bit for bit, after all its
    steps), and every malleable configuration must beat static on
    jobs/s; per configuration ``makespan_ticks``, ``jobs_per_s``,
    ``alloc_rate_pct``, ``energy_kwh`` (the wattage model's nominal
    100 W idle and 340 W loaded per worker on the tick clock, not a
    reading of the card), ``n_resizes``, ``wall_s`` and
    ``throughput_vs_static``;
14b. real tenants: the ``steady`` workload of six jobs of six steps on the
    eight workers of the card (``device_count=8``), ``algorithm2``,
    moldable, each tenant ``lm_train_app`` of ``mamba2-370m`` at full
    width and all 48 layers (global batch 8 of 1024 tokens, ``train_4k``'s
    4096 cut for the script's time; bf16 over fp32 master weights; AdamW
    1e-3; seeded by its jid), its TrainState on the card and moved by
    ``default`` on every resize; both engines, sanitized: every job
    finishes, the engines agree on ``summary()``, records and trail, the
    most resized tenant's losses are within 1e-4 of the same job run
    alone, and K3 launches exactly 96 forward and 48 backward kernels per
    tenant step (steps counted from the trail), all on ``wgmma``; wall
    seconds, the median seconds per tenant step, each resize's bytes and
    seconds, the peak of co-resident tenants and of
    ``torch.cuda.max_memory_allocated``;
14c. fleet:inplace: ``tests/test_serving.py``'s in-place script at full
    width: one live phi4-mini replica (batch 16, cache 512, 2 of 4
    workers) grown in place to 4 workers at tick 3 and shrunk to 2 at
    tick 6 through the fleet's scale path, sanitized; its tokens and final
    KV cache bit-identical to the same run without resizes, scale events
    ``grow-in-place``, ``shrink-in-place``, runner events ``expand`` then
    ``shrink``, each one's bytes by pattern the closed form of the
    state's sizes (``replicate``: the parameters once per worker of the
    new mesh; ``default``: cache, token and position once), K1 32
    launches a tick, all on split_decode;
14d. fleet:live: ``slo-aware`` over phi4-mini replicas (``FLEET_CONFIG``:
    2 workers a replica, in-place grows to 4, 1-3 replicas on 8 workers)
    serving ``FLEET_STREAM``: ``summary()``, the latency CDF, timeline,
    scale events and trail equal the host model's run of the same stream
    (a synthetic pool, no device); every replica lives within its cache
    and decodes every other replica's tokens; K1 launches exactly
    replica-steps x 32, all on split_decode, and nothing else launches;
    ms per replica-step, each replica-add's seconds (app and runner init,
    first step) and each in-place grow's (``apply_resize``, next step),
    peak GB and wall seconds; replica 0's step ``FLEET_TRACE_STEP`` traced:
    its device busy time, idle share and largest device kernels;
14e. phi4-mini prefill vs decode: ``make_prefill_step`` at all 32 layers
    (B=16, S=256: K1 32 launches on mma's group kernel, no K3), its
    seconds (the time to the first token), then ``logits_check`` (fp32
    full-sequence logits at
    every position against fp32 token-by-token decode, bf16 prefill and
    decode against fp32, ``P_*_LOGITS_*``), and two faults planted in the
    bf16 decode's last step (its position one back; two KV heads' cached
    rows swapped) read by the same bf16 measure, each of which the bf16
    bound must reject; peak GB;
15. one JSON line ``{"kernels": [...]}`` with each kernel's launches, error
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
    (bf16 on wgmma, the main path's; fp32 on fma, the smoke step's).
    zamba2 adds seven: K1 decode, prefill (S=1024), and forward and
    backward at the training shape (B=8), each with SDPA beside it; K3
    forward at the prefill and the training shape and its backward; each
    timed right after the device times, its inputs then freed so that they
    do not count in the paths' peak memory.  phi4-mini adds two (phase
    3c): K1 decode (its launches the fleet's, phase 14d) and prefill (14e).
    Then
    the contract line ``{"ok": true, ...}``.

Any failure exits non-zero before the last line; no phase is caught and
continued.  Needs a CUDA card; without one (or outside a checkout) it
exits 1 and prints no result.
"""
import contextlib
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
#: mamba2 serving and its prefill-vs-decode check run 24 of its 48 layers:
#: both are host-bound (~1.1 ms of dispatch a layer and decode step), and
#: at 48 layers they took 160 of the script's 300 s before zamba2's paths
#: joined them; K3's own checks and times, and mamba2 training, keep all 48
MAMBA_SERVE_LAYERS = 24
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

#: phase 14, the live benchmark's grid (``benchmarks/live_cluster.py``):
#: (label, policy, submission mode, malleable, decisions)
LIVE_GRID = [("static/rigid", "algorithm2", "rigid", False, "policy"),
             ("algorithm2/rigid", "algorithm2", "rigid", True, "policy"),
             ("algorithm2/moldable", "algorithm2", "moldable", True,
              "policy"),
             ("throughput-greedy/rigid", "throughput-greedy", "rigid", True,
              "policy"),
             ("throughput-greedy/moldable", "throughput-greedy", "moldable",
              True, "policy"),
             ("cosim/algorithm2", "algorithm2", "moldable", True, "cosim")]
#: six steady jobs of ten steps on the eight-worker pool.  Job limits scale
#: to half the pool and arrivals to n_jobs * max_steps // 6 ticks, as in
#: the benchmark: a rigid job asking for the whole pool can be unblocked
#: by no shrink, so at device_count=8 the rigid malleable runs equal static
#: (0.1 jobs/s each on the tick clock), and the benchmark's assertion that
#: malleability wins could not hold
LIVE_JOBS, LIVE_STEPS, LIVE_DEVICE_COUNT, LIVE_SPAN = 6, 10, 4, 10
#: phase 14b: six steady jobs of six steps, limits scaled to the whole
#: pool, each a full-width 48-layer mamba2-370m training job at
#: TRAIN_BATCH x CLUSTER_SEQ tokens a step (train_4k's 4096 cut to 1024
#: for the script's time)
CLUSTER_JOBS, CLUSTER_STEPS, CLUSTER_SEQ = 6, 6, 1024

ZAMBA = "zamba2-2.7b"               # the hybrid family, at full width
#: its shared attention is multi-head (H = Hkv = 32, G = 1) at head dim 80
#: (from the config); K1's forward and backward at the training shape,
#: B cut to 1 to bound the plain version's memory, as BWD_TRAIN
Z_BWD_TRAIN = (1, 32, 32, 4096, 80)
#: its scan: 80 heads of P = 64 at N = 64, at the prefill's and the
#: training path's shapes (B, H, S, P, N, Q)
Z_SSD_PREFILL = (BATCH, 80, M_PREFILL_S, 64, 64, 256)
Z_SSD_TRAIN = (TRAIN_BATCH, 80, 4096, 64, 64, 256)
#: zamba2's elastic training runs two groups (12 of its 54 layers): a
#: resize clones the whole state, 29.1 GB at 54 layers, which with the
#: step's own peak does not fit the card; the static run takes all 54
Z_ELASTIC_LAYERS = 12
#: zamba2 serving and the prefill that counts its launches, in layers (all
#: 54); the prefill-vs-decode logits checks run the first 24 (four groups)
#: of the same weights: their two 1024-step decode loops are host-bound
#: (75-170 ms a step at 54 layers on H100 hosts) and took 210 of the
#: script's 590 s there
Z_SERVE_LAYERS, Z_CHECK_LAYERS = 54, 24
#: zamba2 fp32 full-sequence logits vs the token-by-token decode at every
#: one of the 1024 positions, by the largest and the rms gap.  The same
#: function in fp32 through the SSM layers and the attention blocks; the
#: chunked scan is ~1e-4 from the exact recurrence in y at these decays
#: (see M_FP32_LOGITS_ATOL), and this random-init model amplifies a
#: perturbation ~4x more than mamba2's (its fp32 logits move by rms 0.37
#: with the weights rounded to bf16, mamba2's by 0.085).  At all 54 layers
#: an H100 (80GB HBM3, 700 W) measured 5.5e-2 at worst over all positions
#: (8.7e-3 at the last), rms 8.8e-4; fewer layers amplify less.  A wrong cache slot,
#: position or carry moves the logits by about their std (~1.0), an rms
#: gap of ~1.4; so the largest gap is held to 0.25 and the rms gap, which
#: numeric noise keeps far below the largest, to 0.05
Z_FP32_LOGITS_ATOL, Z_FP32_LOGITS_RMS = 0.25, 0.05
#: each zamba2 bf16 path against the fp32 logits, by the largest and the
#: rms gap.  At all 54 layers on that card, rounding only the weights to
#: bf16 moved the fp32 logits by up to 2.31 (rms 0.37), and computing in
#: bf16 by up to 3.07 (rms 0.54 and 0.58, prefill and decode) against a
#: logits std of 1.01: this model's bf16 path is far noisier than
#: mamba2's.  The largest
#: gap is held to 6.0 (~6 std: overflow and blow-ups), the rms gap to 0.9,
#: between the measured 0.58 and the ~1.4 of decorrelated logits
Z_BF16_LOGITS_MAX, Z_BF16_LOGITS_RMS = 6.0, 0.9


#: phi4-mini (3.836 B parameters, 32 layers, 24 query heads of 128 over 8
#: KV heads: G = 3) at full width and depth: K1 at its shapes (phase 3c),
#: the serving fleet's replicas (14c, 14d), and prefill vs decode (14e)
PHI4 = "phi4-mini-3.8b"
#: fleet:live (14d): the policy-driven live fleet.  Replicas of 2 workers
#: that may grow in place to 4, between 1 and 3 of them (3 x 15.3 GB of
#: fp32 weights) on 8 workers, slo-aware at a 0.5 s SLO consulted every 5
#: ticks, a cold start of 4 ticks and an in-place grow of 1.  The stream
#: was picked on the CPU (the host model) for the smallest run that takes
#: every scale path: a 240-request diurnal swell over 3 s grows a replica
#: in place, cold-starts two and shrinks one in place in 158 ticks, 289
#: replica-steps, at most 154 for one replica (its cache holds 512): at
#: ~50 ms a host-bound 32-layer decode step, ~15 s
FLEET_CONFIG = dict(devices_per_replica=2, max_devices_per_replica=4,
                    min_replicas=1, max_replicas=3, initial_replicas=2,
                    cold_start_ticks=4, grow_ticks=1, slo_p99_s=0.5,
                    resize_every=5)
FLEET_STREAM = dict(scenario="diurnal", n_requests=240, horizon_s=3.0,
                    mean_decode=4, seed=0)
FLEET_REPLICA_STEPS = 289
#: replica 0's step (of its 154) that runs under the profiler
FLEET_TRACE_STEP = 100
#: ticks at which a replica decodes prompt tokens fed to it (each row its
#: own) before it decodes greedily
FLEET_PROMPT = 4
#: fleet:inplace (14c): tests/test_serving.py's in-place script
INPLACE_TICKS, INPLACE_GROW_AT, INPLACE_SHRINK_AT = 10, 3, 6
#: phi4 prefill vs decode (14e), through ``logits_check``.  fp32: granite's
#: bound (phase 7), here over every position (1.4e-4 at worst on an H100
#: 80GB HBM3, 700 W).  bf16 against fp32, by the largest and the rms gap:
#: phi4's 200064 logits spread wider than granite's (std 1.11 against
#: 0.90) through 32 wider layers, and on that card the bf16 paths were up
#: to 0.351 off (rms 0.066), past granite's 0.3; rounding only the
#: weights to bf16 moved them by up to 0.184 (rms 0.036).  Faults planted
#: in the bf16 decode's last step (``planted_faults``) read, on that card:
#: its position one back 5.53 (rms 1.10), two KV heads' cached rows
#: swapped 7.45 (rms 1.46), about one std of the logits as a wrong path
#: should.  So the largest gap is held to 0.6 and the rms gap to 0.15:
#: 1.7x and 2.3x above the sound readings, 9x and 7x below the faults'
P_FP32_LOGITS_ATOL = FP32_LOGITS_ATOL
P_BF16_LOGITS_MAX, P_BF16_LOGITS_RMS = 0.6, 0.15


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
    After eight windows with no such pair, the time is each record name's
    mean over the records the windows kept, times the records a call
    launches (its count over ``iters``, rounded), and the line says so;
    with no record kept at all the script fails."""
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
                {e.key: device_us(e) for e in evs})

    for c in calls + calls[:2]:
        c()
    torch.cuda.synchronize()
    last, kept = None, []
    for _ in range(8):
        counts, us = window()
        kept += [(k, n, us[k]) for k, n in counts.items()]
        if not counts or any(n % iters for n in counts.values()):
            print(f"chip_smoke: {what}: {iters} calls left device records "
                  f"{ {k[:60]: n for k, n in counts.items()} }: taken again",
                  file=sys.stderr, flush=True)
            last = None
            continue
        if last is not None and last[0] == counts:
            ms = (sum(us.values()) + last[1]) / 2e3 / iters
            print(f"[device_ms] {what}: {ms:.6f}", flush=True)
            return ms
        last = (counts, sum(us.values()))
    if not kept:
        fail(f"{what}: the profiler kept no device record in eight windows")
    ms = 0.0
    for name in {k for k, _, _ in kept}:
        mine = [(n, u) for k, n, u in kept if k == name]
        per_call = max(round(n / iters) for n, _ in mine)
        ms += sum(u for _, u in mine) / sum(n for n, _ in mine) * per_call
    print(f"[device_ms] {what}: {ms / 1e3:.6f} (mean of the kept records: "
          "the profiler dropped some in every window)", flush=True)
    return ms / 1e3


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


def k3_fwd_bound(B, H, S, P, N, Q):
    """K3's bound: bf16 xdt/B/C and f32 a read, y written once; the work
    counts G = C B^T once per (b, chunk), as the Pallas contract allows,
    over the causal pairs of each chunk."""
    nc = S // Q
    return bound_ms(
        2 * B * S * H * P * 2 + 4 * B * S * H + 2 * B * S * N * 2,
        nc * B * Q * Q * N + nc * B * H * (Q * Q * P + 4 * Q * P * N),
        "bfloat16")


def fleet_app(cfg, prompts, cache_len: int):
    """A replica's app: ``make_decode_app`` (its own parameters from seed
    0, as the JAX package's replicas build theirs) fed ``prompts[:, i]`` at
    its first ticks, so every row of the batch decodes its own sequence and
    a resize that mixed up rows would show."""
    from repro_torch import dmr
    from repro_torch.serve import make_decode_app
    app = make_decode_app(cfg, batch=prompts.shape[0], cache_len=cache_len)
    n_prompt = prompts.shape[1]

    def step(mesh):
        fn = app.make_step(mesh)
        return lambda state, i: fn(state, i, prompts[:, i]
                                   if i < n_prompt else None)
    return dmr.App(init=app.init_state, shardings=app.state_shardings,
                   step=step, patterns=app.patterns, name=app.name)


def kernel_launches() -> dict:
    """Every wrapper's launches since the last ``ops.reset_counts``, and
    K1's by path."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    return dict(ops.launch_counts(),
                paths=dict(fa.flash_attention.path_launches))


def fleet_inplace(cfg, device, batch: int, cache_len: int):
    """``tests/test_serving.py``'s in-place script on ``device``: one live
    replica (2 of 4 workers, static) grown in place to 4 at tick
    ``INPLACE_GROW_AT`` and shrunk to 2 at ``INPLACE_SHRINK_AT`` through
    the fleet's scale path, under the live trail sanitizer, against the
    same run without resizes.  Tokens and the final KV cache must be
    bit-identical, the scale events and runner events those of the script,
    each resize's bytes the closed form of the state's sizes (every
    parameter once per worker of the new mesh, the cache, token and
    position once).  The kernel counts are zeroed before and read after
    each run.  Returns the resized run's kernel launches and the runner's
    events."""
    import numpy as np
    import torch

    from repro_torch import tree as T
    from repro_torch.kernels import ops
    from repro_torch.parallel.mesh import logical_workers
    from repro_torch.serve import ReplicaSet, ServeConfig, make_request_stream
    sc = ServeConfig(devices_per_replica=2, max_devices_per_replica=4,
                     min_replicas=1, max_replicas=1, initial_replicas=1,
                     slots_per_device=4)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, FLEET_PROMPT), dtype=np.int32)

    def drive(resize):
        reqs = make_request_stream("steady", 8, horizon_s=1.0, mean_decode=6,
                                   max_decode_factor=1.0, seed=1)
        rs = ReplicaSet(reqs, devices=logical_workers(4, device), config=sc,
                        static_replicas=1,
                        app_factory=lambda: fleet_app(cfg, prompts,
                                                      cache_len),
                        sanitize=True)
        ops.reset_counts()
        rs.start_fleet()
        rep = rs._replicas[0]
        for i in range(INPLACE_TICKS):
            if resize and i == INPLACE_GROW_AT:
                rs._grow_in_place(rep, 4)
                if rep.current_size != 4 or rs._idle:
                    fail(f"fleet:inplace: grow left {rep.current_size} "
                         f"workers, {len(rs._idle)} idle")
            if resize and i == INPLACE_SHRINK_AT:
                rs._shrink_in_place(rep, 2)
                if rep.current_size != 2 or len(rs._idle) != 2:
                    fail(f"fleet:inplace: shrink left {rep.current_size} "
                         f"workers, {len(rs._idle)} idle")
            rs.tick_once()
            rs._tick += 1
        torch.cuda.synchronize(device)
        return rs, rep, kernel_launches()

    _, rep_s, n_s = drive(False)
    tok_s, cache_s = rep_s.token_history(), rep_s.state["cache"]
    rep_s.state = None                      # its parameters: free them
    rs_e, rep_e, n_e = drive(True)
    tok_e = rep_e.token_history()
    if tok_s.shape != (INPLACE_TICKS, batch, 1) or \
            not np.array_equal(tok_s, tok_e):
        fail(f"fleet:inplace: tokens differ across the in-place resizes:\n"
             f"{tok_s[:, :, 0].T}\nvs\n{tok_e[:, :, 0].T}")
    same_cache = all(torch.equal(a, b) for a, b in zip(
        T.leaves(cache_s), T.leaves(rep_e.state["cache"])))
    if not same_cache:
        fail("fleet:inplace: the KV caches differ across the in-place "
             "resizes")
    kinds = [e["kind"] for e in rs_e.scale_events]
    evs = rep_e.runner.events
    moves = [(e.action, e.from_procs, e.to_procs) for e in evs]
    if kinds != ["grow-in-place", "shrink-in-place"] or \
            (rs_e.n_scale_ups, rs_e.n_scale_downs) != (1, 1) or \
            moves != [("expand", 2, 4), ("shrink", 4, 2)]:
        fail(f"fleet:inplace: scale events {kinds}, runner events {moves}")
    pbytes = sum(t.nbytes for t in T.leaves(rep_e.state["params"]))
    cbytes = sum(t.nbytes for t in T.leaves(rep_e.state["cache"])) + \
        batch * 4 + 4                                   # + tok and pos
    for e in evs:
        want = {"replicate": pbytes * e.to_procs, "default": cbytes}
        got = {k: st.bytes_moved for k, st in e.per_pattern.items()}
        if got != want or e.transfer.bytes_moved != sum(want.values()):
            fail(f"fleet:inplace: {e.action} moved {got} bytes "
                 f"({e.transfer.bytes_moved} in all), the state's sizes "
                 f"say {want}")
    if n_s != n_e:
        fail(f"fleet:inplace: kernel launches {n_s} without resizes, "
             f"{n_e} with")
    rep_e.state = None
    return n_e, evs


def fleet_live(cfg, device, batch: int, cache_len: int):
    """The policy-driven live fleet: ``slo-aware`` over ``FLEET_CONFIG``
    replicas of ``cfg`` on 8 workers of ``device``, serving
    ``FLEET_STREAM``, sanitized, against the host model of the same stream
    and config (a synthetic pool, no device).  Summary, CDF, timeline,
    scale events and trail must be equal; every replica lives within its
    cache and decodes the tokens of every other (one seed, one prompt
    set), resized or not.  Replica 0's step ``FLEET_TRACE_STEP`` runs under
    the profiler.  The kernel counts are zeroed just before the run and
    read just after.  Returns the result, the replica-steps, the kernel
    counts, the wall seconds, each replica's timings and the traced
    step's."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import dmr
    from repro_torch.kernels import ops
    from repro_torch.parallel.mesh import logical_workers
    from repro_torch.serve import ReplicaSet, ServeConfig, make_request_stream

    def sync():
        torch.cuda.synchronize(device)

    def stream():
        kw = dict(FLEET_STREAM)
        return make_request_stream(kw.pop("scenario"), kw.pop("n_requests"),
                                   **kw)

    def observed(res):
        return (res.summary(), res.metrics.cdf(), res.timeline,
                res.scale_events, res.trail, res.ticks, res.device_ticks)

    sc = ServeConfig(**FLEET_CONFIG)
    host_rs = ReplicaSet(stream(), devices=8, config=sc, policy="slo-aware",
                         sanitize=True)
    host = host_rs.run()
    steps = [rep._tick_i for rep in host_rs.tenants]
    kinds = [e["kind"] for e in host.scale_events]
    if sum(steps) != FLEET_REPLICA_STEPS or max(steps) > cache_len or \
            steps[0] <= FLEET_TRACE_STEP or \
            not {"replica-add", "grow-in-place", "shrink-in-place"} <= \
            set(kinds):
        fail(f"fleet:live: the host model's schedule changed: replica "
             f"steps {steps} (cache {cache_len}), scale events {kinds}")

    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, FLEET_PROMPT), dtype=np.int32)
    step_s = []                          # by rid: each step's seconds
    trace = {}

    def factory():
        app = fleet_app(cfg, prompts, cache_len)
        mine, rid = [], len(step_s)
        step_s.append(mine)

        def step(mesh):
            fn = app.make_step(mesh)

            def timed(state, i):
                traced = rid == 0 and len(mine) == FLEET_TRACE_STEP
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) \
                        if traced else contextlib.nullcontext() as prof:
                    t0 = time.perf_counter()
                    out = fn(state, i)
                    sync()
                    mine.append(time.perf_counter() - t0)
                if traced:
                    trace.update(step_s=mine[-1], events=device_events(prof))
                return out
            return timed
        return dmr.App(init=app.init_state, shardings=app.state_shardings,
                       step=step, patterns=app.patterns, name=app.name)

    class TimedFleet(ReplicaSet):
        """The fleet with each replica bring-up and in-place grow timed
        (the device synchronised around them)."""

        def __init__(self, *args, **kw):
            self.up_s, self.grow_s = {}, []
            super().__init__(*args, **kw)

        def _replica_up(self):
            sync()
            t0 = time.perf_counter()
            rep = super()._replica_up()
            sync()
            if rep is not None:
                self.up_s[rep.rid] = time.perf_counter() - t0
            return rep

        def _grow_in_place(self, rep, target):
            sync()
            t0 = time.perf_counter()
            super()._grow_in_place(rep, target)
            sync()
            self.grow_s.append((rep.rid, rep._tick_i,
                                time.perf_counter() - t0))

    rs = TimedFleet(stream(), devices=logical_workers(8, device), config=sc,
                    policy="slo-aware", sanitize=True, app_factory=factory)
    ops.reset_counts()
    sync()
    t0 = time.perf_counter()
    res = rs.run()
    sync()
    wall = time.perf_counter() - t0
    n = kernel_launches()
    if observed(res) != observed(host):
        fail(f"fleet:live: the live run differs from the host model: "
             f"{res.summary()} vs {host.summary()}")
    live_steps = [rep._tick_i for rep in rs.tenants]
    toks = [rep.token_history() for rep in rs.tenants]
    if live_steps != steps or [len(t) for t in toks] != steps:
        fail(f"fleet:live: replica steps {live_steps} (tokens "
             f"{[len(t) for t in toks]}), host model {steps}")
    longest = max(toks, key=len)
    for rid, t in enumerate(toks):
        if not np.array_equal(t, longest[:len(t)]):
            fail(f"fleet:live: replica {rid}'s tokens differ from the "
                 "others'")
    added = [r for r in rs.up_s if r >= sc.initial_replicas]
    timings = dict(
        step_s=step_s,
        replica_add_s=[(r, rs.up_s[r], step_s[r][0]) for r in added],
        initial_up_s=[rs.up_s[r] for r in rs.up_s if r not in added],
        grow_s=[(r, g, step_s[r][i]) for r, i, g in rs.grow_s])
    return res, steps, n, wall, timings, trace


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

    def k1_case(q, k, v, what, mma_kernel=None, **kw):
        """K1 against its plain version on one case; the call must take
        (and count) the path ``select_path`` names for its shape, and, when
        ``mma_kernel`` names one, launch that kernel of the mma path
        ("group" or "block"), as the C entry point counts them."""
        name = str(q.dtype).split(".")[1]
        path = fa.select_path(q.dtype, q.shape[1] // k.shape[1] * q.shape[2])
        before = dict(fa.flash_attention.path_launches)
        mma0 = fa.mma_kernel_launches()
        out = ops.flash_attention(q, k, v, **kw)
        moved = {p: n - before[p]
                 for p, n in fa.flash_attention.path_launches.items()}
        if moved != {p: int(p == path) for p in moved}:
            fail(f"{what}: path launches {moved}, not one on {path}")
        kern = {k_: n_ - mma0[k_]
                for k_, n_ in fa.mma_kernel_launches().items()}
        if mma_kernel is not None and \
                kern != {k_: int(k_ == mma_kernel) for k_ in kern}:
            fail(f"{what}: mma kernels launched {kern}, not one {mma_kernel}")
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
    # zamba2's shared attention, multi-head (G = 1) at head dim 80, bf16:
    # decode over its 512-slot cache on split_decode, at the serving path's
    # last kv_len (384) and around tile edges; causal prefill on mma at
    # S = 256 (the group kernel: 2 B Hkv >= SMs, 4 tiles) and at the
    # prefill path's S = 1024 (the block kernel)
    zcfg = get_config(ZAMBA)
    zH, zHkv, zD = zcfg.num_heads, zcfg.num_kv_heads, zcfg.head_dim
    zkc, zvc = (rand((BATCH, CACHE, zHkv, zD), bf16) for _ in range(2))
    zdargs = (rand((BATCH, 1, zH, zD), bf16).transpose(1, 2),
              zkc.transpose(1, 2), zvc.transpose(1, 2))
    z_err = {"decode_all": 0.0}
    for n_ in (1, 64, 65, 200, CACHE, PROMPT + DECODE):
        _, z_err["decode"] = k1_case(
            *zdargs, f"zamba2 decode {BATCH}x{zH}x{zHkv} D={zD} kv_len {n_}",
            causal=False,
            kv_len=torch.tensor(n_, dtype=torch.int32, device=dev))
        z_err["decode_all"] = max(z_err["decode_all"], z_err["decode"])
    z_pre = {}
    z_kernel = {PROMPT: "group", M_PREFILL_S: "block"}
    for S_ in (PROMPT, M_PREFILL_S):
        z_pre[S_] = (rand((BATCH, S_, zH, zD), bf16).transpose(1, 2),
                     rand((BATCH, S_, zHkv, zD), bf16).transpose(1, 2),
                     rand((BATCH, S_, zHkv, zD), bf16).transpose(1, 2))
        _, z_err[f"prefill{S_}"] = k1_case(
            *z_pre[S_], f"zamba2 prefill {BATCH}x{zH}x{zHkv} S={S_} D={zD}",
            mma_kernel=z_kernel[S_], causal=True)
    zpargs = z_pre[M_PREFILL_S]            # timed in phase 15
    del z_pre
    torch.cuda.synchronize()
    phase("K1", cases=sum(case_paths.values()) + 3,
          paths=json.dumps(case_paths, separators=(",", ":")),
          last_split_kv_len=n_last,
          max_err_f32=f"{errs['float32']:.3e}",
          max_err_bf16=f"{errs['bfloat16']:.3e}",
          slice_decode_err=f"{err_decode:.3e}",
          slice_prefill_err=f"{err_prefill:.3e}",
          zamba2_decode_err=f"{z_err['decode_all']:.3e}",
          zamba2_prefill_err=f"{z_err[f'prefill{PROMPT}']:.3e},"
                             f"{z_err[f'prefill{M_PREFILL_S}']:.3e}",
          zamba2_prefill_kernel=",".join(z_kernel.values()),
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
    # zamba2's shared attention at its training shape: G = 1, D = 80
    zaB, zaH, zaHkv, zaS, zaD = Z_BWD_TRAIN
    bwd_err["bfloat16"] = 0.0
    zargs_1, zgot = k1_bwd_case(zaB, zaH, zaHkv, zaS, zaS, zaD, True, 0,
                                bf16,
                                f"zamba2 bwd train shape {Z_BWD_TRAIN}")
    z_err["bwd_train"] = bwd_err["bfloat16"]
    again = ops.flash_attention_bwd(*zargs_1, causal=True)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(zgot, again)):
        fail("K1 backward at zamba2's shape: two runs differ")
    z_err["fwd_train"] = check_close(
        zargs_1[3], attention_reference(*zargs_1[:3], causal=True),
        "bfloat16", f"K1 forward at zamba2's train shape {Z_BWD_TRAIN}")
    del zargs_1, zgot
    phase("K1:bwd", cases=len(bwd_cases) + 2,
          paths=json.dumps(bwd_paths, separators=(",", ":")),
          max_err_f32=f"{small_err['float32']:.3e}",
          max_err_bf16=f"{max(small_err['bfloat16'], err_bwd_train):.3e}",
          train_shape=str(BWD_TRAIN).replace(" ", ""),
          train_shape_err=f"{err_bwd_train:.3e}", bitwise_repeatable=True,
          fwd_train_shape_err=f"{err_fwd_train:.3e}",
          zamba2_train_shape=str(Z_BWD_TRAIN).replace(" ", ""),
          zamba2_train_shape_err=f"{z_err['bwd_train']:.3e}",
          zamba2_fwd_train_shape_err=f"{z_err['fwd_train']:.3e}",
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
    # zamba2's scan at its prefill path's shape (80 heads, N = 64), bf16 on
    # wgmma, at mamba2's decays (zamba2's A and dt draw the same way)
    zsQ = Z_SSD_PREFILL[5]
    zs_args = ssd_inputs(*Z_SSD_PREFILL[:5], "model", bf16)
    what = f"zamba2 ssd prefill {Z_SSD_PREFILL} bf16 decay model"
    out, path = k3_call(*zs_args, zsQ, what)
    if path != "wgmma":
        fail(f"{what}: took K3's {path} path, not wgmma")
    z_err["ssd_prefill"] = check_close(
        out, ssd_chunked_reference(*zs_args, zsQ), "bfloat16", what,
        SSD_CHUNKED_TOL["bfloat16"])
    torch.cuda.synchronize()
    del out
    phase("K3", cases=len(SSD_CASES) + 4,
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
          zamba2_prefill=str(Z_SSD_PREFILL).replace(" ", ""),
          zamba2_prefill_err_vs_chunked=f"{z_err['ssd_prefill']:.3e}",
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
            ssd_bwd_args = targs                  # timed in phase 15
            again = ops.ssd_scan_bwd(*targs, chunk=bQ)
            torch.cuda.synchronize()
            if not all(torch.equal(a_, b_) for a_, b_ in zip(tgot, again)):
                fail("K3 backward: two runs on the same inputs differ")
            del again
        del tgot, targs
    # zamba2's scan at its training shape (80 heads, N = 64; dB and dC sum
    # 2.5x mamba2's heads): the forward and the backward in bf16 on wgmma,
    # at mamba2's decays and at mild ones; two backward runs bit for bit
    zbB, zbH, zbS, zbP, zbN, zbQ = Z_SSD_TRAIN
    z_bwd_err = {}
    if ss.select_bwd_path(bf16, zbP, zbN, zbQ) != "wgmma":
        fail("K3 backward at zamba2's training shape does not take wgmma")
    for decay in ("model", 0.02):
        targs = ssd_bwd_inputs(zbB, zbH, zbS, zbP, zbN, decay, bf16)
        what = f"zamba2 ssd train shape {Z_SSD_TRAIN} bf16 decay {decay}"
        if decay == "model":
            out, path = k3_call(*targs[:4], zbQ, what)
            if path != "wgmma":
                fail(f"{what}: took K3's {path} path, not wgmma")
            z_err["ssd_train_fwd"] = check_close(
                out, ssd_chunked_reference(*targs[:4], zbQ), "bfloat16",
                what, SSD_CHUNKED_TOL["bfloat16"])
            del out
        tgot, z_bwd_err[decay] = k3_bwd_case(targs, zbQ, what + " bwd")
        if decay == "model":
            zssd_bwd_args = targs                 # timed in phase 15
            again = ops.ssd_scan_bwd(*targs, chunk=zbQ)
            torch.cuda.synchronize()
            if not all(torch.equal(a_, b_) for a_, b_ in zip(tgot, again)):
                fail("K3 backward at zamba2's shape: two runs differ")
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
    phase("K3:bwd", cases=len(bwd_table) + 5,
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
          zamba2_train_shape=str(Z_SSD_TRAIN).replace(" ", ""),
          zamba2_train_shape_err=json.dumps(
              {f"bfloat16,{k}": fmt(v) for k, v in z_bwd_err.items()},
              separators=(",", ":")),
          zamba2_train_shape_fwd_err=f"{z_err['ssd_train_fwd']:.3e}",
          strided_bitwise_equal=True, bitwise_repeatable=True,
          err_order="dx,da,dB,dC",
          tol=json.dumps(SSD_BWD_TOL, separators=(",", ":")))
    torch.cuda.empty_cache()
    mark("K3_bwd")

    # -- device times for the kernels line (phase 15), taken here: late in
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
    # zamba2's rows: K1 (G = 1, D = 80) decode at the serving path's last
    # kv_len and prefill at S = 1024, K1's forward with its lse and its
    # backward at the training shape (B = 8), SDPA beside each; K3 at the
    # prefill and training shapes, and its backward
    z_n = PROMPT + DECODE
    z_kv = torch.tensor(z_n, dtype=torch.int32, device=dev)
    zk1_dec = lambda: ops.flash_attention(*zdargs, causal=False, kv_len=z_kv)
    zsdpa_dec = lambda: F.scaled_dot_product_attention(
        zdargs[0], zdargs[1][:, :, :z_n], zdargs[2][:, :, :z_n])
    zk1_pre = lambda: ops.flash_attention(*zpargs, causal=True)
    zsdpa_pre = lambda: F.scaled_dot_product_attention(*zpargs,
                                                       is_causal=True)
    zq_, zdo_ = (rand((TRAIN_BATCH, zaS, zaH, zaD), bf16).transpose(1, 2)
                 for _ in range(2))
    zk_, zv_ = (rand((TRAIN_BATCH, zaS, zaHkv, zaD), bf16).transpose(1, 2)
                for _ in range(2))
    zbwd_set = (zq_, zk_, zv_, *fa.flash_attention_lse(zq_, zk_, zv_,
                                                        causal=True))
    zbwd_set = zbwd_set[:4] + (zdo_, zbwd_set[4])     # q, k, v, o, dO, lse
    del zq_, zk_, zv_, zdo_
    zk1_bwd = lambda: ops.flash_attention_bwd(*zbwd_set, causal=True)
    zk1_tfwd = lambda: fa.flash_attention_lse(*zbwd_set[:3], causal=True)
    zsdpa_tfwd = lambda: F.scaled_dot_product_attention(*zbwd_set[:3],
                                                        is_causal=True)
    zsq, zsk, zsv = (t.detach().requires_grad_() for t in zbwd_set[:3])
    zs_out = F.scaled_dot_product_attention(zsq, zsk, zsv, is_causal=True)
    zsdpa_bwd = lambda: torch.autograd.grad(zs_out, (zsq, zsk, zsv),
                                            zbwd_set[4], retain_graph=True)
    zk3_pre = lambda: ops.ssd_scan(*zs_args, chunk=zsQ)
    zk3_tfwd = lambda: ops.ssd_scan(*zssd_bwd_args[:4], chunk=zbQ)
    zk3_bwd = lambda: ops.ssd_scan_bwd(*zssd_bwd_args, chunk=zbQ)
    dev_ms.update({
        "Z K1 decode": device_ms(zk1_dec, "zamba2 K1 decode"),
        "Z SDPA decode": device_ms(zsdpa_dec, "zamba2 SDPA decode"),
        "Z K1 prefill": device_ms(zk1_pre, "zamba2 K1 prefill", iters=8),
        "Z SDPA prefill": device_ms(zsdpa_pre, "zamba2 SDPA prefill",
                                    iters=8),
        "Z K1 train fwd": device_ms(zk1_tfwd, "zamba2 K1 forward, train "
                                    "shape", iters=8),
        "Z SDPA train fwd": device_ms(zsdpa_tfwd, "zamba2 SDPA forward, "
                                      "train shape", iters=8),
        "Z K1 bwd": device_ms(zk1_bwd, "zamba2 K1 backward", iters=4),
        "Z SDPA bwd": device_ms(zsdpa_bwd, "zamba2 SDPA backward", iters=4),
        "Z K3 prefill": device_ms(zk3_pre, "zamba2 K3 prefill", iters=5),
        "Z K3 train fwd": device_ms(zk3_tfwd, "zamba2 K3 forward, train "
                                    "shape", iters=8),
        "Z K3 bwd": device_ms(zk3_bwd, "zamba2 K3 backward", iters=4)})
    del cold_dec, cold_pre, k3_bwd_sets, ssd_bwd_f32_args
    mark("device_ms")

    # zamba2's kernel rows for phase 15, timed here and their inputs freed
    # (they would count in the training phases' peak memory): K1 at G = 1,
    # D = 80 (decode at the serving path's last step, prefill at the
    # prefill path's S = 1024, training forward and backward at B = 8,
    # S = 4096), K3 at 80 heads, N = 64 (prefill, training forward and
    # backward); work and bytes counted as phase 15's rows count them.
    # Their launches come from the zamba2 paths (phases 13e-13h)
    attn_src = "src/repro_torch/kernels/csrc/flash_attention.cu"
    zb_dec = bound_ms(2 * (2 * BATCH * zH * zD + 2 * BATCH * zHkv * z_n * zD),
                      4 * BATCH * zH * z_n * zD, "bfloat16")
    zS_ = M_PREFILL_S
    zb_pre = bound_ms(2 * 4 * BATCH * zS_ * zH * zD,
                      4 * BATCH * zH * zD * (zS_ * (zS_ + 1) // 2), "bfloat16")
    zpairs = zaS * (zaS + 1) // 2
    zb_tfwd = bound_ms(2 * 2 * TRAIN_BATCH * zaS * (zaH + zaHkv) * zaD
                       + 4 * TRAIN_BATCH * zaH * zaS,
                       2 * 2 * TRAIN_BATCH * zaH * zaD * zpairs, "bfloat16")
    zb_bwd = bound_ms(2 * (4 * TRAIN_BATCH * zaS * zaH * zaD +
                            4 * TRAIN_BATCH * zaS * zaHkv * zaD)
                      + 4 * TRAIN_BATCH * zaH * zaS,
                      5 * 2 * TRAIN_BATCH * zaH * zaD * zpairs, "bfloat16")

    def per_row(fn, args):
        """A plain version one batch row at a time (its fp32 scores at the
        full batch would not fit)."""
        return lambda: [fn(*(t[b_:b_ + 1] for t in args), causal=True)
                        for b_ in range(args[0].shape[0])]

    z_rows = []
    z_note = f"zamba2-2.7b's {DEPTH_STEPS}-step 54-layer training run"
    for name, path, note, err, fn, dms, plain, b_, lib, ldms, shape in (
        ("flash_attention_fwd (zamba2 decode, G=1, D=80)", "split_decode",
         "one decode_demo run at 54 layers (9 groups)",
         z_err["decode"], zk1_dec, "Z K1 decode",
         (lambda: attention_reference(*zdargs, causal=False, kv_len=z_kv),
          20), zb_dec, zsdpa_dec, "Z SDPA decode",
         f"B={BATCH} H={zH} Hkv={zHkv} D={zD} kv_len={z_n} of {CACHE} bf16"),
        ("flash_attention_fwd (zamba2 prefill, causal)", "mma",
         "one make_prefill_step at B=16, S=1024",
         z_err[f"prefill{M_PREFILL_S}"], zk1_pre, "Z K1 prefill",
         (lambda: attention_reference(*zpargs, causal=True), 3), zb_pre,
         zsdpa_pre, "Z SDPA prefill",
         f"B={BATCH} H={zH} Hkv={zHkv} D={zD} Sq=Sk={M_PREFILL_S} bf16, "
         "the block kernel"),
        ("flash_attention_fwd (zamba2 train, causal, with lse)", "mma",
         z_note, z_err["fwd_train"], zk1_tfwd,
         "Z K1 train fwd", (per_row(attention_reference, zbwd_set[:3]), 2),
         zb_tfwd, zsdpa_tfwd, "Z SDPA train fwd",
         f"B={TRAIN_BATCH} H={zaH} Hkv={zaHkv} D={zaD} S={zaS} causal bf16"),
        ("flash_attention_bwd (zamba2 train, causal)", "wgmma",
         z_note, z_err["bwd_train"], zk1_bwd, "Z K1 bwd",
         (per_row(attention_backward_reference, zbwd_set), 2), zb_bwd,
         zsdpa_bwd, "Z SDPA bwd",
         f"B={TRAIN_BATCH} H={zaH} Hkv={zaHkv} D={zaD} S={zaS} causal bf16")):
        z_rows.append({
            "name": name, "route": "cuda",
            "source": attn_src if "fwd" in name else
            "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention.py:73",
            "path": path, "launches_note": note,
            "max_abs_err": err,
            "ms": time_ms(fn, iters=10, warmup=2), "device_ms": dev_ms[dms],
            "plain_ms": time_ms(plain[0], iters=plain[1], warmup=1),
            "bound_ms": b_[0], "bound_by": b_[1],
            "library_ms": time_ms(lib, iters=10, warmup=2),
            "library_device_ms": dev_ms[ldms], "shape": shape})
    ssd_src = "src/repro_torch/kernels/csrc/ssd_scan.cu"
    zbB_, zbH_, zbS_, zbP_, zbN_, zbQ_ = Z_SSD_TRAIN
    znc, zpb = zbS_ // zbQ_, zbQ_ * (zbQ_ + 1) // 2
    zb_k3b = bound_ms(
        2 * 3 * zbB_ * zbS_ * zbH_ * zbP_ + 4 * 2 * zbB_ * zbS_ * zbH_ +
        2 * 4 * zbB_ * zbS_ * zbN_,
        2 * (zbB_ * zbH_ * znc * (5 * zbQ_ * zbP_ * zbN_ +
                                  zpb * (2 * zbP_ + 2 * zbN_))
             + zbB_ * znc * zpb * zbN_), "bfloat16")
    got = ops.ssd_scan_bwd(*zssd_bwd_args, chunk=zbQ)
    exp = ssd_chunked_backward_reference(*zssd_bwd_args, zbQ)
    z_err["ssd_bwd"] = max((g_.float() - e_.float()).abs().max().item()
                           for g_, e_ in zip(got, exp))
    del got, exp
    no_lib = "no single PyTorch call computes an SSD chunked scan"
    for name, src_, note, err, fn, dms, plain, b_, shape in (
        ("ssd_scan_fwd (zamba2 prefill)", ssd_src,
         "one make_prefill_step at B=16, S=1024", z_err["ssd_prefill"],
         zk3_pre, "Z K3 prefill",
         lambda: ssd_chunked_reference(*zs_args, zsQ),
         k3_fwd_bound(*Z_SSD_PREFILL), Z_SSD_PREFILL),
        ("ssd_scan_fwd (zamba2 train)", ssd_src, z_note,
         z_err["ssd_train_fwd"], zk3_tfwd, "Z K3 train fwd",
         lambda: ssd_chunked_reference(*zssd_bwd_args[:4], zbQ),
         k3_fwd_bound(*Z_SSD_TRAIN), Z_SSD_TRAIN),
        ("ssd_scan_bwd (zamba2 train)",
         "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu", z_note,
         z_err["ssd_bwd"], zk3_bwd, "Z K3 bwd",
         lambda: ssd_chunked_backward_reference(*zssd_bwd_args, zbQ),
         zb_k3b, Z_SSD_TRAIN)):
        z_rows.append({
            "name": name, "route": "cuda", "source": src_,
            "replaces": "src/repro/kernels/ssd_scan.py:59", "path": "wgmma",
            "launches_note": note, "max_abs_err": err,
            "ms": time_ms(fn, iters=10, warmup=2), "device_ms": dev_ms[dms],
            "plain_ms": time_ms(plain, iters=2, warmup=1),
            "bound_ms": b_[0], "bound_by": b_[1], "library_ms": None,
            "library_device_ms": None,
            "library_note": no_lib if "fwd" in name else
            "no PyTorch call computes an SSD scan's gradient",
            "shape": "B={} H={} S={} P={} N={} Q={} bf16 xdt/B/C{}, f32 a, "
                     "mamba2's decays".format(*shape, "/dy" if "bwd" in name
                                              else "")})
    del zbwd_set, zs_out, zssd_bwd_args, zs_args, zpargs, zdargs, zkc, zvc
    torch.cuda.empty_cache()

    # -- 3c. phi4:K1 -- K1 at phi4-mini's shapes (G = 3, D = 128: shapes no
    # earlier phase ran), before any phi4 model phase: decode over its
    # 512-slot cache on split_decode (3 of the 16 rows of an MMA tile) at
    # kv_lens around tile edges and the serving path's last (384); causal
    # prefill at S = 256 on mma's group kernel (4 key tiles, the most it
    # holds at D = 128; 2 B Hkv = 256 CTAs >= the SMs).  Device times as
    # the other rows', warm and L2-cold, with SDPA beside each
    pcfg = get_config(PHI4)
    pH, pHkv, pD = pcfg.num_heads, pcfg.num_kv_heads, pcfg.head_dim
    p_n = PROMPT + DECODE
    p_kv = torch.tensor(p_n, dtype=torch.int32, device=dev)
    pkc, pvc = (rand((BATCH, CACHE, pHkv, pD), bf16) for _ in range(2))
    pdargs = (rand((BATCH, 1, pH, pD), bf16).transpose(1, 2),
              pkc.transpose(1, 2), pvc.transpose(1, 2))
    p_err = {"decode_all": 0.0}
    paths0 = dict(case_paths)
    for n_ in (1, 63, 64, 65, 200, CACHE, p_n):
        _, p_err["decode"] = k1_case(
            *pdargs, f"phi4 decode {BATCH}x{pH}x{pHkv} D={pD} kv_len {n_}",
            causal=False,
            kv_len=torch.tensor(n_, dtype=torch.int32, device=dev))
        p_err["decode_all"] = max(p_err["decode_all"], p_err["decode"])
    ppargs = tuple(rand((BATCH, PROMPT, h_, pD), bf16).transpose(1, 2)
                   for h_ in (pH, pHkv, pHkv))
    _, p_err["prefill"] = k1_case(
        *ppargs, f"phi4 prefill {BATCH}x{pH}x{pHkv} S={PROMPT} D={pD}",
        mma_kernel="group", causal=True)
    p_paths = {k_: case_paths[k_] - paths0[k_] for k_ in case_paths}
    if p_paths != {"fma": 0, "mma": 1, "split_decode": 7}:
        fail(f"phi4 K1 cases took paths {p_paths}")
    p_lib_dec = lambda: F.scaled_dot_product_attention(
        pdargs[0], pdargs[1][:, :, :p_n], pdargs[2][:, :, :p_n],
        enable_gqa=True)
    p_k1_dec = lambda: ops.flash_attention(*pdargs, causal=False,
                                           kv_len=p_kv)
    p_k1_pre = lambda: ops.flash_attention(*ppargs, causal=True)
    p_lib_pre = lambda: F.scaled_dot_product_attention(
        *ppargs, is_causal=True, enable_gqa=True)
    # L2-cold: 4 copies of decode's 33.6 MB and of prefill's 67 MB (output
    # included) rotate through more than the 50 MB of L2
    p_cold_dec = [tuple(t.clone() for t in pdargs) for _ in range(4)]
    p_cold_pre = [tuple(t.clone() for t in ppargs) for _ in range(4)]
    p_ms = {
        "K1 decode": device_ms(p_k1_dec, "phi4 K1 decode"),
        "SDPA decode": device_ms(p_lib_dec, "phi4 SDPA decode"),
        "K1 decode cold": device_ms(cold(
            lambda q_, k_, v_: ops.flash_attention(
                q_, k_, v_, causal=False, kv_len=p_kv), p_cold_dec),
            "phi4 K1 decode, L2-cold", iters=24),
        "SDPA decode cold": device_ms(cold(
            lambda q_, k_, v_: F.scaled_dot_product_attention(
                q_, k_[:, :, :p_n], v_[:, :, :p_n], enable_gqa=True),
            p_cold_dec), "phi4 SDPA decode, L2-cold", iters=24),
        "K1 prefill": device_ms(p_k1_pre, "phi4 K1 prefill"),
        "SDPA prefill": device_ms(p_lib_pre, "phi4 SDPA prefill"),
        "K1 prefill cold": device_ms(cold(
            lambda q_, k_, v_: ops.flash_attention(q_, k_, v_, causal=True),
            p_cold_pre), "phi4 K1 prefill, L2-cold"),
        "SDPA prefill cold": device_ms(cold(
            lambda q_, k_, v_: F.scaled_dot_product_attention(
                q_, k_, v_, is_causal=True, enable_gqa=True), p_cold_pre),
            "phi4 SDPA prefill, L2-cold")}
    del p_cold_dec, p_cold_pre
    # bounds as the granite rows': q, k and v (the kv_len keys) read and
    # the output written once in bf16; the work is QK^T and PV over the
    # keys each row sees
    pb_dec = bound_ms(2 * (2 * BATCH * pH * pD + 2 * BATCH * pHkv * p_n * pD),
                      4 * BATCH * pH * p_n * pD, "bfloat16")
    pb_pre = bound_ms(2 * (2 * BATCH * PROMPT * pH * pD
                           + 2 * BATCH * PROMPT * pHkv * pD),
                      4 * BATCH * pH * pD * (PROMPT * (PROMPT + 1) // 2),
                      "bfloat16")
    p_rows = []
    for name, path, err, fn, key, plain, b_, lib, lkey, shape in (
        ("flash_attention_fwd (phi4 decode, G=3, D=128)", "split_decode",
         p_err["decode"], p_k1_dec, "K1 decode",
         (lambda: attention_reference(*pdargs, causal=False, kv_len=p_kv),
          20), pb_dec, p_lib_dec, "SDPA decode",
         f"B={BATCH} H={pH} Hkv={pHkv} D={pD} kv_len={p_n} of {CACHE} bf16"),
        ("flash_attention_fwd (phi4 prefill, causal)", "mma",
         p_err["prefill"], p_k1_pre, "K1 prefill",
         (lambda: attention_reference(*ppargs, causal=True), 10), pb_pre,
         p_lib_pre, "SDPA prefill",
         f"B={BATCH} H={pH} Hkv={pHkv} D={pD} Sq=Sk={PROMPT} bf16, the "
         "group kernel")):
        p_rows.append({
            "name": name, "route": "cuda", "source": attn_src,
            "replaces": "src/repro/kernels/flash_attention.py:73",
            "path": path, "max_abs_err": err,
            "ms": time_ms(fn), "device_ms": p_ms[key],
            "device_ms_cold": p_ms[f"{key} cold"],
            "plain_ms": time_ms(plain[0], iters=plain[1], warmup=1),
            "bound_ms": b_[0], "bound_by": b_[1],
            "library_ms": time_ms(lib), "library_device_ms": p_ms[lkey],
            "library_device_ms_cold": p_ms[f"{lkey} cold"], "shape": shape})
    p_rows[0]["host_us"] = host_us(p_k1_dec)
    phase("phi4:K1", cases=sum(p_paths.values()),
          paths=json.dumps(p_paths, separators=(",", ":")),
          decode_err=f"{p_err['decode_all']:.3e}",
          prefill_err=f"{p_err['prefill']:.3e}",
          prefill_mma_kernel="group",
          tol=TOL["bfloat16"],
          **{k_.replace(" ", "_") + "_device_ms": f"{v_:.6f}"
             for k_, v_ in p_ms.items()},
          bound_ms=f"{pb_dec[0]:.4f},{pb_pre[0]:.4f}")
    del pkc, pvc, pdargs, ppargs
    torch.cuda.empty_cache()
    mark("phi4_K1")

    def serve_runs(c, tag, k1_per_step):
        """The serving path of ``c``: ``decode_demo`` at the serving
        schedule without and with resizes, kernel counts zeroed just before
        each run and read just after.  Each run must launch K1
        ``k1_per_step`` times a decode step, all on split_decode, and K3
        never (an SSM decode step is the recurrence); both must give the
        same tokens.  Returns the runs and one run's K1 launches."""
        runs = {}
        want = k1_per_step * (PROMPT + DECODE)
        for label, schedule in (("static", None), ("elastic", SCHEDULE)):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            ops.reset_counts()
            out = decode_demo(c, batch=BATCH, prompt_len=PROMPT,
                              decode_steps=DECODE, cache_len=CACHE,
                              workers=WORKERS, device=dev,
                              schedule=schedule, seed=0)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            paths = dict(fa.flash_attention.path_launches)
            if counts["flash_attention"] != want or counts["ssd_scan"] or \
                    paths != {"fma": 0, "mma": 0, "split_decode": want}:
                fail(f"{tag} {label} run launched {counts} (K1 paths "
                     f"{paths}), not K1 {want} times on split_decode and "
                     "no K3")
            toks = out["tokens"]
            if toks.shape != (BATCH, DECODE) or toks.min() < 0 or \
                    toks.max() >= c.vocab_size:
                fail(f"{tag} {label} run: tokens of shape {toks.shape} in "
                     f"[{toks.min()}, {toks.max()}]")
            runs[label] = out
            phase(f"{tag}:{label}", layers=c.num_layers,
                  prefill_s=f"{out['prefill_s']:.3f}",
                  decode_ms_per_token=f"{out['decode_s'] / DECODE * 1e3:.3f}",
                  k1_launches=counts["flash_attention"],
                  path_launches=json.dumps(paths, separators=(",", ":")),
                  peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
                  sizes=json.dumps(out["sizes"], separators=(",", ":")))
            for ev in out["events"]:
                phase(f"{tag}:{label}:resize", step=ev.step,
                      action=ev.action,
                      sizes=f"{ev.from_procs}->{ev.to_procs}",
                      bytes_moved=ev.transfer.bytes_moved,
                      seconds=f"{ev.transfer.seconds:.4f}")
        if not np.array_equal(runs["static"]["tokens"],
                              runs["elastic"]["tokens"]):
            fail(f"{tag}: tokens differ between the static and the elastic "
                 "run")
        actions = [e.action for e in runs["elastic"]["events"]]
        if actions != ["expand", "shrink"]:
            fail(f"{tag} resize actions {actions}")
        phase(tag, tokens_equal=True, actions=",".join(actions))
        return runs, want

    # -- 6. the granite serving path ----------------------------------------
    runs, granite_decode_launches = serve_runs(cfg, "path", cfg.num_layers)
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
    # at MAMBA_SERVE_LAYERS of its 48 layers (training runs all 48)
    mvcfg = dataclasses.replace(get_config(MAMBA),
                                num_layers=MAMBA_SERVE_LAYERS)
    serve_runs(mvcfg, "mamba2", 0)
    mark("mamba2_path")

    def prefill_launches(c, params, batch, tag, want, mma_kernels):
        """One ``make_prefill_step``, the kernel counts zeroed just before
        and read just after; ``want`` maps K1 and K3 to their launches by
        path, ``mma_kernels`` K1's mma launches to their kernel (block or
        group) as its C entry point counts them.  Returns K1's and K3's
        launches."""
        with torch.no_grad():
            torch.cuda.synchronize()
            ops.reset_counts()
            t0 = time.perf_counter()
            first = make_prefill_step(c)(params, batch)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        paths = {k_: dict(ops.KERNELS[k_].path_launches) for k_ in want}
        kern = fa.mma_kernel_launches()
        if paths != want or any(counts[k_] != sum(v.values())
                                for k_, v in want.items()) or \
                kern != mma_kernels:
            fail(f"{tag} prefill launched {counts} on paths {paths}, mma "
                 f"kernels {kern}, not {want}, {mma_kernels}")
        phase(f"{tag}:prefill", layers=c.num_layers, batch=BATCH,
              seq=batch["tokens"].shape[1], prefill_s=f"{secs:.3f}",
              launches=json.dumps({k_: counts[k_] for k_ in want},
                                  separators=(",", ":")),
              path_launches=json.dumps(paths, separators=(",", ":")),
              k1_mma_kernels=json.dumps(kern, separators=(",", ":")),
              first_tokens=",".join(map(str, first[:4].tolist())))
        return {k_: counts[k_] for k_ in want}

    def max_rms(a, b):
        d = (a - b).abs()
        return d.max().item(), d.square().mean().sqrt().item()

    def logits_check(c, params, prompts, tag, fp32_tol, bf16_tol):
        """Prefill against token-by-token decode after the same prompts:
        fp32 full-sequence logits at every position against the fp32
        decode's (``fp32_tol``: bounds of the largest and the rms gap, the
        rms unchecked when None), and the bf16 prefill's and decode's last
        logits against fp32 (``bf16_tol``: the largest and the rms gap),
        beside the fp32 model with its weights rounded to bf16, the
        yardstick of how far bf16 rounding alone moves them.  Returns the
        fp32 decode's last logits and the bf16 decode's cache."""
        V, S = c.vocab_size, prompts.shape[1]
        batch = {"tokens": prompts}
        c32 = dataclasses.replace(c, dtype="float32")

        def decode_logits(cc, full=None):
            cache = M.init_cache(cc, BATCH, S, device=dev)
            mx = sq = torch.zeros((), device=dev)
            for i in range(S):
                logits, cache = M.decode_step(
                    params, cc, prompts[:, i:i + 1], cache,
                    torch.tensor(i, dtype=torch.int32, device=dev))
                if full is not None:
                    d_ = (logits[:, -1, :V].float() - full[:, i]).abs()
                    mx = torch.maximum(mx, d_.max())
                    sq = sq + d_.square().mean() / S
            return (logits[:, -1, :V].float(), mx.item(), sq.sqrt().item(),
                    cache)

        with torch.no_grad():
            lp = prefill_logits(params, c, batch)[:, :V].float()
            full32 = M.forward(params, c32, batch)[0][..., :V]
            lp32 = prefill_logits(params, c32, batch)[:, :V].float()
            rounded = T.tree_map(lambda t: t.bfloat16().float(), params)
            lp32w = prefill_logits(rounded, c32, batch)[:, :V].float()
            del rounded
            ld32, gap_all, rms_all, _ = decode_logits(c32, full32)
            del full32
            ld, _, _, cache = decode_logits(c)
        if not all(bool(torch.isfinite(t).all()) for t in (lp, ld, lp32,
                                                            ld32)):
            fail(f"{tag} logits are not finite")
        gap32 = (lp32 - ld32).abs().max().item()
        err_p, rms_p = max_rms(lp, lp32)
        err_d, rms_d = max_rms(ld, ld32)
        err_w, rms_w = max_rms(lp32w, lp32)
        agree = (lp.argmax(-1) == ld.argmax(-1)).float().mean().item()
        phase(f"{tag}:logits", layers=c.num_layers, batch=BATCH, seq=S,
              fp32_prefill_vs_decode=f"{gap32:.4e}",
              fp32_all_positions=f"{gap_all:.4e}",
              fp32_all_positions_rms=f"{rms_all:.4e}",
              fp32_tol=",".join(map(str, fp32_tol)),
              bf16_prefill_vs_fp32=f"{err_p:.4e}",
              bf16_decode_vs_fp32=f"{err_d:.4e}",
              bf16_rms=f"{rms_p:.4e},{rms_d:.4e}",
              fp32_bf16_weights=f"{err_w:.4e}",
              fp32_bf16_weights_rms=f"{rms_w:.4e}",
              bf16_tol=",".join(map(str, bf16_tol)),
              logits_std=f"{lp32.std().item():.3f}",
              bf16_prefill_vs_decode_argmax_agreement=f"{agree:.3f}")
        if max(gap32, gap_all) > fp32_tol[0] or \
                (fp32_tol[1] is not None and rms_all > fp32_tol[1]):
            fail(f"{tag} fp32 prefill vs decode logits differ by "
                 f"{max(gap32, gap_all):.3e} (rms {rms_all:.3e}) > "
                 f"{fp32_tol}")
        if max(err_p, err_d) > bf16_tol[0] or max(rms_p, rms_d) > bf16_tol[1]:
            fail(f"{tag} bf16 logits off the fp32 ones by "
                 f"{max(err_p, err_d):.3e} (rms {max(rms_p, rms_d):.3e}) > "
                 f"{bf16_tol}")
        return ld32, cache

    def planted_faults(c, params, prompts, tag, ld32, cache, bf16_tol):
        """Faults planted in the bf16 decode's last step of a dense model,
        each read against ``ld32`` (the fp32 decode's last logits) by
        ``logits_check``'s bf16 measure, the largest and the rms gap, which
        ``bf16_tol`` must reject: the step at the position before its own
        (its K/V written over the previous token's row, its rotary phase
        one back), and the cached rows of KV heads 0 and 1 swapped in every
        layer.  Beside them the same step replayed unfaulted, which must
        pass.  ``cache`` is the bf16 decode's (every row filled); it is
        altered."""
        V, S = c.vocab_size, prompts.shape[1]
        tok, kv = prompts[:, S - 1:S], cache["layers"]
        pos = lambda i: torch.tensor(i, dtype=torch.int32, device=dev)
        last = lambda cache_, i: M.decode_step(
            params, c, tok, cache_, pos(i))[0][:, -1, :V].float()
        copy = lambda: {"layers": {k_: t.clone() for k_, t in kv.items()}}
        with torch.no_grad():
            reads = {"replay": max_rms(last(copy(), S - 1), ld32),
                     "position_one_back": max_rms(last(copy(), S - 2), ld32)}
            for k_ in ("k", "v"):
                kv[k_][:, :, :S - 1, [0, 1]] = kv[k_][:, :, :S - 1, [1, 0]]
            reads["kv_heads_swapped"] = max_rms(last(cache, S - 1), ld32)
        phase(f"{tag}:faults", step=S - 1, bf16_tol=",".join(
                  map(str, bf16_tol)),
              **{k_: f"{m_:.4e},rms={r_:.4e}"
                 for k_, (m_, r_) in reads.items()})
        caught = {k_: m_ > bf16_tol[0] or r_ > bf16_tol[1]
                  for k_, (m_, r_) in reads.items()}
        if caught != {k_: k_ != "replay" for k_ in reads}:
            fail(f"{tag}: the bf16 bound {bf16_tol} rejects {caught} of the "
                 f"replayed and faulted last steps, read {reads}")

    def traced_prefill(c, params, batch, tag, names):
        """One untraced, then one traced ``make_prefill_step``: device busy
        time, idle share, each of ``names``' kernels' device ms and share
        (each must show), the largest device kernels."""
        with torch.no_grad():
            t0 = time.perf_counter()
            make_prefill_step(c)(params, batch)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                make_prefill_step(c)(params, batch)
                torch.cuda.synchronize()
                traced_s = time.perf_counter() - t0
        evs = device_events(prof)
        busy = sum(device_us(e) for e in evs) / 1e3
        fields = {}
        for k_, test in names.items():
            ms_ = sum(device_us(e) for e in evs if test(e.key)) / 1e3
            if busy <= 0 or ms_ <= 0:
                fail(f"the profiler saw no device time (or no {k_}) in the "
                     f"traced {tag} prefill")
            fields[f"{k_}_ms"] = f"{ms_:.3f}"
            fields[f"{k_}_share_of_device"] = f"{ms_ / busy:.4f}"
        top = [{"kernel": e.key[:80], "ms": device_us(e) / 1e3,
                "calls": e.count} for e in evs[:PROFILE_TOP]]
        phase(f"{tag}:profile", untraced_prefill_s=f"{wall_s:.3f}",
              traced_prefill_s=f"{traced_s:.3f}",
              traced_device_busy_ms=f"{busy:.3f}",
              traced_idle_share=f"{1 - busy / (traced_s * 1e3):.4f}",
              **fields, top=json.dumps(top, separators=(",", ":")))

    # device records of K1's and K3's forward and backward kernels
    is_k1_fwd = lambda k_: "attn_" in k_ and "attn_bwd" not in k_
    is_k1_bwd = lambda k_: "attn_bwd" in k_
    is_k3_fwd = lambda k_: "ssd_scan" in k_
    is_k3_bwd = lambda k_: "ssd_bwd" in k_
    no_k1 = {"fma": 0, "mma": 0, "split_decode": 0}

    # -- 10. mamba2 prefill vs decode, and where the prefill's time goes ----
    torch.cuda.empty_cache()
    mparams = M.init_params(mvcfg, torch.Generator(dev).manual_seed(0), dev)
    mprompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, mvcfg.vocab_size, (BATCH, M_PREFILL_S), dtype=np.int32)).to(dev)
    k3_prefill = prefill_launches(
        mvcfg, mparams, {"tokens": mprompts}, "mamba2",
        {"ssd_scan": {"fma": 0, "wgmma": mvcfg.num_layers},
         "flash_attention": no_k1},
        {"block": 0, "group": 0})["ssd_scan"]
    logits_check(mvcfg, mparams, mprompts, "mamba2",
                 (M_FP32_LOGITS_ATOL, None),
                 (M_BF16_LOGITS_MAX, M_BF16_LOGITS_RMS))
    traced_prefill(mvcfg, mparams, {"tokens": mprompts}, "mamba2",
                   {"k3": is_k3_fwd})
    del mparams
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
        if c.is_ssm or c.is_hybrid:
            # K3 forward on wgmma, its backward; the hybrid's shared block
            # runs K1 once per group (twice under remat) and its backward
            g = L // c.shared_attention_every if c.is_hybrid else 0
            want = {"flash_attention": 2 * g * steps,
                    "flash_attention_bwd": g * steps,
                    "ssd_scan": fwd, "ssd_scan_bwd": bwd}
            want_paths = {"ssd_scan": {"fma": 0, "wgmma": fwd},
                          "ssd_scan_bwd": {"fma": 0, "wgmma": bwd},
                          "flash_attention": {"fma": 0, "mma": 2 * g * steps,
                                              "split_decode": 0},
                          "flash_attention_bwd": {"fma": 0,
                                                  "wgmma": g * steps}}
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

    def elastic_pair(c, tag):
        """``TRAIN_STEPS`` static and elastic (``TRAIN_SCHEDULE``) steps of
        ``c``, whose losses must agree to ``TRAIN_LOSS_TOL``.  Returns the
        static run's runner, state and kernel counts."""
        out = {}
        for label, schedule in (("static", {}), ("elastic", TRAIN_SCHEDULE)):
            runner, state, losses, secs, counts = train_run(c, schedule,
                                                            TRAIN_STEPS)
            phase(f"{tag}:{label}", layers=c.num_layers,
                  batch=TRAIN_BATCH, seq=tshape.seq_len,
                  losses=",".join(f"{x:.6f}" for x in losses),
                  step_s=",".join(f"{x:.3f}" for x in secs),
                  s_per_step=f"{step_s(secs):.4f}",
                  tokens_per_s=f"{tokens_per_step / step_s(secs):.0f}",
                  per_step=json.dumps({k_: counts[k_] / TRAIN_STEPS for k_ in
                                       counts["paths"]},
                                      separators=(",", ":")),
                  paths=json.dumps(counts["paths"], separators=(",", ":")),
                  peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
                  sizes=",".join(str(e.to_procs) for e in runner.events))
            for ev in runner.events:
                phase(f"{tag}:{label}:resize", step=ev.step,
                      action=ev.action,
                      sizes=f"{ev.from_procs}->{ev.to_procs}",
                      bytes_moved=ev.transfer.bytes_moved,
                      seconds=f"{ev.transfer.seconds:.4f}")
            out[label] = (runner, state if label == "static" else None,
                          losses, counts)
            del state
        static_l, elastic_l = out["static"][2], out["elastic"][2]
        gap_ = max(abs(a - b) for a, b in zip(static_l, elastic_l))
        actions = [e.action for e in out["elastic"][0].events]
        if gap_ > TRAIN_LOSS_TOL or actions != ["expand", "shrink"]:
            fail(f"{tag} elastic training: losses {elastic_l} vs static "
                 f"{static_l} (gap {gap_:.3e} > {TRAIN_LOSS_TOL}?), actions "
                 f"{actions}")
        runner, state, _, counts = out["static"]
        phase(tag, elastic_vs_static_max_gap=f"{gap_:.3e}",
              tol=TRAIN_LOSS_TOL, actions=",".join(actions),
              state_gb=f"{sum(t.nbytes for t in T.leaves(state)) / 1e9:.2f}")
        return runner, state, counts

    def traced_step(runner, state, step, want):
        """One traced ``runner.step``, taken again (four times at most)
        while the profiler dropped a record: ``want`` maps a name to a test
        on a device record's key and the records a step launches.  Returns
        the state, the phase fields (device busy, idle share, each name's
        device ms and share, the largest operators) and each name's
        records."""
        for attempt in range(4):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                state, m = runner.step(state, step + attempt)
                float(m["loss"])
                torch.cuda.synchronize()
                traced_s = time.perf_counter() - t0
            evs = device_events(prof)
            recs = {k_: [e for e in evs if test(e.key)]
                    for k_, (test, _) in want.items()}
            got = {k_: sum(e.count for e in r) for k_, r in recs.items()}
            if got == {k_: n_ for k_, (_, n_) in want.items()}:
                break
            print(f"chip_smoke: traced train step: the profiler kept {got} "
                  "records: taken again", file=sys.stderr, flush=True)
        else:
            fail(f"the profiler dropped records of {list(want)} in four "
                 "traced train steps")
        busy = sum(device_us(e) for e in evs) / 1e3
        fields = dict(traced_step_s=f"{traced_s:.4f}",
                      device_busy_ms=f"{busy:.3f}",
                      idle_share=f"{1 - busy / (traced_s * 1e3):.4f}")
        for k_, r in recs.items():
            ms_ = sum(device_us(e) for e in r) / 1e3
            fields[f"{k_}_ms"] = f"{ms_:.3f}"
            fields[f"{k_}_share"] = f"{ms_ / busy:.4f}"
        fields["top"] = json.dumps(
            [{"kernel": e.key[:80], "ms": device_us(e) / 1e3,
              "calls": e.count} for e in evs[:PROFILE_TRAIN_TOP]],
            separators=(",", ":"))
        return state, fields, recs

    runner, state, counts = elastic_pair(cfg, "train")
    train_launches = counts["flash_attention_bwd"]
    train_fwd_launches = counts["flash_attention"]
    mark("train")

    # -- 12. one traced training step of the static run ----------------------
    L = cfg.num_layers
    state, fields, _ = traced_step(runner, state, TRAIN_STEPS, {
        "k1_fwd": (is_k1_fwd, 2 * L), "k1_bwd": (is_k1_bwd, 3 * L)})
    phase("train:profile", layers=L, **fields)
    del runner, state
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
    mcfg = get_config(MAMBA)
    runner, state, counts = elastic_pair(mcfg, "mamba2:train")
    m_train_fwd_launches = counts["ssd_scan"]
    m_train_bwd_launches = counts["ssd_scan_bwd"]
    mark("mamba2_train")

    # -- 13d. one traced 48-layer mamba2 training step -----------------------
    L = mcfg.num_layers
    state, fields, recs = traced_step(runner, state, TRAIN_STEPS, {
        "k3_fwd": (is_k3_fwd, 2 * L),
        "k3_bwd": (is_k3_bwd, ss.BWD_KERNELS["wgmma"] * L)})
    phase("mamba2:train:profile", layers=L, **fields,
          k3_bwd_ms_by_kernel=json.dumps(
              {re.search(r"ssd_bwd_(\w+?)_kernel", e.key)[1]: round(
                  device_us(e) / 1e3, 3) for e in recs["k3_bwd"]},
              separators=(",", ":")))
    del runner, state
    torch.cuda.empty_cache()
    mark("mamba2_train_profile")

    # -- 13e. the zamba2 serving path ----------------------------------------
    zscfg = dataclasses.replace(zcfg, num_layers=Z_SERVE_LAYERS)
    zgroups = zscfg.num_layers // zscfg.shared_attention_every
    _, z_dec_launches = serve_runs(zscfg, "zamba2", zgroups)
    mark("zamba2_path")

    # -- 13f. zamba2 prefill vs decode, and where the prefill's time goes ----
    torch.cuda.empty_cache()
    zparams = M.init_params(zscfg, torch.Generator(dev).manual_seed(0), dev)
    zprompts = torch.from_numpy(np.random.default_rng(2).integers(
        0, zscfg.vocab_size, (BATCH, M_PREFILL_S), dtype=np.int32)).to(dev)
    z_prefill = prefill_launches(
        zscfg, zparams, {"tokens": zprompts}, "zamba2",
        {"ssd_scan": {"fma": 0, "wgmma": zscfg.num_layers},
         "flash_attention": dict(no_k1, mma=zgroups)},
        {"block": zgroups, "group": 0})
    # the logits checks run the first Z_CHECK_LAYERS layers of these weights
    logits_check(dataclasses.replace(zscfg, num_layers=Z_CHECK_LAYERS),
                 dict(zparams, layers=T.tree_map(
                     lambda t: t[:Z_CHECK_LAYERS], zparams["layers"])),
                 zprompts, "zamba2", (Z_FP32_LOGITS_ATOL, Z_FP32_LOGITS_RMS),
                 (Z_BF16_LOGITS_MAX, Z_BF16_LOGITS_RMS))
    traced_prefill(zscfg, zparams, {"tokens": zprompts}, "zamba2",
                   {"k3": is_k3_fwd, "k1": is_k1_fwd})
    del zparams
    torch.cuda.empty_cache()
    mark("zamba2_prefill")

    # -- 13g. zamba2 training: the smoke step (two groups), card vs CPU, and
    # the elastic run at Z_ELASTIC_LAYERS --------------------------------------
    zsm = dataclasses.replace(get_config(f"{ZAMBA}-smoke"), num_layers=4)
    zsm_groups = zsm.num_layers // zsm.shared_attention_every
    zsbatch = lm_train_app(zsm, dataclasses.replace(
        get_shape("smoke"), global_batch=8)).dataset.batch_at(0)
    zsmoke = {}
    for d in ("cpu", dev):
        tb = {k_: torch.from_numpy(v_).to(d) for k_, v_ in zsbatch.items()}
        st = T.tree_map(lambda t: t.to(d), init_state(zsm, sopt, 0))
        ops.reset_counts()
        _, m = make_train_step(zsm, sopt)(st, tb)
        n_ = ops.launch_counts()
        st = T.tree_map(lambda t: t.to(d), init_state(zsm, sopt, 0))
        flat = T.flatten(st.params)
        leaves = [p_.detach().requires_grad_() for _, p_ in flat]
        loss, _ = loss_fn(T.unflatten(st.params, leaves), zsm, tb)
        grads = torch.autograd.grad(loss, leaves)
        zsmoke[str(d)] = (float(m["loss"]), float(m["grad_norm"]), n_,
                          {k_: g_.cpu() for (k_, _), g_ in zip(flat, grads)})
    (l_c, g_c, n_c, gr_c), (l_g, g_g, n_g, gr_g) = \
        zsmoke["cpu"], zsmoke[str(dev)]
    z_leaf_err = {k_: ((gr_g[k_] - e_).abs().max() / e_.abs().max()).item()
                  for k_, e_ in gr_c.items()}
    worst = max(z_leaf_err, key=z_leaf_err.get)
    shared_err = max(v_ for k_, v_ in z_leaf_err.items()
                     if k_.startswith("shared_attn/"))
    if not z_leaf_err[worst] <= SSM_LEAF_TOL or \
            sum(k_.startswith("shared_attn/") for k_ in z_leaf_err) != 9:
        fail(f"zamba2 smoke step: the card's gradient of {worst} is "
             f"{z_leaf_err[worst]:.3e} of its largest entry off the CPU's "
             f"(> {SSM_LEAF_TOL})")
    want_n = {"ssd_scan": zsm.num_layers, "ssd_scan_bwd": zsm.num_layers,
              "flash_attention": zsm_groups, "flash_attention_bwd": zsm_groups}
    if any(n_c.values()) or {k_: n_g[k_] for k_ in want_n} != want_n:
        fail(f"zamba2 smoke train step launched {n_g} on the card, {n_c} "
             f"on the CPU, not {want_n}")
    if abs(l_g - l_c) > 1e-5 * abs(l_c) or abs(g_g - g_c) > 1e-4 * abs(g_c):
        fail(f"zamba2 smoke train step: card loss {l_g} / grad norm {g_g} "
             f"vs CPU {l_c} / {g_c}")
    phase("zamba2:train:smoke", layers=zsm.num_layers, groups=zsm_groups,
          loss_card=f"{l_g:.7f}", loss_cpu=f"{l_c:.7f}",
          grad_norm_card=f"{g_g:.6f}", grad_norm_cpu=f"{g_c:.6f}",
          launches=json.dumps({k_: n_g[k_] for k_ in want_n},
                              separators=(",", ":")),
          leaves=len(z_leaf_err), worst_leaf=worst,
          worst_leaf_err=f"{z_leaf_err[worst]:.3e}",
          shared_attn_worst_err=f"{shared_err:.3e}",
          leaf_tol=SSM_LEAF_TOL)

    zecfg = dataclasses.replace(zcfg, num_layers=Z_ELASTIC_LAYERS)
    runner, state, _ = elastic_pair(zecfg, "zamba2:train")
    del runner, state
    mark("zamba2_train")

    # -- 13h. zamba2 training at all 54 layers, and one traced step ----------
    runner, state, losses, secs, counts = train_run(zcfg, {}, DEPTH_STEPS)
    z_train_k1 = (counts["flash_attention"], counts["flash_attention_bwd"])
    z_train_k3 = (counts["ssd_scan"], counts["ssd_scan_bwd"])
    phase("zamba2:train:depth", layers=zcfg.num_layers,
          losses=",".join(f"{x:.6f}" for x in losses),
          step_s=",".join(f"{x:.3f}" for x in secs),
          s_per_step=f"{step_s(secs):.4f}",
          tokens_per_s=f"{tokens_per_step / step_s(secs):.0f}",
          per_step=json.dumps({k_: counts[k_] / DEPTH_STEPS for k_ in
                               counts["paths"]}, separators=(",", ":")),
          paths=json.dumps(counts["paths"], separators=(",", ":")),
          state_gb=f"{sum(t.nbytes for t in T.leaves(state)) / 1e9:.2f}",
          peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    L, G_ = zcfg.num_layers, zcfg.num_layers // zcfg.shared_attention_every
    state, fields, _ = traced_step(runner, state, DEPTH_STEPS, {
        "k3_fwd": (is_k3_fwd, 2 * L),
        "k3_bwd": (is_k3_bwd, ss.BWD_KERNELS["wgmma"] * L),
        "k1_fwd": (is_k1_fwd, 2 * G_), "k1_bwd": (is_k1_bwd, 3 * G_)})
    phase("zamba2:train:profile", layers=L, **fields)
    del runner, state
    torch.cuda.empty_cache()
    mark("zamba2_train_depth")

    # -- 14. the paper's live grid on toy tenants ---------------------------
    from repro_torch.rms import materialize_live

    def live_grid(device):
        """Phase 14's grid on WORKERS workers of ``device``, each
        configuration under both engines with the sanitizer on; the engines
        must agree.  Returns, by label, what both packages' tests compare
        (summary but ``wall_s``, records, resize events, trail), the event
        engine's wall seconds and every tenant's final state (``x`` on the
        CPU, ``i``), which must have taken each of the job's steps."""
        homes = set()

        def factory_into(finals):
            def factory(spec):
                app = dmr.default_app_factory(spec)

                def init(mesh):
                    state = app.init_state(mesh)
                    homes.update(str(t.device) for t in T.leaves(state))
                    return state

                def step(mesh):
                    f = app.make_step(mesh)

                    def g(state, i, *a):
                        state, metrics = f(state, i, *a)
                        finals[spec.jid] = state
                        return state, metrics
                    return g
                return dmr.App(init=init, shardings=app.state_shardings,
                               step=step, name=app.name)
            return factory

        out = {}
        for label, policy, mode, malleable, decisions in LIVE_GRID:
            specs = materialize_live(
                "steady", n_jobs=LIVE_JOBS, max_steps=LIVE_STEPS,
                device_count=LIVE_DEVICE_COUNT, mode=mode,
                malleable=malleable, seed=0, arrival_span=LIVE_SPAN)
            seen = []
            for engine in (dmr.Cluster, dmr.ReferenceCluster):
                finals = {}
                cl = engine(specs, logical_workers(WORKERS, device),
                            policy=policy, decisions=decisions,
                            app_factory=factory_into(finals), sanitize=True)
                res = cl.run()
                if decisions == "cosim":
                    cl.crosscheck(res)              # raises on divergence
                s = res.summary()
                wall = s.pop("wall_s")
                states = {j: (st["x"].cpu(), int(st["i"]))
                          for j, st in sorted(finals.items())}
                short = {sp.jid: (states.get(sp.jid, (None, -1))[1],
                                  sp.steps) for sp in specs
                         if states.get(sp.jid, (None, -1))[1] != sp.steps}
                if short:
                    fail(f"live grid {label} on {device}: tenants whose "
                         f"state did not take every step (i, steps): "
                         f"{short}")
                seen.append(((s, [(r.jid, r.start_tick, r.end_tick,
                                   r.start_procs, r.final_procs,
                                   tuple(r.resizes)) for r in res.records],
                              {j: [(e.step, e.action, e.from_procs,
                                    e.to_procs, e.transfer.bytes_moved)
                                   for e in ev]
                               for j, ev in res.events_by_jid.items()},
                              cl.trail), wall, states))
            if seen[0][0] != seen[1][0]:
                fail(f"live grid {label} on {device}: Cluster and "
                     f"ReferenceCluster disagree: {seen[0][0][0]} vs "
                     f"{seen[1][0][0]}")
            if not same_states(seen[0][2], seen[1][2]):
                fail(f"live grid {label} on {device}: Cluster and "
                     f"ReferenceCluster leave different tenant states")
            out[label] = seen[0]
        if homes != {str(torch.device(device))}:
            fail(f"live grid on {device}: tenant state on {sorted(homes)}")
        return out

    def same_states(a, b):
        """Equal final tenant states: the same jobs, bit-equal ``x``,
        equal ``i``."""
        return a.keys() == b.keys() and all(
            torch.equal(a[j][0], b[j][0]) and a[j][1] == b[j][1] for j in a)

    ops.reset_counts()
    grid_card = live_grid(dev)
    grid_cpu = live_grid("cpu")
    for label, (obs, _, states) in grid_card.items():
        if obs != grid_cpu[label][0]:
            fail(f"live grid {label}: the card's run differs from the CPU "
                 f"workers' ({obs[0]} vs {grid_cpu[label][0][0]})")
        if not same_states(states, grid_cpu[label][2]):
            fail(f"live grid {label}: the tenants' final x or i on the "
                 f"card differ from the CPU workers'")
    base = grid_card["static/rigid"][0][0]
    for label, ((s, _, _, trail), wall, _) in grid_card.items():
        if label != "static/rigid" and \
                not s["throughput_jps"] > base["throughput_jps"]:
            fail(f"live grid {label}: {s['throughput_jps']} jobs/s does "
                 f"not beat static's {base['throughput_jps']}")
        phase(f"cluster:grid:{label}", makespan_ticks=int(s["makespan_s"]),
              jobs_per_s=f"{s['throughput_jps']:.5f}",
              alloc_rate_pct=f"{100 * s['alloc_rate']:.2f}",
              energy_kwh=f"{s['energy_kwh']:.6f}",
              energy_note="nominal idle_w=100 loaded_w=340 per worker on "
                          "the tick clock, not read from the card",
              n_resizes=s["n_resizes"], wall_s=f"{wall:.3f}",
              throughput_vs_static=f"{s['throughput_jps'] /
                                      base['throughput_jps']:.2f}",
              trail_events=len(trail))
    phase("cluster:grid", configs=len(grid_card), engines_agree=True,
          card_equals_cpu=True, states_equal=True, workers=WORKERS,
          device_count=LIVE_DEVICE_COUNT, jobs=LIVE_JOBS, steps=LIVE_STEPS,
          kernel_launches=sum(ops.launch_counts().values()))
    mark("cluster_grid")

    # -- 14b. real tenants: full-width mamba2-370m training in the cluster --
    ccfg = get_config(MAMBA)
    cshape = dataclasses.replace(get_shape(TRAIN_SHAPE),
                                 global_batch=TRAIN_BATCH,
                                 seq_len=CLUSTER_SEQ)
    cspecs = materialize_live("steady", n_jobs=CLUSTER_JOBS,
                              device_count=WORKERS, max_steps=CLUSTER_STEPS,
                              seed=0)
    spec_steps = {sp.jid: sp.steps for sp in cspecs}

    def lm_factory(losses, secs, homes):
        """Each tenant an lm_train_app seeded by its jid, its losses and
        step seconds recorded, its state's devices noted."""
        def factory(spec):
            app = lm_train_app(ccfg, cshape, AdamW(learning_rate=1e-3),
                               seed=spec.jid)

            def init(mesh):
                state = app.init_state(mesh)
                homes.update(str(t.device) for t in T.leaves(state))
                return state

            def step(mesh):
                fn = app.make_step(mesh)

                def run(state, i, *a):
                    t0 = time.perf_counter()
                    state, m = fn(state, i, *a)
                    losses.setdefault(spec.jid, []).append(float(m["loss"]))
                    secs.setdefault(spec.jid, []).append(
                        time.perf_counter() - t0)
                    return state, m
                return run
            return dmr.App(init=init, shardings=app.state_shardings,
                           step=step, name=app.name)
        return factory

    runs = {}
    for engine in (dmr.Cluster, dmr.ReferenceCluster):
        losses, secs, homes = {}, {}, set()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cl = engine(cspecs, logical_workers(WORKERS, dev),
                    policy="algorithm2",
                    app_factory=lm_factory(losses, secs, homes),
                    sanitize=True)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()   # earlier phases' tensors
        ops.reset_counts()
        res = cl.run()
        torch.cuda.synchronize()
        counts = dict(ops.launch_counts(), paths={
            k_: dict(ops.KERNELS[k_].path_launches)
            for k_ in ("ssd_scan", "ssd_scan_bwd")})
        peak = torch.cuda.max_memory_allocated()
        s = res.summary()
        wall = s.pop("wall_s")
        finished = [e[1] for e in cl.trail if e[0] == "finish"]
        n_steps = sum(spec_steps[j] for j in finished)
        L = ccfg.num_layers
        want = {"ssd_scan": 2 * L * n_steps, "ssd_scan_bwd": L * n_steps,
                "flash_attention": 0, "flash_attention_bwd": 0}
        want_paths = {"ssd_scan": {"fma": 0, "wgmma": 2 * L * n_steps},
                      "ssd_scan_bwd": {"fma": 0, "wgmma": L * n_steps}}
        if sorted(finished) != sorted(spec_steps) or \
                len(res.records) != CLUSTER_JOBS:
            fail(f"{engine.__name__}: jobs {sorted(finished)} finished of "
                 f"{sorted(spec_steps)}")
        if sum(len(v) for v in losses.values()) != n_steps or \
                any(len(losses[j]) != spec_steps[j] for j in spec_steps):
            fail(f"{engine.__name__}: tenant steps "
                 f"{ {j: len(v) for j, v in losses.items()} } vs the "
                 f"trail's {spec_steps}")
        if {k_: counts[k_] for k_ in want} != want or \
                counts["paths"] != want_paths:
            fail(f"{engine.__name__}: {n_steps} tenant steps launched "
                 f"{counts}, not {want} on {want_paths}")
        if homes != {str(dev)}:
            fail(f"{engine.__name__}: tenant state on {sorted(homes)}")
        if cl._sanitizer.violations:
            fail(f"{engine.__name__}: sanitizer {cl._sanitizer.violations}")
        if not all(np.isfinite(x) for v in losses.values() for x in v):
            fail(f"{engine.__name__}: losses {losses}")
        patterns = {k_ for ev in res.events_by_jid.values() for e in ev
                    for k_ in e.per_pattern}
        if res.n_resizes and patterns != {"default"}:
            fail(f"{engine.__name__}: resizes moved state by {patterns}")
        runs[engine.__name__] = dict(
            summary=s, wall=wall, trail=cl.trail, peak=peak, base=base,
            counts=counts,
            n_steps=n_steps, losses=losses, secs=secs,
            co_resident=max(res.timeline["running"]),
            records=[(r.jid, r.start_tick, r.end_tick, r.start_procs,
                      r.final_procs, tuple(r.resizes)) for r in res.records],
            events=res.events_by_jid)
        del cl, res
    ev_run, ref_run = runs["Cluster"], runs["ReferenceCluster"]
    for key in ("summary", "records", "trail"):
        if ev_run[key] != ref_run[key]:
            fail(f"mamba2 tenants: the engines' {key} differ: {ev_run[key]} "
                 f"vs {ref_run[key]}")
    if not ev_run["summary"]["n_resizes"]:
        fail("mamba2 tenants: the cluster made no resize")
    for jid, ev in sorted(ev_run["events"].items()):
        for e in ev:
            phase("cluster:mamba2:resize", jid=jid, step=e.step,
                  action=e.action, sizes=f"{e.from_procs}->{e.to_procs}",
                  bytes_moved=e.transfer.bytes_moved,
                  seconds=f"{e.transfer.seconds:.4f}")
    # the tenant with the most resizes against the same job run alone
    jid = max(sorted(ev_run["events"]),
              key=lambda j: len(ev_run["events"][j]))
    spec = next(sp for sp in cspecs if sp.jid == jid)
    torch.cuda.empty_cache()
    runner = dmr.MalleableRunner(
        lm_train_app(ccfg, cshape, AdamW(learning_rate=1e-3), seed=jid),
        spec.params, dmr.ScriptedRMS({}),
        devices=logical_workers(WORKERS, dev))
    state, static = runner.init(), []
    for i in range(spec.steps):
        state, m = runner.step(state, i)
        static.append(float(m["loss"]))
    # where a tenant step's time goes at S=1024: one traced step more
    L = ccfg.num_layers
    state, tfields, _ = traced_step(runner, state, spec.steps, {
        "k3_fwd": (is_k3_fwd, 2 * L),
        "k3_bwd": (is_k3_bwd, ss.BWD_KERNELS["wgmma"] * L)})
    phase("cluster:mamba2:profile", layers=L, seq=CLUSTER_SEQ, **tfields)
    del runner, state
    gap_ = max(abs(a - b) for a, b in zip(ev_run["losses"][jid], static))
    if len(static) != len(ev_run["losses"][jid]) or gap_ > TRAIN_LOSS_TOL:
        fail(f"mamba2 tenant {jid}: cluster losses {ev_run['losses'][jid]} "
             f"vs alone {static} (gap {gap_:.3e} > {TRAIN_LOSS_TOL})")
    med_s = float(np.median([x for v in ev_run["secs"].values()
                             for x in v]))
    cluster_k3 = (ev_run["counts"]["ssd_scan"],
                  ev_run["counts"]["ssd_scan_bwd"])
    phase("cluster:mamba2", layers=ccfg.num_layers, jobs=CLUSTER_JOBS,
          batch=TRAIN_BATCH, seq=CLUSTER_SEQ, workers=WORKERS,
          tenant_steps=ev_run["n_steps"],
          makespan_ticks=int(ev_run["summary"]["makespan_s"]),
          n_resizes=ev_run["summary"]["n_resizes"],
          wall_s=f"{ev_run['wall']:.2f}",
          reference_wall_s=f"{ref_run['wall']:.2f}",
          s_per_tenant_step=f"{med_s:.4f}",
          tenant_tokens_per_s=f"{TRAIN_BATCH * CLUSTER_SEQ / med_s:.0f}",
          peak_co_resident=ev_run["co_resident"],
          peak_gb=f"{ev_run['peak'] / 1e9:.2f}",
          held_before_gb=f"{ev_run['base'] / 1e9:.2f}",
          cluster_peak_gb=f"{(ev_run['peak'] - ev_run['base']) / 1e9:.2f}",
          reference_cluster_peak_gb=f"{(ref_run['peak'] - ref_run['base'])
                                       / 1e9:.2f}",
          k3_per_step=f"{cluster_k3[0] / ev_run['n_steps']:.0f},"
                      f"{cluster_k3[1] / ev_run['n_steps']:.0f}",
          k3_paths=json.dumps(ev_run["counts"]["paths"],
                              separators=(",", ":")),
          resized_jid=jid, resizes_of_jid=len(ev_run["events"][jid]),
          vs_alone_max_gap=f"{gap_:.3e}", tol=TRAIN_LOSS_TOL,
          engines_agree=True, sanitizer_violations=0)
    del runs, ev_run, ref_run
    torch.cuda.empty_cache()
    mark("cluster_mamba2")

    # -- 14c. fleet:inplace -- one live phi4 replica grown and shrunk in
    # place through the fleet's scale path --------------------------------
    L = pcfg.num_layers
    n_params = sum(int(np.prod(d.shape)) for d in T.leaves(
        M.model_schema(pcfg)))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    n_in, in_evs = fleet_inplace(pcfg, dev, BATCH, CACHE)
    want = INPLACE_TICKS * L
    if n_in["flash_attention"] != want or \
            n_in["paths"] != {"fma": 0, "mma": 0, "split_decode": want} or \
            any(v_ for k_, v_ in n_in.items()
                if k_ not in ("flash_attention", "paths")):
        fail(f"fleet:inplace launched {n_in}, not K1 {want} times on "
             "split_decode and nothing else")
    for e in in_evs:
        phase("fleet:inplace:resize", step=e.step, action=e.action,
              sizes=f"{e.from_procs}->{e.to_procs}",
              bytes_moved=e.transfer.bytes_moved,
              per_pattern=json.dumps({k_: st.bytes_moved for k_, st in
                                      e.per_pattern.items()},
                                     separators=(",", ":")),
              seconds=f"{e.transfer.seconds:.4f}")
    phase("fleet:inplace", layers=L, batch=BATCH, cache=CACHE,
          ticks=INPLACE_TICKS, tokens_equal=True, cache_equal=True,
          scale_events="grow-in-place,shrink-in-place", sanitizer="clean",
          k1_launches=n_in["flash_attention"],
          wall_s=f"{time.perf_counter() - t0:.2f}",
          peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    torch.cuda.empty_cache()
    mark("fleet_inplace")

    # -- 14d. fleet:live -- the slo-aware fleet of phi4 replicas ------------
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fres, fsteps, n_fl, fwall, ftm, ftr = fleet_live(pcfg, dev, BATCH, CACHE)
    want = FLEET_REPLICA_STEPS * L
    if n_fl["flash_attention"] != want or \
            n_fl["paths"] != {"fma": 0, "mma": 0, "split_decode": want} or \
            any(v_ for k_, v_ in n_fl.items()
                if k_ not in ("flash_attention", "paths")):
        fail(f"fleet:live launched {n_fl}, not K1 {want} times on "
             "split_decode and nothing else")
    fleet_decode_launches = n_fl["flash_attention"]
    fs = fres.summary()
    all_steps = [x for v_ in ftm["step_s"] for x in v_]
    for rid, up, first in ftm["replica_add_s"]:
        phase("fleet:live:replica-add", rid=rid, up_s=f"{up:.3f}",
              first_step_s=f"{first:.4f}", total_s=f"{up + first:.3f}")
    for rid, g_, nxt in ftm["grow_s"]:
        phase("fleet:live:grow-in-place", rid=rid, apply_s=f"{g_:.4f}",
              next_step_s=f"{nxt:.4f}", total_s=f"{g_ + nxt:.4f}")
    phase("fleet:live", layers=L, batch=BATCH, cache=CACHE, workers=8,
          policy="slo-aware", ticks=fres.ticks,
          replica_steps=sum(fsteps), steps_by_replica=",".join(
              map(str, fsteps)),
          scale_events=",".join(e["kind"] for e in fres.scale_events),
          equals_host_model=True, tokens_agree=True, sanitizer="clean",
          k1_launches=fleet_decode_launches,
          ms_per_replica_step=f"{np.median(all_steps) * 1e3:.3f}",
          initial_up_s=",".join(f"{x:.3f}" for x in ftm["initial_up_s"]),
          goodput_rps=fs["goodput_rps"], p99_s=fs["p99_s"],
          slo_attainment=fs["slo_attainment"],
          n_scale_ups=fs["n_scale_ups"], n_scale_downs=fs["n_scale_downs"],
          wall_s=f"{fwall:.2f}",
          peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
          held_before_gb=f"{base / 1e9:.2f}")
    busy = sum(device_us(e) for e in ftr["events"]) / 1e3
    med_ms = np.median(all_steps) * 1e3
    fk1 = sum(device_us(e) for e in ftr["events"] if is_k1_fwd(e.key)) / 1e3
    if busy <= 0 or fk1 <= 0:
        fail("the profiler saw no device time (or no K1) in the traced "
             "fleet replica-step")
    phase("fleet:live:profile", rid=0, step=FLEET_TRACE_STEP,
          traced_step_s=f"{ftr['step_s']:.4f}",
          median_step_s=f"{med_ms / 1e3:.4f}",
          traced_device_busy_ms=f"{busy:.3f}",
          traced_idle_share=f"{1 - busy / (ftr['step_s'] * 1e3):.4f}",
          idle_share_of_median_step=f"{1 - busy / med_ms:.4f}",
          k1_ms=f"{fk1:.3f}", k1_share_of_device=f"{fk1 / busy:.4f}",
          top=json.dumps([{"kernel": e.key[:80], "ms": device_us(e) / 1e3,
                           "calls": e.count}
                          for e in ftr["events"][:PROFILE_TOP]],
                         separators=(",", ":")))
    del fres, ftm, ftr
    torch.cuda.empty_cache()
    mark("fleet_live")

    # -- 14e. phi4-mini prefill vs decode, at full width and all 32 layers --
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pparams = M.init_params(pcfg, torch.Generator(dev).manual_seed(0), dev)
    pprompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, pcfg.vocab_size, (BATCH, PROMPT), dtype=np.int32)).to(dev)
    p_prefill = prefill_launches(
        pcfg, pparams, {"tokens": pprompts}, "phi4",
        {"flash_attention": {"fma": 0, "mma": L, "split_decode": 0},
         "ssd_scan": {"fma": 0, "wgmma": 0}},
        {"block": 0, "group": L})["flash_attention"]
    pld32, pcache = logits_check(pcfg, pparams, pprompts, "phi4",
                                 (P_FP32_LOGITS_ATOL, None),
                                 (P_BF16_LOGITS_MAX, P_BF16_LOGITS_RMS))
    planted_faults(pcfg, pparams, pprompts, "phi4", pld32, pcache,
                   (P_BF16_LOGITS_MAX, P_BF16_LOGITS_RMS))
    del pparams, pprompts, pld32, pcache
    torch.cuda.synchronize()
    phase("phi4", layers=L, params_b=f"{n_params / 1e9:.3f}",
          peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    torch.cuda.empty_cache()
    mark("phi4_prefill")

    # -- 15. kernels line: times at the path's shapes -----------------------
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
        "launches": granite_decode_launches, "max_abs_err": err_decode,
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
    # K3: one layer of the mamba2 prefill (k3_fwd_bound)
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
        "launches_cluster": cluster_k3[0],
        "launches_cluster_note": "phase 14b: six 48-layer mamba2-370m "
                                 "tenants under dmr.Cluster, S=1024",
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
        "launches_cluster": cluster_k3[1],
        "launches_cluster_note": "phase 14b, as the forward's row",
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
    # zamba2's rows, timed after phase 5b; their launches are the
    # zamba2 paths' (phases 13e-13h)
    for row, launches in zip(z_rows, (
            z_dec_launches, z_prefill["flash_attention"], *z_train_k1,
            z_prefill["ssd_scan"], *z_train_k3)):
        kernels.append(dict(row, launches=launches))
    # phi4's rows, timed in phase 3c; their launches are the serving
    # fleet's (14d) and the 32-layer prefill's (14e)
    kernels.append(dict(
        p_rows[0], launches=fleet_decode_launches,
        launches_note=f"fleet:live, {FLEET_REPLICA_STEPS} replica-steps "
                      f"x {L} layers; fleet:inplace adds "
                      f"{n_in['flash_attention']}"))
    kernels.append(dict(p_rows[1], launches=p_prefill,
                        launches_note="one make_prefill_step at 32 layers"))
    mark("kernels")
    phase("timing", **{k: f"{v:.1f}" for k, v in marks.items()})
    print(json.dumps({"kernels": kernels, "card": smi_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
