#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py          # from the root of a checkout

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (K1
flash attention and its backward, K2, K3 and its backward), holds each
against its plain PyTorch version, then drives the port's three families'
serving and training paths at full width with random weights from a
seed -- ``granite-3-2b`` (dense, K1; 10 of its 40 layers, see
``GRANITE_LAYERS``; training also at all 40), ``mamba2-370m`` (SSM, K3;
serving at 12 of its 48 layers, ``MAMBA_SERVE_LAYERS``, training at all
48), ``zamba2-2.7b`` (hybrid, K3 and K1
at G = 1, D = 80; serving at 6 of its 54 layers, ``Z_SERVE_LAYERS``,
training at all 54, elastic training at 12) -- and checks
that each really ran through its kernels; then the paper's live
multi-tenant cluster (``dmr.Cluster``) on eight workers of the card, with
toy tenants and with six full-width ``mamba2-370m`` training tenants; then
the elastic serving fleet (``repro_torch.serve.ReplicaSet``) with live
``phi4-mini-3.8b`` decode replicas at full width and all 32 layers (K1 at
G = 3, D = 128), and phi4's prefill against its decode; then the MoE
family at full width: ``mixtral-8x7b`` serving at 8 of its 32 layers and
elastic training (K1 at G = 4, D = 128, window 4096), and
``qwen3-moe-235b-a22b`` serving at 8 of its 94 layers (K1 at G = 16);
then the encoder-decoder ``seamless-m4t-medium`` at full width and all
12 + 12 layers (K1 non-causal: the encoder's self-attention and the
decoder's cross-attention, in prefill, decode and training) and the
vision-prefix ``pixtral-12b`` at full width (serving at 8 of its 40
layers, training at 1; K1 causal over 256 patches + the text); then
training of the dense configs ``phi4-mini-3.8b``, ``qwen2.5-32b`` and
``internlm2-20b`` at full width and layer cuts that the port's dry run
sizes on meta, each step scored against the analytic model FLOPs (MFU).
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
   D=80, bf16) the same way, twice, bit for bit; then the quickstart's
   own K1 calls (phase 14f): fp32 on fma, causal, the eight query shards
   of its 8-worker sequence path (B=8, H=4, Hkv=2, 8 queries of 64 at
   offsets 0..56, D=16), forward output, lse and backward each against
   its plain version, the ``offset`` mask counted once a shard and
   direction;
3c. phi4:K1: K1 at phi4-mini's shapes, before any phi4 model phase (bf16,
   B=16, H=24, Hkv=8: G = 3, D=128): decode over its 512-slot cache at
   seven kv_lens (384 the serving path's last) on split_decode (3 of its
   16 rows), causal prefill at S=256 on mma's group kernel (4 key tiles,
   the most it holds at D = 128; counted by the C entry point); device
   times warm and L2-cold, SDPA
   beside each, the bounds (phase 15's two phi4 rows); then dense:K1, K1 at
   the dense training configs' shapes (bf16, D=128, S=4096, causal, with
   the lse): phi4-mini's (B=8, H=24: G = 3), qwen2.5-32b's (B=2, a
   microbatch of 8 in 4; H=40: G = 5) and internlm2-20b's (B=4; H=48: G =
   6), before any of their model phases: the forward on mma's block
   kernel and the backward on wgmma, twice bit for bit, each batch row
   against the plain versions within TOL and within ``K1_ULPS`` of each
   half of the sequence's largest entry (a causal output's first rows are
   far larger than its last), a dropped middle key tile planted at row 0
   that the second half's bound must reject; device times, SDPA's forward
   and backward beside each, the bounds (phase 15's six dense rows);
3d. moe:K1: K1 at the MoE family's shapes (bf16, D = 128), before any MoE
   model phase: mixtral's (B=16, H=32, Hkv=8: G = 4) and qwen3-moe's
   (H=64, Hkv=4: G = 16, all 16 rows of a split_decode tile) decode over a
   512-slot cache at seven kv_lens on split_decode, causal prefill at
   S=256 on mma (mixtral's with its window of 4096 on the group kernel,
   equal bit for bit to the causal call's; qwen3-moe's on the block
   kernel: 128 CTAs are fewer than the SMs); mixtral's training shape
   (B=1, S=4096, window 4096) forward with its lse and backward against
   their plain versions, twice bit for bit and equal bit for bit to the
   causal call's; the window biting at Sq=Sk=8192 (block kernel); device
   times warm and L2-cold, SDPA beside each (a band mask for the biting
   window), the bounds (phase 15's seven MoE rows);
3e. zoo:K1: K1 at the encoder-decoder and vision-prefix families' shapes,
   before their model phases (bf16): seamless's encoder self-attention
   (B=16, H = Hkv = 16: G = 1, D=64, S=512, non-causal) and its
   cross-attention prefill (Sq=256 over Sk=512, non-causal), both on
   mma's group kernel; its cross decode on split_decode over 512 valid
   slots (no kv_len); its training shape (B=8, S=4096, non-causal) with
   the lse and the backward, twice bit for bit; pixtral's causal prefix +
   text (B=16, H=32, Hkv=8, D=128, S=512) on the block kernel.  Each
   within TOL of its plain version and within ``K1_ULPS`` bf16 units of
   its largest entry (the training shape batch row by batch row, each
   gradient on its own), which a planted one-tile drop must fail; device
   times warm and L2-cold, SDPA beside each, the bounds (phase 15's six
   rows; ``k1_row``, as phases 3c's and 3d's);
3f. K1:offset: K1 with a causal query offset at phi4-mini's sequence shards
   (16 shards of Sq = 256 over Sk = 4096, B=8, H=24, Hkv=8, D=128, bf16,
   offsets 256 r): each shard's forward with its lse and backward on mma's
   block kernel / wgmma, counted under the ``offset`` mask, twice bit for
   bit, against the plain versions (TOL and ``K1_ULPS``); the 16 outputs
   and dq concatenated and the shard-summed dk and dv against ONE full
   causal call (``K1_ULPS``, ``SEQ_SUM_ULPS``); shard 15 given offset 0
   must fail that bound; device times of the 16 calls, of the full call
   and of SDPA with each shard's boolean offset mask, the bound over the
   offset pairs; then K1 at qwen3-moe's training shape (B=1 of 8
   microbatches, H=64, Hkv=4: G = 16, S=4096) forward and backward, twice
   bit for bit, each half within ``K1_ULPS`` (phase 15's four rows);
3g. phi4:seq: phi4-mini training at full width and ``P_ELASTIC_LAYERS``
   (8), static at 8 workers and elastic 8 -> 16 -> 8 (``SEQ_SCHEDULE``):
   at 16 its 24 heads do not split over 16 ``model`` workers and
   attention runs the sequence path, 16 K1 launches a layer and pass with
   their offsets (counted by mask, every step's from its mesh); losses
   equal bit for bit through the first step at 16 (the same state and a
   bitwise-equal forward) and within ``SEQ_LOSS_TOL`` after; forward
   losses of the final state at 8 and 16 workers equal bit for bit, and
   at 16 with the last shard's offset planted at 0 past the bound;
3h. qwen3moe:train: qwen3-moe-235b-a22b training in its bf16 master
   weights and moments, 8 microbatches, at the first of ``QM_CUTS`` that
   the dry run fits (1 layer), 4 -> 8 -> 16 workers, all EP: per step the
   workers, losses, seconds, the dropped share and each shard's capacity,
   which must equal the reference's C_loc (80, 40, 24); the peak beside
   the dry run's prediction; K1 at G = 16 on mma / wgmma;
3i. moe:tp: mixtral-8x7b's MoE layer at full width and a training
   microbatch (4 x 4096), forward and backward, under its rules: at 8
   workers (F in 8 slices, summed over ``model``) within ``MOE_TP_ULPS`` of
   the global formulation (output, dx, every weight's gradient); at 6 (F
   does not split: nothing is summed) equal to it bit for bit;
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
9. the mamba2 serving path at ``MAMBA_SERVE_LAYERS`` (12 of 48; so is
   phase 10): ``decode_demo`` at granite's batch, prompt,
   decode length, workers and resize schedule; tokens must agree, and the
   decode path (the SSM recurrence) launches neither K1 nor K3;
10. mamba2 prefill vs decode: ``make_prefill_step`` at B=16, S=1024 (four
    chunks, so the state is carried across chunks three times) must launch
    K3 once per layer, every launch on the wgmma path; fp32 full-sequence logits at every position against
    fp32 token-by-token decode logits (tight), bf16 prefill and decode each
    against fp32 (beside the fp32 model with bf16-rounded weights, the
    yardstick of how far bf16 rounding alone moves these logits), and a
    state advanced twice in each decode's last step, which both bounds
    must reject (``state_faults``); then one
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
13. the same training (Listing 2) at all 40 layers: a static and an
    elastic run of 3 steps each, the elastic one 4 -> 8 -> 2 under
    ``ScriptedRMS`` with ``opt/nu`` moved by a user function and
    ``opt/mu`` by a pattern family the script registers
    (``dmr.register_pattern``); losses agree to 1e-4, K1 80 forward and 40
    backward launches a step (all on mma / wgmma), each resize's bytes
    and per-pattern bytes (``custom``, ``rowcopy:4``, ``default``) equal
    the tree's accounting; the resizes donate the old state, so each
    resize's peak stays within the bytes allocated before it plus the
    largest leaf and ``RESIZE_SLACK_BYTES``, and the elastic run's peak
    within the static run's plus the same (the memory line:
    ``train:depth:memory``);
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
13e. the zamba2 serving path at ``Z_SERVE_LAYERS`` (6 of 54): granite's
    ``decode_demo`` schedule; tokens must agree, and each run launches K1
    once per group per step (1 x 384), all on split_decode, and no K3;
13f. zamba2 prefill vs decode: ``make_prefill_step`` at B=16, S=1024 must
    launch K3 once per layer (6, wgmma) and K1 once per group (1, mma);
    then, at ``Z_CHECK_LAYERS`` (the first 12 layers of the same weights),
    fp32 full-sequence logits at every position against the fp32
    token-by-token decode, bf16 prefill and decode against fp32 (largest
    and rms gap, beside the fp32 model with bf16-rounded weights), faults
    planted in each decode's last step (``state_faults``: a state
    advanced twice; in fp32 also a KV slot one back and two KV heads
    swapped) that the bounds must reject; one traced prefill at
    ``Z_SERVE_LAYERS``: K3's and K1's shares, the top device kernels;
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
    width and ``CLUSTER_LAYERS`` (6) of its 48 layers (global batch 8
    of 1024 tokens, ``train_4k``'s
    4096 cut for the script's time; bf16 over fp32 master weights; AdamW
    1e-3; seeded by its jid), its TrainState on the card and moved by
    ``default`` on every resize; both engines, sanitized: every job
    finishes, the engines agree on ``summary()``, records and trail, the
    most resized tenant's losses are within 1e-4 of the same job run
    alone, and K3 launches exactly 2 x 6 forward and 6 backward kernels
    per tenant step (steps counted from the trail), all on ``wgmma``; wall
    seconds, the median seconds per tenant step, each resize's bytes and
    seconds, the peak of co-resident tenants and of
    ``torch.cuda.max_memory_allocated``;
14f. examples (run right after 14b): the paper's §4.3 applications
    (``repro_torch.examples``: quickstart, CG, Jacobi, N-body, the aligner
    pipeline) through each ``main()`` on the card, at the reference's
    sizes: each example's own check passes, each resize's (step, action,
    from, to, bytes_moved, per-pattern bytes) equals the same example's
    run on the CPU in this process, and the final states agree (CG and
    Jacobi x within ``EX_X_TOL``; N-body one step's velocities within
    ``EX_NBODY_STEP_RTOL``, the 20-step energy within
    ``EX_NBODY_ENERGY_RTOL`` and positions within ``EX_NBODY_POS_ATOL``;
    the aligner's counters; the quickstart's two runs start from one
    state, the CPU workers' initial state copied to each run's device, and
    its losses agree at every step within ``EX_QUICKSTART_LOSS_RTOL``
    relative, besides falling);
    K1, K2 and K3 launch counts of each run: the quickstart's K1 forward
    and backward exactly as its 14 steps at 4 -> 8 -> 2 workers need
    (``ex_k1_want``), every other app none.  Then CG at full width
    (``EX_CG_N`` = 32768: A is 4.29 GB fp32) on the same schedule: the
    fp64 true relative residual below ``cg_solver.REL_RESIDUAL_TOL``, the
    ms per iteration (CUDA events over ``EX_CG_TIMED`` more iterations)
    beside one read of A at the card's bandwidth, each resize's seconds
    and bytes, the peak memory; a planted fault (a resize whose moved x
    loses its last row block, planted in the app ``main()`` builds) must
    fail that check.  Last, phase 14's
    trails, written with the port's ``dump_trail``, through
    ``python -m repro_torch.analysis audit``'s ``main``: every one clean;
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
16. mixtral serving at ``MOE_SERVE_LAYERS`` (8 of 32): ``serve_runs`` (K1
    8 launches a step on split_decode; tokens and final KV caches equal
    bit for bit; the share of routed assignments dropped over capacity),
    ``make_prefill_step`` (K1 8 on mma's group kernel) and its first
    tokens against decode's, one traced decode step (device busy, idle
    share, K1's share, and the expert products', the dispatch's and the
    dtype casts' by operator, ``MOE_OP_GROUPS``), then ``logits_check`` on
    the first ``MOE_CHECK_LAYERS`` layers at the check config (capacity
    for every assignment, the window as plain causal attention: both
    paths drop nothing);
17. mixtral training (Listing 2): the smoke step on the card against the
    CPU's (loss, ce_loss, aux_loss, gradient norm), then
    ``MX_ELASTIC_LAYERS`` (1) at granite's training settings with
    mixtral's 2 microbatches, 6 static and 6 elastic steps whose losses
    agree to ``MX_TP_LOSS_TOL`` (its MoE layer sums F-slices over
    "model": 4 at the static run's workers, 8 and 2 at the elastic
    run's), ce_loss and aux_loss beside them; then 6 static steps
    at ``MX_DEPTH_LAYERS`` (2), s/step, peak GB; every attention call on
    K1 (4 forward launches a layer and step on mma, 2 backward on wgmma);
    one traced step split as phase 16's;
18. qwen3-moe serving at 8 of its 94 layers in its bf16 master weights:
    ``serve_runs`` (K1 8 a step on split_decode, q/k norm on the path),
    the prefill (K1 8 on mma's block kernel), a traced decode step split
    as phase 16's, bf16 against fp32 logits at all 8 layers after 64
    prompt tokens (prefill and decode each against its own fp32 path),
    ``logits_check`` on 2 layers at the check config;
19. seamless-m4t-medium serving at all 12 + 12 layers: ``serve_runs`` (K1
    24 launches a step on split_decode, half of them cross-attention over
    the 512-slot cross cache; tokens and final caches, the cross cache
    included, equal bit for bit; each resize's ``bytes_moved``), the
    prefill with 512 frames of 1024 (K1 36 on mma's group kernel), then
    the card against the CPU in fp32 at 2 + 2 layers
    (``zoo_cpu_check``): a prefill's logits and 8 decode steps' over a
    seeded cross cache, which the steps must leave unchanged;
20. seamless training at all 12 + 12 layers (8 x 4096 tokens over 8 x 4096
    frames): 6 static and 6 elastic steps whose losses agree to 1e-4, K1
    72 forward and 36 backward launches a step (by mask: the decoder's
    causal 24 and 12, the encoder's and cross-attention's 48 and 24); one
    traced step's K1 shares and the chunked CE's (the kernels of its
    ``CE_SPAN`` spans and of their operators' backward, ``span_fields``);
21. pixtral-12b serving at ``PX_SERVE_LAYERS`` (8 of 40): ``serve_runs``
    (text-only decode, K1 8 a step on split_decode), the prefill over 256
    patch embeddings + 256 text tokens (K1 8 on mma's block kernel), the
    card against the CPU in fp32 at 2 layers;
22. pixtral training at ``PX_TRAIN_LAYERS`` (1): 4096 = 256 patches + 3840
    text tokens, the loss on the text only, 6 static and 6 elastic steps
    whose losses agree to 1e-4;
23. phi4-mini training (Listing 2) at full width: the smoke config at
    phi4's head dim, G and microbatches, one fp32 step on the card
    against the CPU's; ``P_ELASTIC_LAYERS`` (8) at granite's training
    settings, ``P_ELASTIC_STEPS`` static and elastic steps whose losses
    must be equal bit for bit; then a static depth run (a warm step and
    a timed one) at the first of ``P_STATIC_CUTS`` (32, 24, 16 layers)
    whose dry-run argument and gradient bytes (``launch/dryrun.py``, on
    meta) and the other temporaries measured at 8 layers fit in
    ``DENSE_FIT_GB``; one traced step: K1's forward and backward shares
    and the chunked CE's (``span_fields``);
24. qwen2.5-32b training at ``Q_TRAIN_LAYERS`` (2): its smoke step on the
    card against the CPU's (the QKV bias; 4 microbatches), a static run
    in 4 microbatches of 2, a traced step (K1 at G = 5);
25. internlm2-20b training at ``I_TRAIN_LAYERS`` (4) the same way (2
    microbatches of 4; K1 at G = 6);
26. the dry run against the card, for each cut of 23-25: the dry run's
    argument, state and gradient GB (meta) beside what the card holds
    after ``init_state`` (its state's bytes must equal the dry run's, and
    the allocator's within ``ALLOC_SLACK_PER_LEAF`` a leaf) and the
    measured peak; the model
    FLOPs (``launch/roofline.py``'s ``model_flops``), the counted FLOPs
    (``launch/flopcount.py``: products, K1 over its causal pairs),
    ``useful_ratio``, s/step, tokens/s and MFU (model FLOPs over s/step
    at the bf16 dense peak, 989.4 TFLOP/s), and where the traced step's
    time went;
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
    The MoE family adds seven (phase 3d): mixtral's and qwen3-moe's decode
    and prefill (their launches phases 16's and 18's), mixtral's training
    forward and backward at B=4 (phase 17's 2-layer run) and the window
    biting at S=8192 (no path reaches it: 0 launches).  The
    encoder-decoder and vision-prefix families add six (phase 3e):
    seamless's encoder prefill, cross prefill, cross decode, training
    forward and backward (their launches phases 19's and 20's, counted by
    mask where K1 launches them: ``flash_attention.mask_launches``), and
    pixtral's prefill (21's).  The dense training configs add six (phase
    3c): K1's forward and backward at phi4-mini's, qwen2.5's and
    internlm2's training shapes (their launches 23's to 25's static depth
    runs', counted by mask).  Sharded training adds four (phase 3f): K1's
    forward and backward over phi4's 16 sequence shards with their
    offsets (a row's times are the 16 calls'; the full call's beside; its
    launches phase 3g's ``offset`` ones) and at qwen3-moe's G = 16
    training shape (3h's).  Then the contract line ``{"ok": true,
    ...}``.

Any failure exits non-zero before the last line; no phase is caught and
continued.  Needs a CUDA card; without one (or outside a checkout) it
exits 1 and prints no result.
"""
import contextlib
import dataclasses
import gc
import io
import json
import os
import re
import subprocess
import sys
import time
from unittest import mock

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
#: K1 at the encoder-decoder's non-causal shapes (phase 3e) and pixtral's
#: prefix: a row there averages hundreds to thousands of keys, so |o| and
#: the gradients are ~0.03 (0.2 at their largest), and TOL's 2e-2 + 2e-2
#: |ref| is the size of a typical entry.  Each output is also held to this
#: many bf16 units in the last place of its plain version's largest entry
#: (4e-3 at the training shape): both sides round to bf16 once, and K1
#: rounds P (and dS) to bf16 before its products; on the CPU
#: ``kernels/bwd_rounding``'s model of that arithmetic errs by 1 unit at
#: S = 4096, non-causal, and a kernel that skipped one 64-key tile would
#: move o by ~12 units and dq by ~17
K1_ULPS = 4
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
#: phase 13, the paper's Listing 2 at granite's full depth (40 layers): a
#: static and an elastic run of GRANITE_DEPTH_STEPS steps each, the elastic
#: one expanding and shrinking (4 -> 8 -> 2) with opt/nu moved by a user
#: function and opt/mu by a pattern family registered in the script
GRANITE_DEPTH_STEPS, GRANITE_DEPTH_SCHEDULE = 3, {1: 8, 2: 2}
#: a donated resize holds the state and the leaf it is copying: its peak
#: may pass the bytes allocated just before it by the largest leaf (2.68
#: GB at granite's full depth) and this slack at most, and the elastic
#: run's peak the static run's by the same (the allocator rounds each
#: block up, by under 1 MiB for a large one; two states would pass it by
#: 30 GB)
RESIZE_SLACK_BYTES = 256 * 2 ** 20

MAMBA = "mamba2-370m"               # serving runs at granite's batch, prompt,
M_PREFILL_S = 1024                  # decode length, workers and schedule
#: mamba2 serving and its prefill-vs-decode check run 12 of its 48 layers:
#: both are host-bound (~1.1-1.9 ms of dispatch a layer and decode step);
#: at 48 layers they took 160 of the script's 300 s before zamba2's paths
#: joined them, at 24 112-137 s of 823-1032, which the encoder-decoder
#: and vision phases need; K3's own checks and times, and mamba2
#: training, keep all 48.  A depth cut of an earlier check: at 12 layers
#: its bounds (M_FP32_LOGITS_ATOL, M_BF16_*) sit 9x and 3.6x / 8x over
#: the readings, and reject a planted state advanced twice (4.35, rms
#: 0.88: ``state_faults``)
MAMBA_SERVE_LAYERS = 12
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
#: pool, each a full-width mamba2-370m training job at CLUSTER_LAYERS of its
#: 48 layers and TRAIN_BATCH x CLUSTER_SEQ tokens a step (train_4k's 4096
#: cut to 1024 for the script's time).  A depth cut of an earlier path,
#: three times: its tenant steps are host-bound (the card idles 0.40-0.65
#: of them) and both engines run the workload; at 48 layers it took 86-90
#: s of a script that reached 1147-1162 s on slow hosts, at 24 45 s; with
#: the sharded training phases (3f-3i) one H100 host reached the seamless
#: phases at ~960 s (826 s before them), on course for ~1,100 s: so 12
#: (20.5-25.9 s of 881-1035 s runs), and 6 since phase 13 ran granite's
#: 40 layers elastically.  Every check counts from the config's layers,
#: and the resized tenant's gap to its run alone is exact at any depth
CLUSTER_JOBS, CLUSTER_STEPS, CLUSTER_SEQ, CLUSTER_LAYERS = 6, 6, 1024, 6

#: phase 14f, the §4.3 examples on the card against the same run on the CPU
#: (the tolerances of tests/test_torch_examples.py, which holds the CPU
#: runs to the JAX examples): x of CG and Jacobi; N-body's velocities after
#: one step (relative to the largest), its 20-step energy (relative) and
#: positions (its velocities are not compared after 20 steps: the 1e-2
#: softening lets close encounters amplify rounding)
EX_X_TOL = 1e-6
EX_NBODY_STEP_RTOL = 1e-4
EX_NBODY_ENERGY_RTOL = 1e-5
EX_NBODY_POS_ATOL = 5e-3
#: the quickstart's losses, card against CPU from one initial state, at
#: each of its 14 steps (relative; one step of the sharded smoke models
#: agrees within 1e-5 in tests/test_torch_gpu.py)
EX_QUICKSTART_LOSS_RTOL = 1e-5
#: CG at full width: n x n fp32 (4.29 GB), and the iterations timed after
#: the example's 40
EX_CG_N = 32768
EX_CG_TIMED = 50

ZAMBA = "zamba2-2.7b"               # the hybrid family, at full width
#: its shared attention is multi-head (H = Hkv = 32, G = 1) at head dim 80
#: (from the config); K1's forward and backward at the training shape,
#: B cut to 1 to bound the plain version's memory, as BWD_TRAIN
Z_BWD_TRAIN = (1, 32, 32, 4096, 80)
#: its scan: 80 heads of P = 64 at N = 64, at the prefill's and the
#: training path's shapes (B, H, S, P, N, Q)
Z_SSD_PREFILL = (BATCH, 80, M_PREFILL_S, 64, 64, 256)
Z_SSD_TRAIN = (TRAIN_BATCH, 80, 4096, 64, 64, 256)
#: zamba2's elastic training runs two groups (12 of its 54 layers); the
#: static run takes all 54.  A resize donates the old state, so one at 54
#: layers would hold 29.07 GB of state plus a 2.83 GB leaf, under the
#: static step's 55.43 GB: it fits, but is not run here
Z_ELASTIC_LAYERS = 12
#: zamba2 serving and the prefill that counts its launches run 6 of its
#: 54 layers (one group; all 54 until the dense training phases joined:
#: its two 384-step decode loops are host-bound, 109-159 ms a step at 54
#: layers on H100 hosts, and took 115 s of a 1162 s run on a 145-159 ms
#: host, 38 s short of the limit; 24, 46 s of a 973 s run, until the
#: sharded training phases 3f-3i put the script on course for ~1,100 s:
#: see CLUSTER_LAYERS; 12, 21.5-32.0 s of 881-1035 s runs, until phase 13
#: ran granite's 40 layers elastically); the prefill-vs-decode logits
#: checks run the first 12 (two groups) of the same weights: their two
#: 1024-step decode loops are host-bound too and took 100-138 s of
#: 823-1032 at 24 layers.  Depth cuts of earlier checks: the serving
#: check compares tokens, caches and launch counts exactly at any depth,
#: and the logits bounds are set from 12-layer readings and shown to
#: reject planted faults; zamba2 training keeps all 54
Z_SERVE_LAYERS, Z_CHECK_LAYERS = 6, 12
#: zamba2 fp32 full-sequence logits vs the token-by-token decode at every
#: one of the 1024 positions, at Z_CHECK_LAYERS, by the largest and the
#: rms gap.  The same function in fp32 through the SSM layers and the
#: attention blocks; the chunked scan is ~1e-4 from the exact recurrence
#: in y at these decays (see M_FP32_LOGITS_ATOL), and this random-init
#: model amplifies a perturbation ~4x more than mamba2's.  At 12 layers
#: an H100 (80GB HBM3, 700 W) measured 8.3e-3 at worst over all
#: positions, rms 1.4e-4 (5.5e-2 and 8.8e-4 at all 54).  A state advanced
#: twice in the last step moves the last logits by 7.0 (rms 1.4), but a
#: wrong shared-attention slot far less in this model: the last token's
#: K/V one slot back by 4.1e-2 (rms 6.9e-3), KV heads 0 and 1 swapped by
#: 0.135 (rms 2.6e-2).  So the bounds, 0.03 and 2e-3, sit 3.6x and 14x
#: over the readings and under every such fault (``state_faults``)
Z_FP32_LOGITS_ATOL, Z_FP32_LOGITS_RMS = 0.03, 2e-3
#: each zamba2 bf16 path against the fp32 logits at Z_CHECK_LAYERS, by the
#: largest and the rms gap.  At 12 layers on that card, rounding only the
#: weights to bf16 moved the fp32 logits by up to 0.56 (rms 0.073), and
#: computing in bf16 by up to 1.07 (rms 0.124 and 0.136, prefill and
#: decode) against a logits std of 1.01 (at all 54: 3.07, rms 0.58):
#: this model's bf16 path is far noisier than mamba2's.  The largest gap
#: is held to 3.0, the rms gap to 0.45, ~3x the readings and under the
#: 7.3 (rms 1.38) of a state advanced twice; a wrong attention slot moves
#: these logits less than bf16 rounding does, and only the fp32 bound sees it
Z_BF16_LOGITS_MAX, Z_BF16_LOGITS_RMS = 3.0, 0.45


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

#: the MoE family at full width: mixtral-8x7b (32 query heads over 8 of
#: 128, G = 4, a sliding window of 4096, 8 experts top-2 of d_ff 14336;
#: 1.451 B parameters a layer, 5.81 GB in fp32) and qwen3-moe-235b-a22b (64
#: over 4, G = 16, q/k norm, 128 experts top-8 of d_ff 1536; 2.488 B a
#: layer, 4.98 GB in its bf16 master weights).  Serving (16, 18) runs 8 of
#: their 32 and 94 layers: 47.5 and 42.3 GB of weights
MIXTRAL, QWEN3 = "mixtral-8x7b", "qwen3-moe-235b-a22b"
MOE_SERVE_LAYERS = 8
#: mixtral training (17): elastic at 1 layer, static at 2 for s/step and
#: peak memory.  A resize donates the old state, so one at 2 layers would
#: hold the 37.98 GB state plus a 3.76 GB leaf, under the 2-layer static
#: step's 49 GB peak: it fits, but is not run here
MX_ELASTIC_LAYERS, MX_DEPTH_LAYERS = 1, 2
#: mixtral's elastic losses against static.  Its training steps run
#: under their mesh's sharding context, and its rules split the expert
#: MLP's F axis over "model": the static run (4 workers) sums 4 F-slices
#: of each expert product in bf16, the elastic run 8 and then 2, as the
#: reference's psum does, so the MoE output rounds differently at each
#: count (phase 3i: 8 slices within 2 bf16 units of the global output at
#: a training microbatch).  On an H100 80GB HBM3 (700 W) the first step
#: at 8 workers, from the same state, moved the loss by 7.3e-5, and the
#: random-init model's steps (lr 1e-3) carried the rounding to 1.05e-3
#: over the next two.  So the pair is held to 5e-3, ~5x that: a resize
#: that lost or mixed up a leaf of the 20.6 GB state moves these losses by
#: far more (a reset moment alone changes the next update by its lr)
MX_TP_LOSS_TOL = 5e-3
#: prefill vs decode logits of the MoE models run their first 2 layers, on
#: a check config of the same weights with the capacity raised to hold
#: every assignment (capacity_factor E / k: C >= T) and mixtral's window
#: replaced by plain causal attention: capacity drops depend on the set of
#: tokens routed together (a decode step routes 16, a prefill 4096), and
#: mixtral's rolling decode buffer counts every slot live before it fills,
#: as the reference's does, so neither path equals the other otherwise;
#: at S = 256 <= 4096 the window changes no bit of the prefill (phase 3d)
MOE_CHECK_LAYERS = 2
#: each MoE bf16 path against the fp32 logits (std 1.28 for both models),
#: by the largest and the rms gap.  bf16 also moves tokens across the
#: router's top-k boundary, which changes their expert outputs outright.
#: On an H100 (80GB HBM3, 700 W) at 2 layers: mixtral 0.257 (rms 0.036;
#: its weights rounded to bf16 alone 0.197, rms 0.023), qwen3-moe 0.577
#: (rms 0.054; its master weights are bf16).  So the largest gap is held to
#: 1.2 and the rms gap to 0.15, 2x and 2.8x above the worse reading and
#: ~1 std and ~12x below decorrelated logits (rms ~1.4 std), which a wrong
#: cache, position or routing gives
MOE_BF16_LOGITS_MAX, MOE_BF16_LOGITS_RMS = 1.2, 0.15
#: qwen3-moe's bf16 paths against fp32 at all 8 serving layers (phase 18)
#: run the first 64 prompt tokens: its fp32 decode casts every expert
#: weight to fp32 each step (~60 ms a step), and 256 steps took ~45 s of
#: a slow host's run; the same bounds hold (0.237, rms 0.023 over 256 on
#: that card)
Q8_CHECK_S = 64
#: operators whose kernels a MoE model's traced step is split into (their
#: device time, ``op_group_fields``): the expert products; the dispatch
#: (top-k and rank sorts, searchsorted, the bucket scatter, the gathers --
#: ``aten::index`` also takes the embedding row lookup); every dtype cast
#: (the fp32 -> bf16 weight casts, and the fp32 upcasts of norms and the
#: router's input)
MOE_OP_GROUPS = {"experts": ("aten::bmm",),
                 "dispatch": ("aten::sort", "aten::searchsorted",
                              "aten::_index_put_impl_", "aten::index",
                              "aten::repeat_interleave", "aten::one_hot"),
                 "casts": ("aten::_to_copy",)}

#: the encoder-decoder family at full width and depth: seamless-m4t-medium
#: (12 encoder and 12 decoder layers, d 1024, 16 heads of 64 with no
#: grouping, G = 1, vocab 256206; 0.979 B parameters, 3.92 GB in fp32);
#: and the vision-prefix family at full width: pixtral-12b (40 layers, d
#: 5120, 32 heads over 8 of 128, G = 4, vocab 131072, a prefix of 256
#: patch embeddings of 1024; 12.25 B parameters, 49.0 GB in fp32)
SEAMLESS, PIXTRAL = "seamless-m4t-medium", "pixtral-12b"
#: the encoder's frames on the serving paths: as many as the cache's slots
#: (the reference's serving cache sizes its cross cache enc_len =
#: cache_len), so the cross decode reads 512 valid slots
S_ENC = CACHE
#: pixtral serving runs 8 of its 40 layers (3.53 B parameters, 14.1 GB in
#: fp32), as mixtral's; its elastic training 1 (1.62 B, a 19.5 GB state
#: that a resize moves)
PX_SERVE_LAYERS, PX_TRAIN_LAYERS = 8, 1
#: card against CPU in fp32 (phases 19, 21): seamless at 2 + 2 layers,
#: pixtral at 2, full width; logits of a prefill and of decode steps (over
#: a seeded random cross cache for seamless) within 1e-4: the same
#: function in fp32 on both (no TF32), differing in summation order only
ZOO_CHECK_LAYERS, ZOO_FP32_ATOL, ZOO_CHECK_STEPS = 2, 1e-4, 8

#: the dense training configs at full width (phases 3c, 23-26):
#: phi4-mini-3.8b (32 layers, 24 query heads over 8 of 128: G = 3),
#: qwen2.5-32b (64 layers, 40 over 8: G = 5, a QKV bias, 4 microbatches of
#: the batch) and internlm2-20b (48 layers, 48 over 8: G = 6, 2
#: microbatches); K1 at their training shapes B = 8, 2 and 4 a microbatch
DENSE_TRAIN = {"phi4": PHI4, "qwen2.5": "qwen2.5-32b",
               "internlm2": "internlm2-20b"}
#: phi4's elastic and static pair at 8 layers (1.420 B parameters: a 17.0
#: GB state that a resize moves); TRAIN_SCHEDULE's two resizes take 5
#: steps.  Its static depth run takes the first of these cuts whose
#: dry-run argument and gradient bytes, and the other temporaries
#: measured at 8 layers (the peak less the argument and the gradients:
#: activations, the CE's chunk logits over 200064 columns), fit in
#: DENSE_FIT_GB of the card.  The gradients grow with the depth, so they
#: come from the dry run at each cut: on an H100 80GB HBM3 (700 W) the
#: 8-layer step peaked at 56.44 GB (17.04 of argument, 5.68 of gradients,
#: 33.72 other), the 24-layer one at 78.99 (predicted 82.21; without the
#: gradients' growth, 75.77), and 32 ran out of memory
P_ELASTIC_LAYERS, P_ELASTIC_STEPS, P_STATIC_CUTS = 8, 5, (32, 24, 16)
DENSE_FIT_GB = 76.0
#: qwen2.5 static at 2 of its 64 layers (2.532 B parameters: a 30.4 GB
#: state, 50.6 with its gradients and their microbatch sums), internlm2 at
#: 4 of its 48 (2.697 B: 32.4 GB, 54.0); each static dense run a warm step
#: and a timed one (two timed took the script to 1162 s on a slow host)
Q_TRAIN_LAYERS, I_TRAIN_LAYERS, DENSE_STEPS = 2, 4, 2
#: the card's caching allocator rounds each tensor up to 512 bytes and
#: leaves a large one's block unsplit when less than 1 MiB would remain:
#: what the card holds after init_state may pass the state's bytes by at
#: most this much a leaf
ALLOC_SLACK_PER_LEAF = 2 ** 20 + 512

#: sequence-parallel attention (phases 3f, 3g): phi4-mini's 24 heads do not
#: split over 16 "model" workers, so at 16 workers each layer runs 16 query
#: shards of 4096 / 16 = 256 rows over the whole sequence's keys, each K1
#: launch with its causal query offset
SEQ_SHARDS = SEQ_WORKERS = 16
#: phase 3g's runner: 8 workers, 16 for two steps, 8 again
SEQ_PARAMS, SEQ_SCHEDULE = (2, 16, 8), {2: 16, 4: 8}
#: the 16 shards' dk and dv, each a bf16 partial summed in fp32, against
#: one full causal call's: each partial is rounded once (half a unit of a
#: value at most the half's largest), 16 of them, beside the full call's
#: own K1_ULPS
SEQ_SUM_ULPS = K1_ULPS + SEQ_SHARDS // 2
#: phase 3g's losses, elastic (8 -> 16 -> 8) against static (8).  Through
#: the first step at 16 the state is the static run's, and the step's
#: forward is the 8-worker one bit for bit: phase 3f's row shows the 16
#: shards' outputs and dq equal to one full call's bit for bit, and the
#: projections of a row do not depend on the rows beside it; so those
#: losses, and the final state's forward losses at 8 and 16 workers, must
#: be equal.  Its backward sums dk, dv and each weight's gradient in 16
#: parts (3f: within about one bf16 unit of one call's), and from the
#: next step on the runs part: on an H100 80GB HBM3 (700 W) the losses
#: differed by 1.1e-5 one step later and 2.65e-4 two steps later, as the
#: random-init model's loss rose 0.26 in that step (lr 1e-3).  So the
#: later steps are held to 1e-3, ~4x that; a shard attending with a wrong
#: offset moves the forward loss past it (phase 3g plants one)
SEQ_LOSS_TOL = 1e-3
#: phase 3h: qwen3-moe at the first of these cuts whose dry-run state, its
#: resize clone and the gradients fit DENSE_FIT_GB; 4 workers, 8 at step
#: 2, 16 at step 4 (128 experts split over each: EP)
QM_CUTS, QM_PARAMS, QM_SCHEDULE, QM_STEPS = (2, 1), (4, 16, 4), \
    {2: 8, 4: 16}, 6
#: phase 3i: mixtral's MoE output, dx and weight gradients with F in 8
#: slices against the global formulation, in bf16 units in the last place
#: of each one's largest entry: each of 8 partial products is rounded to
#: bf16 once and 7 bf16 additions sum them (half a unit each, 7.5), the
#: global product once (half), and the gate-weighted combine rounds once
#: more on both sides
MOE_TP_ULPS = 12


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
    time repeats the time of the kernels it launched, listed as events,
    and so does a ``record_function`` span's device-side record (a key
    the host side has too), left out."""
    from torch.autograd import DeviceType
    evs = prof.key_averages()
    host = {e.key for e in evs if e.device_type == DeviceType.CPU}
    return sorted((e for e in evs if e.device_type == DeviceType.CUDA and
                   device_us(e) > 0 and e.key not in host),
                  key=device_us, reverse=True)


def op_group_fields(prof, busy_ms: float, groups, per: int = 1) -> dict:
    """For each name of ``groups`` (a name -> operator names), the device
    time of those operators' kernels in the trace ``prof`` (each
    operator's own and its children's, over ``per`` steps) and its share
    of ``busy_ms``, the trace's device busy time."""
    total = {}
    for e in prof.key_averages():
        for attr in ("device_time_total", "cuda_time_total"):
            if hasattr(e, attr):
                total[e.key] = getattr(e, attr)
                break
    out = {}
    for name, names in groups.items():
        us = sum(total.get(n_, 0.0) for n_ in names)
        out[f"{name}_ms"] = f"{us / 1e3 / per:.3f}"
        out[f"{name}_share"] = f"{us / 1e3 / busy_ms:.4f}"
    return out


def span_events(evs, name: str) -> list:
    """The operator records of the trace's events ``evs`` that belong to
    the ``record_function`` span ``name``: each span and what it ran
    (a span inside the backward, a recomputation, included), and each
    record of the autograd engine that ran the backward of an operator
    the span's forward ran (matched by the forward's thread and sequence
    number), with all they ran; each record once."""
    step = "autograd::engine::evaluate_function"

    def walk(e):
        todo = [e]
        while todo:
            e = todo.pop()
            yield e
            todo.extend(e.cpu_children)

    def in_backward(e):
        while e.cpu_parent is not None:
            e = e.cpu_parent
            if e.name.startswith(step):
                return True
        return False

    roots = [e for e in evs if e.name == name]
    fwd = {(d.thread, d.sequence_nr) for r in roots if not in_backward(r)
           for d in walk(r) if d.sequence_nr >= 0}
    roots += [e for e in evs if e.name.startswith(step) and
              (e.fwd_thread, e.sequence_nr) in fwd]
    seen = {}
    for r in roots:
        for d in walk(r):
            seen.setdefault(d.id, d)
    return list(seen.values())


def span_fields(prof, busy_ms: float, spans) -> dict:
    """For each name of ``spans`` (a name -> a ``record_function`` span's
    name), the device time of the kernels that the span's records
    (``span_events``) launched in the trace ``prof``, and its share of
    ``busy_ms``, the trace's device busy time."""
    evs = prof.events()
    out = {}
    for key, name in spans.items():
        us = sum(k_.duration for e in span_events(evs, name)
                 for k_ in e.kernels)
        out[f"{key}_ms"] = f"{us / 1e3:.3f}"
        out[f"{key}_share"] = f"{us / 1e3 / busy_ms:.4f}"
    return out


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
    from repro_torch.analysis import dump_trail
    from repro_torch.analysis.__main__ import main as analysis_cli
    from repro_torch.examples import (aligner_pipeline, cg_solver, jacobi,
                                      nbody, quickstart)
    from repro_torch.configs import get_config, get_shape, phys_vocab
    from repro_torch.core.lm_app import lm_train_app
    from repro_torch.core.redistribute import blockcyclic_split
    from repro_torch.dmr import get_pattern
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import blockcyclic as bc
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import meta as kmeta
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch import dryrun, flopcount, roofline
    from repro_torch.kernels.ref import (attention_backward_reference,
                                         attention_lse_reference,
                                         attention_reference,
                                         repack_reference,
                                         ssd_chunked_backward_reference,
                                         ssd_chunked_reference, ssd_reference)
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.models.train import (CE_SPAN, init_state, loss_fn,
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

    def k1_bwd_case(B, H_, Hkv_, Sq, Sk, D_, causal, window, dt, what,
                    q_offset=None):
        """K1 forward with its lse, then the backward kernel (which must
        take and count its dtype's path), each against its plain version
        (``q_offset``: a sequence shard's causal query offset); returns
        the inputs, the forward and the gradients."""
        nonlocal lse_err
        name = str(dt).split(".")[1]
        q, k, v = rand((B, H_, Sq, D_), dt), rand((B, Hkv_, Sk, D_), dt), \
            rand((B, Hkv_, Sk, D_), dt)
        do = rand((B, H_, Sq, D_), dt)
        kw = dict(causal=causal, window=window)
        if q_offset is not None:
            kw["q_offset"] = q_offset
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
    # the quickstart's K1 calls (phase 14f): fp32 on fma, causal, on its
    # 8-worker mesh's sequence path (granite-3-2b-smoke's 4 heads do not
    # divide 8): each worker's S / 8 queries at its offset over K and V
    # whole, the batch whole (one data worker)
    qk_c, qk_n = get_config(quickstart.ARCH), 8
    qk_S = quickstart.SHAPE.seq_len
    qk_B = quickstart.SHAPE.global_batch // max(1, qk_c.train_microbatches)
    qk_msk0 = [dict(f_.mask_launches) for f_ in (fa.flash_attention,
                                                 fa.flash_attention_bwd)]
    qk_fwd0 = dict(fa.flash_attention.path_launches)
    bwd_err["float32"], qk_fwd_err = 0.0, 0.0
    for r_ in range(qk_n):
        off_ = r_ * qk_S // qk_n
        qk_what = f"K1 on the quickstart's sequence shard {r_} (offset {off_})"
        (q_, k_, v_, o_, _, _), _ = k1_bwd_case(
            qk_B, qk_c.num_heads, qk_c.num_kv_heads, qk_S // qk_n, qk_S,
            qk_c.head_dim, True, 0, f32, qk_what, q_offset=off_)
        qk_fwd_err = max(qk_fwd_err, check_close(
            o_, attention_reference(q_, k_, v_, causal=True, q_offset=off_),
            "float32", f"{qk_what}, forward"))
    qk_moved = ({p_: n_ - qk_fwd0[p_]
                 for p_, n_ in fa.flash_attention.path_launches.items()},
                [{m_: n_ - m0[m_] for m_, n_ in f_.mask_launches.items()}
                 for m0, f_ in zip(qk_msk0, (fa.flash_attention,
                                             fa.flash_attention_bwd))])
    if qk_moved != ({"fma": qk_n, "mma": 0, "split_decode": 0},
                    [dict(dict.fromkeys(fa.MASKS, 0), offset=qk_n)] * 2):
        fail(f"K1 on the quickstart's sequence shards took {qk_moved}")
    phase("K1:quickstart_shards", shards=qk_n,
          shape=str((qk_B, qk_c.num_heads, qk_c.num_kv_heads, qk_S // qk_n,
                     qk_S, qk_c.head_dim)).replace(" ", ""),
          dtype="float32", fwd_path="fma", bwd_path="fma",
          fwd_err=f"{qk_fwd_err:.3e}", fwd_tol=TOL["float32"],
          bwd_err=f"{bwd_err['float32']:.3e}", bwd_tol=BWD_TOL["float32"])
    phase("K1:bwd", cases=len(bwd_cases) + 2 + qk_n,
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
    attn_bwd_src = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
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
         f"one decode_demo run at {Z_SERVE_LAYERS} layers "
         f"({Z_SERVE_LAYERS // zcfg.shared_attention_every} groups)",
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

    def k1_row(name, args, k1_fn, lib_fn, plain, bound, path, err, shape,
               l2_cold=True, iters=20, source=attn_src):
        """One K1 row of phase 15's line at the shape of ``args``: K1
        (``k1_fn(*args)``) and the library call (``lib_fn(*args)``) timed
        on the device (``device_ms``, ``iters`` calls; when ``l2_cold``,
        again over 4 copies of ``args`` in turn, more than the 50 MB of
        L2) and with CUDA events (``time_ms``; 10 calls when ``iters`` is
        below 20), the plain version (``plain``: a callable and its
        calls) with CUDA events, beside ``bound`` (``bound_ms``'s pair),
        the error ``err`` and ``shape``."""
        k1_, lib_ = (lambda: k1_fn(*args)), (lambda: lib_fn(*args))
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": "src/repro/kernels/flash_attention.py:73",
               "path": path, "max_abs_err": err,
               "device_ms": device_ms(k1_, f"{name} K1", iters=iters),
               "library_device_ms": device_ms(lib_, f"{name} SDPA",
                                              iters=iters)}
        if l2_cold:
            copies = [tuple(t.clone() for t in args) for _ in range(4)]
            row["device_ms_cold"] = device_ms(
                cold(k1_fn, copies), f"{name} K1, L2-cold", iters=24)
            row["library_device_ms_cold"] = device_ms(
                cold(lib_fn, copies), f"{name} SDPA, L2-cold", iters=24)
            del copies
        few = dict(iters=10, warmup=2) if iters < 20 else {}
        row.update(ms=time_ms(k1_, **few), library_ms=time_ms(lib_, **few),
                   plain_ms=time_ms(plain[0], iters=plain[1], warmup=1),
                   bound_ms=bound[0], bound_by=bound[1], shape=shape)
        return row

    def row_fields(rows) -> dict:
        """A phase's fields for its K1 rows (a short name -> row): device
        ms warm and L2-cold, the library's beside, and the bound."""
        return {f"{k_}_{f_}".replace(" ", "_"): f"{r_[f_]:.6f}"
                for k_, r_ in rows.items()
                for f_ in ("device_ms", "device_ms_cold", "library_device_ms",
                           "library_device_ms_cold", "bound_ms") if f_ in r_}

    def ulp_check(out, exp, what) -> tuple:
        """``out`` against its plain version ``exp``: the largest error
        held to K1_ULPS bf16 units in the last place of exp's largest
        magnitude.  Returns the error and the bound."""
        top = exp.float().abs().max().item()
        bound = K1_ULPS * 2.0 ** (np.floor(np.log2(top)) - 7)
        err = (out.float() - exp.float()).abs().max().item()
        if err > bound:
            fail(f"{what}: max abs error {err:.3e} over {K1_ULPS} bf16 ulps "
                 f"of its largest entry {top:.3e} ({bound:.3e})")
        return err, bound

    def drop_tile(k, v):
        """k and v without their middle 64-key tile, and its first key:
        what a kernel that skipped that tile would read."""
        t0 = k.shape[2] // fa.TILE_K // 2 * fa.TILE_K
        keep = torch.cat([torch.arange(t0, device=k.device), torch.arange(
            t0 + fa.TILE_K, k.shape[2], device=k.device)])
        return k[:, :, keep], v[:, :, keep], t0

    def caught(planted, exp, bound, what) -> float:
        """A planted fault's gap from ``exp``, which ``bound`` must
        reject."""
        gap = (planted.float() - exp.float()).abs().max().item()
        if gap <= bound:
            fail(f"{what}: a planted one-tile drop moves it by {gap:.3e}, "
                 f"within the bound {bound:.3e}")
        return gap

    sdpa = F.scaled_dot_product_attention
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
    # bounds as the granite rows': q, k and v (the kv_len keys) read and
    # the output written once in bf16; the work is QK^T and PV over the
    # keys each row sees
    p_k1_dec = lambda q_, k_, v_: ops.flash_attention(q_, k_, v_,
                                                      causal=False,
                                                      kv_len=p_kv)
    p_rows = {
        "decode": k1_row(
            "flash_attention_fwd (phi4 decode, G=3, D=128)", pdargs, p_k1_dec,
            lambda q_, k_, v_: sdpa(q_, k_[:, :, :p_n], v_[:, :, :p_n],
                                    enable_gqa=True),
            (lambda: attention_reference(*pdargs, causal=False,
                                         kv_len=p_kv), 20),
            bound_ms(2 * (2 * BATCH * pH * pD + 2 * BATCH * pHkv * p_n * pD),
                     4 * BATCH * pH * p_n * pD, "bfloat16"),
            "split_decode", p_err["decode"],
            f"B={BATCH} H={pH} Hkv={pHkv} D={pD} kv_len={p_n} of {CACHE} "
            "bf16"),
        "prefill": k1_row(
            "flash_attention_fwd (phi4 prefill, causal)", ppargs,
            lambda q_, k_, v_: ops.flash_attention(q_, k_, v_, causal=True),
            lambda q_, k_, v_: sdpa(q_, k_, v_, is_causal=True,
                                    enable_gqa=True),
            (lambda: attention_reference(*ppargs, causal=True), 10),
            bound_ms(2 * (2 * BATCH * PROMPT * pH * pD
                          + 2 * BATCH * PROMPT * pHkv * pD),
                     4 * BATCH * pH * pD * (PROMPT * (PROMPT + 1) // 2),
                     "bfloat16"),
            "mma", p_err["prefill"],
            f"B={BATCH} H={pH} Hkv={pHkv} D={pD} Sq=Sk={PROMPT} bf16, the "
            "group kernel")}
    p_rows["decode"]["host_us"] = host_us(lambda: p_k1_dec(*pdargs))
    phase("phi4:K1", cases=sum(p_paths.values()),
          paths=json.dumps(p_paths, separators=(",", ":")),
          decode_err=f"{p_err['decode_all']:.3e}",
          prefill_err=f"{p_err['prefill']:.3e}",
          prefill_mma_kernel="group", tol=TOL["bfloat16"],
          **row_fields(p_rows))
    del pkc, pvc, pdargs, ppargs
    torch.cuda.empty_cache()

    def ulp_bands(out, exp, what) -> list:
        """``ulp_check`` on each half of the sequence axis (dim 2: the
        rows of o and dq, the keys of dk and dv), each against its own
        largest entry: a causal output's first rows (row 0 is v's first
        key itself) are far larger than its last, which average thousands
        of keys.  Returns each half's (error, bound)."""
        h_ = out.shape[2] // 2
        return [ulp_check(out[:, :, sl], exp[:, :, sl], f"{what}, {nm}")
                for nm, sl in (("first half", slice(0, h_)),
                               ("second half", slice(h_, None)))]

    def causal_tile_drop(q, k, v, do):
        """o and dq of causal attention at one batch row, in fp32, with the
        middle 64-key tile left out of every row's keys: what a kernel that
        skipped that tile would give.  Returns them and the tile's first
        key."""
        S_ = k.shape[2]
        t0 = S_ // fa.TILE_K // 2 * fa.TILE_K
        qf = q.float().requires_grad_()
        kf, vf = (t.float().repeat_interleave(q.shape[1] // k.shape[1], 1)
                  for t in (k, v))
        ii = torch.arange(S_, device=q.device)
        keep = (ii[:, None] >= ii[None, :]) & ~(
            (ii[None, :] >= t0) & (ii[None, :] < t0 + fa.TILE_K))
        s_ = (qf @ kf.transpose(-1, -2)) * q.shape[-1] ** -0.5
        o_ = torch.softmax(s_.masked_fill(~keep, float("-inf")), -1) @ vf
        dq_, = torch.autograd.grad(o_, qf, do.float())
        return o_.detach(), dq_, t0

    # -- 3c, continued: dense:K1 -- K1 at the dense training configs'
    # shapes (bf16, D = 128, S = 4096, causal, with the lse), before any of
    # their model phases: phi4-mini's (B = 8, H = 24, Hkv = 8: G = 3),
    # qwen2.5's (B = 2, a microbatch of 8 in 4; H = 40: G = 5) and
    # internlm2's (B = 4, a microbatch in 2; H = 48: G = 6).  The forward
    # on mma's block kernel, the backward on wgmma, twice bit for bit; each
    # batch row against the plain versions within TOL (BWD_TOL) and within
    # K1_ULPS of each half's largest entry (each output on its own), a
    # dropped middle key tile planted at row 0 that the second half's
    # bound must reject; device times warm and L2-cold (each call on its
    # own copy of the inputs, SDPA's backward on its own graph's saved
    # tensors), SDPA's forward and backward beside each, the bounds (phase
    # 15's six dense rows)
    dense_k1 = {}              # tag -> (rows, errors, tile-drop gaps)
    for dn_tag, dn_name in DENSE_TRAIN.items():
        dn_c = get_config(dn_name)
        dB = TRAIN_BATCH // dn_c.train_microbatches
        dH, dHkv, dD = dn_c.num_heads, dn_c.num_kv_heads, dn_c.head_dim
        dq_, ddo_ = (rand((dB, tS, dH, dD), bf16).transpose(1, 2)
                     for _ in range(2))
        dk_, dv_ = (rand((dB, tS, dHkv, dD), bf16).transpose(1, 2)
                    for _ in range(2))
        fwd0 = dict(fa.flash_attention.path_launches)
        bwd0 = dict(fa.flash_attention_bwd.path_launches)
        mma0 = fa.mma_kernel_launches()
        dn_set = (dq_, dk_, dv_, *fa.flash_attention_lse(dq_, dk_, dv_,
                                                         causal=True))
        dn_set = dn_set[:4] + (ddo_, dn_set[4])     # q, k, v, o, dO, lse
        del dq_, dk_, dv_, ddo_
        dn_g = [ops.flash_attention_bwd(*dn_set, causal=True)
                for _ in range(2)]
        torch.cuda.synchronize()
        moved = ({p: n - fwd0[p] for p, n in
                  fa.flash_attention.path_launches.items()},
                 {p: n - bwd0[p] for p, n in
                  fa.flash_attention_bwd.path_launches.items()},
                 {k_: n_ - mma0[k_] for k_, n_ in
                  fa.mma_kernel_launches().items()})
        if moved != ({"fma": 0, "mma": 1, "split_decode": 0},
                     {"fma": 0, "wgmma": 2}, {"block": 1, "group": 0}):
            fail(f"K1 at {dn_tag}'s training shape took {moved}")
        if not all(torch.equal(a, b) for a, b in zip(*dn_g)):
            fail(f"K1 backward at {dn_tag}'s training shape: two runs "
                 "differ")
        t_names = ("o", "dq", "dk", "dv")
        # per output: the TOL error, and each half's K1_ULPS error and
        # least bound over the batch rows
        dn_err = {n_: [0.0, [0.0, np.inf], [0.0, np.inf]] for n_ in t_names}
        dn_drop, dn_lse = {}, 0.0
        for b_ in range(dB):
            a_ = [t[b_:b_ + 1] for t in dn_set]
            dn_lse = max(dn_lse, check_close(
                a_[5], attention_lse_reference(*a_[:2], causal=True),
                "float32", f"K1 lse at {dn_tag}'s train shape, row {b_}",
                BWD_TOL["float32"]))
            got_ = dict(zip(t_names, (a_[3], *(g_[b_:b_ + 1]
                                               for g_ in dn_g[0]))))
            exp_ = dict(zip(t_names, (
                attention_reference(*a_[:3], causal=True),
                *attention_backward_reference(*a_, causal=True))))
            bands = {}
            for n_ in t_names:
                e_ = check_close(got_[n_], exp_[n_], "bfloat16",
                                 f"K1 at {dn_tag}'s train shape, {n_} of "
                                 f"row {b_}", BWD_TOL["bfloat16"])
                bands[n_] = ulp_bands(got_[n_], exp_[n_], f"K1 at {dn_tag}'s"
                                      f" train shape, {n_} of row {b_}")
                dn_err[n_] = [max(dn_err[n_][0], e_)] + [
                    [max(h[0], u[0]), min(h[1], u[1])]
                    for h, u in zip(dn_err[n_][1:], bands[n_])]
            if b_ == 0:
                od_, dqd_, t0 = causal_tile_drop(a_[0], a_[1], a_[2], a_[4])
                planted = {"o": od_, "dq": dqd_}
                for n_ in ("dk", "dv"):     # that tile's rows left unwritten
                    planted[n_] = exp_[n_].clone()
                    planted[n_][:, :, t0:t0 + fa.TILE_K] = 0
                h_ = tS // 2                # the tile opens the second half
                for n_ in t_names:
                    dn_drop[n_] = caught(
                        planted[n_][:, :, h_:], exp_[n_][:, :, h_:],
                        bands[n_][1][1], f"K1 at {dn_tag}'s train shape, "
                        f"{n_}")
                del od_, dqd_, planted
            del got_, exp_
        del dn_g
        dsq, dsk, dsv = (t.detach().requires_grad_() for t in dn_set[:3])
        ds_out = sdpa(dsq, dsk, dsv, is_causal=True, enable_gqa=True)
        dshape = (f"B={dB} H={dH} Hkv={dHkv} D={dD} S={tS} causal bf16 (a "
                  f"microbatch of {TRAIN_BATCH} in "
                  f"{dn_c.train_microbatches})")
        f_w = kmeta.attention_work(dB, dH, dHkv, tS, tS, dD, 2, True,
                                   with_lse=True)
        b_w = kmeta.attention_work(dB, dH, dHkv, tS, tS, dD, 2, True,
                                   backward=True)
        dn_rows = {
            "train fwd": k1_row(
                f"flash_attention_fwd ({dn_tag} train, G={dH // dHkv}, "
                f"D={dD}, with lse)", dn_set[:3],
                lambda q_, k_, v_: fa.flash_attention_lse(q_, k_, v_,
                                                          causal=True),
                lambda q_, k_, v_: sdpa(q_, k_, v_, is_causal=True,
                                        enable_gqa=True),
                (per_row(attention_reference, dn_set[:3]), 2),
                bound_ms(f_w[1], f_w[0], "bfloat16"), "mma",
                dn_err["o"][0], dshape + ", the block kernel", iters=8),
            "train bwd": k1_row(
                f"flash_attention_bwd ({dn_tag} train, G={dH // dHkv}, "
                f"D={dD})", dn_set,
                lambda *a_: ops.flash_attention_bwd(*a_, causal=True),
                lambda *a_, o_=ds_out, l_=(dsq, dsk, dsv): torch.autograd
                .grad(o_, l_, a_[4], retain_graph=True),
                (per_row(attention_backward_reference, dn_set), 2),
                bound_ms(b_w[1], b_w[0], "bfloat16"), "wgmma",
                max(dn_err[n_][0] for n_ in t_names[1:]), dshape, iters=4,
                source=attn_bwd_src)}
        halves = lambda e_: {"first_half": e_[1], "second_half": e_[2]}
        dn_rows["train fwd"]["max_abs_err_ulps"] = halves(dn_err["o"])
        dn_rows["train bwd"]["max_abs_err_by_gradient"] = {
            n_: dict(max_abs_err=e_[0], ulps=halves(e_))
            for n_, e_ in dn_err.items() if n_ != "o"}
        dense_k1[dn_tag] = (dn_rows, dn_err, dn_drop)
        phase(f"dense:K1:{dn_tag}", shape=dshape.replace(" ", "_"),
              paths="mma,wgmma", mma_kernel="block",
              bwd_bitwise_repeatable=True, lse_err=f"{dn_lse:.3e}",
              tol=TOL["bfloat16"], ulps=K1_ULPS,
              err=json.dumps({n_: [f"{e_[0]:.3e}"] + [
                  f"{h[0]:.3e}/{h[1]:.3e}" for h in e_[1:]]
                  for n_, e_ in dn_err.items()}, separators=(",", ":")),
              tile_drop_gap=json.dumps({k_: f"{v_:.3e}"
                                        for k_, v_ in dn_drop.items()},
                                       separators=(",", ":")),
              **row_fields(dn_rows))
        del dn_set, ds_out, dsq, dsk, dsv
        torch.cuda.empty_cache()
    mark("phi4_K1")

    # -- 3d. moe:K1 -- K1 at the MoE family's shapes (D = 128), before any
    # MoE model phase: mixtral's G = 4 (32 heads over 8) and qwen3-moe's
    # G = 16 (64 over 4, all 16 rows of a split_decode tile).  Decode over
    # a 512-slot cache at kv_lens around tile edges, 384 (qwen3-moe's last)
    # and 512 (mixtral's every step: its rolling window buffer counts every
    # slot live, as the reference's); causal prefill at S = 256 on mma
    # (mixtral's group kernel with its window of 4096, which must change no
    # bit at S <= window; qwen3-moe's block kernel: 2 B Hkv = 128 CTAs are
    # fewer than the SMs); mixtral's training shape (B = 1, S = 4096, with
    # the lse and the window) forward and backward, twice bit for bit and
    # equal to the causal call's bit for bit; and the window biting at
    # Sq = Sk = 8192 (block kernel).  Device times warm and L2-cold, SDPA
    # beside each (an explicit band mask for the biting window), the
    # bounds as the other K1 rows': q, k, v (the keys each row reads) and
    # the output once in bf16; the work QK^T and PV over the keys each row
    # sees (the backward's five products; the window's band)
    xcfg, qcfg = get_config(MIXTRAL), get_config(QWEN3)
    moe_err, moe_rows, moe_kernel = {}, {}, {}
    paths0 = dict(case_paths)
    for tag, c_, kernel in (("mixtral", xcfg, "group"),
                            ("qwen3", qcfg, "block")):
        H_, Hkv_, D_ = c_.num_heads, c_.num_kv_heads, c_.head_dim
        win = c_.window if c_.attention == "swa" else 0
        kc_, vc_ = (rand((BATCH, CACHE, Hkv_, D_), bf16) for _ in range(2))
        dargs = (rand((BATCH, 1, H_, D_), bf16).transpose(1, 2),
                 kc_.transpose(1, 2), vc_.transpose(1, 2))
        moe_err[f"{tag} decode"] = 0.0
        for n_ in (1, 63, 64, 65, 200, PROMPT + DECODE, CACHE):
            _, e_ = k1_case(
                *dargs, f"{tag} decode {BATCH}x{H_}x{Hkv_} D={D_} kv_len "
                f"{n_}", causal=False,
                kv_len=torch.tensor(n_, dtype=torch.int32, device=dev))
            moe_err[f"{tag} decode"] = max(moe_err[f"{tag} decode"], e_)
        pargs_ = tuple(rand((BATCH, PROMPT, h_, D_), bf16).transpose(1, 2)
                       for h_ in (H_, Hkv_, Hkv_))
        out_, moe_err[f"{tag} prefill"] = k1_case(
            *pargs_, f"{tag} prefill {BATCH}x{H_}x{Hkv_} S={PROMPT} D={D_}",
            mma_kernel=kernel, causal=True, window=win)
        if win and not torch.equal(out_, ops.flash_attention(
                *pargs_, causal=True)):
            fail(f"{tag} prefill: the window of {win} changed K1's output "
                 f"at S = {PROMPT}")
        moe_kernel[tag] = kernel
        # the path's kv_len: every slot of mixtral's rolling buffer (an
        # int, as decode_attn_apply passes it), qwen3-moe's last step's
        n_ = CACHE if win else PROMPT + DECODE
        kvl = n_ if win else torch.tensor(n_, dtype=torch.int32, device=dev)
        moe_rows[f"{tag} decode"] = k1_row(
            f"flash_attention_fwd ({tag} decode, G={H_ // Hkv_}, D={D_})",
            dargs, lambda q_, k_, v_, kvl=kvl: ops.flash_attention(
                q_, k_, v_, causal=False, kv_len=kvl),
            lambda q_, k_, v_, n_=n_: sdpa(q_, k_[:, :, :n_], v_[:, :, :n_],
                                           enable_gqa=True),
            (lambda a_=dargs, kvl=kvl: attention_reference(
                *a_, causal=False, kv_len=kvl), 20),
            bound_ms(2 * (2 * BATCH * H_ * D_ + 2 * BATCH * Hkv_ * n_ * D_),
                     4 * BATCH * H_ * n_ * D_, "bfloat16"),
            "split_decode", moe_err[f"{tag} decode"],
            f"B={BATCH} H={H_} Hkv={Hkv_} D={D_} kv_len={n_} of {CACHE} "
            "bf16")
        moe_rows[f"{tag} prefill"] = k1_row(
            f"flash_attention_fwd ({tag} prefill, G={H_ // Hkv_}, D={D_})",
            pargs_, lambda q_, k_, v_, win=win: ops.flash_attention(
                q_, k_, v_, causal=True, window=win),
            lambda q_, k_, v_: sdpa(q_, k_, v_, is_causal=True,
                                    enable_gqa=True),
            (lambda a_=pargs_, win=win: attention_reference(
                *a_, causal=True, window=win), 10),
            bound_ms(2 * 2 * BATCH * PROMPT * (H_ + Hkv_) * D_,
                     4 * BATCH * H_ * D_ * (PROMPT * (PROMPT + 1) // 2),
                     "bfloat16"),
            "mma", moe_err[f"{tag} prefill"],
            f"B={BATCH} H={H_} Hkv={Hkv_} D={D_} Sq=Sk={PROMPT} causal"
            f"{f' window={win}' if win else ''} bf16, the {kernel} kernel")
        del kc_, vc_, dargs, pargs_
    m_paths = {k_: case_paths[k_] - paths0[k_] for k_ in case_paths}
    if m_paths != {"fma": 0, "mma": 2, "split_decode": 14}:
        fail(f"MoE K1 cases took paths {m_paths}")
    # mixtral's training shape, B cut to 1 for the plain version's memory
    xH, xHkv, xD, xW = xcfg.num_heads, xcfg.num_kv_heads, xcfg.head_dim, \
        xcfg.window
    bwd_err["bfloat16"] = 0.0
    xargs_1, xgot = k1_bwd_case(1, xH, xHkv, tS, tS, xD, True, xW, bf16,
                                f"mixtral bwd train shape S={tS} window {xW}")
    moe_err["train bwd"] = bwd_err["bfloat16"]
    xq, xk, xv, xo, xdo, xlse = xargs_1
    again = ops.flash_attention_bwd(*xargs_1, causal=True, window=xW)
    o0, lse0 = fa.flash_attention_lse(xq, xk, xv, causal=True)
    g0 = ops.flash_attention_bwd(xq, xk, xv, o0, xdo, lse0, causal=True)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(xgot, again)):
        fail("K1 backward at mixtral's shape: two runs differ")
    if not (torch.equal(xo, o0) and torch.equal(xlse, lse0) and
            all(torch.equal(a, b) for a, b in zip(xgot, g0))):
        fail(f"K1 at mixtral's training shape: the window of {xW} changed "
             f"the output, lse or gradients at S = {tS}")
    moe_err["train fwd"] = check_close(
        xo, attention_reference(xq, xk, xv, causal=True), "bfloat16",
        f"K1 forward at mixtral's train shape S={tS}")
    del xargs_1, xgot, again, o0, lse0, g0, xq, xk, xv, xo, xdo, xlse
    # the window biting: twice the window, on the block kernel
    wS = 2 * xW
    wargs = tuple(rand((1, wS, h_, xD), bf16).transpose(1, 2)
                  for h_ in (xH, xHkv, xHkv))
    _, moe_err["window"] = k1_case(
        *wargs, f"mixtral window {xW} at Sq=Sk={wS}", mma_kernel="block",
        causal=True, window=xW)
    ii = torch.arange(wS, device=dev)
    band = (ii[:, None] >= ii[None, :]) & (ii[:, None] - ii[None, :] < xW)
    # SDPA's kernels that take a mask do not take enable_gqa: k and v
    # expanded to the query heads beforehand
    wlib = (wargs[0], *(t.repeat_interleave(xH // xHkv, dim=1)
                        for t in wargs[1:]))
    # mixtral's training path calls K1 at B = 4 (a microbatch of 8 x 4096
    # in two): forward with its lse and backward, SDPA beside each
    xmb = TRAIN_BATCH // xcfg.train_microbatches
    xq_, xdo_ = (rand((xmb, tS, xH, xD), bf16).transpose(1, 2)
                 for _ in range(2))
    xk_, xv_ = (rand((xmb, tS, xHkv, xD), bf16).transpose(1, 2)
                for _ in range(2))
    xbwd_set = (xq_, xk_, xv_, *fa.flash_attention_lse(
        xq_, xk_, xv_, causal=True, window=xW))
    xbwd_set = xbwd_set[:4] + (xdo_, xbwd_set[4])   # q, k, v, o, dO, lse
    del xq_, xk_, xv_, xdo_
    xsq, xsk, xsv = (t.detach().requires_grad_() for t in xbwd_set[:3])
    xs_out = sdpa(xsq, xsk, xsv, is_causal=True, enable_gqa=True)
    xpairs = tS * (tS + 1) // 2
    wpairs = sum(min(i_ + 1, xW) for i_ in range(wS))
    xshape = f"B={xmb} H={xH} Hkv={xHkv} D={xD} S={tS} causal window={xW} bf16"
    moe_rows["mixtral train fwd"] = k1_row(
        "flash_attention_fwd (mixtral train, causal, window, with lse)",
        xbwd_set[:3], lambda q_, k_, v_: fa.flash_attention_lse(
            q_, k_, v_, causal=True, window=xW),
        lambda q_, k_, v_: sdpa(q_, k_, v_, is_causal=True, enable_gqa=True),
        (per_row(lambda *a_, causal: attention_reference(
            *a_, causal=causal, window=xW), xbwd_set[:3]), 2),
        bound_ms(2 * 2 * xmb * tS * (xH + xHkv) * xD + 4 * xmb * xH * tS,
                 2 * 2 * xmb * xH * xD * xpairs, "bfloat16"),
        "mma", moe_err["train fwd"], xshape, l2_cold=False, iters=8)
    moe_rows["mixtral train bwd"] = k1_row(
        "flash_attention_bwd (mixtral train, causal, window)", xbwd_set,
        lambda *a_: ops.flash_attention_bwd(*a_, causal=True, window=xW),
        lambda *a_: torch.autograd.grad(xs_out, (xsq, xsk, xsv), a_[4],
                                        retain_graph=True),
        (per_row(lambda *a_, causal: attention_backward_reference(
            *a_, causal=causal, window=xW), xbwd_set), 2),
        bound_ms(2 * (4 * xmb * tS * xH * xD + 4 * xmb * tS * xHkv * xD)
                 + 4 * xmb * xH * tS, 5 * 2 * xmb * xH * xD * xpairs,
                 "bfloat16"),
        "wgmma", moe_err["train bwd"], xshape, l2_cold=False, iters=4,
        source=attn_bwd_src)
    moe_rows["mixtral window"] = k1_row(
        "flash_attention_fwd (mixtral, the window biting)", wargs,
        lambda q_, k_, v_: ops.flash_attention(q_, k_, v_, causal=True,
                                               window=xW),
        lambda *a_: sdpa(*wlib, attn_mask=band),
        (lambda: attention_reference(*wargs, causal=True, window=xW), 2),
        bound_ms(2 * 2 * wS * (xH + xHkv) * xD, 4 * xH * xD * wpairs,
                 "bfloat16"),
        "mma", moe_err["window"],
        f"B=1 H={xH} Hkv={xHkv} D={xD} Sq=Sk={wS} causal window={xW} "
        "bf16, the block kernel", l2_cold=False, iters=8)
    moe_rows["mixtral window"]["library_note"] = (
        "SDPA with the boolean band mask, k and v expanded to the query "
        "heads (its kernels that take a mask do not take enable_gqa)")
    phase("moe:K1", cases=sum(m_paths.values()) + 2,
          paths=json.dumps(m_paths, separators=(",", ":")),
          **{k_.replace(" ", "_") + "_err": f"{v_:.3e}"
             for k_, v_ in moe_err.items()},
          prefill_mma_kernels=f"{moe_kernel['mixtral']},"
                              f"{moe_kernel['qwen3']}",
          window_unchanged_at_s_le_window=True, bwd_bitwise_repeatable=True,
          tol=TOL["bfloat16"], **row_fields(moe_rows))
    del xbwd_set, xs_out, xsq, xsk, xsv, wargs, wlib, band
    torch.cuda.empty_cache()
    mark("moe_K1")

    # -- 3e. zoo:K1 -- K1 at the encoder-decoder (seamless-m4t: H = Hkv =
    # 16, G = 1, D = 64) and the vision-prefix (pixtral: 32 heads over 8 of
    # 128, G = 4) families' shapes, before any of their model phases: the
    # encoder's self-attention over S_ENC = 512 frames and the decoder's
    # cross-attention (Sq = 256 over Sk = 512, no mask) on mma's group
    # kernel; a decode step's cross-attention over 512 valid slots (no
    # kv_len) on split_decode; pixtral's causal 256 patches + 256 text
    # tokens on the block kernel; the training shape (B = 8, S = 4096,
    # non-causal: the encoder's and the cross-attention) forward with its
    # lse and backward, twice bit for bit.  Each against its plain version
    # within TOL and within K1_ULPS of its largest entry (row by row at the
    # training shape, each gradient on its own), a dropped key tile
    # planted beside the non-causal ones; device times warm and L2-cold,
    # SDPA beside each, the bounds
    smcfg, pxcfg = get_config(SEAMLESS), get_config(PIXTRAL)
    eH, eHkv, eD = smcfg.num_heads, smcfg.num_kv_heads, smcfg.head_dim
    vH, vHkv, vD = pxcfg.num_heads, pxcfg.num_kv_heads, pxcfg.head_dim
    vS = pxcfg.frontend.tokens_per_sample + PROMPT
    zoo_err, zoo_ulps, zoo_drop = {}, {}, {}
    paths0 = dict(case_paths)
    enc_ = tuple(rand((BATCH, S_ENC, h_, eD), bf16).transpose(1, 2)
                 for h_ in (eH, eHkv, eHkv))
    cross_ = (rand((BATCH, PROMPT, eH, eD), bf16).transpose(1, 2),
              enc_[1], enc_[2])
    xdec_ = (rand((BATCH, 1, eH, eD), bf16).transpose(1, 2), enc_[1],
             enc_[2])
    pre_ = tuple(rand((BATCH, vS, h_, vD), bf16).transpose(1, 2)
                 for h_ in (vH, vHkv, vHkv))
    zoo_args = {"encoder prefill": (enc_, "group", False),
                "cross prefill": (cross_, "group", False),
                "cross decode": (xdec_, None, False),
                "pixtral prefill": (pre_, "block", True)}
    for zkey, (a_, kern_, causal_) in zoo_args.items():
        out_, zoo_err[zkey] = k1_case(
            *a_, f"zoo {zkey} {tuple(a_[0].shape)} over "
            f"{tuple(a_[1].shape)}", mma_kernel=kern_, causal=causal_)
        exp_ = attention_reference(*a_, causal=causal_)
        zoo_ulps[zkey] = ulp_check(out_, exp_, f"zoo {zkey}")
        if not causal_:
            kd_, vd_, _ = drop_tile(*a_[1:])
            zoo_drop[zkey] = caught(attention_reference(
                a_[0], kd_, vd_, causal=False), exp_, zoo_ulps[zkey][1],
                f"zoo {zkey}")
        del out_, exp_
    zoo_paths = {k_: case_paths[k_] - paths0[k_] for k_ in case_paths}
    if zoo_paths != {"fma": 0, "mma": 3, "split_decode": 1}:
        fail(f"zoo K1 cases took paths {zoo_paths}")
    # the training shape as the rows time it: K1's forward with its lse
    # (mma) and backward (wgmma) at B = 8, each batch row against the plain
    # versions (fp32 scores of one row: 1.1 GB); a tile dropped at row 0
    eq_, edo_ = (rand((TRAIN_BATCH, tS, eH, eD), bf16).transpose(1, 2)
                 for _ in range(2))
    ek_, ev_ = (rand((TRAIN_BATCH, tS, eHkv, eD), bf16).transpose(1, 2)
                for _ in range(2))
    fwd0 = dict(fa.flash_attention.path_launches)
    bwd0 = dict(fa.flash_attention_bwd.path_launches)
    sbwd_set = (eq_, ek_, ev_, *fa.flash_attention_lse(eq_, ek_, ev_,
                                                        causal=False))
    sbwd_set = sbwd_set[:4] + (edo_, sbwd_set[4])   # q, k, v, o, dO, lse
    del eq_, ek_, ev_, edo_
    sg = [ops.flash_attention_bwd(*sbwd_set, causal=False) for _ in range(2)]
    torch.cuda.synchronize()
    moved = ({p: n - fwd0[p] for p, n in fa.flash_attention.path_launches
              .items()}, {p: n - bwd0[p] for p, n in
                          fa.flash_attention_bwd.path_launches.items()})
    if moved != ({"fma": 0, "mma": 1, "split_decode": 0},
                 {"fma": 0, "wgmma": 2}):
        fail(f"K1 at seamless's training shape took the paths {moved}")
    if not all(torch.equal(a, b) for a, b in zip(*sg)):
        fail("K1 backward at seamless's training shape: two runs differ")
    t_names = ("o", "dq", "dk", "dv")
    t_err = {n_: (0.0, np.inf) for n_ in t_names}   # error, least bound
    lse_train = 0.0
    for b_ in range(TRAIN_BATCH):
        a_ = [t[b_:b_ + 1] for t in sbwd_set]
        lse_train = max(lse_train, check_close(
            a_[5], attention_lse_reference(*a_[:2], causal=False),
            "float32", f"K1 lse at seamless's train shape, row {b_}",
            BWD_TOL["float32"]))
        got_ = dict(zip(t_names, (a_[3], *(g_[b_:b_ + 1] for g_ in sg[0]))))
        exp_ = dict(zip(t_names, (
            attention_reference(*a_[:3], causal=False),
            *attention_backward_reference(*a_, causal=False))))
        bounds_ = {}
        for n_ in t_names:
            e_, bounds_[n_] = ulp_check(
                got_[n_], exp_[n_], f"K1 at seamless's train shape, {n_} "
                f"of row {b_}")
            t_err[n_] = (max(t_err[n_][0], e_), min(t_err[n_][1], bounds_[n_]))
        if b_ == 0:
            kd_, vd_, t0 = drop_tile(*a_[1:3])
            od_ = attention_reference(a_[0], kd_, vd_, causal=False)
            planted = {"o": od_, "dq": attention_backward_reference(
                a_[0], kd_, vd_, od_, a_[4], attention_lse_reference(
                    a_[0], kd_, causal=False), causal=False)[0]}
            for n_ in ("dk", "dv"):     # that tile's rows left unwritten
                planted[n_] = exp_[n_].clone()
                planted[n_][:, :, t0:t0 + fa.TILE_K] = 0
            for n_ in t_names:
                zoo_drop[f"train {n_}"] = caught(
                    planted[n_], exp_[n_], bounds_[n_],
                    f"K1 at seamless's train shape, {n_}")
            del kd_, vd_, od_, planted
        del got_, exp_
    zoo_err["train fwd"] = t_err["o"][0]
    zoo_err["train bwd"] = max(t_err[n_][0] for n_ in t_names[1:])
    del sg
    ssq, ssk, ssv = (t.detach().requires_grad_() for t in sbwd_set[:3])
    ss_out = sdpa(ssq, ssk, ssv)
    nc_k1 = lambda q_, k_, v_: ops.flash_attention(q_, k_, v_, causal=False)
    # bounds as the other K1 rows': q, k, v and the output once in bf16
    # (the lse and the backward's tensors as there); the work QK^T and PV
    # over every pair a row sees (the backward's five products)
    zoo_rows = {
        "encoder prefill": k1_row(
            f"flash_attention_fwd (seamless encoder prefill, G=1, D={eD})",
            enc_, nc_k1, sdpa,
            (lambda: attention_reference(*enc_, causal=False), 10),
            bound_ms(2 * 2 * BATCH * S_ENC * (eH + eHkv) * eD,
                     4 * BATCH * eH * eD * S_ENC * S_ENC, "bfloat16"),
            "mma", zoo_err["encoder prefill"],
            f"B={BATCH} H={eH} Hkv={eHkv} D={eD} Sq=Sk={S_ENC} non-causal "
            "bf16, the group kernel"),
        "cross prefill": k1_row(
            f"flash_attention_fwd (seamless cross prefill, G=1, D={eD})",
            cross_, nc_k1, sdpa,
            (lambda: attention_reference(*cross_, causal=False), 10),
            bound_ms(2 * (2 * BATCH * PROMPT * eH * eD
                          + 2 * BATCH * S_ENC * eHkv * eD),
                     4 * BATCH * eH * eD * PROMPT * S_ENC, "bfloat16"),
            "mma", zoo_err["cross prefill"],
            f"B={BATCH} H={eH} Hkv={eHkv} D={eD} Sq={PROMPT} Sk={S_ENC} "
            "non-causal bf16, the group kernel"),
        "cross decode": k1_row(
            f"flash_attention_fwd (seamless cross decode, G=1, D={eD})",
            xdec_, nc_k1, sdpa,
            (lambda: attention_reference(*xdec_, causal=False), 20),
            bound_ms(2 * (2 * BATCH * eH * eD + 2 * BATCH * eHkv * S_ENC * eD),
                     4 * BATCH * eH * S_ENC * eD, "bfloat16"),
            "split_decode", zoo_err["cross decode"],
            f"B={BATCH} H={eH} Hkv={eHkv} D={eD} Sq=1 over {S_ENC} valid "
            "slots (no kv_len) bf16"),
        "pixtral prefill": k1_row(
            f"flash_attention_fwd (pixtral prefill, G={vH // vHkv}, D={vD})",
            pre_, lambda q_, k_, v_: ops.flash_attention(q_, k_, v_,
                                                         causal=True),
            lambda q_, k_, v_: sdpa(q_, k_, v_, is_causal=True,
                                    enable_gqa=True),
            (lambda: attention_reference(*pre_, causal=True), 5),
            bound_ms(2 * 2 * BATCH * vS * (vH + vHkv) * vD,
                     4 * BATCH * vH * vD * (vS * (vS + 1) // 2), "bfloat16"),
            "mma", zoo_err["pixtral prefill"],
            f"B={BATCH} H={vH} Hkv={vHkv} D={vD} Sq=Sk={vS} causal (256 "
            "patches + 256 text) bf16, the block kernel")}
    sshape = f"B={TRAIN_BATCH} H={eH} Hkv={eHkv} D={eD} S={tS} non-causal bf16"
    zoo_rows["train fwd"] = k1_row(
        "flash_attention_fwd (seamless train, non-causal, with lse)",
        sbwd_set[:3], lambda q_, k_, v_: fa.flash_attention_lse(
            q_, k_, v_, causal=False), sdpa,
        (per_row(lambda *a_, causal: attention_reference(*a_, causal=False),
                 sbwd_set[:3]), 2),
        bound_ms(2 * 2 * TRAIN_BATCH * tS * (eH + eHkv) * eD
                 + 4 * TRAIN_BATCH * eH * tS,
                 2 * 2 * TRAIN_BATCH * eH * eD * tS * tS, "bfloat16"),
        "mma", zoo_err["train fwd"], sshape + ", the block kernel",
        l2_cold=False, iters=8)
    zoo_rows["train bwd"] = k1_row(
        "flash_attention_bwd (seamless train, non-causal)", sbwd_set,
        lambda *a_: ops.flash_attention_bwd(*a_, causal=False),
        lambda *a_: torch.autograd.grad(ss_out, (ssq, ssk, ssv), a_[4],
                                        retain_graph=True),
        (per_row(lambda *a_, causal: attention_backward_reference(
            *a_, causal=False), sbwd_set), 2),
        bound_ms(2 * (4 * TRAIN_BATCH * tS * eH * eD
                      + 4 * TRAIN_BATCH * tS * eHkv * eD)
                 + 4 * TRAIN_BATCH * eH * tS,
                 5 * 2 * TRAIN_BATCH * eH * eD * tS * tS, "bfloat16"),
        "wgmma", zoo_err["train bwd"], sshape, l2_cold=False, iters=4,
        source=attn_bwd_src)
    # each row's error beside its K1_ULPS bound (the least over the
    # training shape's batch rows; the backward's, each gradient's)
    for zkey, (e_, b_) in zoo_ulps.items():
        zoo_rows[zkey]["max_abs_err_bound"] = b_
    zoo_rows["train fwd"]["max_abs_err_bound"] = t_err["o"][1]
    zoo_rows["train bwd"]["max_abs_err_by_gradient"] = {
        n_: {"max_abs_err": e_, "bound": b_}
        for n_, (e_, b_) in t_err.items() if n_ != "o"}
    phase("zoo:K1", cases=sum(zoo_paths.values()) + 1,
          paths=json.dumps(zoo_paths, separators=(",", ":")),
          **{k_.replace(" ", "_") + "_err": f"{v_:.3e}"
             for k_, v_ in zoo_err.items()},
          tol=TOL["bfloat16"], ulps=K1_ULPS,
          ulp_err_bound=json.dumps(
              {**{k_: [f"{e_:.3e}", f"{b_:.3e}"]
                  for k_, (e_, b_) in zoo_ulps.items()},
               **{f"train {k_}": [f"{e_:.3e}", f"{b_:.3e}"]
                  for k_, (e_, b_) in t_err.items()}},
              separators=(",", ":")).replace(" ", "_"),
          tile_drop_gap=json.dumps({k_: f"{v_:.3e}"
                                    for k_, v_ in zoo_drop.items()},
                                   separators=(",", ":")).replace(" ", "_"),
          train_lse_err=f"{lse_train:.3e}", bwd_bitwise_repeatable=True,
          **row_fields(zoo_rows))
    del sbwd_set, ss_out, ssq, ssk, ssv, enc_, cross_, xdec_, pre_, zoo_args
    torch.cuda.empty_cache()
    mark("zoo_K1")

    # -- 3f. K1:offset -- K1 with a causal query offset at phi4-mini's sequence
    # shard (phase 27's sequence path at 16 workers: 16 shards of Sq = 256
    # queries over the whole Sk = 4096 keys, B = 8, H = 24, Hkv = 8, D =
    # 128, bf16, offsets 256 r), before any model phase: each shard's
    # forward (with its lse) and backward on mma's block kernel / wgmma,
    # counted under the offset mask; each against the plain versions within
    # TOL and K1_ULPS of its largest entry; the 16 outputs concatenated, dq
    # concatenated and the shard-summed dk, dv against ONE full causal call
    # (SEQ_SUM_ULPS); shard 15 given offset 0 (a planted fault) must fail
    # that bound.  Device times of the 16 shard calls, of the full call and
    # of SDPA with each shard's boolean offset mask; the bound from the
    # offset pairs (phase 15's two seq rows).  Then K1 at qwen3-moe's
    # training shape (a microbatch of B = 1, H = 64, Hkv = 4: G = 16, D =
    # 128, S = 4096, causal): forward with its lse and backward, twice bit
    # for bit, against the plain versions (TOL and K1_ULPS on each half),
    # SDPA beside (phase 15's two G = 16 training rows; their launches
    # phase 28's)
    sp_c = get_config(PHI4)
    spH, spHkv, spD = sp_c.num_heads, sp_c.num_kv_heads, sp_c.head_dim
    sp_n, spS = SEQ_SHARDS, tS
    sp_q_ = spS // sp_n
    sp_off = [r_ * sp_q_ for r_ in range(sp_n)]
    sp_sl = [slice(o_, o_ + sp_q_) for o_ in sp_off]
    sp_q, sp_do = (rand((TRAIN_BATCH, spS, spH, spD), bf16).transpose(1, 2)
                   for _ in range(2))
    sp_k, sp_v = (rand((TRAIN_BATCH, spS, spHkv, spD), bf16).transpose(1, 2)
                  for _ in range(2))

    def sp_fwd(q_, k_, v_, offsets=sp_off):
        """K1's forward with its lse on each query shard, at its offset."""
        return [fa.flash_attention_lse(q_[:, :, s_], k_, v_, causal=True,
                                       q_offset=o_)
                for s_, o_ in zip(sp_sl, offsets)]

    def sp_bwd(outs):
        """K1's backward on each shard, from its forward's output and
        lse."""
        return [ops.flash_attention_bwd(sp_q[:, :, s_], sp_k, sp_v, o_,
                                        sp_do[:, :, s_], l_, causal=True,
                                        q_offset=off_)
                for s_, off_, (o_, l_) in zip(sp_sl, sp_off, outs)]

    fwd0 = dict(fa.flash_attention.path_launches)
    bwd0 = dict(fa.flash_attention_bwd.path_launches)
    msk0 = [dict(f_.mask_launches) for f_ in (fa.flash_attention,
                                              fa.flash_attention_bwd)]
    mma0 = fa.mma_kernel_launches()
    sp_outs = sp_fwd(sp_q, sp_k, sp_v)
    sp_g = [sp_bwd(sp_outs) for _ in range(2)]
    torch.cuda.synchronize()
    moved = ({p: n - fwd0[p] for p, n in
              fa.flash_attention.path_launches.items()},
             {p: n - bwd0[p] for p, n in
              fa.flash_attention_bwd.path_launches.items()},
             [{m_: n_ - m0[m_] for m_, n_ in f_.mask_launches.items()}
              for m0, f_ in zip(msk0, (fa.flash_attention,
                                       fa.flash_attention_bwd))],
             {k_: n_ - mma0[k_] for k_, n_ in
              fa.mma_kernel_launches().items()})
    if moved != ({"fma": 0, "mma": sp_n, "split_decode": 0},
                 {"fma": 0, "wgmma": 2 * sp_n},
                 [dict(dict.fromkeys(fa.MASKS, 0), offset=sp_n),
                  dict(dict.fromkeys(fa.MASKS, 0), offset=2 * sp_n)],
                 {"block": sp_n, "group": 0}):
        fail(f"K1 on phi4's sequence shards took {moved}")
    if not all(torch.equal(a_, b_) for g0, g1 in zip(*sp_g)
               for a_, b_ in zip(g0, g1)):
        fail("K1 backward on phi4's sequence shards: two runs differ")
    sp_g = sp_g[0]
    t_names = ("o", "dq", "dk", "dv")
    sp_err = {n_: [0.0, 0.0, np.inf] for n_ in t_names}  # TOL, ulps, bound
    for r_, (s_, o_) in enumerate(zip(sp_sl, sp_off)):
        a_ = (sp_q[:, :, s_], sp_k, sp_v)
        sp_lse = check_close(
            sp_outs[r_][1], attention_lse_reference(*a_[:2], causal=True,
                                                    q_offset=o_),
            "float32", f"K1 lse of phi4's sequence shard {r_}",
            BWD_TOL["float32"])
        exp_ = (attention_reference(*a_, causal=True, q_offset=o_),
                *attention_backward_reference(
                    *a_, sp_outs[r_][0], sp_do[:, :, s_], sp_outs[r_][1],
                    causal=True, q_offset=o_))
        for n_, got_, e_ in zip(t_names, (sp_outs[r_][0], *sp_g[r_]), exp_):
            what = f"K1 on phi4's sequence shard {r_} (offset {o_}), {n_}"
            t_ = check_close(got_, e_, "bfloat16", what, BWD_TOL["bfloat16"])
            u_, b_ = ulp_check(got_, e_, what)
            sp_err[n_] = [max(sp_err[n_][0], t_), max(sp_err[n_][1], u_),
                          min(sp_err[n_][2], b_)]
        del exp_
    # the shards against ONE full causal call: o and dq concatenated, dk
    # and dv summed over the shards (in fp32, of the shards' bf16 partials)
    sp_full = fa.flash_attention_lse(sp_q, sp_k, sp_v, causal=True)
    sp_fg = ops.flash_attention_bwd(sp_q, sp_k, sp_v, sp_full[0], sp_do,
                                    sp_full[1], causal=True)
    sp_cat = {"o": torch.cat([o_ for o_, _ in sp_outs], 2),
              "dq": torch.cat([g_[0] for g_ in sp_g], 2),
              "dk": sum(g_[1].float() for g_ in sp_g),
              "dv": sum(g_[2].float() for g_ in sp_g)}
    sp_whole = dict(zip(t_names, (sp_full[0], *sp_fg)))

    def sum_bands(out, exp, what, ulps) -> list:
        """``out`` against ``exp`` on each half of dim 2 within ``ulps``
        bf16 units of that half's largest entry; each half's (error,
        bound)."""
        h_, res = out.shape[2] // 2, []
        for nm, sl in (("first half", slice(0, h_)),
                       ("second half", slice(h_, None))):
            top = exp[:, :, sl].float().abs().max().item()
            bound = ulps * 2.0 ** (np.floor(np.log2(top)) - 7)
            err = (out[:, :, sl].float() - exp[:, :, sl].float()).abs().max(
                ).item()
            if err > bound:
                fail(f"{what}, {nm}: {err:.3e} over {ulps} bf16 ulps of its "
                     f"largest entry {top:.3e} ({bound:.3e})")
            res.append((err, bound))
        return res

    sp_vs_full = {n_: sum_bands(sp_cat[n_], sp_whole[n_],
                                f"phi4's {sp_n} sequence shards against one "
                                f"full causal call, {n_}",
                                K1_ULPS if n_ in ("o", "dq") else SEQ_SUM_ULPS)
                  for n_ in t_names}
    sp_bitwise = {n_: bool(torch.equal(sp_cat[n_].to(sp_whole[n_].dtype),
                                       sp_whole[n_])) for n_ in ("o", "dq")}
    # a planted fault: the last shard given offset 0 (it sees the first 256
    # keys only); the second half's bound must reject it
    sp_bad = sp_fwd(sp_q, sp_k, sp_v, sp_off[:-1] + [0])
    sp_planted = caught(torch.cat([o_ for o_, _ in sp_bad],
                                  2)[:, :, spS // 2:],
                        sp_whole["o"][:, :, spS // 2:],
                        sp_vs_full["o"][1][1],
                        "phi4's sequence shards, shard 15 at offset 0")
    del sp_bad, sp_cat
    # times: the 16 shard calls (a row's unit), the full call, SDPA with
    # each shard's boolean offset mask; the bound over the offset pairs
    sp_masks = [(torch.arange(spS, device=dev)[None, :] <= o_ + torch.arange(
        sp_q_, device=dev)[:, None]) for o_ in sp_off]
    sp_sdpa = lambda q_, k_, v_: [
        sdpa(q_[:, :, s_], k_, v_, attn_mask=m_, enable_gqa=True)
        for s_, m_ in zip(sp_sl, sp_masks)]
    sp_w = [kmeta.attention_work(TRAIN_BATCH, spH, spHkv, sp_q_, spS, spD, 2,
                                 True, with_lse=True, q_offset=o_)
            for o_ in sp_off]
    sp_wb = [kmeta.attention_work(TRAIN_BATCH, spH, spHkv, sp_q_, spS, spD,
                                  2, True, backward=True, q_offset=o_)
             for o_ in sp_off]
    sp_sq = [t.detach().requires_grad_() for t in (sp_q, sp_k, sp_v)]
    sp_souts = sp_sdpa(*sp_sq)
    sp_shape = (f"{sp_n} calls: B={TRAIN_BATCH} H={spH} Hkv={spHkv} D={spD} "
                f"Sq={sp_q_} over Sk={spS}, q_offset=256r, bf16, the block "
                "kernel")
    sp_rows = {
        "offset fwd": k1_row(
            f"flash_attention_fwd (phi4 sequence shards, {sp_n} offset "
            "calls, with lse)", (sp_q, sp_k, sp_v), sp_fwd, sp_sdpa,
            (lambda: [attention_reference(sp_q[:, :, s_], sp_k, sp_v,
                                          causal=True, q_offset=o_)
                      for s_, o_ in zip(sp_sl, sp_off)], 2),
            bound_ms(sum(w_[1] for w_ in sp_w), sum(w_[0] for w_ in sp_w),
                     "bfloat16"), "mma", sp_err["o"][0], sp_shape,
            l2_cold=False, iters=4),
        "offset bwd": k1_row(
            f"flash_attention_bwd (phi4 sequence shards, {sp_n} offset "
            "calls)", (), lambda: sp_bwd(sp_outs),
            lambda: torch.autograd.grad(
                sp_souts, sp_sq, [sp_do[:, :, s_] for s_ in sp_sl],
                retain_graph=True),
            (lambda: [attention_backward_reference(
                sp_q[:, :, s_], sp_k, sp_v, o_, sp_do[:, :, s_], l_,
                causal=True, q_offset=off_)
                for s_, off_, (o_, l_) in zip(sp_sl, sp_off, sp_outs)], 2),
            bound_ms(sum(w_[1] for w_ in sp_wb), sum(w_[0] for w_ in sp_wb),
                     "bfloat16"), "wgmma",
            max(sp_err[n_][0] for n_ in t_names[1:]), sp_shape, l2_cold=False,
            iters=2, source=attn_bwd_src)}
    sp_full_fwd = lambda: fa.flash_attention_lse(sp_q, sp_k, sp_v,
                                                 causal=True)
    sp_rows["offset fwd"].update(
        full_call_ms=time_ms(sp_full_fwd, iters=10, warmup=2),
        full_call_note="one causal K1 call at S=4096 on the same inputs",
        vs_full_call_err=json.dumps({n_: [f"{e_:.3e}/{b_:.3e}"
                                          for e_, b_ in v_]
                                     for n_, v_ in sp_vs_full.items()}),
        planted_offset_gap=sp_planted, library_note="SDPA with each "
        "shard's (Sq, Sk) boolean offset mask, 16 calls")
    sp_full_bwd = lambda: ops.flash_attention_bwd(
        sp_q, sp_k, sp_v, sp_full[0], sp_do, sp_full[1], causal=True)
    sp_rows["offset bwd"].update(
        full_call_ms=time_ms(sp_full_bwd, iters=10, warmup=2),
        library_note="SDPA's backward from its 16 masked forwards")
    for n_, f_ in (("offset fwd", ("o",)),
                   ("offset bwd", ("dq", "dk", "dv"))):
        sp_rows[n_]["max_abs_err_ulps"] = {
            k_: {"error": sp_err[k_][1], "bound": sp_err[k_][2]} for k_ in f_}
    phase("K1:offset", shards=sp_n, shard_rows=sp_q_, keys=spS,
          paths="mma(block),wgmma", masks="offset",
          bwd_bitwise_repeatable=True, tol=TOL["bfloat16"], ulps=K1_ULPS,
          sum_ulps=SEQ_SUM_ULPS,
          err=json.dumps({n_: [f"{e_[0]:.3e}", f"{e_[1]:.3e}/{e_[2]:.3e}"]
                          for n_, e_ in sp_err.items()},
                         separators=(",", ":")),
          vs_full=json.dumps({n_: [f"{e_:.3e}/{b_:.3e}" for e_, b_ in v_]
                              for n_, v_ in sp_vs_full.items()},
                             separators=(",", ":")),
          bitwise_vs_full=json.dumps(sp_bitwise, separators=(",", ":")),
          planted_offset_gap=f"{sp_planted:.3e}",
          ms_16_calls=f"{sp_rows['offset fwd']['ms']:.4f}",
          ms_full_call=f"{sp_rows['offset fwd']['full_call_ms']:.4f}",
          bwd_ms_16_calls=f"{sp_rows['offset bwd']['ms']:.4f}",
          bwd_ms_full_call=f"{sp_rows['offset bwd']['full_call_ms']:.4f}",
          **row_fields(sp_rows))
    del sp_outs, sp_g, sp_full, sp_fg, sp_whole, sp_souts, sp_sq, sp_masks
    del sp_q, sp_k, sp_v, sp_do
    torch.cuda.empty_cache()
    # K1 at qwen3-moe's training shape (G = 16): a microbatch of 1 x 4096
    qm_c = get_config(QWEN3)
    qmB = TRAIN_BATCH // qm_c.train_microbatches
    qmH, qmHkv, qmD = qm_c.num_heads, qm_c.num_kv_heads, qm_c.head_dim
    qm_q, qm_do = (rand((qmB, tS, qmH, qmD), bf16).transpose(1, 2)
                   for _ in range(2))
    qm_k, qm_v = (rand((qmB, tS, qmHkv, qmD), bf16).transpose(1, 2)
                  for _ in range(2))
    qm_set = (qm_q, qm_k, qm_v, *fa.flash_attention_lse(qm_q, qm_k, qm_v,
                                                        causal=True))
    qm_set = qm_set[:4] + (qm_do, qm_set[4])        # q, k, v, o, dO, lse
    qm_g = [ops.flash_attention_bwd(*qm_set, causal=True) for _ in range(2)]
    if not all(torch.equal(a_, b_) for a_, b_ in zip(*qm_g)):
        fail("K1 backward at qwen3-moe's training shape: two runs differ")
    qm_exp = dict(zip(t_names, (
        attention_reference(*qm_set[:3], causal=True),
        *attention_backward_reference(*qm_set, causal=True))))
    qm_err = {}
    for n_, got_ in zip(t_names, (qm_set[3], *qm_g[0])):
        what = f"K1 at qwen3-moe's training shape, {n_}"
        qm_err[n_] = [check_close(got_, qm_exp[n_], "bfloat16", what,
                                  BWD_TOL["bfloat16"]),
                      *ulp_bands(got_, qm_exp[n_], what)]
    del qm_g, qm_exp
    qm_sq = [t.detach().requires_grad_() for t in qm_set[:3]]
    qm_sout = sdpa(*qm_sq, is_causal=True, enable_gqa=True)
    qm_shape = (f"B={qmB} H={qmH} Hkv={qmHkv} D={qmD} S={tS} causal bf16 (a "
                f"microbatch of {TRAIN_BATCH} in {qm_c.train_microbatches})")
    qm_fw = kmeta.attention_work(qmB, qmH, qmHkv, tS, tS, qmD, 2, True,
                                 with_lse=True)
    qm_bw = kmeta.attention_work(qmB, qmH, qmHkv, tS, tS, qmD, 2, True,
                                 backward=True)
    qm_rows = {
        "train fwd": k1_row(
            f"flash_attention_fwd (qwen3moe train, G={qmH // qmHkv}, "
            f"D={qmD}, with lse)", qm_set[:3],
            lambda q_, k_, v_: fa.flash_attention_lse(q_, k_, v_,
                                                      causal=True),
            lambda q_, k_, v_: sdpa(q_, k_, v_, is_causal=True,
                                    enable_gqa=True),
            (lambda: attention_reference(*qm_set[:3], causal=True), 2),
            bound_ms(qm_fw[1], qm_fw[0], "bfloat16"), "mma",
            qm_err["o"][0], qm_shape + ", the block kernel", iters=8),
        "train bwd": k1_row(
            f"flash_attention_bwd (qwen3moe train, G={qmH // qmHkv}, "
            f"D={qmD})", qm_set,
            lambda *a_: ops.flash_attention_bwd(*a_, causal=True),
            lambda *a_: torch.autograd.grad(qm_sout, qm_sq, a_[4],
                                            retain_graph=True),
            (lambda: attention_backward_reference(*qm_set, causal=True), 2),
            bound_ms(qm_bw[1], qm_bw[0], "bfloat16"), "wgmma",
            max(qm_err[n_][0] for n_ in t_names[1:]), qm_shape, iters=4,
            source=attn_bwd_src)}
    halves = lambda e_: {"first_half": e_[1], "second_half": e_[2]}
    qm_rows["train fwd"]["max_abs_err_ulps"] = halves(qm_err["o"])
    qm_rows["train bwd"]["max_abs_err_by_gradient"] = {
        n_: dict(max_abs_err=e_[0], ulps=halves(e_))
        for n_, e_ in qm_err.items() if n_ != "o"}
    phase("qwen3moe:K1", shape=qm_shape.replace(" ", "_"),
          paths="mma,wgmma", bwd_bitwise_repeatable=True,
          err=json.dumps({n_: [f"{e_[0]:.3e}"] + [
              f"{h[0]:.3e}/{h[1]:.3e}" for h in e_[1:]]
              for n_, e_ in qm_err.items()}, separators=(",", ":")),
          **row_fields(qm_rows))
    del qm_set, qm_sq, qm_sout, qm_q, qm_k, qm_v, qm_do
    torch.cuda.empty_cache()
    mark("seq_K1")

    # -- 3g. phi4:seq -- phi4-mini elastic training (Listing 2) at full
    # width and P_ELASTIC_LAYERS (8; phase 23's elastic cut, which the
    # card's measured peak fits with a resize's clone), resizing 8 -> 16 -> 8
    # workers: at 16 its 24 heads do not split over 16 "model" workers, and
    # attention takes the sequence path: per layer, microbatch and pass,
    # SEQ_SHARDS K1 launches with their offsets (remat: the forward twice).
    # Losses against the static 8-worker run: equal bit for bit through
    # the first step at 16, within SEQ_LOSS_TOL after; then forward losses
    # of the final state at 8 and 16 workers, equal bit for bit, and at 16
    # with the last shard's offset planted at 0, which must move it past
    # SEQ_LOSS_TOL
    from repro_torch.models import attention as attn_mod
    from repro_torch.parallel.context import sharding_context
    from repro_torch.parallel.mesh import factor_mesh, make_job_mesh
    from repro_torch.parallel.sharding import rules_for
    sp_tshape = dataclasses.replace(get_shape(TRAIN_SHAPE),
                                    global_batch=TRAIN_BATCH)

    def mesh_run(c, params, schedule, steps, workers, drops=False):
        """``steps`` steps of ``lm_train_app`` on ``c`` under a runner of
        ``workers`` logical workers; counts zeroed just before the loop and
        read just after.  Per step: workers, loss (ce and aux beside a MoE
        model's), seconds and, with ``drops``, the MoE layers' drops and
        capacities (``moe.count_drops``).  Returns the runner, its state,
        the steps' records, counts and the peak bytes over the run.
        Cyclic garbage is collected first: the process's first training
        step imports modules lazily, and a frame that an import keeps
        (``torch.fx.wrap`` holds its caller's frame) holds that step's
        state and gradients until a full collection."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base_ = torch.cuda.memory_allocated()
        app_ = lm_train_app(c, sp_tshape, AdamW(
            learning_rate=1e-3, moment_dtype=c.opt_moment_dtype), seed=0)
        runner_ = dmr.MalleableRunner(
            app_, dmr.MalleabilityParams(*params), dmr.ScriptedRMS(schedule),
            devices=logical_workers(workers, dev))
        state_ = runner_.init()
        ops.reset_counts()
        recs = []
        for i_ in range(steps):
            t0_ = time.perf_counter()
            state_ = dmr.reconfig(runner_, state_, i_)
            with (moe.count_drops() if drops else
                  contextlib.nullcontext({})) as dr_:
                state_, m_ = runner_.step(state_, i_)
                rec_ = {"workers": runner_.current, "loss": float(m_["loss"])}
            rec_["s"] = time.perf_counter() - t0_
            if c.is_moe:
                rec_.update(ce=float(m_["ce_loss"]), aux=float(m_["aux_loss"]))
            if drops:
                rec_.update(dropped=dr_["dropped"], routed=dr_["routed"],
                            capacities=dr_["capacities"])
            recs.append(rec_)
        counts_ = {k_: (dict(ops.KERNELS[k_].path_launches),
                        dict(ops.KERNELS[k_].mask_launches))
                   for k_ in ("flash_attention", "flash_attention_bwd")}
        if not all(np.isfinite([r_["loss"] for r_ in recs])):
            fail(f"{c.name} at {c.num_layers} layers: losses {recs}")
        return runner_, state_, recs, counts_, \
            torch.cuda.max_memory_allocated() - base_

    def k1_want(c, recs):
        """K1's launches by path and by mask that Listing 2's loop must
        make: per layer, microbatch and step, the forward twice (remat) and
        the backward once; one offset launch a "model" worker where the
        step's mesh takes the sequence path (its "model" size does not
        divide the heads), else one causal."""
        L_, mb_ = c.num_layers, max(1, c.train_microbatches)
        shards = [factor_mesh(r_["workers"])[1] for r_ in recs]
        seq_ = [m_ for m_ in shards if m_ > 1 and c.num_heads % m_]
        f_, b_ = ({"offset": n_ * sum(seq_) * L_ * mb_,
                   "causal": n_ * (len(recs) - len(seq_)) * L_ * mb_}
                  for n_ in (2, 1))
        return {"flash_attention": (
                    {"fma": 0, "mma": sum(f_.values()), "split_decode": 0},
                    dict(dict.fromkeys(fa.MASKS, 0), **f_)),
                "flash_attention_bwd": (
                    {"fma": 0, "wgmma": sum(b_.values())},
                    dict(dict.fromkeys(fa.MASKS, 0), **b_))}

    sp_cfg = dataclasses.replace(get_config(PHI4), num_layers=P_ELASTIC_LAYERS)
    sp_runs = {}
    for sp_label, sp_sched in (("static", {}), ("elastic", SEQ_SCHEDULE)):
        sp_runner, sp_state, sp_recs, sp_counts, sp_peak = mesh_run(
            sp_cfg, SEQ_PARAMS, sp_sched, P_ELASTIC_STEPS, SEQ_WORKERS)
        if sp_counts != k1_want(sp_cfg, sp_recs):
            fail(f"phi4:seq {sp_label}: K1 launched {sp_counts}, not "
                 f"{k1_want(sp_cfg, sp_recs)}")
        sp_runs[sp_label] = (sp_recs, sp_counts, sp_peak)
        phase(f"phi4:seq:{sp_label}", layers=sp_cfg.num_layers,
              workers=",".join(str(r_["workers"]) for r_ in sp_recs),
              losses=",".join(f"{r_['loss']:.6f}" for r_ in sp_recs),
              step_s=",".join(f"{r_['s']:.3f}" for r_ in sp_recs),
              k1_masks=json.dumps({k_: v_[1] for k_, v_ in sp_counts.items()},
                                  separators=(",", ":")),
              peak_gb=f"{sp_peak / 1e9:.2f}",
              resizes=",".join(f"{e_.from_procs}->{e_.to_procs}:"
                               f"{e_.transfer.seconds:.3f}s"
                               for e_ in sp_runner.events))
        if sp_label == "static":
            del sp_runner, sp_state
            torch.cuda.empty_cache()
    sp_st, sp_el = ([r_["loss"] for r_ in sp_runs[k_][0]]
                    for k_ in ("static", "elastic"))
    sp_same = list(SEQ_SCHEDULE)[0] + 1       # through the first step at 16
    sp_gap = max(abs(a_ - b_) for a_, b_ in zip(sp_st, sp_el))
    if sp_st[:sp_same] != sp_el[:sp_same] or sp_gap > SEQ_LOSS_TOL or \
            [e_.to_procs for e_ in sp_runner.events] != \
            list(SEQ_SCHEDULE.values()):
        fail(f"phi4:seq: elastic {sp_el} vs static {sp_st} (gap "
             f"{sp_gap:.3e} > {SEQ_LOSS_TOL}?), resizes "
             f"{[e_.to_procs for e_ in sp_runner.events]}")
    # forward losses of the elastic run's final state: 8 and 16 workers,
    # and 16 with the last shard's offset planted at 0
    sp_batch = {k_: torch.from_numpy(v_).to(dev) for k_, v_ in
                lm_train_app(sp_cfg, sp_tshape).dataset.batch_at(0).items()}
    sp_last = (SEQ_SHARDS - 1) * (sp_tshape.seq_len // SEQ_SHARDS)
    sp_real = attn_mod.flash_attention

    def sp_planted(*a_, q_offset=None, **kw_):
        return sp_real(*a_, q_offset=0 if q_offset == sp_last else q_offset,
                       **kw_)

    def sp_eval(n_, plant=False):
        mesh_ = make_job_mesh(logical_workers(n_, dev))
        attn_mod.flash_attention = sp_planted if plant else sp_real
        try:
            with torch.no_grad(), sharding_context(mesh_, rules_for(sp_cfg)):
                return float(loss_fn(sp_state.params, sp_cfg, sp_batch)[0])
        finally:
            attn_mod.flash_attention = sp_real

    sp_ev = {k_: sp_eval(*a_) for k_, a_ in (
        ("8", (8,)), ("16", (SEQ_WORKERS,)),
        ("16_planted", (SEQ_WORKERS, True)))}
    sp_ev_gap = abs(sp_ev["16"] - sp_ev["8"])
    sp_plant_gap = abs(sp_ev["16_planted"] - sp_ev["16"])
    if sp_ev_gap != 0.0 or sp_plant_gap <= SEQ_LOSS_TOL:
        fail(f"phi4:seq forward losses {sp_ev}: 16 vs 8 workers "
             f"{sp_ev_gap:.3e} (not 0), the planted offset "
             f"{sp_plant_gap:.3e} (within the bound {SEQ_LOSS_TOL})")
    seq_launches = (sp_runs["elastic"][1]["flash_attention"][1]["offset"],
                    sp_runs["elastic"][1]["flash_attention_bwd"][1]["offset"])
    phase("phi4:seq", elastic_vs_static_max_gap=f"{sp_gap:.3e}",
          bitwise_through_step=sp_same - 1, tol=SEQ_LOSS_TOL,
          offset_launches=f"{seq_launches[0]},{seq_launches[1]}",
          eval_losses=json.dumps({k_: f"{v_:.6f}" for k_, v_ in sp_ev.items()},
                                 separators=(",", ":")),
          eval_16_vs_8=f"{sp_ev_gap:.3e}",
          planted_offset_gap=f"{sp_plant_gap:.3e}")
    del sp_runner, sp_state, sp_batch
    torch.cuda.empty_cache()
    mark("phi4_seq")

    # -- 3h. qwen3moe:train -- qwen3-moe-235b-a22b elastic training
    # (Listing 2) at full width in its bf16 master weights and moments, 8
    # microbatches of 1 x 4096, at the first of QM_CUTS whose dry-run state,
    # its resize clone and the gradients (with their microbatch sums) fit
    # DENSE_FIT_GB, resizing 4 -> 8 -> 16 workers: 128 experts split over
    # each, so every MoE layer runs EP (each shard routes its own tokens at
    # its own capacity C_loc, an all-to-all each way).  Per step: workers,
    # losses, seconds, the share of assignments dropped and the
    # capacities, which must be the reference's C_loc at that count; the
    # peak beside the dry run's prediction; K1 at G = 16 on mma / wgmma
    # (phase 15's two qwen3moe rows count these launches)
    qm_full = get_config(QWEN3)
    qm_fit = {}
    for qm_L in QM_CUTS:
        qm_cfg = dataclasses.replace(qm_full, num_layers=qm_L)
        _, qm_args = dryrun.abstract_args(qm_cfg, sp_tshape)
        qm_arg = dryrun.argument_bytes(qm_cfg, sp_tshape, qm_args)
        qm_fit[qm_L] = (sum(qm_arg.values()) + qm_arg["state"] +
                        dryrun.grad_bytes(qm_cfg, sp_tshape,
                                          qm_args["state"]))
        if qm_fit[qm_L] <= DENSE_FIT_GB * 1e9:
            break
    else:
        fail(f"no qwen3-moe cut of {QM_CUTS} fits {DENSE_FIT_GB} GB: "
             f"{qm_fit}")
    del qm_args
    qm_runner, qm_state, qm_recs, qm_counts, qm_peak = mesh_run(
        qm_cfg, QM_PARAMS, QM_SCHEDULE, QM_STEPS, max(QM_SCHEDULE.values()),
        drops=True)
    if qm_counts != k1_want(qm_cfg, qm_recs):
        fail(f"qwen3moe:train: K1 launched {qm_counts}, not "
             f"{k1_want(qm_cfg, qm_recs)}")
    qm_m = qm_cfg.moe
    qm_tok = TRAIN_BATCH // qm_cfg.train_microbatches * sp_tshape.seq_len
    for r_ in qm_recs:
        n_ = r_["workers"]
        t_loc = qm_tok // n_
        c_loc = max(8, -(-int(t_loc * qm_m.experts_per_token *
                               qm_m.capacity_factor / qm_m.num_experts)
                         // 8) * 8)
        r_["c_loc"] = c_loc
        if qm_m.num_experts % n_ or r_["capacities"] != [c_loc] or \
                r_["routed"] != 2 * qm_cfg.num_layers * TRAIN_BATCH * \
                sp_tshape.seq_len * qm_m.experts_per_token:
            fail(f"qwen3moe:train at {n_} workers: capacities "
                 f"{r_['capacities']} (C_loc {c_loc}), routed "
                 f"{r_['routed']}")
    qm_launches = (qm_counts["flash_attention"][1]["causal"],
                   qm_counts["flash_attention_bwd"][1]["causal"])
    phase("qwen3moe:train", layers=qm_cfg.num_layers,
          microbatches=qm_cfg.train_microbatches,
          workers=",".join(str(r_["workers"]) for r_ in qm_recs),
          losses=",".join(f"{r_['loss']:.6f}" for r_ in qm_recs),
          ce_loss=",".join(f"{r_['ce']:.6f}" for r_ in qm_recs),
          aux_loss=",".join(f"{r_['aux']:.6f}" for r_ in qm_recs),
          step_s=",".join(f"{r_['s']:.3f}" for r_ in qm_recs),
          c_loc=",".join(str(r_["c_loc"]) for r_ in qm_recs),
          dropped_share=",".join(f"{r_['dropped'] / r_['routed']:.4f}"
                                 for r_ in qm_recs),
          peak_gb=f"{qm_peak / 1e9:.2f}",
          predicted_gb=json.dumps({k_: round(v_ / 1e9, 2)
                                   for k_, v_ in qm_fit.items()},
                                  separators=(",", ":")),
          limit_gb=DENSE_FIT_GB,
          state_gb=f"{sum(t.nbytes for t in T.leaves(qm_state)) / 1e9:.2f}",
          k1_launches=f"{qm_launches[0]},{qm_launches[1]}",
          resizes=",".join(f"{e_.from_procs}->{e_.to_procs}:"
                           f"{e_.transfer.seconds:.3f}s"
                           for e_ in qm_runner.events))
    del qm_runner, qm_state
    torch.cuda.empty_cache()
    mark("qwen3moe_train")

    # -- 3i. moe:tp -- mixtral-8x7b's MoE layer at full width (8 experts of
    # d_ff 14336, top-2) at a training microbatch (4 x 4096 tokens, bf16
    # activations over fp32 weights), forward and backward under a sharding
    # context with mixtral's rules (experts whole, their MLP's F axis over
    # "model"): at 8 workers F splits into 8 slices whose products are
    # summed over "model", held to MOE_TP_ULPS of the global formulation
    # (output, dx and every weight's gradient); at 6 workers F does not
    # split (14336 = 2^11 7), nothing is summed, and the layer equals the
    # global formulation bit for bit (output, dx and the expert weights'
    # gradients; the aux loss and the router's gradient, which the
    # aux's pmean over 6 equal values reaches, within 1e-6 relative)
    from repro_torch.models.params import init as p_init
    gc.collect()
    torch.cuda.empty_cache()
    tp_cfg = get_config(MIXTRAL)
    tp_p = p_init(moe.moe_schema(tp_cfg), torch.Generator(dev).manual_seed(0),
                  dev)
    tp_B = TRAIN_BATCH // tp_cfg.train_microbatches
    tp_x = rand((tp_B, sp_tshape.seq_len, tp_cfg.d_model), bf16)
    tp_w = rand((tp_B, sp_tshape.seq_len, tp_cfg.d_model), bf16)
    tp_names = sorted(tp_p)

    def tp_run(n_):
        """The layer and its gradients: global (``n_`` None) or under the
        context of ``n_`` workers; (y, aux, grads by name, seconds)."""
        leaves = [tp_p[k_].detach().requires_grad_() for k_ in tp_names]
        x_ = tp_x.detach().requires_grad_()
        p_ = dict(zip(tp_names, leaves))
        torch.cuda.synchronize()
        t0_ = time.perf_counter()
        with contextlib.ExitStack() as es_:
            if n_ is not None:
                es_.enter_context(sharding_context(make_job_mesh(
                    logical_workers(n_, dev)), rules_for(tp_cfg)))
            y_, aux_ = (moe.moe_apply_reference(p_, x_, tp_cfg) if n_ is None
                        else moe.moe_apply(p_, x_, tp_cfg))
            g_ = torch.autograd.grad((y_.float() * tp_w.float()).sum() + aux_,
                                     [x_] + leaves)
        torch.cuda.synchronize()
        return (y_.detach(), float(aux_), dict(zip(["x"] + tp_names, g_)),
                time.perf_counter() - t0_)

    def tp_ulps(got_, exp_, what):
        top = exp_.float().abs().max().item()
        bound = MOE_TP_ULPS * 2.0 ** (np.floor(np.log2(top)) - 7)
        err = (got_.float() - exp_.float()).abs().max().item()
        if err > bound:
            fail(f"moe:tp {what}: {err:.3e} over {MOE_TP_ULPS} bf16 ulps of "
                 f"its largest entry {top:.3e} ({bound:.3e})")
        return err, bound

    tp_run(None)                                  # warm up
    tp_ref = tp_run(None)
    tp_res = {n_: tp_run(n_) for n_ in (8, 6)}
    tp_err = {k_: tp_ulps(tp_res[8][2][k_], tp_ref[2][k_], f"8 workers, d{k_}")
              for k_ in tp_ref[2]}
    tp_err["y"] = tp_ulps(tp_res[8][0], tp_ref[0], "8 workers, output")
    y6, aux6, g6, _ = tp_res[6]
    tp_equal = {k_: bool(torch.equal(g6[k_], tp_ref[2][k_]))
                for k_ in tp_ref[2]}
    tp_equal["y"] = bool(torch.equal(y6, tp_ref[0]))
    tp_router = ((g6["router"] - tp_ref[2]["router"]).abs().max() /
                 tp_ref[2]["router"].abs().max()).item()
    if not all(v_ for k_, v_ in tp_equal.items() if k_ != "router") or \
            tp_router > 1e-6 or abs(aux6 - tp_ref[1]) > 1e-6 * abs(tp_ref[1]):
        fail(f"moe:tp at 6 workers (F whole): not the global formulation "
             f"{tp_equal}, router gradient {tp_router:.3e}, aux {aux6} vs "
             f"{tp_ref[1]}")
    phase("moe:tp", tokens=tp_B * sp_tshape.seq_len, workers="8,6",
          f_slices="8,none", ulps=MOE_TP_ULPS,
          err_8=json.dumps({k_: f"{e_:.3e}/{b_:.3e}"
                            for k_, (e_, b_) in tp_err.items()},
                           separators=(",", ":")),
          equal_6=json.dumps(tp_equal, separators=(",", ":")),
          router_grad_6=f"{tp_router:.3e}",
          aux=f"{tp_ref[1]:.6f},{tp_res[8][1]:.6f},{aux6:.6f}",
          s_fwd_bwd=",".join(f"{r_[3]:.3f}" for r_ in (tp_ref, tp_res[8],
                                                       tp_res[6])))
    del tp_p, tp_x, tp_w, tp_ref, tp_res, y6, g6
    torch.cuda.empty_cache()
    mark("moe_tp")

    def serve_runs(c, tag, k1_per_step):
        """The serving path of ``c``: ``decode_demo`` at the serving
        schedule without and with resizes, kernel counts zeroed just before
        each run and read just after.  Each run must launch K1
        ``k1_per_step`` times a decode step, all on split_decode, and K3
        never (an SSM decode step is the recurrence); both must give the
        same tokens and the same final cache, bit for bit.  A MoE model's
        runs print the share of routed assignments dropped over capacity.
        Returns the runs (tokens, events, times, K1's launches by mask)
        and one run's K1 launches."""
        runs = {}
        want = k1_per_step * (PROMPT + DECODE)
        for label, schedule in (("static", None), ("elastic", SCHEDULE)):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            ops.reset_counts()
            with moe.count_drops() as drops:
                out = decode_demo(c, batch=BATCH, prompt_len=PROMPT,
                                  decode_steps=DECODE, cache_len=CACHE,
                                  workers=WORKERS, device=dev,
                                  schedule=schedule, seed=0)
                torch.cuda.synchronize()
            counts = ops.launch_counts()
            paths = dict(fa.flash_attention.path_launches)
            out["k1_masks"] = dict(fa.flash_attention.mask_launches)
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
                  mask_launches=json.dumps(out["k1_masks"],
                                           separators=(",", ":")),
                  peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
                  sizes=json.dumps(out["sizes"], separators=(",", ":")),
                  **({"dropped_share": f"{drops['dropped'] / drops['routed']:.4f}",
                      "routed": drops["routed"]} if c.is_moe else {}))
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
        caches = [T.leaves(r.pop("cache")) for r in runs.values()]
        if not all(torch.equal(a, b) for a, b in zip(*caches)):
            fail(f"{tag}: the final decode caches differ between the static "
                 "and the elastic run")
        del caches
        actions = [e.action for e in runs["elastic"]["events"]]
        if actions != ["expand", "shrink"]:
            fail(f"{tag} resize actions {actions}")
        phase(tag, tokens_equal=True, caches_equal=True,
              actions=",".join(actions))
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

    # device records of K1's and K3's forward and backward kernels
    is_k1_fwd = lambda k_: "attn_" in k_ and "attn_bwd" not in k_
    is_k1_bwd = lambda k_: "attn_bwd" in k_
    is_k3_fwd = lambda k_: "ssd_scan" in k_
    is_k3_bwd = lambda k_: "ssd_bwd" in k_
    no_k1 = {"fma": 0, "mma": 0, "split_decode": 0}

    def traced_decode(c, params, prompts, tag, groups):
        """Where a decode step of a dense or MoE model goes:
        ``make_serve_step`` at the path's last position (cache index 383
        of 512), each row fed its own prompt token, PROFILE_WARMUP steps,
        an untraced window of PROFILE_STEPS, then as many under the
        profiler: device busy, idle share, K1's device time and share,
        each of ``groups``' (``op_group_fields``), the ATen operators a
        step and the largest device kernels, all from that one window."""
        serve = make_serve_step(c)
        cache = M.init_cache(c, BATCH, CACHE, device=dev)
        tok = prompts[:, :1]
        pos = torch.tensor(PROMPT + DECODE - 1, dtype=torch.int32,
                           device=dev)

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
        dev_events = device_events(prof)
        busy = sum(device_us(e) for e in dev_events) / 1e3
        k1_ms = sum(device_us(e) for e in dev_events
                    if is_k1_fwd(e.key)) / 1e3
        if busy <= 0 or k1_ms <= 0:
            fail(f"the profiler saw no device time (or no K1) in the traced "
                 f"{tag} decode steps")
        phase(tag, layers=c.num_layers, cache_index=int(pos),
              steps=PROFILE_STEPS, untraced_ms_per_step=f"{wall_ms:.3f}",
              traced_ms_per_step=f"{traced_ms:.3f}",
              traced_device_busy_ms_per_step=f"{busy / PROFILE_STEPS:.3f}",
              traced_idle_share=f"{1 - busy / PROFILE_STEPS / traced_ms:.4f}",
              untraced_idle_share=f"{1 - busy / PROFILE_STEPS / wall_ms:.4f}",
              k1_ms_per_step=f"{k1_ms / PROFILE_STEPS:.3f}",
              k1_share=f"{k1_ms / busy:.4f}",
              **op_group_fields(prof, busy, groups, PROFILE_STEPS),
              aten_ops_per_step=sum(e.count for e in prof.key_averages()
                                    if e.key.startswith("aten::"))
              / PROFILE_STEPS,
              top=json.dumps([{"kernel": e.key[:80],
                               "ms_per_step": device_us(e) / 1e3
                               / PROFILE_STEPS,
                               "calls_per_step": e.count / PROFILE_STEPS}
                              for e in dev_events[:PROFILE_TOP]],
                             separators=(",", ":")))

    traced_decode(cfg, params, prompts, "profile", {})
    del params
    mark("granite_profile")

    # -- 9. the mamba2 serving path -----------------------------------------
    # at MAMBA_SERVE_LAYERS of its 48 layers (training runs all 48)
    mvcfg = dataclasses.replace(get_config(MAMBA),
                                num_layers=MAMBA_SERVE_LAYERS)
    serve_runs(mvcfg, "mamba2", 0)
    mark("mamba2_path")

    def prefill_launches(c, params, batch, tag, want, mma_kernels,
                         masks=None):
        """One ``make_prefill_step``, the kernel counts zeroed just before
        and read just after; ``want`` maps K1 and K3 to their launches by
        path, ``mma_kernels`` K1's mma launches to their kernel (block or
        group) as its C entry point counts them, ``masks`` (when given)
        K1's launches by mask (a mask it does not name: none).  Returns
        K1's and K3's launches, and K1's by mask (``k1_masks``)."""
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
        k1_masks = dict(fa.flash_attention.mask_launches)
        if paths != want or any(counts[k_] != sum(v.values())
                                for k_, v in want.items()) or \
                kern != mma_kernels or (masks is not None and dict(
                    dict.fromkeys(fa.MASKS, 0), **masks) != k1_masks):
            fail(f"{tag} prefill launched {counts} on paths {paths}, mma "
                 f"kernels {kern}, K1 masks {k1_masks}, not {want}, "
                 f"{mma_kernels}, {masks}")
        phase(f"{tag}:prefill", layers=c.num_layers, batch=BATCH,
              seq=batch["tokens"].shape[1], prefill_s=f"{secs:.3f}",
              launches=json.dumps({k_: counts[k_] for k_ in want},
                                  separators=(",", ":")),
              path_launches=json.dumps(paths, separators=(",", ":")),
              k1_mma_kernels=json.dumps(kern, separators=(",", ":")),
              k1_masks=json.dumps(k1_masks, separators=(",", ":")),
              first_tokens=",".join(map(str, first[:4].tolist())))
        return dict({k_: counts[k_] for k_ in want}, k1_masks=k1_masks)

    def max_rms(a, b):
        d = (a - b).abs()
        return d.max().item(), d.square().mean().sqrt().item()

    def logits_check(c, params, prompts, tag, fp32_tol, bf16_tol,
                     faults=False):
        """Prefill against token-by-token decode after the same prompts:
        fp32 full-sequence logits at every position against the fp32
        decode's (``fp32_tol``: bounds of the largest and the rms gap, the
        rms unchecked when None; both only printed when ``fp32_tol`` is
        None), and the bf16 prefill's and decode's last
        logits against fp32 (``bf16_tol``: the largest and the rms gap),
        beside the fp32 model with its weights rounded to bf16, the
        yardstick of how far bf16 rounding alone moves them.  With
        ``faults``, ``state_faults`` planted in each decode's last step
        must fail its bound.  Returns the fp32 decode's last logits and
        the bf16 decode's cache."""
        V, S = c.vocab_size, prompts.shape[1]
        batch = {"tokens": prompts}
        c32 = dataclasses.replace(c, dtype="float32")
        copy = lambda tree: T.tree_map(lambda t: t.clone(), tree)

        def decode_logits(cc, full=None):
            cache = M.init_cache(cc, BATCH, S, device=dev)
            mx = sq = torch.zeros((), device=dev)
            prev = None
            # the positions go up once: a scalar made on the host each step
            # would be a blocking copy that waits for the step before it
            pos = torch.arange(S, dtype=torch.int32, device=dev)
            for i in range(S):
                if faults and i == S - 1:
                    prev = copy(cache)      # the cache before the last step
                logits, cache = M.decode_step(
                    params, cc, prompts[:, i:i + 1], cache, pos[i])
                if full is not None:
                    d_ = (logits[:, -1, :V].float() - full[:, i]).abs()
                    mx = torch.maximum(mx, d_.max())
                    sq = sq + d_.square().mean() / S
            return (logits[:, -1, :V].float(), mx.item(), sq.sqrt().item(),
                    cache, prev)

        with torch.no_grad():
            lp = prefill_logits(params, c, batch)[:, :V].float()
            full32 = M.forward(params, c32, batch)[0][..., :V]
            lp32 = prefill_logits(params, c32, batch)[:, :V].float()
            # bf16 master weights are their own rounding: no copy
            rounded = params if all(t.dtype == bf16 for t in T.leaves(
                params)) else T.tree_map(lambda t: t.bfloat16().float(),
                                         params)
            lp32w = prefill_logits(rounded, c32, batch)[:, :V].float()
            del rounded
            ld32, gap_all, rms_all, cache32, prev32 = decode_logits(c32,
                                                                  full32)
            del full32
            ld, _, _, cache, prev = decode_logits(c)
            if faults:
                state_faults(c, params, prompts, tag, {
                    "fp32": (c32, prev32, cache32, lp32, fp32_tol),
                    "bf16": (c, prev, cache, ld32, bf16_tol)})
            del cache32, prev32, prev
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
              fp32_tol=",".join(map(str, fp32_tol or ("none",))),
              bf16_prefill_vs_fp32=f"{err_p:.4e}",
              bf16_decode_vs_fp32=f"{err_d:.4e}",
              bf16_rms=f"{rms_p:.4e},{rms_d:.4e}",
              fp32_bf16_weights=f"{err_w:.4e}",
              fp32_bf16_weights_rms=f"{rms_w:.4e}",
              bf16_tol=",".join(map(str, bf16_tol)),
              logits_std=f"{lp32.std().item():.3f}",
              bf16_prefill_vs_decode_argmax_agreement=f"{agree:.3f}")
        if fp32_tol is not None and (max(gap32, gap_all) > fp32_tol[0] or (
                fp32_tol[1] is not None and rms_all > fp32_tol[1])):
            fail(f"{tag} fp32 prefill vs decode logits differ by "
                 f"{max(gap32, gap_all):.3e} (rms {rms_all:.3e}) > "
                 f"{fp32_tol}")
        if max(err_p, err_d) > bf16_tol[0] or max(rms_p, rms_d) > bf16_tol[1]:
            fail(f"{tag} bf16 logits off the fp32 ones by "
                 f"{max(err_p, err_d):.3e} (rms {max(rms_p, rms_d):.3e}) > "
                 f"{bf16_tol}")
        return ld32, cache

    def state_faults(c, params, prompts, tag, runs):
        """Faults planted in the last decode step of an SSM or hybrid
        model's ``logits_check``, for each of ``runs`` (a dtype -> its
        config, cache before and after the last step, the logits it is
        read against and the bound, the largest and the rms gap, the rms
        unchecked when None): that step replayed on the cache before it,
        which must pass, and fed on the cache that already holds its token
        (every layer's state advanced twice by it), which must fail; with
        attention (the hybrid) also the step at the position before its
        own (its K/V over the previous token's slot, its rotary phase one
        back) and the cached rows of KV heads 0 and 1 swapped in every
        block, which the fp32 bound must reject and the bf16 one cannot
        (they move the logits less than bf16 rounding does: read, not
        held)."""
        V, S = c.vocab_size, prompts.shape[1]
        tok = prompts[:, S - 1:S]
        copy = lambda tree: T.tree_map(lambda t: t.clone(), tree)

        def swapped(cache_):
            cache_ = copy(cache_)
            for k_ in ("k", "v"):
                kv_ = cache_["shared_kv"][k_]
                kv_[:, :, :S - 1, [0, 1]] = kv_[:, :, :S - 1, [1, 0]]
            return cache_

        reads = {}
        with torch.no_grad():
            for dt_, (cc, prev_, done_, ref_, _) in runs.items():
                last = lambda cache_, i: max_rms(M.decode_step(
                    params, cc, tok, copy(cache_),
                    torch.tensor(i, dtype=torch.int32, device=dev))[0][
                        :, -1, :V].float(), ref_)
                reads[dt_] = {"replay": last(prev_, S - 1),
                              "token_twice": last(done_, S - 1)}
                if c.is_hybrid:
                    reads[dt_].update(
                        position_one_back=last(prev_, S - 2),
                        kv_heads_swapped=last(swapped(prev_), S - 1))
        held = {dt_: [k_ for k_ in r if dt_ == "fp32" or k_ in (
            "replay", "token_twice")] for dt_, r in reads.items()}
        phase(f"{tag}:faults", layers=c.num_layers, step=S - 1,
              **{f"{dt_}_{k_}{'' if k_ in held[dt_] else '_not_held'}":
                 f"{m_:.4e},rms={r_:.4e}"
                 for dt_, r in reads.items() for k_, (m_, r_) in r.items()},
              **{f"{dt_}_tol": ",".join(map(str, runs[dt_][4]))
                 for dt_ in runs})
        for dt_, r in reads.items():
            tol_ = runs[dt_][4]
            caught = {k_: r[k_][0] > tol_[0] or (tol_[1] is not None and
                                                 r[k_][1] > tol_[1])
                      for k_ in held[dt_]}
            if caught != {k_: k_ != "replay" for k_ in held[dt_]}:
                fail(f"{tag}: the {dt_} bound {tol_} rejects {caught} of the "
                     f"replayed and faulted last steps, read {r}")

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
                 (M_BF16_LOGITS_MAX, M_BF16_LOGITS_RMS), faults=True)
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

    def train_run(c, schedule, steps, patterns=None):
        """``steps`` steps of ``lm_train_app`` on ``c`` (Listing 2's loop);
        kernel counts are zeroed just before the loop and read just after.
        A step runs each layer once per microbatch (``c``'s
        ``train_microbatches`` of the batch); ``patterns`` go to the
        runner.  Returns the runner, its state, losses (with a MoE model's
        ce_loss and aux_loss beside each under ``runner.moe_losses``),
        seconds per step, counts (K1's by path and by mask too).  The
        peak counter is reset around each ``dmr.reconfig``:
        ``runner.resize_mem`` holds, per resize, the bytes allocated just
        before it and the peak during it, ``runner.peak_bytes`` the peak
        over the whole run."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        app = lm_train_app(c, tshape, AdamW(learning_rate=1e-3), seed=0)
        runner = dmr.MalleableRunner(
            app, dmr.MalleabilityParams(*TRAIN_PARAMS),
            dmr.ScriptedRMS(schedule), devices=logical_workers(WORKERS, dev),
            patterns=patterns)
        state = runner.init()
        torch.cuda.synchronize()
        # what the card holds of the run (its state, after init) and
        # beside it before: phase 26 holds the dry run's bytes to these
        runner.base_bytes = base
        runner.init_bytes = torch.cuda.memory_allocated() - base
        runner.state_bytes = sum(t.nbytes for t in T.leaves(state))
        ops.reset_counts()
        losses, secs = [], []
        runner.moe_losses, runner.resize_mem, peak = [], [], 0
        for i in range(steps):
            t0 = time.perf_counter()
            n_ev, before = len(runner.events), torch.cuda.memory_allocated()
            peak = max(peak, torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            state = dmr.reconfig(runner, state, i)
            if len(runner.events) > n_ev:
                runner.resize_mem.append(
                    (before, torch.cuda.max_memory_allocated()))
            state, m = runner.step(state, i)
            losses.append(float(m["loss"]))        # waits for the step
            secs.append(time.perf_counter() - t0)
            if c.is_moe:
                runner.moe_losses.append((float(m["ce_loss"]),
                                          float(m["aux_loss"])))
        L = c.num_layers
        mb = c.train_microbatches if TRAIN_BATCH % max(
            1, c.train_microbatches) == 0 else 1
        fwd, bwd = 2 * L * steps * mb, L * steps * mb   # remat: twice
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
            # once a decoder layer, twice with cross-attention, once an
            # encoder layer
            n_ = (2 if c.is_encdec else 1) * L + c.encoder_layers
            fwd, bwd = 2 * n_ * steps * mb, n_ * steps * mb
            want = {"flash_attention": fwd, "flash_attention_bwd": bwd,
                    "ssd_scan": 0, "ssd_scan_bwd": 0}
            want_paths = {"flash_attention": {"fma": 0, "mma": fwd,
                                              "split_decode": 0},
                          "flash_attention_bwd": {"fma": 0, "wgmma": bwd}}
        counts = dict(ops.launch_counts(), paths={
            k_: dict(ops.KERNELS[k_].path_launches) for k_ in want_paths},
            masks={k_: dict(ops.KERNELS[k_].mask_launches)
                   for k_ in ("flash_attention", "flash_attention_bwd")})
        if {k_: counts[k_] for k_ in want} != want or \
                counts["paths"] != want_paths:
            fail(f"{L}-layer {c.name} training launched {counts}, not "
                 f"{want} on the paths {want_paths}")
        if not all(np.isfinite(losses)):
            fail(f"{L}-layer training losses {losses}")
        runner.secs = secs
        runner.peak_bytes = max(peak, torch.cuda.max_memory_allocated())
        return runner, state, losses, secs, counts

    def step_s(secs):
        """Median seconds per step, the first (warm-up) step left out."""
        return float(np.median(secs[1:]))

    def elastic_pair(c, tag, steps=TRAIN_STEPS, exact=False,
                     keep_state=True, tol=TRAIN_LOSS_TOL):
        """``steps`` elastic (``TRAIN_SCHEDULE``) and static steps of
        ``c``, whose losses must agree to ``tol`` (bit for bit when
        ``exact``).  Returns the static run's runner, state (None unless
        ``keep_state``) and kernel counts.  The elastic run goes first, so
        the static state kept for the caller is not resident during it:
        until it did, the elastic run's ``peak_gb`` counted that state
        too (the 8.51 GB of granite's 10 layers)."""
        out = {}
        for label, schedule in (("elastic", TRAIN_SCHEDULE), ("static", {})):
            runner, state, losses, secs, counts = train_run(c, schedule,
                                                            steps)
            phase(f"{tag}:{label}", layers=c.num_layers,
                  batch=TRAIN_BATCH, seq=tshape.seq_len,
                  losses=",".join(f"{x:.6f}" for x in losses),
                  step_s=",".join(f"{x:.3f}" for x in secs),
                  s_per_step=f"{step_s(secs):.4f}",
                  tokens_per_s=f"{tokens_per_step / step_s(secs):.0f}",
                  per_step=json.dumps({k_: counts[k_] / steps for k_ in
                                       counts["paths"]},
                                      separators=(",", ":")),
                  paths=json.dumps(counts["paths"], separators=(",", ":")),
                  k1_masks=json.dumps(counts["masks"], separators=(",", ":")),
                  base_gb=f"{runner.base_bytes / 1e9:.2f}",
                  peak_gb=f"{runner.peak_bytes / 1e9:.2f}",
                  sizes=",".join(str(e.to_procs) for e in runner.events),
                  **({"ce_loss": ",".join(f"{a:.6f}" for a, _ in
                                          runner.moe_losses),
                      "aux_loss": ",".join(f"{b:.6f}" for _, b in
                                           runner.moe_losses)}
                     if c.is_moe else {}))
            for ev, (before_, peak_) in zip(runner.events,
                                            runner.resize_mem):
                phase(f"{tag}:{label}:resize", step=ev.step,
                      action=ev.action,
                      sizes=f"{ev.from_procs}->{ev.to_procs}",
                      bytes_moved=ev.transfer.bytes_moved,
                      seconds=f"{ev.transfer.seconds:.4f}",
                      allocated_before_gb=f"{before_ / 1e9:.4f}",
                      peak_gb=f"{peak_ / 1e9:.4f}")
            out[label] = (runner, state if label == "static" and
                          keep_state else None, losses, counts)
            del state
        static_l, elastic_l = out["static"][2], out["elastic"][2]
        gap_ = max(abs(a - b) for a, b in zip(static_l, elastic_l))
        actions = [e.action for e in out["elastic"][0].events]
        if gap_ > (0.0 if exact else tol) or \
                actions != ["expand", "shrink"]:
            fail(f"{tag} elastic training: losses {elastic_l} vs static "
                 f"{static_l} (gap {gap_:.3e} > {tol}?), actions "
                 f"{actions}")
        runner, state, _, counts = out["static"]
        phase(tag, elastic_vs_static_max_gap=f"{gap_:.3e}",
              tol=0.0 if exact else tol,
              actions=",".join(actions),
              **({"state_gb": f"{sum(t.nbytes for t in T.leaves(state)) / 1e9:.2f}"}
                 if state is not None else {}))
        return runner, state, counts

    def traced_step(runner, state, step, want, groups=None, spans=None,
                    required=True):
        """One traced ``runner.step``, taken again (four times at most)
        while the profiler dropped a record: ``want`` maps a name to a test
        on a device record's key and the records a step launches;
        ``groups`` a name to operator names whose device time
        (``op_group_fields``) the fields give too, ``spans`` a name to a
        ``record_function`` span whose forward and backward device time
        (``span_fields``) they give.  Returns the state, the phase fields
        (device busy, idle share, each name's device ms and share, the
        largest operators) and each name's records."""
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
            if not required:            # a measurement the caller may lack
                return state, None, None
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
        fields.update(op_group_fields(prof, busy, groups or {}))
        fields.update(span_fields(prof, busy, spans or {}))
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

    # -- 13. Listing 2 at full depth: static and elastic, donated resizes ----
    class RowCopy(dmr.Pattern):
        """A user's pattern family, ``rowcopy:<blocks>``: a leaf copied
        into fresh storage ``blocks`` slices at a time, accounted as
        ``default`` (its resident bytes)."""
        name = "rowcopy"

        def __init__(self, blocks):
            self.blocks = blocks

        def spec(self):
            return f"{self.name}:{self.blocks}"

        def move(self, leaf, placement, ctx):
            out = torch.empty_like(leaf)
            for o_, l_ in zip(out.view(-1).chunk(self.blocks),
                              leaf.view(-1).chunk(self.blocks)):
                o_.copy_(l_)
            return out

    dmr.register_pattern("rowcopy", lambda arg: RowCopy(int(arg or 1)))
    d_patterns = {"opt/nu": lambda leaf, placement, ctx: leaf.clone(),
                  "opt/mu": "rowcopy:4"}
    d_keys = {"opt/nu": "custom", "opt/mu": "rowcopy:4"}
    dcfg = get_config(ARCH)
    d_runs = {}
    for d_label, d_schedule in (("static", {}),
                                ("elastic", GRANITE_DEPTH_SCHEDULE)):
        gc.collect()
        runner, state, losses, secs, counts = train_run(
            dcfg, d_schedule, GRANITE_DEPTH_STEPS, patterns=d_patterns)
        d_flat = [(p_, t.nbytes) for p_, t in T.flatten(state)]
        d_state_b = sum(b_ for _, b_ in d_flat)
        d_leaf_b = max(b_ for _, b_ in d_flat)
        d_want = {}                 # what the accounting gives the tree
        for p_, b_ in d_flat:
            k_ = next((v_ for pre_, v_ in d_keys.items() if p_ == pre_ or
                       p_.startswith(pre_ + "/")), "default")
            d_want[k_] = d_want.get(k_, 0) + b_
        phase(f"train:depth:{d_label}", layers=dcfg.num_layers,
              batch=TRAIN_BATCH, seq=tshape.seq_len,
              losses=",".join(f"{x:.6f}" for x in losses),
              step_s=",".join(f"{x:.3f}" for x in secs),
              s_per_step=f"{step_s(secs):.4f}",
              tokens_per_s=f"{tokens_per_step / step_s(secs):.0f}",
              k1_fwd_per_step=counts["flash_attention"] / GRANITE_DEPTH_STEPS,
              k1_bwd_per_step=counts["flash_attention_bwd"] /
              GRANITE_DEPTH_STEPS,
              paths=json.dumps(counts["paths"], separators=(",", ":")),
              sizes=",".join(str(e.to_procs) for e in runner.events))
        for ev, (d_before, d_peak) in zip(runner.events, runner.resize_mem):
            d_got = {k_: v_.bytes_moved for k_, v_ in ev.per_pattern.items()}
            d_bound = d_before + d_leaf_b + RESIZE_SLACK_BYTES
            phase("train:depth:resize", step=ev.step, action=ev.action,
                  sizes=f"{ev.from_procs}->{ev.to_procs}",
                  bytes_moved=ev.transfer.bytes_moved,
                  n_leaves=ev.transfer.n_leaves,
                  per_pattern=json.dumps(d_got, separators=(",", ":")),
                  seconds=f"{ev.transfer.seconds:.4f}",
                  allocated_before_gb=f"{d_before / 1e9:.4f}",
                  peak_gb=f"{d_peak / 1e9:.4f}",
                  bound_gb=f"{d_bound / 1e9:.4f}", card=repr(smi_line))
            if d_got != d_want or ev.transfer.bytes_moved != d_state_b or \
                    ev.transfer.n_leaves != len(d_flat):
                fail(f"40-layer resize at step {ev.step} moved {d_got} "
                     f"({ev.transfer.bytes_moved} B, {ev.transfer.n_leaves} "
                     f"leaves), the tree's accounting {d_want} "
                     f"({d_state_b} B, {len(d_flat)} leaves)")
            if d_peak > d_bound:
                fail(f"40-layer resize at step {ev.step} peaked at "
                     f"{d_peak} B, past {d_before} B allocated before it + "
                     f"the largest leaf {d_leaf_b} + {RESIZE_SLACK_BYTES}")
        d_runs[d_label] = dict(
            losses=losses, secs=secs, events=list(runner.events),
            resize_mem=list(runner.resize_mem), base=runner.base_bytes,
            peak=runner.peak_bytes - runner.base_bytes,
            k1=(counts["flash_attention"] / GRANITE_DEPTH_STEPS,
                counts["flash_attention_bwd"] / GRANITE_DEPTH_STEPS))
        del runner, state
        torch.cuda.empty_cache()
    d_st, d_el = d_runs["static"], d_runs["elastic"]
    d_gap = max(abs(a - b) for a, b in zip(d_st["losses"], d_el["losses"]))
    d_actions = [e.action for e in d_el["events"]]
    # what a resize that copied without donating would hold: both states
    d_clone_b = max(b_ for b_, _ in d_el["resize_mem"]) + d_state_b
    phase("train:depth:memory", card=repr(smi_line),
          state_gb=f"{d_state_b / 1e9:.4f}",
          largest_leaf_gb=f"{d_leaf_b / 1e9:.4f}",
          slack_gb=f"{RESIZE_SLACK_BYTES / 1e9:.4f}",
          allocated_before_resize_gb=",".join(
              f"{b_ / 1e9:.4f}" for b_, _ in d_el["resize_mem"]),
          resize_peak_gb=",".join(
              f"{p_ / 1e9:.4f}" for _, p_ in d_el["resize_mem"]),
          static_peak_gb=f"{d_st['peak'] / 1e9:.4f}",
          elastic_peak_gb=f"{d_el['peak'] / 1e9:.4f}",
          base_gb=f"{d_st['base'] / 1e9:.4f},{d_el['base'] / 1e9:.4f}",
          cloning_resize_gb=f"{d_clone_b / 1e9:.4f}")
    if d_gap > TRAIN_LOSS_TOL or d_actions != ["expand", "shrink"]:
        fail(f"40-layer elastic training: losses {d_el['losses']} vs static "
             f"{d_st['losses']} (gap {d_gap:.3e} > {TRAIN_LOSS_TOL}?), "
             f"actions {d_actions}")
    if d_el["peak"] > d_st["peak"] + d_leaf_b + RESIZE_SLACK_BYTES:
        fail(f"40-layer elastic run peaked at {d_el['peak']} B over its "
             f"base, past the static run's {d_st['peak']} B + the largest "
             f"leaf {d_leaf_b} + {RESIZE_SLACK_BYTES}")
    phase("train:depth", layers=dcfg.num_layers,
          elastic_vs_static_max_gap=f"{d_gap:.3e}", tol=TRAIN_LOSS_TOL,
          actions=",".join(d_actions),
          k1_fwd_per_step=d_el["k1"][0], k1_bwd_per_step=d_el["k1"][1],
          s_per_step=f"{step_s(d_st['secs']):.4f},"
                     f"{step_s(d_el['secs']):.4f}",
          state_gb=f"{d_state_b / 1e9:.2f}",
          peak_gb=f"{d_st['peak'] / 1e9:.2f},{d_el['peak'] / 1e9:.2f}")
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
    zparams = M.init_params(dataclasses.replace(
        zcfg, num_layers=max(Z_SERVE_LAYERS, Z_CHECK_LAYERS)),
        torch.Generator(dev).manual_seed(0), dev)
    z_first = lambda n: dict(zparams, layers=T.tree_map(
        lambda t: t[:n], zparams["layers"]))    # the first n layers' weights
    zprompts = torch.from_numpy(np.random.default_rng(2).integers(
        0, zscfg.vocab_size, (BATCH, M_PREFILL_S), dtype=np.int32)).to(dev)
    z_prefill = prefill_launches(
        zscfg, z_first(Z_SERVE_LAYERS), {"tokens": zprompts}, "zamba2",
        {"ssd_scan": {"fma": 0, "wgmma": zscfg.num_layers},
         "flash_attention": dict(no_k1, mma=zgroups)},
        {"block": zgroups, "group": 0})
    logits_check(dataclasses.replace(zscfg, num_layers=Z_CHECK_LAYERS),
                 z_first(Z_CHECK_LAYERS),
                 zprompts, "zamba2", (Z_FP32_LOGITS_ATOL, Z_FP32_LOGITS_RMS),
                 (Z_BF16_LOGITS_MAX, Z_BF16_LOGITS_RMS), faults=True)
    traced_prefill(zscfg, z_first(Z_SERVE_LAYERS), {"tokens": zprompts},
                   "zamba2", {"k3": is_k3_fwd, "k1": is_k1_fwd})
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
          peak_gb=f"{runner.peak_bytes / 1e9:.2f}")
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

    def live_grid(device, trail_dir=None):
        """Phase 14's grid on WORKERS workers of ``device``, each
        configuration under both engines with the sanitizer on; the engines
        must agree.  Returns, by label, what both packages' tests compare
        (summary but ``wall_s``, records, resize events, trail), the event
        engine's wall seconds and every tenant's final state (``x`` on the
        CPU, ``i``), which must have taken each of the job's steps.  With
        ``trail_dir``, the event engine's trail of each configuration is
        written there (``dump_trail``: phase 14f audits them)."""
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
                if trail_dir is not None and engine is dmr.Cluster:
                    dump_trail(cl, os.path.join(
                        trail_dir, f"trail_{label.replace('/', '_')}.json"))
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
    trail_dir = os.path.join(HERE, "build", "trails")
    os.makedirs(trail_dir, exist_ok=True)
    grid_card = live_grid(dev, trail_dir)
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
    ccfg = dataclasses.replace(get_config(MAMBA), num_layers=CLUSTER_LAYERS)
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

    # -- 14f. examples: the paper's §4.3 applications on the card --------
    ex_t0 = time.perf_counter()
    ex_apps = {"quickstart": quickstart, "cg_solver": cg_solver,
               "jacobi": jacobi, "nbody": nbody,
               "aligner_pipeline": aligner_pipeline}

    def ex_main(fn, **kw):
        """An example's ``main()``, its printed lines kept in what it
        returns (``out["lines"]``) and not repeated here."""
        with contextlib.redirect_stdout(io.StringIO()):
            return fn(**kw)

    def ex_events(runner_):
        return [(e.step, e.action, e.from_procs, e.to_procs,
                 e.transfer.bytes_moved,
                 {k_: v_.bytes_moved for k_, v_ in e.per_pattern.items()})
                for e in runner_.events]

    def ex_sizes(runner_, steps):
        """The worker count each of ``steps`` steps ran at."""
        at = {e.step: e.to_procs for e in runner_.events}
        size, out_ = runner_.params.preferred, []
        for i in range(steps):
            size = at.get(i, size)
            out_.append(size)
        return out_

    def ex_k1_want(c, sizes):
        """K1's launches (forward, backward) by mask and by path that
        Listing 2's loop must make: per layer, microbatch and step, the
        forward once (twice under remat) and the backward once; one
        ``offset`` launch a "model" worker where the step's mesh takes the
        sequence path (its "model" size does not divide the heads), else
        one ``causal``; fp32 on ``fma``."""
        L_, mb_ = c.num_layers, max(1, c.train_microbatches)
        shards = [factor_mesh(n_)[1] for n_ in sizes]
        seq_ = [m_ for m_ in shards if m_ > 1 and c.num_heads % m_]
        want_ = {}
        for name_, n_ in (("flash_attention", 2 if c.remat else 1),
                          ("flash_attention_bwd", 1)):
            masks_ = {"offset": n_ * sum(seq_) * L_ * mb_,
                      "causal": n_ * (len(sizes) - len(seq_)) * L_ * mb_}
            want_[name_] = (sum(masks_.values()),
                            {"fma": sum(masks_.values())},
                            dict(dict.fromkeys(fa.MASKS, 0), **masks_))
        return want_

    def ex_k1_counts():
        return {n_: (ops.KERNELS[n_].launches,
                     {p_: v_ for p_, v_ in
                      ops.KERNELS[n_].path_launches.items() if v_},
                     dict(ops.KERNELS[n_].mask_launches))
                for n_ in ("flash_attention", "flash_attention_bwd")}

    def ex_maxdiff(a, b):
        return float((a.double().cpu() - b.double().cpu()).abs().max())

    # the quickstart's two runs start from one state: its app's initial
    # state on 4 CPU workers (params.preferred), copied to each run's device
    ex_q0 = lm_train_app(get_config(quickstart.ARCH),
                         quickstart.SHAPE).init_state(
        make_job_mesh(logical_workers(4, "cpu")))

    def ex_q_app(cfg_, shape_):
        """``lm_train_app`` as the quickstart's ``main()`` calls it, its
        initial state ``ex_q0`` on the mesh's device."""
        app_ = lm_train_app(cfg_, shape_)
        app_.init(lambda mesh_: T.tree_map(
            lambda t_: t_.to(mesh_.device, copy=True), ex_q0))
        return app_

    ex_k1_total = 0
    for ex_name, ex_mod in ex_apps.items():
        ex_from = mock.patch.object(quickstart, "lm_train_app", ex_q_app) \
            if ex_name == "quickstart" else contextlib.nullcontext()
        with ex_from:
            ops.reset_counts()
            t0 = time.perf_counter()
            ex_card = ex_main(ex_mod.main)         # its default device: cuda
            torch.cuda.synchronize()
            ex_card_s = time.perf_counter() - t0
            ex_counts = ops.launch_counts()
            ex_k1 = ex_k1_counts()
            t0 = time.perf_counter()
            ex_cpu = ex_main(ex_mod.main, device="cpu")
            ex_cpu_s = time.perf_counter() - t0
        (r_c, st_c, out_c), (r_h, st_h, out_h) = ex_card, ex_cpu
        if ex_events(r_c) != ex_events(r_h):
            fail(f"examples:{ex_name}: resizes on the card {ex_events(r_c)} "
                 f"vs the CPU's {ex_events(r_h)}")
        ex_homes = {str(t_.device) for t_ in T.leaves(st_c)}
        if ex_homes != {"cuda:0"} or not r_c.events:
            fail(f"examples:{ex_name}: state on {ex_homes}, "
                 f"{len(r_c.events)} resizes")
        ex_fields = {}
        if ex_name == "quickstart":
            ex_qcfg = get_config(quickstart.ARCH)
            ex_want = ex_k1_want(ex_qcfg,
                                 ex_sizes(r_c, len(out_c["losses"])))
            if ex_k1 != ex_want:
                fail(f"examples:quickstart: K1 launched {ex_k1}, not "
                     f"{ex_want}")
            ex_k1_total = ex_k1["flash_attention"][0] + \
                ex_k1["flash_attention_bwd"][0]
            # both from ex_q0: the card's losses are the CPU's, step by
            # step, within EX_QUICKSTART_LOSS_RTOL
            lo_c, lo_h = (np.asarray(o_["losses"], np.float64)
                          for o_ in (out_c, out_h))
            ex_l_gap = float(np.max(np.abs(lo_c - lo_h) / np.abs(lo_h)))
            if not (lo_c.shape == lo_h.shape == (14,) and
                    np.all(np.isfinite(lo_c)) and lo_c[-1] < lo_c[0] and
                    ex_l_gap <= EX_QUICKSTART_LOSS_RTOL):
                fail(f"examples:quickstart: losses {lo_c.tolist()} on the "
                     f"card, {lo_h.tolist()} on the CPU (from one state: "
                     f"{ex_l_gap:.3e} relative, bound "
                     f"{EX_QUICKSTART_LOSS_RTOL})")
            ex_fields.update(
                losses=f"{out_c['losses'][0]:.6f}->{out_c['losses'][-1]:.6f}",
                cpu_losses=f"{out_h['losses'][0]:.6f}->"
                           f"{out_h['losses'][-1]:.6f}",
                loss_gap=f"{ex_l_gap:.3e}", tol=EX_QUICKSTART_LOSS_RTOL,
                k1_masks=json.dumps({k_: v_[2] for k_, v_ in ex_k1.items()},
                                    separators=(",", ":")))
        elif ex_name in ("cg_solver", "jacobi"):
            ex_gap = ex_maxdiff(st_c["x"], st_h["x"])
            if ex_gap > EX_X_TOL:
                fail(f"examples:{ex_name}: x {ex_gap:.3e} from the CPU's")
            ex_fields.update(x_gap=f"{ex_gap:.3e}", tol=EX_X_TOL,
                             err_vs_direct=f"{out_c['err']:.3e}")
        elif ex_name == "nbody":
            ex_e_gap = abs(out_c["e1"] - out_h["e1"]) / abs(out_h["e1"])
            ex_p_gap = ex_maxdiff(st_c["pos"], st_h["pos"])
            ex_one = {}
            for d_ in (dev, "cpu"):
                m_ = make_job_mesh(logical_workers(4, d_))
                ex_one[d_] = nbody.app.make_step(m_)(
                    nbody.app.init_state(m_), 0)[0]["vel"]
            ex_v_gap = ex_maxdiff(ex_one[dev], ex_one["cpu"]) / \
                float(ex_one["cpu"].abs().max())
            if ex_e_gap > EX_NBODY_ENERGY_RTOL or \
                    ex_p_gap > EX_NBODY_POS_ATOL or \
                    ex_v_gap > EX_NBODY_STEP_RTOL:
                fail(f"examples:nbody: energy {ex_e_gap:.3e}, positions "
                     f"{ex_p_gap:.3e}, one step's velocities "
                     f"{ex_v_gap:.3e} from the CPU's")
            ex_fields.update(energy_gap=f"{ex_e_gap:.3e}",
                             pos_gap=f"{ex_p_gap:.3e}",
                             step_vel_gap=f"{ex_v_gap:.3e}",
                             drift=f"{out_c['drift']:.4%}")
        else:
            ex_got = {k_: int(st_c[k_])
                      for k_ in ("cursor", "matched", "total")}
            if ex_got != {k_: int(st_h[k_]) for k_ in ex_got}:
                fail(f"examples:aligner: counters {ex_got} vs the CPU's")
            ex_fields.update(**ex_got, steps=len(out_c["done"]))
        if ex_name != "quickstart" and any(ex_counts.values()):
            fail(f"examples:{ex_name}: launched {ex_counts}: it calls no "
                 f"kernel")
        if ex_counts["repack"] or ex_counts["ssd_scan"] or \
                ex_counts["ssd_scan_bwd"]:
            fail(f"examples:{ex_name}: K2 or K3 launched: {ex_counts}")
        phase(f"examples:{ex_name}", card_s=f"{ex_card_s:.3f}",
              cpu_s=f"{ex_cpu_s:.3f}", check=out_c["lines"][-1].split(" ")[0],
              resizes=",".join(f"{e.step}:{e.from_procs}->{e.to_procs}"
                               for e in r_c.events),
              bytes_moved=",".join(str(e.transfer.bytes_moved)
                                   for e in r_c.events),
              per_pattern=json.dumps([{k_: v_.bytes_moved for k_, v_ in
                                       e.per_pattern.items()}
                                      for e in r_c.events],
                                     separators=(",", ":")),
              k1=ex_counts["flash_attention"],
              k1_bwd=ex_counts["flash_attention_bwd"],
              k2=ex_counts["repack"], k3=ex_counts["ssd_scan"],
              k3_bwd=ex_counts["ssd_scan_bwd"], cpu_equal=True, **ex_fields)
        del ex_card, ex_cpu, r_c, st_c, r_h, st_h
    torch.cuda.empty_cache()

    # CG at full width: A is EX_CG_N^2 fp32, built on the card
    torch.cuda.synchronize()
    ex_base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    r_cg, st_cg, out_cg = ex_main(cg_solver.main, n=EX_CG_N)
    torch.cuda.synchronize()
    ex_cg_s = time.perf_counter() - t0
    ex_cg_peak = torch.cuda.max_memory_allocated() - ex_base
    if any(ops.launch_counts().values()):
        fail(f"examples:cg:full: launched {ops.launch_counts()}")
    if [(e.step, e.from_procs, e.to_procs) for e in r_cg.events] != \
            [(10, 4, 8), (25, 8, 2)]:
        fail(f"examples:cg:full: resizes {ex_events(r_cg)}")
    ex_a_bytes = EX_CG_N * EX_CG_N * 4
    for e in r_cg.events:
        if e.per_pattern["default"].bytes_moved < ex_a_bytes:
            fail(f"examples:cg:full: resize @{e.step} moved "
                 f"{e.transfer.bytes_moved} bytes, less than A's {ex_a_bytes}")
        phase("examples:cg:full:resize", step=e.step, action=e.action,
              sizes=f"{e.from_procs}->{e.to_procs}",
              bytes_moved=e.transfer.bytes_moved,
              seconds=f"{e.transfer.seconds:.5f}",
              gb_per_s=f"{2 * e.transfer.bytes_moved / e.transfer.seconds
                          / 1e9:.1f}")
    for i in range(5):                              # warm, then timed
        st_cg, _ = r_cg.step(st_cg, 40 + i)
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    ev0.record()
    for i in range(EX_CG_TIMED):
        st_cg, _ = r_cg.step(st_cg, 45 + i)
    ev1.record()
    torch.cuda.synchronize()
    ex_cg_ms = ev0.elapsed_time(ev1) / EX_CG_TIMED
    ex_cg_bound = ex_a_bytes / H100_BYTES_PER_S * 1e3
    phase("examples:cg:full", n=EX_CG_N, a_gb=f"{ex_a_bytes / 1e9:.2f}",
          iterations=40, rel_residual=f"{out_cg['rel_residual']:.3e}",
          tol=cg_solver.REL_RESIDUAL_TOL, ms_per_iter=f"{ex_cg_ms:.4f}",
          bound_ms=f"{ex_cg_bound:.4f}", bound_by="bytes",
          read_gb_per_s=f"{ex_a_bytes / ex_cg_ms / 1e6:.1f}",
          wall_s=f"{ex_cg_s:.2f}", peak_gb=f"{ex_cg_peak / 1e9:.2f}",
          held_before_gb=f"{ex_base / 1e9:.2f}")
    del r_cg, st_cg, out_cg
    torch.cuda.empty_cache()

    class ExDropLastRowBlock(dmr.DefaultPattern):
        """A planted fault: the moved leaf's last row block arrives as
        zeros."""

        def move(self, leaf, placement, ctx):
            out_ = leaf.clone()
            out_[-(leaf.shape[0] // ctx.to_procs):] = 0
            return out_

    def ex_faulty_app(n_):
        """``make_app`` as CG's ``main()`` calls it, x moved by the faulty
        pattern."""
        app_ = ex_make_app(n_)
        app_.patterns = {"x": ExDropLastRowBlock()}
        return app_

    ex_make_app = cg_solver.make_app
    try:
        with mock.patch.object(cg_solver, "make_app", ex_faulty_app):
            ex_main(cg_solver.main, n=EX_CG_N)
    except AssertionError as ex_err:
        ex_caught = str(ex_err)
    else:
        fail("examples:cg:fault: a resize that lost a row block of x "
             "passed the residual check")
    torch.cuda.empty_cache()
    phase("examples:cg:fault", planted="x loses its last row block at the "
          "4->8 resize", caught=repr(ex_caught))

    # phase 14's ex_trails, through the port's audit CLI
    ex_trails = sorted(os.path.join(trail_dir, f_)
                    for f_ in os.listdir(trail_dir) if f_.endswith(".json"))
    ex_audit_out = io.StringIO()
    with contextlib.redirect_stdout(ex_audit_out):
        ex_audit_rc = analysis_cli(["audit", *ex_trails])
    ex_audit_lines = ex_audit_out.getvalue().splitlines()
    if ex_audit_rc != 0 or len(ex_trails) != len(LIVE_GRID) or \
            len(ex_audit_lines) != len(ex_trails) or \
            not all(" clean (" in l_ for l_ in ex_audit_lines):
        fail(f"examples:audit: rc {ex_audit_rc} over {ex_trails}: "
             f"{ex_audit_lines}")
    phase("examples:audit", trails=len(ex_trails), rc=ex_audit_rc,
          events=",".join(l_.split("(")[1].split(" ")[0]
                          for l_ in ex_audit_lines))
    ex_s = time.perf_counter() - ex_t0
    phase("examples", apps=len(ex_apps), k1_quickstart=ex_k1_total,
          seconds=f"{ex_s:.1f}", budget_s=60)
    mark("examples")

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

    def moe_check(c, params, prompts, tag):
        """``logits_check`` of a MoE model on its first MOE_CHECK_LAYERS
        layers (the rest of ``params`` freed), at the check config: the
        capacity raised to hold every assignment and a window replaced by
        plain causal attention (see MOE_CHECK_LAYERS).  Both paths must
        drop nothing."""
        n_ = MOE_CHECK_LAYERS
        m_ = c.moe
        cc = dataclasses.replace(
            c, num_layers=n_, attention="full", window=0,
            moe=dataclasses.replace(m_, capacity_factor=m_.num_experts
                                    / m_.experts_per_token))
        params["layers"] = T.tree_map(lambda t: t[:n_].clone(),
                                      params["layers"])
        torch.cuda.empty_cache()
        with moe.count_drops() as drops:
            logits_check(cc, params, prompts, tag, (FP32_LOGITS_ATOL, None),
                         (MOE_BF16_LOGITS_MAX, MOE_BF16_LOGITS_RMS))
        if drops["dropped"] or not drops["routed"]:
            fail(f"{tag} logits check: {drops} assignments dropped/routed "
                 "at the check config's capacity")

    def moe_prefill(c, params, prompts, tag, kernel, runs):
        """The MoE model's ``make_prefill_step`` at B = 16, S = 256 (K1 once
        a layer on mma's ``kernel``, no K3) and its first tokens against
        the decode path's (``runs``, from the same weights and prompts;
        capacity drops differ between the two, so they are compared, not
        held equal).  Returns K1's launches."""
        L_ = c.num_layers
        n_k1 = prefill_launches(
            c, params, {"tokens": prompts}, tag,
            {"flash_attention": dict(no_k1, mma=L_),
             "ssd_scan": {"fma": 0, "wgmma": 0}},
            {"block": L_ * (kernel == "block"),
             "group": L_ * (kernel == "group")})["flash_attention"]
        with torch.no_grad():
            first = make_prefill_step(c)(params, {"tokens": prompts})
        agree = (first.cpu().numpy() == runs["static"]["tokens"][:, 0]).mean()
        phase(f"{tag}:first_token", prefill_vs_decode_agreement=f"{agree:.3f}")
        return n_k1

    # -- 16. mixtral serving at MOE_SERVE_LAYERS of its 32 layers, full
    # width: elastic decode (K1 on split_decode at G = 4, every slot of its
    # rolling window buffer live), prefill, logits, a traced decode step ----
    xs = dataclasses.replace(xcfg, num_layers=MOE_SERVE_LAYERS)
    xruns, x_dec_launches = serve_runs(xs, "mixtral", xs.num_layers)
    mark("mixtral_path")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    xparams = M.init_params(xs, torch.Generator(dev).manual_seed(0), dev)
    xprompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, xs.vocab_size, (BATCH, PROMPT), dtype=np.int32)).to(dev)
    x_prefill = moe_prefill(xs, xparams, xprompts, "mixtral", "group", xruns)
    traced_decode(xs, xparams, xprompts, "mixtral:profile", MOE_OP_GROUPS)
    moe_check(xs, xparams, xprompts, "mixtral")
    del xparams, xruns
    phase("mixtral", layers=xs.num_layers, params_b=f"{sum(int(np.prod(d.shape)) for d in T.leaves(M.model_schema(xs))) / 1e9:.3f}",
          peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    torch.cuda.empty_cache()
    mark("mixtral_serve")

    # -- 17. mixtral training (Listing 2): the smoke step on the card
    # against the CPU's, then elastic and static runs at full width --------
    xsm = get_config(f"{MIXTRAL}-smoke")
    xsbatch = lm_train_app(xsm, dataclasses.replace(
        get_shape("smoke"), global_batch=8)).dataset.batch_at(0)
    xsmoke = {}
    for d in ("cpu", dev):
        st = T.tree_map(lambda t: t.to(d), init_state(xsm, sopt, 0))
        ops.reset_counts()
        _, m = make_train_step(xsm, sopt)(
            st, {k_: torch.from_numpy(v_).to(d) for k_, v_ in xsbatch.items()})
        xsmoke[str(d)] = ({k_: float(m[k_]) for k_ in ("loss", "ce_loss",
                                                       "aux_loss",
                                                       "grad_norm")},
                          kernel_launches())
    (m_c, n_c), (m_g, n_g) = xsmoke["cpu"], xsmoke[str(dev)]
    nl = xsm.num_layers
    if n_c["flash_attention"] or n_g["flash_attention"] != nl or \
            n_g["flash_attention_bwd"] != nl or \
            n_g["paths"] != {"fma": nl, "mma": 0, "split_decode": 0}:
        fail(f"mixtral smoke train step launched {n_g} on the card, {n_c} "
             "on the CPU")
    if any(abs(m_g[k_] - m_c[k_]) > 1e-5 * abs(m_c[k_])
           for k_ in ("loss", "ce_loss", "aux_loss")) or \
            abs(m_g["grad_norm"] - m_c["grad_norm"]) > 1e-4 * m_c["grad_norm"]:
        fail(f"mixtral smoke train step: card {m_g} vs CPU {m_c}")
    phase("mixtral:train:smoke",
          **{f"{k_}_card": f"{m_g[k_]:.7f}" for k_ in m_g},
          **{f"{k_}_cpu": f"{m_c[k_]:.7f}" for k_ in m_c},
          k1_launches=f"{n_g['flash_attention']},{n_g['flash_attention_bwd']}")
    runner, state, _ = elastic_pair(
        dataclasses.replace(xcfg, num_layers=MX_ELASTIC_LAYERS),
        "mixtral:train", tol=MX_TP_LOSS_TOL)
    del runner, state
    mark("mixtral_train")
    xd = dataclasses.replace(xcfg, num_layers=MX_DEPTH_LAYERS)
    runner, state, losses, secs, counts = train_run(xd, {}, TRAIN_STEPS)
    x_train_k1 = (counts["flash_attention"], counts["flash_attention_bwd"])
    phase("mixtral:train:depth", layers=xd.num_layers,
          losses=",".join(f"{x:.6f}" for x in losses),
          ce_loss=",".join(f"{a:.6f}" for a, _ in runner.moe_losses),
          aux_loss=",".join(f"{b:.6f}" for _, b in runner.moe_losses),
          step_s=",".join(f"{x:.3f}" for x in secs),
          s_per_step=f"{step_s(secs):.4f}",
          tokens_per_s=f"{tokens_per_step / step_s(secs):.0f}",
          per_step=json.dumps({k_: counts[k_] / TRAIN_STEPS for k_ in
                               counts["paths"]}, separators=(",", ":")),
          paths=json.dumps(counts["paths"], separators=(",", ":")),
          state_gb=f"{sum(t.nbytes for t in T.leaves(state)) / 1e9:.2f}",
          peak_gb=f"{runner.peak_bytes / 1e9:.2f}")
    nl = xd.num_layers * xd.train_microbatches     # layer passes a step
    state, fields, _ = traced_step(runner, state, TRAIN_STEPS, {
        "k1_fwd": (is_k1_fwd, 2 * nl), "k1_bwd": (is_k1_bwd, 3 * nl)},
        MOE_OP_GROUPS)
    phase("mixtral:train:profile", layers=xd.num_layers, **fields)
    del runner, state
    torch.cuda.empty_cache()
    mark("mixtral_train_depth")

    # -- 18. qwen3-moe serving at MOE_SERVE_LAYERS of its 94 layers, full
    # width, bf16 master weights: elastic decode (K1 on split_decode at
    # G = 16, q/k norm), prefill (the block kernel), logits ----------------
    qs = dataclasses.replace(qcfg, num_layers=MOE_SERVE_LAYERS)
    qruns, q_dec_launches = serve_runs(qs, "qwen3moe", qs.num_layers)
    mark("qwen3moe_path")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    qparams = M.init_params(qs, torch.Generator(dev).manual_seed(0), dev)
    qprompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, qs.vocab_size, (BATCH, PROMPT), dtype=np.int32)).to(dev)
    q_prefill = moe_prefill(qs, qparams, qprompts, "qwen3moe", "block", qruns)
    traced_decode(qs, qparams, qprompts, "qwen3moe:profile", MOE_OP_GROUPS)
    # bf16 against fp32 at all 8 layers, each path against itself (the
    # same tokens routed together in both dtypes); prefill against decode
    # is held at the check config below
    logits_check(qs, qparams, qprompts[:, :Q8_CHECK_S], "qwen3moe:8", None,
                 (MOE_BF16_LOGITS_MAX, MOE_BF16_LOGITS_RMS))
    moe_check(qs, qparams, qprompts, "qwen3moe")
    del qparams, qruns
    phase("qwen3moe", layers=qs.num_layers, params_b=f"{sum(int(np.prod(d.shape)) for d in T.leaves(M.model_schema(qs))) / 1e9:.3f}",
          peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    torch.cuda.empty_cache()
    mark("qwen3moe_serve")

    def zoo_cpu_check(c, params, batch, tag, cross=None):
        """``c`` (cut in depth, fp32) on the card against the CPU from the
        same weights (``params``, on the card) and inputs: full-sequence
        logits (the last position's when the model is wide), then
        ZOO_CHECK_STEPS decode steps of the batch's tokens from an empty
        cache, each step's logits; ``cross`` (numpy, a seeded cross cache)
        replaces the encoder-decoder cache's zeros, and must come out of
        the card's decode unchanged.  Returns the largest gaps."""
        V = c.vocab_size
        cpu = torch.device("cpu")
        gaps = {}
        out = {}
        for d in (cpu, dev):
            p_ = T.tree_map(lambda t: t.to(d), params)
            b_ = {k_: v_.to(d) for k_, v_ in batch.items()}
            with torch.no_grad():
                lp = prefill_logits(p_, c, b_)[:, :V].float().cpu()
                toks = b_["tokens"]
                B_ = toks.shape[0]
                cache = M.init_cache(c, B_, ZOO_CHECK_STEPS, device=d,
                                     enc_len=None if cross is None else
                                     cross["k"].shape[2])
                if cross is not None:
                    cache["cross"] = {k_: torch.from_numpy(v_).to(d)
                                      for k_, v_ in cross.items()}
                steps_ = []
                for i in range(ZOO_CHECK_STEPS):
                    lg, cache = M.decode_step(
                        p_, c, toks[:, i:i + 1], cache,
                        torch.tensor(i, dtype=torch.int32, device=d))
                    steps_.append(lg[:, -1, :V].float().cpu())
            if cross is not None and d == dev and not all(
                    np.array_equal(cache["cross"][k_].cpu().numpy(), v_)
                    for k_, v_ in cross.items()):
                fail(f"{tag}: the decode steps wrote the cross cache")
            out[d.type] = (lp, torch.stack(steps_))
            del p_, b_, cache
        (lp_c, st_c), (lp_g, st_g) = out["cpu"], out["cuda"]
        if not all(bool(torch.isfinite(t).all()) for t in (lp_g, st_g)):
            fail(f"{tag}: the card's logits are not finite")
        gaps["prefill"] = (lp_g - lp_c).abs().max().item()
        gaps["decode"] = (st_g - st_c).abs().max().item()
        phase(f"{tag}:cpu_check", layers=c.num_layers,
              encoder_layers=c.encoder_layers,
              batch=batch["tokens"].shape[0],
              seq=batch["tokens"].shape[1],
              prefill_vs_cpu=f"{gaps['prefill']:.4e}",
              decode_vs_cpu=f"{gaps['decode']:.4e}",
              decode_steps=ZOO_CHECK_STEPS, tol=ZOO_FP32_ATOL,
              logits_std=f"{lp_c.std().item():.3f}",
              cross_cache="seeded, unchanged" if cross is not None else
              "none")
        if max(gaps.values()) > ZOO_FP32_ATOL:
            fail(f"{tag}: card against CPU fp32 logits differ by {gaps} > "
                 f"{ZOO_FP32_ATOL}")
        return gaps

    # -- 19. seamless-m4t-medium serving at full width and all 12 + 12
    # layers: elastic decode (K1 24 a step on split_decode: each decoder
    # layer's self-attention and its cross-attention over the 512-slot
    # cross cache), the prefill with 512 frames (K1 36 on mma's group
    # kernel), the card against the CPU at 2 + 2 layers -------------------
    sruns, _ = serve_runs(smcfg, "seamless", 2 * smcfg.num_layers)
    # by mask: each decoder layer's self-attention over the filled cache
    # prefix (kv_len) and its cross-attention over every slot (rect)
    s_dec_masks = sruns["static"]["k1_masks"]
    n_dec = smcfg.num_layers * (PROMPT + DECODE)
    if s_dec_masks != dict(dict.fromkeys(fa.MASKS, 0), kv_len=n_dec,
                           rect=n_dec):
        fail(f"seamless decode: K1 launches by mask {s_dec_masks}, not "
             f"{n_dec} kv_len and {n_dec} rect")
    mark("seamless_path")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sparams = M.init_params(smcfg, torch.Generator(dev).manual_seed(0), dev)
    sprompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, smcfg.vocab_size, (BATCH, PROMPT), dtype=np.int32)).to(dev)
    sframes = rand((BATCH, S_ENC, smcfg.frontend.embed_dim))
    L_ = smcfg.num_layers + smcfg.encoder_layers
    # by mask: the decoder's causal self-attention, the encoder's over its
    # 512 frames (square), the cross-attention's 256 over 512 (rect)
    s_prefill = prefill_launches(
        smcfg, sparams, {"tokens": sprompts, "frames": sframes}, "seamless",
        {"flash_attention": dict(no_k1, mma=L_ + smcfg.num_layers),
         "ssd_scan": {"fma": 0, "wgmma": 0}},
        {"block": 0, "group": L_ + smcfg.num_layers},
        {"causal": smcfg.num_layers, "kv_len": 0,
         "square": smcfg.encoder_layers, "rect": smcfg.num_layers}
    )["k1_masks"]
    n_ = ZOO_CHECK_LAYERS
    s22 = dataclasses.replace(smcfg, num_layers=n_, encoder_layers=n_,
                              dtype="float32")
    cut = dict(sparams, layers=T.tree_map(lambda t: t[:n_].clone(),
                                          sparams["layers"]),
               enc_layers=T.tree_map(lambda t: t[:n_].clone(),
                                     sparams["enc_layers"]))
    del sparams
    crng = np.random.default_rng(7)
    cshape = (n_, 4, 128, smcfg.num_kv_heads, smcfg.head_dim)
    zoo_cpu_check(s22, cut, {
        "tokens": sprompts[:4, :4 * ZOO_CHECK_STEPS].cpu(),
        "frames": sframes[:4, :128].cpu()}, "seamless",
        cross={k_: crng.standard_normal(cshape).astype(np.float32)
               for k_ in ("k", "v")})
    del cut, sruns
    phase("seamless", layers=f"{smcfg.encoder_layers}+{smcfg.num_layers}",
          params_b=f"{sum(int(np.prod(d.shape)) for d in T.leaves(M.model_schema(smcfg))) / 1e9:.3f}",
          peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    torch.cuda.empty_cache()
    mark("seamless_serve")

    # -- 20. seamless-m4t-medium training (Listing 2) at full width and
    # depth: 8 x 4096 tokens over 8 x 4096 frames, 6 static and 6 elastic
    # steps, K1 72 forward launches a step (remat) and 36 backward; a traced
    # step's K1 shares, and the CE's over the 256256-wide vocab ------------
    runner, state, counts = elastic_pair(smcfg, "seamless:train")
    # the non-causal launches (the encoder's and the cross-attention's,
    # over as many frames as tokens) by mask, each forward twice (remat)
    s_train_k1 = [m_["square"] + m_["rect"] for m_ in (
        counts["masks"]["flash_attention"],
        counts["masks"]["flash_attention_bwd"])]
    n_nc = (smcfg.encoder_layers + smcfg.num_layers) * TRAIN_STEPS
    if s_train_k1 != [2 * n_nc, n_nc] or any(
            m_["causal"] != f_ * smcfg.num_layers * TRAIN_STEPS
            for m_, f_ in zip(counts["masks"].values(), (2, 1))):
        fail(f"seamless training: K1 launches by mask {counts['masks']}, "
             f"not {2 * n_nc} and {n_nc} non-causal beside the decoder's "
             "causal")
    mark("seamless_train")
    na_ = 2 * smcfg.num_layers + smcfg.encoder_layers
    state, fields, _ = traced_step(runner, state, TRAIN_STEPS, {
        "k1_fwd": (is_k1_fwd, 2 * na_), "k1_bwd": (is_k1_bwd, 3 * na_)},
        spans={"ce": CE_SPAN})
    del runner, state
    torch.cuda.empty_cache()
    if float(fields["ce_ms"]) <= 0:
        fail("the profiler saw no device time in the traced seamless step's "
             f"CE span ({CE_SPAN})")
    phase("seamless:train:profile",
          layers=f"{smcfg.encoder_layers}+{smcfg.num_layers}", **fields,
          vocab_phys=phys_vocab(smcfg.vocab_size))
    mark("seamless_train_profile")

    # -- 21. pixtral-12b serving at PX_SERVE_LAYERS of its 40 layers, full
    # width: elastic text decode (K1 on split_decode at G = 4), the prefill
    # over 256 patch embeddings + 256 text tokens (K1 on mma's block
    # kernel), the card against the CPU at 2 layers ------------------------
    pxs = dataclasses.replace(pxcfg, num_layers=PX_SERVE_LAYERS)
    pxruns, px_dec_launches = serve_runs(pxs, "pixtral", pxs.num_layers)
    mark("pixtral_path")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pxparams = M.init_params(pxs, torch.Generator(dev).manual_seed(0), dev)
    pxprompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, pxs.vocab_size, (BATCH, PROMPT), dtype=np.int32)).to(dev)
    pxpatches = rand((BATCH, pxs.frontend.tokens_per_sample,
                      pxs.frontend.embed_dim))
    px_prefill = prefill_launches(
        pxs, pxparams, {"tokens": pxprompts, "patch_embeds": pxpatches},
        "pixtral", {"flash_attention": dict(no_k1, mma=pxs.num_layers),
                    "ssd_scan": {"fma": 0, "wgmma": 0}},
        {"block": pxs.num_layers, "group": 0})["flash_attention"]
    p2 = dataclasses.replace(pxs, num_layers=ZOO_CHECK_LAYERS,
                             dtype="float32")
    cut = dict(pxparams, layers=T.tree_map(
        lambda t: t[:ZOO_CHECK_LAYERS].clone(), pxparams["layers"]))
    del pxparams
    zoo_cpu_check(p2, cut, {"tokens": pxprompts[:1, :4 * ZOO_CHECK_STEPS].cpu(),
                            "patch_embeds": pxpatches[:1].cpu()}, "pixtral")
    del cut, pxruns
    phase("pixtral", layers=pxs.num_layers,
          params_b=f"{sum(int(np.prod(d.shape)) for d in T.leaves(M.model_schema(pxs))) / 1e9:.3f}",
          peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    torch.cuda.empty_cache()
    mark("pixtral_serve")

    # -- 22. pixtral-12b training at PX_TRAIN_LAYERS, full width: sequence
    # 4096 = 256 patches + 3840 text tokens, the loss on the text only, 6
    # static and 6 elastic steps ------------------------------------------
    runner, state, counts = elastic_pair(
        dataclasses.replace(pxcfg, num_layers=PX_TRAIN_LAYERS),
        "pixtral:train")
    px_train_k1 = (counts["flash_attention"], counts["flash_attention_bwd"])
    del runner, state
    torch.cuda.empty_cache()
    mark("pixtral_train")

    # -- 23-25. dense training (Listing 2) of phi4-mini-3.8b, qwen2.5-32b
    # and internlm2-20b at full width; each cut sized first by the dry run
    # on meta (launch/dryrun.py: argument and gradient bytes, the step's
    # counted FLOPs) ------------------------------------------------------
    def dense_smoke(name, tag):
        """``name``'s smoke config at its full config's head dim, GQA ratio
        and microbatches: one fp32 step on the card (K1 and its backward
        on fma, once a layer and microbatch) against the CPU's, loss within
        1e-5 and gradient norm within 1e-4 relative (phase 11's bounds)."""
        full = get_config(name)
        c = dataclasses.replace(
            get_config(f"{name}-smoke"), head_dim=full.head_dim,
            num_kv_heads=2, num_heads=2 * full.num_heads // full.num_kv_heads,
            train_microbatches=full.train_microbatches)
        batch = lm_train_app(c, dataclasses.replace(
            get_shape("smoke"), global_batch=8)).dataset.batch_at(0)
        got = {}
        for d in ("cpu", dev):
            st = T.tree_map(lambda t: t.to(d), init_state(c, sopt, 0))
            ops.reset_counts()
            _, m = make_train_step(c, sopt)(
                st, {k_: torch.from_numpy(v_).to(d)
                     for k_, v_ in batch.items()})
            got[str(d)] = (float(m["loss"]), float(m["grad_norm"]),
                           kernel_launches())
        (l_c, g_c, _), (l_g, g_g, n_g) = got["cpu"], got[str(dev)]
        n_ = c.num_layers * c.train_microbatches
        if n_g["flash_attention"] != n_ or \
                n_g["flash_attention_bwd"] != n_ or \
                n_g["paths"] != {"fma": n_, "mma": 0, "split_decode": 0}:
            fail(f"{tag} smoke train step launched {n_g}")
        if abs(l_g - l_c) > 1e-5 * abs(l_c) or \
                abs(g_g - g_c) > 1e-4 * abs(g_c):
            fail(f"{tag} smoke train step: card loss {l_g} / grad norm "
                 f"{g_g} vs CPU {l_c} / {g_c}")
        phase(f"{tag}:train:smoke", heads=f"{c.num_heads}/{c.num_kv_heads}",
              head_dim=c.head_dim, microbatches=c.train_microbatches,
              loss_card=f"{l_g:.7f}", loss_cpu=f"{l_c:.7f}",
              grad_norm_card=f"{g_g:.6f}", grad_norm_cpu=f"{g_c:.6f}")

    def dense_cut(c):
        """The dry run of ``c`` at the training shape, on meta: the state's
        and the batch's bytes, the gradients', one step's count and its
        model FLOPs."""
        step_, args_ = dryrun.abstract_args(c, tshape)
        arg_ = dryrun.argument_bytes(c, tshape, args_)
        return dict(state=arg_["state"], argument=sum(arg_.values()),
                    grads=dryrun.grad_bytes(c, tshape, args_["state"]),
                    leaves=len(T.leaves(args_["state"])),
                    count=flopcount.count(step_, *args_.values()),
                    model_flops=roofline.model_flops(c, tshape))

    def dense_record(runner, cut):
        """A cut's dry run beside what the card measured in its run."""
        s_ = step_s(runner.secs)
        return dict(cut, s_per_step=s_, peak=runner.peak_bytes -
                    runner.base_bytes, init=runner.init_bytes,
                    card_state=runner.state_bytes,
                    mfu=roofline.measured_mfu(cut["model_flops"], s_))

    def dense_profile(c, runner, state, tag):
        """One traced step of ``runner``: K1's forward and backward shares
        and the chunked CE's (``span_fields``); None, with a line that
        says so, when the profiler dropped records in four attempts (late
        in this long process it does: phase 26 needs one of the three)."""
        nl = c.num_layers * c.train_microbatches   # layer passes a step
        state, fields, _ = traced_step(runner, state, DENSE_STEPS, {
            "k1_fwd": (is_k1_fwd, 2 * nl), "k1_bwd": (is_k1_bwd, 3 * nl)},
            spans={"ce": CE_SPAN}, required=False)
        if fields is None:
            phase(f"{tag}:train:profile", layers=c.num_layers,
                  not_measured="the profiler dropped records in four "
                               "traced steps")
            return None
        if float(fields["ce_ms"]) <= 0:
            fail(f"the profiler saw no device time in the traced {tag} "
                 f"step's CE span ({CE_SPAN})")
        phase(f"{tag}:train:profile", layers=c.num_layers, **fields)
        return fields

    def dense_static(c, tag):
        """``DENSE_STEPS`` static steps of ``c``: s/step, tokens/s, peak;
        then one traced step.  Returns its record and kernel counts."""
        cut = dense_cut(c)
        runner, state, losses, secs, counts = train_run(c, {}, DENSE_STEPS)
        rec = dense_record(runner, cut)
        phase(f"{tag}:train:depth", layers=c.num_layers,
              microbatches=c.train_microbatches,
              losses=",".join(f"{x:.6f}" for x in losses),
              step_s=",".join(f"{x:.3f}" for x in secs),
              s_per_step=f"{rec['s_per_step']:.4f}",
              tokens_per_s=f"{tokens_per_step / rec['s_per_step']:.0f}",
              per_step=json.dumps({k_: counts[k_] / DENSE_STEPS for k_ in
                                   counts["paths"]}, separators=(",", ":")),
              state_gb=f"{cut['state'] / 1e9:.2f}",
              peak_gb=f"{rec['peak'] / 1e9:.2f}")
        prof = dense_profile(c, runner, state, tag)
        if prof is not None:
            rec["profile"] = prof
        del runner, state
        torch.cuda.empty_cache()
        return rec, counts

    dense_runs, dense_counts = {}, {}
    # -- 23. phi4-mini: the smoke step against the CPU; elastic and static
    # training at P_ELASTIC_LAYERS, bit for bit; the static depth run at
    # the largest cut the dry run and the 8-layer temporaries fit
    pfull = get_config(PHI4)
    dense_smoke(PHI4, "phi4")
    p8 = dataclasses.replace(pfull, num_layers=P_ELASTIC_LAYERS)
    p8_cut = dense_cut(p8)
    # the static run's state is freed before the elastic run: both beside
    # the step's 33 GB of other temporaries do not fit the card
    runner, _, counts = elastic_pair(p8, "phi4:train", steps=P_ELASTIC_STEPS,
                                     exact=True, keep_state=False)
    dense_runs[f"phi4:{P_ELASTIC_LAYERS}"] = dense_record(runner, p8_cut)
    # the 8-layer step's temporaries besides its gradients
    p_other = dense_runs[f"phi4:{P_ELASTIC_LAYERS}"]["peak"] - \
        p8_cut["argument"] - p8_cut["grads"]
    del runner
    torch.cuda.empty_cache()
    mark("phi4_train")
    p_fit = {}
    for L_ in P_STATIC_CUTS:
        c_ = dense_cut(dataclasses.replace(pfull, num_layers=L_))
        p_fit[L_] = c_["argument"] + c_["grads"] + p_other
        if p_fit[L_] <= DENSE_FIT_GB * 1e9:
            break
    else:
        fail(f"no phi4 static cut of {P_STATIC_CUTS} fits {DENSE_FIT_GB} "
             f"GB: {p_fit}")
    phase("phi4:train:fit", other_temps_gb_at_8=f"{p_other / 1e9:.2f}",
          predicted_peak_gb=json.dumps({k_: round(v_ / 1e9, 2) for k_, v_
                                        in p_fit.items()},
                                       separators=(",", ":")),
          limit_gb=DENSE_FIT_GB, cut=L_)
    pL = dataclasses.replace(pfull, num_layers=L_)
    dense_runs[f"phi4:{L_}"], dense_counts["phi4"] = dense_static(pL, "phi4")
    dense_runs[f"phi4:{L_}"]["predicted_peak"] = p_fit[L_]
    mark("phi4_train_depth")

    # -- 24. qwen2.5-32b: its QKV bias, 4 microbatches of 2; K1 at G = 5 --
    qfull = get_config(DENSE_TRAIN["qwen2.5"])
    dense_smoke(qfull.name, "qwen2.5")
    dense_runs[f"qwen2.5:{Q_TRAIN_LAYERS}"], dense_counts["qwen2.5"] = \
        dense_static(dataclasses.replace(qfull, num_layers=Q_TRAIN_LAYERS),
                     "qwen2.5")
    mark("qwen2_5_train")

    # -- 25. internlm2-20b: 2 microbatches of 4; K1 at G = 6 --------------
    ifull = get_config(DENSE_TRAIN["internlm2"])
    dense_smoke(ifull.name, "internlm2")
    dense_runs[f"internlm2:{I_TRAIN_LAYERS}"], dense_counts["internlm2"] = \
        dense_static(dataclasses.replace(ifull, num_layers=I_TRAIN_LAYERS),
                     "internlm2")
    mark("internlm2_train")

    # -- 26. the dry run against the card: for each cut the dry run's
    # bytes (meta) beside the card's (after init_state, and the peak), the
    # counted and model FLOPs, s/step, tokens/s, MFU at the bf16 peak
    for key, r_ in dense_runs.items():
        slack = ALLOC_SLACK_PER_LEAF * r_["leaves"]
        if r_["card_state"] != r_["state"] or \
                not 0 <= r_["init"] - r_["state"] <= slack:
            fail(f"dense:dryrun {key}: the card's state is "
                 f"{r_['card_state']} bytes and the allocator holds "
                 f"{r_['init']} after init_state; the dry run's state is "
                 f"{r_['state']} (allocator slack {slack})")
        cnt = r_["count"]
        phase(f"dense:dryrun:{key}",
              argument_gb=f"{r_['argument'] / 1e9:.3f}",
              state_gb=f"{r_['state'] / 1e9:.3f}",
              card_state_equal=True,
              card_init_gb=f"{r_['init'] / 1e9:.3f}",
              init_minus_state_bytes=r_["init"] - r_["state"],
              slack_bytes=slack,
              grads_gb=f"{r_['grads'] / 1e9:.3f}",
              measured_peak_gb=f"{r_['peak'] / 1e9:.2f}",
              temp_gb=f"{(r_['peak'] - r_['argument']) / 1e9:.2f}",
              **({"predicted_peak_gb": f"{r_['predicted_peak'] / 1e9:.2f}"}
                 if "predicted_peak" in r_ else {}),
              model_flops=f"{r_['model_flops']:.4e}",
              counted_flops=f"{cnt.flops:.4e}",
              k1_flops=f"{cnt.kernel_flops.get('flash_attention', 0) + cnt.kernel_flops.get('flash_attention_bwd', 0):.4e}",
              useful_ratio=f"{r_['model_flops'] / cnt.flops:.4f}",
              s_per_step=f"{r_['s_per_step']:.4f}",
              tokens_per_s=f"{tokens_per_step / r_['s_per_step']:.0f}",
              mfu=f"{r_['mfu']:.4f}",
              roofline_s=f"{max(cnt.flops / roofline.PEAK_FLOPS, cnt.hbm_bytes / roofline.HBM_BW):.4f}",
              **({f_: r_["profile"][f_] for f_ in (
                  "device_busy_ms", "idle_share", "k1_fwd_share",
                  "k1_bwd_share", "ce_ms", "ce_share")}
                 if "profile" in r_ else {}))
    if not any("profile" in r_ for r_ in dense_runs.values()):
        fail("dense:dryrun: no dense training step could be traced")
    mark("dense_dryrun")

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
        "launches_cluster_note": f"phase 14b: six {CLUSTER_LAYERS}-layer "
                                 "mamba2-370m tenants under dmr.Cluster, "
                                 "S=1024",
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
        p_rows["decode"], launches=fleet_decode_launches,
        launches_note=f"fleet:live, {FLEET_REPLICA_STEPS} replica-steps "
                      f"x {L} layers; fleet:inplace adds "
                      f"{n_in['flash_attention']}"))
    kernels.append(dict(p_rows["prefill"], launches=p_prefill,
                        launches_note="one make_prefill_step at 32 layers"))
    # the MoE family's rows, timed in phase 3d; their launches are the
    # serving paths' (16, 18) and mixtral's 2-layer training run's (17)
    for row, launches, note in zip(moe_rows.values(), (
            x_dec_launches, x_prefill, q_dec_launches, q_prefill,
            *x_train_k1, 0), (
            f"one decode_demo run at {MOE_SERVE_LAYERS} layers",
            f"one make_prefill_step at {MOE_SERVE_LAYERS} layers",
            f"one decode_demo run at {MOE_SERVE_LAYERS} layers",
            f"one make_prefill_step at {MOE_SERVE_LAYERS} layers",
            f"mixtral-8x7b's {TRAIN_STEPS}-step {MX_DEPTH_LAYERS}-layer "
            "training run", "the same run",
            "no path of this script: the window bites only past 4096 "
            "tokens, and the training path runs 4096")):
        kernels.append(dict(row, launches=launches, launches_note=note))
    # the encoder-decoder and vision-prefix families' rows, timed in phase
    # 3e; their launches are the paths' (19-22), counted by mask
    # (fa.mask_of) where K1 launches them
    for key, launches, note in (
            ("encoder prefill", s_prefill["square"],
             "one make_prefill_step at 12 + 12 layers, its non-causal "
             "Sq = Sk launches (the encoder's)"),
            ("cross prefill", s_prefill["rect"],
             "the same prefill's non-causal Sq != Sk launches (the "
             "cross-attention's)"),
            ("cross decode", s_dec_masks["rect"],
             "one decode_demo run at 12 decoder layers, its launches with "
             "neither kv_len nor mask (the cross-attention's)"),
            ("train fwd", s_train_k1[0],
             f"seamless's {TRAIN_STEPS}-step static training run at 12 + 12 "
             "layers, its non-causal launches (the encoder's and the "
             "cross-attention's)"),
            ("train bwd", s_train_k1[1], "the same run's"),
            ("pixtral prefill", px_prefill,
             f"one make_prefill_step at {PX_SERVE_LAYERS} layers")):
        kernels.append(dict(zoo_rows[key], launches=launches,
                            launches_note=note))
    # the dense training rows, timed in phase 3c; their launches are the
    # static depth runs' (23-25), counted by mask (all causal)
    for dn_tag, (dn_rows, _, dn_drop) in dense_k1.items():
        for key, k_name in (("train fwd", "flash_attention"),
                             ("train bwd", "flash_attention_bwd")):
            kernels.append(dict(
                dn_rows[key], tile_drop_gap=dn_drop,
                launches=dense_counts[dn_tag]["masks"][k_name]["causal"],
                launches_note=f"{dn_tag}'s {DENSE_STEPS}-step static depth "
                              "run, its causal launches"))
    # the sequence shards' rows and qwen3-moe's G = 16 training rows, timed
    # in phase 3f; their launches are phase 3g's elastic run's (offset
    # mask) and phase 3h's (causal)
    for row, launches, note in (
            (sp_rows["offset fwd"], seq_launches[0],
             f"phi4:seq's elastic run at {P_ELASTIC_LAYERS} layers, its "
             "offset launches (each one of 16 shards)"),
            (sp_rows["offset bwd"], seq_launches[1], "the same run's"),
            (qm_rows["train fwd"], qm_launches[0],
             f"qwen3moe:train's {QM_STEPS}-step run, its causal launches"),
            (qm_rows["train bwd"], qm_launches[1], "the same run's")):
        kernels.append(dict(row, launches=launches, launches_note=note))
    mark("kernels")
    phase("timing", **{k: f"{v:.1f}" for k, v in marks.items()})
    print(json.dumps({"kernels": kernels, "card": smi_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
