// Backward of the Mamba2 SSD chunked scan (K3) for Hopper (sm_90a), plain C
// interface for ctypes.
//
// No TPU kernel to replace: the JAX package differentiates its pure-jnp
// `ssd_chunked` (src/repro/models/ssm.py:57) through XLA.  This is the
// gradient of `ssd_scan_fwd` (csrc/ssd_scan.cu, which replaces the Pallas
// kernel `_ssd_kernel` of src/repro/kernels/ssd_scan.py), so that the SSM
// block trains on the card.  Its plain version is
// `ssd_chunked_backward_reference` (kernels/ref.py).
//
// The forward, per (batch b, head h) and chunk of Q positions, with the
// chunk-start state S_in (P x N, zero for the first chunk), cum the
// in-chunk cumsum of a and tot = cum[Q-1]:
//   y_q   = sum_{s <= q} (C_q . B_s) exp(cum_q - cum_s) x_s + exp(cum_q) S_in C_q
//   S_out = exp(tot) S_in + sum_s exp(tot - cum_s) x_s (x) B_s
// Given dy it returns dx, da (fp32), and dB and dC summed over the heads:
//   dS_out(last chunk) = 0, dS_in = exp(tot) dS_out + sum_q exp(cum_q) dy_q (x) C_q
//   dx_s  = sum_{q >= s} G_qs L_qs dy_q + exp(tot - cum_s) dS_out B_s
//   dC_q  = sum_{s <= q} D_qs L_qs B_s + exp(cum_q) dy_q S_in
//   dB_s  = sum_{q >= s} D_qs L_qs C_q + exp(tot - cum_s) dS_out^T x_s
//   dcum  = rowsum(W) - colsum(W) + exp(cum_q) dy_q . (S_in C_q) - V_q
//           (+ sum_s V_s + exp(tot) <dS_out, S_in> at q = Q-1)
//   da_t  = sum_{q >= t} dcum_q within the chunk
// with G = C B^T, L_qs = exp(cum_q - cum_s) (s <= q only: a masked entry is
// never exponentiated, and no exp(-cum) is ever formed, since in-chunk
// cumsums reach ~-3e3 at mamba2's decays), D_qs = dy_q . x_s, W = G o L o
// D and V_s = exp(tot - cum_s) x_s . (dS_out B_s).
//
// What bounds it on the card: at the training shape (B=8, S=4096, H=32,
// P=64, N=128, Q=256, bf16) the work: ~1.9e11 flop over the causal pairs
// against ~0.44 GB of inputs and outputs (0.19 ms at the bf16 tensor-core
// peak, 0.13 ms at 3.35 TB/s).  One entry point, two device paths; the
// wrapper chooses and passes the path, and the entry point refuses one that
// cannot take the call:
//
// * wgmma (bf16; P, N multiples of 16 up to 64 and 128; Q a multiple of 64
//   up to 256; 16-byte aligned rows).  Every product on the tensor cores
//   with fp32 accumulators, four launches:
//   w1. states  (b, h, direction): one warpgroup walks the sequence in
//       64-row sub-chunks with the state in its accumulators, as the forward
//       kernel does: forward S <- e^l63 S + (x o e^(l63 - l))^T B, storing
//       S_in at each chunk's start (and cum, tot); backward dS <- e^l63 dS
//       + (dy o e^l)^T C, storing dS_out at each chunk's end.  l is the
//       sub-chunk's local cumsum, so no exponent leaves [l63, 0].
//   w2. pairs   (b, chunk, key tile s): two warpgroups walk the heads.  G^T
//       = B C^T of the tile's pairs is made once for all heads and kept in
//       shared memory (fp32); per head and pair D^T = x dy^T on wgmma, then
//       L, G o L, D o L and W = G o L o D once, on the CUDA cores: dx +=
//       (G o L)^T dy on wgmma, the row and column sums of W in fp32, and M
//       = sum_h D o L summed in the accumulators over the heads.  dx's state
//       term e^(tot - cum) (B dS_out^T) and V come first, so dx is whole
//       when the head ends.  M goes out once, as bf16 hi + lo.
//   w3. tiles   (b, chunk, tile): two warpgroups walk the heads, one
//       summing dB's state term e^(tot - cum) (x dS_out), the other dC's
//       e^cum (dy S_in) and dcum's e^cum dy . (S_in C); then dB += M^T C and
//       dC += M B over the tile's pairs.  The head sums stay in the
//       accumulators (no per-head workspace, no atomics: a fixed order).
//   w4. da      (b, h, chunk): dcum from its parts and its reverse cumsum.
//   Operands: x, dy, B, C are bf16 inputs, exact.  The carried states and
//   the decayed rows of their sums go in as bf16 hi + lo (~16 bits), and M
//   too; G o L is rounded once.  Row scales that depend on the head stay
//   fp32, applied to the accumulators.  The CPU rounding model
//   (kernels/ssd_rounding.py, model_grads) shows why: at the training shape
//   this holds SSD_BWD_TOL with ~2.9x to spare, and rounding the states or
//   the decayed rows once puts da 6.0x or 5.1x past its 1e-4.  Loads:
//   cp.async into 128-byte-swizzled tiles, each head's tiles landing while
//   the previous head computes.  Workspace ~0.34 GB at the training shape.
// * fma (fp32, and bf16 shapes the wgmma path does not take).  The first
//   version: every product fp32 FMAs on the CUDA cores (bf16 inputs are
//   widened on load, so both dtypes accumulate in fp32).  Seven launches,
//   each a plain tiled loop:
//   1. local   (b, h, chunk): cum (kept for the others), tot, and the
//              chunk's own state sums sum_s exp(tot - cum_s) x_s (x) B_s and
//              sum_q exp(cum_q) dy_q (x) C_q;
//   2. gram    (b, chunk, tile pair): G = C B^T on and below the diagonal,
//              computed once for all heads;
//   3. scan    (b, h, state entry): in place, the chunk-start states
//              forward and the chunk-end state gradients backward;
//   4. dq      (b, h, chunk, 64-row query tile): dC per head, rowsum(W)
//              and the state term of dcum;
//   5. dk      (b, h, chunk, 64-row key tile): dx, dB per head, colsum(W)
//              and V; the first key tile's CTA also <dS_out, S_in>;
//   6. heads   dB and dC summed over the heads in a fixed order (no
//              atomics: two runs are equal bit for bit);
//   7. da      (b, h, chunk): dcum and its reverse cumsum.
//   The per-head dB / dC partials (B, H, S, N) and the states (B, H, S/Q, P,
//   N) live in one fp32 workspace that the wrapper allocates (~1.4 GB at the
//   training shape, transient).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <initializer_list>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxP = 64, kMaxN = 128, kMaxQ = 4096;
constexpr int kThreads = 256;                   // a 16 x 16 thread grid
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                       // rows per query / key tile
constexpr int kMT = kTile / 16;                 // tile rows per thread
constexpr int kMP = kMaxP / 16;                 // head dims per thread
constexpr int kMN = kMaxN / 16;                 // state dims per thread
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* x;
  const float* a;
  const void* bm;
  const void* cm;
  const void* dy;
  void* dx;                                     // (B, S, H, P), contiguous
  float* da;                                    // (B, S, H), contiguous
  void* dbm;                                    // (B, S, N), contiguous
  void* dcm;                                    // (B, S, N), contiguous
  int B, S, H, P, N, Q, nc, ntiles;
  long long sxb, sxs, sxh;                      // input strides in elements;
  long long sab, sas, sah;                      // the last dim of x, B, C
  long long sbb, sbs;                           // and dy is contiguous
  long long scb, scs;
  long long sgb, sgs, sgh;                      // dy
  // fp32 workspace
  float* cum;                                   // (B, H, S)
  float* rp;                                    // (B, H, S): rowsum(W) + state term
  float* cp;                                    // (B, H, S): colsum(W) + V
  float* vv;                                    // (B, H, S): V
  float* tot;                                   // (B, H, nc)
  float* inner;                                 // (B, H, nc): <dS_out, S_in>
  float* st;                                    // (B, H, nc, P, N): S_in
  float* ds;                                    // (B, H, nc, P, N): dS_out
  float* gram;                                  // (B, nc, Q, Q): C B^T
  float* dbh;                                   // (B, H, S, N): dB per head
  float* dch;                                   // (B, H, S, N): dC per head
  // the wgmma path's own (cum, tot and inner as above)
  float* wd;                                    // (kSlots, B, H, S): dcum's parts
  bf16* sin;                                    // (B, H, nc, hi / lo, 64, NP): S_in
  bf16* dso;                                    // (B, H, nc, hi / lo, 64, NP): dS_out
  bf16* mt;                                     // (B, nc, nt, nt, hi / lo, 64, 64): M^T
};

long long round4(long long n) { return (n + 3) / 4 * 4; }

// Floats of the fma path's workspace, in the order ssd_scan_bwd takes them.
long long fma_workspace_floats(int B, int S, int H, int P, int N, int Q) {
  const long long bh = static_cast<long long>(B) * H, nc = S / Q;
  return 4 * round4(bh * S) + 2 * round4(bh * nc) +
         2 * round4(bh * nc * P * N) + round4(B * nc * Q * Q) +
         2 * round4(bh * S * N);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_from_f32(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// kTile rows of `width` values into shared memory (row stride ld), widened
// to fp32; rows at or past `rows` are zero.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          long long row_stride, int rows,
                                          int width) {
  for (int e = threadIdx.x; e < kTile * width; e += kThreads) {
    const int r = e / width, col = e % width;
    dst[r * ld + col] = r < rows ? to_f32(src[r * row_stride + col]) : 0.f;
  }
}

// In-place inclusive scan of v[0..n) by the whole CTA (as the forward's).
__device__ __forceinline__ void block_cumsum(float* v, int n, float* wsum) {
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = min(n, static_cast<int>(threadIdx.x) * per);
  const int hi = min(n, lo + per);
  float run = 0.f;
  for (int t = lo; t < hi; ++t) {
    run += v[t];
    v[t] = run;
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float inc = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += up;
  }
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  float off = inc - run;
  for (int w = 0; w < warp; ++w) off += wsum[w];
  for (int t = lo; t < hi; ++t) v[t] += off;
  __syncthreads();
}

// The sum of every thread's v, in a fixed order, returned to every thread.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  __syncthreads();                              // red free
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += red[w];
  return t;
}

// Sum over the 16 threads of a row of the 16 x 16 thread grid (lanes that
// differ in their low four bits).
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// -- 1. cum, tot and the chunk's own state sums ---------------------------
// grid (nc, H, B).  Pass 0: sum_s exp(tot - cum_s) x_s (x) B_s -> st; pass
// 1: sum_q exp(cum_q) dy_q (x) C_q -> ds.  Thread (ty, tx) owns entries
// (p = ty + 16 i, n = tx + 16 j).
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_local_kernel(const Params p) {
  extern __shared__ float smem[];
  __shared__ float wsum[kWarps];
  const int P = p.P, N = p.N, Q = p.Q;
  float* cum = smem;                            // Q
  float* wgt = cum + Q;                         // Q
  float* Rs = wgt + Q;                          // kTile x P: x or dy rows
  float* Ms = Rs + kTile * P;                   // kTile x N: B or C rows
  const int c = blockIdx.x, h = blockIdx.y;
  const long long b = blockIdx.z, bh = b * p.H + h;
  const long long row0 = static_cast<long long>(c) * Q;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int PB = P / 16, NB = N / 16;

  for (int t = threadIdx.x; t < Q; t += kThreads)
    cum[t] = p.a[b * p.sab + (row0 + t) * p.sas + h * p.sah];
  __syncthreads();
  block_cumsum(cum, Q, wsum);
  const float tot = cum[Q - 1];
  for (int t = threadIdx.x; t < Q; t += kThreads) {
    p.cum[bh * p.S + row0 + t] = cum[t];
    wgt[t] = expf(tot - cum[t]);
  }
  if (threadIdx.x == 0) p.tot[bh * p.nc + c] = tot;

  for (int pass = 0; pass < 2; ++pass) {
    const T* rsrc = static_cast<const T*>(pass ? p.dy : p.x) +
                    b * (pass ? p.sgb : p.sxb) + row0 * (pass ? p.sgs : p.sxs) +
                    h * (pass ? p.sgh : p.sxh);
    const long long rstride = pass ? p.sgs : p.sxs;
    const T* msrc = static_cast<const T*>(pass ? p.cm : p.bm) +
                    b * (pass ? p.scb : p.sbb) + row0 * (pass ? p.scs : p.sbs);
    const long long mstride = pass ? p.scs : p.sbs;
    if (pass == 1) {
      __syncthreads();                          // pass 0 read wgt
      for (int t = threadIdx.x; t < Q; t += kThreads) wgt[t] = expf(cum[t]);
    }
    float acc[kMP][kMN];
#pragma unroll
    for (int i = 0; i < kMP; ++i)
#pragma unroll
      for (int j = 0; j < kMN; ++j) acc[i][j] = 0.f;
    for (int s0 = 0; s0 < Q; s0 += kTile) {
      const int rows = min(kTile, Q - s0);
      __syncthreads();                          // Rs, Ms free; wgt written
      load_rows(Rs, P, rsrc + s0 * rstride, rstride, rows, P);
      load_rows(Ms, N, msrc + s0 * mstride, mstride, rows, N);
      __syncthreads();
      for (int r = 0; r < rows; ++r) {
        const float w = wgt[s0 + r];
        float rv[kMP], mv[kMN];
#pragma unroll
        for (int i = 0; i < kMP; ++i)
          rv[i] = i < PB ? Rs[r * P + ty + 16 * i] * w : 0.f;
#pragma unroll
        for (int j = 0; j < kMN; ++j)
          mv[j] = j < NB ? Ms[r * N + tx + 16 * j] : 0.f;
#pragma unroll
        for (int i = 0; i < kMP; ++i)
#pragma unroll
          for (int j = 0; j < kMN; ++j) acc[i][j] = fmaf(rv[i], mv[j], acc[i][j]);
      }
    }
    float* out = (pass ? p.ds : p.st) + (bh * p.nc + c) * P * N;
#pragma unroll
    for (int i = 0; i < kMP; ++i)
#pragma unroll
      for (int j = 0; j < kMN; ++j)
        if (i < PB && j < NB) out[(ty + 16 * i) * N + tx + 16 * j] = acc[i][j];
  }
}

// -- 2. G = C B^T, the tiles on and below the diagonal --------------------
// grid (ntiles^2 * nc, B); thread (ty, tx) owns (q = ty + 16 i, s = tx + 16 j).
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_gram_kernel(const Params p) {
  extern __shared__ float smem[];
  const int N = p.N, Q = p.Q, nt = p.ntiles;
  const int ld = N + 1;
  float* Cs = smem;                             // kTile x ld
  float* Bs = Cs + kTile * ld;                  // kTile x ld
  const int pair = blockIdx.x % (nt * nt), c = blockIdx.x / (nt * nt);
  const int qt = pair / nt, st = pair % nt;
  if (st > qt) return;
  const long long b = blockIdx.y;
  const long long row0 = static_cast<long long>(c) * Q;
  const int q0 = qt * kTile, s0 = st * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  load_rows(Cs, ld, static_cast<const T*>(p.cm) + b * p.scb + (row0 + q0) * p.scs,
            p.scs, min(kTile, Q - q0), N);
  load_rows(Bs, ld, static_cast<const T*>(p.bm) + b * p.sbb + (row0 + s0) * p.sbs,
            p.sbs, min(kTile, Q - s0), N);
  __syncthreads();
  float g[kMT][kMT];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kMT; ++j) g[i][j] = 0.f;
  for (int n = 0; n < N; ++n) {
    float cv[kMT], bv[kMT];
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      cv[i] = Cs[(ty + 16 * i) * ld + n];
      bv[i] = Bs[(tx + 16 * i) * ld + n];
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kMT; ++j) g[i][j] = fmaf(cv[i], bv[j], g[i][j]);
  }
  float* out = p.gram + (b * p.nc + c) * Q * static_cast<long long>(Q);
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kMT; ++j) {
      const int q = q0 + ty + 16 * i, s = s0 + tx + 16 * j;
      if (q < Q && s < Q) out[static_cast<long long>(q) * Q + s] = g[i][j];
    }
}

// -- 3. chunk-start states and chunk-end state gradients ------------------
// grid (B * H, ceil(P N / kThreads)): one (p, n) state entry per thread,
// carried across the chunks forward (st: local sums -> S_in) and backward
// (ds: local sums -> dS_out), in place; each batch of kBatch chunks' loads
// is issued before any of their stores, so the pass streams at the memory's
// rate instead of waiting on one load per chunk.
constexpr int kBatch = 8;

__global__ void __launch_bounds__(kThreads) ssd_bwd_scan_kernel(const Params p) {
  const long long PN = static_cast<long long>(p.P) * p.N;
  const int e = blockIdx.y * kThreads + threadIdx.x, nc = p.nc;
  if (e >= PN) return;
  const long long bh = blockIdx.x;
  float* st = p.st + bh * nc * PN + e;
  float* ds = p.ds + bh * nc * PN + e;
  const float* tot = p.tot + bh * nc;
  float run = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kBatch) {
    float d[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      d[k] = c0 + k < nc ? st[(c0 + k) * PN] : 0.f;
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (c0 + k < nc) {
        st[(c0 + k) * PN] = run;
        run = fmaf(run, expf(tot[c0 + k]), d[k]);
      }
  }
  run = 0.f;
  for (int c1 = nc - 1; c1 >= 0; c1 -= kBatch) {
    float d[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      d[k] = c1 - k >= 0 ? ds[(c1 - k) * PN] : 0.f;
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (c1 - k >= 0) {
        ds[(c1 - k) * PN] = run;
        run = fmaf(run, expf(tot[c1 - k]), d[k]);
      }
  }
}

// -- 4. per query tile: dC (per head), rowsum(W) + the state term of dcum --
// grid (nc * ntiles, H, B).  Thread (ty, tx) owns query rows q = ty + 16 i,
// and (n = tx + 16 j) of dC, (s = tx + 16 j) of a key tile.
size_t dq_smem_floats(int P, int N, int Q) {
  return size_t(Q) + 2 * size_t(kTile) * (P + 1) + size_t(kTile) * N +
         size_t(kTile) * (kTile + 1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_dq_kernel(const Params p) {
  extern __shared__ float smem[];
  const int P = p.P, N = p.N, Q = p.Q;
  const int ldp = P + 1, ldw = kTile + 1;
  float* cum = smem;                            // Q
  float* Ys = cum + Q;                          // kTile x ldp: dy, query tile
  float* Xs = Ys + kTile * ldp;                 // kTile x ldp: x, key tile
  float* Bs = Xs + kTile * ldp;                 // kTile x N: B, key tile (first S_in, P x N)
  float* Ws = Bs + kTile * N;                   // kTile x ldw: D o L
  const int c = blockIdx.x / p.ntiles, qt = blockIdx.x % p.ntiles;
  const int h = blockIdx.y;
  const long long b = blockIdx.z, bh = b * p.H + h;
  const long long row0 = static_cast<long long>(c) * Q;
  const int q0 = qt * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int NB = N / 16;
  const T* x = static_cast<const T*>(p.x) + b * p.sxb + row0 * p.sxs + h * p.sxh;
  const T* bm = static_cast<const T*>(p.bm) + b * p.sbb + row0 * p.sbs;
  const T* cm = static_cast<const T*>(p.cm) + b * p.scb + row0 * p.scs;
  const T* dy = static_cast<const T*>(p.dy) + b * p.sgb + row0 * p.sgs + h * p.sgh;
  const float* gram = p.gram + (b * p.nc + c) * Q * static_cast<long long>(Q);

  for (int t = threadIdx.x; t < Q; t += kThreads) cum[t] = p.cum[bh * p.S + row0 + t];
  load_rows(Ys, ldp, dy + q0 * p.sgs, p.sgs, min(kTile, Q - q0), P);
  const float* s_in = p.st + (bh * p.nc + c) * P * N;
  for (int e = threadIdx.x; e < P * N; e += kThreads) Bs[e] = s_in[e];
  __syncthreads();

  // state term: acc = exp(cum_q) dy_q S_in; dcum's exp(cum_q) dy_q . (S_in C_q)
  float acc[kMT][kMN];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kMN; ++j) acc[i][j] = 0.f;
  for (int pp = 0; pp < P; ++pp) {
    float yv[kMT], sv[kMN];
#pragma unroll
    for (int i = 0; i < kMT; ++i) yv[i] = Ys[(ty + 16 * i) * ldp + pp];
#pragma unroll
    for (int j = 0; j < kMN; ++j) sv[j] = j < NB ? Bs[pp * N + tx + 16 * j] : 0.f;
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kMN; ++j) acc[i][j] = fmaf(yv[i], sv[j], acc[i][j]);
  }
  float row[kMT];
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    const int q = q0 + ty + 16 * i;
    const float e = q < Q ? expf(cum[q]) : 0.f;
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < kMN; ++j) {
      acc[i][j] *= e;
      if (q < Q && j < NB)
        part = fmaf(acc[i][j], to_f32(cm[q * p.scs + tx + 16 * j]), part);
    }
    row[i] = part;
  }

  // the key tiles at or below the diagonal
  for (int st = 0; st <= qt; ++st) {
    const int s0 = st * kTile;
    __syncthreads();                            // Xs, Bs, Ws free
    load_rows(Xs, ldp, x + s0 * p.sxs, p.sxs, min(kTile, Q - s0), P);
    load_rows(Bs, N, bm + s0 * p.sbs, p.sbs, min(kTile, Q - s0), N);
    __syncthreads();
    float d[kMT][kMT];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kMT; ++j) d[i][j] = 0.f;
    for (int pp = 0; pp < P; ++pp) {
      float yv[kMT], xv[kMT];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        yv[i] = Ys[(ty + 16 * i) * ldp + pp];
        xv[i] = Xs[(tx + 16 * i) * ldp + pp];
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kMT; ++j) d[i][j] = fmaf(yv[i], xv[j], d[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kMT; ++j) {
        const int q = q0 + ty + 16 * i, s = s0 + tx + 16 * j;
        float dl = 0.f;
        if (q < Q && s <= q) {                  // causal: only s <= q
          dl = d[i][j] * expf(cum[q] - cum[s]);
          row[i] = fmaf(gram[static_cast<long long>(q) * Q + s], dl, row[i]);
        }
        Ws[(ty + 16 * i) * ldw + tx + 16 * j] = dl;
      }
    __syncthreads();
    for (int ss = 0; ss < kTile; ++ss) {
      float wv[kMT], bv[kMN];
#pragma unroll
      for (int i = 0; i < kMT; ++i) wv[i] = Ws[(ty + 16 * i) * ldw + ss];
#pragma unroll
      for (int j = 0; j < kMN; ++j) bv[j] = j < NB ? Bs[ss * N + tx + 16 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kMN; ++j) acc[i][j] = fmaf(wv[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    const float r = row_sum16(row[i]);
    const int q = q0 + ty + 16 * i;
    if (q >= Q) continue;
    if (tx == 0) p.rp[bh * p.S + row0 + q] = r;
    float* out = p.dch + (bh * p.S + row0 + q) * N;
#pragma unroll
    for (int j = 0; j < kMN; ++j)
      if (j < NB) out[tx + 16 * j] = acc[i][j];
  }
}

// -- 5. per key tile: dx, dB (per head), colsum(W) + V ---------------------
// grid (nc * ntiles, H, B).  Thread (ty, tx) owns key rows s = ty + 16 i,
// and (p = tx + 16 j) of dx, (n = tx + 16 j) of dB, (q = tx + 16 j) of a
// query tile.
size_t dk_smem_floats(int P, int N, int Q) {
  const size_t r = size_t(kTile) * (P + 1) + size_t(kTile) * (kTile + 1);
  const size_t s = size_t(P) * (N + 1);
  return size_t(Q) + kTile + size_t(kTile) * (P + 1) + size_t(kTile) * (N + 1) +
         (r > s ? r : s);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_dk_kernel(const Params p) {
  extern __shared__ float smem[];
  __shared__ float red[kWarps];
  const int P = p.P, N = p.N, Q = p.Q;
  const int ldp = P + 1, ldn = N + 1, ldw = kTile + 1;
  float* cum = smem;                            // Q
  float* dec = cum + Q;                         // kTile: exp(tot - cum_s)
  float* Xs = dec + kTile;                      // kTile x ldp: x, key tile
  float* Ms = Xs + kTile * ldp;                 // kTile x ldn: B of the key tile, then C of a query tile
  float* Rs = Ms + kTile * ldn;                 // dS_out (P x ldn), then:
  float* Ys = Rs;                               //   kTile x ldp: dy, query tile
  float* Ws = Rs + kTile * ldp;                 //   kTile x ldw: G, G o L, D o L ([q][s])
  const int c = blockIdx.x / p.ntiles, st = blockIdx.x % p.ntiles;
  const int h = blockIdx.y;
  const long long b = blockIdx.z, bh = b * p.H + h;
  const long long row0 = static_cast<long long>(c) * Q;
  const int s0 = st * kTile, ns = min(kTile, Q - s0);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int PB = P / 16, NB = N / 16;
  const T* x = static_cast<const T*>(p.x) + b * p.sxb + row0 * p.sxs + h * p.sxh;
  const T* bm = static_cast<const T*>(p.bm) + b * p.sbb + row0 * p.sbs;
  const T* cm = static_cast<const T*>(p.cm) + b * p.scb + row0 * p.scs;
  const T* dy = static_cast<const T*>(p.dy) + b * p.sgb + row0 * p.sgs + h * p.sgh;
  const float* gram = p.gram + (b * p.nc + c) * Q * static_cast<long long>(Q);

  for (int t = threadIdx.x; t < Q; t += kThreads) cum[t] = p.cum[bh * p.S + row0 + t];
  load_rows(Xs, ldp, x + s0 * p.sxs, p.sxs, ns, P);
  load_rows(Ms, ldn, bm + s0 * p.sbs, p.sbs, ns, N);
  const float* ds = p.ds + (bh * p.nc + c) * P * N;
  for (int e = threadIdx.x; e < P * N; e += kThreads) Rs[(e / N) * ldn + e % N] = ds[e];
  __syncthreads();
  for (int r = threadIdx.x; r < kTile; r += kThreads)
    dec[r] = r < ns ? expf(cum[Q - 1] - cum[s0 + r]) : 0.f;
  if (st == 0) {            // one CTA per (b, h, chunk): <dS_out, S_in>
    const float* s_in = p.st + (bh * p.nc + c) * P * N;
    float part = 0.f;
    for (int e = threadIdx.x; e < P * N; e += kThreads)
      part = fmaf(Rs[(e / N) * ldn + e % N], s_in[e], part);
    const float inner = block_sum(part, red);
    if (threadIdx.x == 0) p.inner[bh * p.nc + c] = inner;
  }
  __syncthreads();

  // state terms: dx = dec_s dS_out B_s, dB = dec_s dS_out^T x_s, V = x_s . dx_s
  float adx[kMT][kMP], adb[kMT][kMN];
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int j = 0; j < kMP; ++j) adx[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < kMN; ++j) adb[i][j] = 0.f;
  }
  for (int n = 0; n < N; ++n) {
    float bv[kMT], sv[kMP];
#pragma unroll
    for (int i = 0; i < kMT; ++i) bv[i] = Ms[(ty + 16 * i) * ldn + n];
#pragma unroll
    for (int j = 0; j < kMP; ++j) sv[j] = j < PB ? Rs[(tx + 16 * j) * ldn + n] : 0.f;
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kMP; ++j) adx[i][j] = fmaf(bv[i], sv[j], adx[i][j]);
  }
  for (int pp = 0; pp < P; ++pp) {
    float xv[kMT], sv[kMN];
#pragma unroll
    for (int i = 0; i < kMT; ++i) xv[i] = Xs[(ty + 16 * i) * ldp + pp];
#pragma unroll
    for (int j = 0; j < kMN; ++j) sv[j] = j < NB ? Rs[pp * ldn + tx + 16 * j] : 0.f;
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kMN; ++j) adb[i][j] = fmaf(xv[i], sv[j], adb[i][j]);
  }
  float vacc[kMT], col[kMT];
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    const float e = dec[ty + 16 * i];
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < kMP; ++j) {
      adx[i][j] *= e;
      if (j < PB) v = fmaf(Xs[(ty + 16 * i) * ldp + tx + 16 * j], adx[i][j], v);
    }
#pragma unroll
    for (int j = 0; j < kMN; ++j) adb[i][j] *= e;
    vacc[i] = v;
    col[i] = 0.f;
  }

  // the query tiles at or after the diagonal
  for (int qt = st; qt < p.ntiles; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();                            // Rs (dS_out, Ys, Ws), Ms free
    load_rows(Ms, ldn, cm + q0 * p.scs, p.scs, min(kTile, Q - q0), N);
    load_rows(Ys, ldp, dy + q0 * p.sgs, p.sgs, min(kTile, Q - q0), P);
    for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
      const int r = e / kTile, cc = e % kTile;
      const int q = q0 + r, s = s0 + cc;
      Ws[r * ldw + cc] = (q < Q && s <= q) ? gram[static_cast<long long>(q) * Q + s] : 0.f;
    }
    __syncthreads();
    float d[kMT][kMT], gl[kMT][kMT];            // (s = ty + 16 i, q = tx + 16 j)
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kMT; ++j) d[i][j] = 0.f;
    for (int pp = 0; pp < P; ++pp) {
      float xv[kMT], yv[kMT];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        xv[i] = Xs[(ty + 16 * i) * ldp + pp];
        yv[i] = Ys[(tx + 16 * i) * ldp + pp];
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kMT; ++j) d[i][j] = fmaf(xv[i], yv[j], d[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kMT; ++j) {
        const int s = s0 + ty + 16 * i, q = q0 + tx + 16 * j;
        float g = 0.f, dl = 0.f;
        if (q < Q && s <= q) {                  // causal: only s <= q
          const float l = expf(cum[q] - cum[s]);
          g = Ws[(tx + 16 * j) * ldw + ty + 16 * i] * l;
          dl = d[i][j] * l;
          col[i] = fmaf(g, d[i][j], col[i]);
        }
        gl[i][j] = g;
        d[i][j] = dl;
      }
    __syncthreads();                            // G read
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kMT; ++j) Ws[(tx + 16 * j) * ldw + ty + 16 * i] = gl[i][j];
    __syncthreads();
    for (int qq = 0; qq < kTile; ++qq) {        // dx_s += sum_q (G o L)_qs dy_q
      float wv[kMT], yv[kMP];
#pragma unroll
      for (int i = 0; i < kMT; ++i) wv[i] = Ws[qq * ldw + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kMP; ++j) yv[j] = j < PB ? Ys[qq * ldp + tx + 16 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kMP; ++j) adx[i][j] = fmaf(wv[i], yv[j], adx[i][j]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kMT; ++j) Ws[(tx + 16 * j) * ldw + ty + 16 * i] = d[i][j];
    __syncthreads();
    for (int qq = 0; qq < kTile; ++qq) {        // dB_s += sum_q (D o L)_qs C_q
      float wv[kMT], cv[kMN];
#pragma unroll
      for (int i = 0; i < kMT; ++i) wv[i] = Ws[qq * ldw + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kMN; ++j) cv[j] = j < NB ? Ms[qq * ldn + tx + 16 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kMN; ++j) adb[i][j] = fmaf(wv[i], cv[j], adb[i][j]);
    }
  }

  T* dx = static_cast<T*>(p.dx);
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    const float cs = row_sum16(col[i]), v = row_sum16(vacc[i]);
    const int s = s0 + ty + 16 * i;
    if (s >= Q) continue;
    const long long pos = row0 + s;
    if (tx == 0) {
      p.cp[bh * p.S + pos] = cs + v;
      p.vv[bh * p.S + pos] = v;
    }
    T* dxr = dx + ((b * p.S + pos) * p.H + h) * P;
#pragma unroll
    for (int j = 0; j < kMP; ++j)
      if (j < PB) store_from_f32(dxr + tx + 16 * j, adx[i][j]);
    float* dbr = p.dbh + (bh * p.S + pos) * N;
#pragma unroll
    for (int j = 0; j < kMN; ++j)
      if (j < NB) dbr[tx + 16 * j] = adb[i][j];
  }
}

// -- 6. dB and dC: the per-head partials summed over the heads, in order --
// one thread per (b, s, n)
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_heads_kernel(const Params p) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long per_b = static_cast<long long>(p.S) * p.N;
  if (e >= p.B * per_b) return;
  const long long b = e / per_b, sn = e % per_b;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < p.H; ++h) {
    const long long off = (b * p.H + h) * per_b + sn;
    sb += p.dbh[off];
    sc += p.dch[off];
  }
  store_from_f32(static_cast<T*>(p.dbm) + e, sb);
  store_from_f32(static_cast<T*>(p.dcm) + e, sc);
}

// -- 7. da: dcum and its reverse cumsum within the chunk -------------------
// grid (nc, H, B)
__global__ void __launch_bounds__(kThreads) ssd_bwd_da_kernel(const Params p) {
  extern __shared__ float smem[];
  __shared__ float wsum[kWarps];
  const int Q = p.Q;
  float* v = smem;                              // Q, reversed: v[Q-1-t] = dcum_t
  const int c = blockIdx.x, h = blockIdx.y;
  const long long b = blockIdx.z, bh = b * p.H + h;
  const long long base = bh * p.S + static_cast<long long>(c) * Q;
  float part = 0.f;
  for (int t = threadIdx.x; t < Q; t += kThreads) part += p.vv[base + t];
  const float vsum = block_sum(part, wsum);
  const float extra = vsum + expf(p.tot[bh * p.nc + c]) * p.inner[bh * p.nc + c];
  for (int t = threadIdx.x; t < Q; t += kThreads)
    v[Q - 1 - t] = p.rp[base + t] - p.cp[base + t] + (t == Q - 1 ? extra : 0.f);
  __syncthreads();
  block_cumsum(v, Q, wsum);
  for (int t = threadIdx.x; t < Q; t += kThreads)
    p.da[((b * p.S + static_cast<long long>(c) * Q + t) * p.H) + h] = v[Q - 1 - t];
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(bytes))
             : cudaSuccess;
}

template <typename T>
cudaError_t launch_fma(const Params& p, cudaStream_t stream) {
  const int P = p.P, N = p.N, Q = p.Q, nt = p.ntiles;
  const size_t f = sizeof(float);
  const size_t local_smem = f * (2 * size_t(Q) + size_t(kTile) * (P + N));
  const size_t gram_smem = f * 2 * size_t(kTile) * (N + 1);
  const size_t dq_smem = f * dq_smem_floats(P, N, Q);
  const size_t dk_smem = f * dk_smem_floats(P, N, Q);
  const size_t da_smem = f * size_t(Q);
  cudaError_t err;
  if ((err = allow_smem(ssd_bwd_local_kernel<T>, local_smem)) != cudaSuccess ||
      (err = allow_smem(ssd_bwd_gram_kernel<T>, gram_smem)) != cudaSuccess ||
      (err = allow_smem(ssd_bwd_dq_kernel<T>, dq_smem)) != cudaSuccess ||
      (err = allow_smem(ssd_bwd_dk_kernel<T>, dk_smem)) != cudaSuccess ||
      (err = allow_smem(ssd_bwd_da_kernel, da_smem)) != cudaSuccess)
    return err;
  const dim3 per_chunk(p.nc, p.H, p.B), per_tile(p.nc * nt, p.H, p.B);
  ssd_bwd_local_kernel<T><<<per_chunk, kThreads, local_smem, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_gram_kernel<T><<<dim3(nt * nt * p.nc, p.B), kThreads, gram_smem, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_scan_kernel<<<dim3(p.B * p.H, (P * N + kThreads - 1) / kThreads),
                        kThreads, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_dq_kernel<T><<<per_tile, kThreads, dq_smem, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_dk_kernel<T><<<per_tile, kThreads, dk_smem, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long elems = static_cast<long long>(p.B) * p.S * N;
  ssd_bwd_heads_kernel<T><<<static_cast<unsigned>((elems + kThreads - 1) / kThreads),
                            kThreads, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_da_kernel<<<per_chunk, kThreads, da_smem, stream>>>(p);
  return cudaGetLastError();
}


// =========================================================================
// wgmma path: bf16 on the tensor cores
// =========================================================================

constexpr int kFma = 0, kWgmma = 1;             // path ids (the wrapper's)
constexpr int kWg = 128;                        // threads of a warpgroup
constexpr int kPP = 64;                         // P, padded
constexpr int kMaxNt = 4;                       // 64-row tiles a chunk
constexpr int kSlots = 7;                       // dcum's parts a row (w4)
constexpr int kTT = kTile * kTile;              // elements of a 64 x 64 tile

// The wgmma path's workspace, offsets in floats (each part a multiple of 4
// floats, so every bf16 plane starts 16-byte aligned).
struct WgLayout {
  long long cum, tot, inner, wd, sin, dso, mt, total;
};
WgLayout wg_layout(int B, int S, int H, int N, int Q) {
  const long long bh = static_cast<long long>(B) * H, nc = S / Q,
                  nt = Q / kTile, np = N <= 64 ? 64 : 128;
  WgLayout l{};
  long long o = 0;
  auto take = [&o](long long n) { const long long r = o; o += round4(n); return r; };
  l.cum = take(bh * S);
  l.tot = take(bh * nc);
  l.inner = take(bh * nc);
  l.wd = take(kSlots * bh * S);
  l.sin = take(bh * nc * kTile * np);           // hi + lo bf16: a float each
  l.dso = take(bh * nc * kTile * np);
  l.mt = take(static_cast<long long>(B) * nc * nt * nt * kTT);
  l.total = o;
  return l;
}

// The named barrier `id` of one warpgroup's 128 threads.
__device__ __forceinline__ void wg_barrier(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(kWg) : "memory");
}
// Sum over the four lanes of an accumulator row (lane % 4).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}
// A operand (rows 16 warp .., K = the tile's columns 16 kk ..) of a
// swizzled tile stored rows M, columns K; with trans, of one stored rows K,
// columns M.
__device__ __forceinline__ void frag(uint32_t (&r)[4], const bf16* tile,
                                     int warp, int lane, int kk, bool trans) {
  const int mi = lane >> 3;
  if (trans)
    ldmatrix_x4_trans(r, tile + sw_off(16 * kk + (mi >> 1) * 8 + (lane & 7),
                                       16 * warp + (mi & 1) * 8));
  else
    ldmatrix_x4(r, tile + sw_off(16 * warp + (lane & 7) + (mi & 1) * 8,
                                 16 * kk + (mi >> 1) * 8));
}
// B operand descriptors of a swizzled tile: K-major (rows N, K along the
// columns), k-step kd; N-contiguous (rows K), k-step kk, 64-column block hn.
__device__ __forceinline__ uint64_t desc_k(const bf16* t, int kd) {
  return smem_desc_sw128(t + (kd / 4) * kTT + (kd % 4) * 16, 16);
}
__device__ __forceinline__ uint64_t desc_n(const bf16* t, int kk, int hn) {
  return smem_desc_sw128(t + hn * kTT + kk * 16 * 64, kTile * 128);
}
// Two accumulator values of a row as bf16 hi and lo at `hi` and `lo`.
__device__ __forceinline__ void store_split(bf16* hi, bf16* lo, float v0,
                                            float v1) {
  uint32_t h, l;
  split_bf16(v0, v1, h, l);
  *reinterpret_cast<uint32_t*>(hi) = h;
  *reinterpret_cast<uint32_t*>(lo) = l;
}

// -- w1. chunk-start states, chunk-end state gradients ----------------------
// grid (H, B, 2), one warpgroup.  Thread layout of the state (rows p,
// columns n): the wgmma accumulator's.
template <int NP>
size_t states_smem_bytes() {
  return sizeof(bf16) * 2 * size_t(kTile) * (NP + kPP) +
         sizeof(float) * (3 * kTile + 1);
}

template <int NP>
__global__ void __launch_bounds__(kWg, 2) ssd_bwd_wg_states_kernel(const Params p) {
  constexpr int HN = NP / 64;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  bf16* Ms = reinterpret_cast<bf16*>(wg_smem);  // 2 x (64 x NP): B or C
  bf16* Rs = Ms + 2 * kTile * NP;               // 2 x (64 x 64): x or dy
  float* As = reinterpret_cast<float*>(Rs + 2 * kTile * kPP);  // 2 x 64: a
  float* Sc = As + 2 * kTile;                   // 64 row scales, e^l63
  const int dir = blockIdx.z, h = blockIdx.x;
  const long long b = blockIdx.y, bh = b * p.H + h;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int ra = 16 * warp + g, rb = ra + 8;
  const int nsub = p.S / kTile, spc = p.Q / kTile;
  const bf16* rsrc = static_cast<const bf16*>(dir ? p.dy : p.x) +
                     b * (dir ? p.sgb : p.sxb) + h * (dir ? p.sgh : p.sxh);
  const long long rst = dir ? p.sgs : p.sxs;
  const bf16* msrc = static_cast<const bf16*>(dir ? p.cm : p.bm) +
                     b * (dir ? p.scb : p.sbb);
  const long long mst = dir ? p.scs : p.sbs;
  const float* ah = p.a + b * p.sab + h * p.sah;
  bf16* planes = (dir ? p.dso : p.sin) + bh * p.nc * 2 * kTile * NP;

  auto load = [&](int j, int st) {
    load_tile_sw128<NP>(Ms + st * kTile * NP, msrc + j * kTile * mst, mst,
                        p.N, tid, kWg);
    load_tile_sw128<kPP>(Rs + st * kTile * kPP, rsrc + j * kTile * rst, rst,
                         p.P, tid, kWg);
    if (tid < kTile)
      cp_async4(As + st * kTile + tid,
                ah + (static_cast<long long>(j) * kTile + tid) * p.sas, true);
  };

  float acc[NP / 2];
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) acc[i] = 0.f;
  float off = 0.f;                              // forward, warp 0: the chunk's cumsum so far
  load(dir ? nsub - 1 : 0, 0);
  cp_async_commit();
  for (int k = 0; k < nsub; ++k) {
    const int j = dir ? nsub - 1 - k : k, st = k & 1;
    const bf16* Mj = Ms + st * kTile * NP;
    const bf16* Rj = Rs + st * kTile * kPP;
    cp_async_wait<0>();                         // sub-chunk j landed
    fence_proxy_async();
    __syncthreads();
    if (warp == 0) {                            // local cumsum l, inclusive
      const float a0 = As[st * kTile + 2 * lane];
      const float a1 = As[st * kTile + 2 * lane + 1];
      float inc = a0 + a1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(kFull, inc, o);
        if (lane >= o) inc += up;
      }
      const float l0 = inc - a1, l1 = inc, tot = __shfl_sync(kFull, inc, 31);
      if (dir == 0) {
        Sc[2 * lane] = expf(tot - l0);
        Sc[2 * lane + 1] = expf(tot - l1);
        float* cum = p.cum + bh * p.S + static_cast<long long>(j) * kTile;
        cum[2 * lane] = off + l0;
        cum[2 * lane + 1] = off + l1;
        off += tot;
        if (j % spc == spc - 1) {
          if (lane == 0) p.tot[bh * p.nc + j / spc] = off;
          off = 0.f;
        }
      } else {
        Sc[2 * lane] = expf(l0);
        Sc[2 * lane + 1] = expf(l1);
      }
      if (lane == 0) Sc[kTile] = expf(tot);
    }
    __syncthreads();                            // Sc ready; the other stage free
    if (k + 1 < nsub) load(dir ? j - 1 : j + 1, st ^ 1);
    cp_async_commit();
    if (dir ? j % spc == spc - 1 : j % spc == 0) {   // at the chunk's edge
      bf16* hi = planes + static_cast<long long>(j / spc) * 2 * kTile * NP;
#pragma unroll
      for (int hn = 0; hn < HN; ++hn)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int off2 = (u ? rb : ra) * NP + 64 * hn + 8 * i + 2 * t;
            store_split(hi + off2, hi + kTile * NP + off2,
                        acc[32 * hn + 4 * i + 2 * u],
                        acc[32 * hn + 4 * i + 2 * u + 1]);
          }
    }
    // (R o scale)^T, hi and lo: the A operand (rows p, K = the rows of R)
    uint32_t uh[4][4], ul[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t r[4];
      frag(r, Rj, warp, lane, kk, true);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int s = 16 * kk + (c >> 1) * 8 + 2 * t;
        const float2 v = unpack_bf16(r[c]);
        split_bf16(v.x * Sc[s], v.y * Sc[s + 1], uh[kk][c], ul[kk][c]);
      }
    }
    const float e = Sc[kTile];
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) acc[i] *= e;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int hn = 0; hn < HN; ++hn) {
        Wgmma<64, 1>::run(cols64(acc, hn), uh[kk], desc_n(Mj, kk, hn), 1);
        Wgmma<64, 1>::run(cols64(acc, hn), ul[kk], desc_n(Mj, kk, hn), 1);
      }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(uh);
    fence_regs(ul);
  }
}

// -- w2. pairs: dx, M = sum_h D o L, the sums of W ---------------------------
// grid (nt, nc, B), two warpgroups; warpgroup w takes the pairs (qt, st)
// with qt - st = w, w + 2.  Products in the frame of the key tile: rows s
// (the accumulator rows), columns q.
template <int NP>
constexpr size_t pairs_smem_bytes() {
  return sizeof(bf16) * (size_t(kTile) * NP + 2 * 5 * size_t(kTT) +
                         2 * size_t(kTile) * NP) +
         sizeof(float) * (size_t(kMaxNt) * kTT + kTT + 2 * kMaxNt * kTile +
                          2 * 2 * 4 * kTile + kTile);
}

template <int NP>
__global__ void __launch_bounds__(2 * kWg, 1) ssd_bwd_wg_pairs_kernel(const Params p) {
  constexpr int KN = NP / 16;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  bf16* Bst = reinterpret_cast<bf16*>(wg_smem); // 64 x NP: B of the key tile
  bf16* Stg = Bst + kTile * NP;                 // 2 stages of x, 4 dy tiles
  bf16* Dsh = Stg + 2 * 5 * kTT;                // 64 x NP: dS_out hi
  bf16* Dsl = Dsh + kTile * NP;                 //          and lo
  float* Gc = reinterpret_cast<float*>(Dsl + kTile * NP);  // G^T, per thread
  float* Dxp = Gc + kMaxNt * kTT;               // warpgroup 1's dx, per thread
  float* Cum = Dxp + kTT;                       // 2 stages x Q: cum
  float* Red = Cum + 2 * kMaxNt * kTile;        // W's column sums by warp
  float* Csx = Red + 2 * 2 * 4 * kTile;         // warpgroup 1's row sums
  const int st = blockIdx.x, c = blockIdx.y;
  const long long b = blockIdx.z;
  const int Q = p.Q, np = p.ntiles - st;        // pairs: qt = st .. nt - 1
  const int tid = threadIdx.x, w = tid / kWg, wt = tid % kWg;
  const int warp = wt / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int ra = 16 * warp + g, rb = ra + 8;
  const long long row0 = static_cast<long long>(c) * Q;
  const int s0 = st * kTile;
  const long long BHS = static_cast<long long>(p.B) * p.H * p.S;
  const bf16* bm = static_cast<const bf16*>(p.bm) + b * p.sbb + row0 * p.sbs;
  const bf16* cm = static_cast<const bf16*>(p.cm) + b * p.scb + row0 * p.scs;

  // G^T = B C^T of this warpgroup's pairs, once for every head
  load_tile_sw128<NP>(Bst, bm + s0 * p.sbs, p.sbs, p.N, tid, 2 * kWg);
  for (int j = 0; j < np; ++j)
    load_tile_sw128<NP>(Stg + j * kTile * NP, cm + (s0 + j * kTile) * p.scs,
                        p.scs, p.N, tid, 2 * kWg);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  for (int j = w; j < np; j += 2) {
    uint32_t bf[KN][4];
    float gacc[32];
#pragma unroll
    for (int kd = 0; kd < KN; ++kd) frag(bf[kd], Bst, warp, lane, kd, false);
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < KN; ++kd)
      Wgmma<64, 0>::run(gacc, bf[kd], desc_k(Stg + j * kTile * NP, kd), kd);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(gacc);
    fence_regs(bf);
    float4* gc = reinterpret_cast<float4*>(Gc) + j * 8 * kWg + wt;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      gc[i * kWg] = make_float4(gacc[4 * i], gacc[4 * i + 1], gacc[4 * i + 2],
                                gacc[4 * i + 3]);
  }
  __syncthreads();                              // the C tiles read

  auto load_head = [&](int h, int sg) {         // x, dy tiles and cum
    bf16* X = Stg + sg * 5 * kTT;
    load_tile_sw128<kPP>(X, static_cast<const bf16*>(p.x) + b * p.sxb +
                                (row0 + s0) * p.sxs + h * p.sxh,
                         p.sxs, p.P, tid, 2 * kWg);
    const bf16* dy = static_cast<const bf16*>(p.dy) + b * p.sgb +
                     (row0 + s0) * p.sgs + h * p.sgh;
    for (int j = 0; j < np; ++j)
      load_tile_sw128<kPP>(X + (1 + j) * kTT, dy + j * kTile * p.sgs, p.sgs,
                           p.P, tid, 2 * kWg);
    const float* cum = p.cum + (b * p.H + h) * p.S + row0;
    for (int e = tid; e < Q; e += 2 * kWg)
      cp_async4(Cum + sg * kMaxNt * kTile + e, cum + e, true);
  };
  auto load_ds = [&](int h, int i0, int n) {    // dS_out, hi and lo
    const bf16* src = p.dso + ((b * p.H + h) * p.nc + c) * 2 * kTile * NP;
    load_tile_sw128<NP>(Dsh, src, NP, NP, i0, n);
    load_tile_sw128<NP>(Dsl, src + kTile * NP, NP, NP, i0, n);
  };
  load_head(0, 0);
  load_ds(0, tid, 2 * kWg);
  cp_async_commit();

  float macc[2][32];                            // the pairs' M^T, over the heads
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int i = 0; i < 32; ++i) macc[jj][i] = 0.f;
  for (int h = 0; h < p.H; ++h) {
    const int sg = h & 1;
    const bf16* X = Stg + sg * 5 * kTT;
    const float* cum = Cum + sg * kMaxNt * kTile;
    const long long bh = b * p.H + h;
    cp_async_wait<0>();                         // head h landed
    fence_proxy_async();
    __syncthreads();
    if (h + 1 < p.H) load_head(h + 1, sg ^ 1);
    cp_async_commit();
    const float tot = cum[Q - 1];
    const float cs_a = cum[s0 + ra], cs_b = cum[s0 + rb];

    // dx's state term: e^(tot - cum_s) (B_s dS_out^T), and V (warpgroup 0)
    float dxa[32], va = 0.f, vb = 0.f;
    if (w == 0) {
      uint32_t bf[KN][4];
#pragma unroll
      for (int kd = 0; kd < KN; ++kd) frag(bf[kd], Bst, warp, lane, kd, false);
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < KN; ++kd)
        Wgmma<64, 0>::run(dxa, bf[kd], desc_k(Dsh, kd), kd);
#pragma unroll
      for (int kd = 0; kd < KN; ++kd)
        Wgmma<64, 0>::run(dxa, bf[kd], desc_k(Dsl, kd), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dxa);
      fence_regs(bf);
      wg_barrier(1);                            // every warp's products read dS_out
      if (h + 1 < p.H) load_ds(h + 1, wt, kWg);
      cp_async_commit();
      const float da_ = expf(tot - cs_a), db_ = expf(tot - cs_b);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = 8 * i + 2 * t;
        const float2 xa = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(X + sw_off(ra, col)));
        const float2 xb = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(X + sw_off(rb, col)));
        va += xa.x * dxa[4 * i] + xa.y * dxa[4 * i + 1];
        vb += xb.x * dxa[4 * i + 2] + xb.y * dxa[4 * i + 3];
        dxa[4 * i] *= da_;
        dxa[4 * i + 1] *= da_;
        dxa[4 * i + 2] *= db_;
        dxa[4 * i + 3] *= db_;
      }
      va = quad_sum(va) * da_;
      vb = quad_sum(vb) * db_;
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) dxa[i] = 0.f;
    }

    // the pairs: D^T = x dy^T, then L, G o L, D o L and W once each
    float csa = 0.f, csb = 0.f;                 // row sums of W^T: colsum(W)
    uint32_t xf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) frag(xf[kk], X, warp, lane, kk, false);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = w + 2 * jj;
      if (j >= np) break;
      const int q0 = (st + j) * kTile;
      const bf16* Yj = X + (1 + j) * kTT;
      float dacc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<64, 0>::run(dacc, xf[kk], desc_k(Yj, kk), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dacc);
      fence_regs(xf);
      const float4* gc = reinterpret_cast<const float4*>(Gc) + j * 8 * kWg + wt;
      uint32_t ph[4][4];
      float rs[16];                             // W's column sums, own rows
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 gv = gc[i * kWg];
        const float gg[4] = {gv.x, gv.y, gv.z, gv.w};
        float gl[4], wv[4];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int row = cc < 2 ? ra : rb, col = 8 * i + 2 * t + (cc & 1);
          // causal: only q >= s is ever exponentiated
          const float l = (j > 0 || col >= row)
                              ? expf(cum[q0 + col] - (cc < 2 ? cs_a : cs_b))
                              : 0.f;
          const float d = dacc[4 * i + cc];
          gl[cc] = gg[cc] * l;
          wv[cc] = gl[cc] * d;
          macc[jj][4 * i + cc] += d * l;
        }
        csa += wv[0] + wv[1];
        csb += wv[2] + wv[3];
        rs[2 * i] = wv[0] + wv[2];
        rs[2 * i + 1] = wv[1] + wv[3];
        ph[i / 2][(i & 1) * 2] = pack_bf16(gl[0], gl[1]);
        ph[i / 2][(i & 1) * 2 + 1] = pack_bf16(gl[2], gl[3]);
      }
      // dx_s += sum_q (G o L)[q, s] dy_q
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<64, 1>::run(dxa, ph[kk], desc_n(Yj, kk, 0), 1);
      wgmma_commit();
      // rowsum(W) of the query tile, this key tile's part: over the rows
      float* red = Red + (w * 2 + jj) * 4 * kTile;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        float v = rs[k];
        v += __shfl_xor_sync(kFull, v, 4);
        v += __shfl_xor_sync(kFull, v, 8);
        v += __shfl_xor_sync(kFull, v, 16);
        if (g == 0) red[warp * kTile + 8 * (k / 2) + 2 * t + (k & 1)] = v;
      }
      wg_barrier(2 + w);
      if (wt < kTile)
        p.wd[st * BHS + bh * p.S + row0 + q0 + wt] =
            red[wt] + red[kTile + wt] + red[2 * kTile + wt] + red[3 * kTile + wt];
      wgmma_wait<0>();
      fence_regs(dxa);
      fence_regs(ph);
    }

    // dx whole: warpgroup 1's part through shared memory
    csa = quad_sum(csa);
    csb = quad_sum(csb);
    if (w == 1) {
      float4* dp = reinterpret_cast<float4*>(Dxp) + wt;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        dp[i * kWg] = make_float4(dxa[4 * i], dxa[4 * i + 1], dxa[4 * i + 2],
                                  dxa[4 * i + 3]);
      if (t == 0) {
        Csx[ra] = csa;
        Csx[rb] = csb;
      }
    }
    __syncthreads();
    if (w == 0) {
      const float4* dp = reinterpret_cast<const float4*>(Dxp) + wt;
      bf16* dx = static_cast<bf16*>(p.dx) +
                 ((b * p.S + row0 + s0) * p.H + h) * p.P;
      const long long rs_ = static_cast<long long>(p.H) * p.P;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 o = dp[i * kWg];
        const int col = 8 * i + 2 * t;
        if (col < p.P) {
          *reinterpret_cast<__nv_bfloat162*>(dx + ra * rs_ + col) =
              __floats2bfloat162_rn(dxa[4 * i] + o.x, dxa[4 * i + 1] + o.y);
          *reinterpret_cast<__nv_bfloat162*>(dx + rb * rs_ + col) =
              __floats2bfloat162_rn(dxa[4 * i + 2] + o.z, dxa[4 * i + 3] + o.w);
        }
      }
      if (t == 0) {
        float* wr = p.wd + bh * p.S + row0 + s0;
        wr[4 * BHS + ra] = -(csa + Csx[ra]) - va;
        wr[4 * BHS + rb] = -(csb + Csx[rb]) - vb;
        wr[5 * BHS + ra] = va;
        wr[5 * BHS + rb] = vb;
      }
    }
  }

  // M^T of each pair, bf16 hi + lo, rows s
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const int j = w + 2 * jj;
    if (j >= np) break;
    bf16* hi = p.mt +
               (((b * p.nc + c) * p.ntiles + st + j) * p.ntiles + st) * 2 * kTT;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int o = (u ? rb : ra) * kTile + 8 * i + 2 * t;
        store_split(hi + o, hi + kTT + o, macc[jj][4 * i + 2 * u],
                    macc[jj][4 * i + 2 * u + 1]);
      }
  }
}

// -- w3. tiles: dB and dC, summed over the heads ----------------------------
// grid (nt, nc, B), two warpgroups on the tile's 64 rows: 0 dB (rows s), 1
// dC (rows q).
template <int NP>
constexpr size_t tiles_smem_bytes() {
  return sizeof(bf16) * (size_t(kTile) * NP +
                         2 * (2 * size_t(kTT) + 4 * size_t(kTile) * NP)) +
         sizeof(float) * (2 * (kTile + 1) + 8);
}

template <int NP>
__global__ void __launch_bounds__(2 * kWg, 1) ssd_bwd_wg_tiles_kernel(const Params p) {
  constexpr int HN = NP / 64;
  constexpr int SS = 2 * kTT + 4 * kTile * NP;  // a stage, in elements
  constexpr int MR = 2 * kTT + kTile * NP;      // a warpgroup's M-phase share
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  bf16* Ct = reinterpret_cast<bf16*>(wg_smem);  // 64 x NP: C of the tile
  bf16* Stg = Ct + kTile * NP;                  // 2 stages: x, dy, S_in, dS_out
  float* Cum = reinterpret_cast<float*>(Stg + 2 * SS);  // 2 x 65: cum, tot
  float* Red = Cum + 2 * (kTile + 1);           // 8: a block sum's warp parts
  const int tt = blockIdx.x, c = blockIdx.y, nt = p.ntiles;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x, w = tid / kWg, wt = tid % kWg;
  const int warp = wt / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int ra = 16 * warp + g, rb = ra + 8;
  const long long crow = static_cast<long long>(c) * p.Q;   // the chunk's first row
  const long long row0 = crow + tt * kTile;     // the tile's first row
  const long long BHS = static_cast<long long>(p.B) * p.H * p.S;
  const bf16* bm = static_cast<const bf16*>(p.bm) + b * p.sbb;
  const bf16* cm = static_cast<const bf16*>(p.cm) + b * p.scb;

  load_tile_sw128<NP>(Ct, cm + row0 * p.scs, p.scs, p.N, tid, 2 * kWg);
  auto load_head = [&](int h, int sg) {
    bf16* S_ = Stg + sg * SS;
    const long long bh = b * p.H + h;
    load_tile_sw128<kPP>(S_, static_cast<const bf16*>(p.x) + b * p.sxb +
                                 row0 * p.sxs + h * p.sxh,
                         p.sxs, p.P, tid, 2 * kWg);
    load_tile_sw128<kPP>(S_ + kTT, static_cast<const bf16*>(p.dy) + b * p.sgb +
                                       row0 * p.sgs + h * p.sgh,
                         p.sgs, p.P, tid, 2 * kWg);
    const long long pl = (bh * p.nc + c) * 2 * kTile * NP;
#pragma unroll
    for (int k = 0; k < 2; ++k) {               // S_in, then dS_out: hi, lo
      load_tile_sw128<NP>(S_ + 2 * kTT + 2 * k * kTile * NP,
                          (k ? p.dso : p.sin) + pl, NP, NP, tid, 2 * kWg);
      load_tile_sw128<NP>(S_ + 2 * kTT + (2 * k + 1) * kTile * NP,
                          (k ? p.dso : p.sin) + pl + kTile * NP, NP, NP, tid,
                          2 * kWg);
    }
    if (tid < kTile)
      cp_async4(Cum + sg * (kTile + 1) + tid, p.cum + bh * p.S + row0 + tid, true);
    else if (tid == kTile)
      cp_async4(Cum + sg * (kTile + 1) + kTile, p.tot + bh * p.nc + c, true);
  };
  load_head(0, 0);
  cp_async_commit();

  float acc[NP / 2];                            // dB (warpgroup 0) or dC (1)
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) acc[i] = 0.f;
  for (int h = 0; h < p.H; ++h) {
    const int sg = h & 1;
    const bf16* S_ = Stg + sg * SS;
    const bf16* SIh = S_ + 2 * kTT;
    const bf16* SOh = SIh + 2 * kTile * NP;
    const float* cum = Cum + sg * (kTile + 1);
    const long long bh = b * p.H + h;
    cp_async_wait<0>();                         // head h landed
    fence_proxy_async();
    __syncthreads();
    if (h + 1 < p.H) load_head(h + 1, sg ^ 1);
    cp_async_commit();
    // 0: x dS_out scaled by e^(tot - cum_s); 1: dy S_in scaled by e^cum_q
    const bf16* A = w ? S_ + kTT : S_;
    const bf16* Sh = w ? SIh : SOh;
    uint32_t af[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) frag(af[kk], A, warp, lane, kk, false);
    float tmp[NP / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int hn = 0; hn < HN; ++hn)
        Wgmma<64, 1>::run(cols64(tmp, hn), af[kk], desc_n(Sh, kk, hn), kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int hn = 0; hn < HN; ++hn)
        Wgmma<64, 1>::run(cols64(tmp, hn), af[kk],
                          desc_n(Sh + kTile * NP, kk, hn), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(tmp);
    fence_regs(af);
    const float tot = cum[kTile];
    const float sa = expf(w ? cum[ra] : tot - cum[ra]);
    const float sb = expf(w ? cum[rb] : tot - cum[rb]);
    float pa = 0.f, pb = 0.f;                   // dy_q . (S_in C_q)
#pragma unroll
    for (int hn = 0; hn < HN; ++hn)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int e = 32 * hn + 4 * i + 2 * u, row = u ? rb : ra;
          const float s_ = u ? sb : sa;
          acc[e] = fmaf(s_, tmp[e], acc[e]);
          acc[e + 1] = fmaf(s_, tmp[e + 1], acc[e + 1]);
          if (w == 1) {
            const float2 cv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(
                    Ct + sw_off(row, 64 * hn + 8 * i + 2 * t)));
            const float part = tmp[e] * cv.x + tmp[e + 1] * cv.y;
            if (u) pb += part; else pa += part;
          }
        }
    if (w == 1) {
      pa = quad_sum(pa) * sa;
      pb = quad_sum(pb) * sb;
      if (t == 0) {
        float* wr = p.wd + 6 * BHS + bh * p.S + row0;
        wr[ra] = pa;
        wr[rb] = pb;
      }
    }
    if (tt == 0) {                              // <dS_out, S_in> of (b, h, c)
      float part = 0.f;
      for (int e = tid; e < kTile * NP; e += 2 * kWg) {
        const float si = __bfloat162float(SIh[e]) +
                         __bfloat162float(SIh[kTile * NP + e]);
        const float so = __bfloat162float(SOh[e]) +
                         __bfloat162float(SOh[kTile * NP + e]);
        part = fmaf(si, so, part);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(kFull, part, o);
      if (lane == 0) Red[tid / 32] = part;
      __syncthreads();
      if (tid == 0) {
        float s_ = 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k) s_ += Red[k];
        p.inner[bh * p.nc + c] = s_;
      }
    }
  }

  // dB += sum_{qt >= tt} M(qt, tt)^T C(qt); dC += sum_{st <= tt} M(tt, st) B(st)
  __syncthreads();                              // every stage free
  const int R = max(nt - tt, tt + 1);
  auto load_round = [&](int r, int sg) {
    bf16* dst = Stg + sg * SS + w * MR;
    const int k = w ? tt - r : tt + r;          // the pair's other tile
    if (k < 0 || k >= nt) return;
    const bf16* m = p.mt + (((b * p.nc + c) * nt + (w ? tt : k)) * nt +
                            (w ? k : tt)) * 2 * kTT;
    load_tile_sw128<kPP>(dst, m, kTile, kTile, wt, kWg);
    load_tile_sw128<kPP>(dst + kTT, m + kTT, kTile, kTile, wt, kWg);
    load_tile_sw128<NP>(dst + 2 * kTT,
                        w ? bm + (crow + k * kTile) * p.sbs
                          : cm + (crow + k * kTile) * p.scs,
                        w ? p.sbs : p.scs, p.N, wt, kWg);
  };
  load_round(0, 0);
  cp_async_commit();
  for (int r = 0; r < R; ++r) {
    const int sg = r & 1, k = w ? tt - r : tt + r;
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (r + 1 < R) load_round(r + 1, sg ^ 1);
    cp_async_commit();
    if (k < 0 || k >= nt) continue;
    const bf16* M_ = Stg + sg * SS + w * MR;
    uint32_t mh[4][4], ml[4][4];                // M^T (rows s) or M (rows q)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      frag(mh[kk], M_, warp, lane, kk, w == 1);
      frag(ml[kk], M_ + kTT, warp, lane, kk, w == 1);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int hn = 0; hn < HN; ++hn) {
        Wgmma<64, 1>::run(cols64(acc, hn), mh[kk], desc_n(M_ + 2 * kTT, kk, hn), 1);
        Wgmma<64, 1>::run(cols64(acc, hn), ml[kk], desc_n(M_ + 2 * kTT, kk, hn), 1);
      }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(mh);
    fence_regs(ml);
  }
  bf16* out = static_cast<bf16*>(w ? p.dcm : p.dbm) + (b * p.S + row0) * p.N;
#pragma unroll
  for (int hn = 0; hn < HN; ++hn)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = 64 * hn + 8 * i + 2 * t;
      if (col >= p.N) continue;
#pragma unroll
      for (int u = 0; u < 2; ++u)
        *reinterpret_cast<__nv_bfloat162*>(out + (u ? rb : ra) * p.N + col) =
            __floats2bfloat162_rn(acc[32 * hn + 4 * i + 2 * u],
                                  acc[32 * hn + 4 * i + 2 * u + 1]);
    }
}

// -- w4. da: dcum from its parts, and its reverse cumsum --------------------
// grid (nc, H, B).  wd's slots, per row r of the chunk: 0-3 rowsum(W) from
// key tile 0-3 (those at or before r's tile), 4 -colsum(W) - V, 5 V, 6
// e^cum dy . (S_in C); at r = Q-1 also sum V + e^tot <dS_out, S_in>.
__global__ void __launch_bounds__(kThreads) ssd_bwd_wg_da_kernel(const Params p) {
  extern __shared__ float smem[];
  __shared__ float wsum[kWarps];
  const int Q = p.Q;
  float* v = smem;                              // Q, reversed: v[Q-1-t] = dcum_t
  const int c = blockIdx.x, h = blockIdx.y;
  const long long b = blockIdx.z, bh = b * p.H + h;
  const long long BHS = static_cast<long long>(p.B) * p.H * p.S;
  const float* wd = p.wd + bh * p.S + static_cast<long long>(c) * Q;
  float part = 0.f;
  for (int t = threadIdx.x; t < Q; t += kThreads) part += wd[5 * BHS + t];
  const float vsum = block_sum(part, wsum);
  const float extra = vsum + expf(p.tot[bh * p.nc + c]) * p.inner[bh * p.nc + c];
  for (int t = threadIdx.x; t < Q; t += kThreads) {
    float d = 0.f;
    for (int k = 0; k <= t / kTile; ++k) d += wd[k * BHS + t];
    v[Q - 1 - t] = d + wd[4 * BHS + t] + wd[6 * BHS + t] +
                   (t == Q - 1 ? extra : 0.f);
  }
  __syncthreads();
  block_cumsum(v, Q, wsum);
  for (int t = threadIdx.x; t < Q; t += kThreads)
    p.da[((b * p.S + static_cast<long long>(c) * Q + t) * p.H) + h] = v[Q - 1 - t];
}

template <int NP>
cudaError_t launch_wgmma_n(const Params& p, cudaStream_t stream) {
  const size_t st_smem = states_smem_bytes<NP>();
  const size_t pr_smem = pairs_smem_bytes<NP>();
  const size_t tl_smem = tiles_smem_bytes<NP>();
  const size_t da_smem = sizeof(float) * size_t(p.Q);
  cudaError_t err;
  if ((err = allow_smem(ssd_bwd_wg_states_kernel<NP>, st_smem)) != cudaSuccess ||
      (err = allow_smem(ssd_bwd_wg_pairs_kernel<NP>, pr_smem)) != cudaSuccess ||
      (err = allow_smem(ssd_bwd_wg_tiles_kernel<NP>, tl_smem)) != cudaSuccess ||
      (err = allow_smem(ssd_bwd_wg_da_kernel, da_smem)) != cudaSuccess)
    return err;
  ssd_bwd_wg_states_kernel<NP><<<dim3(p.H, p.B, 2), kWg, st_smem, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 tiles(p.ntiles, p.nc, p.B);
  ssd_bwd_wg_pairs_kernel<NP><<<tiles, 2 * kWg, pr_smem, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_wg_tiles_kernel<NP><<<tiles, 2 * kWg, tl_smem, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_wg_da_kernel<<<dim3(p.nc, p.H, p.B), kThreads, da_smem, stream>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// What the wgmma path needs beyond the common limits: bf16, chunks of one
// to four whole 64-row tiles, and 16-byte aligned rows of x, B, C and dy.
bool wgmma_takes(const Params& p, int dtype) {
  bool ok = dtype == 1 && p.Q % kTile == 0 && p.Q <= kMaxNt * kTile &&
            aligned16(p.x) && aligned16(p.bm) && aligned16(p.cm) &&
            aligned16(p.dy);
  for (long long s : {p.sxb, p.sxs, p.sxh, p.sbb, p.sbs, p.scb, p.scs, p.sgb,
                      p.sgs, p.sgh})
    ok = ok && s % 8 == 0;
  return ok;
}

// Floats of workspace a call on `path` needs; -1 for an unknown path.
long long workspace_floats(int path, int B, int S, int H, int P, int N,
                           int Q) {
  if (path == kFma) return fma_workspace_floats(B, S, H, P, N, Q);
  if (path == kWgmma) return wg_layout(B, S, H, N, Q).total;
  return -1;
}

}  // namespace

// path: 0 = fma, 1 = wgmma (the wrapper's choice).  dtype (of x, B, C, dy,
// dx, dB and dC): 0 = float32, 1 = bfloat16; a and da are float32.  Takes
// what the forward takes: P and N multiples of 16, at most 64 and 128; S %
// Q == 0 (and Q at most 4096); B, H and the chunk count at most 65535; the
// wgmma path also bf16, Q a multiple of 64 up to 256 and 16-byte aligned
// rows.  Inputs by strides with a contiguous last dim; outputs contiguous.
// ws holds ws_floats floats, at least ssd_scan_bwd_workspace_floats(path,
// ...).  Returns a cudaError_t (0 = launched); a call it cannot take is
// cudaErrorInvalidValue.
extern "C" int ssd_scan_bwd(
    const void* x, const float* a, const void* bm, const void* cm,
    const void* dy, void* dx, float* da, void* dbm, void* dcm, float* ws,
    long long ws_floats, int path, int dtype, int B, int S, int H, int P,
    int N, int Q, long long sxb, long long sxs, long long sxh, long long sab,
    long long sas, long long sah, long long sbb, long long sbs, long long scb,
    long long scs, long long sgb, long long sgs, long long sgh,
    void* stream) {
  if (B < 0 || B > 65535 || H < 0 || H > 65535 || S < 0 ||
      Q <= 0 || Q > kMaxQ || S % Q != 0 || S / Q > 65535 || P <= 0 ||
      P > kMaxP || P % 16 != 0 || N <= 0 || N > kMaxN || N % 16 != 0 ||
      (dtype != 0 && dtype != 1) || (path != kFma && path != kWgmma))
    return static_cast<int>(cudaErrorInvalidValue);
  if (ws_floats < workspace_floats(path, B, S, H, P, N, Q))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = S / Q, nt = (Q + kTile - 1) / kTile;
  const long long bh = static_cast<long long>(B) * H;
  Params p{x, a, bm, cm, dy, dx, da, dbm, dcm, B, S, H, P, N, Q, nc, nt,
           sxb, sxs, sxh, sab, sas, sah, sbb, sbs, scb, scs, sgb, sgs, sgh};
  if (path == kWgmma && !wgmma_takes(p, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == kWgmma) {
    const WgLayout l = wg_layout(B, S, H, N, Q);
    p.cum = ws + l.cum;
    p.tot = ws + l.tot;
    p.inner = ws + l.inner;
    p.wd = ws + l.wd;
    p.sin = reinterpret_cast<bf16*>(ws + l.sin);
    p.dso = reinterpret_cast<bf16*>(ws + l.dso);
    p.mt = reinterpret_cast<bf16*>(ws + l.mt);
    return static_cast<int>(N <= 64 ? launch_wgmma_n<64>(p, s)
                                    : launch_wgmma_n<128>(p, s));
  }
  float* w = ws;
  auto take = [&w](long long n) { float* r = w; w += round4(n); return r; };
  p.cum = take(bh * S);
  p.rp = take(bh * S);
  p.cp = take(bh * S);
  p.vv = take(bh * S);
  p.tot = take(bh * nc);
  p.inner = take(bh * nc);
  p.st = take(bh * nc * P * N);
  p.ds = take(bh * nc * P * N);
  p.gram = take(static_cast<long long>(B) * nc * Q * Q);
  p.dbh = take(bh * S * N);
  p.dch = take(bh * S * N);
  return static_cast<int>(dtype == 0 ? launch_fma<float>(p, s)
                                     : launch_fma<bf16>(p, s));
}

// The fp32 workspace ssd_scan_bwd needs on `path` for these shapes (the
// wrapper allocates it); 0 for an unknown path, a chunk that is not
// positive or a negative size.
extern "C" long long ssd_scan_bwd_workspace_floats(int path, int B, int S,
                                                   int H, int P, int N,
                                                   int Q) {
  if (B < 0 || H < 0 || S < 0 || P < 0 || N < 0 || Q <= 0) return 0;
  const long long n = workspace_floats(path, B, S, H, P, N, Q);
  return n < 0 ? 0 : n;
}
