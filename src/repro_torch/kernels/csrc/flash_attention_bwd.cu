// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// The gradient of K1 (flash_attention.cu), for training.  The JAX package
// has no Pallas backward: it differentiates the pure-jnp chunked_attention
// (src/repro/models/attention.py) through XLA under jax.checkpoint.  In the
// port, attention on the card is K1, so its gradient is this kernel.
//
// Contract: the forward's.  q (B, H, Sq, D), k / v (B, Hkv, Sk, D), o and dO
// (B, H, Sq, D), any strides with a contiguous last dim and 16-byte rows;
// GQA (query head h reads KV head h / (H / Hkv)); scale D^-0.5; optional
// top-left causal mask (query i sees keys j <= i) and sliding window
// (i - j < window); head dims 16, 32, 64, 80, 128; fp32 or bf16 inputs and
// outputs.  The forward saves lse = m + log(l), the row log-sum-exp of the
// scaled scores, (B, H, Sq) fp32; from it P is recomputed exactly:
//
//   P = exp(S - lse) on the valid keys, 0 elsewhere (S = Q K^T D^-0.5)
//   dV = P^T dO,  dS = P o (dO V^T - delta),  delta = rowsum(dO o O)
//   dQ = dS K D^-0.5,  dK = dS^T Q D^-0.5,
//
// dK and dV summed over the G query heads of each KV head.  A row with no
// valid key has P = 0 and so zero gradients.  There is no kv_len: the
// backward is for training, whose every key is valid.
//
// Three launches on either path, deterministic (no floating-point atomics:
// two runs agree bit for bit):
//  (a) delta: a few lanes per query row (16 bytes each), fp32.
//  (b) dK, dV per (batch, KV head, block of key tiles): each 64-key tile
//      stays in shared memory while the CTA walks the G query heads and,
//      for each, the 64-row query tiles the mask lets see its keys, summing
//      their contributions in registers: the GQA sum stays in the CTA.
//  (c) dQ per (batch, head, block of 64-row query tiles), walking the key
//      tiles its rows may see.
// Both tile kernels recompute S and dP = dO V^T for a (query tile, key
// tile) pair; (b) and (c) together do 7 tile products for the 5 of the
// algorithm.  A single pass with dQ summed across key tiles would need
// atomics (or an ordered hand-off between CTAs) and would lose the
// bit-equal reruns, so the two passes stay.  Tile pairs outside the mask's
// reach are never visited; the heaviest CTAs (the first key blocks of (b),
// the last query blocks of (c) under a causal mask) start first.
//
// One entry point, two device paths.  The wrapper chooses the path from the
// dtype and passes it in; the entry point refuses a path whose kernels
// cannot take the call (cudaErrorInvalidValue):
//
// * wgmma (bf16).  What bounds it: at the training shape (B=8, H=32,
//   Hkv=8, S=4096, D=64, causal) the algorithm's 5 products are 1.4e12
//   flop against 0.67 GB of inputs and outputs, ~2,000 flop per byte, far
//   above the card's ~295 balance point: operations, 1.39 ms at the bf16
//   tensor rate (7 products done: 1.9e12 flop).  So every tile product runs
//   on the tensor cores, wgmma with bf16 operands and fp32 accumulators, a
//   warpgroup (128 threads) holding the 64 rows of its tile:
//   - (b): S^T = K Q^T and dP^T = V dO^T (m64n64k16, A = the warpgroup's
//     K or V tile and B = the streamed Q or dO tile, both from shared
//     memory, K-contiguous); P^T = exp(S^T D^-0.5 - lse) on the valid pairs
//     and dS^T = P^T o (dP^T - delta) in registers; then dV += P^T dO and
//     dK += dS^T Q (m64nDk16, A = P^T or dS^T rounded to bf16 in registers
//     as the forward rounds P, B = dO or Q N-contiguous from shared memory).
//   - (c): S = Q K^T, dP = dO V^T and dQ += dS K in the same forms, Q and
//     dO resident, K and V streamed.
//   What holds it back is not the products: they run at about a third of
//   the tensor rate.  The first version (one warpgroup per CTA, three
//   CTAs an SM) re-read every streamed tile once per 64 rows, ~17 GB from
//   L2 a call at the training shape, and timed within a few per cent the
//   same with the products or the elementwise steps taken out, which
//   points at the stream.  So a CTA holds as many warpgroups as an SM's
//   registers allow (kDkvWGs, kDqWGs: 2-3, one CTA an SM), each with its
//   own 64 keys or query rows, and they share each streamed tile: a third
//   of the L2 traffic.  The tiles come through a 3-slot cp.async ring, two
//   items ahead, one CTA barrier an item, stored as 8-row x 16-byte core
//   matrices (each warp writes 512 contiguous bytes): the layout wgmma
//   reads without a swizzle, K-contiguous for the score products and, the
//   same bytes, N-contiguous for the gradient products.  Only tile pairs
//   that cross the diagonal, the window's edge or a ragged end are masked
//   per element.
//   Rounding: P and dS once each to bf16 before their products; S, dP, P,
//   dS and every sum fp32 in tile order; outputs rounded once.
//   kernels/bwd_rounding.py models exactly this on the CPU: at S = 4096 it
//   keeps dq, dk, dv within a third of the bf16 tolerance (2e-2), so dS
//   needs no hi + lo split.
// * fma (fp32): the first version of this kernel, kept for fp32 inputs:
//   fp32 FMAs (never TF32, so fp32 is held to 1e-4); tiles in shared memory
//   as fp32 rows padded so that 16-byte vector reads fall in distinct bank
//   groups; each of 256 threads holds a 4 x 4 block of the 64 x 64 score
//   tile.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;                       // query rows / keys a tile
constexpr int kThreads = 256;                   // fma path, delta
constexpr int kPS = kTile + 1;                  // padded P / dS row
constexpr int kWgThreads = 128;                 // wgmma path: a warpgroup
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kWgThreads == 2 * kTile, "a thread per lse or delta row");

enum Path { kFma = 0, kWgmma = 1 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;                             // (B, H, Sq)
  float* delta;                                 // (B, H, Sq)
  void* dq;
  void* dk;
  void* dv;
  int B, H, Hkv, Sq, Sk, causal, window;
  // strides in elements (b, head, row) of q, k, v, o, dO, dq, dk, dv
  long long st[8][3];
  float scale;
};
enum { kQ = 0, kK, kV, kO, kDO, kDQ, kDK, kDV };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ bool valid(const Params& p, int i, int j) {
  return i < p.Sq && j < p.Sk && (!p.causal || j <= i) &&
         (!p.window || i - j < p.window);
}

// The query tiles whose rows see some key of [j0, j0 + 64): [*qt0, *qt1).
__device__ __forceinline__ void query_tiles(const Params& p, int j0,
                                            int* qt0, int* qt1) {
  const int nqt = (p.Sq + kTile - 1) / kTile;
  *qt0 = p.causal ? j0 / kTile : 0;
  *qt1 = p.window ? min(nqt, (j0 + kTile - 1 + p.window - 1) / kTile + 1)
                  : nqt;
}

// The keys some row of [i0, i0 + 64) sees: [*lo, *hi).
__device__ __forceinline__ void key_span(const Params& p, int i0, int* lo,
                                         int* hi) {
  const int i_last = min(i0 + kTile, p.Sq) - 1;
  *lo = p.window ? max(0, i0 - p.window + 1) : 0;
  *hi = p.causal ? min(p.Sk, i_last + 1) : p.Sk;
}

// (a) delta = rowsum(dO o O), fp32: a group of L lanes per (b, h, i) row,
// lane l reading the row's l-th 16 bytes of O and dO.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads) attn_bwd_delta_kernel(
    const Params p) {
  constexpr int VEC = 16 / sizeof(T), CPR = D / VEC;   // 16-byte chunks
  constexpr int L = CPR <= 4 ? 4 : CPR <= 8 ? 8 : CPR <= 16 ? 16 : 32;
  static_assert(CPR <= 32, "a row's chunks fit one warp");
  const int l = threadIdx.x % L;
  const long long row = blockIdx.x * (long long)(kThreads / L) +
                        threadIdx.x / L;
  const bool live = row < (long long)p.B * p.H * p.Sq;
  float acc = 0.f;
  if (live && l < CPR) {
    const int i = row % p.Sq;
    const int h = (row / p.Sq) % p.H;
    const long long b = row / ((long long)p.Sq * p.H);
    const uint4 ov = *reinterpret_cast<const uint4*>(
        static_cast<const T*>(p.o) + b * p.st[kO][0] + h * p.st[kO][1] +
        i * p.st[kO][2] + l * VEC);
    const uint4 dv = *reinterpret_cast<const uint4*>(
        static_cast<const T*>(p.dout) + b * p.st[kDO][0] +
        h * p.st[kDO][1] + i * p.st[kDO][2] + l * VEC);
    const T* ot = reinterpret_cast<const T*>(&ov);
    const T* dt = reinterpret_cast<const T*>(&dv);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      acc = fmaf(to_f32(ot[e]), to_f32(dt[e]), acc);
  }
#pragma unroll
  for (int s = L / 2; s > 0; s >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (live && l == 0) p.delta[row] = acc;
}

// =========================================================================
// fma path: fp32 FMAs (the first version of this kernel)
// =========================================================================

// Rows [row0, row0 + 64) of one head (base, row stride rs) into dst with
// row stride RS = D + 4; rows at or past n read as zeros.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* base,
                                          long long rs, int row0, int n) {
  constexpr int RS = D + 4;
  constexpr int CPR = D / 4;                    // 16-byte chunks per row
  for (int e = threadIdx.x; e < kTile * CPR; e += kThreads) {
    const int r = e / CPR, c = (e % CPR) * 4;
    const float4 x = row0 + r < n
        ? *reinterpret_cast<const float4*>(base + (row0 + r) * rs + c)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * RS + c) = x;
  }
}

// acc[a][c] += sum_d X[ty + 16 a][d] Y[tx + 16 c][d] over 16-byte vectors
// of padded fp32 rows (RS = D + 4: the 16 column threads' vectors fall in
// distinct bank groups; the row reads are broadcasts).
template <int D>
__device__ __forceinline__ void tile_dot(const float* X, const float* Y,
                                         int ty, int tx, float (&acc)[4][4]) {
  constexpr int RS = D + 4;
  for (int d = 0; d < D; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      x[a] = *reinterpret_cast<const float4*>(X + (ty + 16 * a) * RS + d);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      y[c] = *reinterpret_cast<const float4*>(Y + (tx + 16 * c) * RS + d);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[a][c] = fmaf(x[a].x, y[c].x, acc[a][c]);
        acc[a][c] = fmaf(x[a].y, y[c].y, acc[a][c]);
        acc[a][c] = fmaf(x[a].z, y[c].z, acc[a][c]);
        acc[a][c] = fmaf(x[a].w, y[c].w, acc[a][c]);
      }
  }
}

// The score step for one (query tile, key tile): this thread's 4 x 4 block
// (rows ty + 16 a of Qs / dOs, keys tx + 16 c of Ks / Vs) of S = Q K^T and
// dP = dO V^T, then P = exp(S D^-0.5 - lse) on the valid pairs and
// dS = P (dP - delta).  lse_s / delta_s: the query tile's rows.
template <int D>
__device__ __forceinline__ void score_tile(
    const Params& p, const float* Qs, const float* dOs, const float* Ks,
    const float* Vs, const float* lse_s, const float* delta_s, int i0,
    int j0, float (&P)[4][4], float (&dS)[4][4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.f;
  // S, then dP: one pair of operands live at a time (registers)
  tile_dot<D>(Qs, Ks, ty, tx, s);
  tile_dot<D>(dOs, Vs, ty, tx, dp);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float pv = valid(p, i0 + r, j0 + tx + 16 * c)
                           ? expf(fmaf(s[a][c], p.scale, -lse_s[r])) : 0.f;
      P[a][c] = pv;
      dS[a][c] = pv * (dp[a][c] - delta_s[r]);
    }
  }
}

template <int D>
constexpr size_t dkv_smem_bytes() {     // K, V, Q, dO; P, dS; lse, delta
  return sizeof(float) * (4 * size_t(kTile) * (D + 4) +
                          2 * size_t(kTile) * kPS + 2 * kTile);
}

// (b) dK, dV for one (batch, KV head, key tile).
template <int D>
__global__ void __launch_bounds__(kThreads) attn_bwd_dkv_kernel(
    const Params p) {
  constexpr int RS = D + 4, DT = D / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + kTile * RS;
  float* Qs = Vs + kTile * RS;
  float* dOs = Qs + kTile * RS;
  float* Ps = dOs + kTile * RS;
  float* dSs = Ps + kTile * kPS;
  float* lse_s = dSs + kTile * kPS;
  float* delta_s = lse_s + kTile;

  const int j0 = blockIdx.x * kTile, kvh = blockIdx.y;
  const long long b = blockIdx.z;
  const int G = p.H / p.Hkv;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* q = static_cast<const float*>(p.q);
  const float* dout = static_cast<const float*>(p.dout);

  load_tile<D>(Ks, static_cast<const float*>(p.k) + b * p.st[kK][0] +
                       kvh * p.st[kK][1], p.st[kK][2], j0, p.Sk);
  load_tile<D>(Vs, static_cast<const float*>(p.v) + b * p.st[kV][0] +
                       kvh * p.st[kV][1], p.st[kV][2], j0, p.Sk);
  int qt0, qt1;
  query_tiles(p, j0, &qt0, &qt1);

  float dk[4][DT], dv[4][DT];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int t = 0; t < DT; ++t) dk[a][t] = dv[a][t] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const float* qh = q + b * p.st[kQ][0] + h * p.st[kQ][1];
    const float* doh = dout + b * p.st[kDO][0] + h * p.st[kDO][1];
    const long long lrow = (b * p.H + h) * (long long)p.Sq;
    for (int qt = qt0; qt < qt1; ++qt) {
      const int i0 = qt * kTile;
      __syncthreads();                          // the last tile is consumed
      load_tile<D>(Qs, qh, p.st[kQ][2], i0, p.Sq);
      load_tile<D>(dOs, doh, p.st[kDO][2], i0, p.Sq);
      for (int r = threadIdx.x; r < kTile; r += kThreads) {
        const bool ok = i0 + r < p.Sq;
        lse_s[r] = ok ? p.lse[lrow + i0 + r] : 0.f;
        delta_s[r] = ok ? p.delta[lrow + i0 + r] : 0.f;
      }
      __syncthreads();
      float P[4][4], dS[4][4];
      score_tile<D>(p, Qs, dOs, Ks, Vs, lse_s, delta_s, i0, j0, P, dS);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          Ps[(ty + 16 * a) * kPS + tx + 16 * c] = P[a][c];
          dSs[(ty + 16 * a) * kPS + tx + 16 * c] = dS[a][c];
        }
      __syncthreads();
      // dV[j] += sum_i P[i][j] dO[i];  dK[j] += sum_i dS[i][j] Q[i]
      const int rows = min(kTile, p.Sq - i0);
      for (int i = 0; i < rows; ++i) {
        float pa[4], sa[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pa[a] = Ps[i * kPS + ty + 16 * a];
          sa[a] = dSs[i * kPS + ty + 16 * a];
        }
#pragma unroll
        for (int t = 0; t < DT; ++t) {
          const float ov = dOs[i * RS + tx + 16 * t];
          const float qv = Qs[i * RS + tx + 16 * t];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            dv[a][t] = fmaf(pa[a], ov, dv[a][t]);
            dk[a][t] = fmaf(sa[a], qv, dk[a][t]);
          }
        }
      }
    }
  }

  float* dkp = static_cast<float*>(p.dk) + b * p.st[kDK][0] +
               kvh * p.st[kDK][1];
  float* dvp = static_cast<float*>(p.dv) + b * p.st[kDV][0] +
               kvh * p.st[kDV][1];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = j0 + ty + 16 * a;
    if (j >= p.Sk) continue;
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      dkp[j * p.st[kDK][2] + tx + 16 * t] = dk[a][t] * p.scale;
      dvp[j * p.st[kDV][2] + tx + 16 * t] = dv[a][t];
    }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {              // Q, dO, K, V; dS; lse, delta
  return sizeof(float) * (4 * size_t(kTile) * (D + 4) +
                          size_t(kTile) * kPS + 2 * kTile);
}

// (c) dQ for one (batch, head, query tile).
template <int D>
__global__ void __launch_bounds__(kThreads) attn_bwd_dq_kernel(
    const Params p) {
  constexpr int RS = D + 4, DT = D / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + kTile * RS;
  float* Ks = dOs + kTile * RS;
  float* Vs = Ks + kTile * RS;
  float* dSs = Vs + kTile * RS;
  float* lse_s = dSs + kTile * kPS;
  float* delta_s = lse_s + kTile;

  // The heaviest query tiles (the last, under a causal mask) start first.
  const int i0 = (gridDim.x - 1 - blockIdx.x) * kTile, h = blockIdx.y;
  const long long b = blockIdx.z;
  const int kvh = h / (p.H / p.Hkv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<D>(Qs, static_cast<const float*>(p.q) + b * p.st[kQ][0] +
                       h * p.st[kQ][1], p.st[kQ][2], i0, p.Sq);
  load_tile<D>(dOs, static_cast<const float*>(p.dout) + b * p.st[kDO][0] +
                        h * p.st[kDO][1], p.st[kDO][2], i0, p.Sq);
  const long long lrow = (b * p.H + h) * (long long)p.Sq;
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const bool ok = i0 + r < p.Sq;
    lse_s[r] = ok ? p.lse[lrow + i0 + r] : 0.f;
    delta_s[r] = ok ? p.delta[lrow + i0 + r] : 0.f;
  }

  int lo, hi;
  key_span(p, i0, &lo, &hi);
  const float* kb = static_cast<const float*>(p.k) + b * p.st[kK][0] +
                    kvh * p.st[kK][1];
  const float* vb = static_cast<const float*>(p.v) + b * p.st[kV][0] +
                    kvh * p.st[kV][1];

  float dq[4][DT];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int t = 0; t < DT; ++t) dq[a][t] = 0.f;

  for (int j0 = lo / kTile * kTile; j0 < hi; j0 += kTile) {
    __syncthreads();                            // the last tile is consumed
    load_tile<D>(Ks, kb, p.st[kK][2], j0, p.Sk);
    load_tile<D>(Vs, vb, p.st[kV][2], j0, p.Sk);
    __syncthreads();
    float P[4][4], dS[4][4];
    score_tile<D>(p, Qs, dOs, Ks, Vs, lse_s, delta_s, i0, j0, P, dS);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        dSs[(ty + 16 * a) * kPS + tx + 16 * c] = dS[a][c];
    __syncthreads();
    // dQ[i] += sum_j dS[i][j] K[j]
    const int keys = min(kTile, p.Sk - j0);
    for (int j = 0; j < keys; ++j) {
      float sa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) sa[a] = dSs[(ty + 16 * a) * kPS + j];
#pragma unroll
      for (int t = 0; t < DT; ++t) {
        const float kv = Ks[j * RS + tx + 16 * t];
#pragma unroll
        for (int a = 0; a < 4; ++a) dq[a][t] = fmaf(sa[a], kv, dq[a][t]);
      }
    }
  }

  float* dqp = static_cast<float*>(p.dq) + b * p.st[kDQ][0] +
               h * p.st[kDQ][1];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
    if (i >= p.Sq) continue;
#pragma unroll
    for (int t = 0; t < DT; ++t)
      dqp[i * p.st[kDQ][2] + tx + 16 * t] = dq[a][t] * p.scale;
  }
}

// =========================================================================
// wgmma path: bf16 on the tensor cores
// =========================================================================

// Rows [row0, row0 + 64) of one head (base, row stride rs) into dst as
// 8-row x 16-byte core matrices -- row j, columns 8 c..8 c + 7 at element
// ((j / 8) * D / 8 + c) * 64 + (j % 8) * 8 -- asynchronously, by threads
// t of nt; rows at or past n read as zeros.  Thread e writes the e-th 16
// bytes of dst, so a warp's writes are contiguous (free of bank
// conflicts); its reads are 8 rows x 64 bytes.
template <int D>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* base,
                                                long long rs, int row0,
                                                int n, int t, int nt) {
  constexpr int CPR = D / 8;                    // 16-byte chunks per row
  for (int e = t; e < kTile * CPR; e += nt) {
    const int cm = e >> 3;                      // core matrix (j / 8, c)
    const int j = (cm / CPR) * 8 + (e & 7), c = cm % CPR;
    const bool ok = row0 + j < n;
    cp_async16(dst + e * 8, base + (ok ? row0 + j : 0) * rs + c * 8, ok);
  }
}

// A core-matrix tile as a K-contiguous wgmma operand (its rows as M or N,
// the head dim as K): the 16 head dims of step kd.
template <int D>
__device__ __forceinline__ uint64_t desc_k(const bf16* t, int kd) {
  return smem_desc(t + kd * 128, 128, D / 8 * 128);
}
// The same tile as an N-contiguous B operand (its rows as K, the head dim
// as N): the 16 rows of step kk.
template <int D>
__device__ __forceinline__ uint64_t desc_n(const bf16* t, int kk) {
  return smem_desc(t + kk * 2 * (D / 8) * 64, D / 8 * 128, 128);
}

// Every (query i0 + x, key j0 + y) of the tile pair is valid.
__device__ __forceinline__ bool tile_full(const Params& p, int i0, int j0) {
  return i0 + kTile <= p.Sq && j0 + kTile <= p.Sk &&
         (!p.causal || j0 + kTile - 1 <= i0) &&
         (!p.window || i0 + kTile - 1 - j0 < p.window);
}

// P and dS of a warpgroup's 64 x 64 tile pair, from its fp32 accumulators
// s (scores) and dp: P = exp(s D^-0.5 - lse) on the valid pairs, 0
// elsewhere, dS = P (dp - delta), both rounded to bf16 as the A fragments
// of the gradient products (pf, sf: 16 columns each).  This thread holds
// rows r and r + 8 (r = 16 w + lane / 4, w its warp in the warpgroup),
// columns 8 j + 2 (lane % 4) +
// {0, 1}: s[4 j + c] is row r + 8 (c / 2), column 8 j + 2 (lane % 4) +
// c % 2.  KEY_ROWS: rows are keys and columns queries ((b)), else the
// reverse ((c)).  lse_s, dl_s: lse and delta of the tile's 64 queries.
template <bool KEY_ROWS, bool MASK>
__device__ __forceinline__ void grad_tile(const Params& p, float (&s)[32],
                                          float (&dp)[32], int i0, int j0,
                                          const float* lse_s,
                                          const float* dl_s,
                                          uint32_t (&pf)[4][4],
                                          uint32_t (&sf)[4][4]) {
  const int lane = threadIdx.x % 32;
  const int r0 = threadIdx.x / 32 % 4 * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  const float sl2 = p.scale * kLog2e;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = r0 + (c >> 1) * 8, col = c0 + 8 * j + (c & 1);
      const int qi = KEY_ROWS ? col : r, kj = KEY_ROWS ? r : col;
      const int x = 4 * j + c;
      const float pv =
          !MASK || valid(p, i0 + qi, j0 + kj)
              ? exp2f(fmaf(s[x], sl2, -lse_s[qi] * kLog2e)) : 0.f;
      s[x] = pv;
      dp[x] = pv * (dp[x] - dl_s[qi]);
    }
    pf[j / 2][(j & 1) * 2] = pack_bf16(s[4 * j], s[4 * j + 1]);
    pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
    sf[j / 2][(j & 1) * 2] = pack_bf16(dp[4 * j], dp[4 * j + 1]);
    sf[j / 2][(j & 1) * 2 + 1] = pack_bf16(dp[4 * j + 2], dp[4 * j + 3]);
  }
}

template <bool KEY_ROWS>
__device__ __forceinline__ void grad_tile(const Params& p, float (&s)[32],
                                          float (&dp)[32], int i0, int j0,
                                          const float* lse_s,
                                          const float* dl_s,
                                          uint32_t (&pf)[4][4],
                                          uint32_t (&sf)[4][4]) {
  if (tile_full(p, i0, j0))
    grad_tile<KEY_ROWS, false>(p, s, dp, i0, j0, lse_s, dl_s, pf, sf);
  else
    grad_tile<KEY_ROWS, true>(p, s, dp, i0, j0, lse_s, dl_s, pf, sf);
}

// A warpgroup's 64 x D fp32 accumulators times f, rounded to bf16, into
// rows ra and ra + 8 of this thread (row stride rs; rows at or past n
// are not written).
template <int D>
__device__ __forceinline__ void store_acc(bf16* base, long long rs, int ra,
                                          int n, const float (&acc)[D / 2],
                                          float f) {
  const int tg = threadIdx.x & 3;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int row = ra + 8 * u;
    if (row >= n) continue;
    bf16* r = base + row * rs;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(r + dt * 8 + 2 * tg) =
          __floats2bfloat162_rn(acc[4 * dt + 2 * u] * f,
                                acc[4 * dt + 2 * u + 1] * f);
  }
}

// The CTA's warpgroups, each with its own 64 keys ((b)) or query rows
// ((c)), share every streamed tile: as many as the registers of one SM
// hold (ptxas: the dK/dV kernel needs ~168 registers a thread at D <= 64,
// ~200-250 above; the dQ kernel ~130-170), so one CTA fills an SM.
template <int D>
constexpr int kDkvWGs = D <= 64 ? 3 : 2;
constexpr int kDqWGs = 3;
constexpr int kStages = 3;                      // ring slots
template <int D>
constexpr size_t kTileBytes = sizeof(bf16) * size_t(kTile) * D;
// (b): a stage holds a query tile's Q and dO, then its rows' lse and delta
template <int D>
constexpr size_t kDkvStageBytes =
    2 * kTileBytes<D> + 2 * sizeof(float) * kTile;
template <int D>
constexpr size_t dkv_wgmma_smem_bytes() {       // K, V per warpgroup; ring
  return 2 * kDkvWGs<D> * kTileBytes<D> + kStages * kDkvStageBytes<D>;
}
template <int D>
constexpr size_t dq_wgmma_smem_bytes() {        // Q, dO, lse, delta per
  return kDqWGs * (2 * kTileBytes<D> + 2 * sizeof(float) * kTile) +
         kStages * 2 * kTileBytes<D>;           // warpgroup; K/V ring
}

// (b) dK, dV for one (batch, KV head, block of kDkvWGs key tiles): each
// warpgroup keeps its K and V tile; the items, (query head g, query tile)
// in order over the block's reach, stream their Q, dO, lse and delta
// through the ring, and each warpgroup works on those its keys see.
template <int D>
__global__ void __launch_bounds__(kDkvWGs<D> * kWgThreads, 1)
attn_bwd_dkv_wgmma_kernel(const Params p) {
  constexpr int TILE = kTile * D, NWG = kDkvWGs<D>, NT = NWG * kWgThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, wg = tid / kWgThreads, wt = tid % kWgThreads;
  bf16* Ks = reinterpret_cast<bf16*>(smem) + wg * 2 * TILE;   // then V
  unsigned char* ring = smem + 2 * NWG * kTileBytes<D>;
  auto q_at = [&](int s) {                      // the stage's Q, then dO
    return reinterpret_cast<bf16*>(ring + s * kDkvStageBytes<D>);
  };
  auto lse_at = [&](int s) {                    // its lse, then delta
    return reinterpret_cast<float*>(ring + s * kDkvStageBytes<D> +
                                    2 * kTileBytes<D>);
  };

  // Under a causal mask the first key blocks, seen by the most query
  // tiles, start first (the grid's y dimension).
  const int kvh = blockIdx.x, jb = blockIdx.y * NWG * kTile;
  const long long b = blockIdx.z;
  const int G = p.H / p.Hkv, j0 = jb + wg * kTile;     // this warpgroup's
  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* dout = static_cast<const bf16*>(p.dout);
  int qt0, qt1, wq0, wq1, dummy;
  query_tiles(p, jb, &qt0, &dummy);             // the block's reach
  query_tiles(p, min(jb + (NWG - 1) * kTile, p.Sk - 1), &dummy, &qt1);
  query_tiles(p, j0, &wq0, &wq1);               // this warpgroup's
  const bool has_keys = j0 < p.Sk;
  const int per = max(0, qt1 - qt0), nitems = G * per;

  auto load_item = [&](int it) {
    if (it >= nitems) return;
    const int h = kvh * G + it / per, i0 = (qt0 + it % per) * kTile;
    const int s = it % kStages;
    bf16* qs = q_at(s);
    load_tile_async<D>(qs, q + b * p.st[kQ][0] + h * p.st[kQ][1],
                       p.st[kQ][2], i0, p.Sq, tid, NT);
    load_tile_async<D>(qs + TILE, dout + b * p.st[kDO][0] + h * p.st[kDO][1],
                       p.st[kDO][2], i0, p.Sq, tid, NT);
    if (tid < 2 * kTile) {                      // threads 0-63 lse, 64-127
      const int r = tid % kTile;                // delta
      const bool ok = i0 + r < p.Sq;
      const long long row = (b * p.H + h) * (long long)p.Sq +
                            (ok ? i0 + r : 0);
      cp_async4(lse_at(s) + tid, tid < kTile ? p.lse + row : p.delta + row,
                ok);
    }
  };
  load_tile_async<D>(Ks, static_cast<const bf16*>(p.k) + b * p.st[kK][0] +
                             kvh * p.st[kK][1], p.st[kK][2], j0, p.Sk, wt,
                     kWgThreads);
  load_tile_async<D>(Ks + TILE, static_cast<const bf16*>(p.v) +
                                    b * p.st[kV][0] + kvh * p.st[kV][1],
                     p.st[kV][2], j0, p.Sk, wt, kWgThreads);
#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) {
    load_item(it);
    cp_async_commit();
  }

  // One barrier an item: past it, item it has landed for every thread and
  // every warpgroup is done with item it - 1, whose slot is then reloaded.
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) dk[x] = dv[x] = 0.f;
  for (int it = 0; it < nitems; ++it) {
    cp_async_wait<kStages - 2>();               // item it's tiles landed
    fence_proxy_async();
    __syncthreads();
    load_item(it + kStages - 1);
    cp_async_commit();
    const int s = it % kStages, qt = qt0 + it % per, i0 = qt * kTile;
    if (has_keys && qt >= wq0 && qt < wq1) {    // warpgroup-uniform
      const bf16* qs = q_at(s);
      const bf16* dos = qs + TILE;
      float st[32], dpt[32];
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd)       // S^T = K Q^T
        wgmma_ss64(st, desc_k<D>(Ks, kd), desc_k<D>(qs, kd), kd);
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd)       // dP^T = V dO^T
        wgmma_ss64(dpt, desc_k<D>(Ks + TILE, kd), desc_k<D>(dos, kd), kd);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      uint32_t pf[4][4], sf[4][4];
      grad_tile<true>(p, st, dpt, i0, j0, lse_at(s), lse_at(s) + kTile, pf,
                      sf);
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)            // dV += P^T dO
        Wgmma<D, 1>::run(dv, pf[kk], desc_n<D>(dos, kk), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)            // dK += dS^T Q
        Wgmma<D, 1>::run(dk, sf[kk], desc_n<D>(qs, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
    }
  }
  cp_async_wait<0>();

  const int ra = j0 + wt / 32 * 16 + (wt % 32 >> 2);
  store_acc<D>(static_cast<bf16*>(p.dk) + b * p.st[kDK][0] +
                   kvh * p.st[kDK][1], p.st[kDK][2], ra, p.Sk, dk, p.scale);
  store_acc<D>(static_cast<bf16*>(p.dv) + b * p.st[kDV][0] +
                   kvh * p.st[kDV][1], p.st[kDV][2], ra, p.Sk, dv, 1.f);
}

// (c) dQ for one (batch, head, block of kDqWGs query tiles): each
// warpgroup keeps its Q, dO and their rows' lse and delta; the key tiles
// of the block's reach stream through the ring, and each warpgroup works
// on those its rows see.
template <int D>
__global__ void __launch_bounds__(kDqWGs * kWgThreads, 1)
attn_bwd_dq_wgmma_kernel(const Params p) {
  constexpr int TILE = kTile * D, NT = kDqWGs * kWgThreads;
  constexpr int WG_BYTES = 2 * kTileBytes<D> + 2 * sizeof(float) * kTile;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, wg = tid / kWgThreads, wt = tid % kWgThreads;
  bf16* Qs = reinterpret_cast<bf16*>(smem + wg * WG_BYTES);  // then dO
  float* lse_s = reinterpret_cast<float*>(Qs + 2 * TILE);   // then delta
  bf16* ring = reinterpret_cast<bf16*>(smem + kDqWGs * WG_BYTES);

  // The heaviest query blocks (the last, under a causal mask) start first.
  const int h = blockIdx.x;
  const int ib = (gridDim.y - 1 - blockIdx.y) * kDqWGs * kTile;
  const int i0 = ib + wg * kTile;               // this warpgroup's rows
  const long long b = blockIdx.z;
  const int kvh = h / (p.H / p.Hkv);
  load_tile_async<D>(Qs, static_cast<const bf16*>(p.q) + b * p.st[kQ][0] +
                             h * p.st[kQ][1], p.st[kQ][2], i0, p.Sq, wt,
                     kWgThreads);
  load_tile_async<D>(Qs + TILE, static_cast<const bf16*>(p.dout) +
                                    b * p.st[kDO][0] + h * p.st[kDO][1],
                     p.st[kDO][2], i0, p.Sq, wt, kWgThreads);
  {
    const int r = wt % kTile;                   // threads 0-63 lse, 64-127
    const bool ok = i0 + r < p.Sq;              // delta
    const long long row = (b * p.H + h) * (long long)p.Sq + (ok ? i0 + r : 0);
    cp_async4(lse_s + wt, wt < kTile ? p.lse + row : p.delta + row, ok);
  }

  int lo, hi, wlo, whi, dummy;
  key_span(p, ib, &lo, &dummy);                 // the block's reach
  key_span(p, min(ib + (kDqWGs - 1) * kTile, p.Sq - 1), &dummy, &hi);
  key_span(p, i0, &wlo, &whi);                  // this warpgroup's
  const bool has_rows = i0 < p.Sq;
  const int t0 = lo / kTile;
  const int ntiles = hi > t0 * kTile ? (hi - t0 * kTile + kTile - 1) / kTile
                                     : 0;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.st[kK][0] +
                   kvh * p.st[kK][1];
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.st[kV][0] +
                   kvh * p.st[kV][1];
  auto load_kv = [&](int t) {
    if (t >= ntiles) return;
    bf16* ks = ring + (t % kStages) * 2 * TILE;
    const int j0 = (t0 + t) * kTile;
    load_tile_async<D>(ks, kb, p.st[kK][2], j0, p.Sk, tid, NT);
    load_tile_async<D>(ks + TILE, vb, p.st[kV][2], j0, p.Sk, tid, NT);
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    load_kv(t);
    cp_async_commit();
  }

  float dq[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) dq[x] = 0.f;
  for (int t = 0; t < ntiles; ++t) {             // one barrier a tile, as (b)
    cp_async_wait<kStages - 2>();               // tile t landed
    fence_proxy_async();
    __syncthreads();
    load_kv(t + kStages - 1);
    cp_async_commit();
    const int j0 = (t0 + t) * kTile;
    if (has_rows && j0 < whi && j0 + kTile > wlo) {  // warpgroup-uniform
      const bf16* ks = ring + (t % kStages) * 2 * TILE;
      const bf16* vs = ks + TILE;
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd)       // S = Q K^T
        wgmma_ss64(s, desc_k<D>(Qs, kd), desc_k<D>(ks, kd), kd);
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd)       // dP = dO V^T
        wgmma_ss64(dp, desc_k<D>(Qs + TILE, kd), desc_k<D>(vs, kd), kd);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      uint32_t pf[4][4], sf[4][4];              // pf unused: no P V here
      grad_tile<false>(p, s, dp, i0, j0, lse_s, lse_s + kTile, pf, sf);
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)            // dQ += dS K
        Wgmma<D, 1>::run(dq, sf[kk], desc_n<D>(ks, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
    }
  }
  cp_async_wait<0>();

  store_acc<D>(static_cast<bf16*>(p.dq) + b * p.st[kDQ][0] +
                   h * p.st[kDQ][1], p.st[kDQ][2],
               i0 + wt / 32 * 16 + (wt % 32 >> 2), p.Sq, dq, p.scale);
}

// =========================================================================
// launch
// =========================================================================

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int D, typename T>
cudaError_t launch_delta(const Params& p, cudaStream_t stream) {
  constexpr int CPR = D * int(sizeof(T)) / 16;
  constexpr int L = CPR <= 4 ? 4 : CPR <= 8 ? 8 : CPR <= 16 ? 16 : 32;
  const long long rows = (long long)p.B * p.H * p.Sq;
  const int per = kThreads / L;                 // rows a block
  attn_bwd_delta_kernel<D, T><<<(rows + per - 1) / per, kThreads, 0,
                                stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fma(const Params& p, cudaStream_t stream) {
  cudaError_t err;
  if ((err = launch_delta<D, float>(p, stream)) != cudaSuccess) return err;
  constexpr size_t s_kv = dkv_smem_bytes<D>();
  if ((err = allow_smem(attn_bwd_dkv_kernel<D>, s_kv)) != cudaSuccess)
    return err;
  const dim3 gkv((p.Sk + kTile - 1) / kTile, p.Hkv, p.B);
  attn_bwd_dkv_kernel<D><<<gkv, kThreads, s_kv, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  constexpr size_t s_q = dq_smem_bytes<D>();
  if ((err = allow_smem(attn_bwd_dq_kernel<D>, s_q)) != cudaSuccess)
    return err;
  const dim3 gq((p.Sq + kTile - 1) / kTile, p.H, p.B);
  attn_bwd_dq_kernel<D><<<gq, kThreads, s_q, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wgmma(const Params& p, cudaStream_t stream) {
  cudaError_t err;
  if ((err = launch_delta<D, bf16>(p, stream)) != cudaSuccess) return err;
  constexpr size_t s_kv = dkv_wgmma_smem_bytes<D>();
  if ((err = allow_smem(attn_bwd_dkv_wgmma_kernel<D>, s_kv)) != cudaSuccess)
    return err;
  constexpr int kb = kDkvWGs<D> * kTile;       // keys a CTA
  const dim3 gkv(p.Hkv, (p.Sk + kb - 1) / kb, p.B);
  attn_bwd_dkv_wgmma_kernel<D><<<gkv, kDkvWGs<D> * kWgThreads, s_kv,
                                 stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  constexpr size_t s_q = dq_wgmma_smem_bytes<D>();
  if ((err = allow_smem(attn_bwd_dq_wgmma_kernel<D>, s_q)) != cudaSuccess)
    return err;
  constexpr int qb = kDqWGs * kTile;            // query rows a CTA
  const dim3 gq(p.H, (p.Sq + qb - 1) / qb, p.B);
  attn_bwd_dq_wgmma_kernel<D><<<gq, kDqWGs * kWgThreads, s_q, stream>>>(p);
  return cudaGetLastError();
}

#define FA_BWD_HEAD_DIMS(X) X(16) X(32) X(64) X(80) X(128)

cudaError_t dispatch(int path, const Params& p, int D, cudaStream_t s) {
  switch (path * 1000 + D) {
#define FA_BWD_CASE(d)                                                      \
    case kFma * 1000 + d: return launch_fma<d>(p, s);                       \
    case kWgmma * 1000 + d: return launch_wgmma<d>(p, s);
    FA_BWD_HEAD_DIMS(FA_BWD_CASE)
#undef FA_BWD_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t (0 = launched).  path: 0 = fma (fp32 only), 1 =
// wgmma (bf16 only); dtype: 0 = fp32, 1 = bf16 (q, k, v, o, dO and the
// three gradients alike); a path that does not take the dtype is refused.
// lse: the forward's (B, H, Sq) contiguous fp32 row log-sum-exp; delta:
// (B, H, Sq) fp32 scratch.  strides: 24 host int64s, (b, head, row)
// strides in elements of q, k, v, o, dO, dq, dk, dv in that order (the last
// dim of each is contiguous).  B is at most 65535 (a grid dimension).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int path, int dtype, int B, int H, int Hkv, int Sq, int Sk,
    int D, const long long* strides, int causal, int window, float scale,
    void* stream) {
  const bool takes = path == kFma     ? dtype == 0
                     : path == kWgmma ? dtype == 1
                                      : false;
  if (!takes || B < 0 || B > 65535 || Sq < 0 || Sk < 0 || Hkv <= 0 ||
      H % Hkv != 0 || !lse || !delta || !strides)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0 || Sk == 0) return 0;
  Params p{q, k, v, o, dout, lse, delta, dq, dk, dv,
           B, H, Hkv, Sq, Sk, causal, window, {}, scale};
  for (int t = 0; t < 8; ++t)
    for (int u = 0; u < 3; ++u) p.st[t][u] = strides[3 * t + u];
  return static_cast<int>(
      dispatch(path, p, D, static_cast<cudaStream_t>(stream)));
}
