// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `flash_attention_fwd` / `_attn_kernel`
// (src/repro/kernels/flash_attention.py) and takes its place at the two
// attention call sites of the model: `decode_attn_apply` (one query token
// against the KV cache) and `attn_apply` (prefill / full sequence).
//
// Contract kept from `_attn_kernel`: GQA (query head h reads KV head
// h / (H/Hkv)), scale D^-0.5, optional causal mask aligned top-left (query
// position i sees keys 0..i, also when Sq < Sk), optional sliding window
// (i - j < window), both measured from position q_offset + i for query row
// i when given a query offset (a sequence shard's queries over the whole
// sequence's keys: the reference's chunked_attention(q_offset=)), masked
// scores are the finite -1e30, online softmax with
// fp32 m/l/acc, and out = acc / max(l, 1e-30) in the input dtype.  Two
// additions: the kernels mask ragged edges themselves (no Sq % block or
// Sk % block requirement), and they take the number of valid keys `kv_len`
// (host int or a device int32, read on the device: no host sync), so the
// decode step reads only the filled prefix of the cache.  Strides are
// passed for q, k, v and out, so the (B, S, Hkv, D) cache is read in place
// as (B, Hkv, S, D) with no transpose; the output is laid out (B, Sq, H, D).
// A query row with no valid key yields zeros.  Head dims 16, 32, 64, 80
// and 128 on every path.  For training, the fma and mma paths also write
// each row's log-sum-exp (fp32, (B, H, Sq)) when given a pointer for it:
// the backward kernel (flash_attention_bwd.cu) recomputes P from it.
//
// One entry point, three device paths.  The wrapper chooses the path from
// the dtype and the number of query rows per KV head, G * Sq (G = H / Hkv),
// and passes it in; the entry point refuses a path whose kernels cannot
// take the call:
//
// * split_decode (G * Sq <= kDecodeRows, fp32 or bf16).  The decode step:
//   a handful of query rows against a long cache, ~G flop per K/V byte, far
//   below the H100's ~295 flop/byte balance point.  So it is bound by the
//   bytes of K and V, and in practice by latency: one thin CTA per (batch,
//   KV head) walking its tiles one after another keeps too few bytes in
//   flight.  The design splits the key axis two ways.  Inside a CTA, each
//   of 4 warps owns every 4th 64-key tile in its own cp.async ring (16-byte
//   copies; two slots up to D = 80, the next tile in flight while this one
//   computes), and the warps merge through shared memory.  Across CTAs, the wrapper fixes
//   the split count from the buffer length Sk and the SM count, never from
//   kv_len, so the launch is shape-static (a CUDA graph can capture it):
//   one split per (batch, KV head) when those fill the card (the serving
//   path's B * Hkv = 128), more when they do not; splits at or past kv_len
//   exit at once, and the last split of a (batch, KV head) to finish merges
//   the partial (m, l, acc) of the others from an fp32 workspace by the
//   log-sum-exp rule, through an arrival counter it resets.  Each CTA serves
//   all G query heads of its group from one read of each K/V tile, and asks
//   for its first tiles and Q before kv_len (a device int) comes back.  bf16
//   runs the tile on mma.sync.m16n8k16 with the group's R <= 16 query rows
//   as the 16 rows of the tile; fp32 runs fp32 FMAs (a warp per row, a lane
//   per key), so fp32 stays fp32.
// * mma (bf16, more rows): prefill, bound by arithmetic at the path's shape
//   (causal Sq = 256, D = 64: ~64 flop per byte), which only the tensor
//   cores deliver: wgmma (sm_90a warpgroup MMA), 64 query rows of one head
//   per warpgroup, S = Q K^T with Q in registers and K from shared memory,
//   O += P V with P rounded to bf16 in registers (as the Pallas kernel does
//   with p.astype(v.dtype)) and V from shared memory, fp32 accumulators,
//   mask and online softmax in registers.  K/V tiles are staged with
//   cp.async as 8 x 16-byte core matrices, the layout wgmma reads without a
//   swizzle.  When a (batch, KV head)'s keys fit in shared memory and there
//   are enough of them to fill the card, one CTA per (batch, KV head) loads
//   them once and 2-4 warpgroups take its (query block, head) units, heaviest
//   first: one read of each K/V tile serves all G heads and query blocks,
//   and the grid is a single wave.  Otherwise one warpgroup per (query
//   block, batch, KV head) streams its tiles through a 4-slot ring.  Tiles
//   with no valid key are skipped whole.  wgmma rather than mma.sync: on
//   this card mma.sync reaches about a quarter of the tensor rate, which
//   the first mma.sync version of this path measured as its limiter.
// * fma (fp32, more rows): the first version of this kernel, kept for fp32
//   inputs that are not decode-shaped; fp32 FMAs (never TF32, so fp32 is
//   held to 2e-5), K/V widened to fp32 in shared memory, a lane per key.
//
// Any other case (another dtype or head dim, a path that does not take the
// call, a missing workspace) returns cudaErrorInvalidValue; the wrapper
// raises.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <atomic>
#include <climits>
#include <cstdint>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileK = 64;                      // keys per shared-memory tile
constexpr int kDecodeRows = 16;                 // split path: G * Sq <= this
constexpr int kMmaRows = 64;                    // mma path: query rows per CTA
constexpr int kFmaRows = 32;                    // fma path: query rows per CTA
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

enum Path { kFma = 0, kMma = 1, kSplit = 2 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* kv_len_dev;                        // nullptr -> kv_len_host
  int B, H, Hkv, Sq, Sk, kv_len_host, causal, window;
  int qoff;                                     // query row i at qoff + i
  long long sqb, sqh, sqs;                      // strides in elements; the
  long long skb, skh, sks;                      // last dim is contiguous
  long long svb, svh, svs;
  long long sob, soh, sos;
  float scale;
  float* lse;                                   // nullptr, or (B, H, Sq) fp32
};

__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_from_f32(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes of fp32 (from global or shared memory).
__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// ---- PTX: mma (cp.async, ldmatrix and wgmma: hopper.cuh) ----------------

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- end of PTX --------------------------------------------------------

__device__ __forceinline__ int read_kv_len(const Params& p) {
  const int kvl = p.kv_len_dev ? *p.kv_len_dev : p.kv_len_host;
  return max(0, min(kvl, p.Sk));
}

// Keys [lo, hi) that query row i, at position qoff + i, may see.
__device__ __forceinline__ void key_range(const Params& p, int i, int kvl,
                                          int* lo, int* hi) {
  const int pos = p.qoff + i;
  *hi = p.causal ? min(kvl, pos + 1) : kvl;
  *lo = p.window ? max(0, pos - p.window + 1) : 0;
}

// =========================================================================
// fma path: fp32, a lane per key (the first version of this kernel)
// =========================================================================

template <int D>
constexpr size_t fma_smem_bytes() {
  return sizeof(float) * (size_t(kFmaRows) * D + size_t(kTileK) * (D + 1) +
                          size_t(kTileK) * D);
}

template <int D>
__global__ void __launch_bounds__(kThreads) attn_fma_kernel(const Params p) {
  constexpr int VEC = 4;                        // floats per 16-byte load
  constexpr int VPR = D / VEC;                  // 16-byte loads per row
  constexpr int KP = D + 1;                     // padded K row
  constexpr int DL = (D + 31) / 32;             // output dims per lane
  constexpr int kRowsPerWarp = kFmaRows / kWarps;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);   // kFmaRows x D
  float* Ks = Qs + kFmaRows * D;                // kTileK x KP
  float* Vs = Ks + kTileK * KP;                 // kTileK x D

  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  float* o = static_cast<float*>(p.o);

  const int kvh = blockIdx.y;
  const long long b = blockIdx.z;
  const int G = p.H / p.Hkv;
  const int nrows = G * p.Sq;
  const int row0 = blockIdx.x * kFmaRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int kvl = read_kv_len(p);

  // Query rows of this CTA (row = g * Sq + i).
  for (int e = threadIdx.x; e < kFmaRows * D; e += kThreads) {
    const int r = e / D, d = e % D, gr = row0 + r;
    float val = 0.f;
    if (gr < nrows) {
      const int g = gr / p.Sq, i = gr % p.Sq, h = kvh * G + g;
      val = q[b * p.sqb + h * p.sqh + i * p.sqs + d];
    }
    Qs[e] = val;
  }

  // The CTA's key range: the union of its rows' ranges.
  int cta_lo = INT_MAX, cta_hi = 0;
  for (int r = 0; r < kFmaRows && row0 + r < nrows; ++r) {
    int lo, hi;
    key_range(p, (row0 + r) % p.Sq, kvl, &lo, &hi);
    if (lo < hi) {
      cta_lo = min(cta_lo, lo);
      cta_hi = max(cta_hi, hi);
    }
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DL];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int t = 0; t < DL; ++t) acc[rr][t] = 0.f;
  }

  const float* kbase = k + b * p.skb + kvh * p.skh;
  const float* vbase = v + b * p.svb + kvh * p.svh;
  for (int k0 = cta_lo; k0 < cta_hi; k0 += kTileK) {
    __syncthreads();                            // previous tile consumed
    for (int e = threadIdx.x; e < kTileK * VPR; e += kThreads) {
      const int j = e / VPR, d0 = (e % VPR) * VEC, kp = k0 + j;
      float kt[VEC], vt[VEC];
      if (kp < cta_hi) {
        load16(kbase + kp * p.sks + d0, kt);
        load16(vbase + kp * p.svs + d0, vt);
      } else {
#pragma unroll
        for (int t = 0; t < VEC; ++t) kt[t] = vt[t] = 0.f;
      }
#pragma unroll
      for (int t = 0; t < VEC; ++t) {
        Ks[j * KP + d0 + t] = kt[t];
        Vs[j * D + d0 + t] = vt[t];
      }
    }
    __syncthreads();

    const int kend = min(k0 + kTileK, cta_hi);
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp + kWarps * rr, gr = row0 + r;
      if (gr >= nrows) continue;                // warp-uniform
      int lo, hi;
      key_range(p, gr % p.Sq, kvl, &lo, &hi);
      const float* qr = Qs + r * D;
      for (int c0 = k0; c0 < kend; c0 += 32) {
        if (c0 >= hi || c0 + 32 <= lo) continue;  // no valid key here
        const int kp = c0 + lane;
        float s = kNegInf;
        if (kp >= lo && kp < hi) {
          const float* kr = Ks + (kp - k0) * KP;
          float dot = 0.f;
#pragma unroll 16
          for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
          s = dot * p.scale;
        }
        const float m_new = fmaxf(m[rr], warp_max(s));
        const float pj = expf(s - m_new);
        const float corr = expf(m[rr] - m_new);
        l[rr] = l[rr] * corr + warp_sum(pj);
#pragma unroll
        for (int t = 0; t < DL; ++t) acc[rr][t] *= corr;
        const int js = max(0, lo - c0), je = min(32, hi - c0);
        for (int jj = js; jj < je; ++jj) {
          const float pb = __shfl_sync(kFull, pj, jj);
          const float* vr = Vs + (c0 - k0 + jj) * D;
#pragma unroll
          for (int t = 0; t < DL; ++t)
            if (D % 32 == 0 || lane + 32 * t < D)   // D = 16, 80: part of a warp
              acc[rr][t] = fmaf(pb, vr[lane + 32 * t], acc[rr][t]);
        }
        m[rr] = m_new;
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int gr = row0 + warp + kWarps * rr;
    if (gr >= nrows) continue;
    const int g = gr / p.Sq, i = gr % p.Sq, h = kvh * G + g;
    float* orow = o + b * p.sob + h * p.soh + i * p.sos;
    const float den = fmaxf(l[rr], 1e-30f);
    if (p.lse && lane == 0)
      p.lse[(b * p.H + h) * p.Sq + i] = m[rr] + logf(den);
#pragma unroll
    for (int t = 0; t < DL; ++t)
      if (D % 32 == 0 || lane + 32 * t < D)
        orow[lane + 32 * t] = acc[rr][t] / den;
  }
}

// =========================================================================
// the tensor-core tile step: S = Q K^T, mask and online softmax, O += P V
// =========================================================================

// The row sum of a quad's partial sums.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// A fragments of Q (16 rows x D, bf16) for this thread's rows ra, rb,
// straight from global memory: a row with ok* false reads as zeros.
template <int D>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[D / 16][4],
                                             const bf16* qa, const bf16* qb,
                                             bool oka, bool okb) {
  const int c = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    const int col = kd * 16 + c;
    qf[kd][0] = oka ? *reinterpret_cast<const uint32_t*>(qa + col) : 0u;
    qf[kd][1] = okb ? *reinterpret_cast<const uint32_t*>(qb + col) : 0u;
    qf[kd][2] = oka ? *reinterpret_cast<const uint32_t*>(qa + col + 8) : 0u;
    qf[kd][3] = okb ? *reinterpret_cast<const uint32_t*>(qb + col + 8) : 0u;
  }
}

// Mask and online softmax of one 64-key tile of scores s (this thread's
// two rows: s[j][0..1] row a, s[j][2..3] row b, key 8 j + 2 tg + c % 2),
// the mma accumulator layout of mma.sync and wgmma alike.  Scores and m stay
// unscaled; p = 2^(s * sl2 - m * sl2) with sl2 = D^-0.5 log2(e), which is
// exp((s - m) * D^-0.5).  Key j of the tile is valid for row a iff
// ja0 <= j < ja1 (row b: jb0, jb1); `full` says every key is valid for
// every row of the warp.  Rescales l and adds this lane's part of the
// tile's sum to it, returns in corr the factor the caller must rescale O
// by, and leaves P rounded to bf16 as the A fragments of P V (16 keys
// each).
__device__ __forceinline__ void softmax_tile(
    float (&s)[8][4], float sl2, int ja0, int ja1, int jb0, int jb1,
    bool full, float (&m)[2], float (&l)[2], float (&corr)[2],
    uint32_t (&pf)[4][4]) {
  const int tg = threadIdx.x & 3;
  if (!full) {                                  // this thread's columns:
    ja0 -= 2 * tg; ja1 -= 2 * tg;               // 8 j + 2 tg + {0, 1}
    jb0 -= 2 * tg; jb1 -= 2 * tg;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 8 * j + (c & 1);
        const bool ok = c < 2 ? (col >= ja0 && col < ja1)
                              : (col >= jb0 && col < jb1);
        if (!ok) s[j][c] = kNegInf;
      }
  }
  // The row max is shared by the 4 lanes of a quad.
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
  }
  float mb[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    mx[u] = fmaxf(mx[u], __shfl_xor_sync(kFull, mx[u], 1));
    mx[u] = fmaxf(mx[u], __shfl_xor_sync(kFull, mx[u], 2));
    // A row with no valid key yet keeps m = -1e30: exponents taken against
    // 0 then make every masked p exactly 0.
    mb[u] = mx[u] <= kNegInf ? 0.f : mx[u] * sl2;
    corr[u] = exp2f(fmaf(m[u], sl2, -mb[u]));
    m[u] = mx[u];
    l[u] *= corr[u];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float p0 = exp2f(fmaf(s[j][0], sl2, -mb[0]));
    const float p1 = exp2f(fmaf(s[j][1], sl2, -mb[0]));
    const float p2 = exp2f(fmaf(s[j][2], sl2, -mb[1]));
    const float p3 = exp2f(fmaf(s[j][3], sl2, -mb[1]));
    l[0] += p0 + p1;                            // fp32, unrounded
    l[1] += p2 + p3;
    pf[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
    pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
  }
}

// O *= corr, row by row (this thread's rows a, b).
template <int ND>
__device__ __forceinline__ void rescale(float (&oacc)[ND][4],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int dt = 0; dt < ND; ++dt) {
    oacc[dt][0] *= corr[0];
    oacc[dt][1] *= corr[0];
    oacc[dt][2] *= corr[1];
    oacc[dt][3] *= corr[1];
  }
}

// The split_decode path's tile step for one warp's 16 rows, on mma.sync:
// ks / vs is the tile, kTileK x (D + 8) bf16 each (rows padded by 16 bytes
// so that ldmatrix is free of bank conflicts).
template <int D>
__device__ __forceinline__ void mma_attend_tile(
    const uint32_t (&qf)[D / 16][4], const bf16* ks, const bf16* vs,
    float sl2, int ja0, int ja1, int jb0, int jb1, bool full,
    float (&m)[2], float (&l)[2], float (&oacc)[D / 8][4]) {
  constexpr int RS = D + 8, KD = D / 16, ND = D / 8;
  const int lane = threadIdx.x % 32;
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
  for (int j2 = 0; j2 < 4; ++j2) {              // S = Q K^T, 16 keys a step
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t bk[4];
      ldmatrix_x4(bk, ks + (j2 * 16 + (lane & 7) + (lane >> 4) * 8) * RS +
                          kd * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * j2], qf[kd], bk[0], bk[1]);
      mma_bf16(s[2 * j2 + 1], qf[kd], bk[2], bk[3]);
    }
  }
  uint32_t pf[4][4];
  float corr[2];
  softmax_tile(s, sl2, ja0, ja1, jb0, jb1, full, m, l, corr, pf);
  rescale<ND>(oacc, corr);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {              // O += P V, 16 keys a step
#pragma unroll
    for (int dn = 0; dn < ND / 2; ++dn) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, vs + (kk * 16 + (lane & 7) +
                                  ((lane >> 3) & 1) * 8) * RS +
                                dn * 16 + (lane >> 4) * 8);
      mma_bf16(oacc[2 * dn], pf[kk], bv[0], bv[1]);
      mma_bf16(oacc[2 * dn + 1], pf[kk], bv[2], bv[3]);
    }
  }
}

// One 64-key tile for a warpgroup's 64 query rows on wgmma: S = Q K^T, the
// mask and online softmax of softmax_tile, O += P V.  ks / vs: the tile as
// 8-key x 8-dim core matrices (16-byte rows), the K-contiguous B operand of
// Q K^T and the N-contiguous (transposed) B operand of P V.
template <int D>
__device__ __forceinline__ void wgmma_attend_tile(
    const uint32_t (&qf)[D / 16][4], const bf16* ks, const bf16* vs,
    float sl2, int ja0, int ja1, int jb0, int jb1, bool full,
    float (&m)[2], float (&l)[2], float (&oacc)[D / 8][4]) {
  constexpr int CPR = D / 8, ND = D / 8;
  float s[8][4];
  float (&sf)[32] = reinterpret_cast<float (&)[32]>(s);
  wgmma_fence();
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd)           // S = Q K^T
    Wgmma<64, 0>::run(sf, qf[kd], smem_desc(ks + kd * 128, 128, CPR * 128),
                      kd);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(sf);
  uint32_t pf[4][4];
  float corr[2];
  softmax_tile(s, sl2, ja0, ja1, jb0, jb1, full, m, l, corr, pf);
  rescale<ND>(oacc, corr);
  float (&of)[ND * 4] = reinterpret_cast<float (&)[ND * 4]>(oacc);
  fence_regs(of);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)                // O += P V
    Wgmma<D, 1>::run(of, pf[kk],
                     smem_desc(vs + kk * 2 * CPR * 64, CPR * 128, 128), 1);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(of);
}

// Stores a warpgroup's 64 x D output rows: oacc / l in bf16, rows ra, rb
// of this thread (skipped past Sq); and, where lse is not null (the row
// log-sum-exp of head h, Sq floats), m D^-0.5 + log(l) of each row.
template <int D>
__device__ __forceinline__ void store_rows(const Params& p, bf16* obase,
                                           float* lse, int ra, int rb,
                                           const float (&oacc)[D / 8][4],
                                           const float (&m)[2],
                                           const float (&l)[2]) {
  const int tg = threadIdx.x & 3;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const float den = fmaxf(quad_sum(l[u]), 1e-30f);
    const float inv = 1.f / den;
    const int row = u ? rb : ra;
    if (row >= p.Sq) continue;
    if (lse && tg == 0) lse[row] = m[u] * p.scale + logf(den);
    bf16* orow = obase + row * p.sos;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8 + 2 * tg) =
          __floats2bfloat162_rn(oacc[dt][2 * u] * inv,
                                oacc[dt][2 * u + 1] * inv);
  }
}

// =========================================================================
// mma path: bf16 prefill on the tensor cores (wgmma)
// =========================================================================
//
// Two kernels.  The group kernel, when a (batch, KV head)'s keys fit in
// shared memory and there are enough of them to fill the card: one CTA per
// (batch, KV head) loads its K/V tiles once, and its kGroupWGs warpgroups
// take the (query block, head) units of all G heads, heaviest first, with
// no barrier after the load.  One read of each K/V tile serves every query
// row that sees it, and the grid is a single wave.  Otherwise the block
// kernel: one warpgroup per (query block, batch, KV head), as below.

constexpr int kMmaStages = 4;                   // K/V tiles in the ring

template <int D>
constexpr size_t mma_smem_bytes() {             // the K/V ring
  return sizeof(bf16) * size_t(kMmaStages) * 2 * kTileK * D;
}

// A CTA is one warpgroup: kMmaRows = 64 query positions of one (batch, KV
// head), warp w holding rows 16 w..16 w + 15, and it serves the G query
// heads of the group in turn, from one read of each K/V tile while the
// CTA's tiles fit in the ring: then they are loaded once, up front, and stay
// resident across the heads.  Past that, the work is a sequence of items
// (head g, tile t) that streams the tiles again for each head, the tile of
// item i + kMmaStages - 1 in flight while item i computes.  Tiles are stored
// as 8-key x 8-dim core matrices (16-byte rows): the K-contiguous B operand
// of S = Q K^T, and the N-contiguous (transposed) B operand of O += P V.
template <int D>
__global__ void __launch_bounds__(kThreads) attn_mma_kernel(const Params p) {
  constexpr int CPR = D / 8;                    // 16-byte chunks per row
  constexpr int ND = D / 8;
  constexpr int TILE = kTileK * D;              // elements of a K or V tile
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* KV = reinterpret_cast<bf16*>(smem);     // per stage: K, then V

  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* k = static_cast<const bf16*>(p.k);
  const bf16* v = static_cast<const bf16*>(p.v);
  bf16* o = static_cast<bf16*>(p.o);

  const int G = p.H / p.Hkv, kvh = blockIdx.x;
  const long long b = blockIdx.y;
  // The grid's last dimension runs from the longest causal rows down (a
  // query offset shifts every row alike), so that the heaviest CTAs start
  // first.
  const int i0 = (gridDim.z - 1 - blockIdx.z) * kMmaRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kvl = read_kv_len(p);
  const int i_last = min(i0 + kMmaRows, p.Sq) - 1;
  const int lo = p.window ? max(0, p.qoff + i0 - p.window + 1) : 0;
  const int hi = p.causal ? min(kvl, p.qoff + i_last + 1) : kvl;
  const int ntiles = lo < hi ? (hi - lo + kTileK - 1) / kTileK : 0;
  const bool resident = ntiles <= kMmaStages;
  const int nitems = G * ntiles;

  const bf16* kbase = k + b * p.skb + kvh * p.skh;
  const bf16* vbase = v + b * p.svb + kvh * p.svh;
  auto stage = [&](int i) {                     // item i's K tile
    const int t = i % ntiles;
    return KV + (resident ? t : i % kMmaStages) * 2 * TILE;
  };
  auto load_item = [&](int i) {                 // keys past hi read as 0
    if (i >= nitems || (resident && i >= ntiles)) return;
    const int k0 = lo + (i % ntiles) * kTileK;
    bf16* ks = stage(i);
    bf16* vs = ks + TILE;
    for (int e = tid; e < kTileK * CPR; e += kThreads) {
      const int j = e / CPR, c = e % CPR;
      const int off = ((j >> 3) * CPR + c) * 64 + (j & 7) * 8;
      const bool ok = k0 + j < hi;
      const long long kp = ok ? k0 + j : k0;
      cp_async16(ks + off, kbase + kp * p.sks + c * 8, ok);
      cp_async16(vs + off, vbase + kp * p.svs + c * 8, ok);
    }
  };
  // This thread's rows and their key bounds (row i at position qoff + i).
  const int w0 = i0 + warp * 16;
  const int ra = w0 + (lane >> 2), rb = ra + 8;
  auto key_lo = [&](int i) {
    return p.window ? max(0, p.qoff + i - p.window + 1) : 0;
  };
  auto key_hi = [&](int i) {
    return p.causal ? min(kvl, p.qoff + i + 1) : kvl;
  };
  const int lo_a = key_lo(ra), hi_a = key_hi(ra);
  const int lo_b = key_lo(rb), hi_b = key_hi(rb);
  // The keys all of the warp's rows see.
  const int all_lo = key_lo(w0 + 15), all_hi = key_hi(w0);
  const float sl2 = p.scale * kLog2e;

  auto q_rows = [&](int g, uint32_t (&qf)[D / 16][4]) {
    const bf16* qh = q + b * p.sqb + (kvh * G + g) * p.sqh;
    load_q_frags<D>(qf, qh + min(ra, p.Sq - 1) * p.sqs,
                    qh + min(rb, p.Sq - 1) * p.sqs, ra < p.Sq, rb < p.Sq);
  };
  uint32_t qf[D / 16][4], qn[D / 16][4];
  q_rows(0, qf);                                // first: head 0 needs it
  if (resident) {                               // every tile, once, each
    for (int t = 0; t < ntiles; ++t) {          // its own group: head 0
      load_item(t);                             // takes them as they land
      cp_async_commit();
    }
  } else {
#pragma unroll
    for (int i = 0; i < kMmaStages - 1; ++i) {
      load_item(i);
      cp_async_commit();
    }
  }

  for (int g = 0; g < G; ++g) {
    if (g + 1 < G) q_rows(g + 1, qn);           // in flight during head g
    float oacc[ND][4];
#pragma unroll
    for (int dt = 0; dt < ND; ++dt)
#pragma unroll
      for (int c = 0; c < 4; ++c) oacc[dt][c] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    for (int t = 0; t < ntiles; ++t) {
      const int i = g * ntiles + t;
      if (!resident) {
        load_item(i + kMmaStages - 1);
        cp_async_commit();
        cp_async_wait<kMmaStages - 1>();        // item i's tile landed
        fence_proxy_async();
        __syncthreads();
      } else if (g == 0) {
        cp_async_wait_upto(ntiles - 1 - t);     // tile t landed
        fence_proxy_async();
        __syncthreads();
      }
      const int k0 = lo + t * kTileK;
      const bf16* ks = stage(i);
      wgmma_attend_tile<D>(qf, ks, ks + TILE, sl2, lo_a - k0, hi_a - k0,
                           lo_b - k0, hi_b - k0,
                           k0 >= all_lo && k0 + kTileK <= all_hi, m, l,
                           oacc);
      if (!resident) __syncthreads();           // the stage may be reloaded
    }
    const int h = kvh * G + g;
    store_rows<D>(p, o + b * p.sob + h * p.soh,
                  p.lse ? p.lse + (b * p.H + h) * p.Sq : nullptr, ra, rb,
                  oacc, m, l);
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
#pragma unroll
      for (int c = 0; c < 4; ++c) qf[kd][c] = qn[kd][c];
  }
  cp_async_wait<0>();
}

// Warpgroups per group CTA: as many as registers allow without spilling.
template <int D>
constexpr int kGroupWGs = D <= 64 ? 4 : D <= 80 ? 3 : 2;
constexpr size_t kGroupSmem = 128 * 1024;       // K/V budget of a group CTA

template <int D>
constexpr int kGroupMaxTiles = int(kGroupSmem / (sizeof(bf16) * 2 * kTileK * D));

template <int D>
__global__ void __launch_bounds__(kGroupWGs<D> * kThreads)
attn_mma_group_kernel(const Params p) {
  constexpr int CPR = D / 8, ND = D / 8;
  constexpr int NWG = kGroupWGs<D>, NT = NWG * kThreads;
  constexpr int TILE = kTileK * D;              // elements of a K or V tile
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* KV = reinterpret_cast<bf16*>(smem);     // tile t: K, then V

  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* k = static_cast<const bf16*>(p.k);
  const bf16* v = static_cast<const bf16*>(p.v);
  bf16* o = static_cast<bf16*>(p.o);
  const int G = p.H / p.Hkv, kvh = blockIdx.x;
  const long long b = blockIdx.y;
  const int tid = threadIdx.x, wg = tid / kThreads;
  const int warp = tid % kThreads / 32, lane = tid % 32;
  const int kvl = read_kv_len(p);
  const int hi = p.causal ? min(kvl, p.qoff + p.Sq) : kvl;  // keys any
  const int ntiles = (hi + kTileK - 1) / kTileK;      // row sees, from 0

  // Unit u: query block nqb - 1 - u / G (the longest causal rows first),
  // head u % G; warpgroup w takes units w, w + NWG, ...
  const int nqb = (p.Sq + kMmaRows - 1) / kMmaRows, nunits = nqb * G;
  auto rows_of = [&](int u, int* i0, int* ra) {
    *i0 = (nqb - 1 - u / G) * kMmaRows;
    *ra = *i0 + warp * 16 + (lane >> 2);
  };
  auto q_rows = [&](int u, uint32_t (&qf)[D / 16][4]) {
    int i0, ra;
    rows_of(u, &i0, &ra);
    const bf16* qh = q + b * p.sqb + (kvh * G + u % G) * p.sqh;
    load_q_frags<D>(qf, qh + min(ra, p.Sq - 1) * p.sqs,
                    qh + min(ra + 8, p.Sq - 1) * p.sqs, ra < p.Sq,
                    ra + 8 < p.Sq);
  };
  uint32_t qf[D / 16][4], qn[D / 16][4];
  if (wg < nunits) q_rows(wg, qf);              // first: the first unit's Q

  const bf16* kbase = k + b * p.skb + kvh * p.skh;   // every tile, once
  const bf16* vbase = v + b * p.svb + kvh * p.svh;
  for (int e = tid; e < ntiles * kTileK * CPR; e += NT) {
    const int j = e / CPR, c = e % CPR, t = j / kTileK, jj = j % kTileK;
    const int off = t * 2 * TILE + ((jj >> 3) * CPR + c) * 64 + (jj & 7) * 8;
    const bool ok = j < hi;
    const long long kp = ok ? j : 0;
    cp_async16(KV + off, kbase + kp * p.sks + c * 8, ok);
    cp_async16(KV + off + TILE, vbase + kp * p.svs + c * 8, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  auto key_lo = [&](int i) {                    // row i at qoff + i
    return p.window ? max(0, p.qoff + i - p.window + 1) : 0;
  };
  auto key_hi = [&](int i) {
    return p.causal ? min(kvl, p.qoff + i + 1) : kvl;
  };
  const float sl2 = p.scale * kLog2e;
  for (int u = wg; u < nunits; u += NWG) {
    if (u + NWG < nunits) q_rows(u + NWG, qn);  // in flight
    int i0, ra;
    rows_of(u, &i0, &ra);
    const int rb = ra + 8, w0 = i0 + warp * 16;
    const int lo_a = key_lo(ra), hi_a = key_hi(ra);
    const int lo_b = key_lo(rb), hi_b = key_hi(rb);
    const int all_lo = key_lo(w0 + 15), all_hi = key_hi(w0);
    const int i_last = min(i0 + kMmaRows, p.Sq) - 1;
    const int t0 = key_lo(i0) / kTileK;         // the unit's tiles
    const int t1 = (key_hi(i_last) + kTileK - 1) / kTileK;
    float oacc[ND][4];
#pragma unroll
    for (int dt = 0; dt < ND; ++dt)
#pragma unroll
      for (int c = 0; c < 4; ++c) oacc[dt][c] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    for (int t = t0; t < t1; ++t) {
      const int k0 = t * kTileK;
      const bf16* ks = KV + t * 2 * TILE;
      wgmma_attend_tile<D>(qf, ks, ks + TILE, sl2, lo_a - k0, hi_a - k0,
                           lo_b - k0, hi_b - k0,
                           k0 >= all_lo && k0 + kTileK <= all_hi, m, l,
                           oacc);
    }
    const int h = kvh * G + u % G;
    store_rows<D>(p, o + b * p.sob + h * p.soh,
                  p.lse ? p.lse + (b * p.H + h) * p.Sq : nullptr, ra, rb,
                  oacc, m, l);
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
#pragma unroll
      for (int c = 0; c < 4; ++c) qf[kd][c] = qn[kd][c];
  }
  cp_async_wait<0>();
}

// =========================================================================
// split_decode path: split-KV decode, merged by the last split to finish
// =========================================================================

// The union of the query rows' key ranges (ulo >= uhi: no key at all).
__device__ __forceinline__ void union_keys(const Params& p, int kvl,
                                           int* ulo, int* uhi) {
  *ulo = INT_MAX;
  *uhi = 0;
  for (int i = 0; i < p.Sq; ++i) {
    int a, z;
    key_range(p, i, kvl, &a, &z);
    if (a < z) {
      *ulo = min(*ulo, a);
      *uhi = max(*uhi, z);
    }
  }
}

// The splits that run: [s0, s1), those whose [s * chunk, (s + 1) * chunk)
// meets the union of the rows' key ranges; split s gets keys [lo, hi).
__device__ __forceinline__ void split_range(const Params& p, int kvl, int s,
                                            int chunk, int nsplit, int* s0,
                                            int* s1, int* lo, int* hi) {
  int ulo, uhi;
  union_keys(p, kvl, &ulo, &uhi);
  *s0 = ulo < uhi ? ulo / chunk : 0;
  *s1 = ulo < uhi ? min(nsplit, (uhi + chunk - 1) / chunk) : 0;
  *lo = max(ulo, s * chunk);
  *hi = min(uhi, (s + 1) * chunk);
}

// Workspace: B * Hkv * nsplit * R partials, R = G * Sq: acc (D floats
// each), then (m, l) pairs, all fp32.
struct Partials {
  float* acc;
  float* ml;
};
__device__ __forceinline__ Partials partials(const Params& p, float* ws,
                                             int kvh, long long b, int s,
                                             int nsplit, int R, int D) {
  const long long part = ((b * p.Hkv + kvh) * nsplit + s) * R;
  return {ws + part * D,
          ws + (long long)p.B * p.Hkv * nsplit * R * D + part * 2};
}

// Called by every split CTA of (b, kvh) once its partial is written: the
// last to arrive merges the splits [s0, s1) by the log-sum-exp rule,
// out = sum_s acc_s e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-30) with M
// the largest m_s, and resets the counter for the next launch.
template <typename T>
__device__ void merge_if_last(const Params& p, float* ws, int* counters,
                              int kvh, long long b, int s0, int s1,
                              int nsplit, int R, int D) {
  __shared__ int last;
  const int nthreads = blockDim.x, warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  __threadfence();                              // this partial, device-wide
  __syncthreads();
  int* counter = counters + b * p.Hkv + kvh;
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == s1 - s0 - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();                              // the others' partials
  const Partials base = partials(p, ws, kvh, b, 0, nsplit, R, D);
  const int G = p.H / p.Hkv;
  T* o = static_cast<T*>(p.o);
  for (int r = warp; r < R; r += nthreads / 32) {
    float mx = kNegInf;
    for (int s = s0 + lane; s < s1; s += 32)
      mx = fmaxf(mx, __ldcg(base.ml + (s * R + r) * 2));
    mx = warp_max(mx);
    float den = 0.f;
    for (int s = s0 + lane; s < s1; s += 32)
      den += __ldcg(base.ml + (s * R + r) * 2 + 1) *
             expf(__ldcg(base.ml + (s * R + r) * 2) - mx);
    den = fmaxf(warp_sum(den), 1e-30f);
    const int g = r / p.Sq, i = r % p.Sq, h = kvh * G + g;
    for (int d = lane; d < D; d += 32) {
      float num = 0.f;
#pragma unroll 4
      for (int s = s0; s < s1; ++s)
        num = fmaf(__ldcg(base.acc + (s * R + r) * D + d),
                   expf(__ldcg(base.ml + (s * R + r) * 2) - mx), num);
      store_from_f32(o + b * p.sob + h * p.soh + i * p.sos + d, num / den);
    }
  }
  if (threadIdx.x == 0) *counter = 0;
}

// When no split runs (no valid key at all), split 0 writes the zero rows.
template <typename T>
__device__ void write_zero_rows(const Params& p, int kvh, long long b,
                                int R, int D) {
  const int G = p.H / p.Hkv;
  T* o = static_cast<T*>(p.o);
  for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
    const int r = e / D, d = e % D, h = kvh * G + r / p.Sq, i = r % p.Sq;
    store_from_f32(o + b * p.sob + h * p.soh + i * p.sos + d, 0.f);
  }
}

// fp32: a warp per query row, a lane per key (fp32 FMAs: fp32 stays fp32).
template <int D>
size_t split_smem_bytes(int rows, int stages) {
  return sizeof(float) * (size_t(rows) * D +
                          size_t(stages) * 2 * kTileK * (D + 4));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
attn_split_kernel(const Params p, float* ws, int* counters, int nsplit,
                  int chunk) {
  constexpr int RS = D + 4;                     // padded smem row
  constexpr int CPR = D / 4;                    // 16-byte chunks per row
  constexpr int DL = (D + 31) / 32;             // output dims per lane
  constexpr int RPW = kDecodeRows / kWarps;     // rows per warp, at most
  extern __shared__ __align__(128) unsigned char smem[];
  const int G = p.H / p.Hkv, R = G * p.Sq;
  float* Qs = reinterpret_cast<float*>(smem);   // R x D
  float* KV = Qs + R * D;                       // per stage: K, then V

  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  const int s = blockIdx.x, kvh = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kvl = read_kv_len(p);
  int s0, s1, c_lo, c_hi;
  split_range(p, kvl, s, chunk, nsplit, &s0, &s1, &c_lo, &c_hi);
  if (c_lo >= c_hi) {                           // the merge skips it too
    if (s0 == s1 && s == 0) write_zero_rows<float>(p, kvh, b, R, D);
    return;
  }
  const int ntiles = (c_hi - c_lo + kTileK - 1) / kTileK;

  const float* kbase = k + b * p.skb + kvh * p.skh;
  const float* vbase = v + b * p.svb + kvh * p.svh;
  auto load_tile = [&](int t) {                 // keys past c_hi read as 0
    const int k0 = c_lo + t * kTileK;
    float* ks = KV + (t & 1) * 2 * kTileK * RS;
    float* vs = ks + kTileK * RS;
    for (int e = tid; e < kTileK * CPR; e += kThreads) {
      const int j = e / CPR, c = (e % CPR) * 4;
      const bool ok = k0 + j < c_hi;
      const long long kp = ok ? k0 + j : k0;
      cp_async16(ks + j * RS + c, kbase + kp * p.sks + c, ok);
      cp_async16(vs + j * RS + c, vbase + kp * p.svs + c, ok);
    }
  };
  load_tile(0);
  cp_async_commit();

  // Query rows (row = g * Sq + i), while tile 0 flies.
  for (int e = tid; e < R * D; e += kThreads) {
    const int r = e / D, d = e % D, g = r / p.Sq, i = r % p.Sq;
    Qs[e] = q[b * p.sqb + (kvh * G + g) * p.sqh + i * p.sqs + d];
  }

  float m[RPW], l[RPW], acc[RPW][DL];
  int rlo[RPW], rhi[RPW];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int t = 0; t < DL; ++t) acc[rr][t] = 0.f;
    const int r = warp + kWarps * rr;
    key_range(p, r % p.Sq, kvl, &rlo[rr], &rhi[rr]);
    rlo[rr] = max(rlo[rr], c_lo);
    rhi[rr] = min(rhi[rr], c_hi);
  }

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load_tile(t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = c_lo + t * kTileK;
    const float* ks = KV + (t & 1) * 2 * kTileK * RS;
    const float* vs = ks + kTileK * RS;
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp + kWarps * rr;
      const int lo = max(rlo[rr], k0), hi = min(rhi[rr], k0 + kTileK);
      if (r >= R || lo >= hi) continue;         // warp-uniform
      const float* qr = Qs + r * D;
      float sc[2];
      bool ok[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {             // lane: keys lane, lane + 32
        const int kp = k0 + lane + 32 * u;
        ok[u] = kp >= lo && kp < hi;
        float dot = 0.f;
        if (ok[u]) {
          const float* kr = ks + (lane + 32 * u) * RS;
#pragma unroll
          for (int c = 0; c < CPR; ++c) {
            float kt[4];
            load16(kr + c * 4, kt);
#pragma unroll
            for (int e = 0; e < 4; ++e) dot = fmaf(qr[c * 4 + e], kt[e], dot);
          }
        }
        sc[u] = ok[u] ? dot * p.scale : kNegInf;
      }
      const float m_new = fmaxf(m[rr], warp_max(fmaxf(sc[0], sc[1])));
      const float p0 = ok[0] ? expf(sc[0] - m_new) : 0.f;
      const float p1 = ok[1] ? expf(sc[1] - m_new) : 0.f;
      const float corr = expf(m[rr] - m_new);
      l[rr] = l[rr] * corr + warp_sum(p0 + p1);
      m[rr] = m_new;
#pragma unroll
      for (int t2 = 0; t2 < DL; ++t2) acc[rr][t2] *= corr;
      for (int jj = lo - k0; jj < hi - k0; ++jj) {
        const float pb = __shfl_sync(kFull, jj < 32 ? p0 : p1, jj & 31);
        const float* vr = vs + jj * RS;
#pragma unroll
        for (int t2 = 0; t2 < DL; ++t2)
          if (D % 32 == 0 || lane + 32 * t2 < D)
            acc[rr][t2] = fmaf(pb, vr[lane + 32 * t2], acc[rr][t2]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  const Partials w = partials(p, ws, kvh, b, s, nsplit, R, D);
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = warp + kWarps * rr;
    if (r >= R) continue;
#pragma unroll
    for (int t = 0; t < DL; ++t)
      if (D % 32 == 0 || lane + 32 * t < D)
        w.acc[r * D + lane + 32 * t] = acc[rr][t];
    if (lane == 0) {
      w.ml[2 * r] = m[rr];
      w.ml[2 * r + 1] = l[rr];
    }
  }
  merge_if_last<float>(p, ws, counters, kvh, b, s0, s1, nsplit, R, D);
}

// bf16: each warp of the CTA runs the tensor-core tile step over its own
// share of the split's tiles (tile t goes to warp t % 4), through its own
// cp.async ring, with the CTA's R <= 16 query rows (all G heads of the KV
// head) as the 16 rows of the mma tile; rows past R are zeros and are never
// written.  The warps' results merge through shared memory; a CTA that is
// its (b, KV head)'s only split writes the output itself, otherwise it
// writes a partial for merge_if_last.  Each warp requests its first tile
// and Q before kv_len is read: the buffer's keys are valid memory whatever
// kv_len is, so the two global reads overlap; V rows past the valid keys
// are cleared before use.
constexpr int kDecodeWarps = 4;

template <int D>
constexpr int kDecodeStages = D <= 80 ? 2 : 1;  // ring slots per warp

template <int D>
constexpr size_t split_mma_smem_bytes() {     // the warps' rings + merge
  return sizeof(bf16) * size_t(kDecodeWarps) * kDecodeStages<D> * 2 *
             kTileK * (D + 8) +
         sizeof(float) * size_t(kDecodeWarps) * kDecodeRows * (D + 2);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
attn_split_mma_kernel(const Params p, float* ws, int* counters, int nsplit,
                      int chunk) {
  constexpr int RS = D + 8, CPR = D / 8, ND = D / 8;
  constexpr int ST = kDecodeStages<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bf16* ring = reinterpret_cast<bf16*>(smem) + warp * ST * 2 * kTileK * RS;
  float* macc = reinterpret_cast<float*>(
      reinterpret_cast<bf16*>(smem) + kDecodeWarps * ST * 2 * kTileK * RS);
  float* mml = macc + kDecodeWarps * kDecodeRows * D;  // per warp: (m, l)

  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* k = static_cast<const bf16*>(p.k);
  const bf16* v = static_cast<const bf16*>(p.v);
  const int G = p.H / p.Hkv, R = G * p.Sq;
  const int s = blockIdx.x, kvh = blockIdx.y;
  const long long b = blockIdx.z;
  const bf16* kbase = k + b * p.skb + kvh * p.skh;
  const bf16* vbase = v + b * p.svb + kvh * p.svh;
  const int sbeg = s * chunk;
  // The warp's n-th tile is tile w + 4 n of the split, keys from k0(n);
  // rows at or past `end` read as zeros.
  auto k0_of = [&](int t) { return sbeg + t * kTileK; };
  auto load_tile = [&](int t, int slot, int end) {
    const int k0 = k0_of(t);
    bf16* ks = ring + slot * 2 * kTileK * RS;
    bf16* vs = ks + kTileK * RS;
    for (int e = lane; e < kTileK * CPR; e += 32) {
      const int j = e / CPR, c = (e % CPR) * 8;
      const bool ok = k0 + j < end;
      const long long kp = ok ? k0 + j : 0;
      cp_async16(ks + j * RS + c, kbase + kp * p.sks + c, ok);
      cp_async16(vs + j * RS + c, vbase + kp * p.svs + c, ok);
    }
  };
  const int spec = warp;                        // loaded before kv_len
  load_tile(spec, 0, min(p.Sk, sbeg + chunk));
  cp_async_commit();
  const int ra = lane >> 2, rb = ra + 8;        // this thread's rows
  uint32_t qf[D / 16][4];
  {
    auto qrow = [&](int r) {                    // row r = g * Sq + i
      const int rr = min(r, R - 1);
      return q + b * p.sqb + (kvh * G + rr / p.Sq) * p.sqh +
             (rr % p.Sq) * p.sqs;
    };
    load_q_frags<D>(qf, qrow(ra), qrow(rb), ra < R, rb < R);
  }

  const int kvl = read_kv_len(p);
  int s0, s1, c_lo, c_hi;
  split_range(p, kvl, s, chunk, nsplit, &s0, &s1, &c_lo, &c_hi);
  if (c_lo >= c_hi) {                           // the merge skips it too
    cp_async_wait<0>();
    if (s0 == s1 && s == 0) write_zero_rows<bf16>(p, kvh, b, R, D);
    return;
  }
  // The split's tiles [t0, t1); this warp's are t0 + (warp - t0) mod 4 + 4n.
  const int t0 = (c_lo - sbeg) / kTileK;
  const int t1 = (c_hi - sbeg + kTileK - 1) / kTileK;
  const int first = t0 + ((warp - t0) % kDecodeWarps + kDecodeWarps) %
                             kDecodeWarps;
  if (first != spec) {                          // the guess was not used
    cp_async_wait<0>();
    if (first < t1) load_tile(first, 0, c_hi);
    cp_async_commit();
  }

  auto key_lo = [&](int i) {                    // row i at qoff + i
    return max(c_lo, p.window ? p.qoff + i - p.window + 1 : 0);
  };
  auto key_hi = [&](int i) {
    return min(c_hi, p.causal ? p.qoff + i + 1 : c_hi);
  };
  const int pa = ra % p.Sq, pb = rb % p.Sq;
  const int lo_a = key_lo(pa), hi_a = key_hi(pa);
  const int lo_b = key_lo(pb), hi_b = key_hi(pb);
  const int all_lo = key_lo(p.Sq - 1), all_hi = key_hi(0);
  const float sl2 = p.scale * kLog2e;

  float oacc[ND][4];
#pragma unroll
  for (int dt = 0; dt < ND; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) oacc[dt][c] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int t = first, n = 0; t < t1; t += kDecodeWarps, ++n) {
    if (ST > 1) {                               // the next tile flies
      if (t + kDecodeWarps < t1)
        load_tile(t + kDecodeWarps, (n + 1) % ST, c_hi);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const int k0 = k0_of(t);
    bf16* ks = ring + (n % ST) * 2 * kTileK * RS;
    bf16* vs = ks + kTileK * RS;
    if (c_hi < k0 + kTileK) {                   // clear V past the keys used
      for (int e = lane; e < kTileK * CPR; e += 32)
        if (e / CPR >= c_hi - k0)
          *reinterpret_cast<uint4*>(vs + (e / CPR) * RS + (e % CPR) * 8) =
              make_uint4(0u, 0u, 0u, 0u);
      __syncwarp();
    }
    mma_attend_tile<D>(qf, ks, vs, sl2, lo_a - k0, hi_a - k0, lo_b - k0,
                       hi_b - k0, k0 >= all_lo && k0 + kTileK <= all_hi, m,
                       l, oacc);
    __syncwarp();
    if (ST == 1 && t + kDecodeWarps < t1) {     // one slot: now it is free
      load_tile(t + kDecodeWarps, 0, c_hi);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

  // The warps' (m, l, acc) into shared memory, m in units of the scaled
  // scores; a warp that had no tile leaves m = -1e30, l = 0, acc = 0.
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const float lsum = quad_sum(l[u]);
    const int r = u ? rb : ra;
    if (r >= R) continue;
    float* wa = macc + (warp * kDecodeRows + r) * D;
#pragma unroll
    for (int dt = 0; dt < ND; ++dt)
      *reinterpret_cast<float2*>(wa + dt * 8 + 2 * (lane & 3)) =
          make_float2(oacc[dt][2 * u], oacc[dt][2 * u + 1]);
    if ((lane & 3) == 0) {
      mml[(warp * kDecodeRows + r) * 2] =
          m[u] <= kNegInf ? kNegInf : m[u] * p.scale;
      mml[(warp * kDecodeRows + r) * 2 + 1] = lsum;
    }
  }
  __syncthreads();
  const bool alone = s1 - s0 == 1;
  const Partials w = alone ? Partials{nullptr, nullptr}
                           : partials(p, ws, kvh, b, s, nsplit, R, D);
  bf16* o = static_cast<bf16*>(p.o);
  for (int e = threadIdx.x; e < R * D; e += kThreads) {
    const int r = e / D, d = e % D;
    float mx = kNegInf;
#pragma unroll
    for (int wi = 0; wi < kDecodeWarps; ++wi)
      mx = fmaxf(mx, mml[(wi * kDecodeRows + r) * 2]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int wi = 0; wi < kDecodeWarps; ++wi) {
      const float f = expf(mml[(wi * kDecodeRows + r) * 2] - mx);
      den = fmaf(mml[(wi * kDecodeRows + r) * 2 + 1], f, den);
      num = fmaf(macc[(wi * kDecodeRows + r) * D + d], f, num);
    }
    if (alone) {
      const int h = kvh * G + r / p.Sq, i = r % p.Sq;
      o[b * p.sob + h * p.soh + i * p.sos + d] =
          __float2bfloat16(num / fmaxf(den, 1e-30f));
    } else {
      w.acc[r * D + d] = num;
      if (d == 0) {
        w.ml[2 * r] = mx;
        w.ml[2 * r + 1] = den;
      }
    }
  }
  if (!alone)
    merge_if_last<bf16>(p, ws, counters, kvh, b, s0, s1, nsplit, R, D);
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

template <int D>
cudaError_t launch_fma(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = fma_smem_bytes<D>();
  cudaError_t err = allow_smem(attn_fma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const int nrows = (p.H / p.Hkv) * p.Sq;
  const dim3 grid((nrows + kFmaRows - 1) / kFmaRows, p.Hkv, p.B);
  attn_fma_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

int sm_count() {                                // of the current device
  static int cached[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0)
    cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  return cached[dev];
}

// The group kernel's tiles (0: it does not take the call).
template <int D>
int group_tiles(const Params& p) {
  const int kvl = p.kv_len_dev ? p.Sk : max(0, min(p.kv_len_host, p.Sk));
  const int hi = p.causal ? min(kvl, p.qoff + p.Sq) : kvl;
  const int tiles = max(1, (hi + kTileK - 1) / kTileK);
  return tiles <= kGroupMaxTiles<D> && 2 * p.B * p.Hkv >= sm_count()
             ? tiles : 0;
}

// The mma path's launches by kernel (0: the block kernel, 1: the group
// kernel), counted where launch_mma launches each; read and zeroed through
// flash_attention_mma_kernels.
std::atomic<long long> mma_kernel_launches[2];

template <int D>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  cudaError_t err;
  if (const int tiles = group_tiles<D>(p)) {
    const size_t smem = sizeof(bf16) * size_t(tiles) * 2 * kTileK * D;
    if ((err = allow_smem(attn_mma_group_kernel<D>, smem)) != cudaSuccess)
      return err;
    attn_mma_group_kernel<D><<<dim3(p.Hkv, p.B), kGroupWGs<D> * kThreads,
                               smem, stream>>>(p);
    if ((err = cudaGetLastError()) == cudaSuccess) ++mma_kernel_launches[1];
    return err;
  }
  constexpr size_t smem = mma_smem_bytes<D>();
  if ((err = allow_smem(attn_mma_kernel<D>, smem)) != cudaSuccess) return err;
  const dim3 grid(p.Hkv, p.B, (p.Sq + kMmaRows - 1) / kMmaRows);
  attn_mma_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  if ((err = cudaGetLastError()) == cudaSuccess) ++mma_kernel_launches[0];
  return err;
}

int split_chunk(int Sk, int nsplit) {           // keys per split
  const int tiles = Sk > 0 ? (Sk + kTileK - 1) / kTileK : 1;
  return (tiles + nsplit - 1) / nsplit * kTileK;
}

template <int D>
cudaError_t launch_split(const Params& p, int dtype, float* ws, int* counters,
                         int nsplit, cudaStream_t stream) {
  const int chunk = split_chunk(p.Sk, nsplit);
  const int stages = chunk > kTileK ? 2 : 1;
  const dim3 grid(nsplit, p.Hkv, p.B);
  cudaError_t err;
  if (dtype == 0) {
    const size_t smem = split_smem_bytes<D>((p.H / p.Hkv) * p.Sq, stages);
    if ((err = allow_smem(attn_split_kernel<D>, smem)) != cudaSuccess)
      return err;
    attn_split_kernel<D><<<grid, kThreads, smem, stream>>>(
        p, ws, counters, nsplit, chunk);
  } else {
    constexpr size_t smem = split_mma_smem_bytes<D>();
    if ((err = allow_smem(attn_split_mma_kernel<D>, smem)) != cudaSuccess)
      return err;
    attn_split_mma_kernel<D><<<grid, kThreads, smem, stream>>>(
        p, ws, counters, nsplit, chunk);
  }
  return cudaGetLastError();
}

#define FA_HEAD_DIMS(X) X(16) X(32) X(64) X(80) X(128)

cudaError_t dispatch(int path, const Params& p, int dtype, int D, float* ws,
                     int* counters, int nsplit, cudaStream_t s) {
  switch (path * 1000 + D) {
#define FA_CASE(d)                                                          \
    case kFma * 1000 + d: return launch_fma<d>(p, s);                       \
    case kMma * 1000 + d: return launch_mma<d>(p, s);                       \
    case kSplit * 1000 + d:                                                 \
      return launch_split<d>(p, dtype, ws, counters, nsplit, s);
    FA_HEAD_DIMS(FA_CASE)
#undef FA_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t (0 = launched).  `path`: 0 = fma (fp32), 1 = mma
// (bf16), 2 = split_decode (either dtype, (H / Hkv) * Sq <= kDecodeRows
// query rows per KV head).  The split path takes nsplit, its
// split count, and, where splits merge (nsplit > 1, or fp32, which always
// merges through them), `ws`, an fp32 workspace of B * Hkv * nsplit * rows
// * (D + 2) floats, and `counters`, B * Hkv int32 zeros that the kernel
// leaves zero; the other paths ignore the three.  `lse`, when not null,
// receives each row's log-sum-exp m + log(max(l, 1e-30)) over the scaled
// scores, (B, H, Sq) contiguous fp32, for the backward (training shapes:
// the fma and mma paths; split_decode refuses it).  `q_offset` >= 0: query
// row i stands at position q_offset + i for the causal mask and the window
// (a sequence shard's queries over the whole sequence's keys).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out,
    const int* kv_len_dev, int path, int dtype, int B, int H, int Hkv,
    int Sq, int Sk, int D, long long sqb, long long sqh, long long sqs,
    long long skb, long long skh, long long sks, long long svb, long long svh,
    long long svs, long long sob, long long soh, long long sos,
    int kv_len_host, int causal, int window, int q_offset, float scale,
    void* ws, void* counters, int nsplit, float* lse, void* stream) {
  if (B <= 0 || Sq <= 0 || Hkv <= 0 || H % Hkv != 0 || q_offset < 0)
    return B == 0 || Sq == 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
  const bool takes =
      path == kFma     ? dtype == 0
      : path == kMma   ? dtype == 1
      : path == kSplit ? (dtype == 0 || dtype == 1) &&
                             (H / Hkv) * Sq <= kDecodeRows && nsplit >= 1 &&
                             ((nsplit == 1 && dtype == 1) ||
                              (ws != nullptr && counters != nullptr)) &&
                             lse == nullptr
                       : false;
  if (!takes) return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, out, kv_len_dev, B, H, Hkv, Sq, Sk, kv_len_host, causal,
           window, q_offset, sqb, sqh, sqs, skb, skh, sks, svb, svh, svs, sob, soh, sos,
           scale, lse};
  return static_cast<int>(dispatch(path, p, dtype, D, static_cast<float*>(ws),
                                   static_cast<int*>(counters), nsplit,
                                   static_cast<cudaStream_t>(stream)));
}

// Writes the mma path's launches by kernel since the last reset to out[0]
// (the block kernel) and out[1] (the group kernel), and zeroes them when
// `reset` is set.  Returns 0.
extern "C" int flash_attention_mma_kernels(long long* out, int reset) {
  for (int i = 0; i < 2; ++i)
    out[i] = reset ? mma_kernel_launches[i].exchange(0)
                   : mma_kernel_launches[i].load();
  return 0;
}
