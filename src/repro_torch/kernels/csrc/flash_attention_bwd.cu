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
// Three launches, deterministic (no floating-point atomics: two runs agree
// bit for bit):
//  (a) delta: a warp per query row, fp32.
//  (b) dK, dV: one CTA per (batch, KV head, 64-key tile).  It keeps its K
//      and V tile in shared memory and walks the G query heads and, for
//      each, the 64-row query tiles the mask lets see its keys, summing
//      their contributions in registers: the GQA sum stays in the CTA.
//  (c) dQ: one CTA per (batch, head, 64-row query tile), walking the key
//      tiles its rows may see.
// Both tile kernels recompute S and dP = dO V^T for a (query tile, key
// tile) pair; (b) and (c) together do 7 tile products for the 5 of the
// algorithm.
//
// What bounds it: at the training shape (S = 4096, D = 64) the work is
// ~5 products of 2 S^2 D / 2 flop per head, far above the card's ~295
// flop/byte balance point, so arithmetic.  This first version computes in
// fp32 FMAs on both dtypes (bf16 is loaded and widened; outputs rounded
// once), so it runs against the 67 TFLOP/s fp32 rate, not the tensor
// cores' 989.  Its tiles live in shared memory as fp32 with padded rows;
// each thread of 256 holds a 4 x 4 block of the 64 x 64 score tile (rows
// ty + 16 a, keys tx + 16 c) and reads Q, dO, K, V along d as 16-byte
// vectors: 8 vector reads per 64 FMAs.  Tile pairs outside the mask's
// reach are never visited; the heaviest CTAs (the first key tiles of (b),
// the last query tiles of (c) under a causal mask) start first.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;                       // query rows / keys a tile
constexpr int kThreads = 256;                   // 16 x 16 threads
constexpr int kPS = kTile + 1;                  // padded P / dS row

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
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes of T from global memory, widened to fp32.
__device__ __forceinline__ void load_vec(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}
__device__ __forceinline__ void load_vec(const bf16* src, float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// Rows [row0, row0 + 64) of one head (base, row stride rs) into dst as fp32
// with row stride RS; rows at or past n read as zeros.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          long long rs, int row0, int n) {
  constexpr int RS = D + 4;
  constexpr int VEC = 16 / sizeof(T);           // elements per 16 bytes
  constexpr int CPR = D / VEC;                  // 16-byte chunks per row
  for (int e = threadIdx.x; e < kTile * CPR; e += kThreads) {
    const int r = e / CPR, c = (e % CPR) * VEC;
    float x[VEC];
    if (row0 + r < n) {
      load_vec(base + (row0 + r) * rs + c, x);
    } else {
#pragma unroll
      for (int t = 0; t < VEC; ++t) x[t] = 0.f;
    }
#pragma unroll
    for (int t = 0; t < VEC; t += 4)
      *reinterpret_cast<float4*>(dst + r * RS + c + t) =
          make_float4(x[t], x[t + 1], x[t + 2], x[t + 3]);
  }
}

__device__ __forceinline__ bool valid(const Params& p, int i, int j) {
  return i < p.Sq && j < p.Sk && (!p.causal || j <= i) &&
         (!p.window || i - j < p.window);
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

// (a) delta = rowsum(dO o O), fp32: a warp per (b, h, i) row.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads) attn_bwd_delta_kernel(
    const Params p) {
  const long long row = blockIdx.x * (long long)(kThreads / 32) +
                        threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)p.B * p.H * p.Sq) return;
  const int i = row % p.Sq;
  const int h = (row / p.Sq) % p.H;
  const long long b = row / ((long long)p.Sq * p.H);
  const T* o = static_cast<const T*>(p.o) + b * p.st[kO][0] +
               h * p.st[kO][1] + i * p.st[kO][2];
  const T* dout = static_cast<const T*>(p.dout) + b * p.st[kDO][0] +
                  h * p.st[kDO][1] + i * p.st[kDO][2];
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(to_f32(o[d]), to_f32(dout[d]), acc);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) p.delta[row] = acc;
}

template <int D>
constexpr size_t dkv_smem_bytes() {             // K, V, Q, dO; P, dS; lse, delta
  return sizeof(float) * (4 * size_t(kTile) * (D + 4) +
                          2 * size_t(kTile) * kPS + 2 * kTile);
}

// (b) dK, dV for one (batch, KV head, key tile).
template <int D, typename T>
__global__ void __launch_bounds__(kThreads) attn_bwd_dkv_kernel(
    const Params p) {
  constexpr int RS = D + 4, DT = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
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
  const T* q = static_cast<const T*>(p.q);
  const T* dout = static_cast<const T*>(p.dout);

  load_tile<D>(Ks, static_cast<const T*>(p.k) + b * p.st[kK][0] +
                       kvh * p.st[kK][1], p.st[kK][2], j0, p.Sk);
  load_tile<D>(Vs, static_cast<const T*>(p.v) + b * p.st[kV][0] +
                       kvh * p.st[kV][1], p.st[kV][2], j0, p.Sk);

  // The query tiles whose rows see some key of [j0, j0 + 64).
  const int nqt = (p.Sq + kTile - 1) / kTile;
  const int qt0 = p.causal ? j0 / kTile : 0;
  const int qt1 = p.window
                      ? min(nqt, (j0 + kTile - 1 + p.window - 1) / kTile + 1)
                      : nqt;

  float dk[4][DT], dv[4][DT];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int t = 0; t < DT; ++t) dk[a][t] = dv[a][t] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* qh = q + b * p.st[kQ][0] + h * p.st[kQ][1];
    const T* doh = dout + b * p.st[kDO][0] + h * p.st[kDO][1];
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

  T* dkp = static_cast<T*>(p.dk) + b * p.st[kDK][0] + kvh * p.st[kDK][1];
  T* dvp = static_cast<T*>(p.dv) + b * p.st[kDV][0] + kvh * p.st[kDV][1];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = j0 + ty + 16 * a;
    if (j >= p.Sk) continue;
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      store_f32(dkp + j * p.st[kDK][2] + tx + 16 * t, dk[a][t] * p.scale);
      store_f32(dvp + j * p.st[kDV][2] + tx + 16 * t, dv[a][t]);
    }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {              // Q, dO, K, V; dS; lse, delta
  return sizeof(float) * (4 * size_t(kTile) * (D + 4) +
                          size_t(kTile) * kPS + 2 * kTile);
}

// (c) dQ for one (batch, head, query tile).
template <int D, typename T>
__global__ void __launch_bounds__(kThreads) attn_bwd_dq_kernel(
    const Params p) {
  constexpr int RS = D + 4, DT = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
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

  load_tile<D>(Qs, static_cast<const T*>(p.q) + b * p.st[kQ][0] +
                       h * p.st[kQ][1], p.st[kQ][2], i0, p.Sq);
  load_tile<D>(dOs, static_cast<const T*>(p.dout) + b * p.st[kDO][0] +
                        h * p.st[kDO][1], p.st[kDO][2], i0, p.Sq);
  const long long lrow = (b * p.H + h) * (long long)p.Sq;
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const bool ok = i0 + r < p.Sq;
    lse_s[r] = ok ? p.lse[lrow + i0 + r] : 0.f;
    delta_s[r] = ok ? p.delta[lrow + i0 + r] : 0.f;
  }

  // The key tiles some row of [i0, i0 + 64) sees.
  const int i_last = min(i0 + kTile, p.Sq) - 1;
  const int lo = p.window ? max(0, i0 - p.window + 1) : 0;
  const int hi = p.causal ? min(p.Sk, i_last + 1) : p.Sk;
  const T* kb = static_cast<const T*>(p.k) + b * p.st[kK][0] +
                kvh * p.st[kK][1];
  const T* vb = static_cast<const T*>(p.v) + b * p.st[kV][0] +
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

  T* dqp = static_cast<T*>(p.dq) + b * p.st[kDQ][0] + h * p.st[kDQ][1];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
    if (i >= p.Sq) continue;
#pragma unroll
    for (int t = 0; t < DT; ++t)
      store_f32(dqp + i * p.st[kDQ][2] + tx + 16 * t, dq[a][t] * p.scale);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int D, typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  cudaError_t err;
  const long long rows = (long long)p.B * p.H * p.Sq;
  const int per = kThreads / 32;
  attn_bwd_delta_kernel<D, T><<<(rows + per - 1) / per, kThreads, 0,
                                stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  constexpr size_t s_kv = dkv_smem_bytes<D>();
  if ((err = allow_smem(attn_bwd_dkv_kernel<D, T>, s_kv)) != cudaSuccess)
    return err;
  const dim3 gkv((p.Sk + kTile - 1) / kTile, p.Hkv, p.B);
  attn_bwd_dkv_kernel<D, T><<<gkv, kThreads, s_kv, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  constexpr size_t s_q = dq_smem_bytes<D>();
  if ((err = allow_smem(attn_bwd_dq_kernel<D, T>, s_q)) != cudaSuccess)
    return err;
  const dim3 gq((p.Sq + kTile - 1) / kTile, p.H, p.B);
  attn_bwd_dq_kernel<D, T><<<gq, kThreads, s_q, stream>>>(p);
  return cudaGetLastError();
}

#define FA_BWD_HEAD_DIMS(X) X(16) X(32) X(64) X(80) X(128)

cudaError_t dispatch(const Params& p, int dtype, int D, cudaStream_t s) {
  switch (dtype * 1000 + D) {
#define FA_BWD_CASE(d)                                                      \
    case d: return launch<d, float>(p, s);                                  \
    case 1000 + d: return launch<d, bf16>(p, s);
    FA_BWD_HEAD_DIMS(FA_BWD_CASE)
#undef FA_BWD_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t (0 = launched).  dtype: 0 = fp32, 1 = bf16 (q, k, v,
// o, dO and the three gradients alike).  lse: the forward's (B, H, Sq)
// contiguous fp32 row log-sum-exp; delta: (B, H, Sq) fp32 scratch.
// strides: 24 host int64s, (b, head, row) strides in elements of q, k, v,
// o, dO, dq, dk, dv in that order (the last dim of each is contiguous).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int dtype, int B, int H, int Hkv, int Sq, int Sk, int D,
    const long long* strides, int causal, int window, float scale,
    void* stream) {
  if (B == 0 || Sq == 0 || Sk == 0) return 0;
  if (B < 0 || Sq < 0 || Sk < 0 || Hkv <= 0 || H % Hkv != 0 ||
      !lse || !delta || !strides)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, o, dout, lse, delta, dq, dk, dv,
           B, H, Hkv, Sq, Sk, causal, window, {}, scale};
  for (int t = 0; t < 8; ++t)
    for (int u = 0; u < 3; ++u) p.st[t][u] = strides[3 * t + u];
  return static_cast<int>(
      dispatch(p, dtype, D, static_cast<cudaStream_t>(stream)));
}
