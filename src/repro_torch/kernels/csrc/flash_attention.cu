// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `flash_attention_fwd` / `_attn_kernel`
// (src/repro/kernels/flash_attention.py) and takes its place at the two
// attention call sites of the model: `decode_attn_apply` (one query token
// against the KV cache) and `attn_apply` (prefill / full sequence).
//
// Contract kept from `_attn_kernel`: GQA (query head h reads KV head
// h / (H/Hkv)), scale D^-0.5, optional causal mask aligned top-left (query
// position i sees keys 0..i), optional sliding window (i - j < window),
// masked scores are the finite -1e30, online softmax with fp32 m/l/acc, and
// out = acc / max(l, 1e-30) in the input dtype.  Two additions: the kernel
// masks ragged edges itself (no Sq % block or Sk % block requirement), and
// it takes the number of valid keys `kv_len` (host int or a device int32),
// stopping its key loop there — the decode step reads only the filled
// prefix of the cache, never the whole buffer.  Strides are passed for q,
// k, v and out, so the (B, S, Hkv, D) cache is read in place as
// (B, Hkv, S, D) with no transpose.  A row with no valid key (kv_len = 0)
// yields zeros.
//
// What bounds it on the card: at decode (Sq = 1) the bytes of K and V —
// each key is used by only G = H/Hkv query rows, far below the H100's
// ~295 flop/byte balance point — so one CTA per (batch, kv head) loads each
// K/V tile once into shared memory and serves all G query heads from it;
// KV is never repeated per query head.  At prefill (Sq = 256, causal) it is
// the arithmetic; this first version does it in fp32 FMAs (fp32 inputs must
// not take TF32: they are held to 2e-5), with no tensor cores.  That is
// the known gap to close in a later change (mma/wgmma for bf16 tiles).
//
// Design: a CTA owns kRows query rows (pairs of query head in the group and
// query position) of one (batch, kv head), 4 warps, each warp one row at a
// time.  K/V tiles of kTileK keys go through shared memory as fp32 (K rows
// padded to D+1 floats so that lane-per-key reads are conflict-free).  For
// each 32-key chunk a lane computes one score, the warp reduces max and sum
// with shuffles, and each lane then accumulates D/32 output dims (at D = 16
// lanes 16-31 idle).  Chunks that hold no valid key for a row are skipped;
// this changes no result, because a row's first processed chunk always
// holds a valid key.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;                       // query rows per CTA
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kTileK = 64;                      // keys per shared-memory tile
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* kv_len_dev;                        // nullptr -> kv_len_host
  int B, H, Hkv, Sq, Sk, kv_len_host, causal, window;
  long long sqb, sqh, sqs;                      // strides in elements; the
  long long skb, skh, sks;                      // last dim is contiguous
  long long svb, svh, svs;
  long long sob, soh, sos;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16-byte vector load, widened to fp32.
__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
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

// Keys [lo, hi) that query position i may see.
__device__ __forceinline__ void key_range(const Params& p, int i, int kvl,
                                          int* lo, int* hi) {
  *hi = p.causal ? min(kvl, i + 1) : kvl;
  *lo = p.window ? max(0, i - p.window + 1) : 0;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(kRows) * D + size_t(kTileK) * (D + 1) +
                          size_t(kTileK) * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) attn_fwd_kernel(const Params p) {
  constexpr int VEC = 16 / sizeof(T);           // elements per 16-byte load
  constexpr int VPR = D / VEC;                  // 16-byte loads per row
  constexpr int KP = D + 1;                     // padded K row
  constexpr int DL = (D + 31) / 32;             // output dims per lane
  extern __shared__ float smem[];
  float* Qs = smem;                             // kRows x D
  float* Ks = Qs + kRows * D;                   // kTileK x KP
  float* Vs = Ks + kTileK * KP;                 // kTileK x D

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  T* o = static_cast<T*>(p.o);

  const int kvh = blockIdx.y;
  const long long b = blockIdx.z;
  const int G = p.H / p.Hkv;
  const int nrows = G * p.Sq;
  const int row0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int kvl = p.kv_len_dev ? *p.kv_len_dev : p.kv_len_host;
  kvl = max(0, min(kvl, p.Sk));

  // Query rows of this CTA (row = g * Sq + i), widened to fp32.
  for (int e = threadIdx.x; e < kRows * D; e += kThreads) {
    const int r = e / D, d = e % D, gr = row0 + r;
    float val = 0.f;
    if (gr < nrows) {
      const int g = gr / p.Sq, i = gr % p.Sq, h = kvh * G + g;
      val = to_f32(q[b * p.sqb + h * p.sqh + i * p.sqs + d]);
    }
    Qs[e] = val;
  }

  // The CTA's key range: the union of its rows' ranges.
  int cta_lo = INT_MAX, cta_hi = 0;
  for (int r = 0; r < kRows && row0 + r < nrows; ++r) {
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

  const T* kbase = k + b * p.skb + kvh * p.skh;
  const T* vbase = v + b * p.svb + kvh * p.svh;
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
            if (D % 32 == 0 || lane + 32 * t < D)   // D = 16: half a warp
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
    T* orow = o + b * p.sob + h * p.soh + i * p.sos;
    const float den = fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int t = 0; t < DL; ++t)
      if (D % 32 == 0 || lane + 32 * t < D)
        store_from_f32(orow + lane + 32 * t, acc[rr][t] / den);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int nrows = (p.H / p.Hkv) * p.Sq;
  const dim3 grid((nrows + kRows - 1) / kRows, p.Hkv, p.B);
  attn_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out,
    const int* kv_len_dev, int dtype, int B, int H, int Hkv, int Sq, int Sk,
    int D, long long sqb, long long sqh, long long sqs, long long skb,
    long long skh, long long sks, long long svb, long long svh, long long svs,
    long long sob, long long soh, long long sos, int kv_len_host, int causal,
    int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Hkv <= 0 || H % Hkv != 0)
    return B == 0 || Sq == 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, out, kv_len_dev, B, H, Hkv, Sq, Sk, kv_len_host, causal,
           window, sqb, sqh, sqs, skb, skh, sks, svb, svh, svs, sob, soh, sos,
           scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? dispatch_d<float>(p, D, s)
                  : dtype == 1 ? dispatch_d<__nv_bfloat16>(p, D, s)
                               : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
