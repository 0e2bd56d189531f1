// Mamba2 SSD chunked scan for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `ssd_scan_fwd` / `_ssd_kernel`
// (src/repro/kernels/ssd_scan.py) and takes its place in the model's
// `ssd_chunked` (full-sequence forward of every SSM layer).
//
// Contract kept from `_ssd_kernel`: for each (batch b, head h), chunks of Q
// positions in order, with an fp32 state (P, N) carried from chunk to chunk
// (zero at the start):
//   cum   = cumsum(a) over the chunk
//   y[q]  = sum_{s <= q} (C[q] . B[s]) exp(cum[q] - cum[s]) x[s]
//           + exp(cum[q]) C[q] state^T
//   state = state exp(cum[Q-1]) + sum_s exp(cum[Q-1] - cum[s]) x[s] (x) B[s]
// with x = xdt (already times dt), a = dt * A (negative), and B, C shared
// by every head.  The causal mask is applied to the exponent: an entry with
// s > q is never exponentiated.  Inputs are f32 or bf16 (a is f32), the
// state and every sum are fp32 (no TF32); y comes back in xdt's dtype.  The
// kernels take the model's layout through strides -- xdt and y (B, S, H, P),
// a (B, S, H), B and C (B, S, N), each with its last dim contiguous -- so
// there is no transpose copy around the call.
//
// What bounds it on the card: at the serving path's bf16 shapes (B=16,
// S=1024, H=32, P=64, N=128, Q=256) the bytes.  xdt and y are 134 MB, a and
// B/C 10.5 MB: ~145 MB is ~43 us at 3.35 TB/s, against ~26 GFLOP (~26 us at
// the bf16 tensor-core peak).  Only the tensor cores come near that: on the
// CUDA cores the same work is ~0.4 ms even at the full fp32 FMA rate.
//
// One entry point, two device paths; the wrapper chooses and passes the
// path, and the entry point refuses one that cannot take the call:
//
// * wgmma (bf16; P, N multiples of 16 up to 64 and 128; Q a multiple of 64;
//   16-byte aligned rows).  One CTA of one warpgroup per (b, h) walks the
//   sequence in 64-row sub-chunks, each chunk of Q being Q / 64 of them, and
//   carries the state from sub-chunk to sub-chunk in the registers of the
//   warpgroup (the wgmma accumulator, fp32).  For a sub-chunk with local
//   cumsum l (l[q] = sum of a over the sub-chunk up to q):
//     y   = exp(l[q]) C S^T + (C B^T o exp(l[q] - l[s]), s <= q) x
//     S  <- S exp(l[63]) + (x o exp(l[63] - l[s]))^T B
//   which is the contract's recurrence with the exponents of the chunk's
//   cumsum split at the sub-chunk edges (exp(cum[q] - cum[s]) = exp(l[q] -
//   l[s]) within a sub-chunk, and an earlier sub-chunk's terms reach q
//   through S).  So each 64-row query tile meets one key tile, the diagonal
//   one, and the off-diagonal key tiles of the chunk reach it through the
//   state product it needs anyway: 25 MFLOP per (b, h, chunk) of 256 rows
//   instead of 38 for G over every key tile on or below the diagonal.  The
//   exponents come from sums over at most 64 rows, never from cumsums that
//   reach ~-3e3 at mamba2's decays.
//   All four products run on wgmma with fp32 accumulators, the A operand in
//   registers: C (ldmatrix) for C S^T and G = C B^T; the decayed, masked G
//   for G x, as K1's prefill does with P; (x o decay)^T (ldmatrix.trans) for
//   the state update.  A bf16 operand rounds to 8 bits, which alone would
//   put y ~2x past SSD_CHUNKED_TOL at the path's shape (a rounding model
//   on the CPU); so every operand that is not an input -- the decayed G,
//   x o decay and the fp32 state -- is split into hi + lo bf16 parts, two
//   products into one accumulator, ~16 bits.  The inputs C, B, x are bf16
//   already and are exact operands.
//   P is padded to 64 and N to 64 or 128 (zero columns), so every tile is
//   made of 128-byte rows.  Loads: cp.async, 8 lanes to a row's 128 bytes,
//   into tiles with the 128-byte swizzle that wgmma reads (whole lines of
//   global memory, no bank conflicts); B, x and a double-buffered so that
//   sub-chunk j + 1 lands while j computes; C goes to registers first, so
//   its single buffer is refilled as soon as it is read.  y is staged in
//   shared memory and stored in whole rows.  ~106 KB of shared memory and
//   <= 255 registers a thread: two CTAs per SM, so the 512 CTAs of the
//   path's shape run in ~2 waves, and one CTA's loads, exps and stores
//   overlap the other's products.  The update's products stay in flight
//   while the decayed G is formed on the CUDA cores.  What is left on the
//   card (chip_smoke.py, H100 SXM at 700 W: ~3.7x the bytes bound) is
//   latency: each CTA is one chain of products, exps, barriers and state
//   writes per sub-chunk, with two such chains per SM.
// * fma (fp32, and bf16 shapes the wgmma path does not take).  The first
//   version of this kernel: one CTA per (b, h) loops over the chunks with
//   the state in shared memory; the within-chunk term is tiled (64 x 64,
//   causal tiles only) since the (Q, Q) fp32 block of 256 KB does not fit;
//   fp32 FMAs on the CUDA cores, so fp32 stays fp32.
//
// Left for later (see ROADMAP): splitting the sequence across CTAs (a
// second pass for the carried states) when B*H is small against the SM
// count, TMA loads and a producer warp.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <initializer_list>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

struct Params {
  const void* x;
  const float* a;
  const void* bm;
  const void* cm;
  void* y;
  int B, S, H, P, N, Q;
  long long sxb, sxs, sxh;                      // strides in elements; the
  long long sab, sas, sah;                      // last dim of x, B, C and y
  long long sbb, sbs;                           // is contiguous
  long long scb, scs;
  long long syb, sys, syh;
};

constexpr int kFma = 0, kWgmma = 1;             // path ids (the wrapper's)
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_from_f32(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// =========================================================================
// fma path: fp32 FMAs (the first version of this kernel)
// =========================================================================

constexpr int kThreads = 256;                   // a 16 x 16 thread grid
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                       // rows per query / key tile
constexpr int kMT = kTile / 16;                 // tile rows per thread
constexpr int kMP = kMaxP / 16;                 // head dims per thread
constexpr int kMN = kMaxN / 16;                 // state dims per thread

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

// In-place inclusive scan of v[0..n) by the whole CTA.
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

size_t smem_floats(int P, int N, int Q) {
  return size_t(N) * P + 2 * size_t(kTile) * (N + 1) + size_t(kTile) * P +
         size_t(kTile) * (kTile + 1) + 2 * size_t(Q);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_scan_fma_kernel(const Params p) {
  extern __shared__ float smem[];
  __shared__ float wsum[kWarps];
  const int P = p.P, N = p.N, Q = p.Q;
  const int ldc = N + 1;                        // padded C / B rows
  const int ldg = kTile + 1;
  float* St = smem;                             // state, [n][p]
  float* Cs = St + N * P;                       // kTile x ldc
  float* Bs = Cs + kTile * ldc;                 // kTile x ldc
  float* Xs = Bs + kTile * ldc;                 // kTile x P
  float* Gs = Xs + kTile * P;                   // kTile x ldg
  float* cum = Gs + kTile * ldg;                // Q
  float* dec = cum + Q;                         // Q

  const T* x = static_cast<const T*>(p.x);
  const T* bm = static_cast<const T*>(p.bm);
  const T* cm = static_cast<const T*>(p.cm);
  T* y = static_cast<T*>(p.y);
  const int h = blockIdx.x;
  const long long b = blockIdx.y;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int PB = P / 16, NB = N / 16;
  const int ntiles = (Q + kTile - 1) / kTile;

  for (int e = threadIdx.x; e < N * P; e += kThreads) St[e] = 0.f;

  for (int c0 = 0; c0 < p.S; c0 += Q) {
    const T* xc = x + b * p.sxb + c0 * p.sxs + h * p.sxh;
    const T* bc = bm + b * p.sbb + c0 * p.sbs;
    const T* cc = cm + b * p.scb + c0 * p.scs;
    T* yc = y + b * p.syb + c0 * p.sys + h * p.syh;

    __syncthreads();                            // last chunk's cum/dec read
    for (int t = threadIdx.x; t < Q; t += kThreads)
      cum[t] = p.a[b * p.sab + (c0 + t) * p.sas + h * p.sah];
    __syncthreads();
    block_cumsum(cum, Q, wsum);
    const float total = cum[Q - 1];

    // -- y, one 64-row query tile at a time ------------------------------
    for (int qt = 0; qt < ntiles; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();                          // Cs free
      load_rows(Cs, ldc, cc + q0 * p.scs, p.scs, Q - q0, N);
      __syncthreads();

      // incoming state: acc[i][p] = exp(cum[i]) * C[i] . state[:, p]
      float acc[kMT][kMP];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kMP; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[kMT], sv[kMP];
#pragma unroll
        for (int i = 0; i < kMT; ++i) cv[i] = Cs[(ty + 16 * i) * ldc + n];
#pragma unroll
        for (int j = 0; j < kMP; ++j)
          sv[j] = j < PB ? St[n * P + tx + 16 * j] : 0.f;
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < kMP; ++j) acc[i][j] = fmaf(cv[i], sv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int q = q0 + ty + 16 * i;
        const float e = q < Q ? expf(cum[q]) : 0.f;
#pragma unroll
        for (int j = 0; j < kMP; ++j) acc[i][j] *= e;
      }

      // within-chunk term over the key tiles at or below the diagonal
      for (int st = 0; st <= qt; ++st) {
        const int s0 = st * kTile;
        __syncthreads();                        // Bs, Xs, Gs free
        load_rows(Bs, ldc, bc + s0 * p.sbs, p.sbs, Q - s0, N);
        load_rows(Xs, P, xc + s0 * p.sxs, p.sxs, Q - s0, P);
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
            cv[i] = Cs[(ty + 16 * i) * ldc + n];
            bv[i] = Bs[(tx + 16 * i) * ldc + n];
          }
#pragma unroll
          for (int i = 0; i < kMT; ++i)
#pragma unroll
            for (int j = 0; j < kMT; ++j) g[i][j] = fmaf(cv[i], bv[j], g[i][j]);
        }
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < kMT; ++j) {
            const int q = q0 + ty + 16 * i, s = s0 + tx + 16 * j;
            // causal: only s <= q (< Q) is ever exponentiated
            Gs[(ty + 16 * i) * ldg + tx + 16 * j] =
                (s <= q && q < Q) ? g[i][j] * expf(cum[q] - cum[s]) : 0.f;
          }
        __syncthreads();
        const int jend = min(kTile, Q - s0);
        for (int jj = 0; jj < jend; ++jj) {
          float gv[kMT], xv[kMP];
#pragma unroll
          for (int i = 0; i < kMT; ++i) gv[i] = Gs[(ty + 16 * i) * ldg + jj];
#pragma unroll
          for (int j = 0; j < kMP; ++j)
            xv[j] = j < PB ? Xs[jj * P + tx + 16 * j] : 0.f;
#pragma unroll
          for (int i = 0; i < kMT; ++i)
#pragma unroll
            for (int j = 0; j < kMP; ++j) acc[i][j] = fmaf(gv[i], xv[j], acc[i][j]);
        }
      }

#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int q = q0 + ty + 16 * i;
        if (q >= Q) continue;
#pragma unroll
        for (int j = 0; j < kMP; ++j)
          if (j < PB) store_from_f32(yc + q * p.sys + tx + 16 * j, acc[i][j]);
      }
    }

    // -- state update, after every query tile has read the old state ------
    for (int t = threadIdx.x; t < Q; t += kThreads) dec[t] = expf(total - cum[t]);
    float sacc[kMN][kMP];                       // entries (ty + 16i, tx + 16j)
#pragma unroll
    for (int i = 0; i < kMN; ++i)
#pragma unroll
      for (int j = 0; j < kMP; ++j) sacc[i][j] = 0.f;
    for (int st = 0; st < ntiles; ++st) {
      const int s0 = st * kTile;
      __syncthreads();                          // Bs, Xs free; dec written
      load_rows(Bs, ldc, bc + s0 * p.sbs, p.sbs, Q - s0, N);
      load_rows(Xs, P, xc + s0 * p.sxs, p.sxs, Q - s0, P);
      __syncthreads();
      const int jend = min(kTile, Q - s0);
      for (int jj = 0; jj < jend; ++jj) {
        const float d = dec[s0 + jj];
        float bv[kMN], xv[kMP];
#pragma unroll
        for (int i = 0; i < kMN; ++i)
          bv[i] = i < NB ? Bs[jj * ldc + ty + 16 * i] * d : 0.f;
#pragma unroll
        for (int j = 0; j < kMP; ++j)
          xv[j] = j < PB ? Xs[jj * P + tx + 16 * j] : 0.f;
#pragma unroll
        for (int i = 0; i < kMN; ++i)
#pragma unroll
          for (int j = 0; j < kMP; ++j) sacc[i][j] = fmaf(bv[i], xv[j], sacc[i][j]);
      }
    }
    // every read of the old state (the query tiles' first loop) is behind
    // the barriers above, and each entry has one owner: no race
    const float et = expf(total);
#pragma unroll
    for (int i = 0; i < kMN; ++i)
#pragma unroll
      for (int j = 0; j < kMP; ++j)
        if (i < NB && j < PB) {
          float* s = St + (ty + 16 * i) * P + tx + 16 * j;
          *s = fmaf(*s, et, sacc[i][j]);
        }
  }
}

template <typename T>
cudaError_t launch_fma(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(p.P, p.N, p.Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_fma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, p.B);
  ssd_scan_fma_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// =========================================================================
// wgmma path: bf16 on the tensor cores, 64-row sub-chunks
// =========================================================================

constexpr int kWgThreads = 128;                 // one warpgroup
constexpr int kSub = 64;                        // rows per sub-chunk
constexpr int kPP = 64;                         // P, padded
constexpr float kLog2e = 1.4426950408889634f;

// PTX (cp.async, ldmatrix, wgmma, descriptors) and the 128-byte-swizzled
// tiles of C, B and x (sw_off, load_tile_sw128): hopper.cuh.  The state:
// no swizzle, core matrices row block by row block.
template <int W>
__device__ __forceinline__ int cm_off(int r, int c) {
  return ((r >> 3) * (W / 8) + (c >> 3)) * 64 + (r & 7) * 8 + (c & 7);
}

// Shared memory of the wgmma path, in bytes (see the kernel).
template <int NP>
constexpr size_t wg_smem_bytes() {
  return sizeof(bf16) * (size_t(kSub) * NP * 3 + size_t(kSub) * kPP * 2 +
                         size_t(kPP) * NP * 2 + size_t(kSub) * (kPP + 8)) +
         sizeof(float) * (2 * kSub + 3 * kSub);
}

// One CTA (one warpgroup) per (head, batch).  P is padded to 64 and N to NP
// (64 or 128), the columns past P and N zero.  Warp w owns rows 16 w .. 16 w
// + 15 of every product: query rows of y and G, state rows p of S.
template <int NP>
__global__ void __launch_bounds__(kWgThreads, 2)
ssd_scan_wgmma_kernel(const Params p) {
  constexpr int KN = NP / 16, KS = kSub / 16;   // k-steps over n and s
  constexpr int HN = NP / 64;                   // 64-column blocks of n
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  bf16* Cs = reinterpret_cast<bf16*>(wg_smem);  // 64 x NP: C of the sub-chunk
  bf16* Bs = Cs + kSub * NP;                    // 2 x (64 x NP): B, two stages
  bf16* Xs = Bs + 2 * kSub * NP;                // 2 x (64 x 64): x
  bf16* Sh = Xs + 2 * kSub * kPP;               // 64 x NP: the state, hi part
  bf16* Sl = Sh + kPP * NP;                     //          and lo part
  bf16* Ys = Sl + kPP * NP;                     // 64 x (64 + 8): y, staged
  float* As = reinterpret_cast<float*>(Ys + kSub * (kPP + 8));  // 2 x 64: a
  float* L2 = As + 2 * kSub;                    // 64: log2 local cumsum
  float* Dec = L2 + kSub;                       // 64: exp(l[63] - l[s])
  float* Eq = Dec + kSub;                       // 64: exp(l[q])

  const bf16* x = static_cast<const bf16*>(p.x);
  const bf16* bm = static_cast<const bf16*>(p.bm);
  const bf16* cm = static_cast<const bf16*>(p.cm);
  bf16* y = static_cast<bf16*>(p.y);
  const int h = blockIdx.x;
  const long long b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3;
  const int ra = 16 * warp + g, rb = ra + 8;    // this thread's rows
  const int nsub = p.S / kSub;

  const bf16* xh = x + b * p.sxb + h * p.sxh;
  const bf16* bb = bm + b * p.sbb;
  const bf16* cb = cm + b * p.scb;
  const float* ah = p.a + b * p.sab + h * p.sah;
  bf16* yh = y + b * p.syb + h * p.syh;

  auto load_c = [&](int j) {
    load_tile_sw128<NP>(Cs, cb + (long long)j * kSub * p.scs, p.scs, p.N,
                        tid, kWgThreads);
  };
  auto load_bxa = [&](int j) {                  // into stage j % 2
    const int st = j & 1;
    load_tile_sw128<NP>(Bs + st * kSub * NP,
                        bb + (long long)j * kSub * p.sbs, p.sbs, p.N, tid,
                        kWgThreads);
    load_tile_sw128<kPP>(Xs + st * kSub * kPP,
                         xh + (long long)j * kSub * p.sxs, p.sxs, p.P, tid,
                         kWgThreads);
    if (tid < kSub)
      cp_async4(As + st * kSub + tid, ah + ((long long)j * kSub + tid) * p.sas,
                true);
  };

  // the state: S (rows p, columns n) in the accumulators, S_j in Sh + Sl
  float sacc[NP / 2];
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) sacc[i] = 0.f;
  for (int e = tid; e < kPP * NP; e += kWgThreads) {
    Sh[e] = __float2bfloat16(0.f);
    Sl[e] = __float2bfloat16(0.f);
  }
  load_c(0);
  load_bxa(0);
  cp_async_commit();

  for (int j = 0; j < nsub; ++j) {
    const int st = j & 1;
    const bf16* Bj = Bs + st * kSub * NP;
    const bf16* Xj = Xs + st * kSub * kPP;
    cp_async_wait<0>();                         // sub-chunk j landed
    fence_proxy_async();                        // ... and S_j, for wgmma
    __syncthreads();

    // local cumsum of a (log2 units) and its exponentials, by warp 0
    if (warp == 0) {
      const float a0 = As[st * kSub + 2 * lane];
      const float a1 = As[st * kSub + 2 * lane + 1];
      float inc = a0 + a1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(kFull, inc, o);
        if (lane >= o) inc += up;
      }
      const float l0 = (inc - a1) * kLog2e, l1 = inc * kLog2e;
      const float tot = __shfl_sync(kFull, inc, 31) * kLog2e;
      L2[2 * lane] = l0;
      L2[2 * lane + 1] = l1;
      Dec[2 * lane] = exp2f(tot - l0);
      Dec[2 * lane + 1] = exp2f(tot - l1);
      Eq[2 * lane] = exp2f(l0);
      Eq[2 * lane + 1] = exp2f(l1);
    }
    // C of the sub-chunk into registers: the A operand of C S^T and C B^T
    uint32_t cf[KN][4];
#pragma unroll
    for (int kd = 0; kd < KN; ++kd)
      ldmatrix_x4(cf[kd], Cs + sw_off(16 * warp + (lane & 7) + (mi & 1) * 8,
                                       16 * kd + (mi >> 1) * 8));
    __syncthreads();                            // Cs read; L2, Dec, Eq ready
    if (j + 1 < nsub) {                         // stage st ^ 1 was last read
      load_c(j + 1);                            // by sub-chunk j - 1, which
      load_bxa(j + 1);                          // has ended
    }
    cp_async_commit();

    // (x o decay)^T, hi and lo: the A operand of the state update (rows p)
    uint32_t uh[KS][4], ul[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, Xj + sw_off(16 * kk + (mi >> 1) * 8 + (lane & 7),
                                       16 * warp + (mi & 1) * 8));
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int s = 16 * kk + (c >> 1) * 8 + 2 * t;
        const float2 v = unpack_bf16(r[c]);
        split_bf16(v.x * Dec[s], v.y * Dec[s + 1], uh[kk][c], ul[kk][c]);
      }
    }
    const float etot = Eq[kSub - 1];
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) sacc[i] *= etot;

    // group 1: y = C S_j^T (hi + lo) and G = C B^T; group 2: the update
    float yacc[32], gacc[32];
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < KN; ++kd)
      Wgmma<64, 0>::run(yacc, cf[kd],
                        smem_desc(Sh + kd * 128, 128, (NP / 8) * 128), kd);
#pragma unroll
    for (int kd = 0; kd < KN; ++kd)
      Wgmma<64, 0>::run(yacc, cf[kd],
                        smem_desc(Sl + kd * 128, 128, (NP / 8) * 128), 1);
#pragma unroll
    for (int kd = 0; kd < KN; ++kd)             // B K-major: 32 bytes a k-step
      Wgmma<64, 0>::run(
          gacc, cf[kd],
          smem_desc_sw128(Bj + (kd / 4) * kSub * 64 + (kd % 4) * 16, 16), kd);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)             // B N-contiguous: 16 rows a
#pragma unroll                                  // k-step
      for (int hn = 0; hn < HN; ++hn) {
        const uint64_t bd = smem_desc_sw128(Bj + hn * kSub * 64 + kk * 16 * 64,
                                            kSub * 128);
        Wgmma<64, 1>::run(cols64(sacc, hn), uh[kk], bd, 1);
        Wgmma<64, 1>::run(cols64(sacc, hn), ul[kk], bd, 1);
      }
    wgmma_commit();
    wgmma_wait<1>();                            // group 1 done
    fence_regs(yacc);
    fence_regs(gacc);
    fence_regs(cf);

    // y *= exp(l[q]); P = G o exp(l[q] - l[s]) for s <= q, hi and lo
    const float ea = Eq[ra], eb = Eq[rb];
    const float la = L2[ra], lb = L2[rb];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      yacc[4 * i] *= ea;
      yacc[4 * i + 1] *= ea;
      yacc[4 * i + 2] *= eb;
      yacc[4 * i + 3] *= eb;
    }
    uint32_t ph[KS][4], pl[KS][4];
#pragma unroll
    for (int jt = 0; jt < 8; ++jt) {
      const int s0 = 8 * jt + 2 * t;
      const float ls0 = L2[s0], ls1 = L2[s0 + 1];
      const float pa0 = s0 <= ra ? gacc[4 * jt] * exp2f(la - ls0) : 0.f;
      const float pa1 = s0 + 1 <= ra ? gacc[4 * jt + 1] * exp2f(la - ls1) : 0.f;
      const float pb0 = s0 <= rb ? gacc[4 * jt + 2] * exp2f(lb - ls0) : 0.f;
      const float pb1 = s0 + 1 <= rb ? gacc[4 * jt + 3] * exp2f(lb - ls1) : 0.f;
      split_bf16(pa0, pa1, ph[jt / 2][(jt & 1) * 2], pl[jt / 2][(jt & 1) * 2]);
      split_bf16(pb0, pb1, ph[jt / 2][(jt & 1) * 2 + 1],
                 pl[jt / 2][(jt & 1) * 2 + 1]);
    }
    // group 3: y += P x (hi + lo)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint64_t xd = smem_desc_sw128(Xj + kk * 16 * 64, kSub * 128);
      Wgmma<64, 1>::run(yacc, ph[kk], xd, 1);
      Wgmma<64, 1>::run(yacc, pl[kk], xd, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(yacc);
    fence_regs(sacc);
    fence_regs(uh);
    fence_regs(ul);
    fence_regs(ph);
    fence_regs(pl);

    // y of the sub-chunk: staged in shared memory (rows padded by 16
    // bytes, so the accumulator layout writes it without bank conflicts),
    // then stored 16 bytes a thread, whole rows per 8 threads
    constexpr int YS = kPP + 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = 8 * i + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(Ys + ra * YS + col) =
          __floats2bfloat162_rn(yacc[4 * i], yacc[4 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(Ys + rb * YS + col) =
          __floats2bfloat162_rn(yacc[4 * i + 2], yacc[4 * i + 3]);
    }
    __syncthreads();                            // Ys written; S_j read
    bf16* yj = yh + (long long)j * kSub * p.sys;
    for (int e = tid; e < kSub * 8; e += kWgThreads) {
      const int r = e / 8, c = (e % 8) * 8;
      if (c < p.P)
        *reinterpret_cast<uint4*>(yj + r * p.sys + c) =
            *reinterpret_cast<const uint4*>(Ys + r * YS + c);
    }
    // S_{j+1} into Sh + Sl
#pragma unroll
    for (int i = 0; i < NP / 8; ++i) {
      const int col = 8 * i + 2 * t;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int row = u ? rb : ra;
        uint32_t hi, lo;
        split_bf16(sacc[4 * i + 2 * u], sacc[4 * i + 2 * u + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(Sh + cm_off<NP>(row, col)) = hi;
        *reinterpret_cast<uint32_t*>(Sl + cm_off<NP>(row, col)) = lo;
      }
    }
  }
}

template <int NP>
cudaError_t launch_wgmma_n(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = wg_smem_bytes<NP>();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_wgmma_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_scan_wgmma_kernel<NP>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, p.B);
  ssd_scan_wgmma_kernel<NP><<<grid, kWgThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_wgmma(const Params& p, cudaStream_t stream) {
  return p.N <= 64 ? launch_wgmma_n<64>(p, stream)
                   : launch_wgmma_n<128>(p, stream);
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// What the wgmma path needs beyond the common limits: bf16, whole
// sub-chunks in every chunk, and 16-byte aligned rows of x, B, C and y.
bool wgmma_takes(const Params& p, int dtype) {
  bool ok = dtype == 1 && p.Q % kSub == 0 && aligned16(p.x) &&
            aligned16(p.bm) && aligned16(p.cm) && aligned16(p.y);
  for (long long s : {p.sxb, p.sxs, p.sxh, p.sbb, p.sbs, p.scb, p.scs,
                      p.syb, p.sys, p.syh})
    ok = ok && s % 8 == 0;
  return ok;
}

}  // namespace

// path: 0 = fma, 1 = wgmma (the wrapper's choice).  dtype (of xdt, B, C
// and y): 0 = float32, 1 = bfloat16; a is float32.  P and N are multiples
// of 16, at most 64 and 128; S % Q == 0; the wgmma path also needs bf16,
// Q % 64 == 0 and 16-byte aligned rows.  Returns a cudaError_t (0 =
// launched); a path that cannot take the call is cudaErrorInvalidValue.
extern "C" int ssd_scan_fwd(
    const void* x, const float* a, const void* bm, const void* cm, void* y,
    int path, int dtype, int B, int S, int H, int P, int N, int Q,
    long long sxb, long long sxs, long long sxh, long long sab, long long sas,
    long long sah, long long sbb, long long sbs, long long scb, long long scs,
    long long syb, long long sys, long long syh, void* stream) {
  if (B < 0 || B > 65535 || H < 0 || S < 0 || Q <= 0 || S % Q != 0 ||
      P <= 0 || P > kMaxP || P % 16 != 0 || N <= 0 || N > kMaxN ||
      N % 16 != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, a, bm, cm, y, B, S, H, P, N, Q, sxb, sxs, sxh, sab, sas, sah,
           sbb, sbs, scb, scs, syb, sys, syh};
  if (path == kWgmma ? !wgmma_takes(p, dtype) : path != kFma)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = path == kWgmma ? launch_wgmma(p, s)
                  : dtype == 0     ? launch_fma<float>(p, s)
                                   : launch_fma<bf16>(p, s);
  return static_cast<int>(err);
}
