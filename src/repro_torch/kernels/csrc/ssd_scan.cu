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
// s > q is never exponentiated.  Inputs are f32 or bf16 (a is f32),
// computed in fp32 (no TF32); y comes back in xdt's dtype.  The kernel takes
// the model's layout through strides -- xdt and y (B, S, H, P), a (B, S, H),
// B and C (B, S, N), each with its last dim contiguous -- so there is no
// transpose copy around the call.
//
// What bounds it on the card: at the serving path's bf16 shapes (B=16,
// S=1024, H=32, P=64, N=128, Q=256) the bytes.  xdt and y are 134 MB, a and
// B/C 10.5 MB: ~145 MB is ~43 us at 3.35 TB/s, against ~26 GFLOP (~26 us at
// the bf16 tensor-core peak).  This first version runs its products as fp32
// FMAs on the CUDA cores, so it is operations-bound instead: ~0.4 ms at
// 67 TFLOP/s even at full rate, more since it recomputes G = C B^T per head.
//
// Design.  The TPU grid's sequential chunk axis becomes a loop inside one
// CTA per (b, h) (B*H CTAs: 512 at the path's shapes over 132 SMs), which
// holds the state (P, N) in shared memory across the loop (32 KB at
// 64 x 128).  The Pallas kernel's (Q, Q) fp32 score block is 256 KB at
// Q = 256 and does not fit in 227 KB of shared memory, so the within-chunk
// term is tiled: 64-row query tiles x 64-row key tiles, only tiles on or
// below the diagonal (s <= q), each tile's G = C B^T formed in shared
// memory, decayed and masked, then multiplied into the query tile's y
// accumulators, which live in registers (a 16 x 16 thread grid, 4 x 4 per
// thread).  The in-chunk cumsum is a block scan in shared memory.  The
// state update runs after every query tile of the chunk has read the old
// state; each thread owns a fixed (n, p) set of state entries.
//
// Later work (see ROADMAP): tensor cores (mma/wgmma on bf16 tiles) for the
// three products, G computed once per (b, chunk) and shared by the heads,
// TMA loads, and splitting the chunk loop across CTAs (a second pass that
// carries the chunk states) when B*H is small against the SM count.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;                   // a 16 x 16 thread grid
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                       // rows per query / key tile
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kMT = kTile / 16;                 // tile rows per thread
constexpr int kMP = kMaxP / 16;                 // head dims per thread
constexpr int kMN = kMaxN / 16;                 // state dims per thread
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float x) {
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
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(const Params p) {
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
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(p.P, p.N, p.Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, p.B);
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype (of xdt, B, C and y): 0 = float32, 1 = bfloat16; a is float32.
// P and N are multiples of 16, at most 64 and 128; S % Q == 0.  Returns a
// cudaError_t (0 = launched).
extern "C" int ssd_scan_fwd(
    const void* x, const float* a, const void* bm, const void* cm, void* y,
    int dtype, int B, int S, int H, int P, int N, int Q, long long sxb,
    long long sxs, long long sxh, long long sab, long long sas, long long sah,
    long long sbb, long long sbs, long long scb, long long scs, long long syb,
    long long sys, long long syh, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (B < 0 || B > 65535 || H < 0 || Q <= 0 || S % Q != 0 || P <= 0 ||
      P > kMaxP || P % 16 != 0 || N <= 0 || N > kMaxN || N % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, a, bm, cm, y, B, S, H, P, N, Q, sxb, sxs, sxh, sab, sas, sah,
           sbb, sbs, scb, scs, syb, sys, syh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? launch<float>(p, s)
                  : dtype == 1 ? launch<__nv_bfloat16>(p, s)
                               : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
