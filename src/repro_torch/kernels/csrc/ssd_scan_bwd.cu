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
// peak, 0.13 ms at 3.35 TB/s).  This first version is simple and right
// rather than fast: every product is fp32 FMAs on the CUDA cores (bf16
// inputs are widened on load, so both dtypes accumulate in fp32), which
// puts it near ~3 ms even at the full fp32 FMA rate.  Seven launches, each
// a plain tiled loop:
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
// The per-head dB / dC partials (B, H, S, N) and the states (B, H, S/Q, P,
// N) live in one fp32 workspace that the wrapper allocates (~1.4 GB at the
// training shape, transient).  Tensor cores, TMA and a single pass are
// later work (ROADMAP).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

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
};

long long round4(long long n) { return (n + 3) / 4 * 4; }

// Floats of workspace for a call, in the order ssd_scan_bwd takes them.
long long workspace_floats(int B, int S, int H, int P, int N, int Q) {
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
cudaError_t launch(const Params& p, cudaStream_t stream) {
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

}  // namespace

// dtype (of x, B, C, dy, dx, dB and dC): 0 = float32, 1 = bfloat16; a and da are float32.  Takes what the forward
// takes: P and N multiples of 16, at most 64 and 128; S % Q == 0 (and Q at
// most 4096); B, H and the chunk count at most 65535.  Inputs by strides
// with a contiguous last dim; outputs contiguous.  ws holds ws_floats
// floats, at least workspace_floats(...).  Returns a cudaError_t (0 =
// launched); a call it cannot take is cudaErrorInvalidValue.
extern "C" int ssd_scan_bwd(
    const void* x, const float* a, const void* bm, const void* cm,
    const void* dy, void* dx, float* da, void* dbm, void* dcm, float* ws,
    long long ws_floats, int dtype, int B, int S, int H, int P,
    int N, int Q, long long sxb, long long sxs, long long sxh, long long sab,
    long long sas, long long sah, long long sbb, long long sbs, long long scb,
    long long scs, long long sgb, long long sgs, long long sgh,
    void* stream) {
  if (B < 0 || B > 65535 || H < 0 || H > 65535 || S < 0 ||
      Q <= 0 || Q > kMaxQ || S % Q != 0 || S / Q > 65535 || P <= 0 ||
      P > kMaxP || P % 16 != 0 || N <= 0 || N > kMaxN || N % 16 != 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (ws_floats < workspace_floats(B, S, H, P, N, Q))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || H == 0) return 0;
  const int nc = S / Q, nt = (Q + kTile - 1) / kTile;
  const long long bh = static_cast<long long>(B) * H;
  Params p{x, a, bm, cm, dy, dx, da, dbm, dcm, B, S, H, P, N, Q, nc, nt,
           sxb, sxs, sxh, sab, sas, sah, sbb, sbs, scb, scs, sgb, sgs, sgh};
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 0 ? launch<float>(p, s) : launch<bf16>(p, s));
}

// The fp32 workspace ssd_scan_bwd needs for these shapes (the wrapper
// allocates it); 0 for a chunk that is not positive or a negative size.
extern "C" long long ssd_scan_bwd_workspace_floats(int B, int S, int H,
                                                   int P, int N, int Q) {
  if (B < 0 || H < 0 || S < 0 || P < 0 || N < 0 || Q <= 0) return 0;
  return workspace_floats(B, S, H, P, N, Q);
}
