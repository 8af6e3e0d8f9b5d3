// The Mamba-2 SSD (state-space duality) chunked scan and its reverse scan,
// float32 math on the CUDA cores.
//
// 1. ssd_fwd replaces the Pallas kernel `ssd` (src/repro/kernels/ssd/
//    kernel.py:120, body `_ssd_body` :25, with and without the per-chunk
//    states `_ssd_kernel_states` :79), which every mamba2 layer runs in its
//    forward, its remat recompute and the states sweep of its backward.
//    It reads the model's layouts as they are: x (Bt,S,H,P) float32 or
//    bf16 with any strides but a unit last one (the in_proj slice), dt
//    (Bt,S,H) float32, A (H,), B and C (Bt,S,N) float32 (one group shared
//    by every head). xdt = x dt and a = dt A are formed here, the float32
//    products of exact upcasts that the JAX wrapper forms before its kernel
//    (ops.py:33), so there is no (Bt,H,S,P) float32 copy of x. It writes y
//    (Bt,S,H,P) in x's type (one rounding of the float32 result), the final
//    state (Bt,H,P,N) float32 and, when `states` is not null, the state
//    entering each chunk (Bt,H,S/L,P,N) float32, the backward's residual.
//    The Pallas grid (Bt*H, S/L) runs its chunk axis in order on one core
//    with h in VMEM. Here one CTA per (head, batch row) walks the chunks in
//    a loop, with h (P x N float32, 32 KB at P=64, N=128) in shared memory
//    beside the chunk's tiles: B and C (L x N), xdt (L x P), the L x L
//    decay-weighted C B^T and cs (the inclusive cumsum of a). Per chunk:
//      y  = (C B^T o decay) xdt + exp(cs) o (C h^T)
//      h <- exp(cs_L) h + (xdt o w)^T B,   w = exp(cs_L - cs)
//    The decay exp(cs_t - cs_s) is evaluated only where t >= s: above the
//    diagonal it can overflow to inf (A reaches -16 in mamba2-780m, so 63
//    steps of dt A can pass 88), and only a select before the exp keeps
//    the backward free of 0 * inf.
//
// 2. ssd_bwd replaces the Pallas kernel `ssd_bwd` (src/repro/kernels/ssd/
//    backward.py:123, body `_ssd_bwd_kernel` :35). One CTA per (head, batch
//    row) walks the chunks in reverse with dh (P x N float32) in shared
//    memory, seeded from dh_final (zeros when it is null). Per chunk it
//    recomputes cs, e = exp(cs), w, the decay, C B^T and dy xdt^T from the
//    inputs and the chunk's incoming state, and writes dxdt, da, dB and dC
//    by the equations of backward.py:10-18, da's reverse cumsum taken
//    directly from the last row with the cs_L terms folded into it
//    (backward.py:84-90). dxdt (Bt,S,H,P), da (Bt,S,H), and dB and dC per
//    head (Bt,S,H,N), all float32; the caller sums dB and dC over the heads
//    and chains dxdt and da to dx, ddt and dA, as the JAX wrapper does
//    (ops.py:89-99).
//
// Both kernels: 256 threads as a 16 x 16 grid, each thread a register tile
// of every product (rows r = ty + 16 i, columns c = tx + 16 j); every shared
// tile has a row stride of one word over a multiple of 32, so walks along
// a row and down a column are both free of bank conflicts. Rows past S
// (the ragged last chunk, or S < L) are staged as zeros (a = 0, xdt = 0,
// B = C = dy = 0): the exact padding of the JAX wrapper, with no pad pass.
// Every sum runs in one fixed order and nothing is atomic, so two launches
// give the same bits and a row's result never depends on its batch.
// What bounds them on an H100, at the training shape (Bt=8, S=1024, H=48,
// P=64, N=128, L=64): the forward does 3.67 MFLOP a chunk and head-row
// (C B^T, its product with xdt, C h^T, the state update), 22.5 GFLOP in
// all against 123 MB moved (324 MB with the states); the backward 10.5
// MFLOP a chunk (ten products, 64.4 GFLOP) against 829 MB. Both are bound
// by operations: 0.34 and 0.96 ms at 67 TFLOP/s on the float32 CUDA
// cores, where every product here runs; on the TF32 tensor cores the
// floors would be 0.05 and 0.25 ms, a later redesign.
//
// Every C entry returns cudaGetLastError() after its launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr int SSD_THREADS = 256;  // a 16 x 16 thread grid
constexpr int SSD_MAX_DEVICES = 64;

// Row strides (floats) of the shared tiles: one word over the width.
template <int L, int P, int N>
struct Dims {
  static constexpr int LS = L + 1, PS = P + 1, NS = N + 1;
  static constexpr int RL = L / 16, RP = P / 16, RN = N / 16;
  static_assert(L % 16 == 0 && P % 16 == 0 && N % 16 == 0, "tile widths");
  static_assert(2 * L <= SSD_THREADS, "one thread per row and column sum");
};

template <int L, int P, int N>
constexpr size_t fwd_smem_floats() {
  using D = Dims<L, P, N>;
  // h, B, C, xdt, the decay-weighted C B^T, then cs, exp(cs), w
  return (size_t)P * D::NS + 2 * (size_t)L * D::NS + (size_t)L * D::PS +
         (size_t)L * D::LS + 3 * L;
}

template <int L, int P, int N>
constexpr size_t bwd_smem_floats() {
  using D = Dims<L, P, N>;
  // xdt, dy; B, C; h_in, dh; G = decay C B^T, DD = decay dy xdt^T, E;
  // cs, e, w, rowsum(E), colsum(E), de, dw, dcs; a block-reduction slot
  return 2 * (size_t)L * D::PS + 2 * (size_t)L * D::NS +
         2 * (size_t)P * D::NS + 3 * (size_t)L * D::LS + 8 * L + SSD_THREADS;
}

// Stage one chunk's rows of B and C (zeros past S).
template <int L, int N>
__device__ __forceinline__ void stage_bc(float* Bs, float* Cs,
                                         const float* __restrict__ Bg,
                                         const float* __restrict__ Cg,
                                         int t0, int S, int64_t bs_s,
                                         int64_t cs_s) {
  constexpr int NS = N + 1;
  for (int i = threadIdx.x; i < L * N; i += SSD_THREADS) {
    const int r = i / N, n = i % N, t = t0 + r;
    Bs[r * NS + n] = t < S ? Bg[t * bs_s + n] : 0.f;
    Cs[r * NS + n] = t < S ? Cg[t * cs_s + n] : 0.f;
  }
}

// Stage one chunk's xdt = x dt (zeros past S).
template <typename T, int L, int P>
__device__ __forceinline__ void stage_xdt(float* Xs, const T* __restrict__ xg,
                                          const float* __restrict__ dtg,
                                          int t0, int S, int64_t xs_s,
                                          int64_t ds_s) {
  constexpr int PS = P + 1;
  for (int i = threadIdx.x; i < L * P; i += SSD_THREADS) {
    const int r = i / P, p = i % P, t = t0 + r;
    Xs[r * PS + p] = t < S ? to_f(xg[t * xs_s + p]) * dtg[t * ds_s] : 0.f;
  }
}

// Thread 0: cs = the inclusive cumsum of a = dt A over the chunk (0 past
// S), in row order.
template <int L>
__device__ __forceinline__ void chunk_cumsum(float* cs,
                                             const float* __restrict__ dtg,
                                             float Ah, int t0, int S,
                                             int64_t ds_s) {
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int r = 0; r < L; ++r) {
      const int t = t0 + r;
      acc += t < S ? dtg[t * ds_s] * Ah : 0.f;
      cs[r] = acc;
    }
  }
}

// Sum over the 16 threads of a half-warp (the tx of one ty), butterfly in
// a fixed order; every thread of the half-warp gets the sum.
__device__ __forceinline__ float half_warp_sum(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ------------------------------------------------------------------ forward
template <typename T, int L, int P, int N>
__global__ void __launch_bounds__(SSD_THREADS)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bg,
               const float* __restrict__ Cg, T* __restrict__ y,
               float* __restrict__ h_final, float* __restrict__ states,
               int S, int H, int64_t xs_b, int64_t xs_s, int64_t xs_h,
               int64_t ds_b, int64_t ds_s, int64_t bs_b, int64_t bs_s,
               int64_t cs_b, int64_t cs_s) {
  using D = Dims<L, P, N>;
  constexpr int LS = D::LS, PS = D::PS, NS = D::NS;
  constexpr int RL = D::RL, RP = D::RP, RN = D::RN;
  extern __shared__ float smem[];
  float* hs = smem;              // (P, NS)  the state h[p][n]
  float* Bs = hs + P * NS;       // (L, NS)
  float* Cs = Bs + L * NS;       // (L, NS)
  float* Xs = Cs + L * NS;       // (L, PS)  xdt
  float* Ms = Xs + L * PS;       // (L, LS)  C B^T o decay
  float* cs = Ms + L * LS;       // (L)
  float* ev = cs + L;            // exp(cs)
  float* wv = ev + L;            // exp(cs_L - cs)

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int h = blockIdx.x, b = blockIdx.y;
  const int nc = (S + L - 1) / L;
  const float Ah = A[h];
  const T* xg = x + b * xs_b + h * xs_h;
  const float* dtg = dt + b * ds_b + h;
  const float* Bgb = Bg + b * bs_b;
  const float* Cgb = Cg + b * cs_b;
  T* yg = y + ((int64_t)b * S * H + h) * P;
  const size_t bh = (size_t)b * H + h;

  for (int i = tid; i < P * N; i += SSD_THREADS) hs[(i / N) * NS + i % N] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * L;
    stage_bc<L, N>(Bs, Cs, Bgb, Cgb, t0, S, bs_s, cs_s);
    stage_xdt<T, L, P>(Xs, xg, dtg, t0, S, xs_s, ds_s);
    chunk_cumsum<L>(cs, dtg, Ah, t0, S, ds_s);
    if (states != nullptr) {     // the state entering the chunk
      float* st = states + (bh * nc + c) * (size_t)(P * N);
      for (int i = tid; i < P * N; i += SSD_THREADS)
        st[i] = hs[(i / N) * NS + i % N];
    }
    __syncthreads();
    const float csL = cs[L - 1];
    for (int r = tid; r < L; r += SSD_THREADS) {
      ev[r] = expf(cs[r]);
      wv[r] = expf(csL - cs[r]);
    }
    // M[t][s] = (C_t . B_s) exp(cs_t - cs_s) where t >= s, else 0
    {
      float acc[RL][RL] = {};
      for (int n = 0; n < N; ++n) {
        float cv[RL], bv[RL];
#pragma unroll
        for (int i = 0; i < RL; ++i) cv[i] = Cs[(ty + 16 * i) * NS + n];
#pragma unroll
        for (int j = 0; j < RL; ++j) bv[j] = Bs[(tx + 16 * j) * NS + n];
#pragma unroll
        for (int i = 0; i < RL; ++i)
#pragma unroll
          for (int j = 0; j < RL; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RL; ++i)
#pragma unroll
        for (int j = 0; j < RL; ++j) {
          const int t = ty + 16 * i, s = tx + 16 * j;
          Ms[t * LS + s] = t >= s ? acc[i][j] * expf(cs[t] - cs[s]) : 0.f;
        }
    }
    __syncthreads();
    // y[t][p] = sum_s M[t][s] xdt[s][p] + exp(cs_t) sum_n C[t][n] h[p][n]
    {
      float yi[RL][RP] = {}, yh[RL][RP] = {};
      for (int s = 0; s < L; ++s) {
        float mv[RL], xv[RP];
#pragma unroll
        for (int i = 0; i < RL; ++i) mv[i] = Ms[(ty + 16 * i) * LS + s];
#pragma unroll
        for (int j = 0; j < RP; ++j) xv[j] = Xs[s * PS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RL; ++i)
#pragma unroll
          for (int j = 0; j < RP; ++j) yi[i][j] = fmaf(mv[i], xv[j], yi[i][j]);
      }
      for (int n = 0; n < N; ++n) {
        float cv[RL], hv[RP];
#pragma unroll
        for (int i = 0; i < RL; ++i) cv[i] = Cs[(ty + 16 * i) * NS + n];
#pragma unroll
        for (int j = 0; j < RP; ++j) hv[j] = hs[(tx + 16 * j) * NS + n];
#pragma unroll
        for (int i = 0; i < RL; ++i)
#pragma unroll
          for (int j = 0; j < RP; ++j) yh[i][j] = fmaf(cv[i], hv[j], yh[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RL; ++i) {
        const int t = t0 + ty + 16 * i;
        if (t >= S) continue;
#pragma unroll
        for (int j = 0; j < RP; ++j)
          yg[(int64_t)t * H * P + tx + 16 * j] =
              from_f<T>(yi[i][j] + ev[ty + 16 * i] * yh[i][j]);
      }
    }
    __syncthreads();             // every read of h is done
    // h[p][n] = exp(cs_L) h[p][n] + sum_s (xdt[s][p] w[s]) B[s][n]
    {
      float acc[RP][RN] = {};
      for (int s = 0; s < L; ++s) {
        float xv[RP], bv[RN];
        const float ws = wv[s];
#pragma unroll
        for (int i = 0; i < RP; ++i) xv[i] = Xs[s * PS + ty + 16 * i] * ws;
#pragma unroll
        for (int j = 0; j < RN; ++j) bv[j] = Bs[s * NS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RP; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
      }
      const float dL = expf(csL);
#pragma unroll
      for (int i = 0; i < RP; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          float* hp = hs + (ty + 16 * i) * NS + tx + 16 * j;
          *hp = dL * *hp + acc[i][j];
        }
    }
    __syncthreads();             // h is whole before the next chunk
  }
  float* hf = h_final + bh * (size_t)(P * N);
  for (int i = tid; i < P * N; i += SSD_THREADS) hf[i] = hs[(i / N) * NS + i % N];
}

// ----------------------------------------------------------------- backward
template <typename T, int L, int P, int N>
__global__ void __launch_bounds__(SSD_THREADS)
ssd_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bg,
               const float* __restrict__ Cg, const T* __restrict__ dy,
               const float* __restrict__ states,
               const float* __restrict__ dh_final, float* __restrict__ dxdt,
               float* __restrict__ da, float* __restrict__ dBh,
               float* __restrict__ dCh, int S, int H, int64_t xs_b,
               int64_t xs_s, int64_t xs_h, int64_t ds_b, int64_t ds_s,
               int64_t bs_b, int64_t bs_s, int64_t cs_b, int64_t cs_s,
               int64_t ys_b, int64_t ys_s, int64_t ys_h) {
  using D = Dims<L, P, N>;
  constexpr int LS = D::LS, PS = D::PS, NS = D::NS;
  constexpr int RL = D::RL, RP = D::RP, RN = D::RN;
  extern __shared__ float smem[];
  float* Xs = smem;              // (L, PS)  xdt
  float* Ys = Xs + L * PS;       // (L, PS)  dy
  float* Bs = Ys + L * PS;       // (L, NS)
  float* Cs = Bs + L * NS;       // (L, NS)
  float* Hs = Cs + L * NS;       // (P, NS)  h_in, the state entering
  float* dHs = Hs + P * NS;      // (P, NS)  dh, carried
  float* Gs = dHs + P * NS;      // (L, LS)  decay o C B^T
  float* DDs = Gs + L * LS;      // (L, LS)  decay o dy xdt^T
  float* Es = DDs + L * LS;      // (L, LS)  DD o C B^T
  float* cs = Es + L * LS;       // (L)
  float* ev = cs + L;            // exp(cs)
  float* wv = ev + L;            // exp(cs_L - cs)
  float* r1 = wv + L;            // rowsum(E)
  float* c1 = r1 + L;            // colsum(E)
  float* de = c1 + L;            // <dy, y_inter> per row
  float* dw = de + L;            // w <xdt, B dh^T> per row
  float* dcs = dw + L;
  float* red = dcs + L;          // (SSD_THREADS)

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int h = blockIdx.x, b = blockIdx.y;
  const int nc = (S + L - 1) / L;
  const float Ah = A[h];
  const T* xg = x + b * xs_b + h * xs_h;
  const T* yg = dy + b * ys_b + h * ys_h;
  const float* dtg = dt + b * ds_b + h;
  const float* Bgb = Bg + b * bs_b;
  const float* Cgb = Cg + b * cs_b;
  const size_t bh = (size_t)b * H + h;
  // output rows of this (b, h): (Bt, S, H, ·)
  float* dxg = dxdt + ((int64_t)b * S * H + h) * P;
  float* dBg = dBh + ((int64_t)b * S * H + h) * N;
  float* dCg = dCh + ((int64_t)b * S * H + h) * N;
  float* dag = da + (int64_t)b * S * H + h;

  for (int i = tid; i < P * N; i += SSD_THREADS)
    dHs[(i / N) * NS + i % N] =
        dh_final != nullptr ? dh_final[bh * (size_t)(P * N) + i] : 0.f;

  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * L;
    stage_bc<L, N>(Bs, Cs, Bgb, Cgb, t0, S, bs_s, cs_s);
    stage_xdt<T, L, P>(Xs, xg, dtg, t0, S, xs_s, ds_s);
    for (int i = tid; i < L * P; i += SSD_THREADS) {
      const int r = i / P, p = i % P, t = t0 + r;
      Ys[r * PS + p] = t < S ? to_f(yg[t * ys_s + p]) : 0.f;
    }
    {
      const float* st = states + (bh * nc + c) * (size_t)(P * N);
      for (int i = tid; i < P * N; i += SSD_THREADS)
        Hs[(i / N) * NS + i % N] = st[i];
    }
    chunk_cumsum<L>(cs, dtg, Ah, t0, S, ds_s);
    __syncthreads();
    const float csL = cs[L - 1];
    for (int r = tid; r < L; r += SSD_THREADS) {
      ev[r] = expf(cs[r]);
      wv[r] = expf(csL - cs[r]);
    }
    // G = decay o C B^T, DD = decay o dy xdt^T, E = DD o C B^T (t, s)
    {
      float cb[RL][RL] = {}, yx[RL][RL] = {};
      for (int n = 0; n < N; ++n) {
        float cv[RL], bv[RL];
#pragma unroll
        for (int i = 0; i < RL; ++i) cv[i] = Cs[(ty + 16 * i) * NS + n];
#pragma unroll
        for (int j = 0; j < RL; ++j) bv[j] = Bs[(tx + 16 * j) * NS + n];
#pragma unroll
        for (int i = 0; i < RL; ++i)
#pragma unroll
          for (int j = 0; j < RL; ++j) cb[i][j] = fmaf(cv[i], bv[j], cb[i][j]);
      }
      for (int p = 0; p < P; ++p) {
        float yv[RL], xv[RL];
#pragma unroll
        for (int i = 0; i < RL; ++i) yv[i] = Ys[(ty + 16 * i) * PS + p];
#pragma unroll
        for (int j = 0; j < RL; ++j) xv[j] = Xs[(tx + 16 * j) * PS + p];
#pragma unroll
        for (int i = 0; i < RL; ++i)
#pragma unroll
          for (int j = 0; j < RL; ++j) yx[i][j] = fmaf(yv[i], xv[j], yx[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RL; ++i)
#pragma unroll
        for (int j = 0; j < RL; ++j) {
          const int t = ty + 16 * i, s = tx + 16 * j;
          const float dec = t >= s ? expf(cs[t] - cs[s]) : 0.f;
          const float dd = dec * yx[i][j];
          Gs[t * LS + s] = dec * cb[i][j];
          DDs[t * LS + s] = dd;
          Es[t * LS + s] = dd * cb[i][j];
        }
    }
    __syncthreads();
    if (tid < L) {                          // rowsum(E)
      float acc = 0.f;
      for (int s = 0; s < L; ++s) acc += Es[tid * LS + s];
      r1[tid] = acc;
    } else if (tid < 2 * L) {               // colsum(E)
      const int s = tid - L;
      float acc = 0.f;
      for (int t = 0; t < L; ++t) acc += Es[t * LS + s];
      c1[s] = acc;
    }
    // rows r of L, columns p of P:
    //   dxdt[r][p] = sum_t G[t][r] dy[t][p] + w[r] (B dh^T)[r][p]
    //   dw[r] = w[r] sum_p xdt[r][p] (B dh^T)[r][p]
    //   de[r] = sum_p dy[r][p] exp(cs_r) (C h_in^T)[r][p]
    {
      float g[RL][RP] = {}, v[RL][RP] = {}, yh[RL][RP] = {};
      for (int t = 0; t < L; ++t) {
        float gv[RL], yv[RP];
#pragma unroll
        for (int i = 0; i < RL; ++i) gv[i] = Gs[t * LS + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < RP; ++j) yv[j] = Ys[t * PS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RL; ++i)
#pragma unroll
          for (int j = 0; j < RP; ++j) g[i][j] = fmaf(gv[i], yv[j], g[i][j]);
      }
      for (int n = 0; n < N; ++n) {
        float bv[RL], cv[RL], dv[RP], hv[RP];
#pragma unroll
        for (int i = 0; i < RL; ++i) {
          bv[i] = Bs[(ty + 16 * i) * NS + n];
          cv[i] = Cs[(ty + 16 * i) * NS + n];
        }
#pragma unroll
        for (int j = 0; j < RP; ++j) {
          dv[j] = dHs[(tx + 16 * j) * NS + n];
          hv[j] = Hs[(tx + 16 * j) * NS + n];
        }
#pragma unroll
        for (int i = 0; i < RL; ++i)
#pragma unroll
          for (int j = 0; j < RP; ++j) {
            v[i][j] = fmaf(bv[i], dv[j], v[i][j]);
            yh[i][j] = fmaf(cv[i], hv[j], yh[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < RL; ++i) {
        const int r = ty + 16 * i, t = t0 + r;
        float pw = 0.f, pe = 0.f;
#pragma unroll
        for (int j = 0; j < RP; ++j) {
          const int p = tx + 16 * j;
          pw = fmaf(Xs[r * PS + p], v[i][j], pw);
          pe = fmaf(Ys[r * PS + p], ev[r] * yh[i][j], pe);
          if (t < S) dxg[(int64_t)t * H * P + p] = g[i][j] + wv[r] * v[i][j];
        }
        pw = half_warp_sum(pw);
        pe = half_warp_sum(pe);
        if (tx == 0) {
          dw[r] = pw * wv[r];
          de[r] = pe;
        }
      }
    }
    // rows t of L, columns n of N:
    //   dC[t][n] = sum_s DD[t][s] B[s][n] + e[t] sum_p dy[t][p] h_in[p][n]
    {
      float a1[RL][RN] = {}, a2[RL][RN] = {};
      for (int s = 0; s < L; ++s) {
        float dv[RL], bv[RN];
#pragma unroll
        for (int i = 0; i < RL; ++i) dv[i] = DDs[(ty + 16 * i) * LS + s];
#pragma unroll
        for (int j = 0; j < RN; ++j) bv[j] = Bs[s * NS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RL; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) a1[i][j] = fmaf(dv[i], bv[j], a1[i][j]);
      }
      for (int p = 0; p < P; ++p) {
        float yv[RL], hv[RN];
#pragma unroll
        for (int i = 0; i < RL; ++i) yv[i] = Ys[(ty + 16 * i) * PS + p];
#pragma unroll
        for (int j = 0; j < RN; ++j) hv[j] = Hs[p * NS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RL; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) a2[i][j] = fmaf(yv[i], hv[j], a2[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RL; ++i) {
        const int r = ty + 16 * i, t = t0 + r;
        if (t >= S) continue;
#pragma unroll
        for (int j = 0; j < RN; ++j)
          dCg[(int64_t)t * H * N + tx + 16 * j] = a1[i][j] + ev[r] * a2[i][j];
      }
    }
    // rows s of L, columns n of N:
    //   dB[s][n] = sum_t DD[t][s] C[t][n] + sum_p (w[s] xdt[s][p]) dh[p][n]
    {
      float a1[RL][RN] = {}, a2[RL][RN] = {};
      for (int t = 0; t < L; ++t) {
        float dv[RL], cv[RN];
#pragma unroll
        for (int i = 0; i < RL; ++i) dv[i] = DDs[t * LS + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < RN; ++j) cv[j] = Cs[t * NS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RL; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) a1[i][j] = fmaf(dv[i], cv[j], a1[i][j]);
      }
      for (int p = 0; p < P; ++p) {
        float xv[RL], dv[RN];
#pragma unroll
        for (int i = 0; i < RL; ++i) {
          const int s = ty + 16 * i;
          xv[i] = wv[s] * Xs[s * PS + p];
        }
#pragma unroll
        for (int j = 0; j < RN; ++j) dv[j] = dHs[p * NS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RL; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) a2[i][j] = fmaf(xv[i], dv[j], a2[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RL; ++i) {
        const int t = t0 + ty + 16 * i;
        if (t >= S) continue;
#pragma unroll
        for (int j = 0; j < RN; ++j)
          dBg[(int64_t)t * H * N + tx + 16 * j] = a1[i][j] + a2[i][j];
      }
    }
    __syncthreads();             // every read of dh is done
    // dh[p][n] = exp(cs_L) dh[p][n] + sum_t (e[t] dy[t][p]) C[t][n], and
    // this thread's share of <h_in, dh> before the update
    {
      float acc[RP][RN] = {};
      for (int t = 0; t < L; ++t) {
        float yv[RP], cv[RN];
        const float et = ev[t];
#pragma unroll
        for (int i = 0; i < RP; ++i) yv[i] = et * Ys[t * PS + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < RN; ++j) cv[j] = Cs[t * NS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RP; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(yv[i], cv[j], acc[i][j]);
      }
      const float dL = expf(csL);
      float hd = 0.f;
#pragma unroll
      for (int i = 0; i < RP; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const int o = (ty + 16 * i) * NS + tx + 16 * j;
          hd = fmaf(Hs[o], dHs[o], hd);
          dHs[o] = dL * dHs[o] + acc[i][j];
        }
      red[tid] = hd;
    }
    __syncthreads();
    // da[r] = sum_{t >= r} dcs[t], the cs_L terms folded into the last row
    if (tid == 0) {
      float hd = 0.f, dws = 0.f;
      for (int i = 0; i < SSD_THREADS; ++i) hd += red[i];
      for (int r = 0; r < L; ++r) {
        dcs[r] = r1[r] - c1[r] + de[r] - dw[r];
        dws += dw[r];
      }
      dcs[L - 1] += dws + expf(csL) * hd;
      float acc = 0.f;
      for (int r = L - 1; r >= 0; --r) {
        acc += dcs[r];
        const int t = t0 + r;
        if (t < S) dag[(int64_t)t * H] = acc;
      }
    }
    __syncthreads();             // the chunk's tiles are free again
  }
}

// Opt `kernel` in to `smem` bytes of dynamic shared memory, once per device
// (`set` is the instance's own flags), not per launch.
template <typename K>
cudaError_t smem_opt_in(K* kernel, size_t smem, std::atomic<bool>* set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= SSD_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!set[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    set[dev].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

struct SsdArgs {
  const void* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  const void* dy;        // backward only
  const float* states_in;
  const float* dh_final;
  void* y;               // forward: y; backward: dxdt
  float* out1;           // forward: h_final; backward: da
  float* out2;           // forward: states (or null); backward: dB
  float* out3;           // backward: dC
  int Bt, S, H;
  const int64_t* st;     // x (3), dt (2), B (2), C (2)[, dy (3)]
};

template <typename T, int L, int P, int N>
cudaError_t launch(bool backward, const SsdArgs& a, cudaStream_t stream) {
  dim3 grid(a.H, a.Bt);
  const int64_t* st = a.st;
  if (!backward) {
    const size_t smem = fwd_smem_floats<L, P, N>() * sizeof(float);
    static std::atomic<bool> set[SSD_MAX_DEVICES];
    cudaError_t err = smem_opt_in(ssd_fwd_kernel<T, L, P, N>, smem, set);
    if (err != cudaSuccess) return err;
    ssd_fwd_kernel<T, L, P, N><<<grid, SSD_THREADS, smem, stream>>>(
        static_cast<const T*>(a.x), a.dt, a.A, a.B, a.C, static_cast<T*>(a.y),
        a.out1, a.out2, a.S, a.H, st[0], st[1], st[2], st[3], st[4], st[5],
        st[6], st[7], st[8]);
  } else {
    const size_t smem = bwd_smem_floats<L, P, N>() * sizeof(float);
    static std::atomic<bool> set[SSD_MAX_DEVICES];
    cudaError_t err = smem_opt_in(ssd_bwd_kernel<T, L, P, N>, smem, set);
    if (err != cudaSuccess) return err;
    ssd_bwd_kernel<T, L, P, N><<<grid, SSD_THREADS, smem, stream>>>(
        static_cast<const T*>(a.x), a.dt, a.A, a.B, a.C,
        static_cast<const T*>(a.dy), a.states_in, a.dh_final,
        static_cast<float*>(a.y), a.out1, a.out2, a.out3, a.S, a.H, st[0],
        st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
        st[10], st[11]);
  }
  return cudaGetLastError();
}

// The instantiated (L, P, N): chunks of 32 and 64 at mamba2-780m's head
// (P=64, N=128), zamba2's (P=64, N=64) and the smoke config's (P=16,
// N=16). ssd/ops.py's SHAPES lists the same.
template <typename T>
cudaError_t launch_shape(bool backward, int L, int P, int N,
                         const SsdArgs& a, cudaStream_t s) {
  if (P == 64 && N == 128) {
    if (L == 64) return launch<T, 64, 64, 128>(backward, a, s);
    if (L == 32) return launch<T, 32, 64, 128>(backward, a, s);
  }
  if (P == 64 && N == 64) {
    if (L == 64) return launch<T, 64, 64, 64>(backward, a, s);
    if (L == 32) return launch<T, 32, 64, 64>(backward, a, s);
  }
  if (P == 16 && N == 16) {
    if (L == 64) return launch<T, 64, 16, 16>(backward, a, s);
    if (L == 32) return launch<T, 32, 16, 16>(backward, a, s);
  }
  return cudaErrorInvalidValue;
}

int launch_any(bool backward, int dtype, int L, int P, int N,
               const SsdArgs& a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_shape<float>(backward, L, P, N, a, s);
  if (dtype == 1) return launch_shape<__nv_bfloat16>(backward, L, P, N, a, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes of x (and dy): 0 float32, 1 bfloat16.
// strides: (batch, seq, head) of x, (batch, seq) of dt, B and C.
// y (Bt,S,H,P) in x's type, h_final (Bt,H,P,N) float32 and states
// (Bt,H,ceil(S/L),P,N) float32 (written when not null), all contiguous.
extern "C" int ssd_fwd(const void* x, const void* dt, const void* A,
                       const void* B, const void* C, void* y, void* h_final,
                       void* states, int dtype, int Bt, int S, int H, int P,
                       int N, int L, const int64_t* strides, void* stream) {
  SsdArgs a{x, static_cast<const float*>(dt), static_cast<const float*>(A),
            static_cast<const float*>(B), static_cast<const float*>(C),
            nullptr, nullptr, nullptr, y, static_cast<float*>(h_final),
            static_cast<float*>(states), nullptr, Bt, S, H, strides};
  return launch_any(false, dtype, L, P, N, a, stream);
}

// strides: as for ssd_fwd, then (batch, seq, head) of dy (x's type).
// states (Bt,H,ceil(S/L),P,N) and dh_final (Bt,H,P,N) float32 contiguous,
// dh_final null for zeros. Writes dxdt (Bt,S,H,P), da (Bt,S,H), dB and dC
// (Bt,S,H,N), float32 contiguous.
extern "C" int ssd_bwd(const void* x, const void* dt, const void* A,
                       const void* B, const void* C, const void* dy,
                       const void* states, const void* dh_final, void* dxdt,
                       void* da, void* dB, void* dC, int dtype, int Bt, int S,
                       int H, int P, int N, int L, const int64_t* strides,
                       void* stream) {
  SsdArgs a{x, static_cast<const float*>(dt), static_cast<const float*>(A),
            static_cast<const float*>(B), static_cast<const float*>(C), dy,
            static_cast<const float*>(states),
            static_cast<const float*>(dh_final), dxdt,
            static_cast<float*>(da), static_cast<float*>(dB),
            static_cast<float*>(dC), Bt, S, H, strides};
  return launch_any(true, dtype, L, P, N, a, stream);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
