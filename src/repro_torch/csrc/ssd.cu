// The Mamba-2 SSD (state-space duality) chunked scan and its reverse scan.
// Two bodies of each: bf16 operands on the tensor cores (notes 3 and 4),
// float32 operands on the CUDA cores (notes 1 and 2). The operand types
// choose: x, B and C all bf16 (as mamba2 hands them) run the tensor-core
// bodies, a float32 x, B or C the CUDA-core ones.
//
// 1. ssd_fwd replaces the Pallas kernel `ssd` (src/repro/kernels/ssd/
//    kernel.py:120, body `_ssd_body` :25, with and without the per-chunk
//    states `_ssd_kernel_states` :79), which every mamba2 layer runs in its
//    forward, its remat recompute and the states sweep of its backward.
//    It reads the model's layouts as they are: x (Bt,S,H,P) with any
//    strides but a unit last one (the in_proj slice), dt (Bt,S,H) float32,
//    A (H,), B and C (Bt,S,N) (one group shared by every head). xdt = x dt
//    and a = dt A are formed here, the products the JAX wrapper forms
//    before its kernel (ops.py:33), so there is no (Bt,H,S,P) float32 copy
//    of x. It writes y (Bt,S,H,P) in x's type (one rounding of the float32
//    result), the final state (Bt,H,P,N) float32 and, when `states` is not
//    null, the state entering each chunk (Bt,H,S/L,P,N) float32, the
//    backward's residual. Per chunk, with cs the inclusive cumsum of a:
//      y  = (C B^T o decay) xdt + exp(cs) o (C h^T)
//      h <- exp(cs_L) h + (xdt o w)^T B,   w = exp(cs_L - cs)
//    The decay exp(cs_t - cs_s) is evaluated only where t >= s: above the
//    diagonal it can overflow to inf (A reaches -16 in mamba2-780m, so 63
//    steps of dt A can pass 88), and only a select before the exp keeps
//    the backward free of 0 * inf.
//    float32 (`ssd_fwd_f32_kernel`, x float32 or bf16 with B, C float32):
//    the Pallas grid (Bt*H, S/L) runs its chunk axis in order on one core
//    with h in VMEM; here one CTA per (head, batch row) walks the chunks
//    with h (P x N float32) in shared memory beside the chunk's tiles, 256
//    threads as a 16 x 16 grid, each a register tile of every product, all
//    float32 fmaf.
//
// 2. ssd_bwd replaces the Pallas kernel `ssd_bwd` (src/repro/kernels/ssd/
//    backward.py:123, body `_ssd_bwd_kernel` :35). One CTA per (head, batch
//    row) walks the chunks in reverse carrying dh (P x N float32), seeded
//    from dh_final (zeros when it is null). Per chunk it recomputes cs, e =
//    exp(cs), w, the decay, C B^T and dy xdt^T from the inputs and the
//    chunk's incoming state, and writes dxdt, da, dB and dC by the
//    equations of backward.py:10-18, da's reverse cumsum taken directly
//    from the last row with the cs_L terms folded into it (backward.py:
//    84-90). dxdt (Bt,S,H,P), da (Bt,S,H), and dB and dC per head
//    (Bt,S,H,N), all float32; the caller sums dB and dC over the heads and
//    chains dxdt and da to dx, ddt and dA, as the JAX wrapper does (ops.py:
//    89-99). float32 (`ssd_bwd_f32_kernel`): the forward's CUDA-core
//    design, with dh in shared memory.
//
// 3. `ssd_fwd_bf16_kernel` (x, B, C bf16): one CTA of one warpgroup (128
//    threads) per (head, batch row), two a SM. Thread 0 keeps the next
//    chunk's x, B and C in flight by TMA through a 2-slot ring (mbarriers;
//    the model's strided views read through 4-D tensor maps, rows past S
//    and past a chunk of 32 arriving or staying as zeros), while the
//    warpgroup computes the current one with wgmma (m64: a chunk's rows,
//    zero-padded to 64). h lives in the warpgroup's float32 accumulator
//    registers across the chunks. Per chunk: cs by warp 0 as a float64
//    tree scan over the lanes, the decay from float64 differences;
//    CB = C B^T (two bf16 operands: one wgmma, exact products, float32
//    sums); M' = CB o decay o dt_s, split into two bf16 terms (hi =
//    bf16(v), lo = bf16(v - hi)) written to shared memory; y^T = exp(cs) o
//    (h C^T) + x^T M'^T, h's two terms as register A fragments against C,
//    then x^T (exact, register A) against M''s terms; y in bf16; then
//    h <- exp(cs_L) h + U^T B with U = x o (dt w) in three bf16 terms
//    (register A) against B read MN-major. A product with one float32
//    operand carries it as bf16 terms: two carry it to about 2^-16, three
//    to float32's 2^-24. y is bf16, so M' and h need two; h_final and the
//    states are held to 1e-5, so U takes three
//    (tests/test_torch_ssd.py::test_bf16_terms_meet_the_limits emulates
//    the arithmetic on the CPU).
//
// 4. `ssd_bwd_bf16_kernel`: the forward's structure in reverse, one CTA a
//    SM (196 KB of shared memory at P=64, N=128): the ring carries x, dy,
//    B, C and the chunk's incoming state (float32, by TMA), dh lives in
//    the accumulator registers, and h_in and dh sit in shared memory as two
//    bf16 terms each. Per chunk: B C^T, x dy^T and dy x^T (exact); G^T =
//    C B^T o decay and DD = dy xdt^T o decay in three terms (register A);
//    dB = w dt (x dh) + DD^T C, dxdt = w (B dh^T) + G^T dy, dC = e (dy h_in)
//    + DD B, dh <- exp(cs_L) dh + (e dy)^T C with (e dy)^T in two terms;
//    <dy, y_inter> and <xdt, B dh^T> from the dC and dB accumulators (no
//    product of their own), E's row and column sums, <h_in, dh> and da's
//    reverse cumsum as warp reductions in one fixed order.
//
// Every sum runs in one fixed order and nothing is atomic, so two launches
// give the same bits and a row's result never depends on its batch.
// What bounds them on an H100, at the training shape (Bt=8, S=1024, H=48,
// P=64, N=128, L=64, bf16 x, B, C): the scan needs 17.8 GFLOP of products
// forward and 45.3 backward (over the pairs t >= s), 0.018 and 0.046 ms at
// 989 TFLOP/s, so bytes bound both: the forward moves 119 MB (0.036 ms at
// 3.35 TB/s; 320 MB, 0.096 ms, with the states), the backward 825 MB
// (0.246 ms). Counting each bf16 term, the tensor-core bodies run 38.8 and
// 82.6 GFLOP. The CUDA-core bodies' float32 work takes 0.266 and 0.676 ms
// at 67 TFLOP/s.
//
// Every C entry returns cudaGetLastError() after its launch.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

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
ssd_fwd_f32_kernel(const T* __restrict__ x, const float* __restrict__ dt,
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
ssd_bwd_f32_kernel(const T* __restrict__ x, const float* __restrict__ dt,
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

// ======================================================= tensor-core bodies
// (see the file's notes 3 and 4)
constexpr int TC_THREADS = 128;  // one warpgroup
constexpr int TC_ROWS = 64;      // wgmma's M: a chunk's rows, zero-padded

// A 64-row bf16 tile of W columns in shared memory as TMA writes it: NBOX
// boxes of 64 rows x BOX columns, each row ROW bytes, in the swizzle of
// that row width (128 B at W = 64 and 128, 32 B at W = 16).
template <int W>
struct Tile {
  static_assert(W == 16 || W == 64 || W == 128, "tile width");
  static constexpr int BOX = W < 64 ? W : 64;
  static constexpr int NBOX = W / BOX;
  static constexpr int ROW = 2 * BOX;
  // wgmma descriptor layout code of that swizzle, and its row mask
  static constexpr uint64_t SWIZZLE = ROW == 128 ? 1 : 3;
  static constexpr uint32_t MASK = ROW == 128 ? 7 : 1;
  static constexpr uint32_t BOX_BYTES = TC_ROWS * ROW;
  static constexpr uint32_t BYTES = TC_ROWS * W * 2;
  // byte offset of element (r, c): the 16-byte chunk index XOR the row's
  // place in the swizzle pattern, as TMA writes it
  __device__ static __forceinline__ uint32_t at(int r, int c) {
    const uint32_t lin = (c / BOX) * BOX_BYTES + r * ROW + (c % BOX) * 2;
    return lin ^ (((lin >> 7) & MASK) << 4);
  }
  // descriptor of k-step kk read K-major: columns 16 kk.. of W are the
  // product's K, the rows its M or N
  __device__ static __forceinline__ uint64_t kdesc(uint32_t tile, int kk) {
    const uint32_t off = (kk * 32 / ROW) * BOX_BYTES + kk * 32 % ROW;
    return gmma_desc(tile + off, 16, 8 * ROW, SWIZZLE);
  }
  // descriptor of k-step kk read MN-major: rows 16 kk.. are the product's
  // K, the columns its N (NBOX boxes apart)
  __device__ static __forceinline__ uint64_t mndesc(uint32_t tile, int kk) {
    return gmma_desc(tile + kk * 16 * ROW, BOX_BYTES, 8 * ROW, SWIZZLE);
  }
};

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ void sts32(unsigned char* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}

// A^T's exact A fragments of k-step kk for a 64-row tile T (rows K,
// columns M) by one ldmatrix.x4.trans a warp: lane l gives row l % 8 of
// 8 x 8 block l / 8 (rows 16 kk + 8 (b / 2).., columns 16 warp + 8 (b % 2)..),
// and register i comes back as the A fragment's pair i (row row0 + 8 (i % 2),
// columns 16 kk + 2 q + 8 (i / 2) + {0, 1}). Columns past the tile's width
// (a warp's rows of M past W) are zeros.
template <typename T>
__device__ __forceinline__ void ldsm_at(uint32_t tile, int kk, int warp,
                                        int lane, uint32_t (&a)[4]) {
  const int b = lane / 8;
  const int c0 = 16 * warp + 8 * (b % 2);
  if (16 * warp >= T::BOX * T::NBOX) {
    a[0] = a[1] = a[2] = a[3] = 0u;
    return;
  }
  const uint32_t addr = tile + T::at(16 * kk + 8 * (b / 2) + lane % 8, c0);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr)
      : "memory");
}

// v, as a value the compiler cannot see through: the per-thread swizzled
// addresses derived from it are formed in the phase that uses them, not
// hoisted out of the chunk loop, where dozens of them would hold
// registers across every phase (the backward spilled before)
__device__ __forceinline__ uint32_t opaque(uint32_t v) {
  asm volatile("" : "+r"(v));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Warp 0: cs = the inclusive cumsum of a = dt A over the chunk's 64 rows
// (dt = 0 at rows r >= lc, past the chunk or S) in float64, a tree scan
// over the lanes (lane i holds rows i and i + 32); by row exp(cs), w =
// exp(cs_L - cs), dt and dt w, cs_L being row 63's (the padding adds 0).
__device__ __forceinline__ void chunk_scan(double* cs, float* ev, float* wv,
                                           float* dts, float* wdt,
                                           const float* __restrict__ dtg,
                                           double Ah, int t0, int lc,
                                           int64_t ds_s) {
  const int lane = threadIdx.x % 32;
  double v[2];
  float d[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = lane + 32 * i;
    d[i] = r < lc ? dtg[(int64_t)(t0 + r) * ds_s] : 0.f;
    v[i] = (double)d[i] * Ah;
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const double u = __shfl_up_sync(0xffffffffu, v[i], o);
      if (lane >= o) v[i] += u;
    }
  v[1] += __shfl_sync(0xffffffffu, v[0], 31);
  const double csL = __shfl_sync(0xffffffffu, v[1], 31);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = lane + 32 * i;
    cs[r] = v[i];
    ev[r] = (float)exp(v[i]);
    wv[r] = (float)exp(csL - v[i]);
    dts[r] = d[i];
    wdt[r] = wv[r] * d[i];
  }
}

// exp(cs_t - cs_s) where t >= s, else 0: the difference in float64, the
// exp of the select only
__device__ __forceinline__ float decay(const double* cs, int t, int s) {
  return t >= s ? expf((float)(cs[t] - cs[s])) : 0.f;
}

// Shared-memory plan of the forward: a 2-slot ring of the chunk's x, B
// and C tiles, M' in two bf16 terms, cs (float64) and four float rows,
// then the slots' mbarriers.
template <int P, int N>
struct FwdTc {
  using X = Tile<P>;
  using BC = Tile<N>;
  using MT = Tile<TC_ROWS>;
  static constexpr uint32_t X_OFF = 0;
  static constexpr uint32_t B_OFF = X::BYTES;
  static constexpr uint32_t C_OFF = B_OFF + BC::BYTES;
  static constexpr uint32_t SLOT = C_OFF + BC::BYTES;
  static constexpr uint32_t MT_OFF = 2 * SLOT;
  static constexpr uint32_t CS_OFF = MT_OFF + 2 * MT::BYTES;
  static constexpr uint32_t F_OFF = CS_OFF + 8 * TC_ROWS;
  static constexpr uint32_t BAR_OFF = F_OFF + 4 * 4 * TC_ROWS;
  // + 1024: the base is rounded up to the swizzle pattern's period
  static constexpr size_t SMEM = BAR_OFF + 16 + 1024;
};

template <int L, int P, int N>
__global__ void __launch_bounds__(TC_THREADS, 2)
ssd_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_b,
                    const __grid_constant__ CUtensorMap tm_c,
                    const float* __restrict__ dt, const float* __restrict__ A,
                    __nv_bfloat16* __restrict__ y,
                    float* __restrict__ h_final, float* __restrict__ states,
                    int S, int H, int64_t ds_b, int64_t ds_s) {
  using Pl = FwdTc<P, N>;
  using X = typename Pl::X;
  using BC = typename Pl::BC;
  using MT = typename Pl::MT;
  constexpr int KN = N / 16;  // k-steps over the state
  extern __shared__ unsigned char tc_smem[];
  const uint32_t base = (smem_addr(tc_smem) + 1023u) & ~1023u;
  unsigned char* const sm = tc_smem + (base - smem_addr(tc_smem));
  double* const cs = reinterpret_cast<double*>(sm + Pl::CS_OFF);
  float* const ev = reinterpret_cast<float*>(sm + Pl::F_OFF);
  float* const wv = ev + TC_ROWS;
  float* const dts = wv + TC_ROWS;
  float* const wdt = dts + TC_ROWS;
  const uint32_t bar = base + Pl::BAR_OFF;  // + 8 * slot
  const uint32_t mt = base + Pl::MT_OFF;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int row0 = 16 * warp + g;  // this thread's accumulator rows: + 8 r
  const int h = blockIdx.x, b = blockIdx.y;
  const int nc = (S + L - 1) / L;
  const double Ah = (double)A[h];
  const float* dtg = dt + b * ds_b + h;
  const size_t bh = (size_t)b * H + h;

  // zero the tiles (rows past a chunk of L < 64 are never loaded)
  for (uint32_t i = tid * 16; i < Pl::BAR_OFF; i += TC_THREADS * 16)
    *reinterpret_cast<uint4*>(sm + i) = make_uint4(0u, 0u, 0u, 0u);
  fence_proxy_async();
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0: chunk c's x, B and C into ring slot c % 2 (rows past S
  // arrive as zeros)
  auto issue = [&](int c) {
    const uint32_t full = bar + 8 * (c & 1);
    const uint32_t s0 = base + (c & 1) * Pl::SLOT;
    mbar_expect_tx(full, L * (P + 2 * N) * 2);
    for (int i = 0; i < X::NBOX; ++i)
      tma_load(s0 + Pl::X_OFF + i * X::BOX_BYTES, &tm_x, full, i * X::BOX,
               c * L, h, b);
    for (int i = 0; i < BC::NBOX; ++i) {
      tma_load(s0 + Pl::B_OFF + i * BC::BOX_BYTES, &tm_b, full, i * BC::BOX,
               c * L, 0, b);
      tma_load(s0 + Pl::C_OFF + i * BC::BOX_BYTES, &tm_c, full, i * BC::BOX,
               c * L, 0, b);
    }
  };
  if (tid == 0) issue(0);

  // h (P x N, rows past P zero) as a wgmma accumulator: hacc[4 j + 2 r + e]
  // is row row0 + 8 r, column 8 j + 2 q + e
  float hacc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) hacc[i] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * L, lc = min(L, S - t0);
    if (warp == 0) chunk_scan(cs, ev, wv, dts, wdt, dtg, Ah, t0, lc, ds_s);
    if (states != nullptr) {  // the state entering chunk c
      float* st = states + (bh * nc + c) * (size_t)(P * N);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = row0 + 8 * r;
        if (p >= P) continue;
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
          *reinterpret_cast<float2*>(st + p * N + 8 * j + 2 * q) =
              make_float2(hacc[4 * j + 2 * r], hacc[4 * j + 2 * r + 1]);
      }
    }
    __syncthreads();  // the rows of cs; the other slot is free
    if (tid == 0 && c + 1 < nc) issue(c + 1);
    mbar_wait(bar + 8 * (c & 1), (c >> 1) & 1);
    const uint32_t s0 = base + (c & 1) * Pl::SLOT;
    const uint32_t bs = s0 + Pl::B_OFF, ct = s0 + Pl::C_OFF;

    // CB = C B^T over the state, both K-major: products of bf16, exact
    float cb[32];
    fence_regs(cb);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KN; ++kk)
      wgmma_ss<64, 0>(cb, BC::kdesc(ct, kk), BC::kdesc(bs, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(cb);

    // M' = CB o decay o dt_s (rows t, columns s) in two bf16 terms, into
    // the M' tiles
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = row0 + 8 * r;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int s = 8 * j + 2 * q;
        const float v0 = cb[4 * j + 2 * r] * decay(cs, t, s) * dts[s];
        const float v1 = cb[4 * j + 2 * r + 1] * decay(cs, t, s + 1) *
                         dts[s + 1];
        uint32_t hi, lo;
        split_pair(v0, v1, hi, lo);
        sts32(sm + Pl::MT_OFF + MT::at(t, s), hi);
        sts32(sm + Pl::MT_OFF + MT::BYTES + MT::at(t, s), lo);
      }
    }
    fence_proxy_async();
    __syncthreads();  // M' whole before the tensor cores read it

    // y^T (p x t) = exp(cs_t) (h C^T) + x^T M'^T: first h's two terms as
    // A fragments against C read K-major
    float yt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) yt[i] = 0.f;
    {
      uint32_t hh[KN][4], hl[KN][4];
#pragma unroll
      for (int c2 = 0; c2 < N / 4; ++c2)
        split_pair(hacc[2 * c2], hacc[2 * c2 + 1], hh[c2 / 4][c2 % 4],
                   hl[c2 / 4][c2 % 4]);
      fence_regs(yt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KN; ++kk)
        wgmma_rs<64, 0>(yt, hh[kk], BC::kdesc(ct, kk));
#pragma unroll
      for (int kk = 0; kk < KN; ++kk)
        wgmma_rs<64, 0>(yt, hl[kk], BC::kdesc(ct, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(yt);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float et = ev[8 * j + 2 * q + e];
        yt[4 * j + e] *= et;
        yt[4 * j + 2 + e] *= et;
      }
    // x^T as exact A fragments (row p, columns s)
    uint32_t xf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldsm_at<X>(s0 + Pl::X_OFF, kk, warp, lane, xf[kk]);
    fence_regs(yt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<64, 0>(yt, xf[kk], MT::kdesc(mt, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<64, 0>(yt, xf[kk], MT::kdesc(mt + MT::BYTES, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(yt);

    // y: yt[4 j + 2 r + e] is (p = row0 + 8 r, t = 8 j + 2 q + e)
    __nv_bfloat16* yb = y + ((int64_t)b * S + t0) * H * P + (int64_t)h * P;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = row0 + 8 * r;
      if (p >= P) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = 8 * j + 2 * q + e;
          if (t < lc)
            yb[(int64_t)t * H * P + p] = __float2bfloat16(yt[4 * j + 2 * r + e]);
        }
    }

    // h = exp(cs_L) h + U^T B, U = x o (dt w) by row s in three bf16 terms
    // as A fragments (row p, columns s), B read MN-major
    {
      const float dL = (float)exp(cs[TC_ROWS - 1]);
      uint32_t u1[4][4], u2[4][4], u3[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int s = 16 * kk + 2 * q + 8 * (i / 2);
          const float2 xv = bf16x2_to_f2(xf[kk][i]);
          split3_pair(xv.x * wdt[s], xv.y * wdt[s + 1], u1[kk][i], u2[kk][i],
                      u3[kk][i]);
        }
#pragma unroll
      for (int i = 0; i < N / 2; ++i) hacc[i] *= dL;
      fence_regs(hacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<N, 1>(hacc, u1[kk], BC::mndesc(bs, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<N, 1>(hacc, u2[kk], BC::mndesc(bs, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<N, 1>(hacc, u3[kk], BC::mndesc(bs, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(hacc);
    }
    __syncthreads();  // the slot, M' and the rows are free
  }

  float* hf = h_final + bh * (size_t)(P * N);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = row0 + 8 * r;
    if (p >= P) continue;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<float2*>(hf + p * N + 8 * j + 2 * q) =
          make_float2(hacc[4 * j + 2 * r], hacc[4 * j + 2 * r + 1]);
  }
}

// Shared-memory plan of the backward: a 2-slot ring of the chunk's x, dy,
// B and C tiles; the chunk's incoming state h_in (float32, by TMA); h_in
// and dh in two bf16 terms each (P rows, rows past P zero); cs (float64);
// eleven float rows and the four warps' <h_in, dh>; the mbarriers.
template <int P, int N>
struct BwdTc {
  using X = Tile<P>;
  using BC = Tile<N>;
  static constexpr uint32_t X_OFF = 0;
  static constexpr uint32_t DY_OFF = X::BYTES;
  static constexpr uint32_t B_OFF = 2 * X::BYTES;
  static constexpr uint32_t C_OFF = B_OFF + BC::BYTES;
  static constexpr uint32_t SLOT = C_OFF + BC::BYTES;
  static constexpr uint32_t HS_OFF = 2 * SLOT;
  static constexpr uint32_t HS_BYTES = (P * N * 4 + 1023) / 1024 * 1024;
  static constexpr uint32_t HT_OFF = HS_OFF + HS_BYTES;
  static constexpr uint32_t DH_OFF = HT_OFF + 2 * BC::BYTES;
  static constexpr uint32_t CS_OFF = DH_OFF + 2 * BC::BYTES;
  static constexpr uint32_t F_OFF = CS_OFF + 8 * TC_ROWS;
  static constexpr uint32_t BAR_OFF = F_OFF + 4 * (11 * TC_ROWS + 4);
  static constexpr size_t SMEM = BAR_OFF + 16 + 1024;
};

template <int L, int P, int N>
__global__ void __launch_bounds__(TC_THREADS, 1)
ssd_bwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_dy,
                    const __grid_constant__ CUtensorMap tm_b,
                    const __grid_constant__ CUtensorMap tm_c,
                    const __grid_constant__ CUtensorMap tm_st,
                    const float* __restrict__ dt, const float* __restrict__ A,
                    const float* __restrict__ dh_final,
                    float* __restrict__ dxdt, float* __restrict__ da,
                    float* __restrict__ dBh, float* __restrict__ dCh, int S,
                    int H, int64_t ds_b, int64_t ds_s) {
  using Pl = BwdTc<P, N>;
  using X = typename Pl::X;
  using BC = typename Pl::BC;
  using HT = typename Pl::BC;  // h_in's and dh's terms: P rows of N
  constexpr int KN = N / 16, KP = P / 16;
  constexpr int NH = BC::BOX;  // dB's and dC's columns a pass
  extern __shared__ unsigned char tc_smem[];
  const uint32_t base = (smem_addr(tc_smem) + 1023u) & ~1023u;
  unsigned char* const sm = tc_smem + (base - smem_addr(tc_smem));
  double* const cs = reinterpret_cast<double*>(sm + Pl::CS_OFF);
  float* const ev = reinterpret_cast<float*>(sm + Pl::F_OFF);
  float* const wv = ev + TC_ROWS;
  float* const dts = wv + TC_ROWS;
  float* const wdt = dts + TC_ROWS;
  float* const colE = wdt + TC_ROWS;   // E's column sums
  float* const de = colE + TC_ROWS;    // <dy, y_inter> by row
  float* const dw = de + TC_ROWS;      // w dt <x, B dh^T> by row
  float* const rowE = dw + TC_ROWS;    // E's row sums, a row per warp
  float* const hdv = rowE + 4 * TC_ROWS;  // <h_in, dh>, one per warp
  const float* const hs = reinterpret_cast<const float*>(sm + Pl::HS_OFF);
  const uint32_t bar = base + Pl::BAR_OFF;  // + 8 * slot
  const uint32_t ht = base + Pl::HT_OFF, dht = base + Pl::DH_OFF;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int row0 = 16 * warp + g;
  const int h = blockIdx.x, b = blockIdx.y;
  const int nc = (S + L - 1) / L;
  const double Ah = (double)A[h];
  const float* dtg = dt + b * ds_b + h;
  const size_t bh = (size_t)b * H + h;
  // output rows of this (b, h): (Bt, S, H, ·)
  float* dxg = dxdt + ((int64_t)b * S * H + h) * P;
  float* dBg = dBh + ((int64_t)b * S * H + h) * N;
  float* dCg = dCh + ((int64_t)b * S * H + h) * N;
  float* dag = da + (int64_t)b * S * H + h;

  for (uint32_t i = tid * 16; i < Pl::BAR_OFF; i += TC_THREADS * 16)
    *reinterpret_cast<uint4*>(sm + i) = make_uint4(0u, 0u, 0u, 0u);
  fence_proxy_async();
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0: chunk c's x, dy, B, C into ring slot `slot` and its incoming
  // state into the h_in buffer, all on the slot's barrier
  auto issue = [&](int c, int slot) {
    const uint32_t full = bar + 8 * slot;
    const uint32_t s0 = base + slot * Pl::SLOT;
    mbar_expect_tx(full, L * (2 * P + 2 * N) * 2 + P * N * 4);
    for (int i = 0; i < X::NBOX; ++i) {
      tma_load(s0 + Pl::X_OFF + i * X::BOX_BYTES, &tm_x, full, i * X::BOX,
               c * L, h, b);
      tma_load(s0 + Pl::DY_OFF + i * X::BOX_BYTES, &tm_dy, full, i * X::BOX,
               c * L, h, b);
    }
    for (int i = 0; i < BC::NBOX; ++i) {
      tma_load(s0 + Pl::B_OFF + i * BC::BOX_BYTES, &tm_b, full, i * BC::BOX,
               c * L, 0, b);
      tma_load(s0 + Pl::C_OFF + i * BC::BOX_BYTES, &tm_c, full, i * BC::BOX,
               c * L, 0, b);
    }
    tma_load(base + Pl::HS_OFF, &tm_st, full, 0, 0, c, (int)bh);
  };

  // dh as a wgmma accumulator (P x N, rows past P zero), seeded from
  // dh_final, and its two terms for the first chunk
  float hacc[N / 2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = row0 + 8 * r;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      float2 v = make_float2(0.f, 0.f);
      if (dh_final != nullptr && p < P)
        v = *reinterpret_cast<const float2*>(
            dh_final + bh * (size_t)(P * N) + p * N + 8 * j + 2 * q);
      hacc[4 * j + 2 * r] = v.x;
      hacc[4 * j + 2 * r + 1] = v.y;
      uint32_t hi, lo;
      split_pair(v.x, v.y, hi, lo);
      if (p < P) {
        sts32(sm + Pl::DH_OFF + HT::at(p, 8 * j + 2 * q), hi);
        sts32(sm + Pl::DH_OFF + HT::BYTES + HT::at(p, 8 * j + 2 * q), lo);
      }
    }
  }
  fence_proxy_async();
  if (tid == 0) issue(nc - 1, 0);

  for (int k = 0; k < nc; ++k) {
    const int c = nc - 1 - k, slot = k & 1;
    const int t0 = c * L, lc = min(L, S - t0);
    if (warp == 0) chunk_scan(cs, ev, wv, dts, wdt, dtg, Ah, t0, lc, ds_s);
    mbar_wait(bar + 8 * slot, (k >> 1) & 1);
    // h_in into its two terms at this thread's accumulator places, and
    // this thread's share of <h_in, dh>
    {
      const int rw = (int)opaque(row0);
      float hd = 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = rw + 8 * r;
        if (p >= P) continue;
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const int n = 8 * j + 2 * q;
          const float2 v = *reinterpret_cast<const float2*>(hs + p * N + n);
          hd = fmaf(v.x, hacc[4 * j + 2 * r], hd);
          hd = fmaf(v.y, hacc[4 * j + 2 * r + 1], hd);
          uint32_t hi, lo;
          split_pair(v.x, v.y, hi, lo);
          sts32(sm + Pl::HT_OFF + HT::at(p, n), hi);
          sts32(sm + Pl::HT_OFF + HT::BYTES + HT::at(p, n), lo);
        }
      }
      hd = warp_sum(hd);
      if (lane == 0) hdv[warp] = hd;
    }
    fence_proxy_async();
    __syncthreads();  // h_in's terms, the rows of cs; h_in's buffer is free
    if (tid == 0 && c > 0) issue(c - 1, slot ^ 1);
    const uint32_t s0 = base + slot * Pl::SLOT;
    const uint32_t xs = s0 + Pl::X_OFF, ys = s0 + Pl::DY_OFF;
    const uint32_t bs = s0 + Pl::B_OFF, ct = s0 + Pl::C_OFF;
    const unsigned char* sp = sm + slot * Pl::SLOT;
    const unsigned char* bp = sp + Pl::B_OFF;
    const unsigned char* cp = sp + Pl::C_OFF;
    const double csL = cs[TC_ROWS - 1];

    // (1) B C^T and x dy^T, rows s, columns t: products of bf16, exact
    float sT[32], yT[32];
    fence_regs(sT);
    fence_regs(yT);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KN; ++kk)
      wgmma_ss<64, 0>(sT, BC::kdesc(bs, kk), BC::kdesc(ct, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < KP; ++kk)
      wgmma_ss<64, 0>(yT, X::kdesc(xs, kk), X::kdesc(ys, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sT);
    fence_regs(yT);
    // DD^T = x dy^T o decay o dt_s into yT, G^T = C B^T o decay into sT,
    // and E^T = DD^T o C B^T: its row sums are E's column sums, its column
    // sums (over the warp's rows, then the warps) E's row sums
    {
      float csum[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) csum[i] = 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int s = row0 + 8 * r;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int t = 8 * j + 2 * q + e, i = 4 * j + 2 * r + e;
            const float dec = decay(cs, t, s);
            const float dd = yT[i] * dec * dts[s];
            const float ee = dd * sT[i];
            rs += ee;
            csum[2 * j + e] += ee;
            yT[i] = dd;
            sT[i] *= dec;
          }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        if (q == 0) colE[s] = rs;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        float v = csum[i];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) rowE[warp * TC_ROWS + 8 * (i / 2) + 2 * q + i % 2] = v;
      }
    }

    // (2) dB (s x n) = w_s dt_s (x dh) + DD^T C, NH columns a pass: x (K =
    // p) against dh's terms read MN-major, then DD^T in three terms as A
    // fragments against C read MN-major; dw_s = w_s dt_s sum_n B[s][n]
    // (x dh)[s][n]
    {
      uint32_t d1[4][4], d2[4][4], d3[4][4];
#pragma unroll
      for (int c2 = 0; c2 < 16; ++c2)
        split3_pair(yT[2 * c2], yT[2 * c2 + 1], d1[c2 / 4][c2 % 4],
                    d2[c2 / 4][c2 % 4], d3[c2 / 4][c2 % 4]);
      float dwp[2] = {0.f, 0.f};
      // a loop of unknown trip count even when N = NH: one pass's code is
      // not merged with the next phase's
#pragma unroll 1
      for (int hb = 0; hb < (int)opaque(N / NH); ++hb) {
        const uint32_t dh_t = dht + hb * HT::BOX_BYTES;
        float acc[NH / 2];
#pragma unroll
        for (int i = 0; i < NH / 2; ++i) acc[i] = 0.f;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int term = 0; term < 2; ++term)
#pragma unroll
          for (int kk = 0; kk < KP; ++kk)
            wgmma_ss<NH, 1>(acc, X::kdesc(xs, kk),
                            HT::mndesc(dh_t + term * HT::BYTES, kk), 1);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        const int rw = (int)opaque(row0);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int s = rw + 8 * r;
          const float sc = wdt[s];
#pragma unroll
          for (int j = 0; j < NH / 8; ++j) {
            const int i = 4 * j + 2 * r;
            const float2 bv = bf16x2_to_f2(
                lds32(bp + BC::at(s, hb * NH + 8 * j + 2 * q)));
            dwp[r] = fmaf(bv.x, acc[i], dwp[r]);
            dwp[r] = fmaf(bv.y, acc[i + 1], dwp[r]);
            acc[i] *= sc;
            acc[i + 1] *= sc;
          }
        }
        fence_regs(acc);
        wgmma_fence();
        const uint32_t cb = ct + hb * BC::BOX_BYTES;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<NH, 1>(acc, d1[kk], BC::mndesc(cb, kk));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<NH, 1>(acc, d2[kk], BC::mndesc(cb, kk));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<NH, 1>(acc, d3[kk], BC::mndesc(cb, kk));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int s = row0 + 8 * r;
          if (s >= lc) continue;
#pragma unroll
          for (int j = 0; j < NH / 8; ++j)
            *reinterpret_cast<float2*>(dBg + (int64_t)(t0 + s) * H * N +
                                       hb * NH + 8 * j + 2 * q) =
                make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v = dwp[r];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (q == 0) dw[row0 + 8 * r] = v * wdt[row0 + 8 * r];
      }
    }

    // (3) dxdt (s x p) = w_s (B dh^T) + G^T dy: B (K = n) against dh's
    // terms read K-major, then G^T in three terms against dy read MN-major
    {
      uint32_t g1[4][4], g2[4][4], g3[4][4];
#pragma unroll
      for (int c2 = 0; c2 < 16; ++c2)
        split3_pair(sT[2 * c2], sT[2 * c2 + 1], g1[c2 / 4][c2 % 4],
                    g2[c2 / 4][c2 % 4], g3[c2 / 4][c2 % 4]);
      float acc[P / 2];
#pragma unroll
      for (int i = 0; i < P / 2; ++i) acc[i] = 0.f;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int term = 0; term < 2; ++term)
#pragma unroll
        for (int kk = 0; kk < KN; ++kk)
          wgmma_ss<P, 0>(acc, BC::kdesc(bs, kk),
                         HT::kdesc(dht + term * HT::BYTES, kk), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float sc = wv[row0 + 8 * r];
#pragma unroll
        for (int j = 0; j < P / 8; ++j) {
          acc[4 * j + 2 * r] *= sc;
          acc[4 * j + 2 * r + 1] *= sc;
        }
      }
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<P, 1>(acc, g1[kk], X::mndesc(ys, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<P, 1>(acc, g2[kk], X::mndesc(ys, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<P, 1>(acc, g3[kk], X::mndesc(ys, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int s = row0 + 8 * r;
        if (s >= lc) continue;
#pragma unroll
        for (int j = 0; j < P / 8; ++j)
          *reinterpret_cast<float2*>(dxg + (int64_t)(t0 + s) * H * P +
                                     8 * j + 2 * q) =
              make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    }

    // (4) dC (t x n) = e_t (dy h_in) + DD B: dy (K = p) against h_in's
    // terms read MN-major, then DD in three terms against B read MN-major;
    // de_t = e_t sum_n C[t][n] (dy h_in)[t][n]
    {
      float dd[32];
      fence_regs(dd);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KP; ++kk)
        wgmma_ss<64, 0>(dd, X::kdesc(ys, kk), X::kdesc(xs, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dd);
      uint32_t d1[4][4], d2[4][4], d3[4][4];
#pragma unroll
      for (int c2 = 0; c2 < 16; ++c2) {
        const int j = c2 / 2, r = c2 % 2;
        const int t = row0 + 8 * r, s = 8 * j + 2 * q;
        split3_pair(dd[2 * c2] * decay(cs, t, s) * dts[s],
                    dd[2 * c2 + 1] * decay(cs, t, s + 1) * dts[s + 1],
                    d1[c2 / 4][c2 % 4], d2[c2 / 4][c2 % 4],
                    d3[c2 / 4][c2 % 4]);
      }
      float dep[2] = {0.f, 0.f};
#pragma unroll 1
      for (int hb = 0; hb < (int)opaque(N / NH); ++hb) {
        const uint32_t h_t = ht + hb * HT::BOX_BYTES;
        float acc[NH / 2];
#pragma unroll
        for (int i = 0; i < NH / 2; ++i) acc[i] = 0.f;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int term = 0; term < 2; ++term)
#pragma unroll
          for (int kk = 0; kk < KP; ++kk)
            wgmma_ss<NH, 1>(acc, X::kdesc(ys, kk),
                            HT::mndesc(h_t + term * HT::BYTES, kk), 1);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        const int rw = (int)opaque(row0);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int t = rw + 8 * r;
          const float sc = ev[t];
#pragma unroll
          for (int j = 0; j < NH / 8; ++j) {
            const int i = 4 * j + 2 * r;
            const float2 cv = bf16x2_to_f2(
                lds32(cp + BC::at(t, hb * NH + 8 * j + 2 * q)));
            dep[r] = fmaf(cv.x, acc[i], dep[r]);
            dep[r] = fmaf(cv.y, acc[i + 1], dep[r]);
            acc[i] *= sc;
            acc[i + 1] *= sc;
          }
        }
        fence_regs(acc);
        wgmma_fence();
        const uint32_t bb = bs + hb * BC::BOX_BYTES;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<NH, 1>(acc, d1[kk], BC::mndesc(bb, kk));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<NH, 1>(acc, d2[kk], BC::mndesc(bb, kk));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<NH, 1>(acc, d3[kk], BC::mndesc(bb, kk));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int t = row0 + 8 * r;
          if (t >= lc) continue;
#pragma unroll
          for (int j = 0; j < NH / 8; ++j)
            *reinterpret_cast<float2*>(dCg + (int64_t)(t0 + t) * H * N +
                                       hb * NH + 8 * j + 2 * q) =
                make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v = dep[r];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (q == 0) de[row0 + 8 * r] = v * ev[row0 + 8 * r];
      }
    }

    // (5) dh = exp(cs_L) dh + (e dy)^T C: (e dy)^T in two terms as A
    // fragments (row p, columns t), C read MN-major
    {
      uint32_t e1[4][4], e2[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t yf[4];
        ldsm_at<X>(ys, kk, warp, lane, yf);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = 16 * kk + 2 * q + 8 * (i / 2);
          const float2 v = bf16x2_to_f2(yf[i]);
          split_pair(ev[t] * v.x, ev[t + 1] * v.y, e1[kk][i], e2[kk][i]);
        }
      }
      const float dL = (float)exp(csL);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) hacc[i] *= dL;
      fence_regs(hacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<N, 1>(hacc, e1[kk], BC::mndesc(ct, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<N, 1>(hacc, e2[kk], BC::mndesc(ct, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(hacc);
    }
    __syncthreads();  // every read of dh's terms, and every row, is done

    // dh's terms for the chunk before
    const int rw = (int)opaque(row0);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = rw + 8 * r;
      if (p >= P) continue;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        uint32_t hi, lo;
        split_pair(hacc[4 * j + 2 * r], hacc[4 * j + 2 * r + 1], hi, lo);
        sts32(sm + Pl::DH_OFF + HT::at(p, 8 * j + 2 * q), hi);
        sts32(sm + Pl::DH_OFF + HT::BYTES + HT::at(p, 8 * j + 2 * q), lo);
      }
    }
    fence_proxy_async();

    // (6) da = the reverse cumsum of dcs_r = rowsum(E)_r - colsum(E)_r +
    // de_r - dw_r, with the chunk's cs_L terms (sum_r dw_r + exp(cs_L)
    // <h_in, dh>) at row 63 (rows past the chunk add 0): warp 0, one
    // fixed order
    if (warp == 0) {
      float v[2], dws = 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = lane + 32 * i;
        const float re = rowE[r] + rowE[TC_ROWS + r] + rowE[2 * TC_ROWS + r] +
                         rowE[3 * TC_ROWS + r];
        v[i] = re - colE[r] + de[r] - dw[r];
        dws += dw[r];
      }
      dws = warp_sum(dws);
      const float hd = hdv[0] + hdv[1] + hdv[2] + hdv[3];
      if (lane == 31) v[1] += dws + (float)exp(csL) * hd;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float u = __shfl_down_sync(0xffffffffu, v[i], o);
          if (lane + o < 32) v[i] += u;
        }
      v[0] += __shfl_sync(0xffffffffu, v[1], 0);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = lane + 32 * i;
        if (r < lc) dag[(int64_t)(t0 + r) * H] = v[i];
      }
    }
    __syncthreads();  // the slot and the rows are free
  }
}

// ------------------------------------------------------------------ launch
struct SsdArgs {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
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
cudaError_t launch_f32(bool backward, const SsdArgs& a, cudaStream_t stream) {
  dim3 grid(a.H, a.Bt);
  const int64_t* st = a.st;
  const float* B = static_cast<const float*>(a.B);
  const float* C = static_cast<const float*>(a.C);
  if (!backward) {
    const size_t smem = fwd_smem_floats<L, P, N>() * sizeof(float);
    static std::atomic<bool> set[HOPPER_MAX_DEVICES];
    cudaError_t err = smem_opt_in(ssd_fwd_f32_kernel<T, L, P, N>, smem, set);
    if (err != cudaSuccess) return err;
    ssd_fwd_f32_kernel<T, L, P, N><<<grid, SSD_THREADS, smem, stream>>>(
        static_cast<const T*>(a.x), a.dt, a.A, B, C, static_cast<T*>(a.y),
        a.out1, a.out2, a.S, a.H, st[0], st[1], st[2], st[3], st[4], st[5],
        st[6], st[7], st[8]);
  } else {
    const size_t smem = bwd_smem_floats<L, P, N>() * sizeof(float);
    static std::atomic<bool> set[HOPPER_MAX_DEVICES];
    cudaError_t err = smem_opt_in(ssd_bwd_f32_kernel<T, L, P, N>, smem, set);
    if (err != cudaSuccess) return err;
    ssd_bwd_f32_kernel<T, L, P, N><<<grid, SSD_THREADS, smem, stream>>>(
        static_cast<const T*>(a.x), a.dt, a.A, B, C,
        static_cast<const T*>(a.dy), a.states_in, a.dh_final,
        static_cast<float*>(a.y), a.out1, a.out2, a.out3, a.S, a.H, st[0],
        st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
        st[10], st[11]);
  }
  return cudaGetLastError();
}

// A 4-D tensor map over a strided bf16 view: dimensions (W, rows, d2, d3)
// innermost first, element strides s1, s2, s3 of the outer three, boxes of
// `box_rows` rows x Tile<W>::BOX columns in the tile's swizzle; rows past
// `rows` read as zeros. A dimension of size 1 is never stepped, so its
// stride is replaced by a legal one.
template <int W>
cudaError_t bf16_map(CUtensorMap* map, const void* p, int rows, int d2,
                     int d3, int64_t s1, int64_t s2, int64_t s3,
                     int box_rows) {
  using T = Tile<W>;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)rows,
                              (cuuint64_t)d2, (cuuint64_t)d3};
  const int sizes[3] = {rows, d2, d3};
  const int64_t elems[3] = {s1, s2, s3};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = sizes[i] > 1 ? (cuuint64_t)elems[i] * 2 : (cuuint64_t)W * 2;
  const cuuint32_t box[4] = {(cuuint32_t)T::BOX, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      T::ROW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The per-chunk states (Bt, H, nc, P, N) float32 contiguous as a 4-D map
// (N, P, nc, Bt H), one (P x N) state a box, unswizzled.
cudaError_t states_map(CUtensorMap* map, const void* p, int P, int N, int nc,
                       int bh) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)N, (cuuint64_t)P, (cuuint64_t)nc,
                              (cuuint64_t)bh};
  const cuuint64_t strides[3] = {(cuuint64_t)N * 4, (cuuint64_t)P * N * 4,
                                 (cuuint64_t)nc * P * N * 4};
  const cuuint32_t box[4] = {(cuuint32_t)N, (cuuint32_t)P, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(p), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int L, int P, int N>
cudaError_t launch_bf16(bool backward, const SsdArgs& a,
                        cudaStream_t stream) {
  const int64_t* st = a.st;
  CUtensorMap tm_x, tm_b, tm_c;
  cudaError_t err = bf16_map<P>(&tm_x, a.x, a.S, a.H, a.Bt, st[1], st[2],
                                st[0], L);
  if (err == cudaSuccess)
    err = bf16_map<N>(&tm_b, a.B, a.S, 1, a.Bt, st[6], 0, st[5], L);
  if (err == cudaSuccess)
    err = bf16_map<N>(&tm_c, a.C, a.S, 1, a.Bt, st[8], 0, st[7], L);
  if (err != cudaSuccess) return err;
  dim3 grid(a.H, a.Bt);
  if (!backward) {
    constexpr size_t smem = FwdTc<P, N>::SMEM;
    static std::atomic<bool> set[HOPPER_MAX_DEVICES];
    err = smem_opt_in(ssd_fwd_bf16_kernel<L, P, N>, smem, set);
    if (err != cudaSuccess) return err;
    ssd_fwd_bf16_kernel<L, P, N><<<grid, TC_THREADS, smem, stream>>>(
        tm_x, tm_b, tm_c, a.dt, a.A, static_cast<__nv_bfloat16*>(a.y),
        a.out1, a.out2, a.S, a.H, st[3], st[4]);
  } else {
    CUtensorMap tm_dy, tm_st;
    const int nc = (a.S + L - 1) / L;
    err = bf16_map<P>(&tm_dy, a.dy, a.S, a.H, a.Bt, st[10], st[11], st[9],
                      L);
    if (err == cudaSuccess)
      err = states_map(&tm_st, a.states_in, P, N, nc, a.Bt * a.H);
    if (err != cudaSuccess) return err;
    constexpr size_t smem = BwdTc<P, N>::SMEM;
    static std::atomic<bool> set[HOPPER_MAX_DEVICES];
    err = smem_opt_in(ssd_bwd_bf16_kernel<L, P, N>, smem, set);
    if (err != cudaSuccess) return err;
    ssd_bwd_bf16_kernel<L, P, N><<<grid, TC_THREADS, smem, stream>>>(
        tm_x, tm_dy, tm_b, tm_c, tm_st, a.dt, a.A, a.dh_final,
        static_cast<float*>(a.y), a.out1, a.out2, a.out3, a.S, a.H, st[3],
        st[4]);
  }
  return cudaGetLastError();
}

// dtype 0: x, B, C float32; 1: x bf16, B and C float32 (the CUDA-core
// bodies); 2: x, B, C bf16 (the tensor-core bodies)
template <int L, int P, int N>
cudaError_t launch(bool backward, int dtype, const SsdArgs& a,
                   cudaStream_t s) {
  if (dtype == 0) return launch_f32<float, L, P, N>(backward, a, s);
  if (dtype == 1) return launch_f32<__nv_bfloat16, L, P, N>(backward, a, s);
  if (dtype == 2) return launch_bf16<L, P, N>(backward, a, s);
  return cudaErrorInvalidValue;
}

// The instantiated (L, P, N): chunks of 32 and 64 at mamba2-780m's head
// (P=64, N=128), zamba2's (P=64, N=64) and the smoke config's (P=16,
// N=16). ssd/ops.py's SHAPES lists the same.
int launch_any(bool backward, int dtype, int L, int P, int N,
               const SsdArgs& a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P == 64 && N == 128) {
    if (L == 64) return launch<64, 64, 128>(backward, dtype, a, s);
    if (L == 32) return launch<32, 64, 128>(backward, dtype, a, s);
  }
  if (P == 64 && N == 64) {
    if (L == 64) return launch<64, 64, 64>(backward, dtype, a, s);
    if (L == 32) return launch<32, 64, 64>(backward, dtype, a, s);
  }
  if (P == 16 && N == 16) {
    if (L == 64) return launch<64, 16, 16>(backward, dtype, a, s);
    if (L == 32) return launch<32, 16, 16>(backward, dtype, a, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: see `launch` above. strides: (batch, seq, head) of x, (batch, seq)
// of dt, B and C. y (Bt,S,H,P) in x's type, h_final (Bt,H,P,N) float32 and
// states (Bt,H,ceil(S/L),P,N) float32 (written when not null), all
// contiguous.
extern "C" int ssd_fwd(const void* x, const void* dt, const void* A,
                       const void* B, const void* C, void* y, void* h_final,
                       void* states, int dtype, int Bt, int S, int H, int P,
                       int N, int L, const int64_t* strides, void* stream) {
  SsdArgs a{x, static_cast<const float*>(dt), static_cast<const float*>(A),
            B, C, nullptr, nullptr, nullptr, y, static_cast<float*>(h_final),
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
            B, C, dy, static_cast<const float*>(states),
            static_cast<const float*>(dh_final), dxdt,
            static_cast<float*>(da), static_cast<float*>(dB),
            static_cast<float*>(dC), Bt, S, H, strides};
  return launch_any(true, dtype, L, P, N, a, stream);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
