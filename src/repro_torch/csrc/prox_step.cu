// A whole k-block of a Lasso solver's proximal-gradient updates in one
// launch, float32, against the block's sampled Gram matrices G (k, d, d)
// and right-hand sides R (k, d):
//
//   prox_step_block  for i < k:  v = w + mom(j0 + i) (w - w_prev)
//                                w_prev, w = w, prox(v - t (G_i v - R_i))
//                                W[i] = w
//   prox_loop_block  for i < k:  z <- prox(z - t (G_i z - R_i)), Q times,
//                                warm-started at the previous step's z
//                                W[i] = z
//
// They replace the Pallas kernels `prox_step` (src/repro/kernels/prox_step/
// kernel.py:89, body `_prox_step_kernel` at :62) and `prox_loop` (:77, body
// `_prox_loop_kernel` at :49) together with the `lax.scan` that applies
// them k times a block (src/repro/core/sstep.py:118-128, `_gram_block`).
// The single-call ops are their k = 1 instances: `prox_step` takes v as
// given (no momentum), `prox_loop` is prox_loop_block at k = 1. FISTA's
// momentum, mom(j) = max((j - 2) / max(j, 1), 0) in float32, is computed
// here from the host's iteration counter j0, rounded as
// core/soft_threshold.py's fista_momentum rounds it, and v is rounded as
// the three eager ops it replaces round it (__fsub_rn, __fmul_rn,
// __fadd_rn). The element-wise prox is a template parameter, as the TPU
// kernels take `variant` as a static argument:
//   0 l1           S_{lam t}(x)
//   1 elastic_net  S_{lam t}(x) / (1 + mu t)
//   2 box          clip(x, lo, hi)
//   3 none         x
// The scalars arrive as one (5,) device tensor [t, lam, mu, lo, hi] that the
// solver builds once per solve, so no launch needs a value from the host.
//
// What bounds them on an H100: a covtype block (k = 32, d = 54) reads
// k (d^2 + d) floats and writes k d, 387 KB (0.12 us at 3.35 TB/s), and does
// 2 k d^2 (times Q) FLOP; neither comes close. The time is set by the chain
// of dependent steps: every update needs all of the previous iterate, so a
// block is k (FISTA) or k Q (PNM) matrix-vector products in a row, and a
// step is a row's dot product, its shuffle butterfly, the owner's update
// and a CTA barrier, one after the other. Before this design each step cost
// a launch and the host around it, and each FISTA step three eager
// launches more for its momentum. Within a step the SM's instruction issue
// counts too: work every warp repeats is paid once a warp. The design:
//  * one launch a block, one CTA: a grid-wide barrier between two
//    dependent steps would cost more than the step at d <= 54;
//  * ceil(d / 4) warps (at most 32), each carrying four rows side by side
//    (their chains are independent); a row's dot product is summed in one
//    fixed order, lane l over j = l, l + 32, ... by fmaf, then the xor
//    butterfly 16, 8, 4, 2, 1 - the order of the one-step kernels these
//    replace - so a block is bitwise k launches of its k = 1 instance, CA
//    == classical stays bit-identical, and the solvers' iterates keep
//    their bits. Lanes 0-3 then update the four rows at once, each with
//    what it loaded before the dot product;
//  * the iterate lives in shared memory with one __syncthreads() a step:
//    for FISTA w (each element read and written only by its row's owner)
//    and v double-buffered - the owner of row r forms the next step's
//    v_r = w_r + mom (w_r - w_prev_r) as it writes w_r, from momenta
//    computed once a launch - and for PNM z double-buffered;
//  * R is staged in shared memory once (6.9 KB at covtype), the scalars and
//    their products kept in registers;
//  * the G_i come through a ring of two shared-memory stages of `per`
//    consecutive G_i each (G is contiguous, so one copy fills a stage: per =
//    9 at d = 54, 16 at d = 18 with k = 32), each with its own mbarrier:
//    chunk c + 1 is asked for at the top of chunk c's first step, once the
//    barrier before it has freed its stage, by one bulk copy (TMA without a
//    tensor map) from thread 0. Thread 0 alone waits for it, just before
//    the barrier that ends chunk c and so hands it to the CTA. A copy and a
//    wait a chunk, not a step: issuing and waiting on the step's path cost
//    more than the L2 reads they replace. A bulk copy needs G's base
//    16-byte aligned and d^2 a multiple of 4 (gram_gather returns G
//    contiguous, so an even d qualifies). Otherwise (ragged d), where two
//    G_i do not fit beside the vectors (d > 169 on an H100), and at k = 1,
//    where nothing would overlap a copy, G_i is read from global memory,
//    where gram_reduce has just written it (L2);
//  * the vectors always live in shared memory, so this route is bounded
//    by the card's opt-in shared memory (prox_loop_max_d: 19,368 on an
//    H100); the wrappers take it up to d = 256 (ops.py, ROWS_ABOVE_D) and
//    the rows route below above that;
//  * the CUDA cores, not wgmma: at d <= 54 a step is one matrix-vector
//    product, which fills no wgmma tile (64 rows by at least 8 columns),
//    and the chain, not the FLOPs, sets the time.
// Products and sums outside the dot product are rounded one by one
// (__fmul_rn / __fsub_rn / __fdiv_rn, no contraction into FMA; nvcc is not
// given --use_fast_math), so the kernels differ from the plain PyTorch
// version only in the dot product's summation order.
//
// pdhg_block: k PDHG steps (the Loris-Verhoeven form, K = I) in one launch,
// the FISTA block's design with the momentum off and the dual iterate u in
// shared memory beside w. Step i, with sigma the dual step and inv = 1/sigma:
//   q    = w - t (G_i w - R_i)        (the Pallas prox_step at variant "none",
//   wbar = q - t u                     reached by src/repro/core/
//   x    = u + sigma wbar              update_rules.py:106, pdhg_update)
//   u    = x - sigma prox_{g/sigma}(x inv)   (Moreau: prox of sigma g*)
//   w    = q - t u,  W[i] = w
// sigma is a device scalar (cfg.sigma, or 0.5 / t computed on the device),
// so nothing is read back. Its k = 1 instance is the classical solver's
// step, so CA-PDHG == PDHG bit for bit.
//
// The rows route, for large d (prox_rows_kernel): one CTA keeps the whole
// iterate in shared memory and streams all of G_i through one SM, 0.62 ms
// at d = 4,096 against 0.02 ms of bytes, and cannot hold the iterate past
// d = 19,368. Above a threshold on d alone (ops.py, ROWS_ABOVE_D = 256,
// where the two routes' measured times cross), every prox op takes a grid
// of CTAs over
// row blocks of G_i instead: 4 warps a CTA, 4 rows a warp side by side as
// above, one launch a dependent step. Each CTA rebuilds the step's point x
// (FISTA's extrapolated v from the previous two iterates, PNM's z, PDHG's
// w) from global memory, a tile of kTile elements at a time through shared
// memory, sums its rows' dot products in the one fixed order (lane l over
// j = l, l + 32, ..., then the butterfly), and writes its rows of W[i] (and
// of u). A FISTA or PDHG block is k launches, a PNM block k Q: every inner
// iteration needs all of the previous z, and a grid-wide barrier would need
// every CTA co-resident (640 CTAs at d = 20,480, more than the card holds
// at once) for a saving of a launch gap (a few us) against a step that
// reads d^2 floats (0.5 ms at d = 20,480). The route is chosen by d alone,
// so a k-block and its k = 1 instance, CA and classical, take the same one
// and keep the same bits. Its bound is bytes: G_i read once a dependent
// product.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

constexpr int kMaxWarps = 32;
constexpr int kThreads = 32 * kMaxWarps;  // at most, a CTA
constexpr int kRows = 4;       // rows a warp carries side by side
constexpr int kBarBytes = 16;  // the ring's two mbarriers, first

// How a launch runs and lays out its dynamic shared memory:
// [mbarriers (16 B) | 2 stages of `per` G_i | vectors | momenta | R?]
struct Plan {
  int per;       // G_i a ring stage holds; 0: G_i read from global memory
  int r_shared;  // R staged in shared memory
  int threads;   // 32 a warp, ceil(d / kRows) warps, at most kMaxWarps
  size_t bytes;  // dynamic shared memory of the launch
};

// nvec d-vectors and nmom momenta beside the ring
__host__ __device__ inline size_t plan_bytes(int d, int k, int nvec, int nmom,
                                             int per, bool r_shared) {
  const size_t dd = (size_t)d * d;
  return kBarBytes + (2 * (size_t)per * dd + (size_t)nvec * d + nmom +
                      (r_shared ? (size_t)k * d : 0)) * sizeof(float);
}

// the scalars [t, lam, mu, lo, hi] and the products every prox forms from
// them, each rounded once as the one-step kernels round it
struct Scal {
  float t, th, den, lo, hi;
};

__device__ __forceinline__ Scal load_scal(const float* s) {
  return {s[0], __fmul_rn(s[1], s[0]), __fadd_rn(1.f, __fmul_rn(s[2], s[0])),
          s[3], s[4]};
}

__device__ __forceinline__ float shrink(float x, float th) {
  const float r = fmaxf(__fsub_rn(fabsf(x), th), 0.f);
  return x > 0.f ? r : (x < 0.f ? -r : 0.f);  // sign(x) * r
}

// the products a prox at step `step` forms, for PDHG's dual prox at 1/sigma
__device__ __forceinline__ Scal load_scal_at(const float* s, float step) {
  return {step, __fmul_rn(s[1], step),
          __fadd_rn(1.f, __fmul_rn(s[2], step)), s[3], s[4]};
}

template <int V>
__device__ __forceinline__ float prox(float x, Scal c) {
  if constexpr (V == 0) {
    return shrink(x, c.th);
  } else if constexpr (V == 1) {
    return __fdiv_rn(shrink(x, c.th), c.den);
  } else if constexpr (V == 2) {
    return fminf(fmaxf(x, c.lo), c.hi);
  } else {
    return x;
  }
}

// one gradient-prox update of element i, given dot = (G x)_i
template <int V>
__device__ __forceinline__ float update(float xi, float dot, float ri,
                                        Scal c) {
  return prox<V>(__fsub_rn(xi, __fmul_rn(c.t, __fsub_rn(dot, ri))), c);
}

// PDHG's step after q = w - t (G w - R): the dual ascent through the
// Moreau identity and the primal correction, each op rounded as the plain
// version's eager op (moreau_dual_prox, pdhg_update)
struct WU {
  float w, u;
};

template <int V>
__device__ __forceinline__ WU pdhg_tail(float q, float u, float t,
                                        float sigma, Scal dual) {
  const float wbar = __fsub_rn(q, __fmul_rn(t, u));
  const float x = __fadd_rn(u, __fmul_rn(sigma, wbar));
  const float y = prox<V>(__fmul_rn(x, dual.t), dual);
  const float u_new = __fsub_rn(x, __fmul_rn(sigma, y));
  WU r;
  r.w = __fsub_rn(q, __fmul_rn(t, u_new));
  r.u = u_new;
  return r;
}

// FISTA's momentum (j - 2) / j, zero-clamped, as fista_momentum rounds it
__device__ __forceinline__ float fista_mom(int j) {
  const float jf = __int2float_rn(j);
  return fmaxf(__fdiv_rn(__fsub_rn(jf, 2.f), fmaxf(jf, 1.f)), 0.f);
}

// v = w + mom (w - w_prev), the three eager ops' roundings
__device__ __forceinline__ float extrapolate(float w, float w_prev,
                                             float mom) {
  return __fadd_rn(w, __fmul_rn(mom, __fsub_rn(w, w_prev)));
}

// One pass of a warp: rows r0 + t warps (t < kRows) of G times x, each
// summed in the one fixed order - lane l over j = l, l + 32, ... by fmaf,
// then the xor butterfly 16, 8, 4, 2, 1 - with the kRows chains side by
// side (a row past d recomputes r0). Lane t < kRows returns row
// r0 + t warps's sum, which it then owns.
template <typename X>
__device__ __forceinline__ float dot_rows(const float* g, int d, int r0,
                                          int warps, X xat, int lane) {
  const float* gr[kRows];
  float acc[kRows];
#pragma unroll
  for (int t = 0; t < kRows; ++t) {
    const int row = r0 + t * warps < d ? r0 + t * warps : r0;
    gr[t] = g + (int64_t)row * d;
    acc[t] = 0.f;
  }
  for (int j = lane; j < d; j += 32) {
    const float xj = xat(j);
#pragma unroll
    for (int t = 0; t < kRows; ++t) acc[t] = fmaf(gr[t][j], xj, acc[t]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int t = 0; t < kRows; ++t)
      acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], o);
  }
  float mine = acc[0];
#pragma unroll
  for (int t = 1; t < kRows; ++t) mine = lane == t ? acc[t] : mine;
  return mine;
}

// The G_i of a block. With RING, two shared-memory stages of `per`
// consecutive G_i each (a chunk: G is contiguous, so one copy a chunk):
// chunk c lands in stage c % 2; chunk c + 1 is asked for at the top of
// chunk c's first step, when the barrier before it has freed its stage,
// and thread 0 alone waits for it just before the barrier that ends chunk
// c's last step, so that barrier hands it to the CTA. Without RING, global
// memory.
template <bool RING>
struct Ring {
  const float* G;  // (k, d, d)
  float* stage;    // 2 stages of per * d * d floats
  uint32_t bar;    // their mbarriers, 8 bytes apart
  int64_t dd;
  int per, k;

  // one expect_tx arrival a copy
  __device__ __forceinline__ void init() const {
    if (!RING || threadIdx.x != 0) return;
    mbar_init(bar, 1u);
    mbar_init(bar + 8, 1u);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // ask for chunk c (no-op past the block): one bulk copy from thread 0
  __device__ __forceinline__ void issue(int c) const {
    const int64_t first = (int64_t)c * per;
    if (!RING || first >= k || threadIdx.x != 0) return;
    const int64_t n = (k - first < per ? k - first : per) * dd;
    const uint32_t b = bar + 8 * (c & 1);
    const uint32_t bytes = (uint32_t)(n * sizeof(float));
    mbar_expect_tx(b, bytes);
    bulk_load(smem_addr(stage + (c & 1) * per * dd), G + first * dd, bytes,
              b);
  }

  // thread 0 waits until chunk c has landed (no-op past the block)
  __device__ __forceinline__ void land(int c) const {
    if (!RING || (int64_t)c * per >= k || threadIdx.x != 0) return;
    mbar_wait(bar + 8 * (c & 1), (uint32_t)(c >> 1) & 1u);
  }

  // the prologue: chunks 0 and 1 asked for, chunk 0 landed (a
  // __syncthreads() must follow)
  __device__ __forceinline__ void start() const {
    issue(0);
    issue(1);
    land(0);
  }

  // Step i reads G_i, position `pos` of chunk `chunk` (kept by next(), so
  // no division on the step's path).
  // top of a step: the chunk after this one, into the stage just freed
  __device__ __forceinline__ void top(int chunk, int pos) const {
    if (RING && pos == 0 && chunk > 0) issue(chunk + 1);
  }

  // bottom of a step, before its barrier: the next chunk, landed
  __device__ __forceinline__ void bottom(int chunk, int pos) const {
    if (RING && pos == per - 1) land(chunk + 1);
  }

  // G_i, landed
  __device__ __forceinline__ const float* at(int i, int chunk,
                                             int pos) const {
    if (!RING) return G + i * dd;
    return stage + ((chunk & 1) * per + pos) * dd;
  }

  __device__ __forceinline__ void next(int& chunk, int& pos) const {
    if (++pos == per) {
      pos = 0;
      ++chunk;
    }
  }
};

template <int V, bool RING>
__global__ void __launch_bounds__(kThreads)
prox_step_block_kernel(const float* __restrict__ G,
                       const float* __restrict__ R,
                       const float* __restrict__ w_prev0,
                       const float* __restrict__ w0,
                       const float* __restrict__ scal, float* __restrict__ W,
                       int d, int k, int j0, int momentum, Plan plan) {
  // [bars | ring | w (d) | v (d) | v next (d) | momenta (k + 1) | R?]
  extern __shared__ __align__(128) unsigned char sm[];
  float* stage = reinterpret_cast<float*>(sm + kBarBytes);
  float* w = stage + 2 * (int64_t)plan.per * d * d;
  float* v = w + d;
  float* vn = v + d;
  float* moms = vn + d;
  float* rs = moms + k + 1;
  const Ring<RING> ring{G, stage, smem_addr(sm), (int64_t)d * d, plan.per, k};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const bool on = momentum != 0;
  const Scal sc = load_scal(scal);
  ring.init();
  {
    const float mom = on ? fista_mom(j0) : 0.f;
    for (int e = threadIdx.x; e < d; e += blockDim.x) {
      w[e] = w0[e];
      v[e] = on ? extrapolate(w0[e], w_prev0[e], mom) : w0[e];
    }
  }
  for (int i = threadIdx.x; i <= k; i += blockDim.x)
    moms[i] = on ? fista_mom(j0 + i) : 0.f;
  const float* r = R;
  if (plan.r_shared) {
    for (int64_t e = threadIdx.x; e < (int64_t)k * d; e += blockDim.x)
      rs[e] = R[e];
    r = rs;
  }
  __syncthreads();  // the barriers' init, before any copy counts on them
  ring.start();
  __syncthreads();

  for (int i = 0, chunk = 0, pos = 0; i < k; ++i, ring.next(chunk, pos)) {
    ring.top(chunk, pos);
    const float* g = ring.at(i, chunk, pos);
    const float mom = moms[i + 1];  // v's for the next step
    const float* ri = r + (int64_t)i * d;
    float* wi = W + (int64_t)i * d;
    for (int r0 = warp; r0 < d; r0 += kRows * warps) {
      // the row this lane owns, and what its update reads, loaded before
      // the dot product so their latency hides under it
      const int row = r0 + lane * warps;
      const bool own = lane < kRows && row < d;
      const int at = own ? row : r0;
      const float v_row = v[at], r_row = ri[at], w_row = w[at];
      const float sum =
          dot_rows(g, d, r0, warps, [v](int j) { return v[j]; }, lane);
      if (own) {
        const float x = update<V>(v_row, sum, r_row, sc);
        wi[row] = x;
        vn[row] = on ? extrapolate(x, w_row, mom) : x;
        w[row] = x;  // only this lane reads or writes w[row]
      }
    }
    ring.bottom(chunk, pos);
    __syncthreads();
    float* t = v;
    v = vn;
    vn = t;
  }
}

template <int V, bool RING>
__global__ void __launch_bounds__(kThreads)
prox_loop_block_kernel(const float* __restrict__ G,
                       const float* __restrict__ R,
                       const float* __restrict__ z0,
                       const float* __restrict__ scal, float* __restrict__ W,
                       int d, int k, int Q, Plan plan) {
  if (Q == 0) {  // no iteration: every step returns its warm start
    const int64_t kd = (int64_t)k * d;
    for (int64_t e = threadIdx.x; e < kd; e += blockDim.x) W[e] = z0[e % d];
    return;
  }
  // [bars | ring | z (d) | z next (d) | R?]
  extern __shared__ __align__(128) unsigned char sm[];
  float* stage = reinterpret_cast<float*>(sm + kBarBytes);
  float* z = stage + 2 * (int64_t)plan.per * d * d;
  float* zn = z + d;
  float* rs = zn + d;
  const Ring<RING> ring{G, stage, smem_addr(sm), (int64_t)d * d, plan.per, k};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const Scal sc = load_scal(scal);
  ring.init();
  for (int e = threadIdx.x; e < d; e += blockDim.x) z[e] = z0[e];
  const float* r = R;
  if (plan.r_shared) {
    for (int64_t e = threadIdx.x; e < (int64_t)k * d; e += blockDim.x)
      rs[e] = R[e];
    r = rs;
  }
  __syncthreads();  // the barriers' init, before any copy counts on them
  ring.start();
  __syncthreads();

  for (int i = 0, chunk = 0, pos = 0; i < k; ++i, ring.next(chunk, pos)) {
    ring.top(chunk, pos);
    const float* g = ring.at(i, chunk, pos);
    const float* ri = r + (int64_t)i * d;
    float* wi = W + (int64_t)i * d;
    for (int q = 0; q < Q; ++q) {
      for (int r0 = warp; r0 < d; r0 += kRows * warps) {
        const int row = r0 + lane * warps;
        const bool own = lane < kRows && row < d;
        const int at = own ? row : r0;
        const float z_row = z[at], r_row = ri[at];
        const float sum =
            dot_rows(g, d, r0, warps, [z](int j) { return z[j]; }, lane);
        if (own) {
          const float x = update<V>(z_row, sum, r_row, sc);
          zn[row] = x;
          if (q == Q - 1) wi[row] = x;
        }
      }
      if (q == Q - 1) ring.bottom(chunk, pos);
      __syncthreads();
      float* t = z;
      z = zn;
      zn = t;
    }
  }
}

// element j of a vector in shared memory, for dot_rows (a functor: nvcc
// 12.8's front end fails with an internal error, "i_copy_expr_tree", on a
// lambda capturing the iterate in pdhg_block_kernel)
struct SharedVec {
  const float* p;
  __device__ __forceinline__ float operator()(int j) const { return p[j]; }
};

template <int V, bool RING>
__global__ void __launch_bounds__(kThreads)
pdhg_block_kernel(const float* __restrict__ G, const float* __restrict__ R,
                  const float* __restrict__ w0, const float* __restrict__ u0,
                  const float* __restrict__ scal,
                  const float* __restrict__ sig, float* __restrict__ W,
                  float* __restrict__ u_out, int d, int k, Plan plan) {
  // [bars | ring | w (d) | w next (d) | u (d) | R?]
  extern __shared__ __align__(128) unsigned char sm[];
  float* stage = reinterpret_cast<float*>(sm + kBarBytes);
  float* w = stage + 2 * (int64_t)plan.per * d * d;
  float* wn = w + d;
  float* u = wn + d;
  float* rs = u + d;
  const Ring<RING> ring{G, stage, smem_addr(sm), (int64_t)d * d, plan.per, k};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const Scal sc = load_scal(scal);
  const float sigma = sig[0];
  const Scal dual = load_scal_at(scal, __fdiv_rn(1.f, sigma));
  ring.init();
  for (int e = threadIdx.x; e < d; e += blockDim.x) {
    w[e] = w0[e];
    u[e] = u0[e];
  }
  const float* r = R;
  if (plan.r_shared) {
    for (int64_t e = threadIdx.x; e < (int64_t)k * d; e += blockDim.x)
      rs[e] = R[e];
    r = rs;
  }
  __syncthreads();  // the barriers' init, before any copy counts on them
  ring.start();
  __syncthreads();

  for (int i = 0, chunk = 0, pos = 0; i < k; ++i, ring.next(chunk, pos)) {
    ring.top(chunk, pos);
    const float* g = ring.at(i, chunk, pos);
    const float* ri = r + (int64_t)i * d;
    float* wi = W + (int64_t)i * d;
    for (int r0 = warp; r0 < d; r0 += kRows * warps) {
      const int row = r0 + lane * warps;
      const bool own = lane < kRows && row < d;
      const int at = own ? row : r0;
      // u[row] is read and written only by its row's owner
      const float w_row = w[at], r_row = ri[at], u_row = u[at];
      const float sum = dot_rows(g, d, r0, warps, SharedVec{w}, lane);
      if (own) {
        const float q = update<3>(w_row, sum, r_row, sc);
        const WU nx = pdhg_tail<V>(q, u_row, sc.t, sigma, dual);
        wi[row] = nx.w;
        wn[row] = nx.w;
        u[row] = nx.u;
        if (i == k - 1) u_out[row] = nx.u;
      }
    }
    ring.bottom(chunk, pos);
    __syncthreads();
    float* t = w;
    w = wn;
    wn = t;
  }
}

// The rows route: a grid of CTAs over row blocks of one G_i, a dependent
// step a launch. x (the step's point) is formed from global memory: x_cur
// as it is, or FISTA's extrapolation from x_cur and x_prev with the
// momentum of iteration j (momentum != 0). PDHG also reads u_in and writes
// u_out. Owners write out[row].
constexpr int kRowsWarps = 4;                    // warps a CTA
constexpr int kRowsPerCta = kRows * kRowsWarps;  // rows a CTA
constexpr int kRowsThreads = 32 * kRowsWarps;    // threads a CTA
constexpr int kTile = 2048;                      // x elements a pass

// element e of a rows-route step's point: x_cur, or FISTA's extrapolation
__device__ __forceinline__ float point(const float* x_cur,
                                       const float* x_prev, int64_t e,
                                       bool on, float mom) {
  return on ? extrapolate(x_cur[e], x_prev[e], mom) : x_cur[e];
}

template <int V, bool PDHG>
__global__ void __launch_bounds__(kRowsThreads)
prox_rows_kernel(const float* __restrict__ G, const float* __restrict__ R,
                 const float* __restrict__ x_cur,
                 const float* __restrict__ x_prev, int j, int momentum,
                 const float* __restrict__ u_in, float* __restrict__ u_out,
                 const float* __restrict__ scal,
                 const float* __restrict__ sig, float* __restrict__ out,
                 int d) {
  __shared__ float xs[kTile];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t base = (int64_t)blockIdx.x * kRowsPerCta + warp * kRows;
  const bool on = momentum != 0;
  const float mom = on ? fista_mom(j) : 0.f;
  const float* gr[kRows];
  float acc[kRows];
#pragma unroll
  for (int t = 0; t < kRows; ++t) {
    int64_t row = base + t < d ? base + t : base;
    row = row < d ? row : d - 1;  // a warp past d reads a row and drops it
    gr[t] = G + row * d;
    acc[t] = 0.f;
  }
  const int64_t row = base + lane;
  const bool own = lane < kRows && row < d;
  const int64_t at = own ? row : 0;
  const float x_row = point(x_cur, x_prev, at, on, mom), r_row = R[at];
  const float u_row = PDHG ? u_in[at] : 0.f;
  for (int64_t j0 = 0; j0 < d; j0 += kTile) {
    const int n = d - j0 < kTile ? (int)(d - j0) : kTile;
    __syncthreads();  // the last tile has been read
    for (int e = threadIdx.x; e < n; e += blockDim.x)
      xs[e] = point(x_cur, x_prev, j0 + e, on, mom);
    __syncthreads();
    for (int c = lane; c < n; c += 32) {
      const float xc = xs[c];
#pragma unroll
      for (int t = 0; t < kRows; ++t)
        acc[t] = fmaf(gr[t][j0 + c], xc, acc[t]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int t = 0; t < kRows; ++t)
      acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], o);
  }
  float mine = acc[0];
#pragma unroll
  for (int t = 1; t < kRows; ++t) mine = lane == t ? acc[t] : mine;
  if (!own) return;
  const Scal sc = load_scal(scal);
  if (PDHG) {
    const float sigma = sig[0];
    const Scal dual = load_scal_at(scal, __fdiv_rn(1.f, sigma));
    const float q = update<3>(x_row, mine, r_row, sc);
    const WU nx = pdhg_tail<V>(q, u_row, sc.t, sigma, dual);
    out[row] = nx.w;
    u_out[row] = nx.u;
  } else {
    out[row] = update<V>(x_row, mine, r_row, sc);
  }
}

int max_optin_smem() {
  static int cached[HOPPER_MAX_DEVICES] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= HOPPER_MAX_DEVICES) dev = HOPPER_MAX_DEVICES - 1;
  if (!cached[dev])
    cudaDeviceGetAttribute(&cached[dev],
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return cached[dev];
}

// The ring's plan: two stages of as many G_i as fit (at most half the
// block, so chunk 1 is in flight while chunk 0 is read), R staged when it
// fits too; G_i from global memory (L2-resident after gram_reduce) at k = 1,
// where nothing would overlap a copy, where a bulk copy cannot fill a stage,
// and where two G_i do not fit.
Plan make_plan(const float* G, int d, int k, int nvec, int nmom) {
  const size_t limit = (size_t)max_optin_smem();
  const size_t dd4 = (size_t)d * d * sizeof(float);
  const bool bulk = (reinterpret_cast<uintptr_t>(G) & 15u) == 0 &&
                    ((int64_t)d * d) % 4 == 0;
  int warps = (d + kRows - 1) / kRows;
  warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
  const int threads = 32 * warps;
  if (k >= 2 && bulk) {
    for (int r_shared = 1; r_shared >= 0; --r_shared) {
      const size_t fixed = plan_bytes(d, k, nvec, nmom, 0, r_shared);
      if (fixed >= limit) continue;
      size_t per = (limit - fixed) / (2 * dd4);
      if (per > (size_t)(k + 1) / 2) per = (k + 1) / 2;
      if (per >= 1)
        return {(int)per, r_shared, threads,
                plan_bytes(d, k, nvec, nmom, (int)per, r_shared)};
    }
  }
  const bool r_fits = plan_bytes(d, k, nvec, nmom, 0, true) <= limit;
  return {0, r_fits ? 1 : 0, threads,
          plan_bytes(d, k, nvec, nmom, 0, r_fits)};
}

template <int V, bool RING>
int launch_step(const float* G, const float* R, const float* w_prev,
                const float* w, const float* scal, float* W, int d, int k,
                int j0, int momentum, const Plan& p, cudaStream_t st) {
  static std::atomic<bool> set[HOPPER_MAX_DEVICES];
  cudaError_t e = smem_opt_in(prox_step_block_kernel<V, RING>,
                              (size_t)max_optin_smem(), set);
  if (e != cudaSuccess) return (int)e;
  prox_step_block_kernel<V, RING><<<1, p.threads, p.bytes, st>>>(
      G, R, w_prev, w, scal, W, d, k, j0, momentum, p);
  return 0;
}

template <int V, bool RING>
int launch_loop(const float* G, const float* R, const float* z0,
                const float* scal, float* W, int d, int k, int Q,
                const Plan& p, cudaStream_t st) {
  static std::atomic<bool> set[HOPPER_MAX_DEVICES];
  cudaError_t e = smem_opt_in(prox_loop_block_kernel<V, RING>,
                              (size_t)max_optin_smem(), set);
  if (e != cudaSuccess) return (int)e;
  prox_loop_block_kernel<V, RING><<<1, p.threads, p.bytes, st>>>(
      G, R, z0, scal, W, d, k, Q, p);
  return 0;
}

template <int V, bool RING>
int launch_pdhg(const float* G, const float* R, const float* w0,
                const float* u0, const float* scal, const float* sig,
                float* W, float* u_out, int d, int k, const Plan& p,
                cudaStream_t st) {
  static std::atomic<bool> set[HOPPER_MAX_DEVICES];
  cudaError_t e = smem_opt_in(pdhg_block_kernel<V, RING>,
                              (size_t)max_optin_smem(), set);
  if (e != cudaSuccess) return (int)e;
  pdhg_block_kernel<V, RING><<<1, p.threads, p.bytes, st>>>(
      G, R, w0, u0, scal, sig, W, u_out, d, k, p);
  return 0;
}

template <int V>
int pdhg_variant(const float* G, const float* R, const float* w0,
                 const float* u0, const float* scal, const float* sig,
                 float* W, float* u_out, int d, int k, cudaStream_t st) {
  const Plan p = make_plan(G, d, k, 3, 0);
  if (p.bytes > (size_t)max_optin_smem()) return (int)cudaErrorInvalidValue;
  return p.per > 0 ? launch_pdhg<V, true>(G, R, w0, u0, scal, sig, W, u_out,
                                          d, k, p, st)
                   : launch_pdhg<V, false>(G, R, w0, u0, scal, sig, W,
                                           u_out, d, k, p, st);
}

// one launch of the rows route: the step whose point is x_cur (extrapolated
// from x_prev with the momentum of iteration j when momentum != 0)
template <int V, bool PDHG>
int launch_rows(const float* G, const float* R, const float* x_cur,
                const float* x_prev, int j, int momentum, const float* u_in,
                float* u_out, const float* scal, const float* sig,
                float* out, int d, cudaStream_t st) {
  const int64_t ctas = ((int64_t)d + kRowsPerCta - 1) / kRowsPerCta;
  prox_rows_kernel<V, PDHG><<<(unsigned)ctas, kRowsThreads, 0, st>>>(
      G, R, x_cur, x_prev, j, momentum, u_in, u_out, scal, sig, out, d);
  return (int)cudaGetLastError();
}

// k FISTA steps on the rows route (momentum off: k ISTA steps from w)
template <int V>
int rows_step(const float* G, const float* R, const float* w_prev,
              const float* w, const float* scal, float* W, int d, int k,
              int j0, int momentum, cudaStream_t st) {
  const int64_t dd = (int64_t)d * d;
  for (int i = 0; i < k; ++i) {
    const float* cur = i == 0 ? w : W + (int64_t)(i - 1) * d;
    const float* prev =
        i == 0 ? w_prev : (i == 1 ? w : W + (int64_t)(i - 2) * d);
    const int e = launch_rows<V, false>(G + i * dd, R + (int64_t)i * d, cur,
                                        prev, j0 + i, momentum, nullptr,
                                        nullptr, scal, nullptr,
                                        W + (int64_t)i * d, d, st);
    if (e) return e;
  }
  return 0;
}

// k proximal Newton steps of Q on the rows route: a launch an inner
// iteration, z ping-ponging through scratch (2 d floats)
template <int V>
int rows_loop(const float* G, const float* R, const float* z0,
              const float* scal, float* W, float* scratch, int d, int k,
              int Q, cudaStream_t st) {
  const int64_t dd = (int64_t)d * d;
  for (int i = 0; i < k; ++i) {
    float* wi = W + (int64_t)i * d;
    const float* from = i == 0 ? z0 : W + (int64_t)(i - 1) * d;
    if (Q == 0) {  // no iteration: the step returns its warm start
      cudaError_t e = cudaMemcpyAsync(wi, from, (size_t)d * sizeof(float),
                                      cudaMemcpyDeviceToDevice, st);
      if (e != cudaSuccess) return (int)e;
      continue;
    }
    for (int q = 0; q < Q; ++q) {
      const float* src = q == 0 ? from : scratch + ((q - 1) & 1) * (int64_t)d;
      float* dst = q == Q - 1 ? wi : scratch + (q & 1) * (int64_t)d;
      const int e = launch_rows<V, false>(G + i * dd, R + (int64_t)i * d,
                                          src, src, 0, 0, nullptr, nullptr,
                                          scal, nullptr, dst, d, st);
      if (e) return e;
    }
  }
  return 0;
}

// k PDHG steps on the rows route, u ping-ponging through scratch (2 d
// floats) into u_out at the last step
template <int V>
int rows_pdhg(const float* G, const float* R, const float* w0,
              const float* u0, const float* scal, const float* sig, float* W,
              float* u_out, float* scratch, int d, int k, cudaStream_t st) {
  const int64_t dd = (int64_t)d * d;
  for (int i = 0; i < k; ++i) {
    const float* w = i == 0 ? w0 : W + (int64_t)(i - 1) * d;
    const float* u = i == 0 ? u0 : scratch + ((i - 1) & 1) * (int64_t)d;
    float* un = i == k - 1 ? u_out : scratch + (i & 1) * (int64_t)d;
    const int e = launch_rows<V, true>(G + i * dd, R + (int64_t)i * d, w, w,
                                       0, 0, u, un, scal, sig,
                                       W + (int64_t)i * d, d, st);
    if (e) return e;
  }
  return 0;
}

template <int V>
int step_variant(const float* G, const float* R, const float* w_prev,
                 const float* w, const float* scal, float* W, int d, int k,
                 int j0, int momentum, cudaStream_t st) {
  const Plan p = make_plan(G, d, k, 3, k + 1);
  if (p.bytes > (size_t)max_optin_smem()) return (int)cudaErrorInvalidValue;
  return p.per > 0
             ? launch_step<V, true>(G, R, w_prev, w, scal, W, d, k, j0,
                                    momentum, p, st)
             : launch_step<V, false>(G, R, w_prev, w, scal, W, d, k, j0,
                                     momentum, p, st);
}

template <int V>
int loop_variant(const float* G, const float* R, const float* z0,
                 const float* scal, float* W, int d, int k, int Q,
                 cudaStream_t st) {
  const Plan p = make_plan(G, d, k, 2, 0);
  if (p.bytes > (size_t)max_optin_smem()) return (int)cudaErrorInvalidValue;
  return p.per > 0
             ? launch_loop<V, true>(G, R, z0, scal, W, d, k, Q, p, st)
             : launch_loop<V, false>(G, R, z0, scal, W, d, k, Q, p, st);
}

int step_block(const float* G, const float* R, const float* w_prev,
               const float* w, const float* scal, float* W, int d, int k,
               int j0, int momentum, int variant, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = 0;
  switch (variant) {
    case 0: err = step_variant<0>(G, R, w_prev, w, scal, W, d, k, j0, momentum, st); break;
    case 1: err = step_variant<1>(G, R, w_prev, w, scal, W, d, k, j0, momentum, st); break;
    case 2: err = step_variant<2>(G, R, w_prev, w, scal, W, d, k, j0, momentum, st); break;
    case 3: err = step_variant<3>(G, R, w_prev, w, scal, W, d, k, j0, momentum, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return (int)cudaGetLastError();
}

// The largest d that `fits` accepts.
template <typename F>
int largest_d(F fits) {
  const size_t limit = (size_t)max_optin_smem();
  int d = 0;
  while (fits(d + 1, limit)) ++d;
  return d;
}

}  // namespace

extern "C" {

// G (k, d, d), R (k, d), w_prev, w (d,), scal (5,) = [t, lam, mu, lo, hi],
// W (k, d); all float32 on the device. j0: the iteration counter at the
// block's first step. variant: 0 l1, 1 elastic_net, 2 box, 3 none.
int prox_step_block_f32(const float* G, const float* R, const float* w_prev,
                        const float* w, const float* scal, float* W, int d,
                        int k, int j0, int variant, void* stream) {
  return step_block(G, R, w_prev, w, scal, W, d, k, j0, 1, variant, stream);
}

// G (d, d), R, v, out (d,): one step at v as given (no momentum)
int prox_step_f32(const float* G, const float* R, const float* v,
                  const float* scal, float* out, int d, int variant,
                  void* stream) {
  return step_block(G, R, v, v, scal, out, d, 1, 0, 0, variant, stream);
}

// G (k, d, d), R (k, d), z0 (d,), W (k, d): Q iterations a step; prox_loop
// is its k = 1 instance
int prox_loop_block_f32(const float* G, const float* R, const float* z0,
                        const float* scal, float* W, int d, int k, int Q,
                        int variant, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = 0;
  switch (variant) {
    case 0: err = loop_variant<0>(G, R, z0, scal, W, d, k, Q, st); break;
    case 1: err = loop_variant<1>(G, R, z0, scal, W, d, k, Q, st); break;
    case 2: err = loop_variant<2>(G, R, z0, scal, W, d, k, Q, st); break;
    case 3: err = loop_variant<3>(G, R, z0, scal, W, d, k, Q, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return (int)cudaGetLastError();
}

// Largest d whose G_i go through the ring (one G_i a stage, k = 2, d^2 a
// multiple of 4) on the current device.
int prox_loop_max_shared_d(void) {
  return largest_d([](int d, size_t limit) {
    return plan_bytes(d, 2, 3, 3, 1, false) <= limit;
  });
}

// Largest d the kernels take at all (their vectors live in shared memory).
int prox_loop_max_d(void) {
  return largest_d([](int d, size_t limit) {
    return plan_bytes(d, 1, 3, 2, 0, false) <= limit;
  });
}

// G (k, d, d), R (k, d), w, u (d,), scal (5,), sig (1,) = [sigma], W (k, d),
// u_out (d,): k PDHG steps in one launch (one CTA)
int pdhg_block_f32(const float* G, const float* R, const float* w,
                   const float* u, const float* scal, const float* sig,
                   float* W, float* u_out, int d, int k, int variant,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = 0;
  switch (variant) {
    case 0: err = pdhg_variant<0>(G, R, w, u, scal, sig, W, u_out, d, k, st); break;
    case 1: err = pdhg_variant<1>(G, R, w, u, scal, sig, W, u_out, d, k, st); break;
    case 2: err = pdhg_variant<2>(G, R, w, u, scal, sig, W, u_out, d, k, st); break;
    case 3: err = pdhg_variant<3>(G, R, w, u, scal, sig, W, u_out, d, k, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return (int)cudaGetLastError();
}

// The rows route, a launch a dependent step. As prox_step_block_f32
// (momentum 0: k ISTA steps from w, w_prev unread) ...
int prox_rows_step_f32(const float* G, const float* R, const float* w_prev,
                       const float* w, const float* scal, float* W, int d,
                       int k, int j0, int momentum, int variant,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return rows_step<0>(G, R, w_prev, w, scal, W, d, k, j0, momentum, st);
    case 1: return rows_step<1>(G, R, w_prev, w, scal, W, d, k, j0, momentum, st);
    case 2: return rows_step<2>(G, R, w_prev, w, scal, W, d, k, j0, momentum, st);
    case 3: return rows_step<3>(G, R, w_prev, w, scal, W, d, k, j0, momentum, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ... as prox_loop_block_f32, scratch (2 d floats) ...
int prox_rows_loop_f32(const float* G, const float* R, const float* z0,
                       const float* scal, float* W, float* scratch, int d,
                       int k, int Q, int variant, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return rows_loop<0>(G, R, z0, scal, W, scratch, d, k, Q, st);
    case 1: return rows_loop<1>(G, R, z0, scal, W, scratch, d, k, Q, st);
    case 2: return rows_loop<2>(G, R, z0, scal, W, scratch, d, k, Q, st);
    case 3: return rows_loop<3>(G, R, z0, scal, W, scratch, d, k, Q, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ... and as pdhg_block_f32, scratch (2 d floats)
int prox_rows_pdhg_f32(const float* G, const float* R, const float* w,
                       const float* u, const float* scal, const float* sig,
                       float* W, float* u_out, float* scratch, int d, int k,
                       int variant, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return rows_pdhg<0>(G, R, w, u, scal, sig, W, u_out, scratch, d, k, st);
    case 1: return rows_pdhg<1>(G, R, w, u, scal, sig, W, u_out, scratch, d, k, st);
    case 2: return rows_pdhg<2>(G, R, w, u, scal, sig, W, u_out, scratch, d, k, st);
    case 3: return rows_pdhg<3>(G, R, w, u, scal, sig, W, u_out, scratch, d, k, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
