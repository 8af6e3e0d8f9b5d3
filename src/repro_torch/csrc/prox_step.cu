// Fused proximal-gradient steps against a sampled Gram matrix, float32.
//
//   prox_step: w+ = prox(v - t (G v - R))             one step
//   prox_loop: z <- prox(z - t (G z - R)), Q times     warm-started at z0
//
// Replaces the Pallas kernels `prox_step` (src/repro/kernels/prox_step/
// kernel.py:89, body `_prox_step_kernel` at :62) and `prox_loop` (:77, body
// `_prox_loop_kernel` at :49). The element-wise prox is a template parameter,
// as the TPU kernels take `variant` as a static argument:
//   0 l1           S_{lam t}(x)
//   1 elastic_net  S_{lam t}(x) / (1 + mu t)
//   2 box          clip(x, lo, hi)
//   3 none         x
// The scalars arrive as one (5,) device tensor [t, lam, mu, lo, hi] that the
// solver builds once per solve, so no launch needs a value from the host.
//
// What bounds them on an H100: at the paper's d <= 54 a call touches at most
// d^2*4 + 4*d*4 bytes (12 KB) and does 2*d^2*(Q) FLOP, microseconds of
// nothing: both are bound by launch latency, and by the dependency chain of
// the Q matvecs in prox_loop. The design keeps each call to one launch:
//  * prox_step: one warp per row, the row's dot product reduced by shuffles
//    in a fixed order, the prox applied by lane 0.
//  * prox_loop: every iteration needs all of z, so the whole loop runs in one
//    CTA with z double-buffered in shared memory and a __syncthreads()
//    between iterations. G is staged in shared memory once when
//    (d^2 + 3d + 8)*4 bytes fit the card's opt-in limit (227 KB on an H100: d up
//    to 239); above that the same kernel reads G from global memory, where
//    it stays in L2 across the Q iterations. So every d runs on the card.
// Products and sums outside the dot product are rounded one by one
// (__fmul_rn / __fsub_rn, no contraction into FMA), so the kernels differ
// from the plain PyTorch version only in the dot product's summation order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // prox_step: 8 warps, one row per warp
constexpr int kLoopThreads = 512;   // prox_loop: 16 warps in the one CTA
constexpr int kScal = 8;            // prox_loop's shared scalars, padded

__device__ __forceinline__ float shrink(float x, float th) {
  const float r = fmaxf(__fsub_rn(fabsf(x), th), 0.f);
  return x > 0.f ? r : (x < 0.f ? -r : 0.f);  // sign(x) * r
}

// s = [t, lam, mu, lo, hi]
template <int V>
__device__ __forceinline__ float prox(float x, const float* s) {
  if constexpr (V == 0) {
    return shrink(x, __fmul_rn(s[1], s[0]));
  } else if constexpr (V == 1) {
    return __fdiv_rn(shrink(x, __fmul_rn(s[1], s[0])),
                     __fadd_rn(1.f, __fmul_rn(s[2], s[0])));
  } else if constexpr (V == 2) {
    return fminf(fmaxf(x, s[3]), s[4]);
  } else {
    return x;
  }
}

// one gradient-prox update of element i, given dot = (G x)_i
template <int V>
__device__ __forceinline__ float update(float xi, float dot, float ri,
                                        const float* s) {
  return prox<V>(__fsub_rn(xi, __fmul_rn(s[0], __fsub_rn(dot, ri))), s);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
prox_step_kernel(const float* __restrict__ G, const float* __restrict__ R,
                 const float* __restrict__ v, const float* __restrict__ scal,
                 float* __restrict__ out, int d) {
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int i = blockIdx.x * warps + (threadIdx.x >> 5); i < d;
       i += gridDim.x * warps) {
    const float* g = G + (int64_t)i * d;
    float s = 0.f;
    for (int j = lane; j < d; j += 32) s = fmaf(g[j], v[j], s);
    s = warp_sum(s);
    if (lane == 0) out[i] = update<V>(v[i], s, R[i], scal);
  }
}

template <int V, bool G_SHARED>
__global__ void __launch_bounds__(kLoopThreads)
prox_loop_kernel(const float* __restrict__ G, const float* __restrict__ R,
                 const float* __restrict__ z0, const float* __restrict__ scal,
                 float* __restrict__ out, int d, int Q) {
  // [scalars (8) | z (d) | z next (d) | R (d) | G (d*d) when G_SHARED]
  extern __shared__ float sm[];
  float* s = sm;
  float* z = sm + kScal;
  float* zn = z + d;
  float* r = zn + d;
  float* gs = r + d;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;

  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    z[i] = z0[i];
    r[i] = R[i];
  }
  if (threadIdx.x < 5) s[threadIdx.x] = scal[threadIdx.x];
  if (G_SHARED) {
    const int64_t dd = (int64_t)d * d;
    for (int64_t e = threadIdx.x; e < dd; e += blockDim.x) gs[e] = G[e];
  }
  __syncthreads();
  const float* g = G_SHARED ? gs : G;

  for (int q = 0; q < Q; ++q) {
    for (int i = warp; i < d; i += warps) {
      const float* gi = g + (int64_t)i * d;
      float acc = 0.f;
      for (int j = lane; j < d; j += 32) acc = fmaf(gi[j], z[j], acc);
      acc = warp_sum(acc);
      if (lane == 0) zn[i] = update<V>(z[i], acc, r[i], s);
    }
    __syncthreads();
    float* tmp = z;
    z = zn;
    zn = tmp;
  }
  for (int i = threadIdx.x; i < d; i += blockDim.x) out[i] = z[i];
}

int max_optin_smem() {
  static int cached[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64) dev = 63;
  if (!cached[dev])
    cudaDeviceGetAttribute(&cached[dev],
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return cached[dev];
}

// Shared-memory bytes prox_loop needs at d, with or without G.
size_t loop_bytes(long long d, bool g_shared) {
  return (size_t)(kScal + 3 * d + (g_shared ? d * d : 0)) * sizeof(float);
}

template <int V>
void launch_step(const float* G, const float* R, const float* v,
                 const float* scal, float* out, int d, cudaStream_t st) {
  const int warps = kThreads / 32;
  int blocks = (d + warps - 1) / warps;
  if (blocks > 4096) blocks = 4096;
  prox_step_kernel<V><<<blocks, kThreads, 0, st>>>(G, R, v, scal, out, d);
}

template <int V, bool G_SHARED>
int launch_loop(const float* G, const float* R, const float* z0,
                const float* scal, float* out, int d, int Q, size_t bytes,
                cudaStream_t st) {
  static size_t opted_in = 48 * 1024;  // per instantiation
  if (bytes > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        prox_loop_kernel<V, G_SHARED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    opted_in = bytes;
  }
  prox_loop_kernel<V, G_SHARED><<<1, kLoopThreads, bytes, st>>>(
      G, R, z0, scal, out, d, Q);
  return 0;
}

template <int V>
int launch_loop_variant(const float* G, const float* R, const float* z0,
                        const float* scal, float* out, int d, int Q,
                        cudaStream_t st) {
  const size_t with_g = loop_bytes(d, true);
  if (with_g <= (size_t)max_optin_smem())
    return launch_loop<V, true>(G, R, z0, scal, out, d, Q, with_g, st);
  return launch_loop<V, false>(G, R, z0, scal, out, d, Q,
                               loop_bytes(d, false), st);
}

}  // namespace

extern "C" {

// G (d, d), R, v, out (d,), scal (5,) = [t, lam, mu, lo, hi]; all float32
// on the device. variant: 0 l1, 1 elastic_net, 2 box, 3 none.
int prox_step_f32(const float* G, const float* R, const float* v,
                  const float* scal, float* out, int d, int variant,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: launch_step<0>(G, R, v, scal, out, d, st); break;
    case 1: launch_step<1>(G, R, v, scal, out, d, st); break;
    case 2: launch_step<2>(G, R, v, scal, out, d, st); break;
    case 3: launch_step<3>(G, R, v, scal, out, d, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int prox_loop_f32(const float* G, const float* R, const float* z0,
                  const float* scal, float* out, int d, int Q, int variant,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = 0;
  switch (variant) {
    case 0: err = launch_loop_variant<0>(G, R, z0, scal, out, d, Q, st); break;
    case 1: err = launch_loop_variant<1>(G, R, z0, scal, out, d, Q, st); break;
    case 2: err = launch_loop_variant<2>(G, R, z0, scal, out, d, Q, st); break;
    case 3: err = launch_loop_variant<3>(G, R, z0, scal, out, d, Q, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return (int)cudaGetLastError();
}

// Largest d whose G prox_loop keeps in shared memory on the current device.
int prox_loop_max_shared_d(void) {
  const size_t limit = (size_t)max_optin_smem();
  int d = 0;
  while (loop_bytes(d + 1, true) <= limit) ++d;
  return d;
}

// Largest d prox_loop takes at all (its vectors always live in shared memory).
int prox_loop_max_d(void) {
  const size_t limit = (size_t)max_optin_smem();
  int d = 0;
  while (loop_bytes(d + 1, false) <= limit) ++d;
  return d;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
