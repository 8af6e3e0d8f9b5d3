// Hopper building blocks shared by the port's kernels (flash_attention.cu,
// ssd.cu, prox_step.cu): mbarriers, TMA loads through tensor maps and bulk
// copies without one,
// wgmma shared-memory descriptors and instructions (float32 accumulators,
// bf16 operands), the split of a float32 pair into bf16 hi and lo halves,
// the tensor-map encoder (cuTensorMapEncodeTiled), and the shared-memory
// opt-in. Every helper sits in an anonymous namespace: each source
// includes its own copy.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` contiguous bytes from global to shared memory by one bulk copy
// (TMA without a tensor map: both addresses 16-byte aligned, `bytes` a
// multiple of 16); they complete a transaction on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// one box of a 4-D tensor map (coordinates innermost first) into shared
// memory; its bytes complete a transaction on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout code in bits 62-63
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving reads or writes of wgmma's registers
// across the asynchronous span
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// A wgmma's float32 accumulator as asm operands, "+f"(d[i]) ..., and their
// names in the instruction, "%0, %1, ...": both written once, in blocks of 8
#define FH_ACC8(d, i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define FH_ACC16(d, i) FH_ACC8(d, i), FH_ACC8(d, i + 8)
#define FH_ACC32(d, i) FH_ACC16(d, i), FH_ACC16(d, i + 16)
#define FH_ACC64(d, i) FH_ACC32(d, i), FH_ACC32(d, i + 32)
#define FH_NAMES8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define FH_NAMES16 FH_NAMES8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define FH_NAMES32                                                        \
  FH_NAMES16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "  \
             "%27, %28, %29, %30, %31"
#define FH_NAMES64                                                        \
  FH_NAMES32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "  \
             "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, " \
             "%55, %56, %57, %58, %59, %60, %61, %62, %63"

// d (64 x N, float32) += A (64 x 16, bf16 pairs in registers) B (16 x N),
// B in shared memory MN-major (TB = 1, the transpose bit set) or K-major
// (TB = 0); N = 16, 32, 64, 128
template <int N, int TB = 1>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db);
// ACC, NAMES: the N / 2 accumulators; A0..A3, B, P: the numbers of the
// operands after them (A's four registers, B's descriptor, the predicate)
#define FH_WGMMA_RS(N, TB, ACC, NAMES, A0, A1, A2, A3, B, P)               \
  template <>                                                             \
  __device__ __forceinline__ void wgmma_rs<N, TB>(float (&d)[N / 2],      \
                                                  const uint32_t (&a)[4], \
                                                  uint64_t db) {          \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"          \
                 "wgmma.mma_async.sync.aligned.m64n" #N                   \
                 "k16.f32.bf16.bf16 {" NAMES "}, {%" #A0 ", %" #A1         \
                 ", %" #A2 ", %" #A3 "}, %" #B ", p, 1, 1, " #TB ";\n}\n" \
                 : ACC(d, 0)                                              \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),   \
                   "r"(1));                                               \
  }
FH_WGMMA_RS(16, 1, FH_ACC8, FH_NAMES8, 8, 9, 10, 11, 12, 13)
FH_WGMMA_RS(32, 1, FH_ACC16, FH_NAMES16, 16, 17, 18, 19, 20, 21)
FH_WGMMA_RS(64, 1, FH_ACC32, FH_NAMES32, 32, 33, 34, 35, 36, 37)
FH_WGMMA_RS(128, 1, FH_ACC64, FH_NAMES64, 64, 65, 66, 67, 68, 69)
FH_WGMMA_RS(64, 0, FH_ACC32, FH_NAMES32, 32, 33, 34, 35, 36, 37)
#undef FH_WGMMA_RS

// d (64 x N, float32) (+)= A (64 x 16) B (16 x N), both in shared memory:
// A K-major, B K-major (TB = 0) or MN-major (TB = 1); scale_d 0 overwrites
// d; N = 16, 64
template <int N, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);
#define FH_WGMMA_SS(N, TB, ACC, NAMES, DA, DB, P)                          \
  template <>                                                             \
  __device__ __forceinline__ void wgmma_ss<N, TB>(                        \
      float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {         \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"          \
                 "wgmma.mma_async.sync.aligned.m64n" #N                   \
                 "k16.f32.bf16.bf16 {" NAMES "}, %" #DA ", %" #DB         \
                 ", p, 1, 1, 0, " #TB ";\n}\n"                            \
                 : ACC(d, 0)                                              \
                 : "l"(da), "l"(db), "r"(scale_d));                       \
  }
FH_WGMMA_SS(16, 0, FH_ACC8, FH_NAMES8, 8, 9, 10)
FH_WGMMA_SS(64, 0, FH_ACC32, FH_NAMES32, 32, 33, 34)
FH_WGMMA_SS(16, 1, FH_ACC8, FH_NAMES8, 8, 9, 10)
FH_WGMMA_SS(64, 1, FH_ACC32, FH_NAMES32, 32, 33, 34)
#undef FH_WGMMA_SS

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// a packed bf16 pair (the lower column in the low half) as two floats
__device__ __forceinline__ float2 bf16x2_to_f2(uint32_t v) {
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xffff0000u));
}

// x0, x1 in float32 as one A-fragment register of each half: hi =
// bf16(x), lo = bf16(x - hi), which carry x to about 2^-16 relative
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// x0, x1 in float32 as three bf16 terms t1 + t2 + t3, one A-fragment
// register each: the rest after two terms (about 2^-16 of x) is carried
// by the third to about 2^-24, float32's own precision
__device__ __forceinline__ void split3_pair(float x0, float x1, uint32_t& t1,
                                            uint32_t& t2, uint32_t& t3) {
  split_pair(x0, x1, t1, t2);
  const float2 a = bf16x2_to_f2(t1), b = bf16x2_to_f2(t2);
  t3 = bf16x2_bits(__floats2bfloat162_rn(x0 - a.x - b.x, x1 - a.y - b.y));
}

// order this thread's generic-proxy accesses of shared memory before the
// async proxy's (wgmma and TMA) that follow a barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query, so the library needs no -lcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

constexpr int HOPPER_MAX_DEVICES = 64;

// (`set` is the instance's own flags), not per launch: the launch path is
// host-bound (see PERF.md).
template <typename K>
cudaError_t smem_opt_in(K* kernel, size_t smem, std::atomic<bool>* set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= HOPPER_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!set[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    set[dev].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

}  // namespace
