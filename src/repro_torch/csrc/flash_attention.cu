// GQA attention for the model's forward, its backward and paged decode,
// float32 accumulation.
//
// 1. flash_attention_fwd replaces the Pallas kernel `flash_attention`
//    (src/repro/kernels/flash_attention/kernel.py:219, body `_flash_kernel`
//    at :83), which the teacher-forced `forward` runs in every layer.
//    q (B,Sq,Hq,D), k/v (B,Skv,Hkv,D), any strides with a unit last one (the
//    model's layout, so the wrapper passes the projections as they are),
//    base and strides 16-byte aligned (TMA's rule).
//    GQA by index: q head h reads kv head h / (Hq / Hkv), no K/V copy.
//    Causal rows are right-aligned (q_offset = Skv - Sq) and the kv tiles
//    past a tile's last visible key are never loaded. Ragged Sq and Skv are
//    masked here, with no pad pass; a row that sees no key gives 0.
//    What bounds it on an H100: at the training shape (B=8, Hq=16, S=1024,
//    D=128, causal, bf16) the work is 17.2 GFLOP of QK^T and as much of PV
//    over the visible pairs against ~101 MB moved (30 us at 3.35 TB/s):
//    bound by operations, 34.8 us on the bf16 tensor cores at 989 TFLOP/s
//    (at (B=2, S=1024): 8.6 GFLOP, 8.7 us).
//    bf16 (`flash_fwd_bf16_kernel`, the only bf16 body): both products on
//    the tensor cores (wgmma), the K/V tiles through an asynchronous ring.
//    One CTA per (128 query rows, q head, batch row): a producer warpgroup
//    whose one thread keeps TMA loads of 64-row K/V tiles in flight through
//    a 2-slot ring in shared memory (mbarriers mark full and empty slots),
//    and two consumer warpgroups of 64 query rows each. TMA reads the
//    strided (B, S, H, D) view through a 4-D tensor map and writes each
//    tile in the swizzle the wgmma descriptors name (128-byte rows of 64
//    columns; 64- and 32-byte rows at D = 32 and 16), zero-filling rows
//    past the end. S = Q K^T is one m64n64k16 wgmma per 16 columns of D,
//    both operands K-major in shared memory: products of bf16 are exact
//    and sums float32, as before. The online softmax runs in the
//    accumulator's registers (row max and sum over the four threads of a
//    row; masking only on the diagonal tile and the ragged last tile; exp2
//    of the select only, so a masked entry is exactly 0 and a row that sees
//    nothing stays 0). p never leaves the registers: it is split into hi =
//    bf16(p) and lo = bf16(p - hi), which carry p to about 2^-16 relative,
//    and O += hi V + lo V runs as two register-A wgmmas against V's tile in
//    shared memory (MN-major, the descriptor's transpose bit), so PV keeps
//    the float32 kernel's numbers where a single bf16 p would cost another
//    rounding; l sums the float32 p. Registers are rebalanced with
//    setmaxnreg (producer 40, consumers 232); under causal the heaviest q
//    tiles launch first. No atomics, no split along the keys, one fixed
//    summation order per row: two launches give the same bits and a row's
//    result never depends on the batch.
//    float32 (`flash_fwd_f32_kernel`) keeps the CUDA-core body: no tensor-
//    core type gives float32's numbers without a three-way split, and no
//    path on the card runs attention in float32 (the model computes in a
//    bf16 copy when serving and when training); it checks the algorithm
//    at 1e-5. One CTA per (64 query rows, q head, batch row), K/V tiles of
//    64 rows through shared memory, m, l and the 64 x D accumulator in
//    registers, both products as float32 fmaf (67 TFLOP/s peak).
//    With a non-null `lse` it also writes each row's float32 logsumexp of
//    the scaled, masked scores, lse = m + log(max(l, 1e-30)), (B, Hq, Sq)
//    contiguous: the residual the backward recomputes p = exp(s - lse)
//    from, as the Pallas body `_flash_kernel_lse` (kernel.py:87, written at
//    :75-80) does. Masking is with true -inf, so a row that sees no key has
//    m = -inf and lse = -inf (Pallas' finite -1e30 gives a finite number);
//    the backward kernels never evaluate exp(s - lse) at a masked entry,
//    they select 0 there, so such a row has zero gradients, not NaN.
//
// 2. paged_decode replaces the Pallas kernel `paged_flash_decode`
//    (kernel.py:208, bodies `_paged_body` :93, `_paged_kernel` :145 and
//    `_paged_kernel_quant` :151), which every engine decode step runs in
//    every layer.
//    q (B,1,Hq,D); pools (num_pages, page_size, Hkv, D) of float32, bf16 or
//    int8 with float32 scales (num_pages, page_size, Hkv); table
//    (B, npages) int32; valid (B,) int32. One launch a call
//    (`paged_decode_kernel`). One CTA per (chunk of 128 positions, kv head,
//    batch row) serves all Hq/Hkv query heads of the group, so each K/V
//    row is read once (the Pallas grid (B, Hq, npages) reads it once per
//    query head); the chunk is a constant, never a function of the batch,
//    so a row's result does not depend on its neighbours, and a long row
//    spreads over the card (flash-decoding). Warp 0 is the producer: it
//    stages the chunk's table entries in shared memory and its lane 0 asks
//    TMA for each page's (rows, 1 kv head, D) box of K and of V through 4-D
//    tensor maps over the pools (D, Hkv, page_size, num_pages innermost
//    first), with the page number from the table as a coordinate, so TMA
//    walks the page table and no thread forms a K/V address. The boxes go
//    into a ring of stages with full/empty mbarriers, about 64 KB, which
//    holds a whole chunk at the engine's page size of 16 in bf16 (8 pages
//    of 2 x 4 KB). A box has at most 64 rows: a larger page is read in
//    several, and rows of a box past the page read as zeros. int8 scales
//    are P floats at a stride of Hkv floats, too narrow for a TMA box (16
//    bytes at least) at the smoke config's Hkv = 2: the producer's lanes
//    copy them by 4-byte cp.async into the stage, and each lane's
//    cp.async.mbarrier.arrive.noinc counts on the same full barrier, so a
//    stage is full when its boxes and its scales have landed. The 4
//    consumer warps take the tiles in turn (warp w the tiles w, w + 4,
//    ...; each releases its stage alone); a warp's lanes form groups of
//    D/16 lanes (D/8 for a group of 8 query heads), each group one row at
//    a time, so a score is 16 (8) fmaf a lane and a sum over the group's
//    lanes (3 shuffles at D = 128, not 5). Each group keeps its own online
//    softmax in base 2, in float32 on the CUDA cores, and rescales only
//    when its max grows; the groups, then the warps, merge at the end of
//    the chunk in a fixed order. Only
//    rows inside [chunk start, valid) are read from a tile: TMA loads the
//    last page whole, and the rows past valid (NaN in a pool is possible
//    there) add nothing to m, l or acc, by selection and not by a zero
//    weight; pages whose first position is at or past valid (table entries
//    0, the pool's scratch page) are never asked for. int8 is dequantized
//    in registers (code * scale, then the dot, as the Pallas body does).
//    The warps' states merge through the ring. A row that fits one chunk is
//    normalized and written by its CTA. A longer row's CTAs each write
//    their (m, l, acc), fence, and draw a ticket (atomicAdd on a per-(row,
//    kv head) counter the caller keeps zeroed); the CTA that draws the last
//    one merges the row's chunks in chunk order, the same order and
//    arithmetic for any arrival order, so the bits do not depend on which
//    CTA came last, and resets the counter. The ticket is the only atomic;
//    no value is summed atomically. A row with no valid position gives 0.
//    Tensor cores: not used. wgmma's smallest M is 64 rows and a group
//    holds 1-8 query rows; mma.sync's m16n8k16 would waste at least half
//    its rows; and the work is 4 FLOP per K/V element against a byte bound.
//    What bounds it: the valid K/V bytes. At the engine's shape (B=8,
//    Hkv=8, D=128, bf16, valid up to 1024) that is at most 33.6 MB a layer
//    (10 us at 3.35 TB/s); the FLOP are 4 per K/V element, far below. On
//    the card the kernel stays well above that bound: a CTA's chain of
//    dependent steps (valid and the table, the first box, its rows'
//    arithmetic, the partial's fence and ticket, the merge's reads) sets
//    its time, and the consumers' instruction issue, not the bytes, the
//    longest step (PERF.md, row 7).
//
// 3. flash_attention_bwd_dq replaces the Pallas kernel `flash_dq`
//    (src/repro/kernels/flash_attention/backward.py:125, body `_dq_kernel`
//    :50). Per tile of keys it recomputes s = q k^T and dp = do v^T, p =
//    exp(s * scale - lse) on visible entries and 0 elsewhere, ds = p (dp -
//    delta), and adds ds k to a float32 accumulator; dq = scale * acc.
//    delta = rowsum(do * o), (B, Hq, Sq) float32, comes from the caller.
//    bf16 (`flash_bwd_dq_bf16_kernel`, the only bf16 body): the forward's
//    design with two score products. One CTA per (128 query rows, q head,
//    batch row): a producer warpgroup whose one thread loads the Q and dO
//    tiles once by TMA and keeps 64-row K/V tiles in flight through the
//    2-slot ring, and two consumer warpgroups of 64 rows each. Per tile,
//    S = Q K^T and dP = dO V^T run as wgmmas with both operands K-major in
//    shared memory; p = exp2(s * scale * log2 e - lse * log2 e) (exp2 of
//    the select only: masked entries are exactly 0) and ds = p (dp - delta)
//    are formed in the accumulators' registers, with lse and delta of the
//    thread's two rows read once. ds is split into hi = bf16(ds) and lo =
//    bf16(ds - hi), as the forward splits p, and dQ += hi K + lo K runs as
//    register-A wgmmas against the same K tile read MN-major, so ds reaches
//    the tensor cores at about 2^-16 of itself, not at bf16's 2^-8. Under
//    causal the heaviest q tiles launch first and kv tiles past the last
//    visible key are never loaded.
//    float32 (`flash_bwd_dq_f32_kernel`) keeps the CUDA-core body, for the
//    forward's reasons (note 1): one CTA per (64 query rows, q head, batch
//    row), Q and dO in shared memory, K/V tiles of 64 rows loaded in
//    32-bit words between two barriers, s, dp and ds k as float32 fmaf.
//
// 4. flash_attention_bwd_dkv replaces the Pallas kernel `flash_dkv`
//    (backward.py:157, body `_dkv_kernel` :84) together with the sum over
//    the GQA group that the JAX wrapper does outside it (ops.py:108-111):
//    dk = scale * sum ds^T q and dv = sum p^T do over the group's query
//    heads and their visible queries, with no (B, Hq, Skv, D) buffer and no
//    atomics.
//    bf16 (`flash_bwd_dkv_bf16_kernel`, the only bf16 body): one CTA per
//    (128 keys, kv head, batch row). TMA loads its K and V tiles once; the
//    producer's thread 0 streams 64-row Q and dO tiles through a 2-slot
//    ring and its second warp the tiles' lse (base 2) and delta rows,
//    walking the group's query heads and, for each, the q tiles that can
//    see the CTA's keys (the forward's causal skip, transposed), in one
//    fixed order. Each consumer warpgroup owns 64 keys and computes the
//    transposed scores directly, S^T = K Q^T and dP^T = V dO^T (wgmma,
//    both K-major), so p^T and ds^T sit in the accumulator layout, which is
//    the register-A fragment layout: dV += p^T dO and dK += ds^T Q run as
//    register-A wgmmas against dO and Q read MN-major, each operand split
//    hi + lo as in dq; lse and delta index the accumulator's columns. dK
//    and dV stay in float32 registers over the whole walk (setmaxnreg 24
//    for the producer, 240 for the consumers) and are written once in bf16.
//    float32 (`flash_bwd_dkv_f32_kernel`) keeps the CUDA-core body: one CTA
//    per (64 keys, kv head, batch row), p^T and ds^T through shared memory,
//    p^T do and ds^T q as float32 fmaf.
//    Masking in both bf16 kernels is with true -inf, only on the tiles that
//    need it (the diagonal under causal, ragged edges); rows past Sq and
//    keys past Skv arrive as TMA's zero fill. Both backward kernels sum in
//    one fixed order (kv tiles in order, hi before lo, for dq; query heads,
//    then q tiles, for dk/dv), so a launch gives the same bits every time
//    and a row's result never depends on the batch. Operands keep the
//    model's strided (B, S, H, D) layout; in bf16 their bases and strides
//    are 16-byte aligned, TMA's rule.
//    What bounds them on an H100: at the training shape (B=8, Hq=16,
//    Hkv=8, S=1024, D=128, causal, bf16) dq does three products and dk/dv
//    four over the 67 M visible (query, key) pairs (2 D FLOP each): 52 and
//    69 GFLOP against ~135 MB moved, so operations: 52 and 70 us on the
//    bf16 tensor cores (0.77 and 1.03 ms on the float32 CUDA cores). The
//    hi/lo split makes the tensor cores do 4 and 6 products, 69 and 103
//    GFLOP; the bound counts the model's work.
//
// Every C entry returns cudaGetLastError() after its launch.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>
#include <cstring>
#include <type_traits>

#include "hopper.cuh"

namespace {

// ----------------------------------------------------------------- helpers
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// two consecutive elements (the first at an even index) as floats
__device__ __forceinline__ float2 load2(const float* p) {
  return make_float2(p[0], p[1]);
}

// ---------------------------------------------------------- flash attention
constexpr int FA_BQ = 64;       // query rows per CTA
constexpr int FA_BK = 64;       // key rows per shared-memory tile
constexpr int FA_THREADS = 256; // a 16 x 16 thread grid
constexpr int FA_PS = FA_BK + 1;  // row stride of the p tile (floats)

// Shared-memory row stride of a Q/K/V tile, in elements: D plus one 32-bit
// word, so a row spans an odd number of words and the 16 threads that read
// 16 different rows at one column hit 16 different banks.
template <typename T, int D>
struct TileStride {
  static constexpr int value = D + 4 / (int)sizeof(T);
};

template <typename T, int D>
constexpr size_t fa_smem_bytes() {
  return (size_t)3 * FA_BQ * TileStride<T, D>::value * sizeof(T) +
         (size_t)FA_BQ * FA_PS * sizeof(float);
}

// the backward kernels: four Q/dO/K/V tiles, `ptiles` 64 x 64 float tiles
// (ds for dq; p and ds for dk/dv) and the tile's lse and delta rows
template <typename T, int D>
constexpr size_t bwd_smem_bytes(int ptiles) {
  return (size_t)4 * FA_BQ * TileStride<T, D>::value * sizeof(T) +
         (size_t)ptiles * FA_BQ * FA_PS * sizeof(float) +
         (size_t)2 * FA_BQ * sizeof(float);
}

// Copy `rows` rows of D elements (row r at src + r*stride) into a shared
// tile of row stride S, in 32-bit words; rows at or past `valid_rows` are
// zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          int64_t stride, int valid_rows) {
  constexpr int S = TileStride<T, D>::value;
  constexpr int WPR = D * (int)sizeof(T) / 4;  // 32-bit words per row
  for (int i = threadIdx.x; i < FA_BQ * WPR; i += FA_THREADS) {
    const int r = i / WPR, w = i % WPR;
    uint32_t val = 0;
    if (r < valid_rows)
      val = reinterpret_cast<const uint32_t*>(src + r * stride)[w];
    reinterpret_cast<uint32_t*>(dst + r * S)[w] = val;
  }
}

// the float32 forward; see the file's note 1
template <int D>
__global__ void __launch_bounds__(FA_THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int Hq,
                     int Hkv, int Sq, int Skv, int64_t qsb, int64_t qss,
                     int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
                     int64_t vsb, int64_t vss, int64_t vsh, int64_t osb,
                     int64_t oss, int64_t osh, int causal, float scale) {
  using T = float;
  constexpr int S = TileStride<T, D>::value;
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + FA_BQ * S;
  T* vs = ks + FA_BK * S;
  float* ps = reinterpret_cast<float*>(vs + FA_BK * S);

  const int q0 = blockIdx.x * FA_BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q_offset = Skv - Sq;

  const T* qb = q + b * qsb + h * qsh + q0 * qss;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;
  load_tile<T, D>(qs, qb, qss, min(FA_BQ, Sq - q0));

  // keys [0, kv_end) can be visible to some row of this tile
  int kv_end = Skv;
  if (causal) kv_end = min(Skv, q_offset + q0 + FA_BQ);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < kv_end; k0 += FA_BK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(ks, kb + k0 * kss, kss, min(FA_BK, Skv - k0));
    load_tile<T, D>(vs, vb + k0 * vss, vss, min(FA_BK, Skv - k0));
    __syncthreads();

    // scores: rows ty + 16 i, columns tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 2) {
      float2 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = load2(qs + (ty + 16 * i) * S + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = load2(ks + (tx + 16 * j) * S + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);
        }
    }

    // mask, online softmax, p tile to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + ty + 16 * i;
      float mx = -CUDART_INF_F;
      bool keep[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        keep[j] = kpos < Skv && (!causal || kpos <= qpos);
        s[i][j] *= scale;
        if (keep[j]) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
      const float m_new = fmaxf(m[i], mx);
      float alpha = 1.f, rs = 0.f;
      if (m_new != -CUDART_INF_F) {
        alpha = expf(m[i] - m_new);  // exp(-inf) = 0 on the first visible tile
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = keep[j] ? expf(s[i][j] - m_new) : 0.f;
          ps[(ty + 16 * i) * FA_PS + tx + 16 * j] = p;
          rs += p;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) ps[(ty + 16 * i) * FA_PS + tx + 16 * j] = 0.f;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off, 16);
      m[i] = m_new;
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += p v: rows ty + 16 i, columns tx + 16 j
#pragma unroll 4
    for (int kk = 0; kk < FA_BK; ++kk) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * FA_PS + kk];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = to_f(vs[kk * S + tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* ob = o + b * osb + h * osh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DC; ++j)
      ob[r * oss + tx + 16 * j] = from_f<T>(acc[i][j] * inv);
    // m and l are the same in the 16 threads of a row; -inf for a row
    // that sees no key
    if (lse != nullptr && tx == 0)
      lse[((int64_t)b * Hq + h) * Sq + r] = m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

// ------------------------------------------- flash attention forward, bf16
// (see the file's note 1)
constexpr int FH_BM = 128;       // query rows per CTA: two consumer warpgroups
constexpr int FH_BN = 64;        // key rows per ring slot
constexpr int FH_STAGES = 2;     // ring slots
constexpr int FH_THREADS = 384;  // producer warpgroup + two consumers

// Shared-memory plan of the bf16 forward at head dim D. A 64-row tile is
// NBOX boxes of 64 rows x BOX columns (one TMA load each), each row ROW
// bytes, in the swizzle of that row width: the Q tiles of the two consumer
// warpgroups, then the ring's K and V slots, then the mbarriers.
template <int D>
struct FwdPlan {
  static constexpr int BOX = D < 64 ? D : 64;
  static constexpr int NBOX = D / BOX;
  static constexpr int ROW = 2 * BOX;
  // wgmma descriptor layout code of that swizzle: 128 B, 64 B, 32 B
  static constexpr uint64_t SWIZZLE = ROW == 128 ? 1 : ROW == 64 ? 2 : 3;
  static constexpr uint32_t BOX_BYTES = FH_BN * ROW;
  static constexpr uint32_t TILE = FH_BN * D * 2;
  static constexpr uint32_t Q_OFF = 0;
  static constexpr uint32_t K_OFF = 2 * TILE;
  static constexpr uint32_t V_OFF = K_OFF + FH_STAGES * TILE;
  static constexpr uint32_t BAR_OFF = V_OFF + FH_STAGES * TILE;
  // + 1024: the base is rounded up to the swizzle pattern's period
  static constexpr size_t SMEM = BAR_OFF + 8 * (1 + 2 * FH_STAGES) + 1024;
};

// d (64 x 64) = A B^T over the head dim, A and B 64-row tiles of the
// plan's layout read K-major: one wgmma per 16 columns of D, not committed
template <int D>
__device__ __forceinline__ void wgmma_tiles_nt(float (&d)[32], uint32_t a,
                                               uint32_t b) {
  using P = FwdPlan<D>;
  constexpr uint32_t SBO = 8 * P::ROW;  // the next 8 rows
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // 32 bytes of D a step: box kk * 32 / ROW, at kk * 32 % ROW in it
    const uint32_t off = (kk * 32 / P::ROW) * P::BOX_BYTES + kk * 32 % P::ROW;
    wgmma_ss<64, 0>(d, gmma_desc(a + off, 16, SBO, P::SWIZZLE),
                 gmma_desc(b + off, 16, SBO, P::SWIZZLE), kk > 0);
  }
}

// d (64 x D) += hi B + lo B: hi and lo the A fragments of a 64 x 64
// operand (pair c = 2 j + r is register c % 4 of k-step c / 4), B a 64-row
// tile of the plan's layout read MN-major (the transpose bit); hi's four
// wgmmas, then lo's, not committed
template <int D>
__device__ __forceinline__ void wgmma_split_nn(float (&d)[D / 2],
                                               const uint32_t (&hi)[16],
                                               const uint32_t (&lo)[16],
                                               uint32_t b) {
  using P = FwdPlan<D>;
  constexpr uint32_t SBO = 8 * P::ROW;  // the next 8 rows of B
#pragma unroll
  for (int kk = 0; kk < FH_BN / 16; ++kk) {
    const uint32_t a[4] = {hi[4 * kk], hi[4 * kk + 1], hi[4 * kk + 2],
                           hi[4 * kk + 3]};
    wgmma_rs<D>(d, a, gmma_desc(b + kk * 16 * P::ROW, P::BOX_BYTES, SBO,
                                P::SWIZZLE));
  }
#pragma unroll
  for (int kk = 0; kk < FH_BN / 16; ++kk) {
    const uint32_t a[4] = {lo[4 * kk], lo[4 * kk + 1], lo[4 * kk + 2],
                           lo[4 * kk + 3]};
    wgmma_rs<D>(d, a, gmma_desc(b + kk * 16 * P::ROW, P::BOX_BYTES, SBO,
                                P::SWIZZLE));
  }
}

template <int D>
__global__ void __launch_bounds__(FH_THREADS, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int Hq, int Hkv, int Sq, int Skv, int64_t osb,
                      int64_t oss, int64_t osh, int causal,
                      float scale_log2) {
  using P = FwdPlan<D>;
  extern __shared__ unsigned char fh_smem[];
  const uint32_t base = (smem_addr(fh_smem) + 1023u) & ~1023u;
  const uint32_t q_s = base + P::Q_OFF;
  const uint32_t k_s = base + P::K_OFF;
  const uint32_t v_s = base + P::V_OFF;
  const uint32_t bar_q = base + P::BAR_OFF;
  const uint32_t bar_full = bar_q + 8;                  // + 8 * slot
  const uint32_t bar_empty = bar_full + 8 * FH_STAGES;  // + 8 * slot

  // under causal the last q tiles see the most keys: launch them first
  const int tile = causal ? (int)(gridDim.x - 1 - blockIdx.x) : blockIdx.x;
  const int q0 = tile * FH_BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q_offset = Skv - Sq;
  // keys [0, kv_end) can be visible to some row of this CTA
  const int kv_end = causal ? min(Skv, q_offset + q0 + FH_BM) : Skv;
  const int n_tiles = kv_end > 0 ? (kv_end + FH_BN - 1) / FH_BN : 0;
  const int q_tiles = q0 + 64 < Sq ? 2 : 1;  // 64-row Q tiles with a row

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < FH_STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2 * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_expect_tx(bar_q, q_tiles * P::TILE);
      for (int w = 0; w < q_tiles; ++w)
        for (int x = 0; x < P::NBOX; ++x)
          tma_load(q_s + w * P::TILE + x * P::BOX_BYTES, &tm_q, bar_q,
                   x * P::BOX, q0 + 64 * w, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % FH_STAGES;
        // the slot's previous tile has been read by both consumers
        if (i >= FH_STAGES)
          mbar_wait(bar_empty + 8 * s, (i / FH_STAGES - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, 2 * P::TILE);
        for (int x = 0; x < P::NBOX; ++x) {
          tma_load(k_s + s * P::TILE + x * P::BOX_BYTES, &tm_k, full,
                   x * P::BOX, i * FH_BN, hk, b);
          tma_load(v_s + s * P::TILE + x * P::BOX_BYTES, &tm_v, full,
                   x * P::BOX, i * FH_BN, hk, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup w: query rows [row0, row0 + 64); this thread holds
  // rows r_lo and r_lo + 8, columns 8 j + 2 t + {0, 1} of each accumulator
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int w = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + 64 * w;
  const int r_lo = row0 + 16 * warp + g;
  int wg_end = 0;  // keys [0, wg_end) can be visible to one of its rows
  if (row0 < Sq) wg_end = causal ? min(Skv, q_offset + row0 + 64) : Skv;
  const uint32_t q_tile = q_s + w * P::TILE;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  if (n_tiles > 0 && wg_end > 0) mbar_wait(bar_q, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % FH_STAGES;
    mbar_wait(bar_full + 8 * s, (i / FH_STAGES) & 1);
    const int k0 = i * FH_BN;
    if (k0 < wg_end) {
      // S = Q K^T, 16 columns of D a step (the first overwrites sc)
      float sc[32];
      fence_regs(sc);
      wgmma_fence();
      wgmma_tiles_nt<D>(sc, q_tile, k_s + s * P::TILE);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // online softmax in base 2 on the accumulator: sc[4 j + 2 r + e] is
      // row r_lo + 8 r, key k0 + 8 j + 2 t + e
      const bool masked = k0 + FH_BN > Skv ||
                          (causal && k0 + FH_BN - 1 > q_offset + row0);
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int r = (j / 2) % 2;
        float x = sc[j] * scale_log2;
        if (masked) {
          const int kpos = k0 + 8 * (j / 4) + 2 * t + j % 2;
          const int qpos = q_offset + r_lo + 8 * r;
          if (kpos >= Skv || (causal && kpos > qpos)) x = -CUDART_INF_F;
        }
        sc[j] = x;
        mx[r] = fmaxf(mx[r], x);
      }
      float mu[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        // a row with no visible key yet keeps m = -inf: exponents against
        // 0 there, so every p and alpha is exp2(-inf) = 0, never NaN
        mu[r] = m_new == -CUDART_INF_F ? 0.f : m_new;
        alpha[r] = exp2f(m[r] - mu[r]);
        m[r] = m_new;
      }

      // p in float32, split into the A fragments hi = bf16(p) and lo =
      // bf16(p - hi): pair c = 2 j + r is register c % 4 of k-step c / 4
      uint32_t hi[16], lo[16];
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int r = c % 2;
        const float p0 = exp2f(sc[2 * c] - mu[r]);
        const float p1 = exp2f(sc[2 * c + 1] - mu[r]);
        rs[r] += p0 + p1;
        split_pair(p0, p1, hi[c], lo[c]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[j] *= alpha[(j / 2) % 2];

      // O += hi V + lo V, 16 keys a step
      fence_regs(acc);
      wgmma_fence();
      wgmma_split_nn<D>(acc, hi, lo, v_s + s * P::TILE);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    mbar_arrive(bar_empty + 8 * s);  // this warpgroup is done with the slot
  }

  // the row sums over the four threads of a row, then the output
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __nv_bfloat16* ob = o + b * osb + h * osh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_lo + 8 * r;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = ob + (int64_t)row * oss;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv,
                                acc[4 * j + 2 * r + 1] * inv);
    // natural log: m is in base 2; -inf for a row that sees no key
    if (lse != nullptr && t == 0)
      lse[((int64_t)b * Hq + h) * Sq + row] =
          m[r] * 0.69314718055994531f + logf(fmaxf(l[r], 1e-30f));
  }
}

// ------------------------------------------ flash attention backward, bf16
// (see the file's notes 3 and 4)
constexpr float FH_LOG2E = 1.4426950408889634f;

// Shared-memory plan of the bf16 dq kernel at head dim D, in the forward's
// tile layout: the Q and dO tiles of the two consumer warpgroups, the
// ring's K and V slots, then the mbarriers (Q/dO, full and empty a slot).
template <int D>
struct DqPlan {
  static constexpr uint32_t TILE = FwdPlan<D>::TILE;
  static constexpr uint32_t Q_OFF = 0;
  static constexpr uint32_t DO_OFF = 2 * TILE;
  static constexpr uint32_t K_OFF = 4 * TILE;
  static constexpr uint32_t V_OFF = K_OFF + FH_STAGES * TILE;
  static constexpr uint32_t BAR_OFF = V_OFF + FH_STAGES * TILE;
  static constexpr size_t SMEM = BAR_OFF + 8 * (1 + 2 * FH_STAGES) + 1024;
};

// ... of the bf16 dk/dv kernel: the K and V tiles of the two consumer
// warpgroups, the ring's Q and dO slots, each slot's 64 lse (base 2) and
// 64 delta values, then the mbarriers (K/V, full and empty a slot).
template <int D>
struct DkvPlan {
  static constexpr uint32_t TILE = FwdPlan<D>::TILE;
  static constexpr uint32_t K_OFF = 0;
  static constexpr uint32_t V_OFF = 2 * TILE;
  static constexpr uint32_t Q_OFF = 4 * TILE;
  static constexpr uint32_t DO_OFF = Q_OFF + FH_STAGES * TILE;
  static constexpr uint32_t ROWS_OFF = DO_OFF + FH_STAGES * TILE;
  static constexpr uint32_t ROWS = 2 * FH_BN;  // floats a slot
  static constexpr uint32_t BAR_OFF = ROWS_OFF + FH_STAGES * ROWS * 4;
  static constexpr size_t SMEM = BAR_OFF + 8 * (1 + 2 * FH_STAGES) + 1024;
};

// dq of one (128 query rows, q head, batch row); see the file's note 3
template <int D>
__global__ void __launch_bounds__(FH_THREADS, 1)
flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int Hq, int Hkv,
                         int Sq, int Skv, int64_t dsb, int64_t dss,
                         int64_t dsh, int causal, float scale) {
  using P = FwdPlan<D>;
  using L = DqPlan<D>;
  extern __shared__ unsigned char fh_smem[];
  const uint32_t base = (smem_addr(fh_smem) + 1023u) & ~1023u;
  const uint32_t q_s = base + L::Q_OFF;
  const uint32_t do_s = base + L::DO_OFF;
  const uint32_t k_s = base + L::K_OFF;
  const uint32_t v_s = base + L::V_OFF;
  const uint32_t bar_q = base + L::BAR_OFF;
  const uint32_t bar_full = bar_q + 8;                  // + 8 * slot
  const uint32_t bar_empty = bar_full + 8 * FH_STAGES;  // + 8 * slot

  // under causal the last q tiles see the most keys: launch them first
  const int tile = causal ? (int)(gridDim.x - 1 - blockIdx.x) : blockIdx.x;
  const int q0 = tile * FH_BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q_offset = Skv - Sq;
  // keys [0, kv_end) can be visible to some row of this CTA
  const int kv_end = causal ? min(Skv, q_offset + q0 + FH_BM) : Skv;
  const int n_tiles = kv_end > 0 ? (kv_end + FH_BN - 1) / FH_BN : 0;
  const int q_tiles = q0 + 64 < Sq ? 2 : 1;  // 64-row Q tiles with a row

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < FH_STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2 * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread loads Q and dO, then keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_expect_tx(bar_q, 2 * q_tiles * P::TILE);
      for (int w = 0; w < q_tiles; ++w)
        for (int x = 0; x < P::NBOX; ++x) {
          tma_load(q_s + w * P::TILE + x * P::BOX_BYTES, &tm_q, bar_q,
                   x * P::BOX, q0 + 64 * w, h, b);
          tma_load(do_s + w * P::TILE + x * P::BOX_BYTES, &tm_do, bar_q,
                   x * P::BOX, q0 + 64 * w, h, b);
        }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % FH_STAGES;
        // the slot's previous tile has been read by both consumers
        if (i >= FH_STAGES)
          mbar_wait(bar_empty + 8 * s, (i / FH_STAGES - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, 2 * P::TILE);
        for (int x = 0; x < P::NBOX; ++x) {
          tma_load(k_s + s * P::TILE + x * P::BOX_BYTES, &tm_k, full,
                   x * P::BOX, i * FH_BN, hk, b);
          tma_load(v_s + s * P::TILE + x * P::BOX_BYTES, &tm_v, full,
                   x * P::BOX, i * FH_BN, hk, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup w: query rows [row0, row0 + 64); this thread holds
  // rows r_lo and r_lo + 8, columns 8 j + 2 t + {0, 1} of each accumulator
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int w = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + 64 * w;
  const int r_lo = row0 + 16 * warp + g;
  int wg_end = 0;  // keys [0, wg_end) can be visible to one of its rows
  if (row0 < Sq) wg_end = causal ? min(Skv, q_offset + row0 + 64) : Skv;
  const uint32_t q_tile = q_s + w * P::TILE;
  const uint32_t do_tile = do_s + w * P::TILE;
  const float scale_log2 = scale * FH_LOG2E;

  // the two rows' lse (base 2; -inf for a row that sees no key) and delta;
  // 0 past Sq, where Q and dO read as zeros, so ds is 0 there
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_lo + 8 * r;
    const int64_t at = ((int64_t)b * Hq + h) * Sq + row;
    lse2[r] = row < Sq ? lse[at] * FH_LOG2E : 0.f;
    dl[r] = row < Sq ? delta[at] : 0.f;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  if (n_tiles > 0 && wg_end > 0) mbar_wait(bar_q, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % FH_STAGES;
    mbar_wait(bar_full + 8 * s, (i / FH_STAGES) & 1);
    const int k0 = i * FH_BN;
    if (k0 < wg_end) {
      // S = Q K^T and dP = dO V^T
      float sc[32], dp[32];
      const uint32_t k_tile = k_s + s * P::TILE;
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
      wgmma_tiles_nt<D>(sc, q_tile, k_tile);
      wgmma_tiles_nt<D>(dp, do_tile, v_s + s * P::TILE);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      // p and ds on the accumulators: sc[4 j + 2 r + e] is row r_lo + 8 r,
      // key k0 + 8 j + 2 t + e; ds split into the A fragments hi and lo,
      // pair c = 2 j + r
      const bool masked = k0 + FH_BN > Skv ||
                          (causal && k0 + FH_BN - 1 > q_offset + row0);
      uint32_t hi[16], lo[16];
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int r = c % 2;
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 2 * c + e;
          float x = sc[j] * scale_log2 - lse2[r];
          if (masked) {
            const int kpos = k0 + 8 * (c / 2) + 2 * t + e;
            const int qpos = q_offset + r_lo + 8 * r;
            if (kpos >= Skv || (causal && kpos > qpos)) x = -CUDART_INF_F;
          }
          ds[e] = exp2f(x) * (dp[j] - dl[r]);
        }
        split_pair(ds[0], ds[1], hi[c], lo[c]);
      }

      // dQ += hi K + lo K, 16 keys a step, K read MN-major
      fence_regs(acc);
      wgmma_fence();
      wgmma_split_nn<D>(acc, hi, lo, k_tile);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    mbar_arrive(bar_empty + 8 * s);  // this warpgroup is done with the slot
  }

  __nv_bfloat16* out = dq + b * dsb + h * dsh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_lo + 8 * r;
    if (row >= Sq) continue;
    __nv_bfloat16* orow = out + (int64_t)row * dss;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * scale,
                                acc[4 * j + 2 * r + 1] * scale);
  }
}

// dk and dv of one (128 keys, kv head, batch row), summed over the GQA
// group's query heads; see the file's note 4
template <int D>
__global__ void __launch_bounds__(FH_THREADS, 1)
flash_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int Hq, int Hkv,
                          int Sq, int Skv, int64_t gsb, int64_t gss,
                          int64_t gsh, int causal, float scale) {
  using P = FwdPlan<D>;
  using L = DkvPlan<D>;
  extern __shared__ unsigned char fh_smem[];
  const uint32_t base = (smem_addr(fh_smem) + 1023u) & ~1023u;
  const uint32_t k_s = base + L::K_OFF;
  const uint32_t v_s = base + L::V_OFF;
  const uint32_t q_s = base + L::Q_OFF;
  const uint32_t do_s = base + L::DO_OFF;
  // each slot's lse and delta rows, written by the producer's second warp
  float* const rows = reinterpret_cast<float*>(
      fh_smem + (base - smem_addr(fh_smem)) + L::ROWS_OFF);
  const uint32_t bar_kv = base + L::BAR_OFF;
  const uint32_t bar_full = bar_kv + 8;                 // + 8 * slot
  const uint32_t bar_empty = bar_full + 8 * FH_STAGES;  // + 8 * slot

  // the first key tiles are seen by the most queries: natural order
  const int k0 = blockIdx.x * FH_BM;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv;
  const int q_offset = Skv - Sq;
  // q rows [q_first, Sq) can see some key of this CTA; q tiles start at
  // multiples of 64, as in the forward and dq
  const int q_first = causal ? max(0, k0 - q_offset) / FH_BN * FH_BN : 0;
  const int nq = q_first < Sq ? (Sq - q_first + FH_BN - 1) / FH_BN : 0;
  const int n_tiles = group * nq;  // query heads in order, then q tiles
  const int kv_tiles = k0 + 64 < Skv ? 2 : 1;  // 64-key tiles with a key

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < FH_STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1 + 32);    // TMA's thread, the row warp
      mbar_init(bar_empty + 8 * s, 2 * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: thread 0 loads K and V, then keeps the ring's Q and dO
    // tiles in flight; warp 1 stages each tile's lse and delta rows
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_expect_tx(bar_kv, 2 * kv_tiles * P::TILE);
      for (int w = 0; w < kv_tiles; ++w)
        for (int x = 0; x < P::NBOX; ++x) {
          tma_load(k_s + w * P::TILE + x * P::BOX_BYTES, &tm_k, bar_kv,
                   x * P::BOX, k0 + 64 * w, hk, b);
          tma_load(v_s + w * P::TILE + x * P::BOX_BYTES, &tm_v, bar_kv,
                   x * P::BOX, k0 + 64 * w, hk, b);
        }
      // head h and q tile q0 of tile i, stepped rather than divided: this
      // warpgroup runs on 24 registers
      int h = hk * group, q0 = q_first;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % FH_STAGES;
        if (i >= FH_STAGES)
          mbar_wait(bar_empty + 8 * s, (i / FH_STAGES - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, 2 * P::TILE);
        for (int x = 0; x < P::NBOX; ++x) {
          tma_load(q_s + s * P::TILE + x * P::BOX_BYTES, &tm_q, full,
                   x * P::BOX, q0, h, b);
          tma_load(do_s + s * P::TILE + x * P::BOX_BYTES, &tm_do, full,
                   x * P::BOX, q0, h, b);
        }
        q0 += FH_BN;
        if (q0 >= Sq) q0 = q_first, ++h;
      }
    } else if (threadIdx.x / 32 == 1 && n_tiles > 0) {
      const int lane = threadIdx.x % 32;
      const float* lse_h = lse + ((int64_t)b * Hq + hk * group) * Sq;
      const float* dl_h = delta + ((int64_t)b * Hq + hk * group) * Sq;
      int q0 = q_first;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % FH_STAGES;
        if (i >= FH_STAGES)
          mbar_wait(bar_empty + 8 * s, (i / FH_STAGES - 1) & 1);
        float* slot = rows + s * L::ROWS;
        for (int c = lane; c < FH_BN; c += 32) {
          const int row = q0 + c;  // past Sq: masked, any finite value
          slot[c] = row < Sq ? lse_h[row] * FH_LOG2E : 0.f;
          slot[FH_BN + c] = row < Sq ? dl_h[row] : 0.f;
        }
        mbar_arrive(bar_full + 8 * s);  // release: the stores before it
        q0 += FH_BN;
        if (q0 >= Sq) q0 = q_first, lse_h += Sq, dl_h += Sq;
      }
    }
    return;
  }

  // consumer warpgroup w: keys [kw, kw + 64); this thread holds keys r_lo
  // and r_lo + 8, queries 8 j + 2 t + {0, 1} of each transposed score
  // tile and columns 8 j + 2 t + {0, 1} of dK and dV
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int w = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kw = k0 + 64 * w;
  const int r_lo = kw + 16 * warp + g;
  const bool wg_on = kw < Skv;
  const uint32_t k_tile = k_s + w * P::TILE;
  const uint32_t v_tile = v_s + w * P::TILE;
  const float scale_log2 = scale * FH_LOG2E;

  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

  if (n_tiles > 0 && wg_on) mbar_wait(bar_kv, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % FH_STAGES;
    mbar_wait(bar_full + 8 * s, (i / FH_STAGES) & 1);
    const int q0 = q_first + i % nq * FH_BN;
    // under causal a q tile whose last row is before this warpgroup's
    // first key sees none of them
    if (wg_on && !(causal && q_offset + q0 + FH_BN - 1 < kw)) {
      // S^T = K Q^T and dP^T = V dO^T
      float st[32], dpt[32];
      const uint32_t q_tile = q_s + s * P::TILE;
      const uint32_t do_tile = do_s + s * P::TILE;
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
      wgmma_tiles_nt<D>(st, k_tile, q_tile);
      wgmma_tiles_nt<D>(dpt, v_tile, do_tile);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      // p^T and ds^T on the accumulators: st[4 j + 2 r + e] is key
      // r_lo + 8 r, query q0 + 8 j + 2 t + e, so lse and delta are read by
      // column; p^T split into the A fragments hi and lo (pair c = 2 j + r),
      // ds^T kept in dpt
      const float* lse_s = rows + s * L::ROWS;
      const float* dl_s = lse_s + FH_BN;
      const bool masked = kw + FH_BN > Skv || q0 + FH_BN > Sq ||
                          (causal && kw + FH_BN - 1 > q_offset + q0);
      uint32_t hi[16], lo[16];
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int r = c % 2, col = 8 * (c / 2) + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
        const float2 d2 = *reinterpret_cast<const float2*>(dl_s + col);
        float x[2] = {st[2 * c] * scale_log2 - l2.x,
                      st[2 * c + 1] * scale_log2 - l2.y};
        if (masked) {
          const int kpos = r_lo + 8 * r;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qrow = q0 + col + e;
            if (kpos >= Skv || qrow >= Sq ||
                (causal && kpos > q_offset + qrow))
              x[e] = -CUDART_INF_F;
          }
        }
        const float p0 = exp2f(x[0]), p1 = exp2f(x[1]);
        dpt[2 * c] = p0 * (dpt[2 * c] - d2.x);
        dpt[2 * c + 1] = p1 * (dpt[2 * c + 1] - d2.y);
        split_pair(p0, p1, hi[c], lo[c]);
      }

      // dV += hi dO + lo dO, then dK += hi Q + lo Q with ds^T's halves,
      // 16 queries a step, dO and Q read MN-major
      fence_regs(acc_v);
      wgmma_fence();
      wgmma_split_nn<D>(acc_v, hi, lo, do_tile);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc_v);
#pragma unroll
      for (int c = 0; c < 16; ++c)
        split_pair(dpt[2 * c], dpt[2 * c + 1], hi[c], lo[c]);
      fence_regs(acc_k);
      wgmma_fence();
      wgmma_split_nn<D>(acc_k, hi, lo, q_tile);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc_k);
    }
    mbar_arrive(bar_empty + 8 * s);  // this warpgroup is done with the slot
  }

  if (!wg_on) return;
  __nv_bfloat16* dkb = dk + b * gsb + hk * gsh;
  __nv_bfloat16* dvb = dv + b * gsb + hk * gsh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_lo + 8 * r;
    if (row >= Skv) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int64_t at = (int64_t)row * gss + 8 * j + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(dkb + at) = __floats2bfloat162_rn(
          acc_k[4 * j + 2 * r] * scale, acc_k[4 * j + 2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + at) = __floats2bfloat162_rn(
          acc_v[4 * j + 2 * r], acc_v[4 * j + 2 * r + 1]);
    }
  }
}

// Operands of the float32 backward kernels: base pointers and (batch, seq,
// head) strides in elements, the unit-stride head dim last.
struct Strided {
  const float* p;
  int64_t sb, ss, sh;
};

// dq of one (q tile, q head, batch row) in float32; see the file's note 3.
template <int D>
__global__ void __launch_bounds__(FA_THREADS)
flash_bwd_dq_f32_kernel(Strided q, Strided k, Strided v, Strided dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int64_t dqsb, int64_t dqss,
                        int64_t dqsh, int Hq, int Hkv, int Sq, int Skv,
                        int causal, float scale) {
  using T = float;
  constexpr int S = TileStride<T, D>::value;
  constexpr int DC = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* dos = qs + FA_BQ * S;
  T* ks = dos + FA_BQ * S;
  T* vs = ks + FA_BK * S;
  float* dss = reinterpret_cast<float*>(vs + FA_BK * S);
  float* lse_s = dss + FA_BQ * FA_PS;
  float* dl_s = lse_s + FA_BQ;

  const int q0 = blockIdx.x * FA_BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q_offset = Skv - Sq;
  const int qrows = min(FA_BQ, Sq - q0);

  load_tile<T, D>(qs, q.p + b * q.sb + h * q.sh + q0 * q.ss, q.ss, qrows);
  load_tile<T, D>(dos, dout.p + b * dout.sb + h * dout.sh + q0 * dout.ss,
                  dout.ss, qrows);
  const int64_t row0 = ((int64_t)b * Hq + h) * Sq + q0;
  if (threadIdx.x < FA_BQ) {
    const bool in = threadIdx.x < qrows;
    lse_s[threadIdx.x] = in ? lse[row0 + threadIdx.x] : 0.f;
    dl_s[threadIdx.x] = in ? delta[row0 + threadIdx.x] : 0.f;
  }
  const T* kb = k.p + b * k.sb + hk * k.sh;
  const T* vb = v.p + b * v.sb + hk * v.sh;

  // keys [0, kv_end) can be visible to some row of this tile
  int kv_end = Skv;
  if (causal) kv_end = min(Skv, q_offset + q0 + FA_BQ);

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < kv_end; k0 += FA_BK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(ks, kb + k0 * k.ss, k.ss, min(FA_BK, Skv - k0));
    load_tile<T, D>(vs, vb + k0 * v.ss, v.ss, min(FA_BK, Skv - k0));
    __syncthreads();

    // s = q k^T and dp = do v^T: rows ty + 16 i, keys tx + 16 j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 2) {
      float2 qa[4], oa[4], ka[4], va[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = load2(qs + (ty + 16 * i) * S + d);
        oa[i] = load2(dos + (ty + 16 * i) * S + d);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ka[j] = load2(ks + (tx + 16 * j) * S + d);
        va[j] = load2(vs + (tx + 16 * j) * S + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);
          dp[i][j] = fmaf(oa[i].x, va[j].x, dp[i][j]);
          dp[i][j] = fmaf(oa[i].y, va[j].y, dp[i][j]);
        }
    }

    // ds = p (dp - delta), selected to 0 on masked entries: exp(s - lse)
    // is never taken there (lse may be -inf)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q_offset + q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool keep = r < qrows && kpos < Skv && (!causal || kpos <= qpos);
        float ds = 0.f;
        if (keep) ds = expf(s[i][j] * scale - lse_s[r]) * (dp[i][j] - dl_s[r]);
        dss[r * FA_PS + tx + 16 * j] = ds;
      }
    }
    __syncthreads();

    // acc += ds k: rows ty + 16 i, columns tx + 16 j
#pragma unroll 4
    for (int kk = 0; kk < FA_BK; ++kk) {
      float dsr[4], kv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsr[i] = dss[(ty + 16 * i) * FA_PS + kk];
#pragma unroll
      for (int j = 0; j < DC; ++j) kv[j] = to_f(ks[kk * S + tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(dsr[i], kv[j], acc[i][j]);
    }
  }

  T* out = dq + b * dqsb + h * dqsh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      out[r * dqss + tx + 16 * j] = from_f<T>(acc[i][j] * scale);
  }
}

// dk and dv of one (kv tile, kv head, batch row) in float32, summed over
// the GQA group's query heads; see the file's note 4.
template <int D>
__global__ void __launch_bounds__(FA_THREADS)
flash_bwd_dkv_f32_kernel(Strided q, Strided k, Strided v, Strided dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int64_t gsb, int64_t gss, int64_t gsh, int Hq,
                         int Hkv, int Sq, int Skv, int causal, float scale) {
  using T = float;
  constexpr int S = TileStride<T, D>::value;
  constexpr int DC = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + FA_BK * S;
  T* qs = vs + FA_BK * S;
  T* dos = qs + FA_BQ * S;
  float* ps = reinterpret_cast<float*>(dos + FA_BQ * S);  // p^T: (key, query)
  float* dss = ps + FA_BK * FA_PS;                         // ds^T
  float* lse_s = dss + FA_BK * FA_PS;
  float* dl_s = lse_s + FA_BQ;

  const int k0 = blockIdx.x * FA_BK;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q_offset = Skv - Sq;
  const int krows = min(FA_BK, Skv - k0);

  load_tile<T, D>(ks, k.p + b * k.sb + hk * k.sh + k0 * k.ss, k.ss, krows);
  load_tile<T, D>(vs, v.p + b * v.sb + hk * v.sh + k0 * v.ss, v.ss, krows);

  // q rows [q_first, Sq) can see some key of this tile; q tiles start at
  // multiples of FA_BQ, as in the forward and dq
  int q_first = 0;
  if (causal) q_first = max(0, k0 - q_offset) / FA_BQ * FA_BQ;

  float acc_k[4][DC], acc_v[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* qb = q.p + b * q.sb + h * q.sh;
    const T* ob = dout.p + b * dout.sb + h * dout.sh;
    const int64_t rows = ((int64_t)b * Hq + h) * Sq;
    for (int q0 = q_first; q0 < Sq; q0 += FA_BQ) {
      const int qrows = min(FA_BQ, Sq - q0);
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, D>(qs, qb + q0 * q.ss, q.ss, qrows);
      load_tile<T, D>(dos, ob + q0 * dout.ss, dout.ss, qrows);
      if (threadIdx.x < FA_BQ) {
        const bool in = threadIdx.x < qrows;
        lse_s[threadIdx.x] = in ? lse[rows + q0 + threadIdx.x] : 0.f;
        dl_s[threadIdx.x] = in ? delta[rows + q0 + threadIdx.x] : 0.f;
      }
      __syncthreads();

      // s^T = k q^T and dp^T = v do^T: keys ty + 16 i, queries tx + 16 j
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; d += 2) {
        float2 ka[4], va[4], qa[4], oa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ka[i] = load2(ks + (ty + 16 * i) * S + d);
          va[i] = load2(vs + (ty + 16 * i) * S + d);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qa[j] = load2(qs + (tx + 16 * j) * S + d);
          oa[j] = load2(dos + (tx + 16 * j) * S + d);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(ka[i].x, qa[j].x, s[i][j]);
            s[i][j] = fmaf(ka[i].y, qa[j].y, s[i][j]);
            dp[i][j] = fmaf(va[i].x, oa[j].x, dp[i][j]);
            dp[i][j] = fmaf(va[i].y, oa[j].y, dp[i][j]);
          }
      }

      // p and ds, selected to 0 on masked entries
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kr = ty + 16 * i;
        const int kpos = k0 + kr;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const int qpos = q_offset + q0 + c;
          const bool keep = c < qrows && kr < krows &&
                            (!causal || kpos <= qpos);
          float p = 0.f, ds = 0.f;
          if (keep) {
            p = expf(s[i][j] * scale - lse_s[c]);
            ds = p * (dp[i][j] - dl_s[c]);
          }
          ps[kr * FA_PS + c] = p;
          dss[kr * FA_PS + c] = ds;
        }
      }
      __syncthreads();

      // acc_v += p^T do and acc_k += ds^T q: keys ty + 16 i, columns
      // tx + 16 j
#pragma unroll 4
      for (int qq = 0; qq < FA_BQ; ++qq) {
        float pv[4], dsv[4], ov[DC], qv[DC];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = ps[(ty + 16 * i) * FA_PS + qq];
          dsv[i] = dss[(ty + 16 * i) * FA_PS + qq];
        }
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          ov[j] = to_f(dos[qq * S + tx + 16 * j]);
          qv[j] = to_f(qs[qq * S + tx + 16 * j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DC; ++j) {
            acc_v[i][j] = fmaf(pv[i], ov[j], acc_v[i][j]);
            acc_k[i][j] = fmaf(dsv[i], qv[j], acc_k[i][j]);
          }
      }
    }
  }

  T* dkb = dk + b * gsb + hk * gsh;
  T* dvb = dv + b * gsb + hk * gsh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= Skv) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      dkb[r * gss + tx + 16 * j] = from_f<T>(acc_k[i][j] * scale);
      dvb[r * gss + tx + 16 * j] = from_f<T>(acc_v[i][j]);
    }
  }
}

// st: (batch, seq, head) strides of q, k, v, o
template <int D>
cudaError_t launch_flash_f32(const void* q, const void* k, const void* v,
                             void* o, float* lse, int B, int Hq, int Hkv,
                             int Sq, int Skv, const int64_t* st, int causal,
                             float scale, cudaStream_t stream) {
  const size_t smem = fa_smem_bytes<float, D>();
  static std::atomic<bool> smem_set[HOPPER_MAX_DEVICES];
  cudaError_t err = smem_opt_in(flash_fwd_f32_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + FA_BQ - 1) / FA_BQ, Hq, B);
  flash_fwd_f32_kernel<D><<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Hq, Hkv, Sq,
      Skv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], causal, scale);
  return cudaGetLastError();
}

// A 4-D tensor map (D, S, H, B innermost first) over a strided bf16 view
// with (batch, seq, head) element strides st, in boxes of 64 rows x BOX
// columns with the plan's swizzle; rows past S read as zeros. A dimension
// of size 1 is never stepped, so its stride is replaced by a legal one.
template <int D>
cudaError_t make_map(CUtensorMap* map, const void* p, int B, int S, int H,
                     const int64_t* st) {
  using P = FwdPlan<D>;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const int sizes[3] = {S, H, B};
  const int64_t elems[3] = {st[1], st[2], st[0]};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = sizes[i] > 1 ? (cuuint64_t)elems[i] * 2 : (cuuint64_t)D * 2;
  const cuuint32_t box[4] = {(cuuint32_t)P::BOX, (cuuint32_t)FH_BN, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      P::ROW == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : P::ROW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                     : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// st: (batch, seq, head) strides of q, k, v, o
template <int D>
cudaError_t launch_flash_bf16(const void* q, const void* k, const void* v,
                              void* o, float* lse, int B, int Hq, int Hkv,
                              int Sq, int Skv, const int64_t* st, int causal,
                              float scale, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = make_map<D>(&tm_q, q, B, Sq, Hq, st);
  if (err == cudaSuccess) err = make_map<D>(&tm_k, k, B, Skv, Hkv, st + 3);
  if (err == cudaSuccess) err = make_map<D>(&tm_v, v, B, Skv, Hkv, st + 6);
  if (err != cudaSuccess) return err;
  static std::atomic<bool> smem_set[HOPPER_MAX_DEVICES];
  err = smem_opt_in(flash_fwd_bf16_kernel<D>, FwdPlan<D>::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + FH_BM - 1) / FH_BM, Hq, B);
  flash_fwd_bf16_kernel<D><<<grid, FH_THREADS, FwdPlan<D>::SMEM, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), lse, Hq, Hkv, Sq,
      Skv, st[9], st[10], st[11], causal, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

Strided strided(const void* p, const int64_t* st) {
  return Strided{static_cast<const float*>(p), st[0], st[1], st[2]};
}

// One of the three flash kernels (0 forward, 1 dq, 2 dk/dv) for element
// type T, by head dim. Pointers: q, k, v, o (forward) or do, lse, delta,
// then the outputs. st: (batch, seq, head) strides of q, k, v, o or do,
// then of dq or of dk and dv (alike).
struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* x;     // forward: o (written); backward: do
  float* lse;        // forward: written when not null; backward: read
  const float* delta;
  void* out0;        // dq, or dk
  void* out1;        // dv
  int B, Hq, Hkv, Sq, Skv;
  const int64_t* st;
  int causal;
  float scale;
};

template <int D>
cudaError_t launch_bwd_f32(int kind, const FlashArgs& a,
                           cudaStream_t stream) {
  const int64_t* st = a.st;
  static std::atomic<bool> dq_set[HOPPER_MAX_DEVICES], dkv_set[HOPPER_MAX_DEVICES];
  if (kind == 1) {
    const size_t smem = bwd_smem_bytes<float, D>(1);
    cudaError_t err = smem_opt_in(flash_bwd_dq_f32_kernel<D>, smem, dq_set);
    if (err != cudaSuccess) return err;
    dim3 grid((a.Sq + FA_BQ - 1) / FA_BQ, a.Hq, a.B);
    flash_bwd_dq_f32_kernel<D><<<grid, FA_THREADS, smem, stream>>>(
        strided(a.q, st), strided(a.k, st + 3), strided(a.v, st + 6),
        strided(a.x, st + 9), a.lse, a.delta, static_cast<float*>(a.out0),
        st[12], st[13], st[14], a.Hq, a.Hkv, a.Sq, a.Skv, a.causal, a.scale);
  } else {
    const size_t smem = bwd_smem_bytes<float, D>(2);
    cudaError_t err =
        smem_opt_in(flash_bwd_dkv_f32_kernel<D>, smem, dkv_set);
    if (err != cudaSuccess) return err;
    dim3 grid((a.Skv + FA_BK - 1) / FA_BK, a.Hkv, a.B);
    flash_bwd_dkv_f32_kernel<D><<<grid, FA_THREADS, smem, stream>>>(
        strided(a.q, st), strided(a.k, st + 3), strided(a.v, st + 6),
        strided(a.x, st + 9), a.lse, a.delta, static_cast<float*>(a.out0),
        static_cast<float*>(a.out1), st[12], st[13], st[14], a.Hq, a.Hkv,
        a.Sq, a.Skv, a.causal, a.scale);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_bf16(int kind, const FlashArgs& a,
                            cudaStream_t stream) {
  const int64_t* st = a.st;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  cudaError_t err = make_map<D>(&tm_q, a.q, a.B, a.Sq, a.Hq, st);
  if (err == cudaSuccess)
    err = make_map<D>(&tm_k, a.k, a.B, a.Skv, a.Hkv, st + 3);
  if (err == cudaSuccess)
    err = make_map<D>(&tm_v, a.v, a.B, a.Skv, a.Hkv, st + 6);
  if (err == cudaSuccess)
    err = make_map<D>(&tm_do, a.x, a.B, a.Sq, a.Hq, st + 9);
  if (err != cudaSuccess) return err;
  static std::atomic<bool> dq_set[HOPPER_MAX_DEVICES], dkv_set[HOPPER_MAX_DEVICES];
  if (kind == 1) {
    constexpr size_t smem = DqPlan<D>::SMEM;
    err = smem_opt_in(flash_bwd_dq_bf16_kernel<D>, smem, dq_set);
    if (err != cudaSuccess) return err;
    dim3 grid((a.Sq + FH_BM - 1) / FH_BM, a.Hq, a.B);
    flash_bwd_dq_bf16_kernel<D><<<grid, FH_THREADS, smem, stream>>>(
        tm_q, tm_k, tm_v, tm_do, a.lse, a.delta,
        static_cast<__nv_bfloat16*>(a.out0), a.Hq, a.Hkv, a.Sq, a.Skv,
        st[12], st[13], st[14], a.causal, a.scale);
  } else {
    constexpr size_t smem = DkvPlan<D>::SMEM;
    err = smem_opt_in(flash_bwd_dkv_bf16_kernel<D>, smem, dkv_set);
    if (err != cudaSuccess) return err;
    dim3 grid((a.Skv + FH_BM - 1) / FH_BM, a.Hkv, a.B);
    flash_bwd_dkv_bf16_kernel<D><<<grid, FH_THREADS, smem, stream>>>(
        tm_q, tm_k, tm_v, tm_do, a.lse, a.delta,
        static_cast<__nv_bfloat16*>(a.out0),
        static_cast<__nv_bfloat16*>(a.out1), a.Hq, a.Hkv, a.Sq, a.Skv,
        st[12], st[13], st[14], a.causal, a.scale);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_kind(int kind, const FlashArgs& a, cudaStream_t s) {
  constexpr bool f32 = std::is_same<T, float>::value;
  switch (kind) {
    case 0:
      if constexpr (f32)
        return launch_flash_f32<D>(a.q, a.k, a.v, const_cast<void*>(a.x),
                                   a.lse, a.B, a.Hq, a.Hkv, a.Sq, a.Skv, a.st,
                                   a.causal, a.scale, s);
      else
        return launch_flash_bf16<D>(a.q, a.k, a.v, const_cast<void*>(a.x),
                                    a.lse, a.B, a.Hq, a.Hkv, a.Sq, a.Skv,
                                    a.st, a.causal, a.scale, s);
    case 1:
    case 2:
      if constexpr (f32)
        return launch_bwd_f32<D>(kind, a, s);
      else
        return launch_bwd_bf16<D>(kind, a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_flash_d(int kind, int D, const FlashArgs& a,
                           cudaStream_t s) {
  switch (D) {
    case 16: return launch_kind<T, 16>(kind, a, s);
    case 32: return launch_kind<T, 32>(kind, a, s);
    case 64: return launch_kind<T, 64>(kind, a, s);
    case 128: return launch_kind<T, 128>(kind, a, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_flash_any(int kind, int dtype, int D, const FlashArgs& a,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_flash_d<float>(kind, D, a, s);
  if (dtype == 1) return launch_flash_d<__nv_bfloat16>(kind, D, a, s);
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------------- paged decode
constexpr int PD_CHUNK = 128;   // positions per CTA: a constant, so a row's
                                // result never depends on the batch
constexpr int PD_GMAX = 8;      // query heads per kv head (GQA group) at most
constexpr int PD_CWARPS = 4;    // consumer warps; warp 0 is the producer
constexpr int PD_THREADS = 32 * (1 + PD_CWARPS);
constexpr int PD_MB = 8;        // chunk partials the merge reads at once
constexpr int PD_BOX_ROWS = 64;       // rows of one TMA box at most
constexpr int PD_RING = 64 * 1024;    // ring bytes aimed at
constexpr int PD_MAX_STAGES = 32;
constexpr int PD_SMEM_MAX = 232448;   // an H100 block's opt-in limit

__host__ __device__ constexpr int pd_align(int x, int a) {
  return (x + a - 1) / a * a;
}

// pages a chunk of PD_CHUNK positions touches at most
__host__ __device__ constexpr int pd_chunk_pages(int P) {
  return (PD_CHUNK - 1) / P + 2;
}

// The shared-memory plan of one (page size, head dim, element size): a
// ring of `ns` stages, each one box of K and one of V (`br` rows of one kv
// head, D wide), with the int8 rows' scales after them; the ring is reused
// for the warps' merge at the end; then the mbarriers, the staged table
// entries and the ticket flag. Offsets from a 128-byte aligned base.
struct PdPlan {
  int br, box, sbox, stage, ns, bar_off, table_off, flag_off, smem;
};

__host__ __device__ inline PdPlan pd_plan(int P, int D, int esz, bool quant) {
  PdPlan p;
  p.br = P < PD_BOX_ROWS ? P : PD_BOX_ROWS;
  p.box = pd_align(p.br * D * esz, 128);
  p.sbox = quant ? pd_align(p.br * 4, 16) : 0;
  p.stage = pd_align(2 * p.box + 2 * p.sbox, 128);
  // tiles a chunk can touch: its pages, each in ceil(P / br) boxes
  const int tiles = pd_chunk_pages(P) * ((P + p.br - 1) / p.br);
  int ns = PD_RING / p.stage;
  ns = ns < 2 ? 2 : ns;
  ns = ns > tiles ? tiles : ns;
  p.ns = ns > PD_MAX_STAGES ? PD_MAX_STAGES : ns;
  const int merge = PD_CWARPS * PD_GMAX * (D + 2) * 4;
  const int ring = p.ns * p.stage > merge ? p.ns * p.stage : merge;
  p.bar_off = pd_align(ring, 8);
  p.table_off = p.bar_off + 16 * p.ns;
  p.flag_off = p.table_off + 4 * pd_chunk_pages(P);
  p.smem = p.flag_off + 4 + 128;  // + the base's alignment
  return p;
}

// one 4-byte cp.async, global to shared
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// an arrival on `bar` once this thread's earlier cp.asyncs have landed,
// counted in the barrier's expected arrivals (.noinc)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the consumer warps' own barrier (the producer warp has left)
__device__ __forceinline__ void pd_consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * PD_CWARPS) : "memory");
}

// raw vector type of B bytes, for one load of a lane's head-dim vector
template <int B> struct RawVec;
template <> struct RawVec<1> { using type = uint8_t; };
template <> struct RawVec<2> { using type = uint16_t; };
template <> struct RawVec<4> { using type = uint32_t; };
template <> struct RawVec<8> { using type = uint2; };
template <> struct RawVec<16> { using type = uint4; };

// N elements of type T (N * sizeof(T) bytes, aligned so) as floats
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  using R = typename RawVec<sizeof(T) * N>::type;
  const R raw = *reinterpret_cast<const R*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f(e[i]);
}

// LANES of a row: the fewest (a power of two) that give each lane at most
// `et` of the row's D elements
__host__ __device__ constexpr int pd_lanes(int D, int et) {
  int l = 1;
  while (l < 32 && (D % l != 0 || D / l > et)) l *= 2;
  return l;
}

// the widest vector (a power of two, at most vmax elements) dividing E
__host__ __device__ constexpr int pd_vec(int E, int vmax) {
  int v = 1;
  while (v * 2 <= vmax && E % (v * 2) == 0) v *= 2;
  return v;
}

// A consumer warp's layout over rows of D elements: LANES lanes a row (a
// lane group), E elements a lane, RPW rows a warp at once. A lane reads its
// E elements as vectors of VB elements (16 bytes where E allows), in-
// terleaved across its group (element e of lane `sub` is column col(sub,
// e)), so the lanes of a group read contiguous bytes. The pair layout
// (G = 2) aims at 16 elements a lane, the wide group (G = 8) at 8, to keep
// q and acc in registers. At D = 16, 32, 64 and 128 that is 16 (8)
// elements a lane in 16-byte vectors; zamba2's D = 80 takes 8 lanes of 10
// elements in 4-byte vectors (bf16), or 16 lanes of 5 in the wide group.
template <typename TKV, int D, int G>
struct PdLanes {
  static constexpr int LANES = pd_lanes(D, G <= 2 ? 16 : 8);
  static constexpr int E = D / LANES;
  static constexpr int RPW = 32 / LANES;
  static constexpr int VB = pd_vec(E, 16 / (int)sizeof(TKV));
  static_assert(LANES * E == D && E <= (G <= 2 ? 16 : 8),
                "no lane layout for this head dim");
  __device__ static __forceinline__ int col(int sub, int e) {
    return ((e / VB) * LANES + sub) * VB + e % VB;
  }
};

// One launch a call. One CTA per (chunk of PD_CHUNK positions, kv head,
// batch row); a CTA whose chunk starts at or past the row's valid length
// returns at once (split 0 of a row with none writes its zeros). Warp 0's
// lane 0 walks the chunk's pages and asks TMA for each page's K and V box
// (int8: its lanes copy the rows' scales by cp.async, counted on the same
// barrier); the 4 consumer warps take the tiles in turn, a tile's rows
// spread over a warp's lane groups (PdLanes), and keep an online softmax
// per query head of the group. A row that fits one chunk is normalized
// and written here; otherwise each CTA writes its (m, l, acc), and the CTA
// that draws the row's last ticket merges the chunks in order and resets
// the ticket. Scores are in base 2 (scale_log2 = scale * log2 e). G is
// the group size the registers are laid out for (2 or PD_GMAX), at least
// Hq / Hkv: the engine's group of 2 holds its q and acc in 64 registers a
// lane, which lets three CTAs share an SM.
template <typename TQ, typename TKV, int D, int G>
__global__ void __launch_bounds__(PD_THREADS, G <= 2 ? 3 : 1)
paged_decode_kernel(const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const TQ* __restrict__ q, const float* __restrict__ kscale,
                    const float* __restrict__ vscale,
                    const int* __restrict__ table,
                    const int* __restrict__ valid, float* __restrict__ part_m,
                    float* __restrict__ part_l, float* __restrict__ part_acc,
                    int* __restrict__ tickets, TQ* __restrict__ out, int Hq,
                    int Hkv, int P, int npages, int nsplit,
                    float scale_log2) {
  constexpr bool QUANT = std::is_same<TKV, int8_t>::value;
  extern __shared__ unsigned char pd_smem[];
  const PdPlan plan = pd_plan(P, D, (int)sizeof(TKV), QUANT);
  unsigned char* sm = pd_smem + ((128u - (smem_addr(pd_smem) & 127u)) & 127u);
  const uint32_t base = smem_addr(sm);
  const uint32_t full = base + plan.bar_off;      // + 8 * stage
  const uint32_t empty = full + 8 * plan.ns;      // + 8 * stage
  int* s_table = reinterpret_cast<int*>(sm + plan.table_off);
  volatile int* s_flag = reinterpret_cast<int*>(sm + plan.flag_off);

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv;
  const int64_t h0 = (int64_t)b * Hq + hk * group;  // the group's first head
  const int t0 = split * PD_CHUNK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row_valid = valid[b];
  if (warp == 0) {
    // the producer's table entries over the chunk's whole reach, read
    // while `valid` is in flight (those past it are never used)
    const int last = min((t0 + PD_CHUNK - 1) / P, npages - 1) - t0 / P;
    for (int i = lane; i <= last; i += 32)
      s_table[i] = table[(int64_t)b * npages + t0 / P + i];
  }
  // positions past the table's reach are not read (the Pallas grid stops
  // at npages pages as well)
  const int n = max(0, min(row_valid, npages * P));
  if (t0 >= n) {
    // a row with no valid position gives 0, as the Pallas kernel does
    if (split == 0)
      for (int i = threadIdx.x; i < group * D; i += PD_THREADS)
        out[h0 * D + i] = from_f<TQ>(0.f);
    return;
  }
  const int t1 = min(n, t0 + PD_CHUNK);
  const int used = (n + PD_CHUNK - 1) / PD_CHUNK;  // the row's chunks
  const int p0 = t0 / P, p1 = (t1 - 1) / P;        // the chunk's pages
  const int br = plan.br, ns = plan.ns;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(full + 8 * s, QUANT ? 1 + 32 : 1);
      mbar_init(empty + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    // producer: one tile (a box of K and of V) a stage, in page order;
    // pages past the chunk's last valid position are never asked for
    int it = 0;
    for (int p = p0; p <= p1; ++p) {
      const int page = s_table[p - p0];
      for (int r0 = 0; r0 < P; r0 += br) {
        const int a = p * P + r0, rows = min(br, P - r0);
        if (a + rows <= t0 || a >= t1) continue;
        const int s = it % ns;
        if (it >= ns) mbar_wait(empty + 8 * s, (it / ns - 1) & 1);
        const uint32_t st = base + s * plan.stage;
        if constexpr (QUANT) {
          for (int r = lane; r < rows; r += 32) {
            const int64_t row = ((int64_t)page * P + r0 + r) * Hkv + hk;
            cp_async4(st + 2 * plan.box + 4 * r, kscale + row);
            cp_async4(st + 2 * plan.box + plan.sbox + 4 * r, vscale + row);
          }
          cp_async_arrive(full + 8 * s);
        }
        if (lane == 0) {
          // rows of the box past the page read as zeros and count
          mbar_expect_tx(full + 8 * s, 2u * br * D * (uint32_t)sizeof(TKV));
          tma_load(st, &tm_k, full + 8 * s, 0, hk, r0, page);
          tma_load(st + plan.box, &tm_v, full + 8 * s, 0, hk, r0, page);
        }
        ++it;
      }
    }
    if constexpr (QUANT) cp_async_wait_all();
    return;
  }

  // consumers: warp cw takes tiles cw, cw + 4, ... of the chunk; a tile's
  // rows go to the warp's lane groups, one row a group at a time, and each
  // group keeps its own online softmax, rescaled only when its max grows
  using Lay = PdLanes<TKV, D, G>;
  constexpr int E = Lay::E, VB = Lay::VB;
  const int cw = warp - 1, ct = threadIdx.x - 32;
  const int grp = lane / Lay::LANES, sub = lane % Lay::LANES;
  float qr[G][E], acc[G][E], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -CUDART_INF_F;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      acc[g][e] = 0.f;
      qr[g][e] = g < group ? to_f(q[(h0 + g) * D + Lay::col(sub, e)]) : 0.f;
    }
  }

  int it = 0;
  for (int p = p0; p <= p1; ++p) {
    for (int r0 = 0; r0 < P; r0 += br) {
      const int a = p * P + r0, rows = min(br, P - r0);
      if (a + rows <= t0 || a >= t1) continue;
      const int s = it % ns, phase = (it / ns) & 1;
      if (it++ % PD_CWARPS != cw) continue;  // another warp's tile
      mbar_wait(full + 8 * s, phase);
      const unsigned char* st = sm + s * plan.stage;
      const TKV* kt = reinterpret_cast<const TKV*>(st);
      const TKV* vt = reinterpret_cast<const TKV*>(st + plan.box);
      const float* kst = reinterpret_cast<const float*>(st + 2 * plan.box);
      const float* vst = kst + plan.sbox / 4;
      // the tile's rows inside [t0, t1): rows at or past `valid` (NaN in
      // a pool is possible there) are never read
      const int lo = max(t0 - a, 0), hi = min(rows, t1 - a);
      for (int rb = lo; rb < hi; rb += Lay::RPW) {
        const int r = rb + grp;
        const bool live = r < hi;
        float kv[E], vv[E];
        if (live) {
#pragma unroll
          for (int j = 0; j < E / VB; ++j) {
            load_vec<TKV, VB>(kt + r * D + Lay::col(sub, j * VB), kv + j * VB);
            load_vec<TKV, VB>(vt + r * D + Lay::col(sub, j * VB), vv + j * VB);
          }
          if constexpr (QUANT) {
            // dequantize, then the dot, as the Pallas body does
            const float ks = kst[r], vs = vst[r];
#pragma unroll
            for (int e = 0; e < E; ++e) {
              kv[e] *= ks;
              vv[e] *= vs;
            }
          }
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) kv[e] = vv[e] = 0.f;
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (g >= group) continue;
          float d0 = 0.f, d1 = 0.f;
#pragma unroll
          for (int e = 0; e < E; e += 2) {
            d0 = fmaf(qr[g][e], kv[e], d0);
            if (e + 1 < E) d1 = fmaf(qr[g][e + 1], kv[e + 1], d1);
          }
          float dot = d0 + d1;
#pragma unroll
          for (int off = Lay::LANES / 2; off > 0; off >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          if (live) {
            const float sc = dot * scale_log2;
            if (sc > m[g]) {  // a new max: rescale what the group holds
              const float alpha = exp2f(m[g] - sc);  // 0 at the first row
              l[g] *= alpha;
#pragma unroll
              for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
              m[g] = sc;
            }
            const float pr = exp2f(sc - m[g]);
            l[g] += pr;
#pragma unroll
            for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pr, vv[e], acc[g][e]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
  }

  // the warp's lane groups combine by a butterfly over the group bits; a
  // group that saw no row holds m = -inf, weight 0. The two lanes of a
  // pair may round their sums differently (the compiler contracts either
  // product into an fma), so the groups' bits may differ: only group 0's
  // state is stored, and its order of combination is fixed, so the
  // result does not depend on the run
#pragma unroll
  for (int off = Lay::LANES; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g >= group) continue;
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float M = fmaxf(m[g], mo);
      const float c = M == -CUDART_INF_F ? 0.f : exp2f(m[g] - M);
      const float co = M == -CUDART_INF_F ? 0.f : exp2f(mo - M);
      l[g] = l[g] * c + lo_ * co;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * c + ao * co;
      }
      m[g] = M;
    }
  }

  // merge the warps' states into the chunk's, through the ring (every
  // stage has been read); a warp that saw no row holds m = -inf, weight 0
  float* wm = reinterpret_cast<float*>(sm);    // [warp][g]
  float* wl = wm + PD_CWARPS * G;              // [warp][g]
  float* wa = wl + PD_CWARPS * G;              // [warp][g][D]
  pd_consumer_sync();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g >= group) continue;
    if (lane == 0) {
      wm[cw * G + g] = m[g];
      wl[cw * G + g] = l[g];
    }
    if (grp == 0)
#pragma unroll
      for (int e = 0; e < E; ++e)
        wa[(cw * G + g) * D + Lay::col(sub, e)] = acc[g][e];
  }
  pd_consumer_sync();
  for (int i = ct; i < group * D; i += 32 * PD_CWARPS) {
    const int g = i / D, d = i % D;
    float M = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < PD_CWARPS; ++w) M = fmaxf(M, wm[w * G + g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < PD_CWARPS; ++w) {
      const float c = exp2f(wm[w * G + g] - M);
      L += wl[w * G + g] * c;
      A += wa[(w * G + g) * D + d] * c;
    }
    if (used == 1) {
      out[h0 * D + i] = from_f<TQ>(A / fmaxf(L, 1e-30f));
    } else {
      const int64_t hs = (h0 + g) * nsplit + split;
      part_acc[hs * D + d] = A;
      if (d == 0) {
        part_m[hs] = M;
        part_l[hs] = L;
      }
    }
  }
  if (used == 1) return;

  // the row's chunks meet here: each CTA publishes its partial, then draws
  // a ticket; the last one merges all of them in chunk order, so the bits
  // do not depend on which CTA came last
  __threadfence();
  pd_consumer_sync();
  if (ct == 0)
    *s_flag = atomicAdd(&tickets[b * Hkv + hk], 1) == used - 1;
  pd_consumer_sync();
  if (!*s_flag) return;
  __threadfence();
  // each thread merges two of the group's (head, column) entries at once,
  // reading their partials PD_MB chunks at a time with every load of a
  // batch issued before the sums take them in chunk order: a row of up to
  // PD_MB chunks costs two L2 round trips, the maxima, then the rest
  for (int i0 = ct; i0 < group * D; i0 += 2 * 32 * PD_CWARPS) {
    int64_t hs[2];
    int dd[2];
    bool on[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int i = i0 + t * 32 * PD_CWARPS;
      on[t] = i < group * D;
      hs[t] = (h0 + (on[t] ? i / D : 0)) * nsplit;
      dd[t] = i % D;
    }
    float M[2] = {-CUDART_INF_F, -CUDART_INF_F};
    for (int s0 = 0; s0 < used; s0 += PD_MB) {
      float mv[2][PD_MB];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int j = 0; j < PD_MB; ++j)
          mv[t][j] = on[t] && s0 + j < used ? __ldcg(part_m + hs[t] + s0 + j)
                                            : -CUDART_INF_F;
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int j = 0; j < PD_MB; ++j) M[t] = fmaxf(M[t], mv[t][j]);
    }
    float L[2] = {0.f, 0.f}, A[2] = {0.f, 0.f};
    for (int s0 = 0; s0 < used; s0 += PD_MB) {
      float mv[2][PD_MB], lv[2][PD_MB], av[2][PD_MB];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int j = 0; j < PD_MB; ++j) {
          const bool in = on[t] && s0 + j < used;
          const int64_t c = hs[t] + s0 + j;
          mv[t][j] = in ? __ldcg(part_m + c) : 0.f;
          lv[t][j] = in ? __ldcg(part_l + c) : 0.f;
          av[t][j] = in ? __ldcg(part_acc + c * D + dd[t]) : 0.f;
        }
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int j = 0; j < PD_MB; ++j) {
          if (s0 + j >= used) break;
          const float c = exp2f(mv[t][j] - M[t]);
          L[t] += lv[t][j] * c;
          A[t] += av[t][j] * c;
        }
    }
#pragma unroll
    for (int t = 0; t < 2; ++t)
      if (on[t])
        out[h0 * D + i0 + t * 32 * PD_CWARPS] =
            from_f<TQ>(A[t] / fmaxf(L[t], 1e-30f));
  }
  if (ct == 0) tickets[b * Hkv + hk] = 0;  // ready for the next launch
}

template <typename TKV>
constexpr CUtensorMapDataType pd_map_type() {
  return std::is_same<TKV, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
         : std::is_same<TKV, int8_t>::value
             ? CU_TENSOR_MAP_DATA_TYPE_UINT8
             : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// A 4-D tensor map (D, Hkv, P, num_pages innermost first) over a
// contiguous pool, in boxes of (D, 1 head, br rows, 1 page): TMA takes a
// page number from the table as a coordinate, and rows of a box past the
// page read as zeros. 16-byte aligned base (the wrapper checks it).
template <typename TKV>
cudaError_t make_pool_map(CUtensorMap* map, const void* pool, int num_pages,
                          int P, int Hkv, int D) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t esz = sizeof(TKV);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hkv, (cuuint64_t)P,
                              (cuuint64_t)num_pages};
  const cuuint64_t strides[3] = {D * esz, (cuuint64_t)Hkv * D * esz,
                                 (cuuint64_t)P * Hkv * D * esz};
  const PdPlan plan = pd_plan(P, D, (int)esz, false);
  const cuuint32_t box[4] = {(cuuint32_t)D, 1, (cuuint32_t)plan.br, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, pd_map_type<TKV>(), 4, const_cast<void*>(pool), dims, strides,
      box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename TQ, typename TKV, int D>
cudaError_t launch_paged(const void* kmap, const void* vmap, const void* q,
                         const float* ks, const float* vs, const int* table,
                         const int* valid, float* part, int* tickets,
                         void* out, int B, int Hq, int Hkv, int P, int npages,
                         int nsplit, float scale, cudaStream_t stream) {
  constexpr bool QUANT = std::is_same<TKV, int8_t>::value;
  if (QUANT != (ks != nullptr && vs != nullptr)) return cudaErrorInvalidValue;
  const PdPlan plan = pd_plan(P, D, (int)sizeof(TKV), QUANT);
  if (plan.smem > PD_SMEM_MAX) return cudaErrorInvalidValue;
  const bool pair = Hq / Hkv <= 2;
  auto kernel = pair ? paged_decode_kernel<TQ, TKV, D, 2>
                     : paged_decode_kernel<TQ, TKV, D, PD_GMAX>;
  static std::atomic<bool> smem_set[2][HOPPER_MAX_DEVICES];
  cudaError_t err = smem_opt_in(kernel, PD_SMEM_MAX, smem_set[pair]);
  if (err != cudaSuccess) return err;
  CUtensorMap tm_k, tm_v;
  memcpy(&tm_k, kmap, sizeof(CUtensorMap));
  memcpy(&tm_v, vmap, sizeof(CUtensorMap));
  float* pm = part;
  float* pl = pm + (size_t)B * Hq * nsplit;
  float* pa = pl + (size_t)B * Hq * nsplit;
  kernel<<<dim3(nsplit, Hkv, B), PD_THREADS, plan.smem, stream>>>(
      tm_k, tm_v, static_cast<const TQ*>(q), ks, vs, table, valid, pm, pl,
      pa, tickets, static_cast<TQ*>(out), Hq, Hkv, P, npages, nsplit,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

struct PagedArgs {
  const void* kmap;
  const void* vmap;
  const void* q;
  const float* ks;
  const float* vs;
  const int* table;
  const int* valid;
  float* part;
  int* tickets;
  void* out;
  int B, Hq, Hkv, P, npages, nsplit;
  float scale;
};

template <typename TQ, typename TKV, int D>
cudaError_t launch_paged_a(const PagedArgs& a, cudaStream_t st) {
  return launch_paged<TQ, TKV, D>(a.kmap, a.vmap, a.q, a.ks, a.vs, a.table,
                                  a.valid, a.part, a.tickets, a.out, a.B,
                                  a.Hq, a.Hkv, a.P, a.npages, a.nsplit,
                                  a.scale, st);
}

template <typename TQ, typename TKV>
cudaError_t launch_paged_d(int D, const PagedArgs& a, cudaStream_t st) {
  switch (D) {
    case 16: return launch_paged_a<TQ, TKV, 16>(a, st);
    case 32: return launch_paged_a<TQ, TKV, 32>(a, st);
    case 64: return launch_paged_a<TQ, TKV, 64>(a, st);
    case 80: return launch_paged_a<TQ, TKV, 80>(a, st);   // zamba2
    case 128: return launch_paged_a<TQ, TKV, 128>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TQ>
cudaError_t launch_paged_kv(int kv_type, int D, const PagedArgs& a,
                            cudaStream_t st) {
  switch (kv_type) {
    case 0: return launch_paged_d<TQ, float>(D, a, st);
    case 1: return launch_paged_d<TQ, __nv_bfloat16>(D, a, st);
    case 2: return launch_paged_d<TQ, int8_t>(D, a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 int8 (pools only).
// strides: (batch, seq, head) of q, k, v, o; lse: (B, Hq, Sq) float32
// written when not null
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   int dtype, int B, int Hq, int Hkv, int Sq,
                                   int Skv, int D, const int64_t* strides,
                                   int causal, float scale, void* stream) {
  FlashArgs a{q, k, v, o, static_cast<float*>(lse), nullptr, nullptr,
              nullptr, B, Hq, Hkv, Sq, Skv, strides, causal, scale};
  return launch_flash_any(0, dtype, D, a, stream);
}

// strides: (batch, seq, head) of q, k, v, do, dq; lse, delta: (B, Hq, Sq)
// float32
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int dtype, int B, int Hq,
                                      int Hkv, int Sq, int Skv, int D,
                                      const int64_t* strides, int causal,
                                      float scale, void* stream) {
  FlashArgs a{q, k, v, dout,
              const_cast<float*>(static_cast<const float*>(lse)),
              static_cast<const float*>(delta), dq, nullptr, B, Hq, Hkv, Sq,
              Skv, strides, causal, scale};
  return launch_flash_any(1, dtype, D, a, stream);
}

// strides: (batch, seq, head) of q, k, v, do, then of dk and dv (alike,
// (B, Skv, Hkv, D)); lse, delta: (B, Hq, Sq) float32
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int dtype, int B,
                                       int Hq, int Hkv, int Sq, int Skv,
                                       int D, const int64_t* strides,
                                       int causal, float scale,
                                       void* stream) {
  FlashArgs a{q, k, v, dout,
              const_cast<float*>(static_cast<const float*>(lse)),
              static_cast<const float*>(delta), dk, dv, B, Hq, Hkv, Sq, Skv,
              strides, causal, scale};
  return launch_flash_any(2, dtype, D, a, stream);
}

// One paged decode call, one launch. kmap, vmap: the pools' tensor maps
// (128 bytes each, from paged_decode_map); part: float32 scratch of
// B*Hq*nsplit*(D + 2) floats, nsplit = ceil(npages*page_size / 128);
// tickets: B*Hkv int32, zero before the first launch, and every launch
// leaves them zero; both allocated by the caller
extern "C" int paged_decode(const void* kmap, const void* vmap,
                            const void* q, const void* ks, const void* vs,
                            const void* table, const void* valid, void* part,
                            void* tickets, void* out, int q_type, int kv_type,
                            int B, int Hq, int Hkv, int D, int page_size,
                            int npages, int nsplit, float scale,
                            void* stream) {
  const PagedArgs a{kmap, vmap, q, static_cast<const float*>(ks),
                    static_cast<const float*>(vs),
                    static_cast<const int*>(table),
                    static_cast<const int*>(valid), static_cast<float*>(part),
                    static_cast<int*>(tickets), out, B, Hq, Hkv, page_size,
                    npages, nsplit, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_type == 0) return launch_paged_kv<float>(kv_type, D, a, st);
  if (q_type == 1) return launch_paged_kv<__nv_bfloat16>(kv_type, D, a, st);
  return cudaErrorInvalidValue;
}

// The tensor map of a contiguous (num_pages, page_size, Hkv, D) pool of
// kv_type (0 float32, 1 bf16, 2 int8) into map (128 bytes); the caller
// keeps it for as long as the pool lives where it is
extern "C" int paged_decode_map(void* map, const void* pool, int kv_type,
                                int num_pages, int page_size, int Hkv,
                                int D) {
  CUtensorMap m;
  cudaError_t err = cudaErrorInvalidValue;
  if (kv_type == 0)
    err = make_pool_map<float>(&m, pool, num_pages, page_size, Hkv, D);
  else if (kv_type == 1)
    err = make_pool_map<__nv_bfloat16>(&m, pool, num_pages, page_size, Hkv,
                                       D);
  else if (kv_type == 2)
    err = make_pool_map<int8_t>(&m, pool, num_pages, page_size, Hkv, D);
  if (err == cudaSuccess) memcpy(map, &m, sizeof(CUtensorMap));
  return err;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
