// Sampled Gram matrices in float32, in two forms that share one body:
//
//  gram_f32         G[b] = Xs[b] Xs[b]^T over draws already gathered, Xs
//                   (k, d, m): op `gram`, the counterpart of the Pallas
//                   kernel `gram` (src/repro/kernels/gram/kernel.py:44, body
//                   `_gram_kernel` at :25), which the JAX package vmaps k
//                   times per CA block over columns `jnp.take` gathered
//                   (src/repro/core/sampling.py:29-31).
//  gram_gather_f32  the same over the rows idx[b] of a sample-major copy of
//                   the data, read where they lie: op `gram_gather`, the
//                   Lasso solvers' block statistics. It fuses the take (which
//                   XLA fuses into the kernel's producer on the TPU) into the
//                   kernel, and scales and splits the result: G (k, r-1, r-1)
//                   and R (k, r-1), the last column, both times inv_m.
//
// What bounds it on an H100. The solver passes the augmented rows [x, y] (r =
// d+1 floats at a 16-byte pitch: 56 for covtype, 20 for susy), so R comes
// from the same sums as G. The function needs the r(r+1)/2 entries on and
// above the diagonal, each a chain of m FMAs. One covtype CA block (k=32,
// r=55, m=58,101): 5.7 GFLOP, 86 us at 67 TFLOP/s of CUDA-core float32,
// against 424 MB if every drawn row is read (127 us at 3.35 TB/s) but 138 MB
// if each distinct row is read once (a block draws a row 3.2 times on
// average, and the repeats can come from L2): operations bound it. One susy
// block (k=32, r=19, m=500,000): 6.1 GFLOP against 1.34 GB (0.49 GB
// distinct): bytes bound it, and rows of 80 bytes at random places cost
// the DRAM more than their bytes.
//
// Design: two passes and no float atomics.
//  1. gram_gather_partial, grid (chunks, block pairs, k), one to eight warps
//     a CTA: each CTA sums one chunk of the m axis for one pair of feature
//     blocks (64 features wide). At r <= 64 (both datasets) there is one
//     pair: one CTA computes the whole triangle of its chunk, and a second
//     pair would read the rows again. Each thread holds a TM x TM micro tile
//     in registers (8 x 8 above 32 features, 4 x 4 at or below); on a
//     diagonal pair only the tiles on and above the diagonal exist (28 of
//     49 at r=55), so the FMAs below it are the diagonal tiles' own lower
//     halves and no more. Shared memory gives an SM 128 bytes a clock for
//     128 FMA lanes, and a tile reads 2 TM floats a sample for TM^2 FMAs: 8
//     x 8 keeps the loads within what the FMAs leave, 4 x 4 needs twice it.
//     A grid of fewer than FEW_CTAS CTAs (the classical solvers' k=1: 114
//     or 128 CTAs, one an SM) is bound by each warp's latency instead, and
//     takes tiles half as wide (4 x 4, 2 x 2): four times the threads share
//     a chunk's FMAs.
//     A stage of KC samples lies in shared memory sample-major ([sample]
//     [feature]) in a ring of NS stages. Every thread copies: two threads a
//     sample, the even and the odd 16-byte pieces of its row (cp.async, one
//     commit group a stage), the row's index read an iteration ahead. No
//     gathered copy reaches device memory. TMA has no gather mode; an
//     earlier version, one bulk copy a row issued by one warp, moved the
//     rows more slowly at three of the four main-path shapes.
//  2. gram_partial, the pre-gathered form: the same tiles (4 x 4) over
//     stages of Xs read by plain loads, coalesced along m.
//  3. gram_reduce: one thread per entry on and above the diagonal sums its
//     partials in chunk order, scales by inv_m and writes the entry and its
//     mirror (the gather form: the last column to R).
// Each entry is one fmaf chain over its chunk's samples in order, then the
// chunks' sums in order: the order gram_f32 has always had, so gram_gather's
// G and R are bitwise gram_f32's over the gathered copy (then scaled). The
// chunking is a function of m alone (the wrapper computes it), never of k or
// of the SM count, so one draw's G has the same bits alone (k=1, the
// classical solver) or inside a batch of k (CA).
//
// The gather form does not check its indices on the card: each must lie in
// [0, n) (the solvers draw them so). Ragged r and m are masked here; the
// rows' padding columns take part in no entry that is written.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int KC = 32;          // samples a stage holds
constexpr int FEW_CTAS = 1024;  // below: the gather form's small tiles

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

__host__ __device__ inline int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// entries on and above the diagonal of an r x r matrix
__host__ __device__ inline int64_t tri_count(int r) {
  return (int64_t)r * (r + 1) / 2;
}

// packed index of entry (i, j), i <= j, of that triangle, row by row
__device__ inline int64_t tri_index(int i, int j, int r) {
  return (int64_t)i * (2 * r - i + 1) / 2 + (j - i);
}

// the t-th cell, row by row, of the upper triangle (diagonal included) of an
// n x n grid; false past its n(n+1)/2 cells
__device__ inline bool upper_cell(int t, int n, int& i, int& j) {
  int row = 0;
  while (row < n && t >= n - row) {
    t -= n - row;
    ++row;
  }
  if (row >= n) return false;
  i = row;
  j = row + t;
  return true;
}

// W consecutive floats of shared memory, one vector load
template <int W>
__device__ __forceinline__ void load_vec(const float* p, float* v);
template <>
__device__ __forceinline__ void load_vec<2>(const float* p, float* v) {
  const float2 q = *reinterpret_cast<const float2*>(p);
  v[0] = q.x;
  v[1] = q.y;
}
template <>
__device__ __forceinline__ void load_vec<4>(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory through L2 (cp.async.cg), and its
// groups: one committed a stage, waited for until N newer are pending
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A CTA's pair of feature blocks and this thread's micro tile in it.
//
// A staged sample holds block i's features, then (off the diagonal) block
// j's, each block as TM-wide tiles: float4 h of tile c sits at slot
// h * tiles + c, so the lanes of a quarter warp, which read one float4 of
// different tiles, hit different banks.
template <int TM, int BLK>
struct Pair {
  static constexpr int W = TM < 4 ? TM : 4;  // floats a vector load reads
  static constexpr int V = TM / W;           // vector loads a tile
  int bi = 0, bj = 0;  // feature blocks, bi <= bj
  bool diag;
  int qi, qj;          // float4s a row has in each block (its copy)
  int ni, nj;          // tiles along each block
  int rw;              // floats a staged sample holds
  bool active;         // this thread owns a micro tile
  int ti = 0, tj = 0;

  __device__ Pair(int pair, int r, int nb, int t) {
    upper_cell(pair, nb, bi, bj);
    diag = bi == bj;
    const int r4 = round4(r);
    qi = min(BLK, r4 - bi * BLK) / 4;
    qj = min(BLK, r4 - bj * BLK) / 4;
    ni = (4 * qi + TM - 1) / TM;
    nj = (4 * qj + TM - 1) / TM;
    rw = TM * (diag ? ni : ni + nj);
    if (diag) {
      active = upper_cell(t, ni, ti, tj);
    } else {
      active = t < ni * nj;
      ti = t / nj;
      tj = t % nj;
    }
  }
  // where float4 q of block i or of block j lies in a staged sample
  __device__ int slot_i(int q) const {
    return V == 1 ? 4 * q : 4 * ((q % V) * ni + q / V);
  }
  __device__ int slot_j(int q) const {
    return (diag ? 0 : TM * ni) + (V == 1 ? 4 * q : 4 * ((q % V) * nj + q / V));
  }

  // the micro tile's entries on and above the diagonal into one partial
  __device__ void write(const float (&acc)[TM][TM], float* out,
                        int r) const {
    const int i0 = bi * BLK + TM * ti, j0 = bj * BLK + TM * tj;
#pragma unroll
    for (int u = 0; u < TM; ++u)
#pragma unroll
      for (int v = 0; v < TM; ++v) {
        const int i = i0 + u, j = j0 + v;
        if (i <= j && j < r) out[tri_index(i, j, r)] = acc[u][v];
      }
  }

  // acc[u][v] += x_(TM ti + u) x_(TM tj + v) over the ns staged samples x,
  // in order, one fmaf each
  __device__ __forceinline__ void accumulate(const float* st, int ns,
                                             float (&acc)[TM][TM]) const {
    // the tile's first vector, and the stride between its vectors
    const int a0 = V == 1 ? TM * ti : 4 * ti;
    const int b0 = (diag ? 0 : TM * ni) + (V == 1 ? TM * tj : 4 * tj);
    const int as = 4 * ni, bs = 4 * nj;
    auto step = [&](int s) {
      const float* x = st + s * rw;
      float a[TM], b[TM];
#pragma unroll
      for (int h = 0; h < V; ++h) {
        load_vec<W>(x + a0 + h * as, a + W * h);
        load_vec<W>(x + b0 + h * bs, b + W * h);
      }
#pragma unroll
      for (int u = 0; u < TM; ++u)
#pragma unroll
        for (int v = 0; v < TM; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
    };
    if (ns == KC) {
#pragma unroll 4
      for (int s = 0; s < KC; ++s) step(s);
    } else {
      for (int s = 0; s < ns; ++s) step(s);
    }
  }
};

template <int TM, int BLK, int NS>
__global__ void __launch_bounds__(256)
gram_gather_partial(const float* __restrict__ rows,
                    const int64_t* __restrict__ idx, float* __restrict__ part,
                    int r, int r_pad, int64_t m, int64_t chunk, int nchunks,
                    int nb) {
  extern __shared__ __align__(16) float ring[];  // NS stages of KC samples
  const int t = threadIdx.x;
  const Pair<TM, BLK> p(blockIdx.y, r, nb, t);
  const int64_t c0 = (int64_t)blockIdx.x * chunk;
  const int len = (int)min64(chunk, m - c0);
  const int nst = (len + KC - 1) / KC;
  const long long* ix =
      reinterpret_cast<const long long*>(idx) + blockIdx.z * m + c0;
  const float* src_i = rows + p.bi * BLK;
  const float* src_j = rows + p.bj * BLK;
  // two threads a sample, one pass of the CTA covering blockDim.x / 2 of
  // the stage's samples: thread t copies the even or odd float4s of sample
  // t / 2 + e * half, so each pair of lanes reads whole 32-byte sectors
  const int half = blockDim.x / 2;

  // the rows (indices) of this thread's samples in stage g; -1: none
  auto rows_of = [&](int g, long long (&v)[2]) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int s = t / 2 + e * half;
      v[e] = (s < KC && g < nst && g * KC + s < len) ? __ldg(ix + g * KC + s)
                                                     : -1;
    }
  };
  auto issue = [&](int g, const long long (&v)[2]) {
    float* st = ring + (size_t)(g % NS) * KC * p.rw;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (v[e] < 0) continue;
      float* dst = st + (t / 2 + e * half) * p.rw;
      const int64_t off = v[e] * r_pad;
      for (int q = t & 1; q < p.qi; q += 2)
        copy16(dst + p.slot_i(q), src_i + off + 4 * q);
      if (!p.diag)
        for (int q = t & 1; q < p.qj; q += 2)
          copy16(dst + p.slot_j(q), src_j + off + 4 * q);
    }
    copy_commit();  // one group a stage, empty past the chunk
  };

  long long first[NS][2];
#pragma unroll
  for (int g = 0; g < NS; ++g) rows_of(g, first[g]);
#pragma unroll
  for (int g = 0; g < NS - 1; ++g) issue(g, first[g]);
  long long cur[2] = {first[NS - 1][0], first[NS - 1][1]}, next[2];

  float acc[TM][TM] = {};
  for (int g = 0; g < nst; ++g) {
    rows_of(g + NS, next);  // used an iteration later: its latency hides
    copy_wait<NS - 2>();    // this thread's copies of stage g have landed
    __syncthreads();        // everyone's, and stage g-1's slot is read
    issue(g + NS - 1, cur);
    if (p.active)
      p.accumulate(ring + (size_t)(g % NS) * KC * p.rw, min(KC, len - g * KC),
                   acc);
    cur[0] = next[0];
    cur[1] = next[1];
  }
  if (p.active)
    p.write(acc, part + ((int64_t)blockIdx.z * nchunks + blockIdx.x) *
                            tri_count(r),
            r);
}

template <int TM, int BLK>
__global__ void __launch_bounds__(256)
gram_partial(const float* __restrict__ xs, float* __restrict__ part, int d,
             int64_t m, int64_t chunk, int nchunks, int nb) {
  __shared__ __align__(16) float st[KC * 2 * BLK];
  const int t = threadIdx.x;
  const Pair<TM, BLK> p(blockIdx.y, d, nb, t);
  const float* x = xs + (int64_t)blockIdx.z * d * m;
  const int64_t c0 = (int64_t)blockIdx.x * chunk;
  const int64_t c1 = min64(c0 + chunk, m);
  const int wi = TM * p.ni;

  float acc[TM][TM] = {};
  for (int64_t k0 = c0; k0 < c1; k0 += KC) {
    const int ns = (int)min64(KC, c1 - k0);
    // consecutive threads read consecutive samples of one feature: coalesced
    for (int e = t; e < p.rw * KC; e += blockDim.x) {
      const int f = e / KC, s = e % KC;
      const bool in_i = f < wi;
      const int fl = in_i ? f : f - wi;  // feature within its block
      const int gf = (in_i ? p.bi : p.bj) * BLK + fl;
      const int at = (in_i ? p.slot_i(fl / 4) : p.slot_j(fl / 4)) + fl % 4;
      st[s * p.rw + at] =
          (s < ns && gf < d) ? x[(int64_t)gf * m + k0 + s] : 0.f;
    }
    __syncthreads();
    if (p.active) p.accumulate(st, ns, acc);
    __syncthreads();
  }
  if (p.active)
    p.write(acc, part + ((int64_t)blockIdx.z * nchunks + blockIdx.x) *
                            tri_count(d),
            d);
}

// one thread per entry (i, j), i <= j < r, of each of the k matrices: the sum
// of its partials in chunk order, times inv_m, into g (dg x dg) and its
// mirror; with dg = r - 1 the last column goes to rv (dg) instead
__global__ void gram_reduce(const float* __restrict__ part,
                            float* __restrict__ g, float* __restrict__ rv,
                            int r, int dg, int nchunks, int64_t total,
                            float inv_m) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int64_t rr = (int64_t)r * r, b = e / rr;
  const int i = (int)(e % rr / r), j = (int)(e % rr % r);
  if (i > j) return;
  const int64_t np = tri_count(r);
  const float* p = part + b * nchunks * np + tri_index(i, j, r);
  float s = 0.f;
  for (int c = 0; c < nchunks; ++c) s += p[(int64_t)c * np];
  s *= inv_m;
  if (j < dg) {
    g[(b * dg + i) * dg + j] = s;
    g[(b * dg + j) * dg + i] = s;
  } else if (i < dg) {
    rv[b * dg + i] = s;
  }
}

// a CTA's threads: one a micro tile of the largest pair, whole warps
template <int TM, int BLK>
int threads_for(int r, int nb) {
  if (nb > 1) return (BLK / TM) * (BLK / TM);
  const int n = (round4(r) + TM - 1) / TM, tiles = n * (n + 1) / 2;
  return (tiles + 31) / 32 * 32;
}

template <int TM, int BLK, int NS>
void launch_gather(const float* rows, const int64_t* idx, float* part,
                   int64_t k, int r, int r_pad, int64_t m, int64_t chunk,
                   int64_t nchunks, cudaStream_t s) {
  const int nb = (round4(r) + BLK - 1) / BLK;
  const int rw_max = nb == 1 ? (round4(r) + TM - 1) / TM * TM : 2 * BLK;
  const size_t smem = (size_t)NS * KC * rw_max * sizeof(float);
  dim3 grid((unsigned)nchunks, (unsigned)(nb * (nb + 1) / 2), (unsigned)k);
  gram_gather_partial<TM, BLK, NS><<<grid, threads_for<TM, BLK>(r, nb), smem,
                                     s>>>(rows, idx, part, r, r_pad, m, chunk,
                                          (int)nchunks, nb);
}

template <int TM, int BLK>
void launch_partial(const float* xs, float* part, int64_t k, int d,
                    int64_t m, int64_t chunk, int64_t nchunks,
                    cudaStream_t s) {
  const int nb = (round4(d) + BLK - 1) / BLK;
  dim3 grid((unsigned)nchunks, (unsigned)(nb * (nb + 1) / 2), (unsigned)k);
  // every thread stages, the tiles' owners multiply
  const int threads = std::max(128, threads_for<TM, BLK>(d, nb));
  gram_partial<TM, BLK><<<grid, threads, 0, s>>>(xs, part, d, m, chunk,
                                                 (int)nchunks, nb);
}

void launch_reduce(const float* part, float* g, float* rv, int64_t k, int r,
                   int dg, int64_t nchunks, float inv_m, cudaStream_t s) {
  const int64_t total = k * r * r;
  const int threads = 256;
  gram_reduce<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                s>>>(part, g, rv, r, dg, (int)nchunks, total, inv_m);
}

}  // namespace

extern "C" {

// xs (k, d, m) contiguous; part (k, nchunks, d(d+1)/2) scratch; g (k, d, d).
// chunk is a multiple of KC and nchunks = ceil(m / chunk), both from m alone.
int gram_f32(const float* xs, float* part, float* g, int64_t k, int64_t d,
             int64_t m, int64_t chunk, int64_t nchunks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 32)
    launch_partial<4, 32>(xs, part, k, (int)d, m, chunk, nchunks, s);
  else
    launch_partial<4, 64>(xs, part, k, (int)d, m, chunk, nchunks, s);
  launch_reduce(part, g, nullptr, k, (int)d, (int)d, nchunks, 1.f, s);
  return (int)cudaGetLastError();
}

// rows (n, r_pad) contiguous, 16-byte aligned, r <= r_pad, r_pad % 4 == 0;
// idx (k, m) int64 contiguous, each in [0, n); part (k, nchunks, r(r+1)/2)
// scratch; g (k, r-1, r-1) and rv (k, r-1), both times inv_m. chunk and
// nchunks as for gram_f32.
int gram_gather_f32(const float* rows, const int64_t* idx, float* part,
                    float* g, float* rv, int64_t k, int64_t r, int64_t r_pad,
                    int64_t m, int64_t chunk, int64_t nchunks, float inv_m,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // a grid of a few CTAs an SM (the classical solvers' k=1) spreads each
  // chunk's FMAs over more warps with smaller tiles; the order of each
  // entry's sum is the same either way
  const bool few = k * nchunks < FEW_CTAS;
  if (r <= 32 && few)
    launch_gather<2, 32, 8>(rows, idx, part, k, (int)r, (int)r_pad, m, chunk,
                            nchunks, s);
  else if (r <= 32)
    launch_gather<4, 32, 8>(rows, idx, part, k, (int)r, (int)r_pad, m, chunk,
                            nchunks, s);
  else if (few)
    launch_gather<4, 64, 3>(rows, idx, part, k, (int)r, (int)r_pad, m, chunk,
                            nchunks, s);
  else
    launch_gather<8, 64, 3>(rows, idx, part, k, (int)r, (int)r_pad, m, chunk,
                            nchunks, s);
  launch_reduce(part, g, rv, k, (int)r, (int)r - 1, nchunks, inv_m, s);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
