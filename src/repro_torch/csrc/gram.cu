// Sampled Gram matrices for a batch of draws: G[b] = Xs[b] Xs[b]^T, float32.
//
// Replaces the Pallas kernel `gram` (src/repro/kernels/gram/kernel.py:44, body
// `_gram_kernel` at :25), which the JAX package vmaps k times per CA block.
// Here the batch is an input dimension: Xs (k, d, m) -> G (k, d, d).
//
// What bounds it on an H100: the paper's shapes have a tiny d (8..54) and a
// long m (5,810..500,000), so the work is a reduction over m. The solver
// passes the augmented data [X; y] (d+1 rows), so that R comes from the same
// launch as G. G is symmetric, so the function needs k*d(d+1)*m FLOP (d here
// the rows passed). At one covtype CA block (k=32, 55 rows, m=58,101) that is
// 5.73 GFLOP (86 us at 67 TFLOP/s of non-tensor float32) against 409 MB read
// (122 us at 3.35 TB/s): bound by bytes. At one susy block (k=32, 19 rows,
// m=500,000): 6.1 GFLOP against 1.22 GB, bound by bytes (363 us). This
// kernel computes every entry of its whole tiles (64 x 64 at 55 rows, 32 x 32
// at 19), 2.7x the FLOP the function needs at covtype and 5.4x at susy: its
// own floor (227 us, 489 us) lies above the byte bound. Skipping the lower
// tiles and a tighter tile are later work. One CTA per output tile, as the
// TPU grid has it, would leave all but a few SMs idle.
//
// Design: two passes and no float atomics.
//  1. gram_partial, grid (chunks, tile pairs, k): each CTA sums one chunk of
//     the m axis into a TILE x TILE output tile held in registers (each thread
//     a TM x TM micro tile, its rows and columns strided by TILE/TM so that a
//     warp reads shared memory without bank conflicts), staging KC columns at
//     a time in shared memory, transposed, and writes the partial tile.
//  2. gram_reduce: one thread per output element sums the partials in chunk
//     order.
// The chunking is a function of m alone (the wrapper computes it), never of
// k or of the SM count, so one draw's G has the same bits whether it is
// computed alone (k=1, the classical solver) or inside a batch of k (CA).
// Ragged d and m are masked here; there is no padding pass. TILE is 32 for
// d <= 32 (susy's d=18 wastes less of each tile) and 64 above.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KC = 32;  // columns of m staged in shared memory per step

template <int TILE, int TM>
__global__ void __launch_bounds__((TILE / TM) * (TILE / TM))
gram_partial(const float* __restrict__ xs, float* __restrict__ part, int d,
             int64_t m, int64_t chunk, int nchunks, int ntiles) {
  constexpr int TPR = TILE / TM;  // threads along one edge of the tile
  constexpr int NT = TPR * TPR;
  __shared__ float sa[KC][TILE + 1];  // +1: transposed stores hit distinct banks
  __shared__ float sb[KC][TILE + 1];

  const int chunk_id = blockIdx.x;
  const int ti = blockIdx.y / ntiles, tj = blockIdx.y % ntiles;
  const int b = blockIdx.z;
  const bool diag = ti == tj;  // both operands are the same rows: stage once
  const float* x = xs + (int64_t)b * d * m;
  const int i0 = ti * TILE, j0 = tj * TILE;
  const int64_t c0 = (int64_t)chunk_id * chunk;
  const int64_t c1 = c0 + chunk < m ? c0 + chunk : m;
  const int tx = threadIdx.x % TPR, ty = threadIdx.x / TPR;

  float acc[TM][TM];
#pragma unroll
  for (int u = 0; u < TM; ++u)
#pragma unroll
    for (int v = 0; v < TM; ++v) acc[u][v] = 0.f;

  for (int64_t k0 = c0; k0 < c1; k0 += KC) {
    // consecutive threads read consecutive columns of one row: coalesced
    for (int e = threadIdx.x; e < TILE * KC; e += NT) {
      const int r = e / KC, col = e % KC;
      const int64_t gc = k0 + col;
      const bool in_m = gc < c1;
      sa[col][r] = (in_m && i0 + r < d) ? x[(int64_t)(i0 + r) * m + gc] : 0.f;
      if (!diag)
        sb[col][r] = (in_m && j0 + r < d) ? x[(int64_t)(j0 + r) * m + gc] : 0.f;
    }
    __syncthreads();
    const float(*pb)[TILE + 1] = diag ? sa : sb;
#pragma unroll 4
    for (int col = 0; col < KC; ++col) {
      float a[TM], bv[TM];
#pragma unroll
      for (int u = 0; u < TM; ++u) a[u] = sa[col][ty + u * TPR];
#pragma unroll
      for (int v = 0; v < TM; ++v) bv[v] = pb[col][tx + v * TPR];
#pragma unroll
      for (int u = 0; u < TM; ++u)
#pragma unroll
        for (int v = 0; v < TM; ++v) acc[u][v] = fmaf(a[u], bv[v], acc[u][v]);
    }
    __syncthreads();
  }

  float* p = part + ((int64_t)b * nchunks + chunk_id) * d * d;
#pragma unroll
  for (int u = 0; u < TM; ++u) {
    const int i = i0 + ty + u * TPR;
#pragma unroll
    for (int v = 0; v < TM; ++v) {
      const int j = j0 + tx + v * TPR;
      if (i < d && j < d) p[(int64_t)i * d + j] = acc[u][v];
    }
  }
}

__global__ void gram_reduce(const float* __restrict__ part,
                            float* __restrict__ g, int64_t dd, int nchunks,
                            int64_t total) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int64_t b = e / dd, o = e % dd;
  const float* p = part + b * nchunks * dd + o;
  float s = 0.f;
  for (int c = 0; c < nchunks; ++c) s += p[(int64_t)c * dd];
  g[e] = s;
}

template <int TILE, int TM>
void launch_partial(const float* xs, float* part, int64_t k, int64_t d,
                    int64_t m, int64_t chunk, int64_t nchunks,
                    cudaStream_t s) {
  const int ntiles = (int)((d + TILE - 1) / TILE);
  dim3 grid((unsigned)nchunks, (unsigned)(ntiles * ntiles), (unsigned)k);
  gram_partial<TILE, TM><<<grid, (TILE / TM) * (TILE / TM), 0, s>>>(
      xs, part, (int)d, m, chunk, (int)nchunks, ntiles);
}

}  // namespace

extern "C" {

// xs (k, d, m) contiguous; part (k, nchunks, d, d) scratch; g (k, d, d).
// chunk is a multiple of KC and nchunks = ceil(m / chunk), both from m alone.
int gram_f32(const float* xs, float* part, float* g, int64_t k, int64_t d,
             int64_t m, int64_t chunk, int64_t nchunks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 32)
    launch_partial<32, 4>(xs, part, k, d, m, chunk, nchunks, s);
  else
    launch_partial<64, 8>(xs, part, k, d, m, chunk, nchunks, s);
  const int64_t total = k * d * d;
  const int threads = 256;
  gram_reduce<<<(unsigned)((total + threads - 1) / threads), threads, 0, s>>>(
      part, g, d * d, (int)nchunks, total);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
