// K2: fused Hamming distance + running top-2 over a descriptor database.
//
// For each query row i of a (N, 256) int8 +-1 matrix, against the valid rows
// j of a (M, 256) int8 +-1 database:
//   dist(i, j) = (256 - dot(a_i, b_j)) >> 1     (integer accumulation)
//   d1[i]  = min over valid j of dist(i, j)      (1 << 20 when none is valid)
//   idx[i] = the lowest j attaining d1[i]        (0 when none is valid)
//   d2[i]  = min over valid j != idx[i]          (1 << 20 when none is left)
// so a duplicate of the minimum gives d2 == d1. N and M are arbitrary.
//
// Replaces the TPU kernel `monocular_slam_tpu/ops/pallas/hamming.py:
// hamming_top2`, which streams 128x128 (query, database) tiles through VMEM,
// feeds the MXU with the +-1 int8 matmul and merges each tile's top-2 into a
// running top-2 kept in VMEM scratch, so only O(N) results leave the chip
// instead of the (N, M) distance table.
//
// Here a block of 8 warps owns 32 query rows, one per lane; every warp keeps
// its lane's query row in 64 registers (packed int8x4) and the block streams
// the database through shared memory in tiles of 128 rows. Warp w scans rows
// [16w, 16w + 16) of each tile: all lanes read the same shared row (a
// broadcast, no bank conflict), take the exact dot with 64 __dp4a, and update
// a running (best1, best2, argbest) in registers with a strict `<`, so within
// a warp the lowest index wins a tie (rows arrive in increasing order). At the
// end the 8 partial top-2s of each query are merged through shared memory
// with the rule of the Pallas kernel's tile merge plus "lowest index among
// equal minima", which keeps the result independent of the merge order.
//
// What bounds it on an H100: per (query, row) pair 64 dp4a plus a few
// compares; 2000 x 65536 pairs are 8.4 G dp4a, a fraction of a millisecond
// at the SM's integer rate, while the bytes (each input read once, three
// int32 outputs written once) are ~17 MB, a few microseconds of HBM time.
// So it is bound by operations, and by parallelism at small N: one block per
// 32 queries fills only ceil(N / 32) of the 132 SMs (32 at N = 1000). Tensor
// core int8 mma, TMA and a split of the database across blocks are the
// later redesign.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 256;                  // descriptor length (int8 entries)
constexpr int VEC = D / 16;             // int4 vectors per row
constexpr int QPB = 32;                 // query rows per block (lane = query)
constexpr int WARPS = 8;
constexpr int NT = QPB * WARPS;
constexpr int TILE = 128;               // database rows per shared tile
constexpr int ROWS_PER_WARP = TILE / WARPS;
constexpr int BIG = 1 << 20;

__device__ __forceinline__ int dot4(const int4& a, const int4& b, int acc) {
  acc = __dp4a(a.x, b.x, acc);
  acc = __dp4a(a.y, b.y, acc);
  acc = __dp4a(a.z, b.z, acc);
  return __dp4a(a.w, b.w, acc);
}

// merge the top-2 (c1, c2, ci) into (b1, b2, bi)
__device__ __forceinline__ void merge(int& b1, int& b2, int& bi, int c1, int c2, int ci) {
  const int n2 = min(max(b1, c1), min(b2, c2));
  if (c1 < b1 || (c1 == b1 && ci < bi)) bi = ci;
  b1 = min(b1, c1);
  b2 = n2;
}

__global__ void __launch_bounds__(NT)
hamming_top2_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                    const uint8_t* __restrict__ b_valid, int N, int M,
                    int* __restrict__ d1_out, int* __restrict__ d2_out,
                    int* __restrict__ idx_out) {
  __shared__ int4 tile[TILE][VEC];
  __shared__ int valid[TILE];
  __shared__ int m1[WARPS][QPB], m2[WARPS][QPB], mi[WARPS][QPB];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q = blockIdx.x * QPB + lane;

  int4 qa[VEC];
  const int4* arow = reinterpret_cast<const int4*>(a + (size_t)min(q, N - 1) * D);
#pragma unroll
  for (int v = 0; v < VEC; ++v) qa[v] = arow[v];

  int best1 = BIG, best2 = BIG, bidx = 0;
  const int4* b4 = reinterpret_cast<const int4*>(b);
  for (int t0 = 0; t0 < M; t0 += TILE) {
    const int rows = min(TILE, M - t0);
    __syncthreads();  // every warp is done with the previous tile
    for (int i = threadIdx.x; i < rows * VEC; i += NT)
      tile[i / VEC][i % VEC] = b4[(size_t)t0 * VEC + i];
    for (int i = threadIdx.x; i < rows; i += NT) valid[i] = b_valid[t0 + i];
    __syncthreads();
    const int r1 = min(warp * ROWS_PER_WARP + ROWS_PER_WARP, rows);
    for (int r = warp * ROWS_PER_WARP; r < r1; ++r) {
      int dot = 0;
#pragma unroll
      for (int v = 0; v < VEC; ++v) dot = dot4(qa[v], tile[r][v], dot);
      const int d = valid[r] ? ((D - dot) >> 1) : BIG;
      if (d < best1) {
        best2 = best1;
        best1 = d;
        bidx = t0 + r;
      } else if (d < best2) {
        best2 = d;
      }
    }
  }
  m1[warp][lane] = best1;
  m2[warp][lane] = best2;
  mi[warp][lane] = bidx;
  __syncthreads();
  if (warp == 0 && q < N) {
#pragma unroll
    for (int w = 1; w < WARPS; ++w) merge(best1, best2, bidx, m1[w][lane], m2[w][lane], mi[w][lane]);
    d1_out[q] = best1;
    d2_out[q] = best2;
    idx_out[q] = bidx;
  }
}

}  // namespace

// Launches K2 on `stream`; returns cudaGetLastError() (0 on success).
// a: (N, 256) int8, b: (M, 256) int8, b_valid: (M,) bool as bytes, rows
// 16-byte aligned; d1, d2, idx: (N,) int32. N >= 1, M >= 0.
extern "C" int hamming_top2(const void* a, const void* b, const void* b_valid,
                            int N, int M, void* d1, void* d2, void* idx, void* stream) {
  const dim3 grid((N + QPB - 1) / QPB);
  hamming_top2_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<const uint8_t*>(b_valid), N, M, static_cast<int*>(d1),
      static_cast<int*>(d2), static_cast<int*>(idx));
  return static_cast<int>(cudaGetLastError());
}
