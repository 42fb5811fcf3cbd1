// K2: fused Hamming distance + top-2 over one or a batch of descriptor
// databases, on the int8 tensor cores.
//
// For each database b of a batch of B, each query row i of a (N, 256) int8
// +-1 matrix, against the valid rows j of a (M, 256) int8 +-1 database:
//   dist(i, j)  = (256 - dot(a_i, b_j)) / 2      (exact integer arithmetic)
//   d1[b, i]    = min over valid j of dist(i, j)     (1 << 20 when none is valid)
//   idx[b, i]   = the lowest j attaining d1[b, i]    (0 when none is valid)
//   d2[b, i]    = min over valid j != idx[b, i]      (1 << 20 when none is left)
// so a duplicate of the minimum gives d2 == d1. N, M and B are arbitrary
// (M <= 2^22); entries are +-1, or 0 on both sides of a padding row, so
// every dot is even.
//
// Replaces the TPU kernel `monocular_slam_tpu/ops/pallas/hamming.py:
// hamming_top2`, which streams 128x128 (query, database) tiles through VMEM,
// feeds the MXU with the +-1 int8 matmul and merges each tile's top-2 into a
// running top-2 kept in VMEM scratch, so only O(N) results leave the chip
// instead of the (N, M) distance table.
//
// Design. Grid = (query tiles of 64 rows, B, S database splits); a block is
// one warpgroup (4 warps) and owns 64 query rows, warp w rows [16w, 16w+16).
// Each warp keeps its rows' A fragments for all 8 k-steps in registers (32
// regs, the m16n8k32 layout that wgmma takes for a register A) and the
// block meets every column of every database tile of its split:
//   - tiles of 128 database rows (32 KB) stream through a double-buffered
//     shared-memory ring by 16-byte cp.async, stored as two K-major slabs
//     of 128-byte rows (bytes 0-127 and 128-255 of each descriptor) in the
//     128-byte swizzle (chunk c of row r at c ^ (r & 7)); rows past M are
//     zero-filled. Beside each tile, 128 per-row key bases (the row index,
//     or "invalid");
//   - the product is wgmma.mma_async m64n128k32 with s8 operands and s32
//     accumulators: 8 k-steps, B read by the tensor cores from the swizzled
//     slabs through a shared-memory descriptor (start + 32 B per k-step
//     within a slab, 1024 B between 8-row groups); |dot| <= 256, so it is
//     exact. s8 wgmma takes K-major operands only, which rows of 256
//     contiguous bytes already are;
//   - the epilogue folds every (dist, column) into a 32-bit key,
//     key = dist << 22 | column for a valid row (one IMAD from the row's
//     base: (256 - dot) << 21 + column), and >= 2^31 for an invalid one, so
//     "smaller distance, then lower index" is one unsigned compare, and
//     keeps the two smallest keys of each of the thread's 2 query rows with
//     min/max only: k2 = min(k2, max(k1, key)); k1 = min(k1, key). The
//     accumulator layout puts each query row on the 4 lanes of a quad;
//   - the 4 lanes of a quad merge with shuffles; the warpgroup covers
//     whole tiles and each warp its own rows, so no cross-warp merge;
//   - with S > 1 each block writes its partial top-2 keys to scratch and
//     takes a ticket on its (query tile, database); the last of the S
//     blocks to arrive merges the S partials and writes the outputs, and
//     resets the ticket to 0 for the next launch. The merge rule
//     (n1 = min(a1, b1), n2 = min(max(a1, b1), min(a2, b2))) is exact on
//     unique keys and independent of order, so the result is deterministic.
// S is chosen by the caller so that the grid fills at most one wave of 3
// blocks per SM (66.5 KB of shared memory and 128 threads each): 1000 x
// 1000 and the tracker's 5-database window fill the card, and a map-scale
// query set has no tail wave (a partial second wave cost more on the card
// than the work it added, and a third stage less than a third block per SM).
//
// Loads are cp.async, not TMA: the database pointer changes with every
// call (the tracker gathers its window anew each frame), so TMA would need a
// tensor map encoded on the host per call (cuTensorMapEncodeTiled), to save
// ~16 copy instructions per thread per tile against ~300 epilogue
// instructions. The epilogue is what bounds the kernel now: 4 integer ops
// per (query, row) pair, 0.52 G at 2000 x 65536, ~35 us at the SMs' integer
// rate (132 SMs x 64 per clock), as much as the product's 34 us at the int8
// tensor-core peak, and within a block it does not overlap the next tile's
// wgmma. Overlapping them (a second accumulator set, or two warpgroups in
// ping-pong) is what is left on the table.
//
// What bounds it on an H100: 2 x N x M x 256 int8 operations against
// N x 256 + M x 257 + 12 N bytes, so operations: 1000 x 1000 is 0.26 us at
// 1979 TOP/s, below one launch's latency.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 256;                   // descriptor length (int8 entries)
constexpr int BQ = 64;                   // query rows per block
constexpr int WARPS = BQ / 16;           // warp w owns query rows [16w, 16w + 16)
constexpr int NT = 32 * WARPS;
constexpr int BD = 128;                  // database rows per tile
constexpr int STAGES = 2;                // shared-memory ring depth (double buffer)
constexpr int CHUNKS = D / 16;           // 16-byte chunks per row
constexpr int KSTEPS = D / 32;           // wgmma k-steps of 32 bytes
constexpr int NTILES = BD / 8;           // n8 column groups of the accumulator
constexpr int TILE_BYTES = BD * D;
constexpr int SMEM_BYTES = STAGES * (TILE_BYTES + BD * 4);
constexpr int IDX_BITS = 22;
constexpr uint32_t IDX_MASK = (1u << IDX_BITS) - 1;
constexpr uint32_t KEY_NONE = 0xFFFFFFFFu;
constexpr uint32_t KEY_VALID_END = 0x80000000u;  // every valid key is below
constexpr uint32_t BASE_VALID = 256u << (IDX_BITS - 1);  // + row
constexpr uint32_t BASE_INVALID = 0xC0000000u;  // - dot << 21 stays in [2^31, 2^32)
constexpr int BIG = 1 << 20;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte copy; src_bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// B operand descriptor of a K-major tile of 128-byte rows in the 128-byte
// swizzle: start address, LBO unused (1), SBO = 1024 B between 8-row groups
__device__ __forceinline__ uint64_t b_desc(const void* p) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (uint64_t(1024 >> 4) << 32) | (1ull << 62);
}

// d (+)= a * b over one k32 step: 64 query rows x 128 database rows, A from
// registers (the m16n8k32 fragment of each warp's 16 rows), B from shared
__device__ __forceinline__ void wgmma_s8(int (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// fold `key` into the running two smallest keys k1 <= k2
__device__ __forceinline__ void insert(uint32_t& k1, uint32_t& k2, uint32_t key) {
  k2 = min(k2, max(k1, key));
  k1 = min(k1, key);
}

// merge the top-2 (c1, c2) into (k1, k2)
__device__ __forceinline__ void merge(uint32_t& k1, uint32_t& k2, uint32_t c1, uint32_t c2) {
  k2 = min(min(k2, c2), max(k1, c1));
  k1 = min(k1, c1);
}

__device__ __forceinline__ void quad_merge(uint32_t& k1, uint32_t& k2) {
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1)
    merge(k1, k2, __shfl_xor_sync(0xFFFFFFFFu, k1, off), __shfl_xor_sync(0xFFFFFFFFu, k2, off));
}

__device__ __forceinline__ void write_out(int* d1, int* d2, int* idx, size_t o, uint32_t k1,
                                          uint32_t k2) {
  const bool v1 = k1 < KEY_VALID_END;
  d1[o] = v1 ? static_cast<int>(k1 >> IDX_BITS) : BIG;
  idx[o] = v1 ? static_cast<int>(k1 & IDX_MASK) : 0;
  d2[o] = k2 < KEY_VALID_END ? static_cast<int>(k2 >> IDX_BITS) : BIG;
}

__device__ __forceinline__ uint32_t ld_a32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One more launch on `*launches` (the port's launch counter): the first
// thread of the first block adds one, so a replayed CUDA graph counts too.
__device__ __forceinline__ void count_launch(unsigned long long* launches) {
  if (launches != nullptr && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&
      threadIdx.x == 0 && threadIdx.y == 0 && threadIdx.z == 0)
    atomicAdd(launches, 1ULL);
}

__global__ void __launch_bounds__(NT)
hamming_top2_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                    const uint8_t* __restrict__ b_valid, int N, int M,
                    int* __restrict__ d1_out, int* __restrict__ d2_out,
                    int* __restrict__ idx_out, uint2* __restrict__ part,
                    unsigned* __restrict__ tickets, unsigned long long* launches) {
  count_launch(launches);
  extern __shared__ __align__(1024) uint8_t smem[];
  uint32_t* bases = reinterpret_cast<uint32_t*>(smem + STAGES * TILE_BYTES);
  __shared__ unsigned s_ticket;

  const int qt = blockIdx.x, batch = blockIdx.y, split = blockIdx.z;
  const int B = gridDim.y, S = gridDim.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q4 = lane & 3;
  const int r0 = qt * BQ + warp * 16 + g, r1 = r0 + 8;
  const int8_t* bb = b + (size_t)batch * M * D;
  const uint8_t* bv = b_valid + (size_t)batch * M;

  // A fragments of rows r0 and r1 for all k-steps (rows past N repeat N - 1)
  uint32_t af[KSTEPS][4];
  {
    const int8_t* a0 = a + (size_t)min(r0, N - 1) * D + q4 * 4;
    const int8_t* a1 = a + (size_t)min(r1, N - 1) * D + q4 * 4;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      af[kk][0] = ld_a32(a0 + kk * 32);
      af[kk][1] = ld_a32(a1 + kk * 32);
      af[kk][2] = ld_a32(a0 + kk * 32 + 16);
      af[kk][3] = ld_a32(a1 + kk * 32 + 16);
    }
  }

  // this split's database tiles [t_begin, t_end)
  const int n_tiles = (M + BD - 1) / BD;
  const int t_begin = (int)((long long)n_tiles * split / S);
  const int t_end = (int)((long long)n_tiles * (split + 1) / S);

  auto load_tile = [&](int t) {
    const int stage = (t - t_begin) % STAGES;
    const int row0 = t * BD;
    uint8_t* sb = smem + stage * TILE_BYTES;
    for (int i = threadIdx.x; i < BD * CHUNKS; i += NT) {
      const int r = i / CHUNKS, c = i % CHUNKS;
      const bool in = row0 + r < M;
      cp_async16(sb + (c >> 3) * (BD * 128) + r * 128 + (((c & 7) ^ (r & 7)) * 16),
                 bb + (size_t)(in ? row0 + r : 0) * D + c * 16, in ? 16 : 0);
    }
    for (int r = threadIdx.x; r < BD; r += NT) {
      const int row = row0 + r;
      bases[stage * BD + r] = (row < M && bv[row]) ? BASE_VALID + row : BASE_INVALID;
    }
  };

  uint32_t k1a = KEY_NONE, k2a = KEY_NONE, k1b = KEY_NONE, k2b = KEY_NONE;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (t_begin + s < t_end) load_tile(t_begin + s);
    cp_async_commit();
  }
  for (int t = t_begin; t < t_end; ++t) {
    cp_async_wait<STAGES - 2>();
    // this thread's copies of tile t are visible to the tensor cores' reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if (t + STAGES - 1 < t_end) load_tile(t + STAGES - 1);
    cp_async_commit();

    const int stage = (t - t_begin) % STAGES;
    const uint8_t* sb = smem + stage * TILE_BYTES;
    int acc[NTILES * 4];
#pragma unroll
    for (int i = 0; i < NTILES * 4; ++i) acc[i] = 0;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      wgmma_s8(acc, af[kk], b_desc(sb + (kk >> 2) * (BD * 128) + (kk & 3) * 32), kk > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    const uint32_t* base = bases + stage * BD + q4 * 2;
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
      const uint2 bs = *reinterpret_cast<const uint2*>(base + nt * 8);
      insert(k1a, k2a, bs.x - (static_cast<uint32_t>(acc[nt * 4 + 0]) << (IDX_BITS - 1)));
      insert(k1a, k2a, bs.y - (static_cast<uint32_t>(acc[nt * 4 + 1]) << (IDX_BITS - 1)));
      insert(k1b, k2b, bs.x - (static_cast<uint32_t>(acc[nt * 4 + 2]) << (IDX_BITS - 1)));
      insert(k1b, k2b, bs.y - (static_cast<uint32_t>(acc[nt * 4 + 3]) << (IDX_BITS - 1)));
    }
  }
  cp_async_wait<0>();
  quad_merge(k1a, k2a);
  quad_merge(k1b, k2b);

  const size_t out0 = (size_t)batch * N;
  if (S == 1) {
    if (q4 == 0 && r0 < N) write_out(d1_out, d2_out, idx_out, out0 + r0, k1a, k2a);
    if (q4 == 0 && r1 < N) write_out(d1_out, d2_out, idx_out, out0 + r1, k1b, k2b);
    return;
  }
  const size_t pbase = ((size_t)split * B + batch) * N;
  if (q4 == 0 && r0 < N) part[pbase + r0] = make_uint2(k1a, k2a);
  if (q4 == 0 && r1 < N) part[pbase + r1] = make_uint2(k1b, k2b);
  __threadfence();
  __syncthreads();
  unsigned* ticket = tickets + (size_t)batch * gridDim.x + qt;
  if (threadIdx.x == 0) s_ticket = atomicAdd(ticket, 1u);
  __syncthreads();
  if (s_ticket != (unsigned)(S - 1)) return;
  // the last block of this (query tile, database): merge the S partials
  __threadfence();
  for (int r = threadIdx.x; r < BQ; r += NT) {
    const int row = qt * BQ + r;
    if (row >= N) break;
    uint32_t k1 = KEY_NONE, k2 = KEY_NONE;
    for (int s = 0; s < S; ++s) {
      const uint2 p = __ldcg(part + ((size_t)s * B + batch) * N + row);
      merge(k1, k2, p.x, p.y);
    }
    write_out(d1_out, d2_out, idx_out, out0 + row, k1, k2);
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

}  // namespace

// Launches K2 on `stream`; returns cudaGetLastError() (0 on success).
// a: (N, 256) int8; b: (B, M, 256) int8; b_valid: (B, M) bool as bytes;
// rows 16-byte aligned; d1, d2, idx: (B, N) int32. N >= 1, M >= 0, B >= 1,
// 1 <= S <= max(1, ceil(M / 128)). With S > 1: part holds S x B x N uint2
// and tickets B x ceil(N / 64) zeros, which the launch leaves at zero. The
// launch adds one to the 64-bit counter at `launches` (none if null).
extern "C" int hamming_top2(const void* a, const void* b, const void* b_valid, int N, int M,
                            int B, int S, void* d1, void* d2, void* idx, void* part,
                            void* tickets, void* launches, void* stream) {
  static int configured_device = -1;
  int dev = 0;
  cudaGetDevice(&dev);
  if (configured_device != dev) {
    const cudaError_t e = cudaFuncSetAttribute(
        hamming_top2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured_device = dev;
  }
  const dim3 grid((N + BQ - 1) / BQ, B, S);
  hamming_top2_kernel<<<grid, NT, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<const uint8_t*>(b_valid), N, M, static_cast<int*>(d1),
      static_cast<int*>(d2), static_cast<int*>(idx), static_cast<uint2*>(part),
      static_cast<unsigned*>(tickets), static_cast<unsigned long long*>(launches));
  return static_cast<int>(cudaGetLastError());
}
