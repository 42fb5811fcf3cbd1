// K1: FAST-9 corner maps of every pyramid level of a frame in one launch —
// per level, the raw score map and the thresholded, border-masked,
// 3x3-non-max-suppressed score map of that level's (H, W) float32 image
// in [0, 255].
//
// Replaces the TPU kernel `monocular_slam_tpu/ops/pallas/fast_score.py:
// corner_maps`, which streams row slabs with a 4-row halo through VMEM and
// forms the 16 ring differences with whole-slab rolls, one call per level.
//
// One launch covers every 32x32 output tile of every level (at most 8).
// The levels travel by value in a small table (pointers, H, W, and the
// first tile index of each level); a block finds its level from the tile
// prefix with static indices only, so the table stays in the parameter
// bank. A 32x8 thread block owns one 32x32 output tile, 4 rows a thread:
//   1. it stages the tile plus a 4-pixel halo (3 for the Bresenham ring,
//      1 for the NMS window), 40x40 pixels, 1.56x the output, in shared
//      memory with cp.async: 16-byte copies where the 4 pixels lie in the
//      level and the global address is 16-byte aligned, else 4-byte copies
//      with zero fill. Level widths 533, 444, 309, 257 and 179 are not
//      multiples of 4 floats, so most rows of those levels are misaligned;
//      TMA would need a pitched copy of the pyramid, which
//      `ops/pyramid.py` does not make, so the staging is cp.async. Pixels outside
//      the level read as 0, as the Pallas kernel's zero padding does — each
//      level pads at its own edge, never with a neighbour level's pixels;
//   2. it computes the score on the tile plus a 1-pixel ring (34x34, 1.13x
//      the output) into shared memory: 16 ring differences in registers,
//      the circular min over 9 contiguous entries by the log-step doubling
//      of `ops/fast.py:_circular_min9` (windows 2, 4, 8, then 9), max over
//      the 16 arcs, both signs; thresholded (> t) and zeroed within
//      BORDER = 3 pixels of the level's edge;
//   3. after a barrier, the 3x3 NMS (score >= all 8 neighbours) from shared
//      memory; each output map is written once, coalesced along rows.
// Only min/max and one subtraction per ring sample touch the values, so on
// each level's interior (>= 3 pixels from its edge) both maps equal the
// plain torch version bit for bit. On the 3-pixel border ring the raw map
// differs (zero padding vs the plain version's wrap-around) and the NMS map
// is 0 in both.
//
// What bounds it on an H100: 4 B read and 8 B written per pixel, about
// 11.4 MB per 640x480 frame's 8 levels (0.95 Mpx), ~3.4 us of HBM time,
// against ~160 float32 min/max/sub per pixel, ~2.3 us at 67 TFLOP/s. The
// earlier design (one launch per level, a 32x8 tile with a 2.5x halo) was
// bound by its 8 launches; one launch a frame leaves one launch latency.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int K1_MAX_LEVELS = 8;

// The per-frame level table. The caller fills img/nms/raw, H, W and
// n_levels; `fast_corner_maps_levels` fills tiles_x and tile0.
struct K1LevelTable {
  const float* img[K1_MAX_LEVELS];
  float* nms[K1_MAX_LEVELS];
  float* raw[K1_MAX_LEVELS];
  int H[K1_MAX_LEVELS];
  int W[K1_MAX_LEVELS];
  int tiles_x[K1_MAX_LEVELS];
  int tile0[K1_MAX_LEVELS + 1];  // first tile of each level; tile0[n_levels] = all tiles
  int n_levels;
};

namespace {

constexpr int TW = 32;           // output tile width  = blockDim.x
constexpr int TH = 32;           // output tile height
constexpr int BY = 8;            // blockDim.y
constexpr int RPT = TH / BY;     // output rows per thread
constexpr int HALO = 4;          // 3 ring + 1 NMS
constexpr int SW = TW + 2 * HALO;
constexpr int SH = TH + 2 * HALO;
constexpr int CW = TW + 2;       // score tile: output tile + 1-pixel ring
constexpr int CH = TH + 2;
constexpr int BORDER = 3;
constexpr int NT = TW * BY;
constexpr int CHUNKS = SW / 4;   // 16-byte chunks per staged row
static_assert(SW % 4 == 0 && TW % 4 == 0 && HALO % 4 == 0, "16-byte staging alignment");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// 4-byte copy; src_bytes = 0 writes a zero and reads nothing
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ float max_arc_min9(const float (&d)[16]) {
  float m2[16], m4[16], m8[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) m2[i] = fminf(d[i], d[(i + 1) & 15]);
#pragma unroll
  for (int i = 0; i < 16; ++i) m4[i] = fminf(m2[i], m2[(i + 2) & 15]);
#pragma unroll
  for (int i = 0; i < 16; ++i) m8[i] = fminf(m4[i], m4[(i + 4) & 15]);
  float best = fminf(m8[0], d[8]);
#pragma unroll
  for (int i = 1; i < 16; ++i) best = fmaxf(best, fminf(m8[i], d[(i + 8) & 15]));
  return best;
}

// raw FAST-9 score of the pixel at tile position (sy, sx)
__device__ __forceinline__ float raw_score(float (*tile)[SW], int sy, int sx) {
  // 16-point Bresenham circle of radius 3, clockwise from 12 o'clock
  constexpr int DY[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  constexpr int DX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const float c = tile[sy][sx];
  float d[16], nd[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    d[i] = tile[sy + DY[i]][sx + DX[i]] - c;
    nd[i] = -d[i];
  }
  return fmaxf(max_arc_min9(d), max_arc_min9(nd));
}

// One more launch on `*launches` (the port's launch counter): the first
// thread of the first block adds one, so a replayed CUDA graph counts too.
__device__ __forceinline__ void count_launch(unsigned long long* launches) {
  if (launches != nullptr && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&
      threadIdx.x == 0 && threadIdx.y == 0 && threadIdx.z == 0)
    atomicAdd(launches, 1ULL);
}

__global__ void __launch_bounds__(NT)
corner_maps_levels_kernel(const K1LevelTable T, float threshold,
                          unsigned long long* launches) {
  count_launch(launches);
  __shared__ __align__(16) float tile[SH][SW];
  __shared__ float score[CH][CW];
  const int t = blockIdx.x;

  // this block's level: static indices only, so T stays in the param bank
  const float* img = T.img[0];
  float* nms = T.nms[0];
  float* raw = T.raw[0];
  int H = T.H[0], W = T.W[0], tiles_x = T.tiles_x[0], first = 0;
#pragma unroll
  for (int l = 1; l < K1_MAX_LEVELS; ++l) {
    if (l < T.n_levels && t >= T.tile0[l]) {
      img = T.img[l];
      nms = T.nms[l];
      raw = T.raw[l];
      H = T.H[l];
      W = T.W[l];
      tiles_x = T.tiles_x[l];
      first = T.tile0[l];
    }
  }
  const int local = t - first;
  const int x0 = (local % tiles_x) * TW;
  const int y0 = (local / tiles_x) * TH;
  const int tid = threadIdx.y * TW + threadIdx.x;

  // 1. stage the 40x40 window; gx of every chunk is a multiple of 4
  for (int i = tid; i < SH * CHUNKS; i += NT) {
    const int sy = i / CHUNKS, c = i % CHUNKS;
    const int gy = y0 - HALO + sy, gx = x0 - HALO + 4 * c;
    float* dst = &tile[sy][4 * c];
    const bool row_in = gy >= 0 && gy < H;
    const float* src = img + (size_t)(row_in ? gy : 0) * W;
    if (row_in && gx >= 0 && gx + 3 < W &&
        (reinterpret_cast<uintptr_t>(src + gx) & 15) == 0) {
      cp_async16(dst, src + gx);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = row_in && gx + e >= 0 && gx + e < W;
        cp_async4(dst + e, in ? src + gx + e : img, in ? 4 : 0);
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 2. thresholded, border-masked score on the 34x34 window; raw map out
  for (int i = tid; i < CH * CW; i += NT) {
    const int cy = i / CW, cx = i % CW;
    const int gy = y0 - 1 + cy, gx = x0 - 1 + cx;
    const float r = raw_score(tile, cy + HALO - 1, cx + HALO - 1);
    const bool interior = gy >= BORDER && gy < H - BORDER &&
                          gx >= BORDER && gx < W - BORDER;
    score[cy][cx] = (interior && r > threshold) ? r : 0.0f;
    if (cy >= 1 && cy <= TH && cx >= 1 && cx <= TW && gy < H && gx < W)
      raw[(size_t)gy * W + gx] = r;
  }
  __syncthreads();

  // 3. 3x3 NMS, RPT rows a thread
  const int gx = x0 + threadIdx.x, cx = threadIdx.x + 1;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int cy = threadIdx.y + BY * r + 1;
    const int gy = y0 + cy - 1;
    if (gy < H && gx < W) {
      const float s = score[cy][cx];
      float mx = s;
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) mx = fmaxf(mx, score[cy + dy][cx + dx]);
      nms[(size_t)gy * W + gx] = (s >= mx) ? s : 0.0f;
    }
  }
}

}  // namespace

// Launches K1 over every level of `*table` on `stream`; returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a table
// of 0 or more than 8 levels or an empty level. The launch adds one to the
// 64-bit counter at `launches` (none if null).
extern "C" int fast_corner_maps_levels(const K1LevelTable* table, float threshold,
                                       void* launches, void* stream) {
  K1LevelTable T = *table;
  if (T.n_levels < 1 || T.n_levels > K1_MAX_LEVELS)
    return static_cast<int>(cudaErrorInvalidValue);
  int tiles = 0;
  for (int l = 0; l < K1_MAX_LEVELS; ++l) {
    if (l < T.n_levels) {
      if (T.H[l] < 1 || T.W[l] < 1) return static_cast<int>(cudaErrorInvalidValue);
      T.tiles_x[l] = (T.W[l] + TW - 1) / TW;
      T.tile0[l] = tiles;
      tiles += T.tiles_x[l] * ((T.H[l] + TH - 1) / TH);
    } else {
      T.tiles_x[l] = 1;
      T.tile0[l] = tiles;
    }
  }
  T.tile0[K1_MAX_LEVELS] = tiles;
  corner_maps_levels_kernel<<<tiles, dim3(TW, BY), 0, static_cast<cudaStream_t>(stream)>>>(
      T, threshold, static_cast<unsigned long long*>(launches));
  return static_cast<int>(cudaGetLastError());
}
