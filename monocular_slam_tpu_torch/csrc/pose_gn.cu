// pose_gn: motion-only bundle adjustment by Gauss-Newton, one pose per
// thread block, for Hopper (sm_90a), with a plain C interface
// (`ops/pose_gn.py`).
//
// It replaces no Pallas kernel: it is the Gauss-Newton route of
// `optim/pose_ba.refine_pose` (the reference's `optim/pose_ba.py`, which XLA
// fuses into the compiled step on the TPU). Op by op that route is ~1,700
// device operations a call of 3 rounds (per step a linearization over the
// edges, two batched products, a 6x6 solve; per round two chi2 sums and a
// re-gate), and the tracked step calls it twice (PnP's polish, 2 rounds, and
// the local-map refine, 3): 2,896 of the track program's 6,094 graph nodes
// on the H100. Here a whole call is one launch.
//
// What bounds it: neither bytes (28 B an edge, read once) nor operations
// (~150 flops an edge a pass), but the chain of dependent passes: per
// round min(n_iters, 3) linearizations, each followed by a block-wide sum
// and a 6x6 solve on one thread, then one pass for the round's chi2s and
// the re-gate counts; one pass at the end for the inliers.
//
// Design: the grid is the batch, one block a pose. The block has 256
// threads up to 1024 edges, 512 up to 2048 and 1024 up to MAX_N = 4096;
// edge i lies with thread i mod THREADS, at most EPT = 4 a thread, loaded
// once from global memory into registers (X, uv, weight; the valid and
// active flags as bits). Per pass each thread evaluates its edges as
// `optim/residuals.linearize` and `optim/robust.huber` do, in float32
// (`_safe_z`, the Huber weight, the 2x6 Jacobian for the left update
// exp(dx) T), and sums the 21 unique entries of H, the 6 of b (or the
// pass's chi2s and counts) in registers. The block's sums run in a fixed
// order, warp butterflies then one warp over the warps' partials in shared
// memory, with no atomics: a call repeats bit for bit. Thread 0 then
// solves (H + tau I) dx = b in float32 by LU with partial pivoting, as
// `torch.linalg.solve_ex` (LAPACK's getrf/getrs) does on the plain route (a
// zero or non-finite pivot gives dx = 0, a non-finite component 0: the
// plain route's `isfinite` guard), forms se3.exp(dx) in float32 with
// `geometry/se3.py`'s small-angle branch at float32's threshold, composes
// it onto the pose and stores it in shared memory, where every thread reads
// it for the next pass. Nothing is computed in more or fewer bits than on
// the plain route: on the few ill-conditioned calls (a handful of valid
// edges) a wider solve would give another step than the plain route's.
//
// The round logic is the plain route's: each round runs min(n_iters, 3)
// steps from the round's pose, keeps them only if the round's chi2 is
// finite and not above the round's start, then re-gates the edges at
// `gate` with unit weights, keeping the old weights if fewer than
// `min_points` valid edges pass. An edge's weight is its input weight or 0;
// before the first re-gate every edge carries its input weight, as in the
// plain route. With fewer than `min_points` valid edges the plain route
// returns the input pose, and its re-gates can never pass, so the weights
// stay the input's: the kernel then skips the rounds. The chi2 and inliers
// are those of the returned pose under the final weights. The counts are
// summed as float32, exact below 2^24 edges.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int EPT = 4;          // edges a thread
constexpr int MAX_N = 1024 * EPT;
constexpr int NH = 27;          // the sums of a linearization: 21 of H, 6 of b
constexpr unsigned FULL = 0xffffffffu;
constexpr float SAFE_Z = 1e-8f;  // `optim/residuals._safe_z`
// `geometry/so3._small_thresh(float32)`: sqrt(2^-23)
constexpr float SMALL_THETA2 = 3.4526698e-04f;

// One more launch on `*launches` (the port's launch counter): the first
// thread of the first block adds one, so a replayed CUDA graph counts too.
__device__ __forceinline__ void count_launch(unsigned long long* launches) {
  if (launches != nullptr && blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(launches, 1ULL);
}

struct Params {
  const float* T0;   // (batch, 3, 4)
  const float* X;    // (batch, n, 3)
  const float* uv;   // (batch, n, 2)
  const float* w;    // (batch, n), >= 0
  const float* k;    // fx, fy, cx, cy: (4,) shared (k_stride 0) or (batch, 4)
  int k_stride, n, n_rounds, n_steps, min_points;
  float gate, delta, delta2, two_delta;  // the chi2 gate; Huber's delta, delta^2, 2 delta
  float tau;
  float* T;          // (batch, 3, 4)
  uint8_t* inl;      // (batch, n) bool
  float* chi2;       // (batch,)
  long long* n_inl;  // (batch,)
  unsigned long long* launches;
};

// the residual of one edge at pose T (3x4 by rows), as `residuals.residual`
struct Proj {
  float x, y, zr, z, r0, r1, e2;  // camera-frame point (zr raw, z through _safe_z), residual
};

__device__ __forceinline__ Proj project(const float* T, float X0, float X1, float X2, float u,
                                        float v, float fx, float fy, float cx, float cy) {
  Proj p;
  p.x = T[0] * X0 + T[1] * X1 + T[2] * X2 + T[3];
  p.y = T[4] * X0 + T[5] * X1 + T[6] * X2 + T[7];
  p.zr = T[8] * X0 + T[9] * X1 + T[10] * X2 + T[11];
  p.z = fabsf(p.zr) < SAFE_Z ? (p.zr < 0.f ? -SAFE_Z : SAFE_Z) : p.zr;
  p.r0 = fx * p.x / p.z + cx - u;
  p.r1 = fy * p.y / p.z + cy - v;
  p.e2 = p.r0 * p.r0 + p.r1 * p.r1;
  return p;
}

// Huber's rho and IRLS weight of a squared error (`robust.huber`; a NaN
// stays NaN)
__device__ __forceinline__ float huber(float e2, float delta, float delta2, float two_delta,
                                       float* w_rob) {
  const float e = sqrtf(e2 < 1e-18f ? 1e-18f : e2);
  const bool inside = e2 <= delta2;
  *w_rob = inside ? 1.f : delta / e;
  return inside ? e2 : two_delta * e - delta2;
}

// V values summed over the block in a fixed order; the totals end in every
// lane of warp 0. `red` holds a warp's partials; the caller separates two
// uses of it by a __syncthreads.
template <int THREADS, int V>
__device__ __forceinline__ void block_sum(float (&v)[V], float (*red)[32]) {
  constexpr int WARPS = THREADS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < V; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[i] += __shfl_xor_sync(FULL, v[i], o);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < V; ++i) red[warp][i] = v[i];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float s = lane < WARPS ? red[lane][i] : 0.f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
      v[i] = s;
    }
  }
}

// (H + tau I) dx = b from the 27 sums (H's upper triangle by rows, then b),
// in float32 by LU with partial pivoting on the augmented matrix (the first
// of equal pivots, as LAPACK's isamax); dx = 0 when a pivot is 0 or not
// finite, a non-finite component 0
__device__ __forceinline__ void solve6(const float* s, float tau, float* dx) {
  float A[6][7];
  int c = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) A[i][j] = A[j][i] = s[c++];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    A[i][i] += tau;
    A[i][6] = s[21 + i];
  }
  bool singular = false;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    int p = j;
#pragma unroll
    for (int r = j + 1; r < 6; ++r) {
      if (fabsf(A[r][j]) > fabsf(A[p][j])) p = r;
    }
#pragma unroll
    for (int r = j + 1; r < 6; ++r) {  // the swap, unrolled so that A stays in registers
      if (r == p) {
#pragma unroll
        for (int m = j; m < 7; ++m) {
          const float t = A[j][m];
          A[j][m] = A[r][m];
          A[r][m] = t;
        }
      }
    }
    if (!(fabsf(A[j][j]) > 0.f) || !isfinite(A[j][j])) singular = true;
    const float inv = 1.f / A[j][j];
#pragma unroll
    for (int r = j + 1; r < 6; ++r) {
      const float f = A[r][j] * inv;
#pragma unroll
      for (int m = j + 1; m < 7; ++m) A[r][m] -= f * A[j][m];
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float t = A[i][6];
#pragma unroll
    for (int m = i + 1; m < 6; ++m) t -= A[i][m] * dx[m];
    dx[i] = t / A[i][i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) dx[i] = (singular || !isfinite(dx[i])) ? 0.f : dx[i];
}

// T <- exp(dx) T (`geometry/se3.exp` and `compose`), in float32
__device__ __forceinline__ void left_update(const float* dx, float* T) {
  const float wx = dx[0], wy = dx[1], wz = dx[2];
  const float th2 = wx * wx + wy * wy + wz * wz;
  const float th = sqrtf(th2 > 1e-16f ? th2 : 1e-16f);
  const float sn = sinf(th), cs = cosf(th);
  const bool small = th2 < SMALL_THETA2;
  const float a = small ? 1.f - th2 / 6.f : sn / th;
  const float b = small ? 0.5f - th2 / 24.f : (1.f - cs) / (th2 > 1e-16f ? th2 : 1e-16f);
  const float c = small ? 1.f / 6.f - th2 / 120.f
                        : (th - sn) / (th2 * th > 1e-24f ? th2 * th : 1e-24f);
  const float W[3][3] = {{0.f, -wz, wy}, {wz, 0.f, -wx}, {-wy, wx, 0.f}};
  float R[3][3], V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float w2 = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
      const float e = i == j ? 1.f : 0.f;
      R[i][j] = e + a * W[i][j] + b * w2;
      V[i][j] = e + b * W[i][j] + c * w2;
    }
  }
  float out[12];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float t = V[i][0] * dx[3] + V[i][1] * dx[4] + V[i][2] * dx[5];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[i * 4 + j] = R[i][0] * T[j] + R[i][1] * T[4 + j] + R[i][2] * T[8 + j] +
                       (j == 3 ? t : 0.f);
    }
  }
#pragma unroll
  for (int m = 0; m < 12; ++m) T[m] = out[m];
}

template <int THREADS>
__global__ void __launch_bounds__(THREADS) pose_gn_kernel(const Params q) {
  count_launch(q.launches);
  __shared__ float red[THREADS / 32][32];
  __shared__ float Ts[12], Tin[12];  // the running pose, the round's start
  __shared__ int flags;
  const int tid = threadIdx.x, n = q.n;
  const size_t b = blockIdx.x;
  const float* kk = q.k + q.k_stride * b;
  const float fx = kk[0], fy = kk[1], cx = kk[2], cy = kk[3];
  const float dl = q.delta, dl2 = q.delta2, dl2x = q.two_delta;

  float X0[EPT], X1[EPT], X2[EPT], U[EPT], Vv[EPT], W[EPT];
  unsigned valid = 0, act = 0;  // bit e: edge tid + e THREADS is valid (w > 0); carries its w
  float n_valid[1] = {0.f};
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int i = tid + e * THREADS;
    X0[e] = X1[e] = X2[e] = U[e] = Vv[e] = W[e] = 0.f;
    if (i < n) {
      const size_t g = b * n + i;
      X0[e] = q.X[3 * g];
      X1[e] = q.X[3 * g + 1];
      X2[e] = q.X[3 * g + 2];
      U[e] = q.uv[2 * g];
      Vv[e] = q.uv[2 * g + 1];
      W[e] = q.w[g];
      act |= 1u << e;
      if (W[e] > 0.f) {
        valid |= 1u << e;
        n_valid[0] += 1.f;
      }
    }
  }
  block_sum<THREADS, 1>(n_valid, red);
  if (tid < 12) Ts[tid] = Tin[tid] = q.T0[12 * b + tid];
  if (tid == 0) flags = n_valid[0] >= static_cast<float>(q.min_points);
  __syncthreads();
  // with fewer than min_points valid edges the input pose is returned
  const int n_rounds = flags ? q.n_rounds : 0;

  for (int round = 0; round < n_rounds; ++round) {
    for (int step = 0; step < q.n_steps; ++step) {
      float T[12];
#pragma unroll
      for (int m = 0; m < 12; ++m) T[m] = Ts[m];
      float s[NH];
#pragma unroll
      for (int m = 0; m < NH; ++m) s[m] = 0.f;
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        if (tid + e * THREADS < n) {
          const Proj p = project(T, X0[e], X1[e], X2[e], U[e], Vv[e], fx, fy, cx, cy);
          float w_rob;
          huber(p.e2, dl, dl2, dl2x, &w_rob);
          const float wt = ((act >> e) & 1u ? W[e] : 0.f) * w_rob;
          const float iz = 1.f / p.z, iz2 = iz * iz;
          const float a00 = fx * iz, a02 = -fx * p.x * iz2, a11 = fy * iz,
                      a12 = -fy * p.y * iz2;
          // the 2x6 Jacobian of the projection for exp(dx) T: A [-hat(Xc) | I]
          const float J0[6] = {a02 * p.y, a00 * p.zr - a02 * p.x, -a00 * p.y, a00, 0.f, a02};
          const float J1[6] = {-a11 * p.zr + a12 * p.y, -a12 * p.x, a11 * p.x, 0.f, a11, a12};
          int c = 0;
#pragma unroll
          for (int i = 0; i < 6; ++i) {
#pragma unroll
            for (int j = i; j < 6; ++j) s[c++] += (J0[i] * J0[j] + J1[i] * J1[j]) * wt;
          }
#pragma unroll
          for (int i = 0; i < 6; ++i) s[21 + i] -= (J0[i] * p.r0 + J1[i] * p.r1) * wt;
        }
      }
      block_sum<THREADS, NH>(s, red);
      if (tid == 0) {
        float dx[6];
        solve6(s, q.tau, dx);
        left_update(dx, Ts);
      }
      __syncthreads();
    }

    // the round's chi2 at its start and end under the round's weights, and
    // the re-gate counts at both poses
    float T[12], Ti[12];
#pragma unroll
    for (int m = 0; m < 12; ++m) {
      T[m] = Ts[m];
      Ti[m] = Tin[m];
    }
    float s[4] = {0.f, 0.f, 0.f, 0.f};  // chi2 at the start, at the end; passing at each
    unsigned pass_in = 0, pass_n = 0;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      if (tid + e * THREADS < n) {
        const float we = (act >> e) & 1u ? W[e] : 0.f;
        float w_rob;
        const Proj a = project(Ti, X0[e], X1[e], X2[e], U[e], Vv[e], fx, fy, cx, cy);
        const Proj z = project(T, X0[e], X1[e], X2[e], U[e], Vv[e], fx, fy, cx, cy);
        s[0] += huber(a.e2, dl, dl2, dl2x, &w_rob) * we;
        s[1] += huber(z.e2, dl, dl2, dl2x, &w_rob) * we;
        const bool v = (valid >> e) & 1u;
        if (v && a.e2 <= q.gate) pass_in |= 1u << e;
        if (v && z.e2 <= q.gate) pass_n |= 1u << e;
      }
    }
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      s[2] += static_cast<float>((pass_in >> e) & 1u);
      s[3] += static_cast<float>((pass_n >> e) & 1u);
    }
    block_sum<THREADS, 4>(s, red);
    if (tid == 0) {
      const bool ok = isfinite(s[1]) && s[1] <= s[0];
      const bool enough = (ok ? s[3] : s[2]) >= static_cast<float>(q.min_points);
#pragma unroll
      for (int m = 0; m < 12; ++m) {
        if (ok)
          Tin[m] = Ts[m];
        else
          Ts[m] = Tin[m];
      }
      flags = (ok ? 1 : 0) | (enough ? 2 : 0);
    }
    __syncthreads();
    const int f = flags;
    if (f & 2) act = (f & 1) ? pass_n : pass_in;
  }

  // the inliers and chi2 at the pose returned
  float T[12];
#pragma unroll
  for (int m = 0; m < 12; ++m) T[m] = Ts[m];
  float s[2] = {0.f, 0.f};  // chi2, inliers
  unsigned inl = 0;
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    if (tid + e * THREADS < n) {
      float w_rob;
      const Proj a = project(T, X0[e], X1[e], X2[e], U[e], Vv[e], fx, fy, cx, cy);
      s[0] += huber(a.e2, dl, dl2, dl2x, &w_rob) * ((act >> e) & 1u ? W[e] : 0.f);
      if (((valid >> e) & 1u) && a.e2 <= q.gate) inl |= 1u << e;
    }
  }
#pragma unroll
  for (int e = 0; e < EPT; ++e) s[1] += static_cast<float>((inl >> e) & 1u);
  block_sum<THREADS, 2>(s, red);
  if (tid == 0) {
    q.chi2[b] = s[0];
    q.n_inl[b] = static_cast<long long>(s[1]);
  }
  if (tid < 12) q.T[12 * b + tid] = Ts[tid];
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int i = tid + e * THREADS;
    if (i < n) q.inl[b * n + i] = (inl >> e) & 1u;
  }
}

}  // namespace

// Launches one `pose_gn_kernel` (batch blocks) on `stream` and returns
// cudaGetLastError() (0 on success); adds one to the 64-bit counter at
// `launches` (none if null). Every array is contiguous float32 but `inl`
// (bool, one byte an edge) and `n_inl` (int64). k holds fx, fy, cx, cy:
// k_stride 0 shares it, 4 gives each pose its own. 0 <= n <= 4096,
// batch >= 1, n_rounds >= 0, n_iters >= 0 (min(n_iters, 3) steps a round).
extern "C" int pose_gn(const void* T0, const void* X, const void* uv, const void* w,
                       const void* k, int k_stride, int batch, int n, int n_rounds, int n_iters,
                       float gate, double tau, int min_points, double delta, void* T, void* inl,
                       void* chi2, void* n_inl, void* launches, void* stream) {
  if (n < 0 || n > MAX_N || batch < 1 || n_rounds < 0 || n_iters < 0 ||
      (k_stride != 0 && k_stride != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  Params q;
  q.T0 = static_cast<const float*>(T0);
  q.X = static_cast<const float*>(X);
  q.uv = static_cast<const float*>(uv);
  q.w = static_cast<const float*>(w);
  q.k = static_cast<const float*>(k);
  q.k_stride = k_stride;
  q.n = n;
  q.n_rounds = n_rounds;
  q.n_steps = n_iters < 3 ? n_iters : 3;
  q.min_points = min_points;
  q.gate = gate;
  q.delta = static_cast<float>(delta);
  q.delta2 = static_cast<float>(delta * delta);
  q.two_delta = static_cast<float>(2.0 * delta);
  q.tau = static_cast<float>(tau);
  q.T = static_cast<float*>(T);
  q.inl = static_cast<uint8_t*>(inl);
  q.chi2 = static_cast<float*>(chi2);
  q.n_inl = static_cast<long long*>(n_inl);
  q.launches = static_cast<unsigned long long*>(launches);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 256 * EPT)
    pose_gn_kernel<256><<<batch, 256, 0, s>>>(q);
  else if (n <= 512 * EPT)
    pose_gn_kernel<512><<<batch, 512, 0, s>>>(q);
  else
    pose_gn_kernel<1024><<<batch, 1024, 0, s>>>(q);
  return static_cast<int>(cudaGetLastError());
}
