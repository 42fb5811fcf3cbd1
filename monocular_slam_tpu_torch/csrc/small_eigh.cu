// K3: batched eigen-decomposition of small symmetric matrices (n <= 12) and
// the 3x3 SVD, for Hopper (sm_90a), with a plain C interface.
//
// It has no Pallas counterpart: inside the reference's compiled step, XLA's
// `eigh` (a Jacobi method on the TPU) and `svd` run as part of the one
// program. torch's `linalg.eigh` / `svd` check their status on the host,
// which a CUDA graph cannot hold, so the port's tracked step decomposes its
// matrices here: the (N, 4, 4) triangulation normal matrices, the 12x12 PnP
// refit normal matrix, and the 3x3 rotation blocks that `project_to_so3`
// and the PnP scale take apart.
//
// small_eigh: cyclic Jacobi, one warp per matrix. The matrix (its lower
// triangle, as LAPACK's UPLO='L' reads it) and the eigenvector basis sit in
// shared memory in double precision; each rotation (p, q) is computed by
// every lane from the same three entries, and lane k updates row/column k
// of A and row k of V. Sweeps run until the off-diagonal mass falls below
// 1e-30 of the diagonal's (or 30 sweeps). Eigenvalues come out ascending;
// each eigenvector's largest-magnitude entry (the first on ties) is made
// positive.
//
// svd3: one-sided (Hestenes) Jacobi, one thread per 3x3 matrix in double:
// column pairs are rotated until orthogonal, the singular values are the
// column norms (descending), U's columns the normalised columns; a zero
// singular value's column of U completes an orthonormal basis.
//
// What bounds it: neither bytes nor the card's peak rate. At the step's
// shapes a launch is a few microseconds of dependent shared-memory work per
// warp (12x12: ~66 rotations per sweep, ~8 sweeps); the design keeps each
// matrix inside one warp so that nothing leaves the SM between rotations
// and no launch waits on the host.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAXN = 12;
constexpr int LD = MAXN + 1;
constexpr int WARPS = 4;  // matrices per block
constexpr int MAX_SWEEPS = 30;
constexpr unsigned FULL = 0xffffffffu;

// One more launch on `*launches` (the port's launch counter): the first
// thread of the first block adds one, so a replayed CUDA graph counts too.
__device__ __forceinline__ void count_launch(unsigned long long* launches) {
  if (launches != nullptr && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&
      threadIdx.x == 0 && threadIdx.y == 0 && threadIdx.z == 0)
    atomicAdd(launches, 1ULL);
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
small_eigh_kernel(const T* __restrict__ A, T* __restrict__ w, T* __restrict__ V, int batch,
                  int n, unsigned long long* launches) {
  count_launch(launches);
  __shared__ double sa[WARPS][MAXN][LD];
  __shared__ double sv[WARPS][MAXN][LD];
  __shared__ double sd[WARPS][MAXN];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t m = (int64_t)blockIdx.x * WARPS + warp;
  if (m >= batch) return;  // the whole warp leaves together
  double(*a)[LD] = sa[warp];
  double(*v)[LD] = sv[warp];
  const T* Am = A + m * n * n;
  for (int e = lane; e < n * n; e += 32) {
    const int r = e / n, c = e % n;
    const int hi = r > c ? r : c, lo = r > c ? c : r;
    a[r][c] = (double)Am[hi * n + lo];
    v[r][c] = r == c ? 1.0 : 0.0;
  }
  __syncwarp();
  for (int sweep = 0; sweep < MAX_SWEEPS; ++sweep) {
    double off = 0.0, diag = 0.0;
    for (int e = lane; e < n * n; e += 32) {
      const int r = e / n, c = e % n;
      const double x = a[r][c];
      if (r == c) diag += x * x; else off += x * x;
    }
    for (int o = 16; o; o >>= 1) {
      off += __shfl_xor_sync(FULL, off, o);
      diag += __shfl_xor_sync(FULL, diag, o);
    }
    if (!(off > 1e-30 * diag)) break;  // converged, all zero, or not finite
    for (int p = 0; p < n - 1; ++p) {
      for (int q = p + 1; q < n; ++q) {
        const double apq = a[p][q], app = a[p][p], aqq = a[q][q];
        __syncwarp();
        if (apq == 0.0) continue;  // the same shared value in every lane
        const double theta = (aqq - app) / (2.0 * apq);
        double t = 1.0 / (fabs(theta) + sqrt(theta * theta + 1.0));
        if (theta < 0.0) t = -t;
        const double c = 1.0 / sqrt(t * t + 1.0), s = t * c;
        const int k = lane;
        if (k < n && k != p && k != q) {
          const double akp = a[k][p], akq = a[k][q];
          const double nkp = c * akp - s * akq, nkq = s * akp + c * akq;
          a[k][p] = nkp;
          a[p][k] = nkp;
          a[k][q] = nkq;
          a[q][k] = nkq;
        }
        if (k < n) {
          const double vkp = v[k][p], vkq = v[k][q];
          v[k][p] = c * vkp - s * vkq;
          v[k][q] = s * vkp + c * vkq;
        }
        if (lane == 0) {
          a[p][p] = app - t * apq;
          a[q][q] = aqq + t * apq;
          a[p][q] = 0.0;
          a[q][p] = 0.0;
        }
        __syncwarp();
      }
    }
  }
  if (lane < n) sd[warp][lane] = a[lane][lane];
  __syncwarp();
  if (lane < n) {
    const double dk = sd[warp][lane];
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const double dj = sd[warp][j];
      rank += (dj < dk || (dj == dk && j < lane)) ? 1 : 0;
    }
    int imax = 0;
    double vmax = -1.0;
    for (int r = 0; r < n; ++r) {
      const double x = fabs(v[r][lane]);
      if (x > vmax) { vmax = x; imax = r; }
    }
    const double sgn = v[imax][lane] < 0.0 ? -1.0 : 1.0;
    w[m * n + rank] = (T)dk;
    T* Vm = V + m * n * n;
    for (int r = 0; r < n; ++r) Vm[r * n + rank] = (T)(sgn * v[r][lane]);
  }
}

__device__ void unit_orthogonal(const double u[3], double out[3]) {
  // a unit vector orthogonal to the unit vector u
  const int i = fabs(u[0]) <= fabs(u[1]) ? (fabs(u[0]) <= fabs(u[2]) ? 0 : 2)
                                         : (fabs(u[1]) <= fabs(u[2]) ? 1 : 2);
  double e[3] = {0.0, 0.0, 0.0};
  e[i] = 1.0;
  out[0] = u[1] * e[2] - u[2] * e[1];
  out[1] = u[2] * e[0] - u[0] * e[2];
  out[2] = u[0] * e[1] - u[1] * e[0];
  const double nrm = sqrt(out[0] * out[0] + out[1] * out[1] + out[2] * out[2]);
  for (int r = 0; r < 3; ++r) out[r] /= nrm;
}

template <typename T>
__global__ void svd3_kernel(const T* __restrict__ M, T* __restrict__ U, T* __restrict__ S,
                            T* __restrict__ Vt, int batch, unsigned long long* launches) {
  count_launch(launches);
  const int64_t m = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= batch) return;
  double a[3][3], v[3][3];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      a[r][c] = (double)M[m * 9 + r * 3 + c];
      v[r][c] = r == c ? 1.0 : 0.0;
    }
  for (int sweep = 0; sweep < MAX_SWEEPS; ++sweep) {
    bool rotated = false;
    for (int pair = 0; pair < 3; ++pair) {
      const int p = pair == 2 ? 1 : 0, q = pair == 0 ? 1 : 2;
      double al = 0.0, be = 0.0, ga = 0.0;
      for (int r = 0; r < 3; ++r) {
        al += a[r][p] * a[r][p];
        be += a[r][q] * a[r][q];
        ga += a[r][p] * a[r][q];
      }
      if (!(fabs(ga) > 1e-15 * sqrt(al * be))) continue;
      rotated = true;
      const double zeta = (be - al) / (2.0 * ga);
      double t = 1.0 / (fabs(zeta) + sqrt(1.0 + zeta * zeta));
      if (zeta < 0.0) t = -t;
      const double c = 1.0 / sqrt(1.0 + t * t), s = c * t;
      for (int r = 0; r < 3; ++r) {
        const double ap = a[r][p], aq = a[r][q];
        a[r][p] = c * ap - s * aq;
        a[r][q] = s * ap + c * aq;
        const double vp = v[r][p], vq = v[r][q];
        v[r][p] = c * vp - s * vq;
        v[r][q] = s * vp + c * vq;
      }
    }
    if (!rotated) break;
  }
  double sig[3];
  int order[3] = {0, 1, 2};
  for (int c = 0; c < 3; ++c)
    sig[c] = sqrt(a[0][c] * a[0][c] + a[1][c] * a[1][c] + a[2][c] * a[2][c]);
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2 - i; ++j)
      if (sig[order[j]] < sig[order[j + 1]]) {
        const int tmp = order[j];
        order[j] = order[j + 1];
        order[j + 1] = tmp;
      }
  double u[3][3];  // u[c] is column c of U
  const double tiny = 1e-300;
  const double floor = sig[order[0]] * 1e-15;
  int have = 0;
  for (int c = 0; c < 3; ++c) {
    const double sc = sig[order[c]];
    if (sc > floor && sc > tiny) {
      for (int r = 0; r < 3; ++r) u[c][r] = a[r][order[c]] / sc;
      ++have;
    }
  }
  if (have == 0) {
    for (int c = 0; c < 3; ++c)
      for (int r = 0; r < 3; ++r) u[c][r] = r == c ? 1.0 : 0.0;
  } else {
    if (have == 1) unit_orthogonal(u[0], u[1]);
    if (have <= 2) {
      u[2][0] = u[0][1] * u[1][2] - u[0][2] * u[1][1];
      u[2][1] = u[0][2] * u[1][0] - u[0][0] * u[1][2];
      u[2][2] = u[0][0] * u[1][1] - u[0][1] * u[1][0];
    }
  }
  for (int c = 0; c < 3; ++c) {
    S[m * 3 + c] = (T)sig[order[c]];
    for (int r = 0; r < 3; ++r) {
      U[m * 9 + r * 3 + c] = (T)u[c][r];
      Vt[m * 9 + c * 3 + r] = (T)v[r][order[c]];
    }
  }
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() (0 on
// success), and adds one to the 64-bit counter at `launches` (none if
// null). Every array is contiguous, float32 (f64 == 0) or float64.
// small_eigh: A (batch, n, n) -> w (batch, n) ascending, V (batch, n, n)
// with the eigenvectors as columns; 1 <= n <= 12, batch >= 1.
extern "C" int small_eigh(const void* A, void* w, void* V, int batch, int n, int f64,
                          void* launches, void* stream) {
  unsigned long long* cnt = static_cast<unsigned long long*>(launches);
  const dim3 grid((batch + WARPS - 1) / WARPS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64)
    small_eigh_kernel<double><<<grid, WARPS * 32, 0, s>>>(
        static_cast<const double*>(A), static_cast<double*>(w), static_cast<double*>(V), batch,
        n, cnt);
  else
    small_eigh_kernel<float><<<grid, WARPS * 32, 0, s>>>(
        static_cast<const float*>(A), static_cast<float*>(w), static_cast<float*>(V), batch, n, cnt);
  return static_cast<int>(cudaGetLastError());
}

// svd3: M (batch, 3, 3) -> U (batch, 3, 3), S (batch, 3) descending,
// Vt (batch, 3, 3) with M = U diag(S) Vt; batch >= 1.
extern "C" int svd3(const void* M, void* U, void* S, void* Vt, int batch, int f64,
                    void* launches, void* stream) {
  unsigned long long* cnt = static_cast<unsigned long long*>(launches);
  const int threads = 128;
  const dim3 grid((batch + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64)
    svd3_kernel<double><<<grid, threads, 0, s>>>(
        static_cast<const double*>(M), static_cast<double*>(U), static_cast<double*>(S),
        static_cast<double*>(Vt), batch, cnt);
  else
    svd3_kernel<float><<<grid, threads, 0, s>>>(
        static_cast<const float*>(M), static_cast<float*>(U), static_cast<float*>(S),
        static_cast<float*>(Vt), batch, cnt);
  return static_cast<int>(cudaGetLastError());
}
