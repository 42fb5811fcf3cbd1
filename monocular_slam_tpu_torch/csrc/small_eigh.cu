// K3: batched eigen-decomposition of small symmetric matrices (n <= 12) and
// the 3x3 SVD, for Hopper (sm_90a), with a plain C interface.
//
// It has no Pallas counterpart: inside the reference's compiled step, XLA's
// `eigh` (a Jacobi method on the TPU) and `svd` run as part of the one
// program. torch's `linalg.eigh` / `svd` check their status on the host,
// which a CUDA graph cannot hold, so the port's tracked step decomposes its
// matrices here: the (N, 4, 4) triangulation normal matrices, the 12x12 PnP
// refit normal matrix, and the 3x3 block of the PnP refit that gives its
// scale and rotation (`project_to_so3`).
//
// What bounds it: neither bytes nor the card's peak rate (both bounds are
// below 0.0001 ms at the step's shapes), but the chain of dependent
// double-precision divides and square roots of the Jacobi rotations (five
// a rotation): a round of the warp kernel at n = 12 is ~0.7 us on the H100
// (0.047 ms for 6 sweeps of 11 rounds, `chip_profile.py k3`). The design
// shortens that chain; it keeps each matrix inside one warp or one thread,
// so that nothing leaves the SM between rotations and no launch waits on
// the host.
//
// small_eigh: Jacobi in double with the parallel (Brent-Luk round-robin)
// ordering. An odd n is padded with a phantom index (a zero row and
// column), m = n rounded up to even; a sweep is m - 1 rounds of m/2
// disjoint pairs, each pair once (`Slot`; its Python mirror is
// `ops/small_eigh.jacobi_rounds`). The rotations of a round touch
// disjoint index pairs, so each is computed from the round's matrix at the
// same time as the others, by the formulas of the cyclic method (theta, t,
// c, s; a pair whose entry is exactly 0 is left alone), and J^T A J is
// applied to whole 2x2 blocks (rows of pair I, columns of pair J): a
// block's new value depends only on its own four entries and the two
// rotations. A diagonal block takes app - t apq, aqq + t apq and an exact
// 0. Only the lower triangle is kept (LAPACK's UPLO='L' is what is read).
// Sweeps run until the off-diagonal mass falls below 1e-30 of the
// diagonal's, or 30 sweeps; a mass that is not finite stops at once.
// Eigenvalues come out ascending (a NaN last); each eigenvector's
// largest-magnitude entry (the first on ties) is made positive.
//
//  - n = 5..12, `small_eigh_warp_kernel`: one warp per matrix, A and V in
//    shared memory. In a round lane k < m/2 computes pair k's rotation,
//    publishes (c, s) in shared memory and writes its diagonal block, while
//    the lanes of the off-diagonal blocks (15 at n = 12) read their
//    blocks; after one __syncwarp those lanes rotate their blocks and every
//    lane rotates its row pairs of V (n m/2 of them, at most 3 a lane, all
//    read before any is written); one more __syncwarp ends the round. A
//    sweep is 11 dependent rounds at n = 12 where the cyclic order was 66
//    dependent rotations. Computing each rotation in every lane that needs
//    it instead (no shared (c, s), one barrier fewer) measured slower: a
//    lane then issues two rotations' double-precision work a round.
//  - n <= 4, `small_eigh_thread_kernel`: one matrix per thread, A and V in
//    registers (96 of them, no spill at n = 4), the 3-round schedule
//    unrolled at compile time: the two rotations of a round are
//    independent instruction streams, and no round waits on shared memory
//    or a barrier. 32 threads a block, so that a batch spreads over the
//    SMs' double-precision units. At (1000, 4, 4) it measured faster than
//    the warp kernel at n = 4 (a warp per matrix, 64 registers, 10.5 KB of
//    shared memory a block: 0.0139 against 0.0107 ms) and than a lane
//    group of four per matrix (see PERF.md).
//
// svd3: one thread per 3x3 matrix, in double. G = M^T M is formed once
// (float32 products are exact in double) and the symmetric Jacobi method
// runs on G in the cyclic order (for 3x3 it is also the round-robin one):
// each rotation reads three entries of G where the one-sided method summed
// nine products. A pair is rotated while |g_pq| > 1e-15 sqrt(|g_pp g_qq|)
// (the one-sided method's test, on the same numbers; the absolute value
// keeps a diagonal entry that rounding took below 0 from freezing its
// pairs); sweeps stop when no pair rotates, or at 30. Then B = M V: the
// singular values are B's column norms (descending), U's first column is
// B's normalised, its second B's next column orthogonalised against the
// first and normalised, its third their cross product (signed as B's third
// column); a singular value at or below 1e-15 of the largest (or 1e-300)
// takes the completion: an orthonormal basis around the columns that
// remain. U is orthonormal to rounding. Forming G squares the condition:
// near a rank deficiency (a second singular value around 1e-8 of the
// first) S and U S Vt can miss by up to ~sqrt(eps) = 1e-8 of the largest
// singular value, below float32's rounding. The chain is a single
// thread's: ~4 sweeps of 3 rotations at the step's shapes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAXN = 12;
constexpr int MAXH = MAXN / 2;  // pairs a round
constexpr int LD = MAXN + 1;
constexpr int WARPS = 4;        // matrices per block of the warp kernel
constexpr int THREADS = 32;     // matrices per block of the per-thread kernels
constexpr int MAX_SWEEPS = 30;
constexpr unsigned FULL = 0xffffffffu;

// One more launch on `*launches` (the port's launch counter): the first
// thread of the first block adds one, so a replayed CUDA graph counts too.
__device__ __forceinline__ void count_launch(unsigned long long* launches) {
  if (launches != nullptr && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&
      threadIdx.x == 0 && threadIdx.y == 0 && threadIdx.z == 0)
    atomicAdd(launches, 1ULL);
}

// The round-robin (circle method) schedule of m players (m even): in round
// r, slot 0 pairs r with m - 1 (the player that stays), slot k > 0 pairs
// (r + k) mod (m - 1) with (r - k) mod (m - 1). From one round to the next
// both players of a slot move up by one (mod m - 1), except the one that
// stays.
struct Slot {
  int a, b;  // the slot's two players this round
  __device__ __forceinline__ void start(int m, int k) {
    a = k;
    b = k == 0 ? m - 1 : m - 1 - k;
  }
  __device__ __forceinline__ void next(int m) {
    a = a + 1 == m - 1 ? 0 : a + 1;
    if (b != m - 1) b = b + 1 == m - 1 ? 0 : b + 1;
  }
  __device__ __forceinline__ int p() const { return a < b ? a : b; }
  __device__ __forceinline__ int q() const { return a < b ? b : a; }
};

// the rotation that zeroes a_pq (Numerical Recipes' `jacobi`): c, s, t; the
// identity when a_pq is exactly 0
__device__ __forceinline__ void rotation(double app, double aqq, double apq, double& c, double& s,
                                         double& t) {
  c = 1.0;
  s = 0.0;
  t = 0.0;
  if (apq != 0.0) {
    const double theta = (aqq - app) / (2.0 * apq);
    t = 1.0 / (fabs(theta) + sqrt(theta * theta + 1.0));
    if (theta < 0.0) t = -t;
    c = 1.0 / sqrt(t * t + 1.0);
    s = t * c;
  }
}

// J_I^T B J_J for the 2x2 block B = [[b00, b01], [b10, b11]] (rows p_I, q_I;
// columns p_J, q_J), J = [[c, s], [-s, c]]: columns first, then rows
__device__ __forceinline__ void rotate_block(double cI, double sI, double cJ, double sJ,
                                             double& b00, double& b01, double& b10,
                                             double& b11) {
  const double c00 = cJ * b00 - sJ * b01, c01 = sJ * b00 + cJ * b01;
  const double c10 = cJ * b10 - sJ * b11, c11 = sJ * b10 + cJ * b11;
  b00 = cI * c00 - sI * c10;
  b10 = sI * c00 + cI * c10;
  b01 = cI * c01 - sI * c11;
  b11 = sI * c01 + cI * c11;
}

// the lower-triangle entry (i, j) of a symmetric matrix stored by rows
template <int L>
__device__ __forceinline__ double& low(double (*a)[L], int i, int j) {
  return i > j ? a[i][j] : a[j][i];
}

// whether d[j] comes before d[k] in the ascending order, NaN last, ties
// (and NaNs) by index: the ranks are a permutation, so every output slot
// is written once
__device__ __forceinline__ bool before(double dj, int j, double dk, int k) {
  const bool nj = isnan(dj), nk = isnan(dk);
  if (nj || nk) return !nj || (nk && j < k);
  return dj < dk || (dj == dk && j < k);
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
small_eigh_warp_kernel(const T* __restrict__ A, T* __restrict__ w, T* __restrict__ V, int batch,
                       int n, unsigned long long* launches) {
  count_launch(launches);
  __shared__ double sa[WARPS][MAXN][LD];
  __shared__ double sv[WARPS][MAXN][LD];
  __shared__ double sc[WARPS][MAXH], ss[WARPS][MAXH], sd[WARPS][MAXN];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t mat = (int64_t)blockIdx.x * WARPS + warp;
  if (mat >= batch) return;  // the whole warp leaves together
  double(*a)[LD] = sa[warp];
  double(*v)[LD] = sv[warp];
  const int m = n + (n & 1), h = m / 2;
  const T* Am = A + mat * n * n;
  for (int e = lane; e < m * m; e += 32) {
    const int r = e / m, c = e % m;
    a[r][c] = r >= c && r < n ? (double)Am[r * n + c] : 0.0;
    v[r][c] = r == c ? 1.0 : 0.0;
  }
  // this lane's work in a round: pair `lane` (lane < h), else the
  // off-diagonal block (I, J), I > J, numbered after the h pairs; and up to
  // three row pairs (row, slot) of V
  int I = 0, J = 0;
  const int nb = h + h * (h - 1) / 2;
  if (lane >= h && lane < nb) {
    int b = lane - h;
    I = 1;
    while (b >= I) b -= I++;
    J = b;
  }
  Slot pair, sI, sJ, sV[3];
  pair.start(m, lane < h ? lane : 0);
  sI.start(m, I);
  sJ.start(m, J);
  int vrow[3], vslot[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int e = lane + 32 * i;
    vrow[i] = e < n * h ? e / h : -1;
    vslot[i] = e < n * h ? e % h : 0;
    sV[i].start(m, vslot[i]);
  }
  __syncwarp();
  for (int sweep = 0; sweep < MAX_SWEEPS; ++sweep) {
    double off = 0.0, diag = 0.0;
    for (int e = lane; e < n * n; e += 32) {
      const int r = e / n, c = e % n;
      const double x = a[r][c];
      if (r == c) diag += x * x; else if (r > c) off += 2.0 * x * x;
    }
    for (int o = 16; o; o >>= 1) {
      off += __shfl_xor_sync(FULL, off, o);
      diag += __shfl_xor_sync(FULL, diag, o);
    }
    if (!(off > 1e-30 * diag)) break;  // converged, all zero, or not finite
    for (int r = 0; r < m - 1; ++r) {
      const int pI = sI.p(), qI = sI.q(), pJ = sJ.p(), qJ = sJ.q();
      double b00 = 0.0, b01 = 0.0, b10 = 0.0, b11 = 0.0;
      if (lane < h) {
        const int p = pair.p(), q = pair.q();
        const double app = a[p][p], aqq = a[q][q], apq = a[q][p];
        double c, s, t;
        rotation(app, aqq, apq, c, s, t);
        sc[warp][lane] = c;
        ss[warp][lane] = s;
        if (apq != 0.0) {
          a[p][p] = app - t * apq;
          a[q][q] = aqq + t * apq;
          a[q][p] = 0.0;
        }
      } else if (lane < nb) {  // this round's block, read while the rotations are computed
        b00 = low(a, pI, pJ);
        b01 = low(a, pI, qJ);
        b10 = low(a, qI, pJ);
        b11 = low(a, qI, qJ);
      }
      __syncwarp();
      if (lane >= h && lane < nb) {
        rotate_block(sc[warp][I], ss[warp][I], sc[warp][J], ss[warp][J], b00, b01, b10, b11);
        low(a, pI, pJ) = b00;
        low(a, pI, qJ) = b01;
        low(a, qI, pJ) = b10;
        low(a, qI, qJ) = b11;
      }
      // V's row pairs: every item of the lane read, then rotated and written
      double vp[3], vq[3], vc[3], vs[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        if (vrow[i] < 0) continue;
        vc[i] = sc[warp][vslot[i]];
        vs[i] = ss[warp][vslot[i]];
        vp[i] = v[vrow[i]][sV[i].p()];
        vq[i] = v[vrow[i]][sV[i].q()];
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        if (vrow[i] < 0) continue;
        v[vrow[i]][sV[i].p()] = vc[i] * vp[i] - vs[i] * vq[i];
        v[vrow[i]][sV[i].q()] = vs[i] * vp[i] + vc[i] * vq[i];
      }
      pair.next(m);
      sI.next(m);
      sJ.next(m);
#pragma unroll
      for (int i = 0; i < 3; ++i) sV[i].next(m);
      __syncwarp();
    }
  }
  if (lane < n) sd[warp][lane] = a[lane][lane];
  __syncwarp();
  if (lane < n) {
    const double dk = sd[warp][lane];
    int rank = 0;
    for (int j = 0; j < n; ++j) rank += before(sd[warp][j], j, dk, lane) ? 1 : 0;
    int imax = 0;
    double vmax = -1.0;
    for (int r = 0; r < n; ++r) {
      const double x = fabs(v[r][lane]);
      if (x > vmax) { vmax = x; imax = r; }
    }
    const double sgn = v[imax][lane] < 0.0 ? -1.0 : 1.0;
    w[mat * n + rank] = (T)dk;
    T* Vm = V + mat * n * n;
    for (int r = 0; r < n; ++r) Vm[r * n + rank] = (T)(sgn * v[r][lane]);
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
small_eigh_thread_kernel(const T* __restrict__ A, T* __restrict__ w, T* __restrict__ V,
                         int batch, unsigned long long* launches) {
  count_launch(launches);
  constexpr int M = N + (N & 1), H = M / 2;
  const int64_t mat = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (mat >= batch) return;
  double a[M][M], v[M][M];  // a: the lower triangle only
  const T* Am = A + mat * N * N;
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int c = 0; c < M; ++c) {
      if (r >= c) a[r][c] = r < N ? (double)Am[r * N + c] : 0.0;
      v[r][c] = r == c ? 1.0 : 0.0;
    }
  for (int sweep = 0; sweep < MAX_SWEEPS; ++sweep) {
    double off = 0.0, diag = 0.0;
#pragma unroll
    for (int r = 0; r < N; ++r) {
      diag += a[r][r] * a[r][r];
#pragma unroll
      for (int c = 0; c < r; ++c) off += 2.0 * a[r][c] * a[r][c];
    }
    if (!(off > 1e-30 * diag)) break;  // converged, all zero, or not finite
    Slot slot[H];
#pragma unroll
    for (int k = 0; k < H; ++k) slot[k].start(M, k);
#pragma unroll
    for (int r = 0; r < M - 1; ++r) {
      int p[H], q[H];
      double c[H], s[H];
#pragma unroll
      for (int k = 0; k < H; ++k) {
        p[k] = slot[k].p();
        q[k] = slot[k].q();
        slot[k].next(M);
        const double app = a[p[k]][p[k]], aqq = a[q[k]][q[k]], apq = a[q[k]][p[k]];
        double t;
        rotation(app, aqq, apq, c[k], s[k], t);
        if (apq != 0.0) {
          a[p[k]][p[k]] = app - t * apq;
          a[q[k]][q[k]] = aqq + t * apq;
          a[q[k]][p[k]] = 0.0;
        }
      }
#pragma unroll
      for (int i = 1; i < H; ++i)
#pragma unroll
        for (int j = 0; j < i; ++j)
          rotate_block(c[i], s[i], c[j], s[j], low(a, p[i], p[j]), low(a, p[i], q[j]),
                       low(a, q[i], p[j]), low(a, q[i], q[j]));
#pragma unroll
      for (int k = 0; k < H; ++k)
#pragma unroll
        for (int row = 0; row < N; ++row) {
          const double vkp = v[row][p[k]], vkq = v[row][q[k]];
          v[row][p[k]] = c[k] * vkp - s[k] * vkq;
          v[row][q[k]] = s[k] * vkp + c[k] * vkq;
        }
    }
  }
  T* Vm = V + mat * N * N;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    int rank = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) rank += before(a[j][j], j, a[k][k], k) ? 1 : 0;
    double vmax = -1.0, big = 0.0;  // the largest-magnitude entry, the first on ties
#pragma unroll
    for (int r = 0; r < N; ++r)
      if (fabs(v[r][k]) > vmax) { vmax = fabs(v[r][k]); big = v[r][k]; }
    const double sgn = big < 0.0 ? -1.0 : 1.0;
    w[mat * N + rank] = (T)a[k][k];
#pragma unroll
    for (int r = 0; r < N; ++r) Vm[r * N + rank] = (T)(sgn * v[r][k]);
  }
}

__device__ __forceinline__ void unit_orthogonal(const double u[3], double out[3]) {
  // a unit vector orthogonal to the unit vector u
  const int i = fabs(u[0]) <= fabs(u[1]) ? (fabs(u[0]) <= fabs(u[2]) ? 0 : 2)
                                         : (fabs(u[1]) <= fabs(u[2]) ? 1 : 2);
  const double e0 = i == 0 ? 1.0 : 0.0, e1 = i == 1 ? 1.0 : 0.0, e2 = i == 2 ? 1.0 : 0.0;
  out[0] = u[1] * e2 - u[2] * e1;
  out[1] = u[2] * e0 - u[0] * e2;
  out[2] = u[0] * e1 - u[1] * e0;
  const double nrm = sqrt(out[0] * out[0] + out[1] * out[1] + out[2] * out[2]);
  for (int r = 0; r < 3; ++r) out[r] /= nrm;
}

__device__ __forceinline__ void cross(const double x[3], const double y[3], double out[3]) {
  out[0] = x[1] * y[2] - x[2] * y[1];
  out[1] = x[2] * y[0] - x[0] * y[2];
  out[2] = x[0] * y[1] - x[1] * y[0];
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
svd3_kernel(const T* __restrict__ M, T* __restrict__ U, T* __restrict__ S, T* __restrict__ Vt,
            int batch, unsigned long long* launches) {
  count_launch(launches);
  const int64_t m = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= batch) return;
  double a[3][3], g[3][3], v[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a[r][c] = (double)M[m * 9 + r * 3 + c];
      v[r][c] = r == c ? 1.0 : 0.0;
    }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      g[i][j] = a[0][i] * a[0][j] + a[1][i] * a[1][j] + a[2][i] * a[2][j];
      g[j][i] = g[i][j];
    }
  for (int sweep = 0; sweep < MAX_SWEEPS; ++sweep) {
    bool rotated = false;
#pragma unroll
    for (int pair = 0; pair < 3; ++pair) {
      const int p = pair == 2 ? 1 : 0, q = pair == 0 ? 1 : 2, o = 3 - p - q;
      const double al = g[p][p], be = g[q][q], ga = g[p][q];
      if (!(fabs(ga) > 1e-15 * sqrt(fabs(al * be)))) continue;
      rotated = true;
      const double zeta = (be - al) / (2.0 * ga);
      double t = 1.0 / (fabs(zeta) + sqrt(1.0 + zeta * zeta));
      if (zeta < 0.0) t = -t;
      const double c = 1.0 / sqrt(1.0 + t * t), s = c * t;
      const double gop = g[o][p], goq = g[o][q];
      g[p][p] = al - t * ga;
      g[q][q] = be + t * ga;
      g[p][q] = g[q][p] = 0.0;
      g[o][p] = g[p][o] = c * gop - s * goq;
      g[o][q] = g[q][o] = s * gop + c * goq;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const double vp = v[r][p], vq = v[r][q];
        v[r][p] = c * vp - s * vq;
        v[r][q] = s * vp + c * vq;
      }
    }
    if (!rotated) break;
  }
  double b[3][3], sig[3];  // b[c]: column c of M V
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int r = 0; r < 3; ++r) b[c][r] = a[r][0] * v[0][c] + a[r][1] * v[1][c] + a[r][2] * v[2][c];
    sig[c] = sqrt(b[c][0] * b[c][0] + b[c][1] * b[c][1] + b[c][2] * b[c][2]);
  }
  // columns in descending order of sig: a stable bubble sort of three
  // (compare-exchange (0, 1), (1, 2), (0, 1)), kept in registers
  const auto exchange = [&](int i, int j) {
    if (sig[i] < sig[j]) {
      const double t = sig[i];
      sig[i] = sig[j];
      sig[j] = t;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const double x = b[i][r], y = v[r][i];
        b[i][r] = b[j][r];
        b[j][r] = x;
        v[r][i] = v[r][j];
        v[r][j] = y;
      }
    }
  };
  exchange(0, 1);
  exchange(1, 2);
  exchange(0, 1);
  double u[3][3];  // u[c] is column c of U
  const double floor = sig[0] * 1e-15;
  const int have = (sig[0] > floor && sig[0] > 1e-300) + (sig[1] > floor && sig[1] > 1e-300) +
                   (sig[2] > floor && sig[2] > 1e-300);
  if (have == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int r = 0; r < 3; ++r) u[c][r] = r == c ? 1.0 : 0.0;
  } else {
#pragma unroll
    for (int r = 0; r < 3; ++r) u[0][r] = b[0][r] / sig[0];
    if (have >= 2) {
      const double d = u[0][0] * b[1][0] + u[0][1] * b[1][1] + u[0][2] * b[1][2];
#pragma unroll
      for (int r = 0; r < 3; ++r) u[1][r] = b[1][r] - d * u[0][r];
      const double nrm = sqrt(u[1][0] * u[1][0] + u[1][1] * u[1][1] + u[1][2] * u[1][2]);
#pragma unroll
      for (int r = 0; r < 3; ++r) u[1][r] /= nrm;
    } else {
      unit_orthogonal(u[0], u[1]);
    }
    cross(u[0], u[1], u[2]);
    if (have == 3 && u[2][0] * b[2][0] + u[2][1] * b[2][1] + u[2][2] * b[2][2] < 0.0) {
#pragma unroll
      for (int r = 0; r < 3; ++r) u[2][r] = -u[2][r];
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    S[m * 3 + c] = (T)sig[c];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      U[m * 9 + r * 3 + c] = (T)u[c][r];
      Vt[m * 9 + c * 3 + r] = (T)v[r][c];
    }
  }
}

template <typename T, int N>
void launch_thread(const void* A, void* w, void* V, int batch, unsigned long long* cnt,
                   cudaStream_t s) {
  small_eigh_thread_kernel<T, N><<<(batch + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      static_cast<const T*>(A), static_cast<T*>(w), static_cast<T*>(V), batch, cnt);
}

template <typename T>
void launch_eigh(const void* A, void* w, void* V, int batch, int n, unsigned long long* cnt,
                 cudaStream_t s) {
  if (n > 4) {
    small_eigh_warp_kernel<T><<<(batch + WARPS - 1) / WARPS, WARPS * 32, 0, s>>>(
        static_cast<const T*>(A), static_cast<T*>(w), static_cast<T*>(V), batch, n, cnt);
    return;
  }
  switch (n) {
    case 1: launch_thread<T, 1>(A, w, V, batch, cnt, s); break;
    case 2: launch_thread<T, 2>(A, w, V, batch, cnt, s); break;
    case 3: launch_thread<T, 3>(A, w, V, batch, cnt, s); break;
    default: launch_thread<T, 4>(A, w, V, batch, cnt, s); break;
  }
}

}  // namespace

// Each entry launches one kernel on `stream` and returns cudaGetLastError()
// (0 on success), and adds one to the 64-bit counter at `launches` (none if
// null). Every array is contiguous, float32 (f64 == 0) or float64.
// small_eigh: A (batch, n, n) -> w (batch, n) ascending, V (batch, n, n)
// with the eigenvectors as columns; 1 <= n <= 12, batch >= 1. n <= 4 takes
// the per-thread kernel, n = 5..12 the warp kernel.
extern "C" int small_eigh(const void* A, void* w, void* V, int batch, int n, int f64,
                          void* launches, void* stream) {
  if (n < 1 || n > MAXN || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  unsigned long long* cnt = static_cast<unsigned long long*>(launches);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64)
    launch_eigh<double>(A, w, V, batch, n, cnt, s);
  else
    launch_eigh<float>(A, w, V, batch, n, cnt, s);
  return static_cast<int>(cudaGetLastError());
}

// svd3: M (batch, 3, 3) -> U (batch, 3, 3), S (batch, 3) descending,
// Vt (batch, 3, 3) with M = U diag(S) Vt; batch >= 1.
extern "C" int svd3(const void* M, void* U, void* S, void* Vt, int batch, int f64,
                    void* launches, void* stream) {
  if (batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  unsigned long long* cnt = static_cast<unsigned long long*>(launches);
  const dim3 grid((batch + THREADS - 1) / THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64)
    svd3_kernel<double><<<grid, THREADS, 0, s>>>(
        static_cast<const double*>(M), static_cast<double*>(U), static_cast<double*>(S),
        static_cast<double*>(Vt), batch, cnt);
  else
    svd3_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(M), static_cast<float*>(U), static_cast<float*>(S),
        static_cast<float*>(Vt), batch, cnt);
  return static_cast<int>(cudaGetLastError());
}
