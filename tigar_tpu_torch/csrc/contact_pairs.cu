// K13 / K14: all-pairs penalty self-contact between collocation points.
//
// Replaces tigar_tpu/contact.py:205 _contact_residual (jax.grad of
// PointContact.energy) and :210 _contact_tangent (its jvp), on the
// pair-space side: n points x [n][3], lumped weights w [n], the static
// exclusion mask live [n][n] (bool, symmetric by construction), and the
// penalty phi(r) = k/2 (r_max - r)^2 for r < r_max.  With d = x_i - x_j,
// r = |d| and C = w_i w_j, for every live pair with r < r_max:
//
//   K13: g_i  = sum_j C phi'(r) d / r
//             = k w_i sum_j w_j (1 - r_max / r) d
//   K14: Hv_i = sum_j C [phi'' n n^T + (phi' / r)(I - n n^T)] (v_i - v_j)
//             = k w_i sum_j w_j [(1 - r_max / r) dv + r_max (d.dv) d / r^3]
//
// with dv = v_i - v_j (masked pairs and pairs at or beyond r_max add
// nothing, as the safe sqrt of contact.py:150-154 makes them).  The
// gather x = X + P U and the scatter P^T g stay in the wrapper
// (ops/contact.py): 9 entries a point, outside the O(n^2) work.
//
// Bound: the n^2 mask bytes (92 MB at the reference workload's n = 9,604)
// against ~8 operations a live pair for the distance test and ~20 / ~40
// more for an interacting one; which binds depends on the state, and the
// measurement counts both from its own data.
// Design: one warp per row i, 8 rows a block.  The block walks j in tiles
// of 512 points staged in shared memory (positions, w, and for K14 the
// perturbations; structure of arrays with one pad slot per 16 points, so
// that lane l's 16 consecutive points fall in distinct banks).  Each lane
// reads its 16 mask bytes of the tile as one 16-byte load (the wrapper
// hands the mask with a row stride that is a multiple of 16 and zero
// padding), tests each live pair's squared distance before the sqrt and
// division, and sums in registers in the working type.  Warp shuffles
// reduce the row and lane 0 writes it once: no atomics, so the result is
// deterministic.
#include "kernels.h"

namespace tigar {

constexpr int CP_THREADS = 256;
constexpr int CP_WARPS = CP_THREADS / 32;
constexpr int CP_TILE = 512;
constexpr int CP_SLOTS = CP_TILE + CP_TILE / 16;

__device__ __forceinline__ int cp_slot(int j) { return j + (j >> 4); }

template <typename T, bool TANGENT>
__global__ void __launch_bounds__(CP_THREADS)
contact_pairs_kernel(int n, long long ld,
                     const unsigned char* __restrict__ mask,
                     const T* __restrict__ x, const T* __restrict__ v,
                     const T* __restrict__ w, T k, T r_max,
                     T* __restrict__ out) {
  __shared__ T xs[3][CP_SLOTS];
  __shared__ T ws[CP_SLOTS];
  __shared__ T vs[TANGENT ? 3 : 1][TANGENT ? CP_SLOTS : 1];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = blockIdx.x * CP_WARPS + warp;
  const bool row = i < n;
  T xi[3] = {T(0), T(0), T(0)}, vi[3] = {T(0), T(0), T(0)};
  if (row) {
    for (int c = 0; c < 3; ++c) {
      xi[c] = x[3 * (size_t)i + c];
      if (TANGENT) vi[c] = v[3 * (size_t)i + c];
    }
  }
  const T r2max = r_max * r_max;
  T acc[3] = {T(0), T(0), T(0)};
  const unsigned char* mrow = mask + (size_t)(row ? i : 0) * ld;

  for (int j0 = 0; j0 < n; j0 += CP_TILE) {
    const int m = min(CP_TILE, n - j0);
    __syncthreads();
    for (int t = threadIdx.x; t < m; t += CP_THREADS) {
      const int s = cp_slot(t);
      const size_t o = 3 * (size_t)(j0 + t);
      xs[0][s] = x[o];
      xs[1][s] = x[o + 1];
      xs[2][s] = x[o + 2];
      ws[s] = w[j0 + t];
      if (TANGENT) {
        vs[0][s] = v[o];
        vs[1][s] = v[o + 1];
        vs[2][s] = v[o + 2];
      }
    }
    __syncthreads();
    const int jl = 16 * lane;
    if (!row || jl >= m) continue;
    const uint4 q = *reinterpret_cast<const uint4*>(mrow + j0 + jl);
    const unsigned words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      if (((words[b >> 2] >> (8 * (b & 3))) & 0xffu) == 0u) continue;
      if (jl + b >= m) continue;
      const int s = cp_slot(jl + b);
      const T d0 = xi[0] - xs[0][s], d1 = xi[1] - xs[1][s],
              d2 = xi[2] - xs[2][s];
      const T r2 = d0 * d0 + d1 * d1 + d2 * d2;
      if (!(r2 < r2max)) continue;
      const T r = sqrt(r2);
      const T a = ws[s] * (T(1) - r_max / r);
      if (TANGENT) {
        const T e0 = vi[0] - vs[0][s], e1 = vi[1] - vs[1][s],
                e2 = vi[2] - vs[2][s];
        const T bb = ws[s] * r_max * (d0 * e0 + d1 * e1 + d2 * e2) /
                     (r2 * r);
        acc[0] += a * e0 + bb * d0;
        acc[1] += a * e1 + bb * d1;
        acc[2] += a * e2 + bb * d2;
      } else {
        acc[0] += a * d0;
        acc[1] += a * d1;
        acc[2] += a * d2;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      acc[c] += __shfl_down_sync(0xffffffffu, acc[c], s);
  }
  if (row && lane == 0) {
    const T kw = k * w[i];
    for (int c = 0; c < 3; ++c) out[3 * (size_t)i + c] = kw * acc[c];
  }
}

template <typename T>
cudaError_t contact_pairs_launch(int n, long long ld,
                                 const unsigned char* mask, const T* x,
                                 const T* v, const T* w, double k,
                                 double r_max, T* out, cudaStream_t stream) {
  if (n < 0 || ld < n || ld % 16 != 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int grid = (n + CP_WARPS - 1) / CP_WARPS;
  if (v)
    contact_pairs_kernel<T, true><<<grid, CP_THREADS, 0, stream>>>(
        n, ld, mask, x, v, w, T(k), T(r_max), out);
  else
    contact_pairs_kernel<T, false><<<grid, CP_THREADS, 0, stream>>>(
        n, ld, mask, x, v, w, T(k), T(r_max), out);
  return cudaGetLastError();
}

template cudaError_t contact_pairs_launch<float>(int, long long,
                                                 const unsigned char*,
                                                 const float*, const float*,
                                                 const float*, double, double,
                                                 float*, cudaStream_t);
template cudaError_t contact_pairs_launch<double>(int, long long,
                                                  const unsigned char*,
                                                  const double*,
                                                  const double*,
                                                  const double*, double,
                                                  double, double*,
                                                  cudaStream_t);

}  // namespace tigar
