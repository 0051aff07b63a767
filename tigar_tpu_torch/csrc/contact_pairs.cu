// K13 / K14: all-pairs penalty self-contact between collocation points.
//
// Replaces tigar_tpu/contact.py:205 _contact_residual (jax.grad of
// PointContact.energy) and :210 _contact_tangent (its jvp), on the
// pair-space side: n points x [n][3], lumped weights w [n], the static
// exclusion mask live [n][n] (symmetric by construction), and the
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
// The mask comes as bits (ops/contact.py pair_bits): tiles of 32
// consecutive points, words [nt][n] with bit b of words[J][i] the pair
// (i, 32 J + b), zero beyond n (by symmetry the bits of row i's columns
// in tile J), and tiles [nt][nt], nonzero where a tile pair holds a live
// pair.  Bound: the words (n^2 / 8 bytes, 11.5 MB at the reference
// workload's n = 9,604) against ~8 operations a live pair for the
// distance test and ~20 / ~40 more for an interacting one; the
// measurement counts both from its own data.
//
// Design: a first launch takes each tile's axis-aligned box at the current
// positions.  The pair launch gives a block R = CP_ROWS row tiles (lane l
// of every warp carries rows 32 I_r + l, r < R, in registers) and W
// warps; the block's warps and the grid's column splits (about 16 warps
// an SM in all) share out the column tiles.  R = 2 measured best of 1, 2,
// 4 and 8 (scripts/k14_designs.py).
// A warp skips a (row tile, column tile) pair when its boxes lie at least
// r_max apart (with a margin of a few roundings, so every skipped pair
// fails the kernel's own r2 < r_max^2) or none of its pairs is live: a
// skipped pair adds exactly zero, so only the order of the nonzero terms
// changes.  For a column tile that any of its R row tiles keeps, each lane
// stages one point of it in the warp's shared slots and reads its mask
// words (coalesced); then every staged point, read by broadcast, serves R
// rows a lane.  The W warps' sums meet in shared memory in a fixed order;
// with column splits, each block writes its rows' partial sums and the
// block that finishes a row group last (a counter per group, zeroed by
// the first launch) adds the splits in order: no atomics on the result,
// so it is deterministic.
#include "kernels.h"

namespace tigar {

constexpr int CP_TILE = 32;   // points a tile: one mask word a row
constexpr int CP_ROWS = 2;    // row tiles a block (rows a lane)
constexpr int CP_WARPS = 4;   // warps a block

template <typename T>
struct alignas(4 * sizeof(T)) CpPoint {
  T a, b, c, d;
};

// one warp a tile: boxes [nt][6] = lo xyz, hi xyz; done[g] = 0
template <typename T>
__global__ void __launch_bounds__(256)
contact_boxes_kernel(int n, int nt, int ngroups, const T* __restrict__ x,
                     T* __restrict__ boxes, int* __restrict__ done) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < ngroups) done[t] = 0;
  const int J = t / 32, lane = t % 32;
  if (J >= nt) return;
  const int j = J * CP_TILE + lane;
  const bool in = j < n;
  T lo[3], hi[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const T xc = in ? x[3 * (size_t)j + c] : T(0);
    lo[c] = in ? xc : T(INFINITY);
    hi[c] = in ? xc : -T(INFINITY);
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      lo[c] = min(lo[c], __shfl_xor_sync(0xffffffffu, lo[c], s));
      hi[c] = max(hi[c], __shfl_xor_sync(0xffffffffu, hi[c], s));
    }
  }
  if (lane < 6) boxes[6 * (size_t)J + lane] = lane < 3 ? lo[lane] : hi[lane - 3];
}

template <typename T, bool TANGENT, int R, int W>
__global__ void __launch_bounds__(32 * W)
contact_pairs_kernel(int n, int nt, const unsigned* __restrict__ words,
                     const unsigned char* __restrict__ tiles,
                     const T* __restrict__ boxes, const T* __restrict__ x,
                     const T* __restrict__ v, const T* __restrict__ w, T k,
                     T r_max, T r2cull, T* __restrict__ partial,
                     int* __restrict__ done, T* __restrict__ out) {
  __shared__ CpPoint<T> sx[W][CP_TILE];
  __shared__ CpPoint<T> sv[TANGENT ? W : 1][CP_TILE];
  __shared__ T red[W > 1 ? W - 1 : 1][3][R * CP_TILE];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = blockIdx.x, split = blockIdx.y, nsplit = gridDim.y;
  const T r2max = r_max * r_max;

  T xi[R][3], vi[R][3], acc[R][3], blo[R][3], bhi[R][3];
  bool rt[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int I = g * R + r, i = I * CP_TILE + lane;
    rt[r] = I < nt;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      xi[r][c] = i < n ? x[3 * (size_t)i + c] : T(0);
      vi[r][c] = TANGENT && i < n ? v[3 * (size_t)i + c] : T(0);
      acc[r][c] = T(0);
      blo[r][c] = rt[r] ? boxes[6 * (size_t)I + c] : T(0);
      bhi[r][c] = rt[r] ? boxes[6 * (size_t)I + 3 + c] : T(0);
    }
  }

  for (int J = split + nsplit * warp; J < nt; J += nsplit * W) {
    T jlo[3], jhi[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      jlo[c] = boxes[6 * (size_t)J + c];
      jhi[c] = boxes[6 * (size_t)J + 3 + c];
    }
    unsigned wd[R];
    bool any = false;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int I = g * R + r, i = I * CP_TILE + lane;
      bool keep = rt[r] && tiles[(size_t)(rt[r] ? I : 0) * nt + J] != 0;
      T g2 = T(0);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const T gap = max(max(jlo[c] - bhi[r][c], blo[r][c] - jhi[c]), T(0));
        g2 += gap * gap;
      }
      keep = keep && g2 < r2cull;
      wd[r] = keep && i < n ? words[(size_t)J * n + i] : 0u;
      any = any || keep;
    }
    if (!any) continue;   // the same for every lane of the warp
    const int j = J * CP_TILE + lane;
    CpPoint<T> p = {T(0), T(0), T(0), T(0)}, q = {T(0), T(0), T(0), T(0)};
    if (j < n) {
      p = {x[3 * (size_t)j], x[3 * (size_t)j + 1], x[3 * (size_t)j + 2],
           w[j]};
      if (TANGENT)
        q = {v[3 * (size_t)j], v[3 * (size_t)j + 1], v[3 * (size_t)j + 2],
             T(0)};
    }
    sx[warp][lane] = p;
    if (TANGENT) sv[warp][lane] = q;
    __syncwarp();
#pragma unroll 4
    for (int b = 0; b < CP_TILE; ++b) {
      const CpPoint<T> pj = sx[warp][b];
      CpPoint<T> qj;
      if (TANGENT) qj = sv[warp][b];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const T d0 = xi[r][0] - pj.a, d1 = xi[r][1] - pj.b,
                d2 = xi[r][2] - pj.c;
        const T r2 = d0 * d0 + d1 * d1 + d2 * d2;
        if (((wd[r] >> b) & 1u) && r2 < r2max) {
          const T ir = rsqrt(r2);
          const T a = pj.d * (T(1) - r_max * ir);
          if (TANGENT) {
            const T e0 = vi[r][0] - qj.a, e1 = vi[r][1] - qj.b,
                    e2 = vi[r][2] - qj.c;
            const T bb = pj.d * r_max * (d0 * e0 + d1 * e1 + d2 * e2) *
                         (ir * ir * ir);
            acc[r][0] += a * e0 + bb * d0;
            acc[r][1] += a * e1 + bb * d1;
            acc[r][2] += a * e2 + bb * d2;
          } else {
            acc[r][0] += a * d0;
            acc[r][1] += a * d1;
            acc[r][2] += a * d2;
          }
        }
      }
    }
    __syncwarp();
  }

  // the block's warps, in order
  if (warp > 0) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) red[warp - 1][c][r * CP_TILE + lane] = acc[r][c];
  }
  __syncthreads();
  if (warp > 0) return;
#pragma unroll
  for (int u = 1; u < W; ++u)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[r][c] += red[u - 1][c][r * CP_TILE + lane];

  if (nsplit > 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = (g * R + r) * CP_TILE + lane;
      if (i < n)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          partial[(3 * ((size_t)split * n + i)) + c] = acc[r][c];
    }
    __threadfence();
    int last = 0;
    if (lane == 0) last = atomicAdd(done + g, 1) == nsplit - 1;
    if (!__shfl_sync(0xffffffffu, last, 0)) return;
    __threadfence();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = (g * R + r) * CP_TILE + lane;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        T s = T(0);
        for (int u = 0; u < nsplit; ++u)
          s += i < n ? __ldcg(partial + 3 * ((size_t)u * n + i) + c) : T(0);
        acc[r][c] = s;
      }
    }
    if (lane == 0) done[g] = 0;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = (g * R + r) * CP_TILE + lane;
    if (i < n) {
      const T kw = k * w[i];
#pragma unroll
      for (int c = 0; c < 3; ++c) out[3 * (size_t)i + c] = kw * acc[r][c];
    }
  }
}

int contact_splits(int n) {
  const int nt = (n + CP_TILE - 1) / CP_TILE;
  const int ng = (nt + CP_ROWS - 1) / CP_ROWS;
  // about 16 warps an SM, and no more splits than column tiles
  const int want = (16 * sm_count() + ng * CP_WARPS - 1) / (ng * CP_WARPS);
  return std::max(1, std::min(want, nt));
}

int contact_groups(int n) {
  const int nt = (n + CP_TILE - 1) / CP_TILE;
  return (nt + CP_ROWS - 1) / CP_ROWS;
}

template <typename T>
cudaError_t contact_pairs_launch(int n, const unsigned* words,
                                 const unsigned char* tiles, const T* x,
                                 const T* v, const T* w, double k,
                                 double r_max, int nsplit, T* boxes,
                                 T* partial, int* done, T* out,
                                 cudaStream_t stream) {
  if (n < 0 || nsplit < 1) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int nt = (n + CP_TILE - 1) / CP_TILE, ng = contact_groups(n);
  const int nb = std::max(nt * 32, ng);
  contact_boxes_kernel<T><<<(nb + 255) / 256, 256, 0, stream>>>(
      n, nt, ng, x, boxes, done);
  // cull only pairs of boxes clear of r_max by a few roundings of r2
  const double eps = sizeof(T) == 4 ? 1e-6 : 1e-14;
  const T r2cull = T(r_max * r_max * (1.0 + eps));
  const dim3 grid(ng, nsplit);
  if (v)
    contact_pairs_kernel<T, true, CP_ROWS, CP_WARPS>
        <<<grid, 32 * CP_WARPS, 0, stream>>>(n, nt, words, tiles, boxes, x,
                                             v, w, T(k), T(r_max), r2cull,
                                             partial, done, out);
  else
    contact_pairs_kernel<T, false, CP_ROWS, CP_WARPS>
        <<<grid, 32 * CP_WARPS, 0, stream>>>(n, nt, words, tiles, boxes, x,
                                             v, w, T(k), T(r_max), r2cull,
                                             partial, done, out);
  return cudaGetLastError();
}

template cudaError_t contact_pairs_launch<float>(
    int, const unsigned*, const unsigned char*, const float*, const float*,
    const float*, double, double, int, float*, float*, int*, float*,
    cudaStream_t);
template cudaError_t contact_pairs_launch<double>(
    int, const unsigned*, const unsigned char*, const double*, const double*,
    const double*, double, double, int, double*, double*, int*, double*,
    cudaStream_t);

}  // namespace tigar
