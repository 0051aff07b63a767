// K15 / K16: sum-factorized jets of tensor-product spline fields and their
// exact transpose.
//
// Replace tigar_tpu/ops/sumfac_forms.py:189 field_jets (the per-direction
// window contractions _fwd_dir :121, _fwd_dir_gather :144, _eval_chains
// :174, one chain per jet column) and :319 SumfacAssembler.scatter_jets
// (jax.linear_transpose of those chains).
//
// K15: for each point of the interleaved quadrature grid (e_{D-1}, q_{D-1},
// ..., e_0, q_0) and each coefficient column c, the value, the D
// parametric first derivatives and (nders 2) the full symmetric Hessian:
//   J_k(pt, c) = sum_{a_0..a_{D-1}} prod_d T_d[e_d, q_d, k_d, a_d]
//                                 W[c, win_0(e_0, a_0), ..., win_{D-1}]
// with the window win_d(e, a) = start_d + stride_d e + a (slide, any
// stride) or idx_d[e][a] (gather, wrapping for periodic knots).  Written
// as the density consumes it: val [npts][M], g [..][D], h [..][D][D]
// (column col0 + c of M; several launches fill one buffer).
// K16: the transpose, owner-computes: one thread per coefficient (and
// column) sums, over the elements whose windows cover it in every
// direction (slide: solved from start/stride; gather: the inverse lists
// the host builds once) and their quadrature points, the jet cotangents
// times the same table products.  Every coefficient is written once: no
// atomics, the sum order is fixed.
//
// Bound: bytes.  K15 writes npts M (1 + D + D^2) values and reads the
// coefficients (about npts / nq^D (p+1)^D-fold re-read from cache); K16
// reads the cotangents once per covering element (from L1/L2) and writes
// each coefficient once.  Design: one thread per (point, column) with the
// contraction done one direction at a time in registers (direction 0 into
// nders+1 partial sums, then 1, then 2), adjacent threads on adjacent
// output rows, so the stores of a warp cover one contiguous range.
#include <cstdint>

#include "kernels.h"

namespace tigar {

namespace {

constexpr int PPMAX = 4;
constexpr int JETS_THREADS = 256;

// the 1D tables of one point in one direction: b[k][a] = T[e][q][k][a]
// (k <= ND, a < pp), and the window's coefficient indices
template <typename T, int ND>
__device__ __forceinline__ void load_dir(const SumfacJetsArgs<T>& A, int d,
                                         int e, int q, T (&b)[ND + 1][PPMAX],
                                         int (&w)[PPMAX]) {
  const int pp = A.pp[d];
  const T* t = A.tab[d] + ((int64_t)(e * A.nq + q) * (ND + 1)) * pp;
#pragma unroll
  for (int k = 0; k <= ND; ++k)
#pragma unroll
    for (int a = 0; a < PPMAX; ++a)
      b[k][a] = a < pp ? t[k * pp + a] : T(0);
#pragma unroll
  for (int a = 0; a < PPMAX; ++a)
    w[a] = a >= pp ? 0
           : A.idx[d] ? A.idx[d][e * pp + a]
                      : A.start[d] + A.stride[d] * e + a;
}

template <typename T, int D, int ND>
__global__ void __launch_bounds__(JETS_THREADS)
sumfac_jets_kernel(SumfacJetsArgs<T> A, const T* __restrict__ W,
                   T* __restrict__ val, T* __restrict__ g,
                   T* __restrict__ h) {
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= A.npts * A.ncols) return;
  const int c = (int)(t % A.ncols);
  const int64_t pt = t / A.ncols;
  int e[3] = {0, 0, 0}, q[3] = {0, 0, 0};
  int64_t rem = pt;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    q[d] = (int)(rem % A.nq);
    rem /= A.nq;
    e[d] = (int)(rem % A.nel[d]);
    rem /= A.nel[d];
  }
  T b[3][ND + 1][PPMAX];
  int w[3][PPMAX];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    if (d < D) {
      load_dir<T, ND>(A, d, e[d], q[d], b[d], w[d]);
    } else {                            // D = 2: a trivial third direction
#pragma unroll
      for (int k = 0; k <= ND; ++k)
#pragma unroll
        for (int a = 0; a < PPMAX; ++a) b[d][k][a] = (k == 0 && a == 0);
#pragma unroll
      for (int a = 0; a < PPMAX; ++a) w[d][a] = 0;
    }
  }
  const int pp0 = A.pp[0], pp1 = A.pp[1], pp2 = D == 3 ? A.pp[2] : 1;
  const T* Wc = W + A.base + c * A.col_stride;
  T u[ND + 1][ND + 1][ND + 1];
#pragma unroll
  for (int i = 0; i <= ND; ++i)
#pragma unroll
    for (int j = 0; j <= ND; ++j)
#pragma unroll
      for (int k = 0; k <= ND; ++k) u[i][j][k] = T(0);
#pragma unroll
  for (int a2 = 0; a2 < PPMAX; ++a2) {
    if (a2 >= pp2) break;
    T t2[ND + 1][ND + 1];
#pragma unroll
    for (int i = 0; i <= ND; ++i)
#pragma unroll
      for (int j = 0; j <= ND; ++j) t2[i][j] = T(0);
#pragma unroll
    for (int a1 = 0; a1 < PPMAX; ++a1) {
      if (a1 >= pp1) break;
      const int64_t row =
          ((int64_t)w[2][a2] * A.ncp[1] + w[1][a1]) * A.ncp[0];
      T s[ND + 1];
#pragma unroll
      for (int i = 0; i <= ND; ++i) s[i] = T(0);
#pragma unroll
      for (int a0 = 0; a0 < PPMAX; ++a0) {
        if (a0 >= pp0) break;
        const T x = Wc[(row + w[0][a0]) * A.cp_stride];
#pragma unroll
        for (int i = 0; i <= ND; ++i) s[i] += b[0][i][a0] * x;
      }
#pragma unroll
      for (int i = 0; i <= ND; ++i)
#pragma unroll
        for (int j = 0; i + j <= ND; ++j) t2[i][j] += s[i] * b[1][j][a1];
    }
#pragma unroll
    for (int i = 0; i <= ND; ++i)
#pragma unroll
      for (int j = 0; i + j <= ND; ++j)
#pragma unroll
        for (int k = 0; i + j + k <= ND; ++k)
          u[i][j][k] += t2[i][j] * b[2][k][a2];
  }
  const int64_t o = pt * A.M + A.col0 + c;
  val[o] = u[0][0][0];
  g[o * D + 0] = u[1][0][0];
  g[o * D + 1] = u[0][1][0];
  if (D == 3) g[o * D + 2] = u[0][0][1];
  if constexpr (ND >= 2) {
#pragma unroll
    for (int d1 = 0; d1 < D; ++d1)
#pragma unroll
      for (int d2 = 0; d2 < D; ++d2)
        h[(o * D + d1) * D + d2] = u[(d1 == 0) + (d2 == 0)]
                                    [(d1 == 1) + (d2 == 1)]
                                    [(d1 == 2) + (d2 == 2)];
  }
}

// the k-th candidate (element e, window slot a) covering coefficient index
// i in direction d; false when the candidate does not cover it.  Slide:
// k in [0, pp); gather: k in [inv[i], inv[i + 1]).
template <typename T>
__device__ __forceinline__ bool cover(const SumfacJetsArgs<T>& A, int d,
                                      int i, int k, int& e, int& a) {
  if (A.inv[d]) {
    const int ent = A.inv[d][A.ncp[d] + 1 + k];
    e = ent / A.pp[d];
    a = ent % A.pp[d];
    return true;
  }
  a = k;
  const int n = i - A.start[d] - k;
  if (n < 0 || n % A.stride[d] != 0) return false;
  e = n / A.stride[d];
  return e < A.nel[d];
}

template <typename T>
__device__ __forceinline__ void cover_range(const SumfacJetsArgs<T>& A,
                                            int d, int i, int& k0, int& k1) {
  if (A.inv[d]) {
    k0 = A.inv[d][i];
    k1 = A.inv[d][i + 1];
  } else {
    k0 = 0;
    k1 = A.pp[d];
  }
}

template <typename T, int ND>
__device__ __forceinline__ void table_at(const SumfacJetsArgs<T>& A, int d,
                                         int e, int q, int a,
                                         T (&b)[ND + 1]) {
  const int pp = A.pp[d];
  const T* t = A.tab[d] + ((int64_t)(e * A.nq + q) * (ND + 1)) * pp + a;
#pragma unroll
  for (int k = 0; k <= ND; ++k) b[k] = t[k * pp];
}

template <typename T, int D, int ND>
__global__ void __launch_bounds__(JETS_THREADS)
sumfac_scatter_jets_kernel(SumfacJetsArgs<T> A, const T* __restrict__ cval,
                           const T* __restrict__ cg,
                           const T* __restrict__ ch, T* __restrict__ out) {
  const int64_t ncp_tot =
      (int64_t)A.ncp[0] * A.ncp[1] * (D == 3 ? A.ncp[2] : 1);
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= ncp_tot * A.ncols) return;
  const int64_t i = t % ncp_tot;
  const int c = (int)(t / ncp_tot);
  const int i0 = (int)(i % A.ncp[0]);
  const int i1 = (int)((i / A.ncp[0]) % A.ncp[1]);
  const int i2 = D == 3 ? (int)(i / ((int64_t)A.ncp[0] * A.ncp[1])) : 0;
  const int64_t oc = A.col0 + c;
  int r0a, r0b, r1a, r1b, r2a = 0, r2b = 1;
  cover_range(A, 0, i0, r0a, r0b);
  cover_range(A, 1, i1, r1a, r1b);
  if (D == 3) cover_range(A, 2, i2, r2a, r2b);
  const int nq = A.nq, nq2 = D == 3 ? nq : 1;
  T acc = T(0);
  for (int k2 = r2a; k2 < r2b; ++k2) {
    int e2 = 0, a2 = 0;
    if (D == 3 && !cover(A, 2, i2, k2, e2, a2)) continue;
    for (int q2 = 0; q2 < nq2; ++q2) {
      T b2[ND + 1];
      if (D == 3) {
        table_at<T, ND>(A, 2, e2, q2, a2, b2);
      } else {
#pragma unroll
        for (int k = 0; k <= ND; ++k) b2[k] = T(k == 0);
      }
      const int64_t base2 = (int64_t)e2 * nq + q2;
      for (int k1 = r1a; k1 < r1b; ++k1) {
        int e1, a1;
        if (!cover(A, 1, i1, k1, e1, a1)) continue;
        for (int q1 = 0; q1 < nq; ++q1) {
          T b1[ND + 1];
          table_at<T, ND>(A, 1, e1, q1, a1, b1);
          const int64_t base1 = (base2 * A.nel[1] + e1) * nq + q1;
          for (int k0 = r0a; k0 < r0b; ++k0) {
            int e0, a0;
            if (!cover(A, 0, i0, k0, e0, a0)) continue;
            const int64_t base0 = (base1 * A.nel[0] + e0) * nq;
            for (int q0 = 0; q0 < nq; ++q0) {
              T b0[ND + 1];
              table_at<T, ND>(A, 0, e0, q0, a0, b0);
              const int64_t o = (base0 + q0) * A.M + oc;
              T s = cval[o] * b0[0] * b1[0] * b2[0];
              s += cg[o * D + 0] * b0[1] * b1[0] * b2[0];
              s += cg[o * D + 1] * b0[0] * b1[1] * b2[0];
              if (D == 3) s += cg[o * D + 2] * b0[0] * b1[0] * b2[1];
              if constexpr (ND >= 2) {
                const T* hh = ch + o * D * D;
                // the symmetric fill's transpose: (d1, d2) and (d2, d1)
                // share one table product
                s += hh[0] * b0[2] * b1[0] * b2[0];
                s += (hh[1] + hh[D]) * b0[1] * b1[1] * b2[0];
                s += hh[D + 1] * b0[0] * b1[2] * b2[0];
                if (D == 3) {
                  s += (hh[2] + hh[6]) * b0[1] * b1[0] * b2[1];
                  s += (hh[5] + hh[7]) * b0[0] * b1[1] * b2[1];
                  s += hh[8] * b0[0] * b1[0] * b2[2];
                }
              }
              acc += s;
            }
          }
        }
      }
    }
  }
  out[A.base + c * A.col_stride + i * A.cp_stride] = acc;
}

int blocks_for(int64_t n) {
  return (int)((n + JETS_THREADS - 1) / JETS_THREADS);
}

}  // namespace

template <typename T>
cudaError_t sumfac_jets_launch(const SumfacJetsArgs<T>& a, const T* W,
                               T* val, T* g, T* h, cudaStream_t stream) {
  const int64_t n = a.npts * a.ncols;
  if (n == 0) return cudaSuccess;
  const int grid = blocks_for(n);
  if (a.dim == 2 && a.nders == 1)
    sumfac_jets_kernel<T, 2, 1>
        <<<grid, JETS_THREADS, 0, stream>>>(a, W, val, g, h);
  else if (a.dim == 2 && a.nders == 2)
    sumfac_jets_kernel<T, 2, 2>
        <<<grid, JETS_THREADS, 0, stream>>>(a, W, val, g, h);
  else if (a.dim == 3 && a.nders == 1)
    sumfac_jets_kernel<T, 3, 1>
        <<<grid, JETS_THREADS, 0, stream>>>(a, W, val, g, h);
  else if (a.dim == 3 && a.nders == 2)
    sumfac_jets_kernel<T, 3, 2>
        <<<grid, JETS_THREADS, 0, stream>>>(a, W, val, g, h);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <typename T>
cudaError_t sumfac_scatter_jets_launch(const SumfacJetsArgs<T>& a,
                                       const T* cval, const T* cg,
                                       const T* ch, T* out,
                                       cudaStream_t stream) {
  const int64_t n = (int64_t)a.ncp[0] * a.ncp[1] *
                    (a.dim == 3 ? a.ncp[2] : 1) * a.ncols;
  if (n == 0) return cudaSuccess;
  const int grid = blocks_for(n);
  if (a.dim == 2 && a.nders == 1)
    sumfac_scatter_jets_kernel<T, 2, 1>
        <<<grid, JETS_THREADS, 0, stream>>>(a, cval, cg, ch, out);
  else if (a.dim == 2 && a.nders == 2)
    sumfac_scatter_jets_kernel<T, 2, 2>
        <<<grid, JETS_THREADS, 0, stream>>>(a, cval, cg, ch, out);
  else if (a.dim == 3 && a.nders == 1)
    sumfac_scatter_jets_kernel<T, 3, 1>
        <<<grid, JETS_THREADS, 0, stream>>>(a, cval, cg, ch, out);
  else if (a.dim == 3 && a.nders == 2)
    sumfac_scatter_jets_kernel<T, 3, 2>
        <<<grid, JETS_THREADS, 0, stream>>>(a, cval, cg, ch, out);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template cudaError_t sumfac_jets_launch<float>(const SumfacJetsArgs<float>&,
                                               const float*, float*, float*,
                                               float*, cudaStream_t);
template cudaError_t sumfac_jets_launch<double>(
    const SumfacJetsArgs<double>&, const double*, double*, double*, double*,
    cudaStream_t);
template cudaError_t sumfac_scatter_jets_launch<float>(
    const SumfacJetsArgs<float>&, const float*, const float*, const float*,
    float*, cudaStream_t);
template cudaError_t sumfac_scatter_jets_launch<double>(
    const SumfacJetsArgs<double>&, const double*, const double*,
    const double*, double*, cudaStream_t);

}  // namespace tigar
