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
// K16: the transpose, in two passes, each owning what it writes.  Pass 1,
// element-local: a thread (element, column, slot a0) reads its element's
// cotangents (L1 serves the element's pp0 threads and a point's
// components; staging them in shared memory with cp.async measured
// slower, scripts/k16_designs.py) and contracts one direction at a time in
// registers (q0 against T0 with the Hessian's (d1, d2) and (d2, d1) folded
// into one table product, then q1 against T1, then q2 against T2), writing
// the element's pp^D window slots to a scratch [pp_{D-1}]..[pp_0][column]
// [element] array (L2-resident).  Pass 2: one thread per coefficient (and
// column) sums the slots of the elements whose windows cover it in every
// direction (slide: solved from start/stride; gather: the inverse lists
// the host builds once) in a fixed order and writes it once: no atomics,
// the sum order is fixed.
//
// Bound: bytes.  K15 writes npts M (1 + D + D^2) values and reads the
// coefficients (about npts / nq^D (p+1)^D-fold re-read from cache); K16
// reads the cotangents once (pass 1) and writes each coefficient once
// (pass 2), the scratch (npts (pp/nq)^D values a column) in between.
// K15's design: one thread per (point, column) with the contraction done
// one direction at a time in registers (direction 0 into nders+1 partial
// sums, then 1, then 2), adjacent threads on adjacent output rows, so the
// stores of a warp cover one contiguous range.
#include <algorithm>
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

// -- K16 --------------------------------------------------------------------

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
  const int n = i - A.start[d] - k, s = A.stride[d];
  if (n < 0) return false;
  if (s == 1) {
    e = n;
  } else if (s == 2) {            // continuity drop 1: no division
    if (n & 1) return false;
    e = n >> 1;
  } else {
    if (n % s != 0) return false;
    e = n / s;
  }
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

// K16, pass 1: element-local contributions local[a2][a1][a0][c][e] =
// sum over the element's points of the cotangents times the table
// products.  A block takes e0c elements of one row of the element grid
// (e1, e2 fixed) and cc columns, a thread (column, a0, e0), which reads
// its element's cotangents straight from device memory (L1 serves the
// pp0 threads of an element and the components of a point) and contracts
// one direction at a time in registers: over q0 with T0 into G0 (the
// Hessian's (d1, d2) and (d2, d1) share one table product), over q1 with
// T1 into G1, over q2 with T2 into L.  NQ: the points a direction (2-4
// unrolled, 0 any).
template <typename T, int D, int ND, int NQ>
__global__ void __launch_bounds__(JETS_THREADS)
sumfac_scatter_jets_local(SumfacJetsArgs<T> A, const T* __restrict__ cval,
                          const T* __restrict__ cg,
                          const T* __restrict__ ch, T* __restrict__ local,
                          int e0c, int cc) {
  constexpr int NK = ND + 1;
  const int nq = NQ ? NQ : A.nq;
  const int pp0 = A.pp[0], pp1 = A.pp[1];
  const int pp2 = D == 3 ? A.pp[2] : 1;
  const int nel0 = A.nel[0], nel1 = A.nel[1], nel2 = D == 3 ? A.nel[2] : 1;
  const int nch0 = (nel0 + e0c - 1) / e0c;
  int blk = blockIdx.x;
  const int e0a = (blk % nch0) * e0c;
  blk /= nch0;
  const int e1 = blk % nel1;
  blk /= nel1;
  const int e2 = blk % nel2;
  // the column fastest, then a0: the threads that read one point's
  // values sit in one warp
  const int c = (blk / nel2) * cc + threadIdx.x % cc;
  const int a0 = (threadIdx.x / cc) % pp0;
  const int e0 = e0a + threadIdx.x / (cc * pp0);
  if (e0 >= nel0 || c >= A.ncols || a0 >= pp0) return;
  const int M = A.M, col = A.col0 + c;
  const T* t0 = A.tab[0] + (int64_t)e0 * nq * NK * pp0 + a0;
  const T* t1 = A.tab[1] + (int64_t)e1 * nq * NK * pp1;
  const T* t2 = D == 3 ? A.tab[2] + (int64_t)e2 * nq * NK * pp2 : nullptr;
  T L[PPMAX][PPMAX];
#pragma unroll
  for (int i = 0; i < PPMAX; ++i)
#pragma unroll
    for (int j = 0; j < PPMAX; ++j) L[i][j] = T(0);
  for (int q2 = 0; q2 < (D == 3 ? nq : 1); ++q2) {
    T G1[PPMAX][NK];
#pragma unroll
    for (int i = 0; i < PPMAX; ++i)
#pragma unroll
      for (int k = 0; k < NK; ++k) G1[i][k] = T(0);
    for (int q1 = 0; q1 < nq; ++q1) {
      const int64_t pt =
          (((((int64_t)e2 * nq + q2) * nel1 + e1) * nq + q1) * nel0 + e0) *
          nq;
      // over q0: G0[k1][k2] = sum_{q0, k0} F(k0, k1, k2) T0[q0][k0][a0]
      T G0[NK][NK];
#pragma unroll
      for (int i = 0; i < NK; ++i)
#pragma unroll
        for (int j = 0; j < NK; ++j) G0[i][j] = T(0);
#pragma unroll
      for (int q0 = 0; q0 < (NQ ? NQ : 1); ++q0) {
        for (int qr = q0; qr < nq; qr += (NQ ? NQ : 1)) {
          const int64_t o = (pt + qr) * M + col;
          T t[NK];
#pragma unroll
          for (int k = 0; k < NK; ++k) t[k] = __ldg(t0 + (qr * NK + k) * pp0);
          const T* g = cg + o * D;
          G0[0][0] += __ldg(cval + o) * t[0] + __ldg(g) * t[1];
          G0[1][0] += __ldg(g + 1) * t[0];
          if (D == 3) G0[0][1] += __ldg(g + 2) * t[0];
          if constexpr (ND >= 2) {
            const T* h = ch + o * D * D;
            G0[0][0] += __ldg(h) * t[2];
            G0[1][0] += (__ldg(h + 1) + __ldg(h + D)) * t[1];
            G0[2][0] += __ldg(h + D + 1) * t[0];
            if (D == 3) {
              G0[0][1] += (__ldg(h + 2) + __ldg(h + 6)) * t[1];
              G0[1][1] += (__ldg(h + 5) + __ldg(h + 7)) * t[0];
              G0[0][2] += __ldg(h + 8) * t[0];
            }
          }
          if (NQ) break;
        }
      }
      // over q1: G1[a1][k2] += sum_k1 G0[k1][k2] T1[q1][k1][a1]
#pragma unroll
      for (int a1 = 0; a1 < PPMAX; ++a1) {
        if (a1 >= pp1) break;
#pragma unroll
        for (int k2 = 0; k2 < (D == 3 ? NK : 1); ++k2)
#pragma unroll
          for (int k1 = 0; k1 + k2 < NK; ++k1)
            G1[a1][k2] += G0[k1][k2] * __ldg(t1 + (q1 * NK + k1) * pp1 + a1);
      }
    }
    // over q2
#pragma unroll
    for (int a1 = 0; a1 < PPMAX; ++a1) {
      if (a1 >= pp1) break;
      if (D == 3) {
#pragma unroll
        for (int a2 = 0; a2 < PPMAX; ++a2) {
          if (a2 >= pp2) break;
#pragma unroll
          for (int k2 = 0; k2 < NK; ++k2)
            L[a2][a1] += G1[a1][k2] * __ldg(t2 + (q2 * NK + k2) * pp2 + a2);
        }
      } else {
        L[0][a1] += G1[a1][0];
      }
    }
  }
  const int64_t nel = (int64_t)nel0 * nel1 * nel2;
  const int64_t e = ((int64_t)e2 * nel1 + e1) * nel0 + e0;
#pragma unroll
  for (int a2 = 0; a2 < PPMAX; ++a2) {
    if (a2 >= pp2) break;
#pragma unroll
    for (int a1 = 0; a1 < PPMAX; ++a1) {
      if (a1 >= pp1) break;
      local[((((int64_t)a2 * pp1 + a1) * pp0 + a0) * A.ncols + c) * nel + e] =
          L[a2][a1];
    }
  }
}

// the candidates of coefficient index i in direction d, in cover's order:
// ok[k] and (e[k], a[k]) for k < PPMAX; false when there are more than
// PPMAX of them (a gather window that wraps onto itself)
template <typename T>
__device__ __forceinline__ bool cover_list(const SumfacJetsArgs<T>& A,
                                           int d, int i, bool (&ok)[PPMAX],
                                           int (&e)[PPMAX],
                                           int (&a)[PPMAX]) {
  int k0, k1;
  cover_range(A, d, i, k0, k1);
  if (k1 - k0 > PPMAX) return false;
#pragma unroll
  for (int k = 0; k < PPMAX; ++k)
    ok[k] = k0 + k < k1 && cover(A, d, i, k0 + k, e[k], a[k]);
  return true;
}

// K16, pass 2: one thread a (coefficient, column), coefficient index 0
// fastest, sums the element-local slots that cover it in every direction
// (slide: solved from start / stride; gather: the inverse lists) in a
// fixed order and writes it once.  Each direction's candidates are listed
// in registers first (faster than finding them as the sum goes,
// scripts/k16_designs.py); a gather window that wraps onto itself has
// more than PPMAX of them and takes the walking loop.
template <typename T, int D>
__global__ void __launch_bounds__(JETS_THREADS)
sumfac_scatter_jets_gather(SumfacJetsArgs<T> A,
                           const T* __restrict__ local,
                           T* __restrict__ out) {
  const int64_t ncp_tot =
      (int64_t)A.ncp[0] * A.ncp[1] * (D == 3 ? A.ncp[2] : 1);
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= ncp_tot * A.ncols) return;
  const int64_t i = t % ncp_tot;
  const int c = (int)(t / ncp_tot);
  int ix[3];
  ix[0] = (int)(i % A.ncp[0]);
  ix[1] = (int)((i / A.ncp[0]) % A.ncp[1]);
  ix[2] = D == 3 ? (int)(i / ((int64_t)A.ncp[0] * A.ncp[1])) : 0;
  const int pp0 = A.pp[0], pp1 = A.pp[1];
  const int nel0 = A.nel[0], nel1 = A.nel[1];
  const int64_t nel = (int64_t)nel0 * nel1 * (D == 3 ? A.nel[2] : 1);
  const T* lc = local + (int64_t)c * nel;
  const int64_t cs = (int64_t)A.ncols * nel;        // stride of a slot
  T acc = T(0);
  // each direction's candidates, found once
  bool ok[3][PPMAX];
  int ce[3][PPMAX], ca[3][PPMAX];
  bool listed = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    if (d < D) {
      listed = listed && cover_list(A, d, ix[d], ok[d], ce[d], ca[d]);
    } else {                            // D = 2: one trivial candidate
#pragma unroll
      for (int k = 0; k < PPMAX; ++k) {
        ok[d][k] = k == 0;
        ce[d][k] = ca[d][k] = 0;
      }
    }
  }
  if (listed) {
#pragma unroll
    for (int k2 = 0; k2 < PPMAX; ++k2) {
      if (!ok[2][k2]) continue;
#pragma unroll
      for (int k1 = 0; k1 < PPMAX; ++k1) {
        if (!ok[1][k1]) continue;
        const int64_t s1 = (int64_t)ca[2][k2] * pp1 + ca[1][k1];
        const int64_t row = ((int64_t)ce[2][k2] * nel1 + ce[1][k1]) * nel0;
#pragma unroll
        for (int k0 = 0; k0 < PPMAX; ++k0)
          if (ok[0][k0])
            acc += __ldg(lc + (s1 * pp0 + ca[0][k0]) * cs + row + ce[0][k0]);
      }
    }
  } else {                  // the same sum, the pairs found as it goes
    int r0a, r0b, r1a, r1b, r2a = 0, r2b = 1;
    cover_range(A, 0, ix[0], r0a, r0b);
    cover_range(A, 1, ix[1], r1a, r1b);
    if (D == 3) cover_range(A, 2, ix[2], r2a, r2b);
    for (int k2 = r2a; k2 < r2b; ++k2) {
      int e2 = 0, a2 = 0;
      if (D == 3 && !cover(A, 2, ix[2], k2, e2, a2)) continue;
      for (int k1 = r1a; k1 < r1b; ++k1) {
        int e1, a1;
        if (!cover(A, 1, ix[1], k1, e1, a1)) continue;
        const int64_t s1 = (int64_t)a2 * pp1 + a1;
        const int64_t row = ((int64_t)e2 * nel1 + e1) * nel0;
        for (int k0 = r0a; k0 < r0b; ++k0) {
          int e0, a0;
          if (!cover(A, 0, ix[0], k0, e0, a0)) continue;
          acc += __ldg(lc + (s1 * pp0 + a0) * cs + row + e0);
        }
      }
    }
  }
  out[A.base + c * A.col_stride + i * A.cp_stride] = acc;
}

int blocks_for(int64_t n) {
  return (int)((n + JETS_THREADS - 1) / JETS_THREADS);
}

// pass 1's block: cc columns (up to all of them) and e0c elements of a row
// of the grid, at most LOCAL_THREADS threads, the row cut into equal runs
constexpr int LOCAL_THREADS = 128;

template <typename T, int D, int ND, int NQ>
cudaError_t scatter_local_nq(const SumfacJetsArgs<T>& a, const T* cval,
                             const T* cg, const T* ch, T* local,
                             cudaStream_t stream) {
  const int pp0 = a.pp[0];
  const int cc = std::min(a.ncols, std::max(1, LOCAL_THREADS / pp0));
  const int most = std::max(1, LOCAL_THREADS / (cc * pp0));
  const int nch0 = (a.nel[0] + most - 1) / most;
  const int e0c = (a.nel[0] + nch0 - 1) / nch0;
  const int64_t blocks = (int64_t)nch0 * a.nel[1] * (D == 3 ? a.nel[2] : 1) *
                         ((a.ncols + cc - 1) / cc);
  sumfac_scatter_jets_local<T, D, ND, NQ>
      <<<(unsigned)blocks, e0c * cc * pp0, 0, stream>>>(a, cval, cg, ch,
                                                        local, e0c, cc);
  return cudaGetLastError();
}

template <typename T, int D, int ND>
cudaError_t scatter_local(const SumfacJetsArgs<T>& a, const T* cval,
                          const T* cg, const T* ch, T* local,
                          cudaStream_t stream) {
  switch (a.nq) {
    case 2:
      return scatter_local_nq<T, D, ND, 2>(a, cval, cg, ch, local, stream);
    case 3:
      return scatter_local_nq<T, D, ND, 3>(a, cval, cg, ch, local, stream);
    case 4:
      return scatter_local_nq<T, D, ND, 4>(a, cval, cg, ch, local, stream);
    default:
      return scatter_local_nq<T, D, ND, 0>(a, cval, cg, ch, local, stream);
  }
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
                                       const T* ch, T* local, T* out,
                                       cudaStream_t stream) {
  const int64_t n = (int64_t)a.ncp[0] * a.ncp[1] *
                    (a.dim == 3 ? a.ncp[2] : 1) * a.ncols;
  if (n == 0) return cudaSuccess;
  cudaError_t err;
  if (a.dim == 2 && a.nders == 1)
    err = scatter_local<T, 2, 1>(a, cval, cg, ch, local, stream);
  else if (a.dim == 2 && a.nders == 2)
    err = scatter_local<T, 2, 2>(a, cval, cg, ch, local, stream);
  else if (a.dim == 3 && a.nders == 1)
    err = scatter_local<T, 3, 1>(a, cval, cg, ch, local, stream);
  else if (a.dim == 3 && a.nders == 2)
    err = scatter_local<T, 3, 2>(a, cval, cg, ch, local, stream);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  if (a.dim == 2)
    sumfac_scatter_jets_gather<T, 2>
        <<<blocks_for(n), JETS_THREADS, 0, stream>>>(a, local, out);
  else
    sumfac_scatter_jets_gather<T, 3>
        <<<blocks_for(n), JETS_THREADS, 0, stream>>>(a, local, out);
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
    float*, float*, cudaStream_t);
template cudaError_t sumfac_scatter_jets_launch<double>(
    const SumfacJetsArgs<double>&, const double*, const double*,
    const double*, double*, double*, cudaStream_t);

}  // namespace tigar
