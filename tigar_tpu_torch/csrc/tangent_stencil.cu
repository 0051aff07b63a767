// K2: SVK shell tangent, built straight into the sliding-window stencil.
//
// Replaces tigar_tpu/ops/assembly.py DomainAssembler
// .element_matrices_adjoint (jacfwd of the adjoint over the ravelled jet,
// E = sum_q w_q B^T K B) followed by tigar_tpu/ops/stencil.py
// stencil_from_element_matrices (fold of each (a, b) entry into S at
// offset b - a + p).
//
// One block per element.
//  1. The pointwise jet-Jacobian K[q] = dF/du over the 18 non-value jet
//     slots (g[3][2], h[3][2][2] in Jet ravel order; the value slots of K
//     are identically zero for this density: F does not depend on u.val
//     and the load is constant).  It comes from the same templated
//     svk_adjoint as K1, evaluated on dual numbers carrying ND tangents;
//     a work item is one (quadrature point, pass of ND seeded slots), so
//     nq * 18/ND threads share the Jacobians of the element.
//  2. E[(f,a),(g,b)] = sum_q w_q sum_{s,t} phi_q[a][s] K_q[(f,s),(g,t)]
//     phi_q[b][t], with phi the 6 derivative tabulations of a local
//     function, from shared memory; one thread per entry of the 27 x 27
//     element matrix.
//  3. Each entry is atomically added into S[f][g][by-ay+2][bx-ax+2]
//     [ey+ay][ex+ax]; the [nel, 27, 27] element matrices never reach
//     device memory.
//
// Element mode (tangent_elements_launch) replaces step 3 for the
// space-agnostic Newton tier (tigar_tpu/solvers/newton_sa.py build_vals):
// each entry, times the element BC mask me[e][row] me[e][col] when given,
// is written to E[e][row][col] (plain stores, coalesced over the entry
// index) instead of folded.
//
// Bound: arithmetic (dual-number passes through the adjoint and the
// 27 x 27 x 36 nq contraction per element); reads are ~60 values per
// point and the atomics touch 729 stencil entries per element.  The design
// keeps K and the tabulations of the element in shared memory
// (at most 9 points: 27.5 KB in f64) and splits the dual work into
// 18/ND passes to bound registers.
#include "kernels.h"
#include "svk_adjoint.cuh"

namespace tigar {

constexpr int NS = 18;      // non-value jet slots: g (6) then h (12)
constexpr int ND = 2;       // tangents per dual pass
constexpr int NPASS = NS / ND;
constexpr int MAXQ = 9;
constexpr int THREADS = 96;

// jet slot of local derivative s (0..5: g0, g1, h00, h01, h10, h11) of
// field f, in Jet ravel order without the 3 value slots
__device__ __forceinline__ int slot(int f, int s) {
  return s < 2 ? f * 2 + s : 6 + f * 4 + (s - 2);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
tangent_stencil_kernel(int nel_x, int nq, const int* __restrict__ conn,
                       const T* __restrict__ U, const T* __restrict__ dN,
                       const T* __restrict__ d2N,
                       const T* __restrict__ scale,
                       const T* __restrict__ DF, const T* __restrict__ d2F,
                       const T* __restrict__ ref_a,
                       const T* __restrict__ ref_b,
                       const T* __restrict__ ea, ShellConst<T> k, int ncp_y,
                       int ncp_x, T* __restrict__ S,
                       const T* __restrict__ me, T* __restrict__ E) {
  __shared__ T Ksh[MAXQ * NS * NS];
  __shared__ T phi[MAXQ * 9 * 6];
  __shared__ T ssh[MAXQ];
  __shared__ T csh[27];
  const int e = blockIdx.x;
  const int tid = threadIdx.x;

  for (int i = tid; i < 27; i += THREADS) csh[i] = U[conn[(size_t)e * 27 + i]];
  for (int i = tid; i < nq * 54; i += THREADS) {
    const int q = i / 54, a = (i / 6) % 9, s = i % 6;
    const size_t pt = (size_t)e * nq + q;
    phi[i] = s < 2 ? dN[pt * 18 + a * 2 + s] : d2N[pt * 36 + a * 4 + (s - 2)];
  }
  for (int q = tid; q < nq; q += THREADS) ssh[q] = scale[(size_t)e * nq + q];
  __syncthreads();

  // 1. jet-Jacobians by forward-mode dual numbers
  using D = Dual<T, ND>;
  for (int w = tid; w < nq * NPASS; w += THREADS) {
    const int q = w / NPASS, pass = w % NPASS;
    const size_t pt = (size_t)e * nq + q;
    const T* ph = phi + q * 54;
    T g[3][2], h[3][2][2];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        g[i][d] = T(0);
        h[i][d][0] = T(0);
        h[i][d][1] = T(0);
      }
#pragma unroll
    for (int a = 0; a < 9; ++a)
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const T c = csh[i * 9 + a];
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          g[i][d] += ph[a * 6 + d] * c;
          h[i][d][0] += ph[a * 6 + 2 + d * 2] * c;
          h[i][d][1] += ph[a * 6 + 3 + d * 2] * c;
        }
      }
    D G[3][2], H[3][2][2];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        G[i][d] = D(DF[pt * 6 + i * 2 + d] + g[i][d]);
        const int sg = i * 2 + d - pass * ND;
#pragma unroll
        for (int kk = 0; kk < ND; ++kk) G[i][d].d[kk] = T(sg == kk ? 1 : 0);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          H[i][d][c] = D(d2F[pt * 12 + i * 4 + d * 2 + c] + h[i][d][c]);
          const int sh = 6 + i * 4 + d * 2 + c - pass * ND;
#pragma unroll
          for (int kk = 0; kk < ND; ++kk)
            H[i][d][c].d[kk] = T(sh == kk ? 1 : 0);
        }
      }
    ShellRef<T> ref;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ref.a[j / 2][j % 2] = ref_a[pt * 4 + j];
      ref.b[j / 2][j % 2] = ref_b[pt * 4 + j];
      ref.ea[j / 2][j % 2] = ea[pt * 4 + j];
    }
    D Fg[3][2], Fh[3][2][2];
    svk_adjoint<D, T>(G, H, ref, k, Fg, Fh);
    T* Kq = Ksh + q * NS * NS + pass * ND;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int d = 0; d < 2; ++d) {
#pragma unroll
        for (int kk = 0; kk < ND; ++kk) {
          Kq[(i * 2 + d) * NS + kk] = Fg[i][d].d[kk];
          Kq[(6 + i * 4 + d * 2) * NS + kk] = Fh[i][d][0].d[kk];
          Kq[(6 + i * 4 + d * 2 + 1) * NS + kk] = Fh[i][d][1].d[kk];
        }
      }
  }
  __syncthreads();

  // 2-3. element matrix entries, folded into the stencil (or written out)
  const int ey = e / nel_x, ex = e % nel_x;
  const size_t plane = (size_t)ncp_y * ncp_x;
  for (int idx = tid; idx < 27 * 27; idx += THREADS) {
    const int row = idx / 27, col = idx % 27;
    const int f = row / 9, a = row % 9, gf = col / 9, b = col % 9;
    T acc = T(0);
    for (int q = 0; q < nq; ++q) {
      const T* Kq = Ksh + q * NS * NS;
      const T* pa = phi + (q * 9 + a) * 6;
      const T* pb = phi + (q * 9 + b) * 6;
      T sub = T(0);
#pragma unroll
      for (int s = 0; s < 6; ++s) {
        const T* Krow = Kq + slot(f, s) * NS;
        T inner = T(0);
#pragma unroll
        for (int t = 0; t < 6; ++t) inner += Krow[slot(gf, t)] * pb[t];
        sub += pa[s] * inner;
      }
      acc += ssh[q] * sub;
    }
    if (E != nullptr) {
      if (me != nullptr)
        acc = acc * me[(size_t)e * 27 + row] * me[(size_t)e * 27 + col];
      E[(size_t)e * 729 + idx] = acc;
      continue;
    }
    const int ay = a / 3, ax = a % 3, by = b / 3, bx = b % 3;
    const size_t o = (((size_t)(f * 3 + gf) * 5 + (by - ay + 2)) * 5
                      + (bx - ax + 2)) * plane
                     + (size_t)(ey + ay) * ncp_x + (ex + ax);
    atomicAdd(S + o, acc);
  }
}

template <typename T>
cudaError_t tangent_stencil_launch(int nel_y, int nel_x, int nq,
                                   const int* conn, const T* U, const T* dN,
                                   const T* d2N, const T* scale, const T* DF,
                                   const T* d2F, const T* ref_a,
                                   const T* ref_b, const T* ea,
                                   const double* c, int ncp_y, int ncp_x,
                                   T* S, cudaStream_t stream) {
  const int nel = nel_y * nel_x;
  if (nq < 1 || nq > MAXQ) return cudaErrorInvalidValue;
  if (nel == 0) return cudaSuccess;
  ShellConst<T> k{T(c[0]), T(c[1]), T(c[2]), T(c[3])};
  tangent_stencil_kernel<T><<<nel, THREADS, 0, stream>>>(
      nel_x, nq, conn, U, dN, d2N, scale, DF, d2F, ref_a, ref_b, ea, k,
      ncp_y, ncp_x, S, nullptr, nullptr);
  return cudaGetLastError();
}

template <typename T>
cudaError_t tangent_elements_launch(int nel, int nq, const int* conn,
                                    const T* U, const T* dN, const T* d2N,
                                    const T* scale, const T* DF,
                                    const T* d2F, const T* ref_a,
                                    const T* ref_b, const T* ea,
                                    const double* c, const T* me, T* E,
                                    cudaStream_t stream) {
  if (nq < 1 || nq > MAXQ) return cudaErrorInvalidValue;
  if (nel == 0) return cudaSuccess;
  ShellConst<T> k{T(c[0]), T(c[1]), T(c[2]), T(c[3])};
  tangent_stencil_kernel<T><<<nel, THREADS, 0, stream>>>(
      1, nq, conn, U, dN, d2N, scale, DF, d2F, ref_a, ref_b, ea, k, 0, 0,
      nullptr, me, E);
  return cudaGetLastError();
}

template cudaError_t tangent_stencil_launch<float>(
    int, int, int, const int*, const float*, const float*, const float*,
    const float*, const float*, const float*, const float*, const float*,
    const float*, const double*, int, int, float*, cudaStream_t);
template cudaError_t tangent_stencil_launch<double>(
    int, int, int, const int*, const double*, const double*, const double*,
    const double*, const double*, const double*, const double*,
    const double*, const double*, const double*, int, int, double*,
    cudaStream_t);
template cudaError_t tangent_elements_launch<float>(
    int, int, const int*, const float*, const float*, const float*,
    const float*, const float*, const float*, const float*, const float*,
    const float*, const double*, const float*, float*, cudaStream_t);
template cudaError_t tangent_elements_launch<double>(
    int, int, const int*, const double*, const double*, const double*,
    const double*, const double*, const double*, const double*,
    const double*, const double*, const double*, const double*, double*,
    cudaStream_t);

}  // namespace tigar
