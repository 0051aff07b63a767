// K1: SVK Kirchhoff-Love shell residual, fused.
//
// Replaces the device work of tigar_tpu/ops/assembly.py
// DomainAssembler.residual_vector_adjoint (element_residuals_adjoint,
// _local_jets, _contract_adjoint, scatter_vector) with the pointwise body
// tigar_tpu/models/shell.py:svk_shell_adjoint, which the JAX package runs
// as XLA-fused einsums over [nel, nq] batches.
//
// One thread per (element, quadrature point): gather the 3 NEN local
// coefficients (3 fields x NEN functions a field: 9 on a biquadratic
// B-spline element, 16 on a bicubic extraction element), form the jets
// G = DF + u.g and H = d2F + u.h, evaluate the adjoint jet (plus the
// constant load on Fval), contract it with scale x (N, dN, d2N) and
// atomically add the 3 NEN contributions into r.  With a padding mask
// [nel, NEN] (ragged T-spline elements: padded slots carry connectivity 0
// and mask 0), each gathered coefficient and each contribution is
// multiplied by its slot's mask, so a padded slot adds nothing.
//
// Bound: device-memory reads of the per-point tabulation and geometry
// (7 NEN + 31 values per point: N, dN, d2N, DF 6, d2F 12, reference frame
// 12, scale 1; 94 at NEN 9, 143 at NEN 16).  The design reads each once,
// keeps every intermediate in registers, and never writes the [nel, 3 NEN]
// element vectors: the atomics add straight into r.
#include "kernels.h"
#include "svk_adjoint.cuh"

namespace tigar {

template <typename T, int NEN, bool MASKED>
__global__ void __launch_bounds__(128)
shell_residual_kernel(int npt, int nq, const int* __restrict__ conn,
                      const T* __restrict__ U, const T* __restrict__ N,
                      const T* __restrict__ dN, const T* __restrict__ d2N,
                      const T* __restrict__ scale, const T* __restrict__ DF,
                      const T* __restrict__ d2F,
                      const T* __restrict__ ref_a,
                      const T* __restrict__ ref_b,
                      const T* __restrict__ ea,
                      const T* __restrict__ mask, ShellConst<T> k, T l0,
                      T l1, T l2, T* __restrict__ r) {
  const int pt = blockIdx.x * blockDim.x + threadIdx.x;
  if (pt >= npt) return;
  const int e = pt / nq;
  const int* ce = conn + (size_t)e * 3 * NEN;
  const T* me = MASKED ? mask + (size_t)e * NEN : nullptr;
  const T* Nq = N + (size_t)pt * NEN;
  const T* dNq = dN + (size_t)pt * 2 * NEN;
  const T* d2Nq = d2N + (size_t)pt * 4 * NEN;

  // jets of the state (the value part does not enter the SVK density)
  T g[3][2], h[3][2][2];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      g[i][d] = T(0);
      h[i][d][0] = T(0);
      h[i][d][1] = T(0);
    }
  }
#pragma unroll
  for (int a = 0; a < NEN; ++a) {
    const T m = MASKED ? me[a] : T(1);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const T c = MASKED ? U[ce[i * NEN + a]] * m : U[ce[i * NEN + a]];
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        g[i][d] += dNq[a * 2 + d] * c;
        h[i][d][0] += d2Nq[a * 4 + d * 2 + 0] * c;
        h[i][d][1] += d2Nq[a * 4 + d * 2 + 1] * c;
      }
    }
  }
  T G[3][2], H[3][2][2];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      G[i][d] = DF[(size_t)pt * 6 + i * 2 + d] + g[i][d];
#pragma unroll
      for (int c = 0; c < 2; ++c)
        H[i][d][c] = d2F[(size_t)pt * 12 + i * 4 + d * 2 + c] + h[i][d][c];
    }
  ShellRef<T> ref;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    ref.a[j / 2][j % 2] = ref_a[(size_t)pt * 4 + j];
    ref.b[j / 2][j % 2] = ref_b[(size_t)pt * 4 + j];
    ref.ea[j / 2][j % 2] = ea[(size_t)pt * 4 + j];
  }
  T Fg[3][2], Fh[3][2][2];
  svk_adjoint<T, T>(G, H, ref, k, Fg, Fh);

  const T s = scale[pt];
  const T Fv[3] = {s * l0, s * l1, s * l2};
  T sFg[3][2], sFh[3][2][2];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      sFg[i][d] = s * Fg[i][d];
      sFh[i][d][0] = s * Fh[i][d][0];
      sFh[i][d][1] = s * Fh[i][d][1];
    }
#pragma unroll
  for (int a = 0; a < NEN; ++a) {
    const T m = MASKED ? me[a] : T(1);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      T v = Fv[i] * Nq[a];
      v += sFg[i][0] * dNq[a * 2] + sFg[i][1] * dNq[a * 2 + 1];
#pragma unroll
      for (int d = 0; d < 2; ++d)
        v += sFh[i][d][0] * d2Nq[a * 4 + d * 2]
             + sFh[i][d][1] * d2Nq[a * 4 + d * 2 + 1];
      atomicAdd(r + ce[i * NEN + a], MASKED ? v * m : v);
    }
  }
}

template <typename T>
cudaError_t shell_residual_launch(int nel, int nq, int nen, const int* conn,
                                  const T* U, const T* N, const T* dN,
                                  const T* d2N, const T* scale, const T* DF,
                                  const T* d2F, const T* ref_a,
                                  const T* ref_b, const T* ea, const T* mask,
                                  const double* c, T* r,
                                  cudaStream_t stream) {
  if (nen != 9 && nen != 16) return cudaErrorInvalidValue;
  const int npt = nel * nq;
  if (npt == 0) return cudaSuccess;
  ShellConst<T> k{T(c[0]), T(c[1]), T(c[2]), T(c[3])};
  const int threads = 128;
  const int blocks = (npt + threads - 1) / threads;
  // the mask is a template parameter, so the unpadded kernels are the
  // biquadratic kernel as it was, without a multiply by one a slot
#define K1_LAUNCH(N_, M_)                                                  \
  shell_residual_kernel<T, N_, M_><<<blocks, threads, 0, stream>>>(       \
      npt, nq, conn, U, N, dN, d2N, scale, DF, d2F, ref_a, ref_b, ea, mask, \
      k, T(c[4]), T(c[5]), T(c[6]), r)
  if (nen == 9) {
    if (mask) K1_LAUNCH(9, true); else K1_LAUNCH(9, false);
  } else {
    if (mask) K1_LAUNCH(16, true); else K1_LAUNCH(16, false);
  }
#undef K1_LAUNCH
  return cudaGetLastError();
}

template cudaError_t shell_residual_launch<float>(
    int, int, int, const int*, const float*, const float*, const float*,
    const float*, const float*, const float*, const float*, const float*,
    const float*, const float*, const float*, const double*, float*,
    cudaStream_t);
template cudaError_t shell_residual_launch<double>(
    int, int, int, const int*, const double*, const double*, const double*,
    const double*, const double*, const double*, const double*,
    const double*, const double*, const double*, const double*,
    const double*, double*, cudaStream_t);

}  // namespace tigar
