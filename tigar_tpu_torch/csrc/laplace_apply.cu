// K12: f32 fast-path scalar stiffness apply over explicit element
// connectivity,
//
//   r = mask * A (mask * W) + (1 - mask) * W,
//   A (mask W) = scatter_e( A2_e^T (A1_e (mask W)[conn_e]) ),
//
// with the layouts A1, A2 [nen][M][nel] (M = nq * d; row a * M + m,
// element axis last): A1 the trial gradients, A2 the test gradients
// weighted by qw * sqrtJ * ginv.
//
// Replaces tigar_tpu/ops/fastpath.py _laplace_apply (the XLA-fused
// gather -> einsum -> einsum -> scatter-add, the computation of the
// Pallas element-apply kernel the JAX package once had).
//
// Bound: bytes.  Each element reads 2 * nen * M floats of the layouts
// (162 + 162 at 2D p=2, 4 quadrature points a direction) for 4 * nen * M
// flops: 0.5 flop a byte.  Design: one thread per element, so consecutive
// threads read consecutive elements of every layout row (coalesced); the
// element's masked coefficients ue[nen] and its local result re[nen] stay
// in registers, the m-th gradient sum is a scalar, and the masked local
// result goes to r by atomicAdd.  A first pass writes r = (1 - mask) W,
// so no epilogue pass follows.  f32 atomics sum in a varying order.
#include "kernels.h"

namespace tigar {

constexpr int LAPLACE_THREADS = 128;

__global__ void laplace_init_kernel(int ndof, const float* __restrict__ mask,
                                    const float* __restrict__ W,
                                    float* __restrict__ r) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < ndof;
       i += gridDim.x * blockDim.x)
    r[i] = (1.0f - mask[i]) * W[i];
}

template <int NEN>
__global__ void __launch_bounds__(LAPLACE_THREADS)
laplace_apply_kernel(int nel, int M, const float* __restrict__ A1,
                     const float* __restrict__ A2,
                     const int* __restrict__ connT,
                     const float* __restrict__ mask,
                     const float* __restrict__ W, float* __restrict__ r) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= nel) return;
  const size_t stride = (size_t)nel;
  int c[NEN];
  float ue[NEN], re[NEN];
#pragma unroll
  for (int a = 0; a < NEN; ++a) {
    c[a] = connT[a * stride + e];
    ue[a] = mask[c[a]] * W[c[a]];
    re[a] = 0.0f;
  }
  for (int m = 0; m < M; ++m) {
    float g = 0.0f;
#pragma unroll
    for (int a = 0; a < NEN; ++a)
      g += A1[((size_t)a * M + m) * stride + e] * ue[a];
#pragma unroll
    for (int a = 0; a < NEN; ++a)
      re[a] += A2[((size_t)a * M + m) * stride + e] * g;
  }
#pragma unroll
  for (int a = 0; a < NEN; ++a) atomicAdd(r + c[a], mask[c[a]] * re[a]);
}

cudaError_t laplace_apply_launch(int nel, int nen, int M, int ndof,
                                 const float* A1, const float* A2,
                                 const int* connT, const float* mask,
                                 const float* W, float* r,
                                 cudaStream_t stream) {
  if (M < 1 || nel < 0 || ndof < 0) return cudaErrorInvalidValue;
  if (ndof > 0) {
    int grid = (ndof + 255) / 256;
    if (grid > 8 * 132) grid = 8 * 132;
    laplace_init_kernel<<<grid, 256, 0, stream>>>(ndof, mask, W, r);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (nel == 0) return cudaSuccess;
  const int grid = (nel + LAPLACE_THREADS - 1) / LAPLACE_THREADS;
#define TIGAR_LAPLACE_CASE(N)                                              \
  case N:                                                                  \
    laplace_apply_kernel<N><<<grid, LAPLACE_THREADS, 0, stream>>>(         \
        nel, M, A1, A2, connT, mask, W, r);                                \
    break;
  switch (nen) {
    TIGAR_LAPLACE_CASE(4)
    TIGAR_LAPLACE_CASE(8)
    TIGAR_LAPLACE_CASE(9)
    TIGAR_LAPLACE_CASE(16)
    TIGAR_LAPLACE_CASE(27)
    TIGAR_LAPLACE_CASE(64)
    default:
      return cudaErrorInvalidValue;
  }
#undef TIGAR_LAPLACE_CASE
  return cudaGetLastError();
}

}  // namespace tigar
