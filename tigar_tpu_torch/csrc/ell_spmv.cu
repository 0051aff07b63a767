// K11: padded-row (ELL) sparse product of the smoothed-aggregation cycle.
//
// Replaces the per-row gather-contracts of tigar_tpu/solvers/
// aggregation.py _mlsa_apply (einsum("ik,ik->i", vals, x[cols]) for the
// level operator A, the prolongation P and its transpose P^T), with the
// level's weighted-Jacobi update fused in:
//
//   mode 0: y = A x;  mode 1: y = b - A x;
//   mode 2: y = x + om_dinv * (b - A x)        (A square)
//
// cols [n][K] int32, vals [n][K]; padding slots carry value 0.
//
// Bound: bytes (cols and vals read once, 2 flops per 8 or 12 bytes).
// Design: one warp per row; the lanes stride over the row's slots, so a
// warp reads cols and vals coalesced, gathers x (small, L2-resident on
// the coarse levels), reduces with shuffles, and lane 0 writes the row's
// result: no atomics, one write per output.
#include "kernels.h"

namespace tigar {

constexpr int ELL_THREADS = 256;
constexpr int ELL_WARPS = ELL_THREADS / 32;

template <typename T>
__global__ void __launch_bounds__(ELL_THREADS)
ell_spmv_kernel(int n, int K, const int* __restrict__ cols,
                const T* __restrict__ vals, const T* __restrict__ x,
                const T* __restrict__ b, const T* __restrict__ om_dinv,
                int mode, T* __restrict__ y) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int row = blockIdx.x * ELL_WARPS + warp; row < n;
       row += gridDim.x * ELL_WARPS) {
    const size_t o = (size_t)row * K;
    T acc = T(0);
    for (int k = lane; k < K; k += 32) acc += vals[o + k] * x[cols[o + k]];
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, s);
    if (lane == 0) {
      if (mode == 0)
        y[row] = acc;
      else if (mode == 1)
        y[row] = b[row] - acc;
      else
        y[row] = x[row] + om_dinv[row] * (b[row] - acc);
    }
  }
}

template <typename T>
cudaError_t ell_spmv_launch(int n, int K, const int* cols, const T* vals,
                            const T* x, const T* b, const T* om_dinv,
                            int mode, T* y, cudaStream_t stream) {
  if (mode < 0 || mode > 2 || K < 1) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  int grid = (n + ELL_WARPS - 1) / ELL_WARPS;
  if (grid > 8 * 132) grid = 8 * 132;
  ell_spmv_kernel<T><<<grid, ELL_THREADS, 0, stream>>>(n, K, cols, vals, x,
                                                       b, om_dinv, mode, y);
  return cudaGetLastError();
}

template cudaError_t ell_spmv_launch<float>(int, int, const int*,
                                            const float*, const float*,
                                            const float*, const float*, int,
                                            float*, cudaStream_t);
template cudaError_t ell_spmv_launch<double>(int, int, const int*,
                                             const double*, const double*,
                                             const double*, const double*,
                                             int, double*, cudaStream_t);

}  // namespace tigar
