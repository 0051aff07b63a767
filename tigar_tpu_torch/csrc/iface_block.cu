// K5: dense interface block apply of the multi-patch operator.
//
// Replaces the dense interface-block products of tigar_tpu/solvers/
// newton_stencil_mp.py MultiPatchStencilOperator: __call__ (out.at[idx]
// .add(K @ U[idx])), schwarz (Sinv @ (m_idx * r[idx]) scattered back) and,
// composed with K3, the residual and Jacobi modes of the multi-patch level
// action.  For one block B [m, m] over the sorted, unique support idx [m]:
//
//   out[idx[i]] += alpha * m_i * sum_j B[i, j] * m_j * v[idx[j]],
//   m = mask[idx] (1 without a mask), alpha = +1 or -1.
//
// Design: every block stages the gathered m_j * v[idx[j]] in shared memory
// (m = 2,376 at the two-patch production size: 9.5 KB in f32, 19 KB in
// f64), then each warp takes whole rows, reads B's row coalesced, reduces
// with shuffles, and lane 0 updates out.  idx is unique, so one launch
// writes each output once and needs no atomics; blocks of one operator are
// launched one after another (they may share corner DoFs).
//
// Bound: device-memory bandwidth on B (m^2 values read once; 2 m^2 flops
// are negligible).  22.6 MB in f32 fits the H100's 50 MB L2, so back-to-back
// applies of the same block can run above the HBM bound.
#include "kernels.h"

namespace tigar {

constexpr int IB_THREADS = 256;
constexpr int IB_WARPS = IB_THREADS / 32;

template <typename T>
__global__ void __launch_bounds__(IB_THREADS)
iface_block_kernel(int m, const T* __restrict__ B, const int* __restrict__ idx,
                   const T* __restrict__ mask, const T* __restrict__ v,
                   T alpha, T* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  for (int j = threadIdx.x; j < m; j += IB_THREADS) {
    const int g = idx[j];
    xs[j] = (mask != nullptr ? mask[g] : T(1)) * v[g];
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int row = blockIdx.x * IB_WARPS + warp; row < m;
       row += gridDim.x * IB_WARPS) {
    const T* Br = B + (size_t)row * m;
    T acc = T(0);
    for (int j = lane; j < m; j += 32) acc += Br[j] * xs[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
    if (lane == 0) {
      const int g = idx[row];
      out[g] += alpha * (mask != nullptr ? mask[g] : T(1)) * acc;
    }
  }
}

template <typename T>
cudaError_t iface_block_launch(int m, const T* B, const int* idx,
                               const T* mask, const T* v, double alpha, T* out,
                               cudaStream_t stream) {
  if (m == 0) return cudaSuccess;
  const size_t smem = (size_t)m * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        iface_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  // about two blocks per SM of the H100; each warp walks several rows
  const int rows_per_block = IB_WARPS;
  int grid = (m + rows_per_block - 1) / rows_per_block;
  if (grid > 264) grid = 264;
  iface_block_kernel<T><<<grid, IB_THREADS, smem, stream>>>(
      m, B, idx, mask, v, T(alpha), out);
  return cudaGetLastError();
}

template cudaError_t iface_block_launch<float>(int, const float*, const int*,
                                               const float*, const float*,
                                               double, float*, cudaStream_t);
template cudaError_t iface_block_launch<double>(int, const double*,
                                                const int*, const double*,
                                                const double*, double,
                                                double*, cudaStream_t);

}  // namespace tigar
