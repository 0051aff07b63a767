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
// Bound: device-memory bandwidth on B (m^2 values read once; 2 m^2 flops
// are negligible): 45.3 MB in f64 at the two-patch production size (m =
// 2,376), 22.6 MB in f32, which fits the H100's 50 MB L2 when the same
// block is applied back to back.
//
// Design:
//  - rows are split evenly over a grid sized to the card: one row a warp,
//    the same number of rows a block and the same number of blocks an SM
//    (m = 2,376: 264 blocks of 9 warps, 18 rows an SM, one wave); when m
//    gives under eight warps an SM, wpr = 2, 4 or 8 warps share a row and
//    their partial sums are reduced in shared memory;
//  - B's rows are read with 16-byte vector loads (float4 / double2),
//    eight independent loads and accumulators a lane (4 KB in flight a
//    warp); the elements before a row's first 16-byte boundary and after
//    its last take a scalar edge loop, so any m and any base address work;
//  - one launch a call, and no scratch: each block first issues the first
//    eight vector loads of its rows, then gathers m_j v[idx[j]] into
//    shared memory while they are in flight (idx in batches of four loads
//    a thread, then asynchronous copies (cp.async) of v[idx[j]] and
//    mask[idx[j]], multiplied once they land).  The gather is repeated in
//    every block (264 x 2,376 scattered reads at the production size, from
//    L2), which a first gather launch would avoid at the cost of a second
//    launch and a scratch vector each call: the call is host-bound in f32.
//    Shared memory: m values, 2 m with a mask (38 KB at the production
//    size in f64; above 48 KB through the dynamic shared memory attribute,
//    up to 227 KB);
//  - idx is unique, so one launch writes each output once and needs no
//    atomics; blocks of one operator are launched one after another (they
//    may share corner DoFs).
#include <cuda_pipeline.h>

#include <cstdint>

#include "kernels.h"

namespace tigar {

constexpr int IB_MAX_WARPS = 16;
constexpr int IB_MAX_THREADS = 32 * IB_MAX_WARPS;
constexpr int IB_UNROLL = 8;
constexpr int IB_GATHER = 4;    // idx loads a thread issues together

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
};

__device__ __forceinline__ float dot16(float4 b, float4 x, float acc) {
  acc = fmaf(b.x, x.x, acc);
  acc = fmaf(b.y, x.y, acc);
  acc = fmaf(b.z, x.z, acc);
  return fmaf(b.w, x.w, acc);
}
__device__ __forceinline__ double dot16(double2 b, double2 x, double acc) {
  acc = fma(b.x, x.x, acc);
  return fma(b.y, x.y, acc);
}

// the vector of xs starting at j: one shared load when j is a multiple of
// the vector width, else scalar loads
__device__ __forceinline__ float4 x16(const float* xs, int j, bool aligned) {
  if (aligned) return *reinterpret_cast<const float4*>(xs + j);
  return make_float4(xs[j], xs[j + 1], xs[j + 2], xs[j + 3]);
}
__device__ __forceinline__ double2 x16(const double* xs, int j,
                                       bool aligned) {
  if (aligned) return *reinterpret_cast<const double2*>(xs + j);
  return make_double2(xs[j], xs[j + 1]);
}

// elements of a row before its first 16-byte boundary
template <typename T>
__device__ __forceinline__ int head_len(const T* row, int m) {
  const int h =
      (int)(((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15) / sizeof(T));
  return h < m ? h : m;
}

template <typename T>
__global__ void __launch_bounds__(IB_MAX_THREADS)
iface_block_kernel(int m, int wpr, int rpb, const T* __restrict__ B,
                   const int* __restrict__ idx, const T* __restrict__ mask,
                   const T* __restrict__ v, T alpha, T* __restrict__ out) {
  using V = typename Vec16<T>::type;
  constexpr int VW = Vec16<T>::n;
  extern __shared__ float4 iface_smem4[];
  T* xs = reinterpret_cast<T*>(iface_smem4);  // [m] the gathered vector
  T* ms = xs + m;                             // [m] mask[idx], with a mask
  __shared__ T part[IB_MAX_WARPS];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int seg = warp % wpr, slot = warp / wpr;
  const int L = seg * 32 + lane, S = 32 * wpr;  // lane among the row's
  const int row = blockIdx.x * rpb + slot;
  const bool active = row < m;
  const T* Br = B + (size_t)(active ? row : 0) * m;
  const int h = head_len(Br, m), nv = (m - h) / VW;
  const V* Bv = reinterpret_cast<const V*>(Br + h);

  // the first vectors of this warp's row, in flight during the gather
  V b[IB_UNROLL];
#pragma unroll
  for (int u = 0; u < IB_UNROLL; ++u)
    if (active && L + u * S < nv) b[u] = __ldg(Bv + L + u * S);
  // the gathered vector: idx in batches, then asynchronous copies of
  // v[idx[j]] (and mask[idx[j]]) into shared memory; thread t takes
  // j = t, t + blockDim.x, ...
  for (int j0 = threadIdx.x; j0 < m; j0 += IB_GATHER * blockDim.x) {
    int g[IB_GATHER];
#pragma unroll
    for (int u = 0; u < IB_GATHER; ++u) {
      const int j = j0 + u * blockDim.x;
      g[u] = j < m ? __ldg(idx + j) : -1;
    }
#pragma unroll
    for (int u = 0; u < IB_GATHER; ++u) {
      if (g[u] < 0) continue;
      const int j = j0 + u * blockDim.x;
      __pipeline_memcpy_async(xs + j, v + g[u], sizeof(T));
      if (mask != nullptr)
        __pipeline_memcpy_async(ms + j, mask + g[u], sizeof(T));
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  if (mask != nullptr)  // this thread's own copies, visible to it now
    for (int j = threadIdx.x; j < m; j += blockDim.x) xs[j] *= ms[j];
  __syncthreads();

  T acc[IB_UNROLL];
#pragma unroll
  for (int u = 0; u < IB_UNROLL; ++u) acc[u] = T(0);
  if (active) {
    const int t0 = h + nv * VW;         // first element of the tail
    const bool xa = h == 0;             // 16-byte shared reads of xs
    if (L < h) acc[0] = Br[L] * xs[L];
    if (L < m - t0) acc[1] = __ldg(Br + t0 + L) * xs[t0 + L];
    // chunks of IB_UNROLL vectors a lane, the first one prefetched
    for (int k = L;;) {
#pragma unroll
      for (int u = 0; u < IB_UNROLL; ++u)
        if (k + u * S < nv)
          acc[u] = dot16(b[u], x16(xs, h + (k + u * S) * VW, xa), acc[u]);
      k += IB_UNROLL * S;
      if (k >= nv) break;
#pragma unroll
      for (int u = 0; u < IB_UNROLL; ++u)
        if (k + u * S < nv) b[u] = __ldg(Bv + k + u * S);
    }
  }
  T sum = T(0);
#pragma unroll
  for (int u = 0; u < IB_UNROLL; ++u) sum += acc[u];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (wpr > 1) {
    if (lane == 0) part[warp] = sum;
    __syncthreads();
    if (seg == 0 && lane == 0)
      for (int s = 1; s < wpr; ++s) sum += part[warp + s];
  }
  if (active && seg == 0 && lane == 0)
    out[__ldg(idx + row)] += alpha * (mask != nullptr ? ms[row] : T(1)) * sum;
}

template <typename T>
cudaError_t iface_block_launch(int m, const T* B, const int* idx,
                               const T* mask, const T* v, double alpha,
                               T* out, cudaStream_t stream) {
  if (m == 0) return cudaSuccess;
  const size_t smem = iface_block_smem<T>(m, mask != nullptr);
  static size_t allowed = 48 * 1024;
  const cudaError_t e = allow_smem(
      reinterpret_cast<const void*>(iface_block_kernel<T>), smem, &allowed);
  if (e != cudaSuccess) return e;
  // every warp takes one row (or one of wpr segments of a row): wpr the
  // fewest that give eight warps an SM; then the rows are split evenly
  // over k blocks an SM, k the fewest that keep a block within 16 warps
  // (m = 2,376: 264 blocks of 9 warps, two an SM, one row a warp)
  const long long nsm = sm_count();
  int wpr = 1;
  while (wpr < IB_MAX_WARPS / 2 && (long long)m * wpr < 8 * nsm) wpr *= 2;
  const long long max_rows = IB_MAX_WARPS / wpr;
  const long long k = (m + nsm * max_rows - 1) / (nsm * max_rows);
  const int rpb = (int)((m + nsm * k - 1) / (nsm * k));
  const int grid = (m + rpb - 1) / rpb;
  iface_block_kernel<T><<<grid, 32 * wpr * rpb, smem, stream>>>(
      m, wpr, rpb, B, idx, mask, v, T(alpha), out);
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
