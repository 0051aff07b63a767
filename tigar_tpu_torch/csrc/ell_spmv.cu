// K11: sliced padded-row (sliced ELL) sparse product of the
// smoothed-aggregation cycles.
//
// Replaces the per-row gather-contracts of tigar_tpu/solvers/
// aggregation.py _mlsa_apply (einsum("ik,ik->i", vals, x[cols]) for the
// level operator A, the prolongation P and its transpose P^T) and the coo
// products of TwoLevelSA.apply32, with the cycle's elementwise steps fused
// in:
//
//   mode 0: y = A x;  mode 1: y = b - A x;
//   mode 2: y = x + om_dinv (b - A x)                      (A square)
//   mode 3: y = x0 + om_dinv (b - A x0), x0 = om_dinv b    (A square: the
//           sweep from x = 0, x0 formed inside the gather; no x)
//   mode 4: y = b + A x                          (the coarse correction)
//
// Layout (ops/sparse.sliced_ell): the rows in slices ("tiles") of
// ELL_THREADS / lanes rows, each with its own lanes a row (4 to 256, powers
// of 2) and width; tile t = (row0, width, lanes) holds its rows' slots
// row-major at cols/vals[starts[t] + r width + k], the width its longest
// row rounded up to a multiple of 4 (one 16-byte load of cols); padding
// slots carry column 0 and value 0.  The host picks, for each aligned run
// of 64 rows, the tallest tiles whose lanes read at most 4 chunks of 4
// slots each (a row a block past that), so long rows get many warps and
// short rows few idle lanes.
//
// Bound: bytes (cols and vals read once, 2 flops per 8 or 12 bytes; x
// gathered from L2).  Design: one block a tile, every thread on one row's
// lane; each lane reads whole 4-slot chunks with 16-byte loads of cols and
// vals and gathers x through the read-only path, and the row's lanes
// reduce with shuffles (and, past a warp, the warps' sums through shared
// memory, in order); the row's first lane writes its result with the
// mode's epilogue: no atomics, one write per output.
#include <cstdint>

#include "kernels.h"

namespace tigar {

namespace {

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 s = __ldg(reinterpret_cast<const double2*>(p));
  const double2 t = __ldg(reinterpret_cast<const double2*>(p) + 1);
  v[0] = s.x;
  v[1] = s.y;
  v[2] = t.x;
  v[3] = t.y;
}

// the gathered entry of column c: x[c], or x0[c] = om_dinv[c] b[c] (X0)
template <typename T, bool X0>
__device__ __forceinline__ T gathered(const T* __restrict__ x,
                                      const T* __restrict__ b,
                                      const T* __restrict__ om, int c) {
  if constexpr (X0)
    return __ldg(om + c) * __ldg(b + c);
  else
    return __ldg(x + c);
}

// the rows of one tile (rows <= ELL_THREADS / LANES, width K), LANES
// lanes a row; every thread runs the same number of passes, so the
// shuffles see whole warps and the block meets each barrier
template <typename T, int LANES, bool X0>
__device__ __forceinline__ void slice_rows(
    int r0, int rows, int K, const int* __restrict__ cols,
    const T* __restrict__ vals, const T* __restrict__ x,
    const T* __restrict__ b, const T* __restrict__ om, int mode,
    T* __restrict__ y) {
  constexpr int RPP = ELL_THREADS / LANES;
  constexpr int WL = LANES < 32 ? LANES : 32;     // lanes a shuffle tree
  __shared__ T part[ELL_THREADS / 32];
  const int lane = threadIdx.x % LANES, sub = threadIdx.x / LANES;
  const int C = K / 4;
  for (int rp = 0; rp < rows; rp += RPP) {
    const int r = rp + sub;
    T acc = T(0);
    if (r < rows) {
      const int* cr = cols + (int64_t)r * K;
      const T* vr = vals + (int64_t)r * K;
#pragma unroll 2
      for (int j = lane; j < C; j += LANES) {
        const int4 c = __ldg(reinterpret_cast<const int4*>(cr) + j);
        T v[4];
        load4(vr + 4 * j, v);
        acc += v[0] * gathered<T, X0>(x, b, om, c.x);
        acc += v[1] * gathered<T, X0>(x, b, om, c.y);
        acc += v[2] * gathered<T, X0>(x, b, om, c.z);
        acc += v[3] * gathered<T, X0>(x, b, om, c.w);
      }
    }
#pragma unroll
    for (int s = WL / 2; s > 0; s >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, s, WL);
    if constexpr (LANES > 32) {
      if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = acc;
      __syncthreads();
      if (lane == 0)
        for (int w = 1; w < LANES / 32; ++w) acc += part[threadIdx.x / 32 + w];
      __syncthreads();
    }
    if (lane == 0 && r < rows) {
      const int i = r0 + r;
      T out;
      if (mode == 0)
        out = acc;
      else if (mode == 1)
        out = b[i] - acc;
      else if (mode == 2)
        out = x[i] + om[i] * (b[i] - acc);
      else if (mode == 3)
        out = om[i] * b[i] + om[i] * (b[i] - acc);
      else
        out = b[i] + acc;
      y[i] = out;
    }
  }
}

template <typename T, bool X0>
__global__ void __launch_bounds__(ELL_THREADS)
ell_sliced_kernel(int n, const int* __restrict__ tiles,
                  const long long* __restrict__ starts,
                  const int* __restrict__ cols, const T* __restrict__ vals,
                  const T* __restrict__ x, const T* __restrict__ b,
                  const T* __restrict__ om, int mode, T* __restrict__ y) {
  const int t = blockIdx.x;
  const int r0 = tiles[3 * t], K = tiles[3 * t + 1];
  const int lanes = tiles[3 * t + 2];
  const int rows = min(ELL_THREADS / lanes, n - r0);
  const long long o = starts[t];
  const int* c = cols + o;
  const T* v = vals + o;
  switch (lanes) {
    case 4:
      slice_rows<T, 4, X0>(r0, rows, K, c, v, x, b, om, mode, y);
      break;
    case 8:
      slice_rows<T, 8, X0>(r0, rows, K, c, v, x, b, om, mode, y);
      break;
    case 16:
      slice_rows<T, 16, X0>(r0, rows, K, c, v, x, b, om, mode, y);
      break;
    case 32:
      slice_rows<T, 32, X0>(r0, rows, K, c, v, x, b, om, mode, y);
      break;
    case 64:
      slice_rows<T, 64, X0>(r0, rows, K, c, v, x, b, om, mode, y);
      break;
    case 128:
      slice_rows<T, 128, X0>(r0, rows, K, c, v, x, b, om, mode, y);
      break;
    default:
      slice_rows<T, 256, X0>(r0, rows, K, c, v, x, b, om, mode, y);
  }
}

}  // namespace

template <typename T>
cudaError_t ell_spmv_launch(int n, int ntiles, const int* tiles,
                            const long long* starts, const int* cols,
                            const T* vals, const T* x, const T* b,
                            const T* om_dinv, int mode, T* y,
                            cudaStream_t stream) {
  if (mode < 0 || mode > 4) return cudaErrorInvalidValue;
  if (n == 0 || ntiles == 0) return cudaSuccess;
  if (mode == 3)
    ell_sliced_kernel<T, true><<<ntiles, ELL_THREADS, 0, stream>>>(
        n, tiles, starts, cols, vals, x, b, om_dinv, mode, y);
  else
    ell_sliced_kernel<T, false><<<ntiles, ELL_THREADS, 0, stream>>>(
        n, tiles, starts, cols, vals, x, b, om_dinv, mode, y);
  return cudaGetLastError();
}

template cudaError_t ell_spmv_launch<float>(int, int, const int*,
                                            const long long*, const int*,
                                            const float*, const float*,
                                            const float*, const float*, int,
                                            float*, cudaStream_t);
template cudaError_t ell_spmv_launch<double>(int, int, const int*,
                                             const long long*, const int*,
                                             const double*, const double*,
                                             const double*, const double*,
                                             int, double*, cudaStream_t);

}  // namespace tigar
