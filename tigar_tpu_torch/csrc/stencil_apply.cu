// K3: sliding-window stencil apply with the multigrid's fused epilogues.
//
// Replaces tigar_tpu/ops/stencil.py StencilOperator.__call__ (and the
// .diagonal consumers), tigar_tpu/solvers/newton_stencil.py _masked_apply,
// the weighted-Jacobi sweep of make_stencil_mgcg(_mixed).smooth and the
// V-cycle residual b - A x, which XLA runs as 25 shifted-slice einsums
// over a zero-padded copy of the grid.
//
// S [3][3][5][5][ny][nx] couples output (f_out, I) to input
// (f_in, I + offset - 2); x, mask, b, dinv, y hold DoF (f, I) at
// base + f * fstride + I: [3][ny][nx] for a single patch (base 0, fstride
// ny * nx), or one patch of a multi-patch vector, read and written in
// place (the JAX package copies each patch out and back).  One thread
// per grid point computes all 3 output fields from the 3 x 25 input
// window (zero outside the grid: no padded copy), then one of
//   mode 0: y = A x
//   mode 1: y = b - A x
//   mode 2: y = x + (omega dinv) (b - A x)
// where A x = mask * S (mask * x) + (1 - mask) * x when mask is given
// (zeroRowsColumns with a unit diagonal), else S x.
//
// Bound: device-memory bandwidth.  Each apply streams S once (225 values
// per grid point) plus the vectors; S is read coalesced (consecutive
// threads, consecutive grid points) and the x window is reused through
// the L1/L2 caches.  No shared-memory tiling yet.
#include "kernels.h"

namespace tigar {

template <typename T>
__global__ void __launch_bounds__(256)
stencil_apply_kernel(int ny, int nx, const T* __restrict__ S,
                     const T* __restrict__ x, const T* __restrict__ mask,
                     const T* __restrict__ b, const T* __restrict__ dinv,
                     T omega, int mode, int base, int fstride,
                     T* __restrict__ y) {
  const int n = ny * nx;
  const int pt = blockIdx.x * blockDim.x + threadIdx.x;
  if (pt >= n) return;
  const int iy = pt / nx, ix = pt % nx;
  T acc[3] = {T(0), T(0), T(0)};
#pragma unroll
  for (int oy = 0; oy < 5; ++oy) {
    const int jy = iy + oy - 2;
    if (jy < 0 || jy >= ny) continue;
#pragma unroll
    for (int ox = 0; ox < 5; ++ox) {
      const int jx = ix + ox - 2;
      if (jx < 0 || jx >= nx) continue;
      const int j = jy * nx + jx;
#pragma unroll
      for (int fi = 0; fi < 3; ++fi) {
        const int k = base + fi * fstride + j;
        T xv = x[k];
        if (mask != nullptr) xv *= mask[k];
#pragma unroll
        for (int fo = 0; fo < 3; ++fo)
          acc[fo] += S[((size_t)((fo * 3 + fi) * 5 + oy) * 5 + ox) * n + pt] * xv;
      }
    }
  }
#pragma unroll
  for (int fo = 0; fo < 3; ++fo) {
    const int i = base + fo * fstride + pt;
    T Ax = acc[fo];
    if (mask != nullptr) Ax = mask[i] * Ax + (T(1) - mask[i]) * x[i];
    if (mode == 0) {
      y[i] = Ax;
    } else if (mode == 1) {
      y[i] = b[i] - Ax;
    } else {
      y[i] = x[i] + (omega * dinv[i]) * (b[i] - Ax);
    }
  }
}

template <typename T>
cudaError_t stencil_apply_launch(int ny, int nx, const T* S, const T* x,
                                 const T* mask, const T* b, const T* dinv,
                                 double omega, int mode, int base,
                                 int fstride, T* y, cudaStream_t stream) {
  const int n = ny * nx;
  if (mode < 0 || mode > 2) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int threads = 256;
  stencil_apply_kernel<T><<<(n + threads - 1) / threads, threads, 0,
                            stream>>>(ny, nx, S, x, mask, b, dinv, T(omega),
                                      mode, base, fstride, y);
  return cudaGetLastError();
}

template cudaError_t stencil_apply_launch<float>(
    int, int, const float*, const float*, const float*, const float*,
    const float*, double, int, int, int, float*, cudaStream_t);
template cudaError_t stencil_apply_launch<double>(
    int, int, const double*, const double*, const double*, const double*,
    const double*, double, int, int, int, double*, cudaStream_t);

}  // namespace tigar
