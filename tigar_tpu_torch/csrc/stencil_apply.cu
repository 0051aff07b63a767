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
// place (the JAX package copies each patch out and back).  Each grid
// point gets A x from the 3 x 25 input window (zero outside the grid: no
// padded copy), then one of
//   mode 0: y = A x
//   mode 1: y = b - A x
//   mode 2: y = x + (omega dinv) (b - A x)
// where A x = mask * S (mask * x) + (1 - mask) * x when mask is given
// (zeroRowsColumns with a unit diagonal), else S x.
//
// Bound: bytes.  Each apply streams S once (225 values a grid point) and
// the vectors: on an NVIDIA H100 80GB HBM3 (3.35 TB/s) 0.0047 ms for the
// f32 apply at 130^2 (15.8 MB; the Jacobi sweep 0.0048), 0.0012 at 66^2,
// 0.0003 at 34^2 and 0.0001 at 18^2.  The coarse levels of the V-cycle
// are bound by the launch and two or three dependent memory latencies
// (a few microseconds), not by their bytes.  Design:
//  - a block takes a tile of ty x tx grid points (tx <= 32 splits the row
//    evenly: 26 at nx 130, 22 at 66, 17 at 34, 18 at 18), and 9 threads
//    a point, one per (f_out, f_in) pair, so a point's 225 products are
//    spread over 9 threads of 25 each.  Tiles are at most 4 points tall
//    and halve in y until the grid holds 4 blocks an SM or ty is 1: 650
//    blocks of 234 threads at 130^2, 198 at 66^2, 68 at 34^2, 18 at 18^2;
//  - thread (f_out, f_in, point) issues its 25 loads of S[f_out][f_in]
//    [oy][ox][point] first (consecutive threads, consecutive points:
//    coalesced), before it helps to stage the tile's mask * x for the 3
//    fields with its 2-point halo in shared memory, so mask * x is formed
//    once a value, while S is in flight;
//  - each thread sums its 25 products from the staged window; the f_in =
//    1, 2 threads hand their sums to the f_in = 0 thread of the point
//    through shared memory, which adds them and writes the epilogue.
#include "kernels.h"

namespace tigar {

constexpr int K3_TX_MAX = 32;
constexpr int K3_TY_MAX = 4;
constexpr int K3_THREADS_MAX = 512;
constexpr int K3_P_MAX = K3_THREADS_MAX / 9;    // points a tile, at most

template <typename T>
__global__ void __launch_bounds__(K3_THREADS_MAX)
stencil_apply_kernel(int ny, int nx, int tx, int ty,
                     const T* __restrict__ S, const T* __restrict__ x,
                     const T* __restrict__ mask, const T* __restrict__ b,
                     const T* __restrict__ dinv, T omega, int mode, int base,
                     int fstride, T* __restrict__ y) {
  __shared__ T xs[3 * (K3_TY_MAX + 4) * (K3_TX_MAX + 4)];
  __shared__ T part[2 * 3 * K3_P_MAX];
  const size_t n = (size_t)ny * nx;
  const int P = tx * ty;
  const int t = threadIdx.x;
  const int lp = t % P, g = t / P;                // point of the tile, pair
  const int fo = g / 3, fi = g - 3 * fo;
  const int ly = lp / tx, lx = lp - ly * tx;
  const int tiles_x = (nx + tx - 1) / tx;
  const int y0 = (blockIdx.x / tiles_x) * ty;
  const int x0 = (blockIdx.x - (blockIdx.x / tiles_x) * tiles_x) * tx;
  const int iy = y0 + ly, ix = x0 + lx;
  const bool live = iy < ny && ix < nx;
  const size_t pt = (size_t)iy * nx + ix;

  // 1. this thread's 25 stencil values, in flight during the staging
  T s[25];
  const T* Sg = S + (size_t)g * 25 * n + pt;
#pragma unroll
  for (int o = 0; o < 25; ++o) s[o] = live ? __ldg(Sg + o * n) : T(0);

  // 2. mask * x over the tile and its halo, zero outside the grid
  const int pw = tx + 4, ph = ty + 4;
  for (int i = t; i < 3 * ph * pw; i += blockDim.x) {
    const int f = i / (ph * pw), r = i - f * (ph * pw);
    const int gy = y0 + r / pw - 2, gx = x0 + r % pw - 2;
    T v = T(0);
    if (gy >= 0 && gy < ny && gx >= 0 && gx < nx) {
      const size_t k = base + (size_t)f * fstride + (size_t)gy * nx + gx;
      v = __ldg(x + k);
      if (mask != nullptr) v *= __ldg(mask + k);
    }
    xs[i] = v;
  }
  __syncthreads();

  // 3. sum over this thread's input field and the 5 x 5 window
  const T* xw = xs + (fi * ph + ly) * pw + lx;
  T acc = T(0);
#pragma unroll
  for (int oy = 0; oy < 5; ++oy)
#pragma unroll
    for (int ox = 0; ox < 5; ++ox) acc += s[oy * 5 + ox] * xw[oy * pw + ox];
  if (fi != 0) part[((fi - 1) * 3 + fo) * P + lp] = acc;
  __syncthreads();
  if (fi != 0 || !live) return;

  // 4. the f_in = 0 thread of (f_out, point): A x and the epilogue
  acc += part[fo * P + lp] + part[(3 + fo) * P + lp];
  const size_t i = base + (size_t)fo * fstride + pt;
  const T xi = __ldg(x + i);
  T Ax = acc;
  if (mask != nullptr) {
    const T mi = __ldg(mask + i);
    Ax = mi * Ax + (T(1) - mi) * xi;
  }
  if (mode == 0) {
    y[i] = Ax;
  } else if (mode == 1) {
    y[i] = __ldg(b + i) - Ax;
  } else {
    y[i] = xi + (omega * __ldg(dinv + i)) * (__ldg(b + i) - Ax);
  }
}

template <typename T>
cudaError_t stencil_apply_launch(int ny, int nx, const T* S, const T* x,
                                 const T* mask, const T* b, const T* dinv,
                                 double omega, int mode, int base,
                                 int fstride, T* y, cudaStream_t stream) {
  if (mode < 0 || mode > 2 || ny < 0 || nx < 0) return cudaErrorInvalidValue;
  if (ny == 0 || nx == 0) return cudaSuccess;
  // the row split evenly into tiles of at most K3_TX_MAX points, then the
  // tallest tile (ty <= 4, 9 tx ty threads <= 512) that still gives 4
  // blocks an SM
  const int ntx = (nx + K3_TX_MAX - 1) / K3_TX_MAX;
  const int tx = (nx + ntx - 1) / ntx;
  const int tiles_x = (nx + tx - 1) / tx;
  int ty = K3_P_MAX / tx < K3_TY_MAX ? K3_P_MAX / tx : K3_TY_MAX;
  while (ty > 1 && (long long)tiles_x * ((ny + ty - 1) / ty) <
                       4LL * sm_count())
    ty /= 2;
  const long long blocks = (long long)tiles_x * ((ny + ty - 1) / ty);
  stencil_apply_kernel<T><<<(unsigned)blocks, 9 * tx * ty, 0, stream>>>(
      ny, nx, tx, ty, S, x, mask, b, dinv, T(omega), mode, base, fstride, y);
  return cudaGetLastError();
}

template cudaError_t stencil_apply_launch<float>(
    int, int, const float*, const float*, const float*, const float*,
    const float*, double, int, int, int, float*, cudaStream_t);
template cudaError_t stencil_apply_launch<double>(
    int, int, const double*, const double*, const double*, const double*,
    const double*, double, int, int, int, double*, cudaStream_t);

}  // namespace tigar
