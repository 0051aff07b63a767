// Designs of K4 (the sum-factorized apply) measured against the port's,
// built by scripts/k4_designs.py.  Includes the port's
// csrc/sumfac_apply.cu (the kernel kept).  Every other design runs the
// same element arithmetic in a generic form (sumfac2d_element /
// sumfac3d_element, or one q_0 slice, sumfac3d_slice, below) and differs
// in where its coefficients come from and where its results go:
//   "port"         the port's launcher: one thread an element, 27 global
//                  atomics an element (p = 2), a memset of r before and
//                  the BC epilogue after;
//   "generic"      the same design built from the generic arithmetic;
//   "generic_compute"  "generic" with its atomics taken out (a store
//                  that never runs keeps the arithmetic live): its loads
//                  and arithmetic alone;
//   "fused"        "generic" with r initialised to (1 - mask) W by a
//                  first launch and the masked atomics of a programmatic
//                  dependent (no memset, no epilogue);
//   "split"        "fused" with Q threads an element, one a q_0 slice, 27
//                  atomics each (3D);
//   "shared_atomics"  the tile design: a block a tile of elements, the
//                  tile's masked window staged once in shared memory, each
//                  element's results added to a shared window of sums by
//                  shared atomics (compare-and-swap loops in f64), one
//                  global atomic a window DoF;
//   "tile_global"  "shared_atomics", but each element's results go
//                  straight to r with global atomics (memset before, BC
//                  epilogue after);
//   "tile_nostage" "shared_atomics", but each element reads its masked
//                  window from device memory;
//   "gather"       the tile design with each element's results kept in
//                  shared memory and each window slot summing those that
//                  cover it, in a fixed order (no shared atomics);
//   "unrolled"     "shared_atomics" with its 3D arithmetic (identity
//                  geometry) fully unrolled, the tables and the element's
//                  coefficients in registers;
//   "tile_split"   "unrolled" with Q threads an element, one a q_0 slice,
//                  the coefficients read from the window (the caller's
//                  tile holds at most 256 / Q elements).
// The tile designs take their tiles and windows from the caller.
#include "../tigar_tpu_torch/csrc/sumfac_apply.cu"

#include <cstring>

namespace tigar {
namespace {

// The element arithmetic of the port's kernel in a generic form (a
// function of where the coefficients come from and where the results go),
// which every design below runs, and an init launch.
// r = (1 - mask) W, or 0 without a mask; lets its dependent start now
template <typename T>
__global__ void sumfac_init_kernel(long long n, const T* __restrict__ W,
                                   const T* __restrict__ mask,
                                   T* __restrict__ r) {
  asm volatile("griddepcontrol.launch_dependents;");
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    r[i] = mask == nullptr ? T(0) : (T(1) - mask[i]) * W[i];
}

// The arithmetic of one 2D element (e1, e0): win(a1, a0) is its masked
// coefficient of local function (a1, a0), out(a1, a0, v) takes its result.
template <typename T, int P1, int Q, class WIn, class Out>
__device__ __forceinline__ void sumfac2d_element(const SumfacArgs<T>& a,
                                                 int e1, int e0,
                                                 const WIn& win,
                                                 const Out& out) {
  const T* B0 = a.B[0] + (size_t)e0 * Q * P1;
  const T* D0 = a.D[0] + (size_t)e0 * Q * P1;
  const T* B1 = a.B[1] + (size_t)e1 * Q * P1;
  const T* D1 = a.D[1] + (size_t)e1 * Q * P1;
  const T ck = a.ck, cm = a.cm;
  const size_t e = (size_t)e1 * a.nel[0] + e0;

  T r[P1][P1];  // [a1][a0]
#pragma unroll
  for (int a1 = 0; a1 < P1; ++a1)
#pragma unroll
    for (int a0 = 0; a0 < P1; ++a0) r[a1][a0] = T(0);

#pragma unroll 1
  for (int q0 = 0; q0 < Q; ++q0) {
    T tB[P1], tD[P1];  // direction-0 contractions, [a1]
#pragma unroll
    for (int a1 = 0; a1 < P1; ++a1) {
      T sb = T(0), sd = T(0);
#pragma unroll
      for (int a0 = 0; a0 < P1; ++a0) {
        const T w = win(a1, a0);
        sb += __ldg(B0 + q0 * P1 + a0) * w;
        sd += __ldg(D0 + q0 * P1 + a0) * w;
      }
      tB[a1] = sb;
      tD[a1] = sd;
    }
    T X[P1], Y[P1];  // transposed direction-1 sums, [a1]: X -> D0, Y -> B0
#pragma unroll
    for (int a1 = 0; a1 < P1; ++a1) X[a1] = Y[a1] = T(0);
    const T wq0 = a.G == nullptr ? __ldg(a.w[0] + e0 * Q + q0) : T(0);
#pragma unroll 1
    for (int q1 = 0; q1 < Q; ++q1) {
      T val = T(0), gx = T(0), gy = T(0);
#pragma unroll
      for (int a1 = 0; a1 < P1; ++a1) {
        const T b1 = __ldg(B1 + q1 * P1 + a1), d1 = __ldg(D1 + q1 * P1 + a1);
        val += b1 * tB[a1];
        gy += d1 * tB[a1];
        gx += b1 * tD[a1];
      }
      T wx, wy, mv;
      if (a.G == nullptr) {
        const T g = wq0 * __ldg(a.w[1] + e1 * Q + q1);
        wx = g * gx;
        wy = g * gy;
        mv = g * val;
      } else {
        const size_t pt = e * (Q * Q) + q1 * Q + q0;
        const T* G = a.G + pt * 4;
        wx = __ldg(G + 0) * gx + __ldg(G + 2) * gy;
        wy = __ldg(G + 1) * gx + __ldg(G + 3) * gy;
        mv = __ldg(a.Gm + pt) * val;
      }
      wx *= ck;
      wy *= ck;
      mv *= cm;
#pragma unroll
      for (int a1 = 0; a1 < P1; ++a1) {
        const T b1 = __ldg(B1 + q1 * P1 + a1), d1 = __ldg(D1 + q1 * P1 + a1);
        X[a1] += b1 * wx;
        Y[a1] += b1 * mv + d1 * wy;
      }
    }
#pragma unroll
    for (int a1 = 0; a1 < P1; ++a1)
#pragma unroll
      for (int a0 = 0; a0 < P1; ++a0)
        r[a1][a0] += __ldg(D0 + q0 * P1 + a0) * X[a1] +
                     __ldg(B0 + q0 * P1 + a0) * Y[a1];
  }
#pragma unroll
  for (int a1 = 0; a1 < P1; ++a1)
#pragma unroll
    for (int a0 = 0; a0 < P1; ++a0) out(a1, a0, r[a1][a0]);
}

// One q_0 slice of the arithmetic of a 3D element (e2, e1, e0), added
// into its results r [a2][a1][a0]; win(a2, a1, a0) is its masked
// coefficient of local function (a2, a1, a0).
template <typename T, int P1, int Q, class WIn>
__device__ __forceinline__ void sumfac3d_slice(const SumfacArgs<T>& a,
                                               int e2, int e1, int e0,
                                               int q0, const WIn& win,
                                               T r[P1][P1][P1]) {
  const T* B0 = a.B[0] + (size_t)e0 * Q * P1;
  const T* D0 = a.D[0] + (size_t)e0 * Q * P1;
  const T* B1 = a.B[1] + (size_t)e1 * Q * P1;
  const T* D1 = a.D[1] + (size_t)e1 * Q * P1;
  const T* B2 = a.B[2] + (size_t)e2 * Q * P1;
  const T* D2 = a.D[2] + (size_t)e2 * Q * P1;
  const bool identity = a.G == nullptr;
  const T ck = a.ck, cm = a.cm;
  const size_t e = ((size_t)e2 * a.nel[1] + e1) * a.nel[0] + e0;

  T tB[P1][P1], tD[P1][P1];  // direction-0 contractions, [a2][a1]
#pragma unroll
  for (int a2 = 0; a2 < P1; ++a2)
#pragma unroll
    for (int a1 = 0; a1 < P1; ++a1) {
      T sb = T(0), sd = T(0);
#pragma unroll
      for (int a0 = 0; a0 < P1; ++a0) {
        const T w = win(a2, a1, a0);
        sb += __ldg(B0 + q0 * P1 + a0) * w;
        sd += __ldg(D0 + q0 * P1 + a0) * w;
      }
      tB[a2][a1] = sb;
      tD[a2][a1] = sd;
    }
  // transposed direction-1 sums, [a2][a1]: X -> D0, Y -> B0
  T X[P1][P1], Y[P1][P1];
#pragma unroll
  for (int a2 = 0; a2 < P1; ++a2)
#pragma unroll
    for (int a1 = 0; a1 < P1; ++a1) X[a2][a1] = Y[a2][a1] = T(0);
  const T wq0 = identity ? __ldg(a.w[0] + e0 * Q + q0) : T(0);

#pragma unroll 1
  for (int q1 = 0; q1 < Q; ++q1) {
    // direction-1 contractions, [a2]: B1 tB, D1 tB, B1 tD
    T uBB[P1], uDB[P1], uBD[P1];
#pragma unroll
    for (int a2 = 0; a2 < P1; ++a2) {
      T bb = T(0), db = T(0), bd = T(0);
#pragma unroll
      for (int a1 = 0; a1 < P1; ++a1) {
        const T b1 = __ldg(B1 + q1 * P1 + a1);
        const T d1 = __ldg(D1 + q1 * P1 + a1);
        bb += b1 * tB[a2][a1];
        db += d1 * tB[a2][a1];
        bd += b1 * tD[a2][a1];
      }
      uBB[a2] = bb;
      uDB[a2] = db;
      uBD[a2] = bd;
    }
    const T wq01 = identity ? wq0 * __ldg(a.w[1] + e1 * Q + q1) : T(0);
    // transposed direction-2 sums, [a2]: Ax -> (B1, D0),
    // Cy -> (D1, B0), Bz -> (B1, B0)
    T Ax[P1], Cy[P1], Bz[P1];
#pragma unroll
    for (int a2 = 0; a2 < P1; ++a2) Ax[a2] = Cy[a2] = Bz[a2] = T(0);
#pragma unroll 1
    for (int q2 = 0; q2 < Q; ++q2) {
      T val = T(0), gx = T(0), gy = T(0), gz = T(0);
#pragma unroll
      for (int a2 = 0; a2 < P1; ++a2) {
        const T b2 = __ldg(B2 + q2 * P1 + a2);
        const T d2 = __ldg(D2 + q2 * P1 + a2);
        val += b2 * uBB[a2];
        gz += d2 * uBB[a2];
        gy += b2 * uDB[a2];
        gx += b2 * uBD[a2];
      }
      T wx, wy, wz, mv;
      if (identity) {
        const T g = wq01 * __ldg(a.w[2] + e2 * Q + q2);
        wx = g * gx;
        wy = g * gy;
        wz = g * gz;
        mv = g * val;
      } else {
        const size_t pt = e * (Q * Q * Q) + (q2 * Q + q1) * Q + q0;
        const T* G = a.G + pt * 9;  // G[d][c] at 3 d + c
        wx = __ldg(G + 0) * gx + __ldg(G + 3) * gy + __ldg(G + 6) * gz;
        wy = __ldg(G + 1) * gx + __ldg(G + 4) * gy + __ldg(G + 7) * gz;
        wz = __ldg(G + 2) * gx + __ldg(G + 5) * gy + __ldg(G + 8) * gz;
        mv = __ldg(a.Gm + pt) * val;
      }
      wx *= ck;
      wy *= ck;
      wz *= ck;
      mv *= cm;
#pragma unroll
      for (int a2 = 0; a2 < P1; ++a2) {
        const T b2 = __ldg(B2 + q2 * P1 + a2);
        const T d2 = __ldg(D2 + q2 * P1 + a2);
        Ax[a2] += b2 * wx;
        Cy[a2] += b2 * wy;
        Bz[a2] += b2 * mv + d2 * wz;
      }
    }
#pragma unroll
    for (int a2 = 0; a2 < P1; ++a2)
#pragma unroll
      for (int a1 = 0; a1 < P1; ++a1) {
        const T b1 = __ldg(B1 + q1 * P1 + a1);
        const T d1 = __ldg(D1 + q1 * P1 + a1);
        X[a2][a1] += b1 * Ax[a2];
        Y[a2][a1] += b1 * Bz[a2] + d1 * Cy[a2];
      }
  }
#pragma unroll
  for (int a2 = 0; a2 < P1; ++a2)
#pragma unroll
    for (int a1 = 0; a1 < P1; ++a1)
#pragma unroll
      for (int a0 = 0; a0 < P1; ++a0)
        r[a2][a1][a0] += __ldg(D0 + q0 * P1 + a0) * X[a2][a1] +
                         __ldg(B0 + q0 * P1 + a0) * Y[a2][a1];
}

// The arithmetic of one 3D element, as sumfac2d_element: its q_0 slices.
template <typename T, int P1, int Q, class WIn, class Out>
__device__ __forceinline__ void sumfac3d_element(const SumfacArgs<T>& a,
                                                 int e2, int e1, int e0,
                                                 const WIn& win,
                                                 const Out& out) {
  T r[P1][P1][P1];  // [a2][a1][a0]
#pragma unroll
  for (int a2 = 0; a2 < P1; ++a2)
#pragma unroll
    for (int a1 = 0; a1 < P1; ++a1)
#pragma unroll
      for (int a0 = 0; a0 < P1; ++a0) r[a2][a1][a0] = T(0);
#pragma unroll 1
  for (int q0 = 0; q0 < Q; ++q0)
    sumfac3d_slice<T, P1, Q>(a, e2, e1, e0, q0, win, r);
#pragma unroll
  for (int a2 = 0; a2 < P1; ++a2)
#pragma unroll
    for (int a1 = 0; a1 < P1; ++a1)
#pragma unroll
      for (int a0 = 0; a0 < P1; ++a0) out(a2, a1, a0, r[a2][a1][a0]);
}

// "fused": one thread an element (direction 0 fastest, so that a warp's
// atomics hit neighbouring DoFs): its masked window read through the
// read-only cache, its P1^DIM results added to r with global atomics once
// the init launch has written r (griddepcontrol.wait), times the mask.
template <typename T, int DIM, int P1, int Q>
__global__ void __launch_bounds__(128)
fused_kernel(const SumfacArgs<T> a) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long nel = 1;
#pragma unroll
  for (int d = 0; d < DIM; ++d) nel *= a.nel[d];
  if (e >= nel) return;
  int ed[DIM], i[DIM][P1];
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    ed[d] = (int)(e % a.nel[d]);
    e /= a.nel[d];
    const int s = __ldg(a.starts[d] + ed[d]);
#pragma unroll
    for (int k = 0; k < P1; ++k) i[d][k] = wrap(s + k, a.ncp[d]);
  }
  const int n0 = a.ncp[0], n1 = a.ncp[1];
  auto w_in = [&](int g) {
    T v = __ldg(a.W + g);
    if (a.mask != nullptr) v *= __ldg(a.mask + g);
    return v;
  };
  auto add = [&](int g, T v) {
    if (a.mask != nullptr) v *= __ldg(a.mask + g);
    atomicAdd(a.r + g, v);
  };
  if constexpr (DIM == 2) {
    T r[P1][P1];
    sumfac2d_element<T, P1, Q>(
        a, ed[1], ed[0],
        [&](int a1, int a0) { return w_in(i[1][a1] * n0 + i[0][a0]); },
        [&](int a1, int a0, T v) { r[a1][a0] = v; });
    asm volatile("griddepcontrol.wait;" ::: "memory");
#pragma unroll
    for (int a1 = 0; a1 < P1; ++a1)
#pragma unroll
      for (int a0 = 0; a0 < P1; ++a0) add(i[1][a1] * n0 + i[0][a0], r[a1][a0]);
  } else {
    T r[P1][P1][P1];
    sumfac3d_element<T, P1, Q>(
        a, ed[2], ed[1], ed[0],
        [&](int a2, int a1, int a0) {
          return w_in((i[2][a2] * n1 + i[1][a1]) * n0 + i[0][a0]);
        },
        [&](int a2, int a1, int a0, T v) { r[a2][a1][a0] = v; });
    asm volatile("griddepcontrol.wait;" ::: "memory");
#pragma unroll
    for (int a2 = 0; a2 < P1; ++a2)
#pragma unroll
      for (int a1 = 0; a1 < P1; ++a1)
#pragma unroll
        for (int a0 = 0; a0 < P1; ++a0)
          add((i[2][a2] * n1 + i[1][a1]) * n0 + i[0][a0], r[a2][a1][a0]);
  }
}

// a programmatic dependent of the init launch
template <typename T, int P1, int Q>
cudaError_t launch_fused(const SumfacArgs<T>& a, long long nel,
                        cudaStream_t s) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((nel + 128 - 1) / 128));
  cfg.blockDim = dim3(128);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return a.dim == 2
             ? cudaLaunchKernelEx(&cfg, fused_kernel<T, 2, P1, Q>, a)
             : cudaLaunchKernelEx(&cfg, fused_kernel<T, 3, P1, Q>, a);
}

template <typename T>
__device__ __forceinline__ T w_glob(const SumfacArgs<T>& a, int i) {
  T v = __ldg(a.W + i);
  if (a.mask != nullptr) v *= __ldg(a.mask + i);
  return v;
}

// The tile designs' arguments: a block a tile of tile[0] x tile[1]
// (x tile[2]) elements; win[d] bounds every tile's window in direction d
template <typename T>
struct TiledArgs : SumfacArgs<T> {
  int tile[3], win[3];
};

// mode 0: global atomics; 1: a store that never runs
template <typename T, int DIM, int P1, int Q>
__global__ void __launch_bounds__(128)
generic_kernel(const SumfacArgs<T> a, int mode) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long nel = 1;
  for (int d = 0; d < DIM; ++d) nel *= a.nel[d];
  if (e >= nel) return;
  int ed[DIM], i[DIM][P1];
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    ed[d] = (int)(e % a.nel[d]);
    e /= a.nel[d];
    const int s = __ldg(a.starts[d] + ed[d]);
#pragma unroll
    for (int k = 0; k < P1; ++k) i[d][k] = wrap(s + k, a.ncp[d]);
  }
  const int n0 = a.ncp[0], n1 = a.ncp[1];
  if constexpr (DIM == 2) {
    sumfac2d_element<T, P1, Q>(
        a, ed[1], ed[0],
        [&](int a1, int a0) { return w_glob(a, i[1][a1] * n0 + i[0][a0]); },
        [&](int a1, int a0, T v) {
          if (mode == 0)
            atomicAdd(a.r + i[1][a1] * n0 + i[0][a0], v);
          else if (v == T(12345.678))
            a.r[0] = v;
        });
  } else {
    sumfac3d_element<T, P1, Q>(
        a, ed[2], ed[1], ed[0],
        [&](int a2, int a1, int a0) {
          return w_glob(a, (i[2][a2] * n1 + i[1][a1]) * n0 + i[0][a0]);
        },
        [&](int a2, int a1, int a0, T v) {
          if (mode == 0)
            atomicAdd(a.r + (i[2][a2] * n1 + i[1][a1]) * n0 + i[0][a0], v);
          else if (v == T(12345.678))
            a.r[0] = v;
        });
  }
}

// The 3D arithmetic (identity geometry) with every loop unrolled
// and the tables loaded once into registers: "hoisted" keeps the window in
// the caller's memory and reads it at every q_0, "unrolled" also holds the
// element's P1^3 coefficients in registers; with q0s >= 0 ("tile_split")
// only
// that q_0 slice of the element's sum is formed.
template <typename T, int P1, int Q, bool HOLD_W, class WIn, class Out>
__device__ __forceinline__ void unrolled3d(const SumfacArgs<T>& a, int e2,
                                           int e1, int e0, const WIn& win,
                                           const Out& out, int q0s = -1) {
  T B[3][Q][P1], D[3][Q][P1], w[3][Q];
  const int ed[3] = {e0, e1, e2};
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int qq = d == 0 && q0s >= 0 ? q0s : q;  // split: one q_0 row
      w[d][q] = __ldg(a.w[d] + ed[d] * Q + qq);
#pragma unroll
      for (int k = 0; k < P1; ++k) {
        B[d][q][k] = __ldg(a.B[d] + ((size_t)ed[d] * Q + qq) * P1 + k);
        D[d][q][k] = __ldg(a.D[d] + ((size_t)ed[d] * Q + qq) * P1 + k);
      }
    }
  T u[HOLD_W ? P1 : 1][P1][P1];
  if constexpr (HOLD_W) {
#pragma unroll
    for (int a2 = 0; a2 < P1; ++a2)
#pragma unroll
      for (int a1 = 0; a1 < P1; ++a1)
#pragma unroll
        for (int a0 = 0; a0 < P1; ++a0) u[a2][a1][a0] = win(a2, a1, a0);
  }
  T r[P1][P1][P1];
#pragma unroll
  for (int a2 = 0; a2 < P1; ++a2)
#pragma unroll
    for (int a1 = 0; a1 < P1; ++a1)
#pragma unroll
      for (int a0 = 0; a0 < P1; ++a0) r[a2][a1][a0] = T(0);
  const int nq0 = q0s >= 0 ? 1 : Q;
#pragma unroll
  for (int q0 = 0; q0 < Q; ++q0) {
    if (q0 >= nq0) break;
    T tB[P1][P1], tD[P1][P1];
#pragma unroll
    for (int a2 = 0; a2 < P1; ++a2)
#pragma unroll
      for (int a1 = 0; a1 < P1; ++a1) {
        T sb = T(0), sd = T(0);
#pragma unroll
        for (int a0 = 0; a0 < P1; ++a0) {
          T x;
          if constexpr (HOLD_W) x = u[a2][a1][a0];
          else x = win(a2, a1, a0);
          sb += B[0][q0][a0] * x;
          sd += D[0][q0][a0] * x;
        }
        tB[a2][a1] = sb;
        tD[a2][a1] = sd;
      }
    T X[P1][P1], Y[P1][P1];
#pragma unroll
    for (int a2 = 0; a2 < P1; ++a2)
#pragma unroll
      for (int a1 = 0; a1 < P1; ++a1) X[a2][a1] = Y[a2][a1] = T(0);
#pragma unroll
    for (int q1 = 0; q1 < Q; ++q1) {
      T uBB[P1], uDB[P1], uBD[P1];
#pragma unroll
      for (int a2 = 0; a2 < P1; ++a2) {
        T bb = T(0), db = T(0), bd = T(0);
#pragma unroll
        for (int a1 = 0; a1 < P1; ++a1) {
          bb += B[1][q1][a1] * tB[a2][a1];
          db += D[1][q1][a1] * tB[a2][a1];
          bd += B[1][q1][a1] * tD[a2][a1];
        }
        uBB[a2] = bb;
        uDB[a2] = db;
        uBD[a2] = bd;
      }
      T Ax[P1], Cy[P1], Bz[P1];
#pragma unroll
      for (int a2 = 0; a2 < P1; ++a2) Ax[a2] = Cy[a2] = Bz[a2] = T(0);
#pragma unroll
      for (int q2 = 0; q2 < Q; ++q2) {
        T val = T(0), gx = T(0), gy = T(0), gz = T(0);
#pragma unroll
        for (int a2 = 0; a2 < P1; ++a2) {
          val += B[2][q2][a2] * uBB[a2];
          gz += D[2][q2][a2] * uBB[a2];
          gy += B[2][q2][a2] * uDB[a2];
          gx += B[2][q2][a2] * uBD[a2];
        }
        const T g = w[0][q0] * w[1][q1] * w[2][q2];
        const T wx = a.ck * g * gx, wy = a.ck * g * gy, wz = a.ck * g * gz;
        const T mv = a.cm * g * val;
#pragma unroll
        for (int a2 = 0; a2 < P1; ++a2) {
          Ax[a2] += B[2][q2][a2] * wx;
          Cy[a2] += B[2][q2][a2] * wy;
          Bz[a2] += B[2][q2][a2] * mv + D[2][q2][a2] * wz;
        }
      }
#pragma unroll
      for (int a2 = 0; a2 < P1; ++a2)
#pragma unroll
        for (int a1 = 0; a1 < P1; ++a1) {
          X[a2][a1] += B[1][q1][a1] * Ax[a2];
          Y[a2][a1] += B[1][q1][a1] * Bz[a2] + D[1][q1][a1] * Cy[a2];
        }
    }
#pragma unroll
    for (int a2 = 0; a2 < P1; ++a2)
#pragma unroll
      for (int a1 = 0; a1 < P1; ++a1)
#pragma unroll
        for (int a0 = 0; a0 < P1; ++a0)
          r[a2][a1][a0] += D[0][q0][a0] * X[a2][a1] + B[0][q0][a0] * Y[a2][a1];
  }
#pragma unroll
  for (int a2 = 0; a2 < P1; ++a2)
#pragma unroll
    for (int a1 = 0; a1 < P1; ++a1)
#pragma unroll
      for (int a0 = 0; a0 < P1; ++a0) out(a2, a1, a0, r[a2][a1][a0]);
}

// The tile design and its ablations, each its own kernel: STAGE 1 reads
// the staged window, 0 device memory; SHARED 1 sums in a shared window by
// shared atomics, 0 adds to r with global atomics; ARITH 0 the generic
// arithmetic, 2 "unrolled", 3 "tile_split" (3D identity geometry)
template <typename T, int DIM, int P1, int Q, int STAGE, int SHARED,
          int ARITH>
__global__ void __launch_bounds__(256) tile_variant(const TiledArgs<T> a) {
  constexpr int stage = STAGE, shared = SHARED, arith = ARITH;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int win_cap = 1;
  for (int d = 0; d < DIM; ++d) win_cap *= a.win[d];
  T* Wsh = reinterpret_cast<T*>(smem_raw);
  T* Rsh = Wsh + win_cap;
  // "tile_split": Q threads an element, thread (q0, element)
  int nte = 1;
  for (int d = 0; d < DIM; ++d) nte *= a.tile[d];
  const int q0s = arith == 3 ? threadIdx.x / nte : -1;
  int b = blockIdx.x, rest = arith == 3 ? threadIdx.x % nte : threadIdx.x;
  int o[DIM], n[DIM], e[DIM];
  bool live = true;
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    const int ntile = (a.nel[d] + a.tile[d] - 1) / a.tile[d];
    const int t0 = (b % ntile) * a.tile[d];
    b /= ntile;
    const int last = min(t0 + a.tile[d], a.nel[d]) - 1;
    o[d] = __ldg(a.starts[d] + t0);
    n[d] = __ldg(a.starts[d] + last) - o[d] + P1;
    e[d] = t0 + rest % a.tile[d];
    rest /= a.tile[d];
    live = live && e[d] <= last;
  }
  int nwin = 1;
  for (int d = 0; d < DIM; ++d) nwin *= n[d];
  auto glob = [&](int j) {
    int g = 0, stride = 1;
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      g += wrap(o[d] + j % n[d], a.ncp[d]) * stride;
      j /= n[d];
      stride *= a.ncp[d];
    }
    return g;
  };
  for (int i = threadIdx.x; i < nwin; i += blockDim.x) {
    if (stage) Wsh[i] = w_glob(a, glob(i));
    if (shared) Rsh[i] = T(0);
  }
  __syncthreads();
  if (live) {
    int base = 0, stride = 1;
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      base += (__ldg(a.starts[d] + e[d]) - o[d]) * stride;
      stride *= n[d];
    }
    auto rd = [&](int j) { return stage ? Wsh[j] : w_glob(a, glob(j)); };
    auto wr = [&](int j, T v) {
      if (shared)
        atomicAdd(Rsh + j, v);
      else
        atomicAdd(a.r + glob(j), v);
    };
    if constexpr (DIM == 2) {
      const int s1 = n[0];
      sumfac2d_element<T, P1, Q>(
          a, e[1], e[0],
          [&](int a1, int a0) { return rd(base + a1 * s1 + a0); },
          [&](int a1, int a0, T v) { wr(base + a1 * s1 + a0, v); });
    } else {
      const int s1 = n[0], s2 = n[0] * n[1];
      auto in = [&](int a2, int a1, int a0) {
        return rd(base + a2 * s2 + a1 * s1 + a0);
      };
      auto put = [&](int a2, int a1, int a0, T v) {
        wr(base + a2 * s2 + a1 * s1 + a0, v);
      };
      if constexpr (ARITH == 0)
        sumfac3d_element<T, P1, Q>(a, e[2], e[1], e[0], in, put);
      else if constexpr (ARITH == 3)
        unrolled3d<T, P1, Q, false>(a, e[2], e[1], e[0], in, put, q0s);
      else
        unrolled3d<T, P1, Q, true>(a, e[2], e[1], e[0], in, put);
    }
  }
  if (!shared) return;
  __syncthreads();
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int i = threadIdx.x; i < nwin; i += blockDim.x) {
    const int g = glob(i);
    T v = Rsh[i];
    if (a.mask != nullptr) v *= __ldg(a.mask + g);
    if (v != T(0)) atomicAdd(a.r + g, v);
  }
}

// "gather": the tile design with each element's P1^DIM results kept in
// shared memory and each window slot summing those of the elements that
// cover it, in a fixed order (no shared atomics).  One block a tile of
// a.tile[0] x a.tile[1] (x a.tile[2]) elements, one thread an element
// (direction 0 fastest).  Shared memory: the tile's
// window of W_in, a.win[0] x a.win[1] (x a.win[2]) values at most (a
// tile's own window is n_d = starts_d[last] - starts_d[first] + P1
// functions a direction, stored densely), and the elements' results,
// P1^DIM a thread.
template <typename T, int DIM, int P1, int Q>
__global__ void __launch_bounds__(256)
gather_kernel(const TiledArgs<T> a) {
  constexpr int NR = DIM == 2 ? P1 * P1 : P1 * P1 * P1;  // results a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int sst[3][256];  // tile's starts - o_d
  int win_cap = 1;
#pragma unroll
  for (int d = 0; d < DIM; ++d) win_cap *= a.win[d];
  const int nth = blockDim.x;
  T* Wsh = reinterpret_cast<T*>(smem_raw);
  T* Rel = Wsh + win_cap;  // [NR][nth]

  // the tile, its window origin o_d and extent n_d, its element count
  // cnt_d, this thread's element
  int b = blockIdx.x, rest = threadIdx.x;
  int o[DIM], n[DIM], e[DIM], cnt[DIM];
  bool live = true;
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    const int ntile = (a.nel[d] + a.tile[d] - 1) / a.tile[d];
    const int t0 = (b % ntile) * a.tile[d];
    b /= ntile;
    cnt[d] = min(a.tile[d], a.nel[d] - t0);
    o[d] = __ldg(a.starts[d] + t0);
    n[d] = __ldg(a.starts[d] + t0 + cnt[d] - 1) - o[d] + P1;
    e[d] = t0 + rest % a.tile[d];
    rest /= a.tile[d];
    live = live && e[d] < t0 + cnt[d];
    if (n[d] > a.win[d]) __trap();  // the wrapper's plan bounds every tile
    for (int l = threadIdx.x; l < cnt[d]; l += nth)
      sst[d][l] = __ldg(a.starts[d] + t0 + l) - o[d];
  }
  int nwin = 1;
#pragma unroll
  for (int d = 0; d < DIM; ++d) nwin *= n[d];

  // the DoF of window slot (j_{DIM-1}, ..., j_0), flat i
  auto dof = [&](int i, int j[DIM]) {
    int g = 0, stride = 1;
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      j[d] = i % n[d];
      i /= n[d];
      g += wrap(o[d] + j[d], a.ncp[d]) * stride;
      stride *= a.ncp[d];
    }
    return g;
  };

  // 1. the masked window
  for (int i = threadIdx.x; i < nwin; i += nth) {
    int j[DIM];
    const int g = dof(i, j);
    T v = __ldg(a.W + g);
    if (a.mask != nullptr) v *= __ldg(a.mask + g);
    Wsh[i] = v;
  }
  __syncthreads();

  // 2. the element's arithmetic on the window; its P1^DIM results kept
  if (live) {
    int base = 0, stride = 1;
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      base += (__ldg(a.starts[d] + e[d]) - o[d]) * stride;
      stride *= n[d];
    }
    T* mine = Rel + threadIdx.x;
    if constexpr (DIM == 2) {
      const int s1 = n[0];
      sumfac2d_element<T, P1, Q>(
          a, e[1], e[0],
          [&](int a1, int a0) { return Wsh[base + a1 * s1 + a0]; },
          [&](int a1, int a0, T v) { mine[(a1 * P1 + a0) * nth] = v; });
    } else {
      const int s1 = n[0], s2 = n[0] * n[1];
      sumfac3d_element<T, P1, Q>(
          a, e[2], e[1], e[0],
          [&](int a2, int a1, int a0) {
            return Wsh[base + a2 * s2 + a1 * s1 + a0];
          },
          [&](int a2, int a1, int a0, T v) {
            mine[((a2 * P1 + a1) * P1 + a0) * nth] = v;
          });
    }
  }
  __syncthreads();

  // 3. each window slot sums the results of the elements that cover it,
  // in a fixed order, and adds mask * sum to r with one global atomic,
  // once r holds (1 - mask) W
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int i = threadIdx.x; i < nwin; i += nth) {
    int j[DIM], lo[DIM], hi[DIM];
    const int g = dof(i, j);
#pragma unroll
    for (int d = 0; d < DIM; ++d) {  // elements l with s_l <= j < s_l + P1
      lo[d] = cnt[d];
      hi[d] = -1;
      for (int l = 0; l < cnt[d]; ++l)
        if (sst[d][l] <= j[d] && j[d] < sst[d][l] + P1) {
          lo[d] = min(lo[d], l);
          hi[d] = l;
        }
    }
    T v = T(0);
    if constexpr (DIM == 2) {
      for (int l1 = lo[1]; l1 <= hi[1]; ++l1)
        for (int l0 = lo[0]; l0 <= hi[0]; ++l0)
          v += Rel[((j[1] - sst[1][l1]) * P1 + j[0] - sst[0][l0]) * nth
                   + l1 * a.tile[0] + l0];
    } else {
      for (int l2 = lo[2]; l2 <= hi[2]; ++l2)
        for (int l1 = lo[1]; l1 <= hi[1]; ++l1)
          for (int l0 = lo[0]; l0 <= hi[0]; ++l0)
            v += Rel[(((j[2] - sst[2][l2]) * P1 + j[1] - sst[1][l1]) * P1
                      + j[0] - sst[0][l0]) * nth
                     + (l2 * a.tile[1] + l1) * a.tile[0] + l0];
    }
    if (a.mask != nullptr) v *= __ldg(a.mask + g);
    if (v != T(0)) atomicAdd(a.r + g, v);
  }
}

// "split": "fused" with Q threads an element, one a q_0 slice
// (sumfac3d_slice), 3D; a warp's lanes are 32 consecutive elements of one
// slice, so that its atomics hit neighbouring DoFs
template <typename T, int P1, int Q>
__global__ void __launch_bounds__(128) split_kernel(const SumfacArgs<T> a) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int q0 = (int)((t / 32) % Q);
  long long e = (t / (32 * Q)) * 32 + t % 32;
  const long long nel = (long long)a.nel[0] * a.nel[1] * a.nel[2];
  if (e >= nel) return;
  int ed[3], i[3][P1];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    ed[d] = (int)(e % a.nel[d]);
    e /= a.nel[d];
    const int s = __ldg(a.starts[d] + ed[d]);
#pragma unroll
    for (int k = 0; k < P1; ++k) i[d][k] = wrap(s + k, a.ncp[d]);
  }
  const int n0 = a.ncp[0], n1 = a.ncp[1];
  T r[P1][P1][P1];
#pragma unroll
  for (int a2 = 0; a2 < P1; ++a2)
#pragma unroll
    for (int a1 = 0; a1 < P1; ++a1)
#pragma unroll
      for (int a0 = 0; a0 < P1; ++a0) r[a2][a1][a0] = T(0);
  sumfac3d_slice<T, P1, Q>(
      a, ed[2], ed[1], ed[0], q0,
      [&](int a2, int a1, int a0) {
        return w_glob(a, (i[2][a2] * n1 + i[1][a1]) * n0 + i[0][a0]);
      },
      r);
#pragma unroll
  for (int a2 = 0; a2 < P1; ++a2)
#pragma unroll
    for (int a1 = 0; a1 < P1; ++a1)
#pragma unroll
      for (int a0 = 0; a0 < P1; ++a0) {
        const int g = (i[2][a2] * n1 + i[1][a1]) * n0 + i[0][a0];
        atomicAdd(a.r + g, a.mask == nullptr ? r[a2][a1][a0]
                                              : r[a2][a1][a0] * a.mask[g]);
      }
}

template <typename T>
__global__ void bc_kernel(int n, const T* __restrict__ W,
                          const T* __restrict__ mask, T* __restrict__ r) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T m = mask[i];
  r[i] = m * r[i] + (T(1) - m) * W[i];
}

template <typename T, int DIM, int P1, int Q>
cudaError_t run_design(const char* what, const TiledArgs<T>& a,
                       cudaStream_t s) {
  long long nel = 1, ndof = 1;
  int threads = 1, ntiles = 1;
  size_t win = 1;
  for (int d = 0; d < DIM; ++d) {
    nel *= a.nel[d];
    ndof *= a.ncp[d];
    threads *= a.tile[d];
    ntiles *= (a.nel[d] + a.tile[d] - 1) / a.tile[d];
    win *= a.win[d];
  }
  const bool old = !strncmp(what, "generic", 7);
  const bool tile_global = !strcmp(what, "tile_global");
  const bool nostage = !strcmp(what, "tile_nostage");
  if (!strcmp(what, "fused")) {
    sumfac_init_kernel<T><<<(unsigned)((ndof + 255) / 256), 256, 0, s>>>(
        ndof, a.W, a.mask, a.r);
    const cudaError_t e = launch_fused<T, P1, Q>(a, nel, s);
    return e != cudaSuccess ? e : cudaGetLastError();
  }
  if (!strcmp(what, "split") || !strcmp(what, "gather")) {
    sumfac_init_kernel<T><<<(unsigned)((ndof + 255) / 256), 256, 0, s>>>(
        ndof, a.W, a.mask, a.r);
    if (!strcmp(what, "split")) {
      if (DIM != 3) return cudaErrorInvalidValue;
      split_kernel<T, P1, Q><<<(unsigned)((Q * nel + 127) / 128), 128, 0,
                               s>>>(a);
    } else {
      const size_t smem = (win + (size_t)threads * P1 * P1 *
                                     (DIM == 3 ? P1 : 1)) * sizeof(T);
      const cudaError_t e = cudaFuncSetAttribute(
          gather_kernel<T, DIM, P1, Q>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
      gather_kernel<T, DIM, P1, Q><<<ntiles, threads, smem, s>>>(a);
    }
    return cudaGetLastError();
  }
  const int arith = !strcmp(what, "unrolled") ? 2
                    : !strcmp(what, "tile_split") ? 3 : 0;
  if (old || tile_global) {
    cudaError_t err = cudaMemsetAsync(a.r, 0, ndof * sizeof(T), s);
    if (err != cudaSuccess) return err;
  }
  if (old) {
    generic_kernel<T, DIM, P1, Q><<<(unsigned)((nel + 127) / 128), 128, 0,
                                    s>>>(a, strcmp(what, "generic") ? 1 : 0);
  } else {
    const size_t smem = 2 * win * sizeof(T);  // window and sums
    if (!tile_global)  // r initialised first
      sumfac_init_kernel<T><<<(unsigned)((ndof + 255) / 256), 256, 0, s>>>(
          ndof, a.W, a.mask, a.r);
    auto go = [&](auto kernel, int nthreads) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
      kernel<<<ntiles, nthreads, smem, s>>>(a);
      return cudaSuccess;
    };
    cudaError_t e;
    if (tile_global) e = go(tile_variant<T, DIM, P1, Q, 1, 0, 0>, threads);
    else if (nostage) e = go(tile_variant<T, DIM, P1, Q, 0, 1, 0>, threads);
    else if (arith == 2) e = go(tile_variant<T, DIM, P1, Q, 1, 1, 2>, threads);
    else if (arith == 3)
      e = go(tile_variant<T, DIM, P1, Q, 1, 1, 3>, Q * threads);
    else e = go(tile_variant<T, DIM, P1, Q, 1, 1, 0>, threads);
    if (e != cudaSuccess) return e;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if ((old || tile_global) && a.mask != nullptr)
    bc_kernel<T><<<(unsigned)((ndof + 255) / 256), 256, 0, s>>>(
        (int)ndof, a.W, a.mask, a.r);
  return cudaGetLastError();
}

template <typename T>
int run(const char* what, int dim, int p1, int nq, const int* nel,
        const int* ncp, const int* tile, const int* win, void** B, void** D,
        void** starts, void** w, const void* G, const void* Gm,
        const void* W, const void* mask, double ck, double cm, void* r,
        void* stream) {
  TiledArgs<T> a{};
  a.dim = dim;
  a.p1 = p1;
  a.nq = nq;
  for (int d = 0; d < dim; ++d) {
    a.nel[d] = nel[d];
    a.ncp[d] = ncp[d];
    a.tile[d] = tile[d];
    a.win[d] = win[d];
    a.B[d] = (const T*)B[d];
    a.D[d] = (const T*)D[d];
    a.starts[d] = (const int*)starts[d];
    a.w[d] = w ? (const T*)w[d] : nullptr;
  }
  a.G = (const T*)G;
  a.Gm = (const T*)Gm;
  a.W = (const T*)W;
  a.mask = (const T*)mask;
  a.ck = T(ck);
  a.cm = T(cm);
  a.r = (T*)r;
  cudaStream_t s = (cudaStream_t)stream;
  if (!strcmp(what, "port")) return (int)sumfac_apply_launch<T>(a, s);
  if (p1 != 3 || nq != 3) return (int)cudaErrorInvalidValue;  // the path's
  return (int)(dim == 2 ? run_design<T, 2, 3, 3>(what, a, s)
                        : run_design<T, 3, 3, 3>(what, a, s));
}

}  // namespace
}  // namespace tigar

extern "C" int k4_design_f32(const char* what, int dim, int p1, int nq,
                             const int* nel, const int* ncp, const int* tile,
                             const int* win, void** B, void** D,
                             void** starts, void** w, const void* G,
                             const void* Gm, const void* W, const void* mask,
                             double ck, double cm, void* r, void* stream) {
  return tigar::run<float>(what, dim, p1, nq, nel, ncp, tile, win, B, D,
                           starts, w, G, Gm, W, mask, ck, cm, r, stream);
}

extern "C" int k4_design_f64(const char* what, int dim, int p1, int nq,
                             const int* nel, const int* ncp, const int* tile,
                             const int* win, void** B, void** D,
                             void** starts, void** w, const void* G,
                             const void* Gm, const void* W, const void* mask,
                             double ck, double cm, void* r, void* stream) {
  return tigar::run<double>(what, dim, p1, nq, nel, ncp, tile, win, B, D,
                            starts, w, G, Gm, W, mask, ck, cm, r, stream);
}
