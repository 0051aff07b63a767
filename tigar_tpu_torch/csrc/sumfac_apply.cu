// K4: sum-factorized stiffness/mass apply r = ck K W_in + cm M W_in.
//
// Replaces tigar_tpu/ops/sumfac.py _sumfac_apply_sliding (:208) and
// _sumfac_apply (:275), with _pad_periodic (:150) / _fold_periodic (:164):
// XLA runs them as chains of shifted-slice multiply-adds (or gathers and
// einsums) over whole quadrature-point fields in device memory.
//
// One thread per element.  Element (e_{D-1}, ..., e_0) supports the
// functions i_d = (starts_d[e_d] + a) mod ncp_d, a < P1 = p + 1, which
// covers open, reduced-continuity and periodic knot vectors alike.  The
// thread reads its window of W_in = mask * W, forms the value and the
// gradient at its Q^D quadrature points by per-direction contractions with
// B_d / D_d, weights them (identity geometry: the product of the 1D
// weights; otherwise w_c = sum_d G[d][c] g_d and Gm * value), runs the
// transposed contractions and atomically adds its P1^D results into r.
// The loops are ordered so that only one (q_1, q_0) column of the
// intermediate fields is live at a time: the 3D state is the P1^3 result,
// two P1^2 first-stage columns and two P1^2 second-stage accumulators.
// A second light pass writes mask * r + (1 - mask) W.
//
// Bound at the Poisson main path (96^3 elements, p = 2, Q = 3, identity
// geometry): operations.  Per element and per direction of travel
// 2 Q P1^3 + 3 Q^2 P1^2 + 4 Q^3 P1 = 729 multiply-adds, 1458 both ways,
// plus 4 weight products per point: ~2.7 GFLOP per apply, against ~23 MB
// for W, the mask and r in float64:
// ~79 us at 34 TFLOP/s (FP64 outside the tensor cores), ~40 us in float32
// at 67 TFLOP/s, ~7 us of memory traffic.  The tables are small and read
// through the read-only cache; neighbouring threads read neighbouring
// windows, and their atomics hit neighbouring addresses.
#include "kernels.h"

namespace tigar {
namespace {

__device__ __forceinline__ int wrap(int j, int n) {
  j %= n;
  return j < 0 ? j + n : j;
}

template <typename T>
__device__ __forceinline__ T w_in(const SumfacArgs<T>& a, int i) {
  T v = __ldg(a.W + i);
  if (a.mask != nullptr) v *= __ldg(a.mask + i);
  return v;
}

template <typename T, int P1, int Q>
__global__ void __launch_bounds__(128)
sumfac2d_kernel(const SumfacArgs<T> a) {
  const int nel0 = a.nel[0], nel1 = a.nel[1];
  const int ncp0 = a.ncp[0], ncp1 = a.ncp[1];
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)nel0 * nel1) return;
  const int e0 = (int)(e % nel0), e1 = (int)(e / nel0);
  int i0[P1], i1[P1];
  const int s0 = __ldg(a.starts[0] + e0), s1 = __ldg(a.starts[1] + e1);
#pragma unroll
  for (int k = 0; k < P1; ++k) {
    i0[k] = wrap(s0 + k, ncp0);
    i1[k] = wrap(s1 + k, ncp1);
  }
  const T* B0 = a.B[0] + (size_t)e0 * Q * P1;
  const T* D0 = a.D[0] + (size_t)e0 * Q * P1;
  const T* B1 = a.B[1] + (size_t)e1 * Q * P1;
  const T* D1 = a.D[1] + (size_t)e1 * Q * P1;
  const T ck = a.ck, cm = a.cm;

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
        const T w = w_in(a, i1[a1] * ncp0 + i0[a0]);
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
        const size_t pt = (size_t)e * (Q * Q) + q1 * Q + q0;
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
    for (int a0 = 0; a0 < P1; ++a0)
      atomicAdd(a.r + i1[a1] * ncp0 + i0[a0], r[a1][a0]);
}

template <typename T, int P1, int Q>
__global__ void __launch_bounds__(128)
sumfac3d_kernel(const SumfacArgs<T> a) {
  const int nel0 = a.nel[0], nel1 = a.nel[1], nel2 = a.nel[2];
  const int ncp0 = a.ncp[0], ncp1 = a.ncp[1], ncp2 = a.ncp[2];
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)nel0 * nel1 * nel2) return;
  const int e0 = (int)(e % nel0);
  const int e1 = (int)((e / nel0) % nel1);
  const int e2 = (int)(e / ((long long)nel0 * nel1));
  int i0[P1], i1[P1], i2[P1];
  const int s0 = __ldg(a.starts[0] + e0), s1 = __ldg(a.starts[1] + e1),
            s2 = __ldg(a.starts[2] + e2);
#pragma unroll
  for (int k = 0; k < P1; ++k) {
    i0[k] = wrap(s0 + k, ncp0);
    i1[k] = wrap(s1 + k, ncp1);
    i2[k] = wrap(s2 + k, ncp2);
  }
  const T* B0 = a.B[0] + (size_t)e0 * Q * P1;
  const T* D0 = a.D[0] + (size_t)e0 * Q * P1;
  const T* B1 = a.B[1] + (size_t)e1 * Q * P1;
  const T* D1 = a.D[1] + (size_t)e1 * Q * P1;
  const T* B2 = a.B[2] + (size_t)e2 * Q * P1;
  const T* D2 = a.D[2] + (size_t)e2 * Q * P1;
  const bool identity = a.G == nullptr;
  const T ck = a.ck, cm = a.cm;

  T r[P1][P1][P1];  // [a2][a1][a0]
#pragma unroll
  for (int a2 = 0; a2 < P1; ++a2)
#pragma unroll
    for (int a1 = 0; a1 < P1; ++a1)
#pragma unroll
      for (int a0 = 0; a0 < P1; ++a0) r[a2][a1][a0] = T(0);

#pragma unroll 1
  for (int q0 = 0; q0 < Q; ++q0) {
    T tB[P1][P1], tD[P1][P1];  // direction-0 contractions, [a2][a1]
#pragma unroll
    for (int a2 = 0; a2 < P1; ++a2)
#pragma unroll
      for (int a1 = 0; a1 < P1; ++a1) {
        const int row = (i2[a2] * ncp1 + i1[a1]) * ncp0;
        T sb = T(0), sd = T(0);
#pragma unroll
        for (int a0 = 0; a0 < P1; ++a0) {
          const T w = w_in(a, row + i0[a0]);
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
          const size_t pt = (size_t)e * (Q * Q * Q) + (q2 * Q + q1) * Q + q0;
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
#pragma unroll
  for (int a2 = 0; a2 < P1; ++a2)
#pragma unroll
    for (int a1 = 0; a1 < P1; ++a1)
#pragma unroll
      for (int a0 = 0; a0 < P1; ++a0)
        atomicAdd(a.r + (i2[a2] * ncp1 + i1[a1]) * ncp0 + i0[a0],
                  r[a2][a1][a0]);
}

// zeroRowsColumns epilogue with a unit diagonal: r = mask r + (1 - mask) W
template <typename T>
__global__ void sumfac_bc_kernel(int n, const T* __restrict__ W,
                                 const T* __restrict__ mask,
                                 T* __restrict__ r) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T m = mask[i];
  r[i] = m * r[i] + (T(1) - m) * W[i];
}

template <typename T, int P1, int Q>
void launch_main(const SumfacArgs<T>& a, long long nel, cudaStream_t s) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((nel + threads - 1) / threads);
  if (a.dim == 2)
    sumfac2d_kernel<T, P1, Q><<<blocks, threads, 0, s>>>(a);
  else
    sumfac3d_kernel<T, P1, Q><<<blocks, threads, 0, s>>>(a);
}

}  // namespace

template <typename T>
cudaError_t sumfac_apply_launch(const SumfacArgs<T>& a,
                                cudaStream_t stream) {
  if (a.dim != 2 && a.dim != 3) return cudaErrorInvalidValue;
  long long nel = 1, ndof = 1;
  for (int d = 0; d < a.dim; ++d) {
    nel *= a.nel[d];
    ndof *= a.ncp[d];
  }
  cudaError_t err = cudaMemsetAsync(a.r, 0, ndof * sizeof(T), stream);
  if (err != cudaSuccess) return err;
  if (nel > 0) {
    switch (a.p1 * 10 + (a.nq - a.p1)) {
      case 20: launch_main<T, 2, 2>(a, nel, stream); break;
      case 21: launch_main<T, 2, 3>(a, nel, stream); break;
      case 30: launch_main<T, 3, 3>(a, nel, stream); break;
      case 31: launch_main<T, 3, 4>(a, nel, stream); break;
      case 40: launch_main<T, 4, 4>(a, nel, stream); break;
      case 41: launch_main<T, 4, 5>(a, nel, stream); break;
      default: return cudaErrorInvalidValue;
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (a.mask != nullptr && ndof > 0) {
    const int threads = 256;
    sumfac_bc_kernel<T><<<(unsigned)((ndof + threads - 1) / threads),
                          threads, 0, stream>>>((int)ndof, a.W, a.mask,
                                                a.r);
  }
  return cudaGetLastError();
}

template cudaError_t sumfac_apply_launch<float>(const SumfacArgs<float>&,
                                                cudaStream_t);
template cudaError_t sumfac_apply_launch<double>(const SumfacArgs<double>&,
                                                 cudaStream_t);

}  // namespace tigar
