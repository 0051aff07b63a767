// K6 and K7: the displacement + rotation penalty coupling of two
// Kirchhoff-Love shell patches (tigar_tpu/coupling.py
// _shell_penalty_density, ShellInterfaceCoupling) at the interface
// quadrature points of tigar_tpu/interface.py InterfaceForm.
//
//   K6 replaces _iform_residual (jax.grad of InterfaceForm.energy): the
//      residual r = dE/dU, E = sum_q wq * density(u_a, u_b).
//   K7 replaces _iform_tangent_block: the dense tangent block K [m, m]
//      over the interface support, sum_q wq * B_q^T H_q B_q scattered at
//      the support positions pos_a/pos_b.
//
// The density depends only on val [3] and g [3][2] of each side, 18 jet
// slots per point (side a 0..8, side b 9..17; per side val[f] then
// g[f][d] at 3 + 2 f + d).  Its jet gradient is written out in closed form
// below (penalty_grad: pd [u] on the values; the rotation term through
// the change of the deformed unit normals), templated over the working
// type like svk_adjoint.cuh: K6 evaluates it on plain floats, K7 on
// forward-mode dual numbers seeded on the 18 slots, which gives the jet
// Hessian H_q exactly (the K1/K2 pattern).
//
// K6: one thread per quadrature point (768 at the two-patch production
//     size): gather the 2 x 3 x 9 coefficients, form the jets, the
//     gradient times wq, contract with the rows and scatter-add with 54
//     atomics.  It moves under 1 MB: launch-bound.
// K7: one block per quadrature point: the jet Hessian by 9 dual passes of
//     2 tangents, then each of the 54 x 54 entries of E_q (9 products with
//     the rows) atomically added into K.  Bound: writing K (m^2 values;
//     the wrapper zeroes it first), 22.6 / 45.2 MB in f32 / f64 at m =
//     2,376.  f32 atomics sum in a run-dependent order.
#include "kernels.h"
#include "svk_adjoint.cuh"

namespace tigar {

template <typename W>
__device__ __forceinline__ W dot3(const W* a, const W* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// unit normal of the reference surface from DF [3][2] (row major)
template <typename S>
__device__ __forceinline__ void ref_normal(const S* DF, S* n) {
  const S c0[3] = {DF[0], DF[2], DF[4]}, c1[3] = {DF[1], DF[3], DF[5]};
  cross3(c0, c1, n);
  const S nn = sqrt(dot3(n, n));
#pragma unroll
  for (int i = 0; i < 3; ++i) n[i] = n[i] / nn;
}

// Gradient F [18] of the shell penalty density with respect to the jet
// slots u [18] (see the header).  c = sign * (side b's normal change
// enters with -sign).
template <typename W, typename S>
__device__ __forceinline__ void penalty_grad(const W* u, const S* DFa,
                                             const S* DFb, S pd, S pr,
                                             S sign, W* F) {
  const S* DF[2] = {DFa, DFb};
  W c0[2][3], c1[2][3], n[2][3], nn[2];
  S n0[2][3];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      c0[s][i] = W(DF[s][i * 2 + 0]) + u[s * 9 + 3 + i * 2 + 0];
      c1[s][i] = W(DF[s][i * 2 + 1]) + u[s * 9 + 3 + i * 2 + 1];
    }
    W m[3];
    cross3(c0[s], c1[s], m);
    nn[s] = sqrt(dot3(m, m));
#pragma unroll
    for (int i = 0; i < 3; ++i) n[s][i] = m[i] / nn[s];
    ref_normal(DF[s], n0[s]);
  }
  W dn[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    dn[i] = (n[0][i] - n0[0][i]) - sign * (n[1][i] - n0[1][i]);
    const W jump = u[i] - u[9 + i];
    F[i] = pd * jump;
    F[9 + i] = (-pd) * jump;
  }
  const S coef[2] = {pr, -sign * pr};
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    // adjoint on the raw normal: (I - n n^T) coef dn / |n|
    const W p = dot3(n[s], dn);
    W lam[3], t0[3], t1[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      lam[i] = coef[s] * (dn[i] - n[s][i] * p) / nn[s];
    cross3(c1[s], lam, t0);   // d/dc0 of lam . (c0 x c1)
    cross3(lam, c0[s], t1);   // d/dc1
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      F[s * 9 + 3 + i * 2 + 0] = t0[i];
      F[s * 9 + 3 + i * 2 + 1] = t1[i];
    }
  }
}

// jet slots of one point from per-(side, field, local) coefficients
template <typename T>
__device__ __forceinline__ void point_jets(const IfaceSide<T>* sides, int q,
                                           const T* coef, T* u) {
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      T val = T(0), g0 = T(0), g1 = T(0);
      const size_t row = ((size_t)q * 3 + f) * 9;
#pragma unroll
      for (int a = 0; a < 9; ++a) {
        const T c = coef[(s * 3 + f) * 9 + a];
        val += sides[s].R0[row + a] * c;
        g0 += sides[s].R1[(row + a) * 2 + 0] * c;
        g1 += sides[s].R1[(row + a) * 2 + 1] * c;
      }
      u[s * 9 + f] = val;
      u[s * 9 + 3 + f * 2 + 0] = g0;
      u[s * 9 + 3 + f * 2 + 1] = g1;
    }
}

template <typename T>
__global__ void __launch_bounds__(128)
shell_iface_residual_kernel(int nq, IfaceSide<T> sa, IfaceSide<T> sb,
                            const T* __restrict__ wq, const T* __restrict__ U,
                            T pd, T pr, T sign, T* __restrict__ r) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= nq) return;
  const IfaceSide<T> sides[2] = {sa, sb};
  T coef[54];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int k = 0; k < 27; ++k)
      coef[s * 27 + k] = U[sides[s].conn[(size_t)q * 27 + k]];
  T u[18], F[18], DFa[6], DFb[6];
  point_jets(sides, q, coef, u);
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    DFa[k] = sa.DF[(size_t)q * 6 + k];
    DFb[k] = sb.DF[(size_t)q * 6 + k];
  }
  penalty_grad<T, T>(u, DFa, DFb, pd, pr, sign, F);
  const T w = wq[q];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      const T Fv = w * F[s * 9 + f], F0 = w * F[s * 9 + 3 + f * 2],
              F1 = w * F[s * 9 + 3 + f * 2 + 1];
      const size_t row = ((size_t)q * 3 + f) * 9;
#pragma unroll
      for (int a = 0; a < 9; ++a) {
        const T c = Fv * sides[s].R0[row + a] +
                    F0 * sides[s].R1[(row + a) * 2 + 0] +
                    F1 * sides[s].R1[(row + a) * 2 + 1];
        atomicAdd(r + sides[s].conn[row + a], c);
      }
    }
}

constexpr int TB_THREADS = 128;
constexpr int TB_ND = 2;                 // tangents per dual pass
constexpr int TB_NPASS = 18 / TB_ND;

// jet slot of derivative k (0 value, 1 g0, 2 g1) of field f on side s
__device__ __forceinline__ int jslot(int s, int f, int k) {
  return s * 9 + (k == 0 ? f : 3 + f * 2 + (k - 1));
}

template <typename T>
__global__ void __launch_bounds__(TB_THREADS)
shell_iface_tangent_kernel(int m, IfaceSide<T> sa, IfaceSide<T> sb,
                           const int* __restrict__ pos_a,
                           const int* __restrict__ pos_b,
                           const T* __restrict__ wq,
                           const T* __restrict__ u_sub, T pd, T pr, T sign,
                           T* __restrict__ K) {
  __shared__ T phi[54 * 3];
  __shared__ int pos[54];
  __shared__ T coef[54];
  __shared__ T ush[18];
  __shared__ T H[18 * 18];
  __shared__ T DFs[12];
  const int q = blockIdx.x, tid = threadIdx.x;
  const IfaceSide<T> sides[2] = {sa, sb};
  for (int i = tid; i < 54; i += TB_THREADS) {
    const int s = i / 27, k = i % 27;
    const size_t row = (size_t)q * 27 + k;
    phi[i * 3 + 0] = sides[s].R0[row];
    phi[i * 3 + 1] = sides[s].R1[row * 2 + 0];
    phi[i * 3 + 2] = sides[s].R1[row * 2 + 1];
    pos[i] = (s == 0 ? pos_a : pos_b)[row];
    coef[i] = u_sub[pos[i]];
  }
  if (tid < 12) DFs[tid] = sides[tid / 6].DF[(size_t)q * 6 + tid % 6];
  __syncthreads();
  if (tid < 18) {
    const int s = tid / 9, j = tid % 9;
    const int f = j < 3 ? j : (j - 3) / 2, k = j < 3 ? 0 : 1 + (j - 3) % 2;
    T acc = T(0);
    for (int a = 0; a < 9; ++a) {
      const int i = s * 27 + f * 9 + a;
      acc += phi[i * 3 + k] * coef[i];
    }
    ush[tid] = acc;
  }
  __syncthreads();
  if (tid < TB_NPASS) {
    using D = Dual<T, TB_ND>;
    D u[18], F[18];
#pragma unroll
    for (int k = 0; k < 18; ++k) {
      u[k] = D(ush[k]);
#pragma unroll
      for (int kk = 0; kk < TB_ND; ++kk)
        u[k].d[kk] = T(k - tid * TB_ND == kk ? 1 : 0);
    }
    penalty_grad<D, T>(u, DFs, DFs + 6, pd, pr, sign, F);
#pragma unroll
    for (int k = 0; k < 18; ++k)
#pragma unroll
      for (int kk = 0; kk < TB_ND; ++kk)
        H[k * 18 + tid * TB_ND + kk] = F[k].d[kk];
  }
  __syncthreads();
  const T w = wq[q];
  for (int e = tid; e < 54 * 54; e += TB_THREADS) {
    const int i = e / 54, j = e % 54;
    const int si = i / 27, fi = (i % 27) / 9, sj = j / 27, fj = (j % 27) / 9;
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const T* Hr = H + jslot(si, fi, k) * 18;
      T inner = T(0);
#pragma unroll
      for (int l = 0; l < 3; ++l) inner += Hr[jslot(sj, fj, l)] * phi[j * 3 + l];
      acc += phi[i * 3 + k] * inner;
    }
    atomicAdd(K + (size_t)pos[i] * m + pos[j], w * acc);
  }
}

template <typename T>
cudaError_t shell_iface_residual_launch(int nq, IfaceSide<T> sa,
                                        IfaceSide<T> sb, const T* wq,
                                        const T* U, const double* c, T* r,
                                        cudaStream_t stream) {
  if (nq == 0) return cudaSuccess;
  shell_iface_residual_kernel<T><<<(nq + 127) / 128, 128, 0, stream>>>(
      nq, sa, sb, wq, U, T(c[0]), T(c[1]), T(c[2]), r);
  return cudaGetLastError();
}

template <typename T>
cudaError_t shell_iface_tangent_launch(int nq, int m, IfaceSide<T> sa,
                                       IfaceSide<T> sb, const int* pos_a,
                                       const int* pos_b, const T* wq,
                                       const T* u_sub, const double* c, T* K,
                                       cudaStream_t stream) {
  if (nq == 0) return cudaSuccess;
  shell_iface_tangent_kernel<T><<<nq, TB_THREADS, 0, stream>>>(
      m, sa, sb, pos_a, pos_b, wq, u_sub, T(c[0]), T(c[1]), T(c[2]), K);
  return cudaGetLastError();
}

template cudaError_t shell_iface_residual_launch<float>(
    int, IfaceSide<float>, IfaceSide<float>, const float*, const float*,
    const double*, float*, cudaStream_t);
template cudaError_t shell_iface_residual_launch<double>(
    int, IfaceSide<double>, IfaceSide<double>, const double*, const double*,
    const double*, double*, cudaStream_t);
template cudaError_t shell_iface_tangent_launch<float>(
    int, int, IfaceSide<float>, IfaceSide<float>, const int*, const int*,
    const float*, const float*, const double*, float*, cudaStream_t);
template cudaError_t shell_iface_tangent_launch<double>(
    int, int, IfaceSide<double>, IfaceSide<double>, const int*, const int*,
    const double*, const double*, const double*, double*, cudaStream_t);

}  // namespace tigar
