// Device functions of the Nitsche interface kernels K8/K9
// (shell_nitsche.cu): the side point data, the shift-dependent reference
// geometry, the coefficient seeds and the side flux in nested forward
// duals.  Plain templates over the working type, so that the host
// operation count (nitsche_opcount.cpp) runs the same code.
#pragma once
#include "svk_adjoint.cuh"

namespace tigar {
namespace nitsche {

template <typename S>
struct SidePoint {
  S DF[3][2], d2F[3][2][2], d3F[3][2][2][2], pinv[2][3], nu[2];
  S val[3], g[3][2], h[3][2][2], t3[3][2][2][2];   // the side's jets
};

// Reference metric, curvature, Cartesian frame and sqrt(det a) of the
// midsurface with Jacobian Gr and Hessian Hr (models/shell.py
// shell_reference, in the working type R).
template <typename R>
__device__ __forceinline__ void shell_reference_at(const R Gr[3][2],
                                                   const R Hr[3][2][2],
                                                   ShellRef<R>& ref,
                                                   R& sqrtJ) {
  const R a0[3] = {Gr[0][0], Gr[1][0], Gr[2][0]};
  const R a1[3] = {Gr[0][1], Gr[1][1], Gr[2][1]};
  R n[3];
  cross3(a0, a1, n);
  const R nn = sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
  R a2[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) a2[i] = n[i] / nn;
  R dn[3][2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const R h0[3] = {Hr[0][0][c], Hr[1][0][c], Hr[2][0][c]};
    const R h1[3] = {Hr[0][1][c], Hr[1][1][c], Hr[2][1][c]};
    R x[3], y[3];
    cross3(h0, a1, x);
    cross3(a0, h1, y);
#pragma unroll
    for (int i = 0; i < 3; ++i) dn[i][c] = x[i] + y[i];
  }
  R da2[3][2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const R a2dn = a2[0] * dn[0][c] + a2[1] * dn[1][c] + a2[2] * dn[2][c];
#pragma unroll
    for (int i = 0; i < 3; ++i) da2[i][c] = (dn[i][c] - a2[i] * a2dn) / nn;
  }
  R bu[2][2];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      ref.a[c][d] = Gr[0][c] * Gr[0][d] + Gr[1][c] * Gr[1][d] + Gr[2][c] * Gr[2][d];
      bu[c][d] = -(Gr[0][c] * da2[0][d] + Gr[1][c] * da2[1][d] + Gr[2][c] * da2[2][d]);
    }
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int d = 0; d < 2; ++d) ref.b[c][d] = R(0.5) * (bu[c][d] + bu[d][c]);
  const R det = ref.a[0][0] * ref.a[1][1] - ref.a[0][1] * ref.a[1][0];
  const R ac00 = ref.a[1][1] / det, ac01 = -ref.a[0][1] / det;
  const R ac10 = -ref.a[1][0] / det, ac11 = ref.a[0][0] / det;
  R a0c[3], a1c[3], e0[3], e1[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    a0c[i] = ac00 * a0[i] + ac01 * a1[i];
    a1c[i] = ac10 * a0[i] + ac11 * a1[i];
  }
  const R n0 = sqrt(a0[0] * a0[0] + a0[1] * a0[1] + a0[2] * a0[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i) e0[i] = a0[i] / n0;
  const R p = a1[0] * e0[0] + a1[1] * e0[1] + a1[2] * e0[2];
#pragma unroll
  for (int i = 0; i < 3; ++i) e1[i] = a1[i] - e0[i] * p;
  const R n1 = sqrt(e1[0] * e1[0] + e1[1] * e1[1] + e1[2] * e1[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i) e1[i] = e1[i] / n1;
  ref.ea[0][0] = e0[0] * a0c[0] + e0[1] * a0c[1] + e0[2] * a0c[2];
  ref.ea[0][1] = e0[0] * a1c[0] + e0[1] * a1c[1] + e0[2] * a1c[2];
  ref.ea[1][0] = e1[0] * a0c[0] + e1[1] * a0c[1] + e1[2] * a0c[2];
  ref.ea[1][1] = e1[0] * a1c[0] + e1[1] * a1c[1] + e1[2] * a1c[2];
  sqrtJ = sqrt(det);
}

// The reference geometry of side point sp in the shift-dual type: the
// shift moves DF (by d2F) and d2F (by d3F), so a, b, ea and sqrt(det a)
// carry their two shift derivatives.
template <typename S>
__device__ __forceinline__ void shift_reference(const SidePoint<S>& sp,
                                                ShellRef<Dual<S, 2>>& geo,
                                                Dual<S, 2>& sqrtJ) {
  using R = Dual<S, 2>;
  R Gr[3][2], Hr[3][2][2];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      Gr[i][a] = R(sp.DF[i][a]);
#pragma unroll
      for (int e = 0; e < 2; ++e) Gr[i][a].d[e] = sp.d2F[i][a][e];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        Hr[i][a][c] = R(sp.d2F[i][a][c]);
#pragma unroll
        for (int e = 0; e < 2; ++e) Hr[i][a][c].d[e] = sp.d3F[i][a][c][e];
      }
    }
  shell_reference_at(Gr, Hr, geo, sqrtJ);
}

// one side's jets g, h, t3 in the coefficient-dual type Z
template <typename Z>
struct ZJets {
  Z g[3][2], h[3][2][2], t3[3][2][2][2];
};

// jets with the rows of coefficient k (field fk) on the one dual level
template <typename S>
__device__ __forceinline__ void seed1(const SidePoint<S>& sp, int fk,
                                      const S* rk, ZJets<Dual<S, 1>>& J) {
  for (int f = 0; f < 3; ++f) {
    const S on = S(f == fk ? 1 : 0);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      J.g[f][a] = Dual<S, 1>(sp.g[f][a]);
      J.g[f][a].d[0] = on * rk[1 + a];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        J.h[f][a][c] = Dual<S, 1>(sp.h[f][a][c]);
        J.h[f][a][c].d[0] = on * rk[3 + a * 2 + c];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          J.t3[f][a][c][e] = Dual<S, 1>(sp.t3[f][a][c][e]);
          J.t3[f][a][c][e].d[0] = on * rk[7 + a * 4 + c * 2 + e];
        }
      }
    }
  }
}

// jets with coefficient k on the inner and coefficient l on the outer
// dual level (the jets are linear: no second-order seed)
template <typename S>
__device__ __forceinline__ void seed2(const SidePoint<S>& sp, int fk,
                                      const S* rk, int fl, const S* rl,
                                      ZJets<Dual<Dual<S, 1>, 1>>& J) {
  using Z1 = Dual<S, 1>;
  using Z2 = Dual<Z1, 1>;
  auto mk = [](S v, S dk, S dl) {
    Z2 z;
    z.v.v = v;
    z.v.d[0] = dk;
    z.d[0].v = dl;
    z.d[0].d[0] = S(0);
    return z;
  };
  for (int f = 0; f < 3; ++f) {
    const S onk = S(f == fk ? 1 : 0), onl = S(f == fl ? 1 : 0);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      J.g[f][a] = mk(sp.g[f][a], onk * rk[1 + a], onl * rl[1 + a]);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int o2 = 3 + a * 2 + c;
        J.h[f][a][c] = mk(sp.h[f][a][c], onk * rk[o2], onl * rl[o2]);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o3 = 7 + a * 4 + c * 2 + e;
          J.t3[f][a][c][e] = mk(sp.t3[f][a][c][e], onk * rk[o3], onl * rl[o3]);
        }
      }
    }
  }
}

template <typename Z, typename S>
__device__ __forceinline__ Dual<Z, 2> lift(const Dual<S, 2>& r) {
  Dual<Z, 2> x;
  x.v = Z(r.v);
  x.d[0] = Z(r.d[0]);
  x.d[1] = Z(r.d[1]);
  return x;
}

// The side flux F = (T - div A [3], A nu [3][2]) at the tabulated point,
// in the coefficient-dual type Z (see shell_nitsche.cu), given the side's
// reference geometry and sqrt(det a) in the shift-dual type
// (shift_reference: they do not depend on the coefficients).
template <typename Z, typename S>
__device__ void side_flux(const SidePoint<S>& sp,
                          const ShellRef<Dual<S, 2>>& geo,
                          const Dual<S, 2>& geo_sqrtJ, const ZJets<Z>& J,
                          const ShellConst<S>& kc, Z Tm[3], Z Anu[3][2]) {
  using X = Dual<Z, 2>;   // the shift level over the coefficient levels
  ShellRef<X> ref;
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      ref.a[c][d] = lift<Z>(geo.a[c][d]);
      ref.b[c][d] = lift<Z>(geo.b[c][d]);
      ref.ea[c][d] = lift<Z>(geo.ea[c][d]);
    }
  const X sqrtJ = lift<Z>(geo_sqrtJ);
  X G[3][2], H[3][2][2];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      G[i][a].v = Z(sp.DF[i][a]) + J.g[i][a];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        G[i][a].d[e] = Z(sp.d2F[i][a][e]) + J.h[i][a][e];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        H[i][a][c].v = Z(sp.d2F[i][a][c]) + J.h[i][a][c];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          H[i][a][c].d[e] = Z(sp.d3F[i][a][c][e]) + J.t3[i][a][c][e];
      }
    }
  const ShellConst<X> kx = {X(kc.lam), X(kc.two_mu), X(kc.h), X(kc.h3_12)};
  X Fg[3][2], Fh[3][2][2];
  svk_adjoint<X, X>(G, H, ref, kx, Fg, Fh);
  const Z nu0 = Z(sp.nu[0]), nu1 = Z(sp.nu[1]);
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    const X B0 = sqrtJ * Fg[f][0], B1 = sqrtJ * Fg[f][1];
    const Z T = B0.v * nu0 + B1.v * nu1;
    X A[2][2];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int d = 0; d < 2; ++d) A[n][d] = sqrtJ * Fh[f][n][d];
    // div A: d/d(shift g) of A[f][n][g], contracted with nu_n
    const Z divA = (A[0][0].d[0] + A[0][1].d[1]) * nu0 +
                   (A[1][0].d[0] + A[1][1].d[1]) * nu1;
    Tm[f] = T - divA;
#pragma unroll
    for (int d = 0; d < 2; ++d) Anu[f][d] = A[0][d].v * nu0 + A[1][d].v * nu1;
  }
}

// flux index: 0..2 the T - div A of field f, 3 + 2 f + d the A nu [f][d]
__device__ __forceinline__ int fidx_anu(int f, int d) { return 3 + 2 * f + d; }

}  // namespace nitsche
}  // namespace tigar
