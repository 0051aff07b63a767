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
// dual level (the jets are linear: no second-order seed): the pass of a
// coefficient pair that nitsche_opcount.cpp counts and checks as the
// scheme pairing_grad's columns replaced')
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

// jets with the rows of coefficients j0 .. j0 + T - 1 of one side (rows
// [54][15], field (j % 27) / 9) on the T dual directions
template <typename S, int T>
__device__ __forceinline__ void seedT(const SidePoint<S>& sp, int j0,
                                      const S (*rows)[15],
                                      ZJets<Dual<S, T>>& J) {
  int fk[T];
#pragma unroll
  for (int t = 0; t < T; ++t) fk[t] = ((j0 + t) % 27) / 9;
  for (int f = 0; f < 3; ++f) {
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      J.g[f][a] = Dual<S, T>(sp.g[f][a]);
#pragma unroll
      for (int t = 0; t < T; ++t)
        J.g[f][a].d[t] = fk[t] == f ? rows[j0 + t][1 + a] : S(0);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        J.h[f][a][c] = Dual<S, T>(sp.h[f][a][c]);
#pragma unroll
        for (int t = 0; t < T; ++t)
          J.h[f][a][c].d[t] = fk[t] == f ? rows[j0 + t][3 + a * 2 + c] : S(0);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          J.t3[f][a][c][e] = Dual<S, T>(sp.t3[f][a][c][e]);
#pragma unroll
          for (int t = 0; t < T; ++t)
            J.t3[f][a][c][e].d[t] =
                fk[t] == f ? rows[j0 + t][7 + a * 4 + c * 2 + e] : S(0);
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

// A value with first-order parts along the two shift directions (s) and
// three jet directions (l), and the two second-order parts s[g] l[1 + g]:
// the truncated polynomials in s0, s1, l0, l1, l2 that keep of the
// second-order terms only s0 l1 and s1 l2 (an ideal's quotient, so the
// arithmetic is exact on what it keeps).
template <typename S>
struct Hyp {
  S v, s[2], l[3], sl[2];
  __device__ __forceinline__ Hyp() {}
  __device__ __forceinline__ Hyp(S x) : v(x) { zero(); }
  template <typename A, typename std::enable_if<std::is_arithmetic<A>::value,
                                                int>::type = 0>
  __device__ __forceinline__ explicit Hyp(A x) : v(S(x)) { zero(); }
  __device__ __forceinline__ void zero() {
    s[0] = s[1] = sl[0] = sl[1] = S(0);
    l[0] = l[1] = l[2] = S(0);
  }
  friend __device__ __forceinline__ Hyp operator+(const Hyp& a, const Hyp& b) {
    Hyp r;
    r.v = a.v + b.v;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      r.s[g] = a.s[g] + b.s[g];
      r.sl[g] = a.sl[g] + b.sl[g];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) r.l[k] = a.l[k] + b.l[k];
    return r;
  }
  friend __device__ __forceinline__ Hyp operator-(const Hyp& a) {
    Hyp r;
    r.v = -a.v;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      r.s[g] = -a.s[g];
      r.sl[g] = -a.sl[g];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) r.l[k] = -a.l[k];
    return r;
  }
  friend __device__ __forceinline__ Hyp operator-(const Hyp& a, const Hyp& b) {
    Hyp r;
    r.v = a.v - b.v;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      r.s[g] = a.s[g] - b.s[g];
      r.sl[g] = a.sl[g] - b.sl[g];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) r.l[k] = a.l[k] - b.l[k];
    return r;
  }
  friend __device__ __forceinline__ Hyp operator*(const Hyp& a, const Hyp& b) {
    Hyp r;
    r.v = a.v * b.v;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      r.s[g] = a.s[g] * b.v + a.v * b.s[g];
      r.sl[g] = a.sl[g] * b.v + a.v * b.sl[g] + a.s[g] * b.l[1 + g] +
                a.l[1 + g] * b.s[g];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) r.l[k] = a.l[k] * b.v + a.v * b.l[k];
    return r;
  }
  friend __device__ __forceinline__ Hyp operator/(const Hyp& a, const Hyp& b) {
    Hyp r;
    const S inv = S(1) / b.v;
    r.v = a.v * inv;
#pragma unroll
    for (int g = 0; g < 2; ++g) r.s[g] = (a.s[g] - r.v * b.s[g]) * inv;
#pragma unroll
    for (int k = 0; k < 3; ++k) r.l[k] = (a.l[k] - r.v * b.l[k]) * inv;
#pragma unroll
    for (int g = 0; g < 2; ++g)
      r.sl[g] = (a.sl[g] - r.v * b.sl[g] - r.s[g] * b.l[1 + g] -
                 r.l[1 + g] * b.s[g]) * inv;
    return r;
  }
  friend __device__ __forceinline__ Hyp sqrt(const Hyp& a) {
    Hyp r;
    r.v = sqrt(a.v);
    const S h = S(0.5) / r.v;
#pragma unroll
    for (int g = 0; g < 2; ++g) r.s[g] = a.s[g] * h;
#pragma unroll
    for (int k = 0; k < 3; ++k) r.l[k] = a.l[k] * h;
#pragma unroll
    for (int g = 0; g < 2; ++g)
      r.sl[g] = (a.sl[g] - S(2) * (r.s[g] * r.l[1 + g])) * h;
    return r;
  }
};

// The side pairing g = F . Jv (Jv = (J0 [3], JD [3][2]) held fixed, F
// the side flux of side_flux) and its gradient over the side's 42 jet
// slots, in one pass of svk_adjoint over Hyp values, in the coefficient-
// dual type Z (Z = S: the gradient; Z a one-coefficient dual seeded by
// seed1: the flux's and the gradient's derivatives along that
// coefficient, i.e. a column of the flux Jacobian and of the Hessian).
//
// F is linear in the jet gradient Phi = sqrtJ (Fg, Fh) of W at the shifted
// jets x(s) = (DF + g + s_e (d2F + h)[e], d2F + h + s_e (d3F + t3)[e]):
// g = <y0, Phi(0)> + sum_e <y_e, d_e Phi>.  The transpose of the shift-
// extended map x -> grad W(x, ref(s)) is, grad W's Jacobian D being
// symmetric at every s,  xbar.v = D ybar.v + sum_e (d_e D) ybar.d_e,
// xbar.d_e = D ybar.d_e: the l parts of a forward pass seeded with the
// (s-constant) directions ybar.v, ybar.d_0, ybar.d_1 (l0, l1, l2): l0 +
// sl0 + sl1 gives xbar.v, l[1 + e] gives xbar.d_e.  The transpose of the
// shift map then gives the slots' adjoints (gb): gbar = xbar.v[G], hbar =
// xbar.v[H] + xbar.d_c[G], t3bar = xbar.d_e[H].
template <typename Z, typename S>
__device__ void pairing_grad(const SidePoint<S>& sp,
                             const ShellRef<Dual<S, 2>>& geo,
                             const Dual<S, 2>& geo_sqrtJ, const ZJets<Z>& J,
                             const ShellConst<S>& kc, const S J0[3],
                             const S JD[3][2], Z Tm[3], Z Anu[3][2],
                             ZJets<Z>& gb) {
  using X = Hyp<Z>;
  ShellRef<X> ref;
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const Dual<S, 2>* src[3] = {&geo.a[c][d], &geo.b[c][d], &geo.ea[c][d]};
      X* dst[3] = {&ref.a[c][d], &ref.b[c][d], &ref.ea[c][d]};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        *dst[k] = X(Z(src[k]->v));
        dst[k]->s[0] = Z(src[k]->d[0]);
        dst[k]->s[1] = Z(src[k]->d[1]);
      }
    }
  const S sj = geo_sqrtJ.v;
  X G[3][2], H[3][2][2];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      G[i][a] = X(Z(sp.DF[i][a]) + J.g[i][a]);
#pragma unroll
      for (int e = 0; e < 2; ++e)
        G[i][a].s[e] = Z(sp.d2F[i][a][e]) + J.h[i][a][e];
      // ybar on Fg: d g / d B.v = J0 nu, times sqrtJ
      G[i][a].l[0] = Z(J0[i] * sp.nu[a] * sj);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        X& h = H[i][a][c];
        h = X(Z(sp.d2F[i][a][c]) + J.h[i][a][c]);
#pragma unroll
        for (int e = 0; e < 2; ++e)
          h.s[e] = Z(sp.d3F[i][a][c][e]) + J.t3[i][a][c][e];
        // ybar on Fh: d g / d A.v = JD nu, d g / d (d_c A) = -J0 nu,
        // through the shift-dual product with sqrtJ
        h.l[0] = Z(sp.nu[a] * (JD[i][c] * sj - J0[i] * geo_sqrtJ.d[c]));
        h.l[1 + c] = Z(-(J0[i] * sp.nu[a] * sj));
      }
    }
  const ShellConst<X> kx = {X(Z(kc.lam)), X(Z(kc.two_mu)), X(Z(kc.h)),
                            X(Z(kc.h3_12))};
  X Fg[3][2], Fh[3][2][2];
  svk_adjoint<X, X>(G, H, ref, kx, Fg, Fh);
  const Z nu0 = Z(sp.nu[0]), nu1 = Z(sp.nu[1]);
  const Z s0 = Z(sj), s1 = Z(geo_sqrtJ.d[0]), s2 = Z(geo_sqrtJ.d[1]);
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    // the flux as side_flux: B = sqrtJ Fg, A = sqrtJ Fh (shift duals)
    const Z T = s0 * (Fg[f][0].v * nu0 + Fg[f][1].v * nu1);
    Z divA = Z(S(0));
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const Z nn = n == 0 ? nu0 : nu1;
      Z dA = Z(S(0));
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const X& q = Fh[f][n][e];
        dA = dA + (s0 * q.s[e] + (e == 0 ? s1 : s2) * q.v);
      }
      divA = divA + dA * nn;
    }
    Tm[f] = T - divA;
#pragma unroll
    for (int d = 0; d < 2; ++d)
      Anu[f][d] = s0 * (Fh[f][0][d].v * nu0 + Fh[f][1][d].v * nu1);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      gb.g[f][a] = Fg[f][a].l[0] + Fg[f][a].sl[0] + Fg[f][a].sl[1];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const X& q = Fh[f][a][c];
        gb.h[f][a][c] = q.l[0] + q.sl[0] + q.sl[1] + Fg[f][a].l[1 + c];
#pragma unroll
        for (int e = 0; e < 2; ++e) gb.t3[f][a][c][e] = q.l[1 + e];
      }
    }
  }
}

}  // namespace nitsche
}  // namespace tigar
