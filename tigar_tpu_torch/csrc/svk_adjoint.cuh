// Pointwise SVK Kirchhoff-Love shell adjoint jet, templated over the
// working type T: a plain float/double (residual kernel K1), a
// forward-mode dual number over it (tangent kernel K2), or nested duals
// (the Nitsche interface kernels K8/K9).  Line for line the
// formulas of tigar_tpu/models/shell.py:svk_shell_adjoint (and of the
// port's models/shell.py): given the deformed Jacobian G = DF + u.g [3][2]
// and Hessian H = d2F + u.h [3][2][2], returns Fg [3][2] and Fh [3][2][2]
// with  dW(u; v) = sum(Fg * v.g) + sum(Fh * v.h).  The value part of the
// adjoint jet is zero (a constant load is added by the caller), and the
// density does not depend on u.val.
#pragma once
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include <type_traits>

namespace tigar {

// Value plus ND directional derivatives (forward-mode AD).
template <typename S, int ND>
struct Dual {
  S v;
  S d[ND];
  __device__ __forceinline__ Dual() {}
  __device__ __forceinline__ Dual(S x) : v(x) {
#pragma unroll
    for (int k = 0; k < ND; ++k) d[k] = S(0);
  }
  // a constant from a plain number at any nesting depth (Dual<Dual<..>>)
  template <typename A, typename std::enable_if<std::is_arithmetic<A>::value,
                                                int>::type = 0>
  __device__ __forceinline__ explicit Dual(A x) : v(S(x)) {
#pragma unroll
    for (int k = 0; k < ND; ++k) d[k] = S(0);
  }
  friend __device__ __forceinline__ Dual operator+(const Dual& a,
                                                   const Dual& b) {
    Dual r;
    r.v = a.v + b.v;
#pragma unroll
    for (int k = 0; k < ND; ++k) r.d[k] = a.d[k] + b.d[k];
    return r;
  }
  friend __device__ __forceinline__ Dual operator-(const Dual& a,
                                                   const Dual& b) {
    Dual r;
    r.v = a.v - b.v;
#pragma unroll
    for (int k = 0; k < ND; ++k) r.d[k] = a.d[k] - b.d[k];
    return r;
  }
  friend __device__ __forceinline__ Dual operator-(const Dual& a) {
    Dual r;
    r.v = -a.v;
#pragma unroll
    for (int k = 0; k < ND; ++k) r.d[k] = -a.d[k];
    return r;
  }
  friend __device__ __forceinline__ Dual operator*(const Dual& a,
                                                   const Dual& b) {
    Dual r;
    r.v = a.v * b.v;
#pragma unroll
    for (int k = 0; k < ND; ++k) r.d[k] = a.d[k] * b.v + a.v * b.d[k];
    return r;
  }
  friend __device__ __forceinline__ Dual operator*(const Dual& a, S b) {
    Dual r;
    r.v = a.v * b;
#pragma unroll
    for (int k = 0; k < ND; ++k) r.d[k] = a.d[k] * b;
    return r;
  }
  friend __device__ __forceinline__ Dual operator*(S a, const Dual& b) {
    return b * a;
  }
  friend __device__ __forceinline__ Dual operator-(const Dual& a, S b) {
    Dual r = a;
    r.v = a.v - b;
    return r;
  }
  friend __device__ __forceinline__ Dual operator/(const Dual& a,
                                                   const Dual& b) {
    Dual r;
    const S inv = S(1) / b.v;
    r.v = a.v * inv;
#pragma unroll
    for (int k = 0; k < ND; ++k) r.d[k] = (a.d[k] - r.v * b.d[k]) * inv;
    return r;
  }
  friend __device__ __forceinline__ Dual sqrt(const Dual& a) {
    Dual r;
    r.v = sqrt(a.v);
    const S h = S(0.5) / r.v;
#pragma unroll
    for (int k = 0; k < ND; ++k) r.d[k] = a.d[k] * h;
    return r;
  }
};

// Material constants in the working scalar type.
template <typename S>
struct ShellConst {
  S lam, two_mu, h, h3_12;
};

// Reference metric a, curvature b and Cartesian frame ea at one point.
template <typename S>
struct ShellRef {
  S a[2][2], b[2][2], ea[2][2];
};

template <typename T>
__device__ __forceinline__ void cross3(const T* a, const T* b, T* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// ea X ea^T (forward) for a 2x2 X.
template <typename T, typename S>
__device__ __forceinline__ void frame_fwd(const S ea[2][2], const T X[2][2],
                                          T out[2][2]) {
  T eX[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int l = 0; l < 2; ++l) eX[i][l] = ea[i][0] * X[0][l] + ea[i][1] * X[1][l];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) out[i][j] = eX[i][0] * ea[j][0] + eX[i][1] * ea[j][1];
}

// ea^T X ea (pull-back) for a 2x2 X.
template <typename T, typename S>
__device__ __forceinline__ void frame_back(const S ea[2][2], const T X[2][2],
                                           T out[2][2]) {
  T eX[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int l = 0; l < 2; ++l) eX[i][l] = ea[0][i] * X[0][l] + ea[1][i] * X[1][l];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) out[i][j] = eX[i][0] * ea[0][j] + eX[i][1] * ea[1][j];
}

template <typename T, typename S>
__device__ __forceinline__ void svk_adjoint(const T G[3][2],
                                            const T H[3][2][2],
                                            const ShellRef<S>& ref,
                                            const ShellConst<S>& k,
                                            T Fg[3][2], T Fh[3][2][2]) {
  const T a0[3] = {G[0][0], G[1][0], G[2][0]};
  const T a1[3] = {G[0][1], G[1][1], G[2][1]};
  T n[3];
  cross3(a0, a1, n);
  const T nn = sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
  T a2[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) a2[i] = n[i] / nn;

  // dn[:, c] = H[:, 0, c] x a1 + a0 x H[:, 1, c]
  T dn[3][2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const T h0[3] = {H[0][0][c], H[1][0][c], H[2][0][c]};
    const T h1[3] = {H[0][1][c], H[1][1][c], H[2][1][c]};
    T x[3], y[3];
    cross3(h0, a1, x);
    cross3(a0, h1, y);
#pragma unroll
    for (int i = 0; i < 3; ++i) dn[i][c] = x[i] + y[i];
  }
  T a2dn[2];
#pragma unroll
  for (int c = 0; c < 2; ++c)
    a2dn[c] = a2[0] * dn[0][c] + a2[1] * dn[1][c] + a2[2] * dn[2][c];
  T da2[3][2];  // deriv_a2
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int c = 0; c < 2; ++c) da2[i][c] = (dn[i][c] - a2[i] * a2dn[c]) / nn;

  // membrane strain and curvature change in the local Cartesian frame
  T X[2][2], Y[2][2];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const T cur_a = G[0][c] * G[0][d] + G[1][c] * G[1][d] + G[2][c] * G[2][d];
      const T bu_cd = -(G[0][c] * da2[0][d] + G[1][c] * da2[1][d] + G[2][c] * da2[2][d]);
      const T bu_dc = -(G[0][d] * da2[0][c] + G[1][d] * da2[1][c] + G[2][d] * da2[2][c]);
      X[c][d] = S(0.5) * (cur_a - ref.a[c][d]);
      Y[c][d] = S(0.5) * (bu_cd + bu_dc) - ref.b[c][d];
    }
  T eps[2][2], kap[2][2];
  frame_fwd(ref.ea, X, eps);
  frame_fwd(ref.ea, Y, kap);
  const T tr_e = k.lam * (eps[0][0] + eps[1][1]);
  const T tr_k = k.lam * (kap[0][0] + kap[1][1]);
  T Nm[2][2], Mm[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const T de = (i == j) ? tr_e : T(S(0));
      const T dk = (i == j) ? tr_k : T(S(0));
      Nm[i][j] = k.h * (de + k.two_mu * eps[i][j]);
      Mm[i][j] = k.h3_12 * (dk + k.two_mu * kap[i][j]);
    }
  T Nb[2][2], Mb[2][2];
  frame_back(ref.ea, Nm, Nb);
  frame_back(ref.ea, Mm, Mb);

  // adjoint (transpose of the linear tail of the first variation)
  T Sm[3][2];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int c = 0; c < 2; ++c) Sm[i][c] = -(G[i][0] * Mb[0][c] + G[i][1] * Mb[1][c]);
  T Sa2[2];
#pragma unroll
  for (int c = 0; c < 2; ++c)
    Sa2[c] = a2[0] * Sm[0][c] + a2[1] * Sm[1][c] + a2[2] * Sm[2][c];
  T R[3][2];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int c = 0; c < 2; ++c) R[i][c] = (Sm[i][c] - a2[i] * Sa2[c]) / nn;
  T Q[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    Q[i] = -((Sm[i][0] * a2dn[0] + Sm[i][1] * a2dn[1])
             + (dn[i][0] * Sa2[0] + dn[i][1] * Sa2[1])) / nn;
  T srho = Sm[0][0] * da2[0][0];
  srho = srho + Sm[0][1] * da2[0][1];
#pragma unroll
  for (int i = 1; i < 3; ++i) {
    srho = srho + Sm[i][0] * da2[i][0];
    srho = srho + Sm[i][1] * da2[i][1];
  }
  const T rho = -srho / nn;
  const T a2Q = a2[0] * Q[0] + a2[1] * Q[1] + a2[2] * Q[2];
  T t[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = (Q[i] - a2[i] * a2Q) / nn + rho * a2[i];

#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      Fg[i][c] = (G[i][0] * Nb[0][c] + G[i][1] * Nb[1][c])
                 - (da2[i][0] * Mb[0][c] + da2[i][1] * Mb[1][c]);
  T x[3], y[3];
  cross3(a1, t, x);
  cross3(t, a0, y);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    Fg[i][0] = Fg[i][0] + x[i];
    Fg[i][1] = Fg[i][1] + y[i];
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const T h0[3] = {H[0][0][c], H[1][0][c], H[2][0][c]};
    const T h1[3] = {H[0][1][c], H[1][1][c], H[2][1][c]};
    const T Rc[3] = {R[0][c], R[1][c], R[2][c]};
    cross3(h1, Rc, x);
    cross3(Rc, h0, y);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      Fg[i][0] = Fg[i][0] + x[i];
      Fg[i][1] = Fg[i][1] + y[i];
    }
    cross3(a1, Rc, x);
    cross3(Rc, a0, y);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      Fh[i][0][c] = x[i];
      Fh[i][1][c] = y[i];
    }
  }
}

}  // namespace tigar
