// Operation count of the function that K8/K9 (shell_nitsche.cu) compute,
// as the least work an implementation needs, on the host.
//
// Per interface point and side, the kernels need the side flux F = (T -
// div A, A nu) (shell_nitsche.cuh side_flux) and, for the pairing
// g = F . Jv with the jumps Jv held fixed:
//   K8 (residual):      dg/dz over the side's 27 coefficients;
//   K9 (tangent block): d2g/dz2 [27][27] and dF/dz [9][27].
// This program counts those with the cheapest general schemes, on the
// same device functions the kernels run:
//   geom  the shift-dependent reference geometry, once per side (it does
//         not depend on the coefficients);
//   jets  the side's jets from its coefficients (42 slots);
//   grad  one primal flux pass recorded on a tape and one reverse sweep
//         (reverse mode), then the map from jet slots to coefficients;
//   hess  the same over values that carry the 27 coefficient tangents
//         (forward over reverse: one primal, one sweep, every Hessian
//         column and the flux Jacobian at once), then the map.
// Every +, -, *, / and sqrt is one operation; negation and operations on
// tangents known to be zero are free.  The terms that are linear in the
// jumps (F . dJv/dz, the Jacobian products of K9, the stabilization)
// and the scatter are not counted, so the totals are below the need.
// It also counts the kernels' own passes (pass1: one coefficient dual,
// pass2: two nested) and checks the reverse-mode gradient, Jacobian and
// Hessian against those passes on the same data.
//
// Build and run (prints one JSON line, exits 1 if a check fails):
//   g++ -std=c++17 -O1 -o nitsche_opcount nitsche_opcount.cpp
//   ./nitsche_opcount
#include <cmath>
#include <cstdio>
#include <type_traits>
#include <vector>

#define __device__
#define __host__
#define __forceinline__ inline
#include "shell_nitsche.cuh"

using namespace tigar;
using namespace tigar::nitsche;
using std::sqrt;

static long long g_ops = 0;

// A value with N forward tangents; t is false while the tangents are
// known to be zero, and then no operation is counted on them.
template <int N>
struct Tn {
  double v;
  double d[N > 0 ? N : 1];
  bool t;
  Tn() : v(0.0), t(false) {}
  Tn(double x) : v(x), t(false) {}
};

// a plain number to the duals' constructors from constants (Dual(A x))
namespace std {
template <>
struct is_arithmetic<Tn<0>> : true_type {};
}  // namespace std

template <int N>
Tn<N> operator+(const Tn<N>& a, const Tn<N>& b) {
  Tn<N> r(a.v + b.v);
  ++g_ops;
  r.t = a.t || b.t;
  for (int k = 0; k < N && r.t; ++k)
    r.d[k] = (a.t ? a.d[k] : 0.0) + (b.t ? b.d[k] : 0.0);
  if (a.t && b.t) g_ops += N;
  return r;
}

template <int N>
Tn<N> operator-(const Tn<N>& a) {
  Tn<N> r(-a.v);
  r.t = a.t;
  for (int k = 0; k < N && r.t; ++k) r.d[k] = -a.d[k];
  return r;
}

template <int N>
Tn<N> operator-(const Tn<N>& a, const Tn<N>& b) {
  return a + (-b);
}

template <int N>
Tn<N> operator*(const Tn<N>& a, const Tn<N>& b) {
  Tn<N> r(a.v * b.v);
  ++g_ops;
  r.t = a.t || b.t;
  for (int k = 0; k < N && r.t; ++k)
    r.d[k] = (a.t ? a.d[k] * b.v : 0.0) + (b.t ? a.v * b.d[k] : 0.0);
  g_ops += (a.t ? N : 0) + (b.t ? N : 0) + (a.t && b.t ? N : 0);
  return r;
}

template <int N>
Tn<N> operator/(const Tn<N>& a, const Tn<N>& b) {
  Tn<N> r(a.v / b.v);
  ++g_ops;
  r.t = a.t || b.t;
  for (int k = 0; k < N && r.t; ++k)
    r.d[k] = ((a.t ? a.d[k] : 0.0) - (b.t ? r.v * b.d[k] : 0.0)) / b.v;
  if (r.t) g_ops += N + (b.t ? N : 0) + (a.t && b.t ? N : 0);
  return r;
}

template <int N>
Tn<N> sqrt(const Tn<N>& a) {
  Tn<N> r(std::sqrt(a.v));
  ++g_ops;
  r.t = a.t;
  if (a.t) {
    const double h = 0.5 / r.v;
    for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * h;
    g_ops += 1 + N;
  }
  return r;
}

// Reverse mode: a tape of nodes, each with up to two parents and the
// partial derivatives towards them.
enum : signed char { NONE = 0, ONE = 1, NEG = 2, VAL = 3 };

template <class B>
struct Node {
  int a, b;
  signed char ka, kb;
  B pa, pb;
};

template <class B>
std::vector<Node<B>>& tape() {
  static std::vector<Node<B>> t;
  return t;
}

template <class B>
struct Rev {
  B v;
  int id;
  Rev() : v(), id(-1) {}
  Rev(double x) : v(x), id(-1) {}
  Rev(const Tn<0>& x) : v(x.v), id(-1) {}
};

template <class B>
Rev<B> node(const B& v, int a, signed char ka, const B& pa, int b,
            signed char kb, const B& pb) {
  Rev<B> r;
  r.v = v;
  if (a < 0) ka = NONE;
  if (b < 0) kb = NONE;
  if (ka == NONE && kb == NONE) return r;
  tape<B>().push_back({a, b, ka, kb, pa, pb});
  r.id = (int)tape<B>().size() - 1;
  return r;
}

template <class B>
Rev<B> leaf(const B& v) {
  Rev<B> r;
  r.v = v;
  tape<B>().push_back({-1, -1, NONE, NONE, B(), B()});
  r.id = (int)tape<B>().size() - 1;
  return r;
}

template <class B>
Rev<B> operator+(const Rev<B>& a, const Rev<B>& b) {
  return node(a.v + b.v, a.id, ONE, B(), b.id, ONE, B());
}
template <class B>
Rev<B> operator-(const Rev<B>& a, const Rev<B>& b) {
  return node(a.v - b.v, a.id, ONE, B(), b.id, NEG, B());
}
template <class B>
Rev<B> operator-(const Rev<B>& a) {
  return node(-a.v, a.id, NEG, B(), -1, NONE, B());
}
template <class B>
Rev<B> operator*(const Rev<B>& a, const Rev<B>& b) {
  return node(a.v * b.v, a.id, VAL, b.v, b.id, VAL, a.v);
}
template <class B>
Rev<B> operator/(const Rev<B>& a, const Rev<B>& b) {
  if (a.id >= 0) {
    const B inv = B(1.0) / b.v;
    const B z = a.v * inv;
    return node(z, a.id, VAL, inv, b.id, VAL, b.id >= 0 ? -(z * inv) : B());
  }
  const B z = a.v / b.v;
  return node(z, -1, NONE, B(), b.id, VAL, b.id >= 0 ? -(z / b.v) : B());
}
template <class B>
Rev<B> sqrt(const Rev<B>& a) {
  const B z = sqrt(a.v);
  return node(z, a.id, VAL, a.id >= 0 ? B(0.5) / z : B(), -1, NONE, B());
}

// adjoints of every node reached from `out` (seeded with 1)
template <class B>
std::vector<B> sweep(int out) {
  const std::vector<Node<B>>& T = tape<B>();
  std::vector<B> adj(T.size());
  std::vector<char> hit(T.size(), 0);
  adj[out] = B(1.0);
  hit[out] = 1;
  auto acc = [&](int p, signed char k, const B& part, const B& g) {
    if (k == NONE) return;
    const B c = k == ONE ? g : k == NEG ? -g : g * part;
    adj[p] = hit[p] ? adj[p] + c : c;
    hit[p] = 1;
  };
  for (int i = out; i >= 0; --i) {
    if (!hit[i]) continue;
    const Node<B>& n = T[i];
    const B g = adj[i];
    acc(n.a, n.ka, n.pa, g);
    acc(n.b, n.kb, n.pb, g);
  }
  return adj;
}

// -- one side point's data, from a fixed pseudo-random sequence ---------

static double rnd() {
  static unsigned long long s = 0x9e3779b97f4a7c15ull;
  s = s * 6364136223846793005ull + 1442695040888963407ull;
  return (double)(s >> 11) / 9007199254740992.0 - 0.5;
}

struct Data {
  double DF[3][2], d2F[3][2][2], d3F[3][2][2][2], nu[2];
  double rows[27][15], z[27], J0[3], JD[3][2];
  double lam, two_mu, h, h3_12;
};

static Data make_data() {
  Data D;
  for (int i = 0; i < 3; ++i)
    for (int a = 0; a < 2; ++a) {
      D.DF[i][a] = (i == a ? 1.0 : 0.0) + 0.1 * rnd();
      for (int c = 0; c < 2; ++c) {
        D.d2F[i][a][c] = 0.1 * rnd();
        for (int e = 0; e < 2; ++e) D.d3F[i][a][c][e] = 0.1 * rnd();
      }
    }
  D.nu[0] = 0.6;
  D.nu[1] = 0.8;
  for (int i = 0; i < 27; ++i) {
    for (int o = 0; o < 15; ++o) D.rows[i][o] = rnd();
    D.z[i] = 0.05 * rnd();
  }
  for (int f = 0; f < 3; ++f) {
    D.J0[f] = rnd();
    for (int d = 0; d < 2; ++d) D.JD[f][d] = rnd();
  }
  // E = 1e7, nu = 0.3, h = 0.03, scaled by 1e-6
  D.lam = 10.0 * 0.3 / (1 - 0.09);
  D.two_mu = 10.0 / 1.3;
  D.h = 0.03;
  D.h3_12 = 0.03 * 0.03 * 0.03 / 12.0;
  return D;
}

// jet slot j of 42 (g 6, h 12, t3 24): field and row offset
static void slot(int j, int& f, int& off) {
  if (j < 6) {
    f = j / 2, off = 1 + j % 2;
  } else if (j < 18) {
    f = (j - 6) / 4, off = 3 + (j - 6) % 4;
  } else {
    f = (j - 18) / 8, off = 7 + (j - 18) % 8;
  }
}

template <typename Z>
Z& jet_at(ZJets<Z>& J, int j) {
  if (j < 6) return (&J.g[0][0])[j];
  if (j < 18) return (&J.h[0][0][0])[j - 6];
  return (&J.t3[0][0][0][0])[j - 18];
}

template <typename S>
SidePoint<S> side_point(const Data& D, const double jet[42]) {
  SidePoint<S> sp;
  for (int i = 0; i < 3; ++i)
    for (int a = 0; a < 2; ++a) {
      sp.DF[i][a] = S(D.DF[i][a]);
      for (int c = 0; c < 2; ++c) {
        sp.d2F[i][a][c] = S(D.d2F[i][a][c]);
        for (int e = 0; e < 2; ++e) sp.d3F[i][a][c][e] = S(D.d3F[i][a][c][e]);
      }
    }
  for (int d = 0; d < 2; ++d) sp.nu[d] = S(D.nu[d]);
  ZJets<S> J;
  for (int j = 0; j < 42; ++j) jet_at(J, j) = S(jet[j]);
  for (int f = 0; f < 3; ++f) {
    sp.val[f] = S(0.0);
    for (int a = 0; a < 2; ++a) {
      sp.g[f][a] = J.g[f][a];
      for (int c = 0; c < 2; ++c) {
        sp.h[f][a][c] = J.h[f][a][c];
        for (int e = 0; e < 2; ++e) sp.t3[f][a][c][e] = J.t3[f][a][c][e];
      }
    }
  }
  return sp;
}

// the pairing g = F . Jv in the flux type Z
template <typename Z>
Z pairing(const Data& D, const Z Tm[3], const Z Anu[3][2]) {
  Z g = Tm[0] * Z(D.J0[0]);
  for (int f = 0; f < 3; ++f) {
    if (f > 0) g = g + Tm[f] * Z(D.J0[f]);
    for (int d = 0; d < 2; ++d) g = g + Anu[f][d] * Z(D.JD[f][d]);
  }
  return g;
}

// one reverse-mode pass of g over base B, the jets seeded by `seed`;
// returns the adjoints of the 42 jet slots and the flux outputs
template <class B, class Seed>
std::vector<B> reverse_pass(const Data& D, const SidePoint<Tn<0>>& sp0,
                            const ShellRef<Dual<Tn<0>, 2>>& geo,
                            const Dual<Tn<0>, 2>& sqrtJ,
                            const double jet[42], Seed seed, B flux[9]) {
  using Z = Rev<B>;
  tape<B>().clear();
  ZJets<Z> J;
  int ids[42];
  for (int j = 0; j < 42; ++j) {
    B v(jet[j]);
    seed(j, v);
    jet_at(J, j) = leaf(v);
    ids[j] = jet_at(J, j).id;
  }
  const ShellConst<Tn<0>> kc = {Tn<0>(D.lam), Tn<0>(D.two_mu), Tn<0>(D.h),
                                Tn<0>(D.h3_12)};
  Z Tm[3], Anu[3][2];
  side_flux(sp0, geo, sqrtJ, J, kc, Tm, Anu);
  const Z g = pairing(D, Tm, Anu);
  for (int f = 0; f < 3; ++f) {
    flux[f] = Tm[f].v;
    for (int d = 0; d < 2; ++d) flux[3 + 2 * f + d] = Anu[f][d].v;
  }
  const std::vector<B> adj = sweep<B>(g.id);
  std::vector<B> out(42);
  for (int j = 0; j < 42; ++j) out[j] = adj[ids[j]];
  return out;
}

int main() {
  const Data D = make_data();
  double jet[42];
  for (int j = 0; j < 42; ++j) {
    int f, off;
    slot(j, f, off);
    jet[j] = 0.0;
    for (int a = 0; a < 9; ++a)
      jet[j] += D.rows[f * 9 + a][off] * D.z[f * 9 + a];
  }
  const SidePoint<Tn<0>> sp0 = side_point<Tn<0>>(D, jet);
  const SidePoint<double> spd = side_point<double>(D, jet);
  const ShellConst<Tn<0>> kc0 = {Tn<0>(D.lam), Tn<0>(D.two_mu), Tn<0>(D.h),
                                 Tn<0>(D.h3_12)};

  // geom, jets
  ShellRef<Dual<Tn<0>, 2>> geo;
  Dual<Tn<0>, 2> sqrtJ;
  g_ops = 0;
  shift_reference(sp0, geo, sqrtJ);
  const long long n_geom = g_ops;
  const long long n_jets = 42 * 17;   // 9 products and 8 sums a slot

  // primal: one flux pass and the pairing
  long long n_primal;
  {
    ZJets<Tn<0>> J;
    for (int j = 0; j < 42; ++j) jet_at(J, j) = Tn<0>(jet[j]);
    Tn<0> Tm[3], Anu[3][2];
    g_ops = 0;
    side_flux(sp0, geo, sqrtJ, J, kc0, Tm, Anu);
    pairing(D, Tm, Anu);
    n_primal = g_ops;
  }

  // grad: reverse mode, then dg/dz_i = sum over the field's 14 slots
  Tn<0> flux0[9];
  g_ops = 0;
  const std::vector<Tn<0>> a0 = reverse_pass<Tn<0>>(
      D, sp0, geo, sqrtJ, jet, [](int, Tn<0>&) {}, flux0);
  double grad[27];
  for (int i = 0; i < 27; ++i) {
    Tn<0> acc;
    bool first = true;
    for (int j = 0; j < 42; ++j) {
      int f, off;
      slot(j, f, off);
      if (f != i / 9) continue;
      const Tn<0> t = a0[j] * Tn<0>(D.rows[i][off]);
      acc = first ? t : acc + t;
      first = false;
    }
    grad[i] = acc.v;
  }
  const long long n_grad = g_ops;

  // hess: forward (27 coefficient tangents) over reverse
  Tn<27> flux1[9];
  g_ops = 0;
  const std::vector<Tn<27>> a1 = reverse_pass<Tn<27>>(
      D, sp0, geo, sqrtJ, jet,
      [&D](int j, Tn<27>& v) {
        int f, off;
        slot(j, f, off);
        v.t = true;
        for (int k = 0; k < 27; ++k)
          v.d[k] = k / 9 == f ? D.rows[k][off] : 0.0;
      },
      flux1);
  double H[27][27];
  for (int i = 0; i < 27; ++i)
    for (int k = 0; k < 27; ++k) {
      Tn<0> acc;
      bool first = true;
      for (int j = 0; j < 42; ++j) {
        int f, off;
        slot(j, f, off);
        if (f != i / 9) continue;
        const Tn<0> t = Tn<0>(a1[j].t ? a1[j].d[k] : 0.0) *
                         Tn<0>(D.rows[i][off]);
        acc = first ? t : acc + t;
        first = false;
      }
      H[i][k] = acc.v;
    }
  const long long n_hess = g_ops;

  // the kernels' passes (shell_nitsche.cu), counted and as the check
  ShellRef<Dual<double, 2>> geod;
  Dual<double, 2> sqrtJd;
  shift_reference(spd, geod, sqrtJd);
  const ShellConst<double> kcd = {D.lam, D.two_mu, D.h, D.h3_12};
  long long n_pass1 = 0, n_pass2 = 0;
  {
    ZJets<Dual<Tn<0>, 1>> J;
    Tn<0> rk[15];
    for (int o = 0; o < 15; ++o) rk[o] = Tn<0>(D.rows[0][o]);
    seed1(sp0, 0, rk, J);
    Dual<Tn<0>, 1> Tm[3], Anu[3][2];
    g_ops = 0;
    side_flux(sp0, geo, sqrtJ, J, kc0, Tm, Anu);
    n_pass1 = g_ops;
    ZJets<Dual<Dual<Tn<0>, 1>, 1>> J2;
    seed2(sp0, 0, rk, 0, rk, J2);
    Dual<Dual<Tn<0>, 1>, 1> T2[3], A2[3][2];
    g_ops = 0;
    side_flux(sp0, geo, sqrtJ, J2, kc0, T2, A2);
    n_pass2 = g_ops;
  }
  double err_g = 0, err_j = 0, err_h = 0, scale_g = 0, scale_j = 0,
         scale_h = 0;
  for (int k = 0; k < 27; ++k) {
    ZJets<Dual<double, 1>> J;
    seed1(spd, k / 9, D.rows[k], J);
    Dual<double, 1> Tm[3], Anu[3][2];
    side_flux(spd, geod, sqrtJd, J, kcd, Tm, Anu);
    double dg = 0;
    for (int f = 0; f < 3; ++f) {
      dg += Tm[f].d[0] * D.J0[f];
      err_j = std::fmax(err_j, std::fabs(Tm[f].d[0] - flux1[f].d[k]));
      scale_j = std::fmax(scale_j, std::fabs(Tm[f].d[0]));
      for (int d = 0; d < 2; ++d) {
        dg += Anu[f][d].d[0] * D.JD[f][d];
        err_j = std::fmax(err_j, std::fabs(Anu[f][d].d[0] -
                                           flux1[3 + 2 * f + d].d[k]));
        scale_j = std::fmax(scale_j, std::fabs(Anu[f][d].d[0]));
      }
    }
    err_g = std::fmax(err_g, std::fabs(dg - grad[k]));
    scale_g = std::fmax(scale_g, std::fabs(dg));
    for (int l = k; l < 27; ++l) {
      ZJets<Dual<Dual<double, 1>, 1>> J2;
      seed2(spd, k / 9, D.rows[k], l / 9, D.rows[l], J2);
      Dual<Dual<double, 1>, 1> T2[3], A2[3][2];
      side_flux(spd, geod, sqrtJd, J2, kcd, T2, A2);
      double h2 = 0;
      for (int f = 0; f < 3; ++f) {
        h2 += T2[f].d[0].d[0] * D.J0[f];
        for (int d = 0; d < 2; ++d) h2 += A2[f][d].d[0].d[0] * D.JD[f][d];
      }
      err_h = std::fmax(err_h, std::fmax(std::fabs(h2 - H[k][l]),
                                         std::fabs(h2 - H[l][k])));
      scale_h = std::fmax(scale_h, std::fabs(h2));
    }
  }
  const double rg = err_g / scale_g, rj = err_j / scale_j,
               rh = err_h / scale_h;
  const bool ok = rg < 1e-12 && rj < 1e-12 && rh < 1e-11;
  std::printf(
      "{\"per_side\": {\"geom\": %lld, \"jets\": %lld, \"primal\": %lld, "
      "\"grad\": %lld, \"hess\": %lld, \"pass1\": %lld, \"pass2\": %lld}, "
      "\"rel_err\": {\"grad\": %.3e, \"jacobian\": %.3e, \"hessian\": "
      "%.3e}, \"ok\": %s}\n",
      n_geom, n_jets, n_primal, n_grad, n_hess, n_pass1, n_pass2, rg, rj, rh,
      ok ? "true" : "false");
  return ok ? 0 : 1;
}
