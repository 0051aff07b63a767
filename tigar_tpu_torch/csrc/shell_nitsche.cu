// K8 and K9: the consistent (symmetric Nitsche) coupling of two
// Kirchhoff-Love shell patches derived from the SVK shell energy
// (tigar_tpu/interface.py EnergyNitscheCoupling on svk_psi_surface with
// w_order = 2) at the interface quadrature points of InterfaceForm.
//
//   K8 replaces _iform_residual (jax.grad of InterfaceForm.energy):
//      r = dE/dU, E = sum_q wq * density(u_a, u_b).
//   K9 replaces _iform_tangent_block: the dense tangent block K [m, m]
//      over the interface support, scattered at pos_a/pos_b.
//
// The density at one point, with z the 54 local coefficients (side a
// 0..26, side b 27..53; within a side field f = k / 9, function k % 9):
//
//   D(z) = -1/surfJ sum_s c_s F_s(z_s) . Jv_s(z)
//          + 1/2 (beta_d |J0|^2 + beta_r |J1|^2),   c_a = w_a, c_b = -w_b,
//
// F_s = (T - div A [3], A nu [3][2]) the side's flux (A = sqrtJ dW/du_h,
// B = sqrtJ dW/du_g, T = B nu, div A = d_g A[:, n, g] nu_n through the
// Taylor shift of the order-3 jets), Jv_s = (J0 [3], J1 DF_s [3][2]), J0
// and J1 the value and physical-gradient jumps.  Jv_s is linear in z, so
//
//   dD/dz_i      = -1/surfJ sum_s c_s (dF_s/dz_i . Jv_s + F_s . dJv_s/dz_i)
//                  + beta_d J0 . dJ0/dz_i + beta_r J1 : dJ1/dz_i,
//   d2D/dz_i dz_j = -1/surfJ sum_s c_s (dF_s/dz_i . dJv_s/dz_j
//                  + dF_s/dz_j . dJv_s/dz_i + d2(F_s . Jv_s)/dz_i dz_j |Jv)
//                  + beta_d dJ0/dz_i . dJ0/dz_j + beta_r dJ1/dz_i : dJ1/dz_j,
//
// exactly what jax.grad / jax.hessian of the density give.  The flux is
// svk_adjoint.cuh's closed-form jet gradient (Fg = dW/du_g, Fh = dW/du_h)
// evaluated in nested forward-mode duals (shell_nitsche.cuh): the
// innermost level carries the two shift directions (through DF, d2F via
// d3F, the reference metric, curvature and frame, which depend on the
// shift, and u's g, h via h, t3), the outer levels carry one or two local
// coefficients (the jets are linear in them, so seeding the coefficient
// rows is exact).  The shifted reference geometry does not depend on the
// coefficients: each block computes it once per side, in the working
// type, and stages it in shared memory for every pass.
//
// K8: one block per quadrature point, one thread per local coefficient:
//     the flux with a one-coefficient dual gives dF_s/dz_i . Jv_s, then
//     the residual entry, atomically added into r (54 atomics a point).
// K9: TN_POINTS points a block, one thread per point and local
//     coefficient j: one pass of pairing_grad (shell_nitsche.cuh) with j
//     seeded gives dF_s/dz_j and column j of d2(F_s . Jv_s) at fixed Jv_s
//     (the symmetry of W's Hessian turns the gradient of the pairing into
//     one forward pass, and its derivative along z_j into a column), then
//     the thread adds column j of the 54 x 54 entries atomically into K
//     (zeroed by the wrapper).
// Bound: the function needs 1.8e4 (K8) and 6.3e5 (K9) operations a point
// (nitsche_opcount.cpp: reverse mode, and forward over reverse), so the
// bytes bind (K is 22.6 / 45.2 MB in f32 / f64 at the 768 fine points).
// K8's passes do 5.4e5 a point, 31x that need; K9's 54 column passes
// 2.0e6, 3.2x it (the passes of one and two coefficient duals they
// replaced did 2.4e7).

#include "kernels.h"
#include "shell_nitsche.cuh"

namespace tigar {

namespace {

using namespace nitsche;

constexpr int NCOEF = 54;   // 2 sides x 3 fields x 9 functions
constexpr int NROW = 15;    // R0, R1 [2], R2 [2][2], R3 [2][2][2]

// what both kernels stage per point in shared memory
template <typename S>
struct PointData {
  int col[NCOEF];          // conn (K8) or support position (K9)
  S coef[NCOEF];
  S rows[NCOEF][NROW];
  SidePoint<S> side[2];
  ShellRef<Dual<S, 2>> geo[2];   // shifted reference geometry per side
  Dual<S, 2> sqrtJ[2];
  S J0[3], J1[3][3], JD[2][3][2];   // JD[s] = J1 DF_s
  S phi[NCOEF][3];         // dJ1/dz_i (unsigned): R1_i pinv_s
  S phidf[NCOEF][2][2];    // phi_i DF_s' for both sides s'
};

template <typename S>
struct NitscheConstS {
  S beta_d, beta_r, wa, wb;
  ShellConst<S> k;
};

// host side: consts = {beta_d, beta_r, w_a, w_b, lam_ps, 2 mu, h, h^3/12}
template <typename S>
NitscheConstS<S> nitsche_consts(const double* c) {
  return {S(c[0]), S(c[1]), S(c[2]), S(c[3]),
          {S(c[4]), S(c[5]), S(c[6]), S(c[7])}};
}

// Stage coefficients, rows, geometry, jets and jumps of point q with the
// tn threads tid = 0 .. tn - 1 of the point (every thread of the block
// calls it: the phases are strided loops between __syncthreads, so any
// count is correct).
template <typename S>
__device__ void load_point(int q, const NitscheSide<S>* sides, const S* x,
                           PointData<S>& P, int tid, int tn) {
  for (int t = tid; t < NCOEF; t += tn) {
    const int s = t / 27;
    const size_t row = (size_t)q * 27 + t % 27;
    const NitscheSide<S>& sd = sides[s];
    P.col[t] = sd.cols[row];
    P.coef[t] = x[P.col[t]];
    P.rows[t][0] = sd.R0[row];
#pragma unroll
    for (int d = 0; d < 2; ++d) P.rows[t][1 + d] = sd.R1[row * 2 + d];
#pragma unroll
    for (int d = 0; d < 4; ++d) P.rows[t][3 + d] = sd.R2[row * 4 + d];
#pragma unroll
    for (int d = 0; d < 8; ++d) P.rows[t][7 + d] = sd.R3[row * 8 + d];
  }
  for (int t = tid; t < 100; t += tn) {
    const int s = t / 50, i = t % 50;
    const NitscheSide<S>& sd = sides[s];
    SidePoint<S>& sp = P.side[s];
    if (i < 6)
      (&sp.DF[0][0])[i] = sd.DF[(size_t)q * 6 + i];
    else if (i < 18)
      (&sp.d2F[0][0][0])[i - 6] = sd.d2F[(size_t)q * 12 + i - 6];
    else if (i < 42)
      (&sp.d3F[0][0][0][0])[i - 18] = sd.d3F[(size_t)q * 24 + i - 18];
    else if (i < 48)
      (&sp.pinv[0][0])[i - 42] = sd.pinv[(size_t)q * 6 + i - 42];
    else
      sp.nu[i - 48] = sd.nu[(size_t)q * 2 + i - 48];
  }
  __syncthreads();
  // jets: per side val 3, g 6, h 12, t3 24 slots; then the two sides'
  // reference geometry
  for (int t = tid; t < 92; t += tn) {
    if (t >= 90) {
      shift_reference(P.side[t - 90], P.geo[t - 90], P.sqrtJ[t - 90]);
      continue;
    }
    const int s = t / 45, j = t % 45;
    SidePoint<S>& sp = P.side[s];
    int f, off;
    S* dst;
    if (j < 3) {
      f = j, off = 0, dst = &sp.val[j];
    } else if (j < 9) {
      f = (j - 3) / 2, off = 1 + (j - 3) % 2, dst = &sp.g[0][0] + (j - 3);
    } else if (j < 21) {
      f = (j - 9) / 4, off = 3 + (j - 9) % 4, dst = &sp.h[0][0][0] + (j - 9);
    } else {
      f = (j - 21) / 8, off = 7 + (j - 21) % 8;
      dst = &sp.t3[0][0][0][0] + (j - 21);
    }
    S acc = S(0);
    for (int a = 0; a < 9; ++a) {
      const int i = s * 27 + f * 9 + a;
      acc += P.rows[i][off] * P.coef[i];
    }
    *dst = acc;
  }
  __syncthreads();
  for (int t = tid; t < 12 + NCOEF * 3; t += tn) {
    if (t < 3) {
      P.J0[t] = P.side[0].val[t] - P.side[1].val[t];
    } else if (t < 12) {
      const int f = (t - 3) / 3, c = (t - 3) % 3;
      S acc = S(0);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const SidePoint<S>& sp = P.side[s];
        const S gp = sp.g[f][0] * sp.pinv[0][c] + sp.g[f][1] * sp.pinv[1][c];
        acc = s == 0 ? gp : acc - gp;
      }
      P.J1[f][c] = acc;
    } else {
      const int i = (t - 12) / 3, c = (t - 12) % 3;
      const SidePoint<S>& sp = P.side[i / 27];
      P.phi[i][c] = P.rows[i][1] * sp.pinv[0][c] + P.rows[i][2] * sp.pinv[1][c];
    }
  }
  __syncthreads();
  for (int t = tid; t < 12 + NCOEF * 4; t += tn) {
    if (t < 12) {
      const int s = t / 6, f = (t % 6) / 2, d = t % 2;
      const SidePoint<S>& sp = P.side[s];
      P.JD[s][f][d] = P.J1[f][0] * sp.DF[0][d] + P.J1[f][1] * sp.DF[1][d] +
                      P.J1[f][2] * sp.DF[2][d];
    } else {
      const int i = (t - 12) / 4, s = ((t - 12) % 4) / 2, d = (t - 12) % 2;
      const SidePoint<S>& sp = P.side[s];
      P.phidf[i][s][d] = P.phi[i][0] * sp.DF[0][d] + P.phi[i][1] * sp.DF[1][d] +
                         P.phi[i][2] * sp.DF[2][d];
    }
  }
  __syncthreads();
}

template <typename S>
__global__ void __launch_bounds__(64)
nitsche_residual_kernel(NitscheSide<S> sa, NitscheSide<S> sb,
                        const S* __restrict__ wq, const S* __restrict__ surfJ,
                        const S* __restrict__ U, NitscheConstS<S> c,
                        S* __restrict__ r) {
  __shared__ PointData<S> P;
  __shared__ S dS[NCOEF];
  __shared__ S flux[2][9];
  const int q = blockIdx.x;
  const NitscheSide<S> sides[2] = {sa, sb};
  load_point(q, sides, U, P, threadIdx.x, blockDim.x);
  for (int t = threadIdx.x; t < NCOEF; t += blockDim.x) {
    const int s = t / 27, f = (t % 27) / 9;
    ZJets<Dual<S, 1>> J;
    seed1(P.side[s], f, P.rows[t], J);
    Dual<S, 1> Tm[3], Anu[3][2];
    side_flux(P.side[s], P.geo[s], P.sqrtJ[s], J, c.k, Tm, Anu);
    S acc = S(0);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      acc += Tm[i].d[0] * P.J0[i];
#pragma unroll
      for (int d = 0; d < 2; ++d) acc += Anu[i][d].d[0] * P.JD[s][i][d];
    }
    dS[t] = acc;
    if (t % 27 == 0) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        flux[s][i] = Tm[i].v;
#pragma unroll
        for (int d = 0; d < 2; ++d) flux[s][fidx_anu(i, d)] = Anu[i][d].v;
      }
    }
  }
  __syncthreads();
  const S w = wq[q], isj = S(1) / surfJ[q];
  for (int t = threadIdx.x; t < NCOEF; t += blockDim.x) {
    const int s = t / 27, f = (t % 27) / 9;
    const S sg = s == 0 ? S(1) : S(-1), R0 = P.rows[t][0];
    S pair = S(0);
#pragma unroll
    for (int s2 = 0; s2 < 2; ++s2) {
      S dP = flux[s2][f] * sg * R0;
#pragma unroll
      for (int d = 0; d < 2; ++d)
        dP += flux[s2][fidx_anu(f, d)] * sg * P.phidf[t][s2][d];
      if (s2 == s) dP += dS[t];
      pair += (s2 == 0 ? c.wa : -c.wb) * dP;
    }
    const S stab = c.beta_d * P.J0[f] * sg * R0 +
                   c.beta_r * sg * (P.J1[f][0] * P.phi[t][0] +
                                    P.J1[f][1] * P.phi[t][1] +
                                    P.J1[f][2] * P.phi[t][2]);
    atomicAdd(r + P.col[t], w * (stab - pair * isj));
  }
}

// K9 lays out TN_POINTS points a block, one thread TN_COLS local
// coefficients of one side (27 / TN_COLS threads a side)
constexpr int TN_POINTS = 2;
constexpr int TN_COLS = 1;
constexpr int TN_THREADS = NCOEF / TN_COLS * TN_POINTS;

template <typename S, int NP, int T>
__global__ void __launch_bounds__(NCOEF / T * NP)
nitsche_tangent_kernel(int nq, int m, NitscheSide<S> sa, NitscheSide<S> sb,
                       const S* __restrict__ wq, const S* __restrict__ surfJ,
                       const S* __restrict__ u_sub, NitscheConstS<S> c,
                       S* __restrict__ K) {
  constexpr int TPP = NCOEF / T;   // threads a point
  static_assert(27 % T == 0, "a thread's coefficients lie on one side");
  __shared__ PointData<S> PP[NP];
  __shared__ S Jf[NP][NCOEF][9];
  const int p = threadIdx.x / TPP, u = threadIdx.x % TPP;
  const int q = blockIdx.x * NP + p;
  const NitscheSide<S> sides[2] = {sa, sb};
  PointData<S>& P = PP[p];
  // a block's missing points stage the last one again and write nothing
  load_point(min(q, nq - 1), sides, u_sub, P, u, TPP);
  // coefficients j0 .. j0 + T - 1's pass: their columns of the flux
  // Jacobian and of their side's Hessian of F_s . Jv_s at fixed Jv_s
  const int j0 = u * T, sj = j0 / 27;
  S Hc[T][27];
  {
    ZJets<Dual<S, T>> J, gb;
    seedT<S, T>(P.side[sj], j0, P.rows, J);
    Dual<S, T> Tm[3], Anu[3][2];
    pairing_grad(P.side[sj], P.geo[sj], P.sqrtJ[sj], J, c.k, P.J0, P.JD[sj],
                 Tm, Anu, gb);
#pragma unroll
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        Jf[p][j0 + t][i] = Tm[i].d[t];
#pragma unroll
        for (int d = 0; d < 2; ++d)
          Jf[p][j0 + t][fidx_anu(i, d)] = Anu[i][d].d[t];
      }
      // the 14 slot adjoints' derivatives of each field, in row order
      S gf[3][14];
#pragma unroll
      for (int f = 0; f < 3; ++f) {
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          gf[f][a] = gb.g[f][a].d[t];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            gf[f][2 + a * 2 + e] = gb.h[f][a][e].d[t];
#pragma unroll
            for (int g = 0; g < 2; ++g)
              gf[f][6 + a * 4 + e * 2 + g] = gb.t3[f][a][e][g].d[t];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 27; ++k) {
        const S* rk = P.rows[sj * 27 + k];
        S acc = S(0);
#pragma unroll
        for (int o = 0; o < 14; ++o) acc += rk[1 + o] * gf[k / 9][o];
        Hc[t][k] = acc;
      }
    }
  }
  __syncthreads();
  if (q >= nq) return;
  const S w = wq[q], isj = S(1) / surfJ[q];
  const S gj = sj == 0 ? S(1) : S(-1);
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int j = j0 + t, fj = (j % 27) / 9;
    const S R0j = P.rows[j][0];
    const int colj = P.col[j];
#pragma unroll
    for (int i = 0; i < NCOEF; ++i) {
      const int si = i / 27, fi = (i % 27) / 9;
      const S gi = si == 0 ? S(1) : S(-1);
      const S R0i = P.rows[i][0];
      S pair = S(0);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        S acc = S(0);
        if (si == s)
          acc += gj * (Jf[p][i][fj] * R0j +
                       Jf[p][i][fidx_anu(fj, 0)] * P.phidf[j][s][0] +
                       Jf[p][i][fidx_anu(fj, 1)] * P.phidf[j][s][1]);
        if (sj == s)
          acc += gi * (Jf[p][j][fi] * R0i +
                       Jf[p][j][fidx_anu(fi, 0)] * P.phidf[i][s][0] +
                       Jf[p][j][fidx_anu(fi, 1)] * P.phidf[i][s][1]);
        if (si == s && sj == s) acc += Hc[t][i % 27];
        pair += (s == 0 ? c.wa : -c.wb) * acc;
      }
      S stab = S(0);
      if (fi == fj)
        stab = gi * gj * (c.beta_d * R0i * R0j +
                          c.beta_r * (P.phi[i][0] * P.phi[j][0] +
                                      P.phi[i][1] * P.phi[j][1] +
                                      P.phi[i][2] * P.phi[j][2]));
      atomicAdd(K + (size_t)P.col[i] * m + colj, w * (stab - pair * isj));
    }
  }
}

}  // namespace

template <typename T>
cudaError_t nitsche_iface_residual_launch(int nq, NitscheSide<T> sa,
                                          NitscheSide<T> sb, const T* wq,
                                          const T* surfJ, const T* U,
                                          const double* consts, T* r,
                                          cudaStream_t stream) {
  if (nq == 0) return cudaSuccess;
  nitsche_residual_kernel<T><<<nq, 64, 0, stream>>>(
      sa, sb, wq, surfJ, U, nitsche_consts<T>(consts), r);
  return cudaGetLastError();
}

template <typename T>
cudaError_t nitsche_iface_tangent_launch(int nq, int m, NitscheSide<T> sa,
                                         NitscheSide<T> sb, const T* wq,
                                         const T* surfJ, const T* u_sub,
                                         const double* consts, T* K,
                                         cudaStream_t stream) {
  if (nq == 0) return cudaSuccess;
  nitsche_tangent_kernel<T, TN_POINTS, TN_COLS>
      <<<(nq + TN_POINTS - 1) / TN_POINTS, TN_THREADS, 0, stream>>>(
          nq, m, sa, sb, wq, surfJ, u_sub, nitsche_consts<T>(consts), K);
  return cudaGetLastError();
}

template cudaError_t nitsche_iface_residual_launch<float>(
    int, NitscheSide<float>, NitscheSide<float>, const float*, const float*,
    const float*, const double*, float*, cudaStream_t);
template cudaError_t nitsche_iface_residual_launch<double>(
    int, NitscheSide<double>, NitscheSide<double>, const double*,
    const double*, const double*, const double*, double*, cudaStream_t);
template cudaError_t nitsche_iface_tangent_launch<float>(
    int, int, NitscheSide<float>, NitscheSide<float>, const float*,
    const float*, const float*, const double*, float*, cudaStream_t);
template cudaError_t nitsche_iface_tangent_launch<double>(
    int, int, NitscheSide<double>, NitscheSide<double>, const double*,
    const double*, const double*, const double*, double*, cudaStream_t);

}  // namespace tigar
