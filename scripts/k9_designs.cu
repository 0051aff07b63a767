// K9 designs measured beside the port's kernel by scripts/k9_designs.py
// (built as a shared library, called through ctypes on the tensors of
// the Nitsche coupling's kernel arguments).
//
//   variant 0: the port's kernel (csrc/shell_nitsche.cu, included) at NP
//              points a block and T coefficients a thread;
//   variant 1: its staging alone (load_point), one value a thread kept;
//   variant 2: its staging and column passes (T = 1) without the scatter
//              into K (one value a thread kept), so that 0 - 2 is the
//              scatter.
#include "../tigar_tpu_torch/csrc/shell_nitsche.cu"

namespace tigar {
namespace {

template <typename S, int NP, int VARIANT>
__global__ void __launch_bounds__(NCOEF * NP)
nitsche_ablation_kernel(int nq, NitscheSide<S> sa, NitscheSide<S> sb,
                        const S* __restrict__ u_sub, NitscheConstS<S> c,
                        S* __restrict__ sink) {
  __shared__ PointData<S> PP[NP];
  const int p = threadIdx.x / NCOEF, j = threadIdx.x % NCOEF;
  const int q = blockIdx.x * NP + p;
  const NitscheSide<S> sides[2] = {sa, sb};
  PointData<S>& P = PP[p];
  load_point(min(q, nq - 1), sides, u_sub, P, j, NCOEF);
  S keep = P.rows[j][0] + P.phidf[j][0][0] + P.geo[j / 27].a[0][0].v;
  if (VARIANT == 2) {
    const int sj = j / 27, fj = (j % 27) / 9;
    ZJets<Dual<S, 1>> J, gb;
    seed1(P.side[sj], fj, P.rows[j], J);
    Dual<S, 1> Tm[3], Anu[3][2];
    pairing_grad(P.side[sj], P.geo[sj], P.sqrtJ[sj], J, c.k, P.J0,
                 P.JD[sj], Tm, Anu, gb);
    for (int f = 0; f < 3; ++f) {
      keep += Tm[f].d[0] + Anu[f][0].d[0] + Anu[f][1].d[0];
      for (int a = 0; a < 2; ++a) {
        keep += gb.g[f][a].d[0];
        for (int e = 0; e < 2; ++e) {
          keep += gb.h[f][a][e].d[0];
          for (int g = 0; g < 2; ++g) keep += gb.t3[f][a][e][g].d[0];
        }
      }
    }
  }
  if (q < nq) sink[(size_t)q * NCOEF + j] = keep;
}

template <typename S>
NitscheSide<S> side_of(void** t) {
  return {static_cast<const int*>(t[0]), static_cast<const S*>(t[1]),
          static_cast<const S*>(t[2]), static_cast<const S*>(t[3]),
          static_cast<const S*>(t[4]), static_cast<const S*>(t[5]),
          static_cast<const S*>(t[6]), static_cast<const S*>(t[7]),
          static_cast<const S*>(t[8]), static_cast<const S*>(t[9])};
}

template <typename S, int NP, int T>
void launch(int variant, int nq, int m, void** ta, void** tb, const void* wq,
            const void* surfJ, const void* u_sub, const double* consts,
            void* out) {
  const NitscheSide<S> sa = side_of<S>(ta), sb = side_of<S>(tb);
  const auto c = nitsche_consts<S>(consts);
  const int grid = (nq + NP - 1) / NP;
  const S* u = static_cast<const S*>(u_sub);
  S* o = static_cast<S*>(out);
  if (variant == 0)
    nitsche_tangent_kernel<S, NP, T><<<grid, NCOEF / T * NP>>>(
        nq, m, sa, sb, static_cast<const S*>(wq),
        static_cast<const S*>(surfJ), u, c, o);
  else if (variant == 1)
    nitsche_ablation_kernel<S, NP, 1><<<grid, NCOEF * NP>>>(nq, sa, sb, u,
                                                            c, o);
  else
    nitsche_ablation_kernel<S, NP, 2><<<grid, NCOEF * NP>>>(nq, sa, sb, u,
                                                            c, o);
}

}  // namespace
}  // namespace tigar

extern "C" {

// ta / tb: a side's (cols, R0, R1, R2, R3, DF, d2F, d3F, pinv, nu) device
// pointers, cols the support positions; out: K [m][m] zeroed (variant 0)
// or a sink of nq * 54 values; (np, T) one of those below, float64 ones
// when built with K9_DOUBLE, float32 ones otherwise
int k9_launch(int dbl, int np, int T, int variant, int nq, int m, void** ta,
              void** tb, const void* wq, const void* surfJ,
              const void* u_sub, const double* consts, void* out) {
  using namespace tigar;
#define K9_CASE(D, S, NP, TT)                                              \
  if (dbl == D && np == NP && T == TT) {                                   \
    launch<S, NP, TT>(variant, nq, m, ta, tb, wq, surfJ, u_sub, consts,   \
                      out);                                                \
    return (int)cudaGetLastError();                                       \
  }
#ifdef K9_DOUBLE
  K9_CASE(1, double, 1, 1)
  K9_CASE(1, double, 2, 1)
  K9_CASE(1, double, 2, 3)
#else
  K9_CASE(0, float, 1, 1)
  K9_CASE(0, float, 2, 1)
  K9_CASE(0, float, 4, 1)
  K9_CASE(0, float, 2, 3)
#endif
#undef K9_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
