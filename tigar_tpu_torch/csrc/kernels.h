// Launchers of the port's hand-written CUDA kernels (plain C++ interface:
// device pointers, sizes, the stream).  Each returns cudaGetLastError()
// after its launch.  Explicitly instantiated for float and double in the
// .cu files; bindings.cpp is the only caller.
#pragma once
#include <cstddef>

#include <cuda_runtime.h>

namespace tigar {

// The current device's streaming multiprocessor count, read once (132 on
// the H100 SXM, also the fallback).
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

// Lets ``kernel`` take ``bytes`` of dynamic shared memory when that is above
// ``*allowed`` (the caller's record for this kernel, 48 KB to begin with).
inline cudaError_t allow_smem(const void* kernel, size_t bytes,
                              size_t* allowed) {
  if (bytes <= *allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) *allowed = bytes;
  return e;
}

// K1: SVK shell residual, one thread per quadrature point, nen = 9 or 16
// local functions a field (conn [nel][3 nen]); mask [nel][nen] (padding
// of ragged elements) or nullptr.
// consts = {lam_ps, 2 mu, h, h^3/12, load0, load1, load2}.
template <typename T>
cudaError_t shell_residual_launch(int nel, int nq, int nen, const int* conn,
                                  const T* U, const T* N, const T* dN,
                                  const T* d2N, const T* scale, const T* DF,
                                  const T* d2F, const T* ref_a,
                                  const T* ref_b, const T* ea, const T* mask,
                                  const double* consts, T* r,
                                  cudaStream_t stream);

// K2: SVK shell tangent stencil of biquadratic elements: the element
// matrices into the scratch E [nel][27][27], then their fold into every
// entry of S [3,3,5,5,nel_y+2,nel_x+2] (no initialisation needed).
// consts = {lam_ps, 2 mu, h, h^3/12}.
template <typename T>
cudaError_t tangent_stencil_launch(int nel_y, int nel_x, int nq,
                                   const int* conn, const T* U, const T* dN,
                                   const T* d2N, const T* scale, const T* DF,
                                   const T* d2F, const T* ref_a,
                                   const T* ref_b, const T* ea,
                                   const double* consts, T* E, T* S,
                                   cudaStream_t stream);

// K2, element mode: the element matrices of nen = 9 or 16 local functions
// a field (1 <= nq <= 16) written to E [nel][3 nen][3 nen] (every entry
// written, no initialisation); entry ((f,a),(g,b)) times mask[e][a]
// mask[e][b] when the padding mask [nel][nen] is given, and times
// me[e][row] me[e][col] when me [nel][3 nen] is given.
template <typename T>
cudaError_t tangent_elements_launch(int nel, int nq, int nen,
                                    const int* conn, const T* U,
                                    const T* dN, const T* d2N,
                                    const T* scale, const T* DF,
                                    const T* d2F, const T* ref_a,
                                    const T* ref_b, const T* ea,
                                    const T* mask, const double* consts,
                                    const T* me, T* E, cudaStream_t stream);

// K3: stencil apply.  mode 0: y = A x; 1: y = b - A x;
// 2: y = x + (omega dinv) (b - A x); A is masked when mask != nullptr.
// Every vector holds DoF (f, i) of the ny x nx grid at
// base + f * fstride + i (base 0, fstride ny * nx for a single patch).
template <typename T>
cudaError_t stencil_apply_launch(int ny, int nx, const T* S, const T* x,
                                 const T* mask, const T* b, const T* dinv,
                                 double omega, int mode, int base,
                                 int fstride, T* y, cudaStream_t stream);

// K4: sum-factorized r = ck K (mask W) + cm M (mask W), then, when mask is
// given, r = mask r + (1 - mask) W.  Per direction d (0 first): B, D
// [nel_d][nq][p1], starts [nel_d]; identity geometry takes the 1D weights
// w [nel_d][nq] and G = Gm = nullptr, a metric G [nel][nq^dim][dim][dim]
// and Gm [nel][nq^dim] (elements and points in C order over directions
// dim-1..0).  p1 in 2..4, nq in {p1, p1 + 1}.
template <typename T>
struct SumfacArgs {
  int dim, p1, nq;
  int nel[3], ncp[3];
  const T* B[3];
  const T* D[3];
  const int* starts[3];
  const T* w[3];
  const T* G;
  const T* Gm;
  const T* W;
  const T* mask;
  T ck, cm;
  T* r;
};

template <typename T>
cudaError_t sumfac_apply_launch(const SumfacArgs<T>& a, cudaStream_t stream);

// K5: out[idx[i]] += alpha m_i sum_j B[i][j] m_j v[idx[j]] for one dense
// interface block B [m][m] over the sorted, unique support idx [m];
// m_i = mask[idx[i]] (1 when mask == nullptr).  Each block holds the
// gathered vector, and with a mask its mask values, in shared memory:
// iface_block_smem bytes, at most 227 KB.
template <typename T>
constexpr size_t iface_block_smem(long long m, bool masked) {
  return (size_t)m * sizeof(T) * (masked ? 2 : 1);
}
template <typename T>
cudaError_t iface_block_launch(int m, const T* B, const int* idx,
                               const T* mask, const T* v, double alpha,
                               T* out, cudaStream_t stream);

// One side of a shell interface at nq points: conn [nq][3][9] global DoF
// indices, rows R0 [nq][3][9] and R1 [nq][3][9][2], DF [nq][3][2].
template <typename T>
struct IfaceSide {
  const int* conn;
  const T* R0;
  const T* R1;
  const T* DF;
};

// K6: shell-penalty interface residual, r += dE/dU (r zero-initialised).
// consts = {penalty_disp, penalty_rot, orientation sign}.
template <typename T>
cudaError_t shell_iface_residual_launch(int nq, IfaceSide<T> sa,
                                        IfaceSide<T> sb, const T* wq,
                                        const T* U, const double* consts,
                                        T* r, cudaStream_t stream);

// K7: shell-penalty interface tangent block K [m][m] (zero-initialised) at
// u_sub = U[idx]; pos_a/pos_b [nq][3][9] are the columns' positions in idx.
template <typename T>
cudaError_t shell_iface_tangent_launch(int nq, int m, IfaceSide<T> sa,
                                       IfaceSide<T> sb, const int* pos_a,
                                       const int* pos_b, const T* wq,
                                       const T* u_sub, const double* consts,
                                       T* K, cudaStream_t stream);

// One side of a Nitsche shell interface at nq points: cols [nq][3][9]
// (global DoF indices for K8, positions in the support for K9), rows R0
// [nq][3][9], R1 [..][2], R2 [..][2][2], R3 [..][2][2][2], geometry DF
// [nq][3][2], d2F [nq][3][2][2], d3F [nq][3][2][2][2], pinv [nq][2][3],
// the flat conormal nu [nq][2].
template <typename T>
struct NitscheSide {
  const int* cols;
  const T* R0;
  const T* R1;
  const T* R2;
  const T* R3;
  const T* DF;
  const T* d2F;
  const T* d3F;
  const T* pinv;
  const T* nu;
};

// K8: consistent (Nitsche) SVK shell interface residual, r += dE/dU (r
// zero-initialised, U and r of ndof entries).  consts = {beta_d, beta_r,
// w_a, w_b, lam_ps, 2 mu, h, h^3/12}.
template <typename T>
cudaError_t nitsche_iface_residual_launch(int nq, NitscheSide<T> sa,
                                          NitscheSide<T> sb, const T* wq,
                                          const T* surfJ, const T* U,
                                          const double* consts, T* r,
                                          cudaStream_t stream);

// K9: its tangent block K [m][m] (zero-initialised) at u_sub = U[idx]; the
// sides' cols are the positions in idx.
template <typename T>
cudaError_t nitsche_iface_tangent_launch(int nq, int m, NitscheSide<T> sa,
                                         NitscheSide<T> sb, const T* wq,
                                         const T* surfJ, const T* u_sub,
                                         const double* consts, T* K,
                                         cudaStream_t stream);

// K10: element-batch tangent y = m * scatter(conn, E (m x)[conn]) +
// (1 - m) x over ndof DoFs (m = 1 and no (1 - m) x term when mask is
// nullptr); conn [nel][nloc], E [nel][nloc][nloc], nloc <= 64.
template <typename T>
cudaError_t elem_tangent_apply_launch(int nel, int nloc, int ndof,
                                      const int* conn, const T* E,
                                      const T* x, const T* mask, T* y,
                                      cudaStream_t stream);

// K10's diagonal: d += scatter(conn, diag E) (d zero-initialised).
template <typename T>
cudaError_t elem_tangent_diagonal_launch(int nel, int nloc, const int* conn,
                                         const T* E, T* d,
                                         cudaStream_t stream);

// K11: sliced ELL product over n rows in ntiles tiles: tile t = tiles[t]
// = (row0, width, lanes) covers rows row0 .. row0 + ELL_THREADS / lanes - 1
// (to n), lanes in {4, 8, ..., 256} a row, and holds their slots row-major at
// cols/vals[starts[t] + r width + k], width a multiple of 4 (16-byte
// aligned chunks of cols).  mode 0: y = A x; 1: y = b - A x;
// 2: y = x + om_dinv (b - A x); 3: the same at x = x0 = om_dinv b (x
// unused); 4: y = b + A x.  ops/sparse.sliced_ell builds the tiles for
// blocks of ELL_THREADS threads.
constexpr int ELL_THREADS = 256;

template <typename T>
cudaError_t ell_spmv_launch(int n, int ntiles, const int* tiles,
                            const long long* starts, const int* cols,
                            const T* vals, const T* x, const T* b,
                            const T* om_dinv, int mode, T* y,
                            cudaStream_t stream);

// K12: f32 scalar stiffness apply r = mask A (mask W) + (1 - mask) W over
// connT [nen][nel] (nen in {4, 8, 9, 16, 27, 64}) with the element matrices'
// upper triangles Ke [nen (nen + 1) / 2][nel] (row a nen - a (a - 1) / 2 +
// b - a holds K_e[a][b], a <= b); r of ndof entries, every entry written.
// A block whose elements touch a DoF range of more than LAPLACE_WINDOW
// entries adds to r with global atomics instead of its shared window.
constexpr int LAPLACE_WINDOW = 2048;
cudaError_t laplace_apply_launch(int nel, int nen, int ndof, const float* Ke,
                                 const int* connT, const float* mask,
                                 const float* W, float* r,
                                 cudaStream_t stream);

// K13 (v == nullptr) / K14: all-pairs penalty contact over n points x
// [n][3] with weights w [n] and the bool mask [n][ld] (ld a multiple of 16,
// columns n..ld-1 zero, 16-byte aligned): K13 writes the pair forces
// out_i = k w_i sum_j live w_j (1 - r_max/r) d, K14 their tangent action
// on the perturbations v [n][3]; every row written once.
template <typename T>
cudaError_t contact_pairs_launch(int n, long long ld,
                                 const unsigned char* mask, const T* x,
                                 const T* v, const T* w, double k,
                                 double r_max, T* out, cudaStream_t stream);

// K15 / K16: one tensor-product field plan in dim = 2 or 3 directions and
// where its coefficient columns sit.  Direction d: nel[d] elements, nq
// points an element, pp[d] = p_d + 1 <= 4 functions an element, ncp[d]
// coefficients (ncp[2] = 1 in 2D), tables tab[d] [nel][nq][nders + 1][pp]
// (nders 1 or 2); windows start[d] + stride[d] e + a (idx[d] == nullptr)
// or idx[d] [nel][pp]; K16 reads gather windows through inv[d]: [ncp + 1]
// offsets, then the entries e pp + a of every coefficient.  Column c <
// ncols of coefficient i = i_0 + ncp_0 (i_1 + ncp_1 i_2) sits at
// base + c col_stride + i cp_stride of the coefficient vector; its jets are
// column col0 + c of M of the npts points (grid (e_{D-1}, q_{D-1}, ...,
// e_0, q_0), e_{D-1} slowest).
template <typename T>
struct SumfacJetsArgs {
  int dim, nders, nq;
  int nel[3], pp[3], ncp[3], start[3], stride[3];
  const T* tab[3];
  const int* idx[3];
  const int* inv[3];
  long long base, col_stride, cp_stride;
  int ncols, col0, M;
  long long npts;
};

// K15: val [npts][M], g [npts][M][dim], h [npts][M][dim][dim] (nders 2;
// else unused) of the columns, each entry of columns col0..col0+ncols-1
// written once.
template <typename T>
cudaError_t sumfac_jets_launch(const SumfacJetsArgs<T>& a, const T* W,
                               T* val, T* g, T* h, cudaStream_t stream);

// K16: the transpose: out[base + c col_stride + i cp_stride] = the jet
// cotangents cval, cg, ch (layouts of K15) of column col0 + c pulled back
// to coefficient i; every coefficient of the columns written once.  Two
// passes through the scratch ``local`` of sumfac_scatter_local_size(a)
// entries: each element's contributions to its pp^dim window slots, then
// each coefficient's sum of the slots that cover it.
template <typename T>
inline long long sumfac_scatter_local_size(const SumfacJetsArgs<T>& a) {
  long long n = (long long)a.ncols;
  for (int d = 0; d < a.dim; ++d) n *= (long long)a.pp[d] * a.nel[d];
  return n;
}

template <typename T>
cudaError_t sumfac_scatter_jets_launch(const SumfacJetsArgs<T>& a,
                                       const T* cval, const T* cg,
                                       const T* ch, T* local, T* out,
                                       cudaStream_t stream);

}  // namespace tigar
