// Launchers of the port's hand-written CUDA kernels (plain C++ interface:
// device pointers, sizes, the stream).  Each returns cudaGetLastError()
// after its launch.  Explicitly instantiated for float and double in the
// .cu files; bindings.cpp is the only caller.
#pragma once
#include <cuda_runtime.h>

namespace tigar {

// K1: SVK shell residual, one thread per quadrature point.
// consts = {lam_ps, 2 mu, h, h^3/12, load0, load1, load2}.
template <typename T>
cudaError_t shell_residual_launch(int nel, int nq, const int* conn,
                                  const T* U, const T* N, const T* dN,
                                  const T* d2N, const T* scale, const T* DF,
                                  const T* d2F, const T* ref_a,
                                  const T* ref_b, const T* ea,
                                  const double* consts, T* r,
                                  cudaStream_t stream);

// K2: SVK shell tangent stencil, one block per element.
// consts = {lam_ps, 2 mu, h, h^3/12}; S zero-initialised [3,3,5,5,ncpy,ncpx].
template <typename T>
cudaError_t tangent_stencil_launch(int nel_y, int nel_x, int nq,
                                   const int* conn, const T* U, const T* dN,
                                   const T* d2N, const T* scale, const T* DF,
                                   const T* d2F, const T* ref_a,
                                   const T* ref_b, const T* ea,
                                   const double* consts, int ncp_y,
                                   int ncp_x, T* S, cudaStream_t stream);

// K3: stencil apply.  mode 0: y = A x; 1: y = b - A x;
// 2: y = x + (omega dinv) (b - A x); A is masked when mask != nullptr.
template <typename T>
cudaError_t stencil_apply_launch(int ny, int nx, const T* S, const T* x,
                                 const T* mask, const T* b, const T* dinv,
                                 double omega, int mode, T* y,
                                 cudaStream_t stream);

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

}  // namespace tigar
