// K10: element-batch tangent apply, BC-masked, and its diagonal.
//
// Replaces tigar_tpu/solvers/newton_sa.py ElemTangent.__call__ (gather of
// x at the connectivity, batched E [nel, nloc, nloc] matvec, scatter-add)
// fused with _masked_act (y = m * A(m * x) + (1 - m) * x), and
// ElemTangent.diagonal (scatter-add of diag E).
//
// Bound: bytes.  E is read once (nel * nloc^2 values: 47.8 MB in f32 on
// the 128^2 shell) against 2 nel nloc^2 operations, so the matvec is far
// below the card's arithmetic-per-byte line.  Design: one block per
// element; E's block is staged in shared memory by all threads with
// coalesced loads, the gathered (masked) local coefficients beside it;
// one thread per local row forms its row sum from shared memory and
// atomically adds m[c] * sum into y.  A first pass writes (1 - m) x into
// y (0 without a mask), so the atomics only accumulate.  The atomics
// make the f32 sum order vary from run to run.
#include "kernels.h"

namespace tigar {

constexpr int ET_THREADS = 128;

template <typename T>
__global__ void elem_init_kernel(int n, const T* __restrict__ x,
                                 const T* __restrict__ mask,
                                 T* __restrict__ y) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = mask != nullptr ? (T(1) - mask[i]) * x[i] : T(0);
}

template <typename T>
__global__ void __launch_bounds__(ET_THREADS)
elem_apply_kernel(int nloc, const int* __restrict__ conn,
                  const T* __restrict__ E, const T* __restrict__ x,
                  const T* __restrict__ mask, T* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Esh = reinterpret_cast<T*>(smem_raw);      // [nloc][nloc]
  T* ush = Esh + nloc * nloc;                    // [nloc]
  __shared__ int csh[64];
  const int e = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t nn = (size_t)nloc * nloc;
  const T* Ee = E + (size_t)e * nn;
  for (int i = tid; i < nloc * nloc; i += ET_THREADS) Esh[i] = Ee[i];
  for (int a = tid; a < nloc; a += ET_THREADS) {
    const int c = conn[(size_t)e * nloc + a];
    csh[a] = c;
    ush[a] = mask != nullptr ? mask[c] * x[c] : x[c];
  }
  __syncthreads();
  for (int a = tid; a < nloc; a += ET_THREADS) {
    const T* row = Esh + a * nloc;
    T acc = T(0);
    for (int b = 0; b < nloc; ++b) acc += row[b] * ush[b];
    const int c = csh[a];
    atomicAdd(y + c, mask != nullptr ? mask[c] * acc : acc);
  }
}

template <typename T>
__global__ void elem_diag_kernel(int nel, int nloc,
                                 const int* __restrict__ conn,
                                 const T* __restrict__ E, T* __restrict__ d) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)nel * nloc) return;
  const size_t e = i / nloc, a = i % nloc;
  atomicAdd(d + conn[i], E[(e * nloc + a) * nloc + a]);
}

template <typename T>
cudaError_t elem_tangent_apply_launch(int nel, int nloc, int ndof,
                                      const int* conn, const T* E,
                                      const T* x, const T* mask, T* y,
                                      cudaStream_t stream) {
  if (nloc < 1 || nloc > 64) return cudaErrorInvalidValue;
  if (ndof > 0)
    elem_init_kernel<T><<<(ndof + 255) / 256, 256, 0, stream>>>(ndof, x,
                                                                mask, y);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nel == 0) return err;
  const size_t shmem = sizeof(T) * (size_t)nloc * (nloc + 1);
  elem_apply_kernel<T><<<nel, ET_THREADS, shmem, stream>>>(nloc, conn, E, x,
                                                           mask, y);
  return cudaGetLastError();
}

template <typename T>
cudaError_t elem_tangent_diagonal_launch(int nel, int nloc, const int* conn,
                                         const T* E, T* d,
                                         cudaStream_t stream) {
  const size_t n = (size_t)nel * nloc;
  if (n == 0) return cudaSuccess;
  elem_diag_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      nel, nloc, conn, E, d);
  return cudaGetLastError();
}

template cudaError_t elem_tangent_apply_launch<float>(
    int, int, int, const int*, const float*, const float*, const float*,
    float*, cudaStream_t);
template cudaError_t elem_tangent_apply_launch<double>(
    int, int, int, const int*, const double*, const double*, const double*,
    double*, cudaStream_t);
template cudaError_t elem_tangent_diagonal_launch<float>(
    int, int, const int*, const float*, float*, cudaStream_t);
template cudaError_t elem_tangent_diagonal_launch<double>(
    int, int, const int*, const double*, double*, cudaStream_t);

}  // namespace tigar
