// K10: element-batch tangent apply, BC-masked, and its diagonal.
//
// Replaces tigar_tpu/solvers/newton_sa.py ElemTangent.__call__ (gather of
// x at the connectivity, batched E [nel, nloc, nloc] matvec, scatter-add)
// fused with _masked_act (y = m * A(m * x) + (1 - m) * x), and
// ElemTangent.diagonal (scatter-add of diag E).
//
// Bound: bytes.  E is the Hessian of an energy, symmetric up to rounding
// (PERF.md gives the measured max |E - E^T| / max |E| of both SANewton
// paths), so the apply reads only its upper triangle, diagonal included:
// nel nloc (nloc + 1) / 2 values against 2 nel nloc^2 operations, far
// below the card's arithmetic-per-byte line.  On an NVIDIA H100 80GB
// HBM3 (3.35 TB/s) that is 0.0200 ms in f64 at the star T-spline (6,912
// elements, nloc 48; 66.9 MB with the vectors and the connectivity) and
// 0.0157 ms at the 128^2 shell (16,384 elements, nloc 27; 52.5 MB), half
// the full matrix's 0.0386 / 0.0294 ms.
// Design:
//  - a block of 256 threads takes epb = 256 / nloc consecutive elements,
//    one thread per (element, local row): 240 of 256 busy at nloc 48,
//    243 at nloc 27;
//  - its threads copy the upper triangles from the row-major E (the
//    layout K2's element mode writes and the host SA setup reads) into
//    packed triangles in shared memory with asynchronous copies
//    (cp.async): thread t takes triangle entry t, t + 256, ... of every
//    element of the block, so it finds each entry's row and column once
//    and consecutive threads copy consecutive entries of a row; the packed
//    triangles take half the shared memory of the square (f64 nloc 48:
//    49 KB a block, 4 blocks an SM);
//  - meanwhile each thread gathers its masked coefficient m[c] x[c];
//  - thread (e, a) sums E_ab u_b over b in one loop, taking E_ab from row
//    a for b >= a and E_ba from row b for b < a (no cross-thread
//    reduction, no shared atomics), then adds m[c] times the sum to y with
//    one global atomicAdd (the connectivity of the SANewton paths spreads
//    an element over three field blocks, too wide for a shared window).
// Tried on the card and not kept (scripts/k10_designs.cu, timed by
// scripts/k10_designs.py; PERF.md has the times): the same copy into an
// odd-stride square, 16-byte loads of the row-major chunks that meet the
// triangle, and 2- and 3-stage pipelines of persistent blocks.  What
// bounds this design is reading the triangle entry by entry: a kernel
// that only reads it takes about as long; the atomics and the arithmetic
// hide under the copies.
// The (1 - m) x part (0 without a mask) is written by a first launch,
// elem_init_kernel; the element kernel is its programmatic dependent
// (Hopper's dependent launch), so its copies and gather overlap the init
// and only its atomics wait for it (griddepcontrol.wait).  The atomics
// make the sum order vary from run to run.
#include <cuda_pipeline.h>

#include "kernels.h"

namespace tigar {

constexpr int ET_THREADS = 256;

template <typename T>
__global__ void elem_init_kernel(int n, const T* __restrict__ x,
                                 const T* __restrict__ mask,
                                 T* __restrict__ y) {
  // let the element kernel start its copies and gather now; it waits for
  // this grid before its first atomic
  asm volatile("griddepcontrol.launch_dependents;");
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    y[i] = mask != nullptr ? (T(1) - mask[i]) * x[i] : T(0);
}

// the first entry of row a of a packed upper triangle (row a holds the
// nloc - a entries b = a .. nloc - 1)
__device__ __forceinline__ int tri_start(int a, int nloc) {
  return a * nloc - a * (a - 1) / 2;
}

// the row of entry j of a packed upper triangle
__device__ __forceinline__ int tri_row(int j, int nloc) {
  const float w = 2.0f * nloc + 1.0f;
  int a = (int)((w - sqrtf(w * w - 8.0f * j)) * 0.5f);
  a = max(0, min(a, nloc - 1));
  while (a > 0 && tri_start(a, nloc) > j) --a;
  while (a + 1 < nloc && tri_start(a + 1, nloc) <= j) ++a;
  return a;
}

template <typename T>
__global__ void __launch_bounds__(ET_THREADS)
elem_apply_kernel(int nel, int nloc, int epb, const int* __restrict__ conn,
                  const T* __restrict__ E, const T* __restrict__ x,
                  const T* __restrict__ mask, T* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char et_smem[];
  const int np = nloc * (nloc + 1) / 2;
  T* tri = reinterpret_cast<T*>(et_smem);       // [epb][np] packed triangles
  T* us = tri + (size_t)epb * np;               // [epb * nloc]
  const int tid = threadIdx.x;
  const size_t e0 = (size_t)blockIdx.x * epb;
  const int ne = min(epb, nel - (int)e0);
  const int nrows = ne * nloc;
  const size_t nn = (size_t)nloc * nloc;

  // 1. the upper triangles, packed: thread t copies entries j = t, t +
  // 256, ... of the triangle of every element of the block
  const T* Eb = E + e0 * nn;
  for (int j = tid; j < np; j += ET_THREADS) {
    const int a = tri_row(j, nloc);
    const T* src = Eb + (size_t)a * nloc + a + (j - tri_start(a, nloc));
    for (int el = 0; el < ne; ++el)
      __pipeline_memcpy_async(tri + el * np + j, src + el * nn, sizeof(T));
  }
  __pipeline_commit();

  // 2. this thread's DoF and masked coefficient, while the copies fly
  int c = 0;
  T m = T(1);
  if (tid < nrows) {
    c = __ldg(conn + e0 * nloc + tid);
    if (mask != nullptr) m = __ldg(mask + c);
    us[tid] = m * __ldg(x + c);
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  if (tid >= nrows) return;

  // 3. thread (e, a): sum_b E_ab u_b, E_ab from row a of the triangle for
  // b >= a and E_ba from row b for b < a, then one atomic into y once the
  // init launch has written it
  const int el = tid / nloc, a = tid - el * nloc;
  const T* t = tri + (size_t)el * np;
  const T* u = us + el * nloc;
  const int pa = tri_start(a, nloc) - a;
  T acc = T(0);
  int pb = 0;                                   // tri_start(b, nloc)
  for (int b = 0; b < nloc; ++b) {
    acc += t[b >= a ? pa + b : pb + a - b] * u[b];
    pb += nloc - b;
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");
  atomicAdd(y + c, m * acc);
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
  if (nloc < 1 || nloc > 64 || nel < 0 || ndof < 0)
    return cudaErrorInvalidValue;
  if (ndof > 0) {
    int grid = (ndof + 255) / 256;
    if (grid > 8 * sm_count()) grid = 8 * sm_count();
    elem_init_kernel<T><<<grid, 256, 0, stream>>>(ndof, x, mask, y);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (nel == 0) return cudaSuccess;
  const int epb = ET_THREADS / nloc;
  const size_t smem =
      sizeof(T) * (size_t)epb * (nloc * (nloc + 1) / 2 + nloc);
  static size_t allowed = 48 * 1024;
  const cudaError_t e = allow_smem(
      reinterpret_cast<const void*>(elem_apply_kernel<T>), smem, &allowed);
  if (e != cudaSuccess) return e;
  // a programmatic dependent of the init kernel: its copies and gather
  // overlap the init, its atomics wait for it
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((nel + epb - 1) / epb));
  cfg.blockDim = dim3(ET_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, elem_apply_kernel<T>, nel, nloc, epb, conn,
                            E, x, mask, y);
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
