// K12: f32 fast-path scalar stiffness apply over explicit element
// connectivity,
//
//   r = mask * A (mask * W) + (1 - mask) * W,
//   A (mask W) = scatter_e( K_e (mask W)[conn_e] ),
//
// with K_e the element stiffness matrices, computed once per operator
// (ops/fastpath.py laplace_element_matrices) and stored as their upper
// triangles Ke [NP][nel], NP = nen (nen + 1) / 2, element axis last, row
// k(a, b) = a nen - a (a - 1) / 2 + (b - a) for a <= b.
//
// Replaces tigar_tpu/ops/fastpath.py _laplace_apply (the XLA-fused
// gather -> einsum -> einsum -> scatter-add, the computation of the
// Pallas element-apply kernel the JAX package once had).
//
// Bound: bytes.  Each element reads 4 NP bytes of Ke (180 at 2D p=2, 1,512
// at 3D p=2) and 4 nen of connT for 2 nen^2 flops (0.8-0.9 flop a byte);
// W, mask and r add 12 bytes a DoF.  The JAX layouts this kernel once
// streamed held 2 nen nq d floats an element (1,296 bytes at 2D p=2),
// 7x the element matrix.  Design:
//  - a block takes epb consecutive elements, one thread per (element,
//    local row) pair: 64 (32 at nen 27, 8 at nen 64, within the shared
//    memory budget), halved where the grid would give under two blocks an
//    SM (3D 16^3: 8);
//  - the thread's connectivity loads are issued together, then their
//    mask and W loads, so a block waits two load latencies;
//  - it stages the block's Ke columns in shared memory with 16-byte
//    asynchronous copies (cp.async) when nel and epb are multiples of 4
//    (4-byte copies otherwise), which overlap the gather of the masked
//    coefficients mask[c] W[c] of its elements (two dependent loads);
//  - thread (a, e) sums K_e[a][b] u_b over b from shared memory;
//  - results go to a shared window over the block's DoF range [lo, hi]
//    (consecutive elements of a structured mesh share most DoFs), and
//    each window entry that received a contribution is flushed with one
//    global atomicAdd; a block whose range exceeds LAPLACE_WINDOW (as with
//    scrambled connectivity) adds straight to r with global atomics.
// The (1 - mask) W part is written by a first launch, laplace_init_kernel;
// the element kernel is its programmatic dependent (Hopper's dependent
// launch), so its staging and gather overlap the init and only its atomics
// wait for it (griddepcontrol.wait).  f32 atomics sum in a varying order.
#include <cuda_pipeline.h>

#include <climits>
#include <cstdint>

#include "kernels.h"

namespace tigar {

constexpr int LAPLACE_THREADS = 256;
constexpr int LAPLACE_SMEM_BUDGET = 100 * 1024;

__global__ void laplace_init_kernel(int ndof, const float* __restrict__ mask,
                                    const float* __restrict__ W,
                                    float* __restrict__ r) {
  // let the element kernel start its staging and gather now (programmatic
  // dependent launch); it waits for this grid before its first atomic
  asm volatile("griddepcontrol.launch_dependents;");
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < ndof;
       i += gridDim.x * blockDim.x)
    r[i] = (1.0f - mask[i]) * W[i];
}

// shared bytes of a block of epb elements: Ke columns, u, the DoF window
template <int NEN>
__host__ __device__ constexpr size_t laplace_smem(int epb) {
  return (size_t)(NEN * (NEN + 1) / 2 + NEN) * epb * 4 +
         (size_t)LAPLACE_WINDOW * 4;
}

// the most elements a block takes: 64, halved to fit the shared budget
template <int NEN>
__host__ __device__ constexpr int laplace_epb_max() {
  int epb = 64;
  while (epb > 4 && laplace_smem<NEN>(epb) > LAPLACE_SMEM_BUDGET) epb /= 2;
  return epb;
}

template <int NEN>
__global__ void __launch_bounds__(LAPLACE_THREADS)
laplace_elem_kernel(int nel, int epb, const float* __restrict__ Ke,
                    const int* __restrict__ connT,
                    const float* __restrict__ mask,
                    const float* __restrict__ W, float* __restrict__ r) {
  constexpr int NP = NEN * (NEN + 1) / 2;
  // (element, local row) pairs a thread takes, at most
  constexpr int IT = (NEN * laplace_epb_max<NEN>() + LAPLACE_THREADS - 1) /
                     LAPLACE_THREADS;
  extern __shared__ float4 laplace_smem4[];
  float* ks = reinterpret_cast<float*>(laplace_smem4);  // [NP][epb]
  float* us = ks + NP * epb;                            // [NEN][epb]
  float* win = us + NEN * epb;                          // [LAPLACE_WINDOW]
  __shared__ int lo_s, hi_s;

  const int tid = threadIdx.x;
  const size_t e0 = (size_t)blockIdx.x * epb;
  const int ne = min(epb, nel - (int)e0);
  const int npairs = NEN * epb;
  if (tid == 0) {
    lo_s = INT_MAX;
    hi_s = -1;
  }

  // 1. the block's Ke columns e0 .. e0 + ne - 1 of every row, copied
  // asynchronously (cp.async) while step 2 gathers
  if (ne == epb && epb % 4 == 0 && nel % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(Ke) & 15) == 0) {
    const int q = epb / 4;
    for (int i = tid; i < NP * q; i += LAPLACE_THREADS) {
      const int k = i / q, j = i - k * q;
      __pipeline_memcpy_async(ks + k * epb + 4 * j,
                              Ke + (size_t)k * nel + e0 + 4 * j, 16);
    }
  } else {
    for (int i = tid; i < NP * epb; i += LAPLACE_THREADS) {
      const int k = i / epb, j = i - k * epb;
      if (j < ne)
        __pipeline_memcpy_async(ks + i, Ke + (size_t)k * nel + e0 + j, 4);
      else
        ks[i] = 0.0f;
    }
  }
  __pipeline_commit();

  // 2. connectivity, masked coefficients and the block's DoF range: every
  // connectivity load of the thread first, then their mask and W loads
  int c[IT];
  float mc[IT];
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int p = tid + it * LAPLACE_THREADS;
    const int a = p / epb, el = p - a * epb;
    c[it] = p < npairs && el < ne ? __ldg(connT + (size_t)a * nel + e0 + el)
                                  : -1;
  }
  int lo = INT_MAX, hi = -1;
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int p = tid + it * LAPLACE_THREADS;
    if (c[it] >= 0) {
      mc[it] = __ldg(mask + c[it]);
      us[p] = mc[it] * __ldg(W + c[it]);
      lo = min(lo, c[it]);
      hi = max(hi, c[it]);
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  __pipeline_wait_prior(0);
  __syncthreads();
  if ((tid & 31) == 0) {
    atomicMin(&lo_s, lo);
    atomicMax(&hi_s, hi);
  }
  __syncthreads();
  const int base = lo_s, range = hi_s - lo_s + 1;
  const bool windowed = range <= LAPLACE_WINDOW;
  if (windowed)
    for (int i = tid; i < range; i += LAPLACE_THREADS) win[i] = 0.0f;
  else
    asm volatile("griddepcontrol.wait;" ::: "memory");  // r initialised
  __syncthreads();

  // 3. thread (a, e): mask_a sum_b K_e[a][b] u_b into the window (or r)
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int p = tid + it * LAPLACE_THREADS;
    if (c[it] < 0) continue;
    const int a = p / epb, el = p - a * epb;
    const int ra = a * NEN - a * (a - 1) / 2 - a;   // k(a, b) = ra + b
    float acc = 0.0f;
#pragma unroll
    for (int b = 0; b < NEN; ++b) {
      const int cb = b * NEN - b * (b - 1) / 2 - b;  // k(b, a) = cb + a
      const int k = b < a ? cb + a : ra + b;
      acc = fmaf(ks[k * epb + el], us[b * epb + el], acc);
    }
    const float val = mc[it] * acc;
    if (windowed)
      atomicAdd(win + (c[it] - base), val);
    else
      atomicAdd(r + c[it], val);
  }
  if (!windowed) return;
  __syncthreads();

  // 4. flush: one global atomic a DoF that received a contribution, once
  // the init launch has written r
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int i = tid; i < range; i += LAPLACE_THREADS) {
    const float v = win[i];
    if (v != 0.0f) atomicAdd(r + base + i, v);
  }
}

namespace {

template <int NEN>
cudaError_t launch_elem(int nel, const float* Ke, const int* connT,
                        const float* mask, const float* W, float* r,
                        cudaStream_t stream) {
  // up to 64 elements a block (a 2D p=2 row of 256 elements in 4 blocks,
  // one wave on the card), halved while the grid gives under two blocks an
  // SM (3D 16^3: 8)
  int epb = laplace_epb_max<NEN>();
  while (epb > 4 && (nel + epb - 1) / epb < 2 * sm_count()) epb /= 2;
  const size_t smem = laplace_smem<NEN>(epb);
  static size_t allowed = 48 * 1024;
  const cudaError_t e = allow_smem(
      reinterpret_cast<const void*>(laplace_elem_kernel<NEN>), smem,
      &allowed);
  if (e != cudaSuccess) return e;
  // launched as a programmatic dependent of the init kernel: its staging
  // and gather overlap the init, its atomics wait for it
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((nel + epb - 1) / epb);
  cfg.blockDim = dim3(LAPLACE_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, laplace_elem_kernel<NEN>, nel, epb, Ke,
                            connT, mask, W, r);
}

}  // namespace

cudaError_t laplace_apply_launch(int nel, int nen, int ndof, const float* Ke,
                                 const int* connT, const float* mask,
                                 const float* W, float* r,
                                 cudaStream_t stream) {
  if (nel < 0 || ndof < 0) return cudaErrorInvalidValue;
  if (ndof > 0) {
    int grid = (ndof + 255) / 256;
    if (grid > 8 * 132) grid = 8 * 132;
    laplace_init_kernel<<<grid, 256, 0, stream>>>(ndof, mask, W, r);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (nel == 0) return cudaSuccess;
  switch (nen) {
    case 4: return launch_elem<4>(nel, Ke, connT, mask, W, r, stream);
    case 8: return launch_elem<8>(nel, Ke, connT, mask, W, r, stream);
    case 9: return launch_elem<9>(nel, Ke, connT, mask, W, r, stream);
    case 16: return launch_elem<16>(nel, Ke, connT, mask, W, r, stream);
    case 27: return launch_elem<27>(nel, Ke, connT, mask, W, r, stream);
    case 64: return launch_elem<64>(nel, Ke, connT, mask, W, r, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tigar
