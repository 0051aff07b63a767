// A stand-in for K9 (tigar_tpu_torch/csrc/shell_nitsche.cu
// nitsche_tangent_kernel) in the torch.profiler experiment of
// scripts/k9_profile_check.py: the same launch shape (one block of 256
// threads per interface point) with a given static shared memory
// (K9_SMEM bytes) and a per-thread local-memory frame (K9_STACK bytes), a
// loop of `iters` steps over both, and none of its arithmetic.  Built with
// nvcc into a shared library with a plain C interface (ctypes).
#include <cuda_runtime.h>

#ifndef K9_SMEM
#define K9_SMEM 16384
#endif
#ifndef K9_STACK
#define K9_STACK 4096
#endif

extern "C" __global__ void __launch_bounds__(256)
k9_dummy_kernel(float* out, int iters) {
  __shared__ double buf[K9_SMEM / 8];
  // a runtime-indexed volatile array lives in the thread's local memory
  volatile char frame[K9_STACK];
  for (int i = threadIdx.x; i < K9_SMEM / 8; i += blockDim.x) buf[i] = i;
  for (int i = 0; i < K9_STACK; i += 64) frame[i] = (char)(i + threadIdx.x);
  __syncthreads();
  float acc = 0.0f;
  for (int it = 0; it < iters; ++it) {
    const int k = (it * 131 + threadIdx.x) % (K9_SMEM / 8);
    const int l = (it * 4099 + threadIdx.x * 64) % K9_STACK;
    acc = 0.999f * acc + (float)buf[k] * 1e-9f + frame[l];
    frame[l] = (char)(it & 127);
  }
  if (acc == -1.0f) out[blockIdx.x] = acc;  // never: keeps the loop alive
}

extern "C" int k9_dummy_launch(void* out, int nblocks, int iters,
                               void* stream) {
  k9_dummy_kernel<<<nblocks, 256, 0, (cudaStream_t)stream>>>(
      (float*)out, iters);
  return (int)cudaGetLastError();
}
