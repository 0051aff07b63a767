// Designs of K10 (the element-batch tangent apply over E's upper triangle)
// that were measured against the one in tigar_tpu_torch/csrc/elem_tangent.cu
// and not kept, and two read-only kernels that bound what a design can
// reach.  Built and timed by scripts/k10_designs.py; nothing of the port
// uses them.  Each adds sum_b E_ab u_b (u = m x gathered at the
// connectivity) times m[c] into y with one atomic a local row; y is not
// initialised here.
//   square:  the port's copy into an odd-stride square instead of packed
//            triangles;
//   pipeline: the port's packed copy in persistent blocks with S stages
//            (S - 1 groups of elements in flight while one is summed);
//   wide:    16-byte loads of the row-major chunks that meet the triangle,
//            through registers into packed triangles;
//   read_tri / read_full: read the triangle entry by entry (the port's
//            order), or all of E with 16-byte loads, and sum.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int TH = 256;

__device__ __forceinline__ int tri_start(int a, int n) {
  return a * n - a * (a - 1) / 2;
}

__device__ __forceinline__ int tri_row(int j, int n) {
  const float w = 2.0f * n + 1.0f;
  int a = (int)((w - sqrtf(w * w - 8.0f * j)) * 0.5f);
  a = max(0, min(a, n - 1));
  while (a > 0 && tri_start(a, n) > j) --a;
  while (a + 1 < n && tri_start(a + 1, n) <= j) ++a;
  return a;
}

template <typename T>
__global__ void __launch_bounds__(TH)
square(int nel, int nloc, int epb, int ld, const int* __restrict__ conn,
       const T* __restrict__ E, const T* __restrict__ x,
       const T* __restrict__ mask, T* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char sm[];
  T* es = reinterpret_cast<T*>(sm);
  T* us = es + (size_t)epb * nloc * ld;
  const int tid = threadIdx.x;
  const size_t e0 = (size_t)blockIdx.x * epb;
  const int ne = min(epb, nel - (int)e0), nrows = ne * nloc;
  const size_t nn = (size_t)nloc * nloc;
  const int np = nloc * (nloc + 1) / 2;
  const T* Eb = E + e0 * nn;
  for (int j = tid; j < np; j += TH) {
    const int a = tri_row(j, nloc), b = a + j - tri_start(a, nloc);
    for (int el = 0; el < ne; ++el)
      __pipeline_memcpy_async(es + ((size_t)el * nloc + a) * ld + b,
                              Eb + el * nn + (size_t)a * nloc + b, sizeof(T));
  }
  __pipeline_commit();
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
  const int el = tid / nloc, a = tid - el * nloc;
  const T* blk = es + (size_t)el * nloc * ld;
  const T* u = us + el * nloc;
  T acc = T(0);
  for (int b = 0; b < nloc; ++b)
    acc += blk[b < a ? b * ld + a : a * ld + b] * u[b];
  atomicAdd(y + c, m * acc);
}

template <typename T>
__global__ void __launch_bounds__(TH)
pipeline(int nel, int nloc, int epb, int S, const int* __restrict__ conn,
         const T* __restrict__ E, const T* __restrict__ x,
         const T* __restrict__ mask, T* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int np = nloc * (nloc + 1) / 2, stage = epb * np;
  T* es = reinterpret_cast<T*>(sm);             // [S][epb][np]
  T* us = es + (size_t)S * stage;               // [S][epb nloc]
  const int tid = threadIdx.x;
  const size_t nn = (size_t)nloc * nloc;
  const int ngroups = (nel + epb - 1) / epb;
  auto issue = [&](int grp, int buf) {
    const size_t e0 = (size_t)grp * epb;
    const int ne = min(epb, nel - (int)e0);
    const T* Eb = E + e0 * nn;
    T* dst = es + (size_t)buf * stage;
    for (int j = tid; j < np; j += TH) {
      const int a = tri_row(j, nloc);
      const T* src = Eb + (size_t)a * nloc + a + (j - tri_start(a, nloc));
      for (int el = 0; el < ne; ++el)
        __pipeline_memcpy_async(dst + el * np + j, src + el * nn, sizeof(T));
    }
    if (tid < ne * nloc) {
      const int c = __ldg(conn + e0 * nloc + tid);
      const T m = mask != nullptr ? __ldg(mask + c) : T(1);
      us[buf * epb * nloc + tid] = m * __ldg(x + c);
    }
  };
  int grp = blockIdx.x;
  for (int s = 0; s < S - 1; ++s) {
    if (grp + s * (int)gridDim.x < ngroups) issue(grp + s * gridDim.x, s);
    __pipeline_commit();
  }
  for (int it = 0; grp < ngroups; ++it, grp += gridDim.x) {
    const int g = grp + (S - 1) * gridDim.x;
    if (g < ngroups) issue(g, (it + S - 1) % S);
    __pipeline_commit();
    __pipeline_wait_prior(S - 1);
    __syncthreads();
    const int buf = it % S;
    const size_t e0 = (size_t)grp * epb;
    if (tid < min(epb, nel - (int)e0) * nloc) {
      const int el = tid / nloc, a = tid - el * nloc;
      const T* t = es + (size_t)buf * stage + el * np;
      const T* u = us + buf * epb * nloc + el * nloc;
      const int pa = tri_start(a, nloc) - a;
      T acc = T(0);
      int pb = 0;
      for (int b = 0; b < nloc; ++b) {
        acc += t[b >= a ? pa + b : pb + a - b] * u[b];
        pb += nloc - b;
      }
      const int c = __ldg(conn + e0 * nloc + tid);
      atomicAdd(y + c, (mask != nullptr ? __ldg(mask + c) : T(1)) * acc);
    }
    __syncthreads();
  }
}

template <typename T, int V> struct Vec;
template <> struct Vec<float, 4> { using type = float4; };
template <> struct Vec<double, 2> { using type = double2; };

constexpr int WIDE_MAXC = 5;   // 16-byte chunks a thread and group, at most

template <typename T>
__global__ void __launch_bounds__(TH)
wide(int nel, int nloc, int epb, int G, const int* __restrict__ conn,
     const T* __restrict__ E, const T* __restrict__ x,
     const T* __restrict__ mask, T* __restrict__ y) {
  constexpr int V = 16 / sizeof(T);
  using VT = typename Vec<T, V>::type;
  extern __shared__ __align__(16) unsigned char sm[];
  const int nn = nloc * nloc, np = nloc * (nloc + 1) / 2;
  T* es = reinterpret_cast<T*>(sm);
  T* us = es + (size_t)epb * np;
  const int tid = threadIdx.x;
  const size_t e0 = (size_t)blockIdx.x * epb;
  const int ne = min(epb, nel - (int)e0), nrows = ne * nloc;
  const int nch = G * nn / V;                   // chunks of G elements
  int code[WIDE_MAXC];                          // first entry, or -1
#pragma unroll
  for (int i = 0; i < WIDE_MAXC; ++i) {
    const int j = tid + i * TH, f = j * V, l = f + V - 1;
    const int rf = f / nloc, rl = l / nloc;
    code[i] = j < nch && !(rf == rl && l - rl * nloc < rl % nloc)
                  ? ((rf / nloc) << 16) | ((rf % nloc) << 8) | (f - rf * nloc)
                  : -1;
  }
  const size_t total = (size_t)nel * nn;
  const VT* Ev = reinterpret_cast<const VT*>(E + e0 * (size_t)nn);
  for (int g = 0; g < (ne + G - 1) / G; ++g) {
    VT v[WIDE_MAXC];
#pragma unroll
    for (int i = 0; i < WIDE_MAXC; ++i) {
      const size_t q = (size_t)g * nch + tid + i * TH;
      if (code[i] >= 0 && e0 * nn + (q + 1) * V <= total) v[i] = __ldg(Ev + q);
    }
#pragma unroll
    for (int i = 0; i < WIDE_MAXC; ++i) {
      if (code[i] < 0) continue;
      int el = code[i] >> 16, a = (code[i] >> 8) & 255, b = code[i] & 255;
      const size_t gi = e0 * nn + ((size_t)g * nch + tid + i * TH) * V;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const T val = gi + V <= total ? reinterpret_cast<const T*>(&v[i])[k]
                      : gi + k < total ? E[gi + k] : T(0);
        if (b >= a && g * G + el < ne)
          es[(g * G + el) * np + tri_start(a, nloc) + b - a] = val;
        if (++b == nloc) {
          b = 0;
          if (++a == nloc) { a = 0; ++el; }
        }
      }
    }
  }
  int c = 0;
  T m = T(1);
  if (tid < nrows) {
    c = __ldg(conn + e0 * nloc + tid);
    if (mask != nullptr) m = __ldg(mask + c);
    us[tid] = m * __ldg(x + c);
  }
  __syncthreads();
  if (tid >= nrows) return;
  const int el = tid / nloc, a = tid - el * nloc;
  const T* t = es + (size_t)el * np;
  const T* u = us + el * nloc;
  const int pa = tri_start(a, nloc) - a;
  T acc = T(0);
  int pb = 0;
  for (int b = 0; b < nloc; ++b) {
    acc += t[b >= a ? pa + b : pb + a - b] * u[b];
    pb += nloc - b;
  }
  atomicAdd(y + c, m * acc);
}

template <typename T>
__global__ void read_tri(int nel, int nloc, const T* __restrict__ E, T* out) {
  const int np = nloc * (nloc + 1) / 2;
  const size_t nn = (size_t)nloc * nloc, tot = (size_t)nel * np;
  T acc = T(0);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < tot;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t e = i / np;
    const int j = (int)(i - e * np), a = tri_row(j, nloc);
    acc += __ldg(E + e * nn + (size_t)a * nloc + a + (j - tri_start(a, nloc)));
  }
  if (acc == T(-1.2345)) out[0] = acc;
}

__global__ void read_full(size_t n16, const float4* __restrict__ E,
                          float* out) {
  float acc = 0.0f;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n16;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 v = __ldg(E + i);
    acc += v.x + v.y + v.z + v.w;
  }
  if (acc == -1.2345f) out[0] = acc;
}

// lets ``kernel`` take ``smem`` bytes of dynamic shared memory, once a
// kernel and size (the attribute call is host work inside the timed loop)
template <typename K>
void opt_in(K kernel, size_t smem) {
  static size_t done = 0;
  if (smem <= done) return;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  done = smem;
}

template <typename T>
int run(const char* what, int stages, int nel, int nloc, const int* conn,
        const T* E, const T* x, const T* mask, T* y, cudaStream_t s) {
  const int np = nloc * (nloc + 1) / 2, nn = nloc * nloc;
  const int epb = TH / nloc;
  const unsigned blocks = (nel + epb - 1) / epb;
  if (!strcmp(what, "square")) {
    const int ld = nloc | 1;
    const size_t smem = sizeof(T) * (size_t)epb * nloc * (ld + 1);
    opt_in(square<T>, smem);
    square<T><<<blocks, TH, smem, s>>>(nel, nloc, epb, ld, conn, E, x, mask,
                                       y);
  } else if (!strcmp(what, "pipeline")) {
    const size_t smem = sizeof(T) * (size_t)stages * epb * (np + nloc);
    opt_in(pipeline<T>, smem);
    static int per = 0, sms = 0;
    static size_t per_smem = 0;
    if (per_smem != smem) {
      int dev = 0;
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, pipeline<T>, TH,
                                                    smem);
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      per_smem = smem;
    }
    const unsigned grid = per * sms < (int)blocks ? per * sms : blocks;
    pipeline<T><<<grid, TH, smem, s>>>(nel, nloc, epb, stages, conn, E, x,
                                       mask, y);
  } else if (!strcmp(what, "wide")) {
    constexpr int V = 16 / sizeof(T);
    if (reinterpret_cast<uintptr_t>(E) % 16 != 0) return -1;
    int gcd = V, r = nn % V;
    while (r) {
      const int t = gcd % r;
      gcd = r;
      r = t;
    }
    const int G = V / gcd;
    const int eg = epb >= G ? epb - epb % G : G;
    if ((G * nn / V + TH - 1) / TH > WIDE_MAXC) return -1;
    const size_t smem = sizeof(T) * (size_t)eg * (np + nloc);
    opt_in(wide<T>, smem);
    wide<T><<<(nel + eg - 1) / eg, TH, smem, s>>>(nel, nloc, eg, G, conn, E,
                                                   x, mask, y);
  } else if (!strcmp(what, "read_tri")) {
    read_tri<T><<<132 * 8, TH, 0, s>>>(nel, nloc, E, y);
  } else if (!strcmp(what, "read_full")) {
    read_full<<<132 * 8, TH, 0, s>>>((size_t)nel * nn * sizeof(T) / 16,
                                     reinterpret_cast<const float4*>(E),
                                     reinterpret_cast<float*>(y));
  } else {
    return -2;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int k10_design_f32(const char* what, int stages, int nel, int nloc,
                              const void* conn, const void* E, const void* x,
                              const void* mask, void* y, void* stream) {
  return run<float>(what, stages, nel, nloc, (const int*)conn,
                    (const float*)E, (const float*)x, (const float*)mask,
                    (float*)y, (cudaStream_t)stream);
}

extern "C" int k10_design_f64(const char* what, int stages, int nel, int nloc,
                              const void* conn, const void* E, const void* x,
                              const void* mask, void* y, void* stream) {
  return run<double>(what, stages, nel, nloc, (const int*)conn,
                     (const double*)E, (const double*)x, (const double*)mask,
                     (double*)y, (cudaStream_t)stream);
}
