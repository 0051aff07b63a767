// K13 / K14 designs measured beside the port's kernel by
// scripts/k14_designs.py (built as a shared library, called through
// ctypes on tensors it owns; float32, the reef-knot path's type).
//
//   k14_old:  the design K14 had before the bit mask and the culling
//             (one warp a row, 8 rows a block, every block restaging all
//             points in 512-point tiles, the bool mask read as 16-byte
//             loads, one branch a live pair), with ablations: mode 0 as
//             it was, 1 without its mask reads (every pair live: the
//             result changes, the time is the point), 2 without the pair
//             arithmetic (its staging, mask reads and loads of staged
//             points alone, summed so that they stay).
//   k14_new:  the port's kernel (csrc/contact_pairs.cu, included) at R =
//             1, 2, 4 or 8 row tiles a block, a chosen number of column
//             splits, with or without its culling.
#include "../tigar_tpu_torch/csrc/contact_pairs.cu"

namespace {

using tigar::CP_TILE;

constexpr int OLD_THREADS = 256, OLD_WARPS = 8, OLD_TILE = 512;
constexpr int OLD_SLOTS = OLD_TILE + OLD_TILE / 16;

__device__ __forceinline__ int old_slot(int j) { return j + (j >> 4); }

template <bool TANGENT, int MODE>
__global__ void __launch_bounds__(OLD_THREADS)
old_kernel(int n, long long ld, const unsigned char* __restrict__ mask,
           const float* __restrict__ x, const float* __restrict__ v,
           const float* __restrict__ w, float k, float r_max,
           float* __restrict__ out) {
  __shared__ float xs[3][OLD_SLOTS];
  __shared__ float ws[OLD_SLOTS];
  __shared__ float vs[3][OLD_SLOTS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = blockIdx.x * OLD_WARPS + warp;
  const bool row = i < n;
  float xi[3] = {0.f, 0.f, 0.f}, vi[3] = {0.f, 0.f, 0.f};
  if (row)
    for (int c = 0; c < 3; ++c) {
      xi[c] = x[3 * (size_t)i + c];
      if (TANGENT) vi[c] = v[3 * (size_t)i + c];
    }
  const float r2max = r_max * r_max;
  float acc[3] = {0.f, 0.f, 0.f};
  const unsigned char* mrow = mask + (size_t)(row ? i : 0) * ld;
  for (int j0 = 0; j0 < n; j0 += OLD_TILE) {
    const int m = min(OLD_TILE, n - j0);
    __syncthreads();
    for (int t = threadIdx.x; t < m; t += OLD_THREADS) {
      const int s = old_slot(t);
      const size_t o = 3 * (size_t)(j0 + t);
      xs[0][s] = x[o];
      xs[1][s] = x[o + 1];
      xs[2][s] = x[o + 2];
      ws[s] = w[j0 + t];
      if (TANGENT) {
        vs[0][s] = v[o];
        vs[1][s] = v[o + 1];
        vs[2][s] = v[o + 2];
      }
    }
    __syncthreads();
    const int jl = 16 * lane;
    if (!row || jl >= m) continue;
    unsigned words[4] = {~0u, ~0u, ~0u, ~0u};
    if (MODE != 1) {
      const uint4 q = *reinterpret_cast<const uint4*>(mrow + j0 + jl);
      words[0] = q.x, words[1] = q.y, words[2] = q.z, words[3] = q.w;
    }
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      if (((words[b >> 2] >> (8 * (b & 3))) & 0xffu) == 0u) continue;
      if (jl + b >= m) continue;
      const int s = old_slot(jl + b);
      const float d0 = xi[0] - xs[0][s], d1 = xi[1] - xs[1][s],
                  d2 = xi[2] - xs[2][s];
      if (MODE == 2) {
        acc[0] += d0 + ws[s];
        acc[1] += d1;
        acc[2] += d2;
        if (TANGENT) acc[0] += vs[0][s] + vs[1][s] + vs[2][s];
        continue;
      }
      const float r2 = d0 * d0 + d1 * d1 + d2 * d2;
      if (!(r2 < r2max)) continue;
      const float r = sqrtf(r2);
      const float a = ws[s] * (1.f - r_max / r);
      if (TANGENT) {
        const float e0 = vi[0] - vs[0][s], e1 = vi[1] - vs[1][s],
                    e2 = vi[2] - vs[2][s];
        const float bb =
            ws[s] * r_max * (d0 * e0 + d1 * e1 + d2 * e2) / (r2 * r);
        acc[0] += a * e0 + bb * d0;
        acc[1] += a * e1 + bb * d1;
        acc[2] += a * e2 + bb * d2;
      } else {
        acc[0] += a * d0;
        acc[1] += a * d1;
        acc[2] += a * d2;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      acc[c] += __shfl_down_sync(0xffffffffu, acc[c], s);
  if (row && lane == 0) {
    const float kw = k * w[i];
    for (int c = 0; c < 3; ++c) out[3 * (size_t)i + c] = kw * acc[c];
  }
}

template <bool TANGENT>
void old_launch(int mode, int n, long long ld, const unsigned char* mask,
                const float* x, const float* v, const float* w, float k,
                float r_max, float* out) {
  const int grid = (n + OLD_WARPS - 1) / OLD_WARPS;
  if (mode == 0)
    old_kernel<TANGENT, 0><<<grid, OLD_THREADS>>>(n, ld, mask, x, v, w, k,
                                                  r_max, out);
  else if (mode == 1)
    old_kernel<TANGENT, 1><<<grid, OLD_THREADS>>>(n, ld, mask, x, v, w, k,
                                                  r_max, out);
  else
    old_kernel<TANGENT, 2><<<grid, OLD_THREADS>>>(n, ld, mask, x, v, w, k,
                                                  r_max, out);
}

template <bool TANGENT, int R>
void new_launch(int n, int nsplit, const unsigned* words,
                const unsigned char* tiles, const float* x, const float* v,
                const float* w, float k, float r_max, float r2cull,
                float* boxes, float* partial, int* done, float* out) {
  const int nt = (n + CP_TILE - 1) / CP_TILE, ng = (nt + R - 1) / R;
  const int nb = std::max(nt * 32, ng);
  tigar::contact_boxes_kernel<float><<<(nb + 255) / 256, 256>>>(
      n, nt, ng, x, boxes, done);
  tigar::contact_pairs_kernel<float, TANGENT, R, tigar::CP_WARPS>
      <<<dim3(ng, nsplit), 32 * tigar::CP_WARPS>>>(
          n, nt, words, tiles, boxes, x, v, w, k, r_max, r2cull, partial,
          done, out);
}

}  // namespace

extern "C" {

// v == nullptr: K13, else K14; returns a cudaError_t
int k14_old(int mode, int n, long long ld, const unsigned char* mask,
            const float* x, const float* v, const float* w, float k,
            float r_max, float* out) {
  if (v)
    old_launch<true>(mode, n, ld, mask, x, v, w, k, r_max, out);
  else
    old_launch<false>(mode, n, ld, mask, x, v, w, k, r_max, out);
  return (int)cudaGetLastError();
}

// the groups (blocks along x) k14_new launches at n points and R
int k14_groups(int n, int R) { return ((n + 31) / 32 + R - 1) / R; }

// cull = 0 passes an r2cull that keeps every box pair (the caller passes
// tiles of ones to keep every mask-empty pair too)
int k14_new(int R, int nsplit, int cull, int n, const unsigned* words,
            const unsigned char* tiles, const float* x, const float* v,
            const float* w, float k, float r_max, float* boxes,
            float* partial, int* done, float* out) {
  const float r2cull = cull ? r_max * r_max * (1.f + 1e-6f) : INFINITY;
#define K14_NEW(RR)                                                       \
  (v ? new_launch<true, RR>(n, nsplit, words, tiles, x, v, w, k, r_max,   \
                            r2cull, boxes, partial, done, out)            \
     : new_launch<false, RR>(n, nsplit, words, tiles, x, v, w, k, r_max,  \
                             r2cull, boxes, partial, done, out))
  if (R == 1)
    K14_NEW(1);
  else if (R == 2)
    K14_NEW(2);
  else if (R == 4)
    K14_NEW(4);
  else if (R == 8)
    K14_NEW(8);
  else
    return (int)cudaErrorInvalidValue;
#undef K14_NEW
  return (int)cudaGetLastError();
}

}  // extern "C"
