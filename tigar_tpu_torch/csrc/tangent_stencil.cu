// K2: SVK shell tangent: element matrices, and their stencil fold.
//
// Replaces tigar_tpu/ops/assembly.py DomainAssembler
// .element_matrices_adjoint (jacfwd of the adjoint over the ravelled jet,
// E = sum_q w_q B^T K B) followed by tigar_tpu/ops/stencil.py
// stencil_from_element_matrices (fold of each (a, b) entry into S at
// offset b - a + p).
//
// The element kernel: a block takes EPB consecutive elements
// (tangent_epb: as many as give its 128 threads at most one dual-number
// work item each; 8 at one point an element, 3 at four, 1 at nine and
// sixteen).
//  0. Its inputs are staged in shared memory by asynchronous copies
//     (cp.async), so a thread waits once for all of its loads.
//  1. The jets of the state at each point: G = DF + u.g, H = d2F + u.h
//     (18 values, one thread a value), then the pointwise jet-Jacobian
//     K[q] = dF/du over the 18 non-value jet slots (the value slots are
//     identically zero for this density: F does not depend on u.val and
//     the load is constant), from the same templated svk_adjoint as K1 on
//     dual numbers carrying ND tangents: a work item is one (element,
//     point, pass of ND seeded slots).  K[q] is stored times w_q, its rows
//     and columns field-major (slot (f, s), s = g0, g1, h00, h01, h10,
//     h11, at 6 f + s), so that the 6 x 6 block K^{fg} has contiguous
//     rows.
//  2. E = sum_q Phi_q^T (w_q K_q) Phi_q, Phi_q[s][a] the 6 derivative
//     tabulations of local function a.  E is the Hessian of an energy, so
//     only its upper triangle is computed: a thread takes a tile of
//     RA x RA entries (RA = 3 at NEN 9, 4 at NEN 16) of one block E^{fg},
//     f <= g (the tiles on or above the diagonal when f = g), and per
//     point and slot row s forms M = K^{fg}[s] Phi_b (RA x 6 products)
//     then adds Phi_a[s] M into its RA x RA accumulators: per point
//     12 RA + 6 shared loads for 12 RA^2 multiply-adds (one entry a
//     thread reads 48 values for 42, and forms the inner K Phi_b product
//     again for every row).
//  3. The tiles, times the element BC mask me[row] me[col] and the
//     padding mask mask[a] mask[b], go to the upper triangle of the
//     block's E in shared memory (rows at an odd stride), and the block
//     writes its elements' E [3 NEN][3 NEN] contiguously, the lower
//     triangle read from the upper: E is exactly symmetric (the plain
//     version's, one jacfwd column at a time, is so to rounding).
// Element mode (tangent_elements_launch, the space-agnostic Newton tier:
// tigar_tpu/solvers/newton_sa.py build_vals) writes E [nel, 3 NEN, 3 NEN]
// for NEN = 9 (biquadratic B-spline) or 16 (bicubic extraction element,
// the T-spline path) local functions a field, with a padding mask
// [nel, NEN] for ragged T-spline elements (the gathered coefficients are
// multiplied by it too).
// Stencil mode (tangent_stencil_launch, biquadratic tensor-product grids)
// writes E into a scratch buffer, and tangent_stencil_fold_kernel gathers
// it into S: each S entry is written once, by one thread, as the sum of
// the (up to 9) element entries it receives, with no atomics and no
// zeroed S (a global atomic for each entry from the thread that forms it
// is 729 scattered atomics an element: 2.7x the fold's time, measured).
//
// Bound: arithmetic (dual-number passes through the adjoint and E's
// triangle) or, in element mode, the bytes of E.  One element a block
// with one entry a thread is bound by shared-memory loads in step 2
// (about one a multiply-add) and leaves 60 of 96 threads idle in step 1
// at four points.  Shared memory of a block: EPB (nq (324 + 6 NEN + 18)
// + 7 NEN + 3 NEN (3 NEN | 1)) values, 17-75 KB.
#include <cuda_pipeline.h>

#include "kernels.h"
#include "svk_adjoint.cuh"

namespace tigar {
namespace {

constexpr int NS = 18;      // non-value jet slots: g (6) then h (12)
constexpr int ND = 2;       // tangents per dual pass
constexpr int NPASS = NS / ND;
constexpr int MAXQ_STENCIL = 9;
constexpr int MAXQ = 16;
constexpr int THREADS = 128;

// elements a block: as many as give at most THREADS (point, pass) items,
// at least 1 and at most 8
__host__ __device__ constexpr int tangent_epb(int nq) {
  const int e = THREADS / (NPASS * nq);
  return e < 1 ? 1 : (e > 8 ? 8 : e);
}

// rows of the block's E in shared memory: an odd stride, so that a warp
// reading a column (E's lower triangle from its upper) hits every bank
__host__ __device__ constexpr int tangent_ld(int nen) { return 3 * nen | 1; }

// dynamic shared memory of one block: K, phi, jets, coefficients, mask,
// row factors, E
template <typename T>
size_t tangent_smem(int nq, int nen) {
  return sizeof(T) * tangent_epb(nq) *
         ((size_t)nq * (NS * NS + nen * 6 + NS) + 7 * nen
          + 3 * nen * tangent_ld(nen));
}

// field-major position 6 f + s of the jet slot at ravel index j (g[3][2]
// then h[3][2][2], without the 3 value slots)
__device__ __forceinline__ int field_major(int j) {
  return j < 6 ? (j >> 1) * 6 + (j & 1)
               : ((j - 6) >> 2) * 6 + 2 + ((j - 6) & 3);
}

template <int N>
struct Tile {
  static constexpr int RA = N == 9 ? 3 : 4;  // local functions a tile side
  static constexpr int NB = N / RA;           // tile rows of E^{fg}
  static constexpr int COUNT = 3 * NB * NB + 3 * NB * (NB + 1) / 2;
};

template <typename T>
__device__ __forceinline__ void load6(const T* p, T v[6]) {
  using V2 = typename std::conditional<sizeof(T) == 4, float2,
                                       double2>::type;
  const V2* q = reinterpret_cast<const V2*>(p);  // 8 / 16-byte aligned
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const V2 x = q[k];
    v[2 * k] = x.x;
    v[2 * k + 1] = x.y;
  }
}

// The element kernel's arguments: the padding mask and me may be
// nullptr; E [nel][3 NEN][3 NEN] (the stencil fold's scratch in stencil
// mode).
template <typename T>
struct TangentArgs {
  int nel, nq;
  const int* conn;
  const T *U, *dN, *d2N, *scale, *DF, *d2F, *ref_a, *ref_b, *ea, *mask;
  ShellConst<T> k;
  const T* me;
  T* E;
};

// A block's shared memory, for epb elements from e0 (nb of them exist)
template <typename T, int NEN>
struct Staged {
  static constexpr int LD = tangent_ld(NEN);
  T *K, *phi, *jet, *c, *m, *F, *E;  // [epb][nq][18][18],
      // [epb][nq][NEN][6], [epb][nq][18], [epb][3][NEN], [epb][NEN],
      // [epb][3 NEN] row factors me * mask, [epb][3 NEN][LD]
  int e0, nb;
  __device__ Staged(unsigned char* raw, int epb, int nq, int nel) {
    K = reinterpret_cast<T*>(raw);
    phi = K + epb * nq * NS * NS;
    jet = phi + epb * nq * NEN * 6;
    c = jet + epb * nq * NS;
    m = c + epb * 3 * NEN;
    F = m + epb * NEN;
    E = F + epb * 3 * NEN;
    e0 = blockIdx.x * epb;
    nb = min(epb, nel - e0);
  }
};

// the padding mask, me, the coefficients (unmasked) and the tabulations,
// by asynchronous copies that a thread issues without waiting for each
// (cp.async); then the row factors F = me * mask
template <typename T, int NEN>
__device__ __forceinline__ void stage_inputs(const TangentArgs<T>& a,
                                             const Staged<T, NEN>& b) {
  constexpr int NLOC = 3 * NEN;
  const int tid = threadIdx.x, nq = a.nq;
  for (int i = tid; i < b.nb * NEN; i += blockDim.x) {
    if (a.mask == nullptr)
      b.m[i] = T(1);
    else
      __pipeline_memcpy_async(b.m + i, a.mask + (size_t)b.e0 * NEN + i,
                              sizeof(T));
  }
  for (int i = tid; i < b.nb * NLOC; i += blockDim.x) {
    if (a.me == nullptr)
      b.F[i] = T(1);
    else
      __pipeline_memcpy_async(b.F + i, a.me + (size_t)b.e0 * NLOC + i,
                              sizeof(T));
    __pipeline_memcpy_async(b.c + i, a.U + a.conn[(size_t)b.e0 * NLOC + i],
                            sizeof(T));
  }
  for (int i = tid; i < b.nb * nq * NEN * 6; i += blockDim.x) {
    const int s = i % 6, l = (i / 6) % NEN;
    const size_t pt = (size_t)b.e0 * nq + i / (NEN * 6);  // element-major
    __pipeline_memcpy_async(b.phi + i,
                            s < 2 ? a.dN + (pt * NEN + l) * 2 + s
                                  : a.d2N + (pt * NEN + l) * 4 + (s - 2),
                            sizeof(T));
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  for (int i = tid; i < b.nb * NLOC; i += blockDim.x)
    b.F[i] *= b.m[(i / NLOC) * NEN + i % NEN];
  __syncthreads();
}

// 1a. the jets at each point, ravel order: G[i][d] at 2 i + d,
// H[i][d][c] at 6 + 4 i + 2 d + c
template <typename T, int NEN>
__device__ __forceinline__ void stage_jets(const TangentArgs<T>& a,
                                           const Staged<T, NEN>& b) {
  const int nq = a.nq;
  for (int w = threadIdx.x; w < b.nb * nq * NS; w += blockDim.x) {
    const int j = w % NS, p = w / NS, el = p / nq;
    const size_t pt = (size_t)b.e0 * nq + p;
    const int f = j < 6 ? j >> 1 : (j - 6) >> 2;
    const int s = j < 6 ? (j & 1) : 2 + ((j - 6) & 3);
    const T* ph = b.phi + p * NEN * 6 + s;
    const T* c = b.c + el * 3 * NEN + f * NEN;
    const T* m = b.m + el * NEN;
    T v = j < 6 ? a.DF[pt * 6 + j] : a.d2F[pt * 12 + (j - 6)];
#pragma unroll
    for (int l = 0; l < NEN; ++l) v += ph[l * 6] * (c[l] * m[l]);
    b.jet[w] = v;
  }
  __syncthreads();
}

// 1b. jet-Jacobians by forward-mode dual numbers, times w_q
template <typename T, int NEN>
__device__ __forceinline__ void stage_jacobians(const TangentArgs<T>& a,
                                                const Staged<T, NEN>& b) {
  using D = Dual<T, ND>;
  const int nq = a.nq;
  for (int w = threadIdx.x; w < b.nb * nq * NPASS; w += blockDim.x) {
    const int p = w / NPASS, pass = w % NPASS;
    const size_t pt = (size_t)b.e0 * nq + p;
    const T* jt = b.jet + p * NS;
    D G[3][2], H[3][2][2];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        G[i][d] = D(jt[i * 2 + d]);
        const int sg = i * 2 + d - pass * ND;
#pragma unroll
        for (int kk = 0; kk < ND; ++kk) G[i][d].d[kk] = T(sg == kk ? 1 : 0);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          H[i][d][c] = D(jt[6 + i * 4 + d * 2 + c]);
          const int sh = 6 + i * 4 + d * 2 + c - pass * ND;
#pragma unroll
          for (int kk = 0; kk < ND; ++kk)
            H[i][d][c].d[kk] = T(sh == kk ? 1 : 0);
        }
      }
    ShellRef<T> ref;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ref.a[j / 2][j % 2] = a.ref_a[pt * 4 + j];
      ref.b[j / 2][j % 2] = a.ref_b[pt * 4 + j];
      ref.ea[j / 2][j % 2] = a.ea[pt * 4 + j];
    }
    D Fg[3][2], Fh[3][2][2];
    svk_adjoint<D, T>(G, H, ref, a.k, Fg, Fh);
    const T wq = a.scale[pt];
    T* Kq = b.K + p * NS * NS;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      const int col = field_major(pass * ND + kk);
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          Kq[(i * 6 + d) * NS + col] = wq * Fg[i][d].d[kk];
          Kq[(i * 6 + 2 + d * 2) * NS + col] = wq * Fh[i][d][0].d[kk];
          Kq[(i * 6 + 3 + d * 2) * NS + col] = wq * Fh[i][d][1].d[kk];
        }
    }
  }
  __syncthreads();
}

// The t-th tile of E's upper triangle: field pairs f <= g in order, NB^2
// tiles each when f < g, NB (NB + 1) / 2 row by row (ab <= bb) when f = g
template <int NEN>
__device__ __forceinline__ void upper_tile(int t, int& f, int& g, int& ab,
                                           int& bb) {
  constexpr int NB = Tile<NEN>::NB;
  f = 0;
  for (g = 0;; ++g) {
    if (g == 3) g = ++f;
    const int n = f == g ? NB * (NB + 1) / 2 : NB * NB;
    if (t < n) break;
    t -= n;
  }
  if (f == g) {
    ab = 0;
    while (t >= NB - ab) t -= NB - ab++;
    bb = ab + t;
  } else {
    ab = t / NB;
    bb = t % NB;
  }
}

// 2. tile (ab, bb) of E^{fg} of element el of the block: per point and
// slot row s, M = K^{fg}[s] Phi_b, then acc += Phi_a[s] M
template <typename T, int NEN>
__device__ __forceinline__ void tile_entries(
    const Staged<T, NEN>& b, int nq, int el, int f, int g, int ab, int bb,
    T acc[Tile<NEN>::RA][Tile<NEN>::RA]) {
  constexpr int RA = Tile<NEN>::RA;
#pragma unroll
  for (int i = 0; i < RA; ++i)
#pragma unroll
    for (int j = 0; j < RA; ++j) acc[i][j] = T(0);
  for (int q = 0; q < nq; ++q) {
    const T* Kq = b.K + (el * nq + q) * NS * NS;
    const T* ph = b.phi + (el * nq + q) * NEN * 6;
    T pb[RA][6];
#pragma unroll
    for (int j = 0; j < RA; ++j) load6(ph + (bb * RA + j) * 6, pb[j]);
#pragma unroll
    for (int s = 0; s < 6; ++s) {
      T kr[6];
      load6(Kq + (f * 6 + s) * NS + g * 6, kr);
      T m[RA];
#pragma unroll
      for (int j = 0; j < RA; ++j) {
        T x = T(0);
#pragma unroll
        for (int u = 0; u < 6; ++u) x += kr[u] * pb[j][u];
        m[j] = x;
      }
#pragma unroll
      for (int i = 0; i < RA; ++i) {
        const T pa = ph[(ab * RA + i) * 6 + s];
#pragma unroll
        for (int j = 0; j < RA; ++j) acc[i][j] += pa * m[j];
      }
    }
  }
}

// 3. the tile's entries, times the row factors of both sides, into the
// upper triangle of the block's E (shared); a tile on E's diagonal
// (f = g, ab = bb) gives its upper triangle only
template <typename T, int NEN>
__device__ __forceinline__ void write_tile(
    const Staged<T, NEN>& b, int el, int f, int g, int ab, int bb,
    const T acc[Tile<NEN>::RA][Tile<NEN>::RA]) {
  constexpr int NLOC = 3 * NEN, RA = Tile<NEN>::RA, LD = Staged<T, NEN>::LD;
  const T* F = b.F + el * NLOC;
  T* Ee = b.E + el * NLOC * LD;
  const bool diag = f == g && ab == bb;
#pragma unroll
  for (int i = 0; i < RA; ++i) {
    const int row = f * NEN + ab * RA + i;
    const T fr = F[row];
#pragma unroll
    for (int j = 0; j < RA; ++j) {
      if (diag && j < i) continue;
      const int col = g * NEN + bb * RA + j;
      Ee[row * LD + col] = acc[i][j] * fr * F[col];
    }
  }
}

// 4. the block's E, contiguous in device memory (coalesced stores), its
// lower triangle read from the upper: E is exactly symmetric
template <typename T, int NEN>
__device__ __forceinline__ void store_block(const TangentArgs<T>& a,
                                            const Staged<T, NEN>& b) {
  constexpr int NLOC = 3 * NEN, NN = NLOC * NLOC, LD = Staged<T, NEN>::LD;
  __syncthreads();
  T* out = a.E + (size_t)b.e0 * NN;
  for (int i = threadIdx.x; i < b.nb * NN; i += blockDim.x) {
    const int el = i / NN, row = (i % NN) / NLOC, col = i % NLOC;
    const T* Ee = b.E + el * NLOC * LD;
    out[i] = row <= col ? Ee[row * LD + col] : Ee[col * LD + row];
  }
}

template <typename T, int NEN>
__global__ void __launch_bounds__(THREADS)
tangent_stencil_kernel(const TangentArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Staged<T, NEN> b(smem_raw, tangent_epb(a.nq), a.nq, a.nel);
  stage_inputs(a, b);
  stage_jets(a, b);
  stage_jacobians(a, b);
  constexpr int RA = Tile<NEN>::RA, COUNT = Tile<NEN>::COUNT;
  for (int w = threadIdx.x; w < b.nb * COUNT; w += THREADS) {
    int f, g, ab, bb;
    upper_tile<NEN>(w % COUNT, f, g, ab, bb);
    T acc[RA][RA];
    tile_entries(b, a.nq, w / COUNT, f, g, ab, bb, acc);
    write_tile(b, w / COUNT, f, g, ab, bb, acc);
  }
  store_block(a, b);
}

// The stencil fold of the element matrices E [nel_y nel_x][27][27] of a
// biquadratic 3-field shell: S[f][g][oy][ox][iy][ix] is the sum over the
// (up to 9) elements (iy - ay, ix - ax) of their entry ((f, ay, ax),
// (g, ay + oy - 2, ax + ox - 2)).  A block takes field f of FOLD_COLS
// points of one grid row: it stages the rows (f, ay, .) of the elements
// that touch them (3 x (FOLD_COLS + 2) elements, 81 values each, zero
// outside the grid) and writes each S entry once.
constexpr int FOLD_COLS = 32;
constexpr int FOLD_THREADS = 256;
constexpr int FOLD_W = FOLD_COLS + 2;

template <typename T>
__global__ void __launch_bounds__(FOLD_THREADS)
tangent_stencil_fold_kernel(int nel_y, int nel_x, const T* __restrict__ E,
                    T* __restrict__ S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sh = reinterpret_cast<T*>(smem_raw);  // [3][FOLD_W][81]
  const int ncp_x = nel_x + 2, ncp_y = nel_y + 2;
  const int ix0 = blockIdx.x * FOLD_COLS, iy = blockIdx.y, f = blockIdx.z;
  for (int i = threadIdx.x; i < 3 * FOLD_W * 81; i += FOLD_THREADS) {
    const int k = i % 81, col = (i / 81) % FOLD_W, ay = i / (81 * FOLD_W);
    const int ey = iy - ay, ex = ix0 - 2 + col;
    if (ey >= 0 && ey < nel_y && ex >= 0 && ex < nel_x)
      __pipeline_memcpy_async(
          sh + i, E + ((size_t)ey * nel_x + ex) * 729 + (f * 9 + ay * 3) * 27
                      + k,
          sizeof(T));
    else
      sh[i] = T(0);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  const size_t plane = (size_t)ncp_y * ncp_x;
  for (int o = threadIdx.x; o < 75 * FOLD_COLS; o += FOLD_THREADS) {
    const int px = o % FOLD_COLS, goo = o / FOLD_COLS;  // (g, oy, ox)
    const int ox = goo % 5, oy = (goo / 5) % 5, g = goo / 25;
    if (ix0 + px >= ncp_x) continue;
    T acc = T(0);
#pragma unroll
    for (int ay = 0; ay < 3; ++ay) {
      const int by = ay + oy - 2;
      if (by < 0 || by > 2) continue;
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        const int bx = ax + ox - 2;
        if (bx < 0 || bx > 2) continue;
        acc += sh[(ay * FOLD_W + px - ax + 2) * 81 + ax * 27 + g * 9
                  + by * 3 + bx];
      }
    }
    S[((size_t)(f * 3 + g) * 25 + oy * 5 + ox) * plane
      + (size_t)iy * ncp_x + ix0 + px] = acc;
  }
}

// launched with its dynamic shared memory, opted in above 48 KB once a
// kernel and size
template <typename T, int NEN>
cudaError_t launch_tangent(const TangentArgs<T>& a, cudaStream_t stream) {
  const size_t smem = tangent_smem<T>(a.nq, NEN);
  static size_t allowed = 48 * 1024;
  const cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(tangent_stencil_kernel<T, NEN>), smem,
      &allowed);
  if (err != cudaSuccess) return err;
  const int epb = tangent_epb(a.nq);
  tangent_stencil_kernel<T, NEN><<<(a.nel + epb - 1) / epb, THREADS, smem,
                                   stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fold(int nel_y, int nel_x, const T* E, T* S,
                        cudaStream_t stream) {
  const size_t smem = sizeof(T) * 3 * FOLD_W * 81;
  static size_t allowed = 48 * 1024;
  const cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(tangent_stencil_fold_kernel<T>), smem,
      &allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((nel_x + 2 + FOLD_COLS - 1) / FOLD_COLS, nel_y + 2, 3);
  tangent_stencil_fold_kernel<T><<<grid, FOLD_THREADS, smem, stream>>>(
      nel_y, nel_x, E, S);
  return cudaGetLastError();
}

}  // namespace

template <typename T>
cudaError_t tangent_stencil_launch(int nel_y, int nel_x, int nq,
                                   const int* conn, const T* U, const T* dN,
                                   const T* d2N, const T* scale, const T* DF,
                                   const T* d2F, const T* ref_a,
                                   const T* ref_b, const T* ea,
                                   const double* c, T* E, T* S,
                                   cudaStream_t stream) {
  const int nel = nel_y * nel_x;
  if (nq < 1 || nq > MAXQ_STENCIL) return cudaErrorInvalidValue;
  if (nel > 0) {
    const TangentArgs<T> a{nel, nq, conn, U, dN, d2N, scale, DF, d2F,
                           ref_a, ref_b, ea, nullptr,
                           ShellConst<T>{T(c[0]), T(c[1]), T(c[2]), T(c[3])},
                           nullptr, E};
    const cudaError_t err = launch_tangent<T, 9>(a, stream);
    if (err != cudaSuccess) return err;
  }
  return launch_fold<T>(nel_y, nel_x, E, S, stream);
}

template <typename T>
cudaError_t tangent_elements_launch(int nel, int nq, int nen,
                                    const int* conn, const T* U,
                                    const T* dN, const T* d2N,
                                    const T* scale, const T* DF,
                                    const T* d2F, const T* ref_a,
                                    const T* ref_b, const T* ea,
                                    const T* mask, const double* c,
                                    const T* me, T* E, cudaStream_t stream) {
  if (nq < 1 || nq > MAXQ || (nen != 9 && nen != 16))
    return cudaErrorInvalidValue;
  if (nel == 0) return cudaSuccess;
  const TangentArgs<T> a{nel, nq, conn, U, dN, d2N, scale, DF, d2F,
                         ref_a, ref_b, ea, mask,
                         ShellConst<T>{T(c[0]), T(c[1]), T(c[2]), T(c[3])},
                         me, E};
  return nen == 9 ? launch_tangent<T, 9>(a, stream)
                  : launch_tangent<T, 16>(a, stream);
}

template cudaError_t tangent_stencil_launch<float>(
    int, int, int, const int*, const float*, const float*, const float*,
    const float*, const float*, const float*, const float*, const float*,
    const float*, const double*, float*, float*, cudaStream_t);
template cudaError_t tangent_stencil_launch<double>(
    int, int, int, const int*, const double*, const double*, const double*,
    const double*, const double*, const double*, const double*,
    const double*, const double*, const double*, double*, double*,
    cudaStream_t);
template cudaError_t tangent_elements_launch<float>(
    int, int, int, const int*, const float*, const float*, const float*,
    const float*, const float*, const float*, const float*, const float*,
    const float*, const float*, const double*, const float*, float*,
    cudaStream_t);
template cudaError_t tangent_elements_launch<double>(
    int, int, int, const int*, const double*, const double*, const double*,
    const double*, const double*, const double*, const double*,
    const double*, const double*, const double*, const double*,
    const double*, double*, cudaStream_t);

}  // namespace tigar
