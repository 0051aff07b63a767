// K16 designs tried and not kept, timed against the port's two passes
// (csrc/sumfac_jets.cu) by scripts/k16_designs.py on the 24^3 drop-1
// Poisson field and the 128^2 shell's three fields.
//
// Pass 2 as first built (32-bit index math beside the port's register
// list of each direction's candidates), and without the list (the
// candidates found as the sum goes) with and without 32-bit indices, are
// timed against the port's pass 2.
//
// "staged": a block stages its elements' cotangents in shared memory
// ([component][q0][column][element], cp.async 4- / 8-byte copies, all the
// lines of the block where they fit, else double-buffered slabs), then a
// thread (element, column, a0) contracts them from shared memory.  Its
// ablations (variant bits: 1 skips the tables' staging, 2 the
// cotangents' staging, 4 the contraction; 7 leaves the launch, the block
// set-up and the writes) split its time.  The port's design reads the
// cotangents straight from device memory instead.
#include "../tigar_tpu_torch/csrc/sumfac_jets.cu"

#include <cmath>
#include <cstdio>
#include <random>
#include <vector>

namespace tigar {
namespace designs {

__constant__ int g_variant;
constexpr int PPMAX = 4;
constexpr int JETS_THREADS = 256;

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(BYTES)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

extern __shared__ __align__(16) unsigned char jets_smem[];

// the raw cotangent components of a point a column: val, g_0..g_{D-1} and
// (nders 2) h_00, h_01, ..., h_{D-1,D-1}
template <int D, int ND>
__host__ __device__ constexpr int jet_comps() {
  return 1 + D + (ND >= 2 ? D * D : 0);
}

// the shared memory of a pass-1 block: nbuf slabs of sl staged lines, a
// line [comp][q0][c][e0], and the tables T0 [q0][k][a0][e0], T1
// [q1][k][a1], T2 [q2][k][a2]
template <typename T, int D, int ND>
size_t local_smem(const SumfacJetsArgs<T>& A, int e0c, int cc, int sl,
                  int nbuf) {
  const int nk = ND + 1;
  const int pp2 = D == 3 ? A.pp[2] : 1;
  return sizeof(T) *
         ((size_t)nbuf * sl * jet_comps<D, ND>() * A.nq * cc * e0c +
          (size_t)A.nq * nk * (A.pp[0] * e0c + A.pp[1] + pp2));
}

// K16, pass 1: element-local contributions local[a2][a1][a0][c][e] =
// sum over the element's points of the cotangents times the table
// products.  A block takes e0c elements of one row of the element grid
// (e1, e2 fixed) and cc columns, a thread (e0, column, a0).  The block's
// cotangents come through shared memory a slab of sl lines (q_{D-1}, ...,
// q_1) at a time (all of them where they fit), the next slab's cp.async
// copies in flight while this one is contracted, line by line: over q0
// with T0 into G0 (the Hessian's (d1, d2) and (d2, d1) share one table
// product), over q1 with T1 into G1, and at a line's last q1 over q2 with
// T2 into L.
template <typename T, int D, int ND>
__global__ void __launch_bounds__(JETS_THREADS)
staged_local(SumfacJetsArgs<T> A, const T* __restrict__ cval,
                          const T* __restrict__ cg,
                          const T* __restrict__ ch, T* __restrict__ local,
                          int e0c, int cc, int sl) {
  // bits: 1 skips the tables, 2 the staging, 4 the contraction
  const int variant = g_variant;
  constexpr int NC = jet_comps<D, ND>();
  constexpr int NK = ND + 1;
  T* smem = reinterpret_cast<T*>(jets_smem);
  const int nq = A.nq, pp0 = A.pp[0], pp1 = A.pp[1];
  const int pp2 = D == 3 ? A.pp[2] : 1;
  const int nel0 = A.nel[0], nel1 = A.nel[1], nel2 = D == 3 ? A.nel[2] : 1;
  const int nch0 = (nel0 + e0c - 1) / e0c;
  int blk = blockIdx.x;
  const int e0a = (blk % nch0) * e0c;
  blk /= nch0;
  const int e1 = blk % nel1;
  blk /= nel1;
  const int e2 = blk % nel2;
  const int c0 = (blk / nel2) * cc;
  const int ne0 = min(e0c, nel0 - e0a), ncc = min(cc, A.ncols - c0);
  const int qs = cc * e0c;                  // stride of q0 in a line
  const int cs = nq * qs;                   // stride of a component
  const int line = NC * cs;
  const int nlines = D == 3 ? nq * nq : nq;
  const int nslab = (nlines + sl - 1) / sl;
  T* t0s = smem + (nslab > 1 ? 2 : 1) * sl * line;
  T* t1s = t0s + nq * NK * pp0 * e0c;
  T* t2s = t1s + nq * NK * pp1;
  const int tid = threadIdx.x, nth = blockDim.x;

  if (!(variant & 1)) {
    const T* g0 = A.tab[0] + (int64_t)e0a * nq * NK * pp0;
    for (int f = tid; f < ne0 * nq * NK * pp0; f += nth) {
      const int a = f % pp0;
      int r = f / pp0;
      const int k = r % NK;
      r /= NK;
      t0s[(((r % nq) * NK + k) * pp0 + a) * e0c + r / nq] = g0[f];
    }
    const T* g1 = A.tab[1] + (int64_t)e1 * nq * NK * pp1;
    for (int f = tid; f < nq * NK * pp1; f += nth) t1s[f] = g1[f];
    if (D == 3) {
      const T* g2 = A.tab[2] + (int64_t)e2 * nq * NK * pp2;
      for (int f = tid; f < nq * NK * pp2; f += nth) t2s[f] = g2[f];
    }
  }

  // line ln = (q2, q1): its ne0 nq points are contiguous in the point grid,
  // each point's ncc columns of an array a run of w = ncc na values.  A
  // thread copies value j = tid % w of every (nth / w)-th point (its
  // place in the line found by counting, no division a value), or, where
  // w > nth, walks the values one by one.
  const int M = A.M, col = A.col0 + c0;
  constexpr int NARR = ND >= 2 ? 3 : 2;
  int sj[NARR], sstep[NARR];
#pragma unroll
  for (int arr = 0; arr < NARR; ++arr) {
    const int w = ncc * (arr == 0 ? 1 : arr == 1 ? D : D * D);
    sj[arr] = w <= nth ? tid % w : -1;
    sstep[arr] = w <= nth ? nth / w : 0;
  }
  auto stage = [&](int ln, T* dst) {
    const int q1 = D == 3 ? ln % nq : ln, q2 = D == 3 ? ln / nq : 0;
    const int64_t pt0 =
        (((((int64_t)e2 * nq + q2) * nel1 + e1) * nq + q1) * nel0 + e0a) *
        nq;
    const int npt = ne0 * nq;
#pragma unroll
    for (int arr = 0; arr < NARR; ++arr) {
      const int na = arr == 0 ? 1 : arr == 1 ? D : D * D;
      const int off = arr == 0 ? 0 : arr == 1 ? 1 : 1 + D;
      const T* src = arr == 0 ? cval : arr == 1 ? cg : ch;
      if (sj[arr] >= 0) {
        const int w = ncc * na, step = sstep[arr];
        int p = tid / w;
        if (p >= step) continue;
        const int c = sj[arr] / na, ca = sj[arr] % na;
        int q0 = p % nq, el = p / nq;
        const int dq = step % nq, de = step / nq;
        const T* sp = src + ((pt0 + p) * M + col + c) * na + ca;
        const int64_t ds = (int64_t)step * M * na;
        T* dp = dst + (off + ca) * cs + c * e0c;
        for (; p < npt; p += step, sp += ds) {
          cp_async<sizeof(T)>(dp + q0 * qs + el, sp);
          q0 += dq;
          el += de;
          if (q0 >= nq) {
            q0 -= nq;
            ++el;
          }
        }
        continue;
      }
      for (int f = tid; f < npt * ncc * na; f += nth) {
        const int ca = f % na;
        int r = f / na;
        const int c = r % ncc;
        const int p = r / ncc;
        cp_async<sizeof(T)>(
            dst + (off + ca) * cs + (p % nq) * qs + c * e0c + p / nq,
            src + ((pt0 + p) * M + col + c) * na + ca);
      }
    }
  };

  const int e0l = tid % e0c;
  const int c = (tid / e0c) % cc;
  const int a0 = tid / (e0c * cc);
  const bool active = e0l < ne0 && c < ncc && a0 < pp0;
  T L[PPMAX][PPMAX], G1[PPMAX][NK];
#pragma unroll
  for (int i = 0; i < PPMAX; ++i) {
#pragma unroll
    for (int j = 0; j < PPMAX; ++j) L[i][j] = T(0);
#pragma unroll
    for (int k = 0; k < NK; ++k) G1[i][k] = T(0);
  }

  // slab k: lines k sl .. (k + 1) sl - 1, in buffer k % 2
  auto stage_slab = [&](int k) {
    if (variant & 2) return;
    T* dst = smem + (k & 1) * sl * line;
    for (int ln = k * sl; ln < min(nlines, (k + 1) * sl); ++ln)
      stage(ln, dst + (ln - k * sl) * line);
  };
  stage_slab(0);
  cp_async_commit();
  for (int ln = 0; ln < nlines; ++ln) {
    const int k = ln / sl;
    if (ln == k * sl) {
      if (k + 1 < nslab) {
        stage_slab(k + 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
    }
    if (active && !(variant & 4)) {
      const T* F =
          smem + ((k & 1) * sl + ln - k * sl) * line + c * e0c + e0l;
      const int q1 = D == 3 ? ln % nq : ln, q2 = D == 3 ? ln / nq : 0;
      // over q0: G0[k1][k2] = sum_{q0, k0} F(k0, k1, k2) T0[q0][k0][a0]
      T G0[NK][NK];
#pragma unroll
      for (int i = 0; i < NK; ++i)
#pragma unroll
        for (int j = 0; j < NK; ++j) G0[i][j] = T(0);
      for (int q0 = 0; q0 < nq; ++q0) {
        const T* Fq = F + q0 * qs;
        T t[NK];
#pragma unroll
        for (int k = 0; k < NK; ++k)
          t[k] = t0s[((q0 * NK + k) * pp0 + a0) * e0c + e0l];
        G0[0][0] += Fq[0] * t[0] + Fq[cs] * t[1];
        G0[1][0] += Fq[2 * cs] * t[0];
        if (D == 3) G0[0][1] += Fq[3 * cs] * t[0];
        if constexpr (ND >= 2) {
          const T* h = Fq + (1 + D) * cs;
          G0[0][0] += h[0] * t[2];
          G0[1][0] += (h[cs] + h[D * cs]) * t[1];
          G0[2][0] += h[(D + 1) * cs] * t[0];
          if (D == 3) {
            G0[0][1] += (h[2 * cs] + h[6 * cs]) * t[1];
            G0[1][1] += (h[5 * cs] + h[7 * cs]) * t[0];
            G0[0][2] += h[8 * cs] * t[0];
          }
        }
      }
      // over q1: G1[a1][k2] += sum_k1 G0[k1][k2] T1[q1][k1][a1]
#pragma unroll
      for (int a1 = 0; a1 < PPMAX; ++a1) {
        if (a1 >= pp1) break;
#pragma unroll
        for (int k2 = 0; k2 < (D == 3 ? NK : 1); ++k2)
#pragma unroll
          for (int k1 = 0; k1 + k2 < NK; ++k1)
            G1[a1][k2] += G0[k1][k2] * t1s[(q1 * NK + k1) * pp1 + a1];
      }
      // over q2, after the line's last q1
      if (q1 == nq - 1) {
#pragma unroll
        for (int a1 = 0; a1 < PPMAX; ++a1) {
          if (a1 >= pp1) break;
          if (D == 3) {
#pragma unroll
            for (int a2 = 0; a2 < PPMAX; ++a2) {
              if (a2 >= pp2) break;
#pragma unroll
              for (int k2 = 0; k2 < NK; ++k2)
                L[a2][a1] += G1[a1][k2] * t2s[(q2 * NK + k2) * pp2 + a2];
            }
          } else {
            L[0][a1] += G1[a1][0];
          }
#pragma unroll
          for (int k = 0; k < NK; ++k) G1[a1][k] = T(0);
        }
      }
    }
    if (ln + 1 == min(nlines, (k + 1) * sl))
      __syncthreads();      // slab k's buffer is restaged for slab k + 2
  }
  if (!active) return;
  const int64_t nel = (int64_t)nel0 * nel1 * nel2;
  const int64_t e = ((int64_t)e2 * nel1 + e1) * nel0 + e0a + e0l;
#pragma unroll
  for (int a2 = 0; a2 < PPMAX; ++a2) {
    if (a2 >= pp2) break;
#pragma unroll
    for (int a1 = 0; a1 < PPMAX; ++a1) {
      if (a1 >= pp1) break;
      local[((((int64_t)a2 * pp1 + a1) * pp0 + a0) * A.ncols + c0 + c) * nel +
            e] = L[a2][a1];
    }
  }
}


// pass 2 with the forks it was first built with: LIST lists each
// direction's candidates in registers (where there are at most PPMAX of
// them) before the sum, else they are found as it goes; IDX32 does the
// index math in 32 bits where the thread count allows.  The port's pass 2
// is <LIST, !IDX32>.  The sum order is the same, so are the results.
template <typename T, int D, bool LIST, bool IDX32>
__global__ void __launch_bounds__(JETS_THREADS)
gather_variant(SumfacJetsArgs<T> A, const T* __restrict__ local,
               T* __restrict__ out) {
  const int64_t ncp_tot =
      (int64_t)A.ncp[0] * A.ncp[1] * (D == 3 ? A.ncp[2] : 1);
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= ncp_tot * A.ncols) return;
  int64_t i;
  int c, ix[3];
  if (IDX32 && ncp_tot * A.ncols < (int64_t(1) << 31)) {     // 32-bit index math
    const int n = (int)ncp_tot, tt = (int)t, it = tt % n;
    i = it;
    c = tt / n;
    ix[0] = it % A.ncp[0];
    ix[1] = (it / A.ncp[0]) % A.ncp[1];
    ix[2] = D == 3 ? it / (A.ncp[0] * A.ncp[1]) : 0;
  } else {
    i = t % ncp_tot;
    c = (int)(t / ncp_tot);
    ix[0] = (int)(i % A.ncp[0]);
    ix[1] = (int)((i / A.ncp[0]) % A.ncp[1]);
    ix[2] = D == 3 ? (int)(i / ((int64_t)A.ncp[0] * A.ncp[1])) : 0;
  }
  const int pp0 = A.pp[0], pp1 = A.pp[1];
  const int nel0 = A.nel[0], nel1 = A.nel[1];
  const int64_t nel = (int64_t)nel0 * nel1 * (D == 3 ? A.nel[2] : 1);
  const T* lc = local + (int64_t)c * nel;
  const int64_t cs = (int64_t)A.ncols * nel;        // stride of a slot
  T acc = T(0);
  // each direction's candidates, found once
  bool ok[3][PPMAX];
  int ce[3][PPMAX], ca[3][PPMAX];
  bool listed = LIST;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    if (d < D) {
      listed = listed && cover_list(A, d, ix[d], ok[d], ce[d], ca[d]);
    } else {                            // D = 2: one trivial candidate
#pragma unroll
      for (int k = 0; k < PPMAX; ++k) {
        ok[d][k] = k == 0;
        ce[d][k] = ca[d][k] = 0;
      }
    }
  }
  if (listed) {
#pragma unroll
    for (int k2 = 0; k2 < PPMAX; ++k2) {
      if (!ok[2][k2]) continue;
#pragma unroll
      for (int k1 = 0; k1 < PPMAX; ++k1) {
        if (!ok[1][k1]) continue;
        const int64_t s1 = (int64_t)ca[2][k2] * pp1 + ca[1][k1];
        const int64_t row = ((int64_t)ce[2][k2] * nel1 + ce[1][k1]) * nel0;
#pragma unroll
        for (int k0 = 0; k0 < PPMAX; ++k0)
          if (ok[0][k0])
            acc += __ldg(lc + (s1 * pp0 + ca[0][k0]) * cs + row + ce[0][k0]);
      }
    }
  } else {                  // the same sum, the pairs found as it goes
    int r0a, r0b, r1a, r1b, r2a = 0, r2b = 1;
    cover_range(A, 0, ix[0], r0a, r0b);
    cover_range(A, 1, ix[1], r1a, r1b);
    if (D == 3) cover_range(A, 2, ix[2], r2a, r2b);
    for (int k2 = r2a; k2 < r2b; ++k2) {
      int e2 = 0, a2 = 0;
      if (D == 3 && !cover(A, 2, ix[2], k2, e2, a2)) continue;
      for (int k1 = r1a; k1 < r1b; ++k1) {
        int e1, a1;
        if (!cover(A, 1, ix[1], k1, e1, a1)) continue;
        const int64_t s1 = (int64_t)a2 * pp1 + a1;
        const int64_t row = ((int64_t)e2 * nel1 + e1) * nel0;
        for (int k0 = r0a; k0 < r0b; ++k0) {
          int e0, a0;
          if (!cover(A, 0, ix[0], k0, e0, a0)) continue;
          acc += __ldg(lc + (s1 * pp0 + a0) * cs + row + e0);
        }
      }
    }
  }
  out[A.base + c * A.col_stride + i * A.cp_stride] = acc;
}

// pass 1's block: cc columns (up to all of them) and e0c elements of a row
// of the grid, at most JETS_THREADS threads and LOCAL_SMEM bytes
constexpr size_t LOCAL_SMEM = 96 * 1024;

template <typename T, int D, int ND>
cudaError_t staged_launch(const SumfacJetsArgs<T>& a, const T* cval,
                          const T* cg, const T* ch, T* local,
                          cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  const int pp0 = a.pp[0];
  const int nlines = D == 3 ? a.nq * a.nq : a.nq;
  int cc = std::min(a.ncols, std::max(1, JETS_THREADS / pp0));
  int e0c = std::min(a.nel[0], std::max(1, JETS_THREADS / (cc * pp0)));
  while (local_smem<T, D, ND>(a, e0c, cc, 1, 2) > LOCAL_SMEM && e0c > 1)
    e0c = (e0c + 1) / 2;
  while (local_smem<T, D, ND>(a, e0c, cc, 1, 2) > LOCAL_SMEM && cc > 1)
    cc = (cc + 1) / 2;
  // all lines at once where they fit, else the longest double-buffered slab
  int sl = nlines, nbuf = 1;
  if (local_smem<T, D, ND>(a, e0c, cc, sl, 1) > LOCAL_SMEM) {
    nbuf = 2;
    sl = nlines - 1;
    while (sl > 1 && local_smem<T, D, ND>(a, e0c, cc, sl, 2) > LOCAL_SMEM)
      --sl;
  }
  const size_t smem = local_smem<T, D, ND>(a, e0c, cc, sl, nbuf);
  cudaError_t err =
      allow_smem((const void*)staged_local<T, D, ND>, smem,
                 &allowed);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (int64_t)((a.nel[0] + e0c - 1) / e0c) * a.nel[1] *
                         (D == 3 ? a.nel[2] : 1) *
                         ((a.ncols + cc - 1) / cc);
  staged_local<T, D, ND>
      <<<(unsigned)blocks, e0c * cc * pp0, smem, stream>>>(
          a, cval, cg, ch, local, e0c, cc, sl);
  return cudaGetLastError();
}


template <typename T, int D, int ND>
void run_case(const char* name, int nel, int nq, int pp, int ncols,
              int stride) {
  SumfacJetsArgs<T> a{};
  a.dim = D;
  a.nders = ND;
  a.nq = nq;
  std::mt19937 rng(0);
  std::normal_distribution<double> nd;
  for (int d = 0; d < 3; ++d) {
    const bool on = d < D;
    a.nel[d] = on ? nel : 1;
    a.pp[d] = on ? pp : 1;
    a.ncp[d] = on ? stride * (nel - 1) + pp : 1;
    a.start[d] = 0;
    a.stride[d] = on ? stride : 1;
    a.idx[d] = nullptr;
    a.inv[d] = nullptr;
    a.tab[d] = nullptr;
    if (!on) continue;
    std::vector<T> h((size_t)nel * nq * (ND + 1) * pp);
    for (auto& x : h) x = nd(rng);
    T* p;
    cudaMalloc(&p, h.size() * sizeof(T));
    cudaMemcpy(p, h.data(), h.size() * sizeof(T), cudaMemcpyHostToDevice);
    a.tab[d] = p;
  }
  long long npts = 1, ncp = 1;
  for (int d = 0; d < D; ++d) {
    npts *= (long long)nel * nq;
    ncp *= a.ncp[d];
  }
  a.base = 0;
  a.cp_stride = 1;
  a.col_stride = ncp;
  a.ncols = ncols;
  a.col0 = 0;
  a.M = ncols;
  a.npts = npts;
  const long long n1 = npts * ncols, nc = 1 + D + (ND >= 2 ? D * D : 0);
  std::vector<T> hc(n1 * nc);
  for (auto& x : hc) x = nd(rng);
  T *cv, *cg, *ch = nullptr, *l_port, *l_staged, *out;
  cudaMalloc(&cv, n1 * sizeof(T));
  cudaMalloc(&cg, n1 * D * sizeof(T));
  cudaMemcpy(cv, hc.data(), n1 * sizeof(T), cudaMemcpyHostToDevice);
  cudaMemcpy(cg, hc.data() + n1, n1 * D * sizeof(T), cudaMemcpyHostToDevice);
  if (ND >= 2) {
    cudaMalloc(&ch, n1 * D * D * sizeof(T));
    cudaMemcpy(ch, hc.data() + n1 * (1 + D), n1 * D * D * sizeof(T),
               cudaMemcpyHostToDevice);
  }
  const long long nl = sumfac_scatter_local_size(a);
  cudaMalloc(&l_port, nl * sizeof(T));
  cudaMalloc(&l_staged, nl * sizeof(T));
  cudaMalloc(&out, ncp * ncols * sizeof(T));
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  auto time = [&](auto launch) {
    launch();
    cudaEventRecord(e0);
    for (int i = 0; i < 200; ++i) launch();
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms;
    cudaEventElapsedTime(&ms, e0, e1);
    return ms / 200;
  };
  const float port = time([&] {
    tigar::scatter_local<T, D, ND>(a, cv, cg, ch, l_port, 0);
  });
  const float gather = time([&] {
    tigar::sumfac_scatter_jets_gather<T, D>
        <<<tigar::blocks_for(ncp * ncols), 256>>>(a, l_port, out);
  });
  // pass 2's forks, one at a time and together, against the port's
  T* out_v;
  cudaMalloc(&out_v, ncp * ncols * sizeof(T));
  const unsigned g2 = tigar::blocks_for(ncp * ncols);
  const float list32 = time([&] {
    gather_variant<T, D, true, true><<<g2, 256>>>(a, l_port, out_v);
  });
  const float walk64 = time([&] {
    gather_variant<T, D, false, false><<<g2, 256>>>(a, l_port, out_v);
  });
  const float walk32 = time([&] {
    gather_variant<T, D, false, true><<<g2, 256>>>(a, l_port, out_v);
  });
  double diff2 = 0, big2 = 0;
  {
    std::vector<T> o1(ncp * ncols), o2(ncp * ncols);
    gather_variant<T, D, false, true><<<g2, 256>>>(a, l_port, out_v);
    cudaMemcpy(o1.data(), out, o1.size() * sizeof(T),
               cudaMemcpyDeviceToHost);
    cudaMemcpy(o2.data(), out_v, o2.size() * sizeof(T),
               cudaMemcpyDeviceToHost);
    for (size_t i = 0; i < o1.size(); ++i) {
      diff2 = std::max(diff2, (double)std::abs(o1[i] - o2[i]));
      big2 = std::max(big2, (double)std::abs(o1[i]));
    }
  }
  float staged[8];
  for (int v = 0; v < 8; ++v) {
    cudaMemcpyToSymbol(g_variant, &v, sizeof(int));
    staged[v] = time([&] {
      staged_launch<T, D, ND>(a, cv, cg, ch, l_staged, 0);
    });
  }
  int v0 = 0;
  cudaMemcpyToSymbol(g_variant, &v0, sizeof(int));
  staged_launch<T, D, ND>(a, cv, cg, ch, l_staged, 0);
  std::vector<T> h1(nl), h2(nl);
  cudaMemcpy(h1.data(), l_port, nl * sizeof(T), cudaMemcpyDeviceToHost);
  cudaMemcpy(h2.data(), l_staged, nl * sizeof(T), cudaMemcpyDeviceToHost);
  double diff = 0, big = 0;
  for (long long i = 0; i < nl; ++i) {
    diff = std::max(diff, (double)std::abs(h1[i] - h2[i]));
    big = std::max(big, (double)std::abs(h1[i]));
  }
  printf("{\"case\": \"%s\", \"port_pass1_ms\": %.5f, "
         "\"port_pass2_ms\": %.5f, \"staged_ms\": %.5f, "
         "\"staged_no_tables_ms\": %.5f, \"staged_no_staging_ms\": %.5f, "
         "\"staged_no_compute_ms\": %.5f, \"staged_bare_ms\": %.5f, "
         "\"max_rel_diff\": %.3e, \"pass2_idx32_ms\": %.5f, "
         "\"pass2_walking_ms\": %.5f, \"pass2_walking_idx32_ms\": %.5f, "
         "\"pass2_variants_max_rel_diff\": %.3e, \"error\": \"%s\"}\n",
         name, port, gather, staged[0], staged[1], staged[2], staged[4],
         staged[7], diff / big, list32, walk64, walk32, diff2 / big2,
         cudaGetErrorString(cudaGetLastError()));
}

}  // namespace designs
}  // namespace tigar

int main() {
  tigar::designs::run_case<double, 3, 1>("24^3 drop 1 f64", 24, 3, 3, 1, 2);
  tigar::designs::run_case<float, 3, 1>("24^3 drop 1 f32", 24, 3, 3, 1, 2);
  tigar::designs::run_case<double, 2, 2>("128^2 shell fields f64", 128, 3, 3,
                                         3, 1);
  tigar::designs::run_case<float, 2, 2>("128^2 shell fields f32", 128, 3, 3,
                                        3, 1);
  return 0;
}
