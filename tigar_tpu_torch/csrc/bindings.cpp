// PyTorch bindings of the port's CUDA kernels: the only translation unit
// that includes the PyTorch headers.  Each function checks device, dtype,
// shape and contiguity, allocates its output, launches on the current
// stream and checks the launch.
#include <torch/extension.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

#include <optional>
#include <vector>

#include "kernels.h"

namespace {

void check(const torch::Tensor& t, const char* name, torch::ScalarType dt,
           std::vector<int64_t> shape) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.scalar_type() == dt, name, " has dtype ", t.scalar_type(),
              ", expected ", dt);
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
  TORCH_CHECK(t.sizes() == c10::IntArrayRef(shape), name, " has shape ",
              t.sizes(), ", expected ", c10::IntArrayRef(shape));
}

void check_float(torch::ScalarType dt) {
  TORCH_CHECK(dt == torch::kFloat || dt == torch::kDouble,
              "kernels take float32 or float64, got ", dt);
}

void check_launch(cudaError_t err, const char* name) {
  TORCH_CHECK(err == cudaSuccess, name, " launch failed: ",
              cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// the per-point shell data shared by K1 and K2: nen = 9 (biquadratic) or
// 16 (bicubic extraction element) local functions a field, read from N
struct ShellArgs {
  int64_t nel, nq, nen;
};

ShellArgs check_shell(const torch::Tensor& U, const torch::Tensor& conn,
                      const torch::Tensor& N, const torch::Tensor& dN,
                      const torch::Tensor& d2N, const torch::Tensor& scale,
                      const torch::Tensor& DF, const torch::Tensor& d2F,
                      const torch::Tensor& ra, const torch::Tensor& rb,
                      const torch::Tensor& ea) {
  const auto dt = U.scalar_type();
  check_float(dt);
  TORCH_CHECK(scale.dim() == 2, "scale must be [nel, nq]");
  const int64_t nel = scale.size(0), nq = scale.size(1);
  TORCH_CHECK(N.dim() == 3, "N must be [nel, nq, nen]");
  const int64_t nen = N.size(2);
  TORCH_CHECK(nen == 9 || nen == 16, "the shell kernels take 9 or 16 "
              "local functions a field, got ", nen);
  check(U, "U", dt, {U.size(0)});
  check(conn, "conn", torch::kInt, {nel, 3 * nen});
  check(N, "N", dt, {nel, nq, nen});
  check(dN, "dN", dt, {nel, nq, nen, 2});
  check(d2N, "d2N", dt, {nel, nq, nen, 2, 2});
  check(scale, "scale", dt, {nel, nq});
  check(DF, "DF", dt, {nel, nq, 3, 2});
  check(d2F, "d2F", dt, {nel, nq, 3, 2, 2});
  check(ra, "ref_a", dt, {nel, nq, 2, 2});
  check(rb, "ref_b", dt, {nel, nq, 2, 2});
  check(ea, "ea", dt, {nel, nq, 2, 2});
  TORCH_CHECK(nel * nq < (int64_t(1) << 31), "too many quadrature points");
  return {nel, nq, nen};
}

// the padding mask of ragged elements, [nel, nen] of U's type, or none
template <typename T>
const T* shell_mask(const std::optional<torch::Tensor>& mask,
                    const ShellArgs& a, torch::ScalarType dt) {
  if (!mask) return nullptr;
  check(*mask, "mask", dt, {a.nel, a.nen});
  return mask->data_ptr<T>();
}

template <typename T>
const T* ptr(const torch::Tensor& t) {
  return t.data_ptr<T>();
}

}  // namespace

torch::Tensor shell_residual(torch::Tensor U, torch::Tensor conn,
                             torch::Tensor N, torch::Tensor dN,
                             torch::Tensor d2N, torch::Tensor scale,
                             torch::Tensor DF, torch::Tensor d2F,
                             torch::Tensor ra, torch::Tensor rb,
                             torch::Tensor ea,
                             std::optional<torch::Tensor> mask,
                             std::vector<double> consts, int64_t ndof) {
  const auto a = check_shell(U, conn, N, dN, d2N, scale, DF, d2F, ra, rb, ea);
  TORCH_CHECK(consts.size() == 7, "shell_residual takes 7 constants");
  TORCH_CHECK(U.size(0) == ndof, "U has ", U.size(0), " entries, ndof ",
              ndof);
  const c10::cuda::CUDAGuard guard(U.device());
  auto r = torch::zeros({ndof}, U.options());
  auto stream = c10::cuda::getCurrentCUDAStream().stream();
  cudaError_t err;
  if (U.scalar_type() == torch::kFloat) {
    using T = float;
    const T* m = shell_mask<T>(mask, a, U.scalar_type());
    err = tigar::shell_residual_launch<T>(
        a.nel, a.nq, a.nen, conn.data_ptr<int>(), ptr<T>(U), ptr<T>(N),
        ptr<T>(dN), ptr<T>(d2N), ptr<T>(scale), ptr<T>(DF), ptr<T>(d2F),
        ptr<T>(ra), ptr<T>(rb), ptr<T>(ea), m, consts.data(),
        r.data_ptr<T>(), stream);
  } else {
    using T = double;
    const T* m = shell_mask<T>(mask, a, U.scalar_type());
    err = tigar::shell_residual_launch<T>(
        a.nel, a.nq, a.nen, conn.data_ptr<int>(), ptr<T>(U), ptr<T>(N),
        ptr<T>(dN), ptr<T>(d2N), ptr<T>(scale), ptr<T>(DF), ptr<T>(d2F),
        ptr<T>(ra), ptr<T>(rb), ptr<T>(ea), m, consts.data(),
        r.data_ptr<T>(), stream);
  }
  check_launch(err, "shell_residual");
  return r;
}

torch::Tensor tangent_stencil(torch::Tensor U, torch::Tensor conn,
                              torch::Tensor N, torch::Tensor dN,
                              torch::Tensor d2N, torch::Tensor scale,
                              torch::Tensor DF, torch::Tensor d2F,
                              torch::Tensor ra, torch::Tensor rb,
                              torch::Tensor ea, std::vector<double> consts,
                              std::vector<int64_t> nel_shape,
                              std::vector<int64_t> grid_shape) {
  const auto a = check_shell(U, conn, N, dN, d2N, scale, DF, d2F, ra, rb, ea);
  TORCH_CHECK(consts.size() == 4, "tangent_stencil takes 4 constants");
  TORCH_CHECK(nel_shape.size() == 2 && grid_shape.size() == 2,
              "tangent_stencil is 2D");
  TORCH_CHECK(nel_shape[0] * nel_shape[1] == a.nel, "element grid ",
              c10::IntArrayRef(nel_shape), " does not match ", a.nel,
              " elements");
  TORCH_CHECK(grid_shape[0] == nel_shape[0] + 2 &&
                  grid_shape[1] == nel_shape[1] + 2,
              "grid ", c10::IntArrayRef(grid_shape),
              " is not the p=2 grid of ", c10::IntArrayRef(nel_shape));
  TORCH_CHECK(a.nen == 9, "tangent_stencil folds biquadratic elements "
              "(9 local functions a field), got ", a.nen);
  TORCH_CHECK(a.nq >= 1 && a.nq <= 9, "tangent_stencil takes at most 9 "
              "quadrature points, got ", a.nq);
  const c10::cuda::CUDAGuard guard(U.device());
  // every entry of S is written by the fold; E is its scratch
  auto S = torch::empty({3, 3, 5, 5, grid_shape[0], grid_shape[1]},
                        U.options());
  auto E = torch::empty({a.nel, 27, 27}, U.options());
  auto stream = c10::cuda::getCurrentCUDAStream().stream();
  cudaError_t err;
  if (U.scalar_type() == torch::kFloat) {
    using T = float;
    err = tigar::tangent_stencil_launch<T>(
        nel_shape[0], nel_shape[1], a.nq, conn.data_ptr<int>(), ptr<T>(U),
        ptr<T>(dN), ptr<T>(d2N), ptr<T>(scale), ptr<T>(DF), ptr<T>(d2F),
        ptr<T>(ra), ptr<T>(rb), ptr<T>(ea), consts.data(), E.data_ptr<T>(),
        S.data_ptr<T>(), stream);
  } else {
    using T = double;
    err = tigar::tangent_stencil_launch<T>(
        nel_shape[0], nel_shape[1], a.nq, conn.data_ptr<int>(), ptr<T>(U),
        ptr<T>(dN), ptr<T>(d2N), ptr<T>(scale), ptr<T>(DF), ptr<T>(d2F),
        ptr<T>(ra), ptr<T>(rb), ptr<T>(ea), consts.data(), E.data_ptr<T>(),
        S.data_ptr<T>(), stream);
  }
  check_launch(err, "tangent_stencil");
  return S;
}

torch::Tensor tangent_elements(torch::Tensor U, torch::Tensor conn,
                               torch::Tensor N, torch::Tensor dN,
                               torch::Tensor d2N, torch::Tensor scale,
                               torch::Tensor DF, torch::Tensor d2F,
                               torch::Tensor ra, torch::Tensor rb,
                               torch::Tensor ea,
                               std::optional<torch::Tensor> mask,
                               std::vector<double> consts,
                               std::optional<torch::Tensor> me) {
  const auto a = check_shell(U, conn, N, dN, d2N, scale, DF, d2F, ra, rb, ea);
  TORCH_CHECK(consts.size() == 4, "tangent_elements takes 4 constants");
  TORCH_CHECK(a.nq >= 1 && a.nq <= 16, "tangent_elements takes at most 16 "
              "quadrature points, got ", a.nq);
  const int64_t nloc = 3 * a.nen;
  if (me) check(*me, "me", U.scalar_type(), {a.nel, nloc});
  const c10::cuda::CUDAGuard guard(U.device());
  auto E = torch::empty({a.nel, nloc, nloc}, U.options());
  auto stream = c10::cuda::getCurrentCUDAStream().stream();
  cudaError_t err;
  if (U.scalar_type() == torch::kFloat) {
    using T = float;
    const T* m = shell_mask<T>(mask, a, U.scalar_type());
    err = tigar::tangent_elements_launch<T>(
        a.nel, a.nq, a.nen, conn.data_ptr<int>(), ptr<T>(U), ptr<T>(dN),
        ptr<T>(d2N), ptr<T>(scale), ptr<T>(DF), ptr<T>(d2F), ptr<T>(ra),
        ptr<T>(rb), ptr<T>(ea), m, consts.data(),
        me ? ptr<T>(*me) : nullptr, E.data_ptr<T>(), stream);
  } else {
    using T = double;
    const T* m = shell_mask<T>(mask, a, U.scalar_type());
    err = tigar::tangent_elements_launch<T>(
        a.nel, a.nq, a.nen, conn.data_ptr<int>(), ptr<T>(U), ptr<T>(dN),
        ptr<T>(d2N), ptr<T>(scale), ptr<T>(DF), ptr<T>(d2F), ptr<T>(ra),
        ptr<T>(rb), ptr<T>(ea), m, consts.data(),
        me ? ptr<T>(*me) : nullptr, E.data_ptr<T>(), stream);
  }
  check_launch(err, "tangent_elements");
  return E;
}

torch::Tensor elem_tangent_apply(torch::Tensor conn, torch::Tensor E,
                                 torch::Tensor x,
                                 std::optional<torch::Tensor> mask) {
  const auto dt = E.scalar_type();
  check_float(dt);
  TORCH_CHECK(conn.dim() == 2 && x.dim() == 1, "conn [nel, nloc], x [ndof]");
  const int64_t nel = conn.size(0), nloc = conn.size(1), ndof = x.size(0);
  TORCH_CHECK(nloc >= 1 && nloc <= 64, "at most 64 local functions");
  TORCH_CHECK(ndof < (int64_t(1) << 31) && nel < (int64_t(1) << 31),
              "too many DoFs or elements");
  check(conn, "conn", torch::kInt, {nel, nloc});
  check(E, "E", dt, {nel, nloc, nloc});
  check(x, "x", dt, {ndof});
  if (mask) check(*mask, "mask", dt, {ndof});
  const c10::cuda::CUDAGuard guard(x.device());
  auto y = torch::empty_like(x);
  auto stream = c10::cuda::getCurrentCUDAStream().stream();
  cudaError_t err;
  if (dt == torch::kFloat) {
    using T = float;
    err = tigar::elem_tangent_apply_launch<T>(
        nel, nloc, ndof, conn.data_ptr<int>(), ptr<T>(E), ptr<T>(x),
        mask ? ptr<T>(*mask) : nullptr, y.data_ptr<T>(), stream);
  } else {
    using T = double;
    err = tigar::elem_tangent_apply_launch<T>(
        nel, nloc, ndof, conn.data_ptr<int>(), ptr<T>(E), ptr<T>(x),
        mask ? ptr<T>(*mask) : nullptr, y.data_ptr<T>(), stream);
  }
  check_launch(err, "elem_tangent_apply");
  return y;
}

torch::Tensor elem_tangent_diagonal(torch::Tensor conn, torch::Tensor E,
                                    int64_t ndof) {
  const auto dt = E.scalar_type();
  check_float(dt);
  TORCH_CHECK(conn.dim() == 2, "conn must be [nel, nloc]");
  const int64_t nel = conn.size(0), nloc = conn.size(1);
  check(conn, "conn", torch::kInt, {nel, nloc});
  check(E, "E", dt, {nel, nloc, nloc});
  TORCH_CHECK(ndof >= 0 && ndof < (int64_t(1) << 31), "bad ndof ", ndof);
  const c10::cuda::CUDAGuard guard(E.device());
  auto d = torch::zeros({ndof}, E.options());
  auto stream = c10::cuda::getCurrentCUDAStream().stream();
  cudaError_t err;
  if (dt == torch::kFloat) {
    using T = float;
    err = tigar::elem_tangent_diagonal_launch<T>(
        nel, nloc, conn.data_ptr<int>(), ptr<T>(E), d.data_ptr<T>(), stream);
  } else {
    using T = double;
    err = tigar::elem_tangent_diagonal_launch<T>(
        nel, nloc, conn.data_ptr<int>(), ptr<T>(E), d.data_ptr<T>(), stream);
  }
  check_launch(err, "elem_tangent_diagonal");
  return d;
}

// K11 over the sliced layout of ops/sparse.sliced_ell (tiles, starts, cols,
// vals: the level's constants, checked in full where the level reaches the
// card); the vectors are checked here on every call
torch::Tensor ell_spmv(torch::Tensor tiles, torch::Tensor starts,
                       torch::Tensor cols, torch::Tensor vals, int64_t n,
                       int64_t ncols, std::optional<torch::Tensor> x,
                       std::optional<torch::Tensor> b,
                       std::optional<torch::Tensor> om_dinv, int64_t mode) {
  const auto dt = vals.scalar_type();
  check_float(dt);
  TORCH_CHECK(mode >= 0 && mode <= 4, "mode must be 0 to 4, got ", mode);
  TORCH_CHECK(n >= 0 && n < (int64_t(1) << 31) && ncols >= 0 &&
                  ncols < (int64_t(1) << 31),
              "bad operator size ", n, " x ", ncols);
  TORCH_CHECK(tiles.dim() == 2, "tiles must be [ntiles, 3]");
  const int64_t nt = tiles.size(0);
  TORCH_CHECK(nt <= n, "more tiles (", nt, ") than rows (", n, ")");
  check(tiles, "tiles", torch::kInt, {nt, 3});
  check(starts, "starts", torch::kLong, {nt + 1});
  TORCH_CHECK(cols.dim() == 1, "cols must be the sliced layout's vector");
  check(cols, "cols", torch::kInt, {cols.size(0)});
  check(vals, "vals", dt, {cols.size(0)});
  TORCH_CHECK((mode != 2 && mode != 3) || ncols == n, "mode ", mode,
              " needs a square operator");
  TORCH_CHECK(mode == 3 ? !x : bool(x), "mode ", mode,
              mode == 3 ? " takes no x" : " needs x");
  TORCH_CHECK(mode == 0 || b, "mode ", mode, " needs b");
  TORCH_CHECK((mode != 2 && mode != 3) || om_dinv, "mode ", mode,
              " needs om_dinv");
  if (x) check(*x, "x", dt, {ncols});
  if (b) check(*b, "b", dt, {n});
  if (om_dinv) check(*om_dinv, "om_dinv", dt, {n});
  const c10::cuda::CUDAGuard guard(vals.device());
  auto y = torch::empty({n}, vals.options());
  auto stream = c10::cuda::getCurrentCUDAStream().stream();
  const auto* s =
      reinterpret_cast<const long long*>(starts.data_ptr<int64_t>());
  cudaError_t err;
  if (dt == torch::kFloat) {
    using T = float;
    err = tigar::ell_spmv_launch<T>(
        (int)n, (int)nt, tiles.data_ptr<int>(), s, cols.data_ptr<int>(),
        ptr<T>(vals), x ? ptr<T>(*x) : nullptr, b ? ptr<T>(*b) : nullptr,
        om_dinv ? ptr<T>(*om_dinv) : nullptr, (int)mode, y.data_ptr<T>(),
        stream);
  } else {
    using T = double;
    err = tigar::ell_spmv_launch<T>(
        (int)n, (int)nt, tiles.data_ptr<int>(), s, cols.data_ptr<int>(),
        ptr<T>(vals), x ? ptr<T>(*x) : nullptr, b ? ptr<T>(*b) : nullptr,
        om_dinv ? ptr<T>(*om_dinv) : nullptr, (int)mode, y.data_ptr<T>(),
        stream);
  }
  check_launch(err, "ell_spmv");
  return y;
}

torch::Tensor laplace_apply(torch::Tensor Ke, torch::Tensor connT,
                            torch::Tensor mask, torch::Tensor W) {
  TORCH_CHECK(connT.dim() == 2 && Ke.dim() == 2 && W.dim() == 1,
              "connT [nen, nel], Ke [nen (nen + 1) / 2, nel], W a vector");
  const int64_t nen = connT.size(0), nel = connT.size(1), ndof = W.size(0);
  TORCH_CHECK(nen == 4 || nen == 8 || nen == 9 || nen == 16 || nen == 27 ||
                  nen == 64,
              "K12 takes nen in {4, 8, 9, 16, 27, 64}, got ", nen);
  const int64_t np = nen * (nen + 1) / 2;
  TORCH_CHECK(nel < (int64_t(1) << 31) && ndof < (int64_t(1) << 31),
              "K12 shape too large: nel ", nel, ", ndof ", ndof);
  check(Ke, "Ke", torch::kFloat, {np, nel});
  check(connT, "connT", torch::kInt, {nen, nel});
  check(mask, "mask", torch::kFloat, {ndof});
  check(W, "W", torch::kFloat, {ndof});
  const c10::cuda::CUDAGuard guard(W.device());
  auto r = torch::empty_like(W);
  auto stream = c10::cuda::getCurrentCUDAStream().stream();
  const cudaError_t err = tigar::laplace_apply_launch(
      (int)nel, (int)nen, (int)ndof, Ke.data_ptr<float>(),
      connT.data_ptr<int>(), mask.data_ptr<float>(), W.data_ptr<float>(),
      r.data_ptr<float>(), stream);
  check_launch(err, "laplace_apply");
  return r;
}

// K13 / K14 over the bool pair mask held with a padded row stride
torch::Tensor contact_pairs(const torch::Tensor& mask, const torch::Tensor& x,
                            const std::optional<torch::Tensor>& v,
                            const torch::Tensor& w, double k, double r_max,
                            const char* name) {
  const auto dt = x.scalar_type();
  check_float(dt);
  TORCH_CHECK(x.dim() == 2 && x.size(1) == 3, name, ": x must be [n, 3]");
  const int64_t n = x.size(0);
  TORCH_CHECK(n < (int64_t(1) << 31), name, ": too many points");
  check(x, "x", dt, {n, 3});
  check(w, "w", dt, {n});
  if (v) check(*v, "v", dt, {n, 3});
  TORCH_CHECK(mask.is_cuda() && mask.scalar_type() == torch::kBool,
              name, ": the pair mask must be a bool CUDA tensor");
  TORCH_CHECK(mask.dim() == 2 && mask.size(0) == n && mask.size(1) == n,
              name, ": the pair mask must be [n, n]");
  const int64_t ld = mask.stride(0);
  TORCH_CHECK(mask.stride(1) == 1 && ld >= n && ld % 16 == 0 &&
                  mask.storage_offset() == 0 &&
                  reinterpret_cast<uintptr_t>(mask.data_ptr()) % 16 == 0 &&
                  mask.storage().nbytes() >= (size_t)(n * ld),
              name, ": the pair mask must be the [n, n] view of a zero-"
              "padded [n, ld] bool buffer with ld a multiple of 16");
  TORCH_CHECK(mask.device() == x.device() && w.device() == x.device() &&
                  (!v || v->device() == x.device()),
              name, ": tensors on different devices");
  const c10::cuda::CUDAGuard guard(x.device());
  auto out = torch::empty_like(x);
  auto stream = c10::cuda::getCurrentCUDAStream().stream();
  const auto* mp = static_cast<const unsigned char*>(mask.data_ptr());
  cudaError_t err;
  if (dt == torch::kFloat) {
    using T = float;
    err = tigar::contact_pairs_launch<T>((int)n, ld, mp, ptr<T>(x),
                                         v ? ptr<T>(*v) : nullptr, ptr<T>(w),
                                         k, r_max, out.data_ptr<T>(), stream);
  } else {
    using T = double;
    err = tigar::contact_pairs_launch<T>((int)n, ld, mp, ptr<T>(x),
                                         v ? ptr<T>(*v) : nullptr, ptr<T>(w),
                                         k, r_max, out.data_ptr<T>(), stream);
  }
  check_launch(err, name);
  return out;
}

torch::Tensor contact_residual(torch::Tensor mask, torch::Tensor x,
                               torch::Tensor w, double k, double r_max) {
  return contact_pairs(mask, x, std::nullopt, w, k, r_max,
                       "contact_residual");
}

torch::Tensor contact_tangent(torch::Tensor mask, torch::Tensor x,
                              torch::Tensor v, torch::Tensor w, double k,
                              double r_max) {
  return contact_pairs(mask, x, v, w, k, r_max, "contact_tangent");
}

torch::Tensor stencil_apply(torch::Tensor S, torch::Tensor x,
                            std::optional<torch::Tensor> mask,
                            std::optional<torch::Tensor> b,
                            std::optional<torch::Tensor> dinv, double omega,
                            int64_t mode, std::optional<torch::Tensor> out,
                            int64_t base, int64_t fstride) {
  const auto dt = x.scalar_type();
  check_float(dt);
  TORCH_CHECK(S.dim() == 6, "S must be [3, 3, 5, 5, ny, nx]");
  const int64_t ny = S.size(4), nx = S.size(5), n = ny * nx;
  check(S, "S", dt, {3, 3, 5, 5, ny, nx});
  // every vector holds DoF (f, i) of the grid at base + f * fstride + i
  TORCH_CHECK(x.dim() == 1, "x must be a vector");
  const int64_t len = x.size(0);
  TORCH_CHECK(base >= 0 && fstride >= n && base + 2 * fstride + n <= len,
              "patch (base ", base, ", field stride ", fstride, ") of ", n,
              " points does not fit ", len, " DoFs");
  TORCH_CHECK(out || (base == 0 && fstride == n && len == 3 * n),
              "without out, x must be exactly the stencil's 3 fields");
  TORCH_CHECK(len < (int64_t(1) << 31), "too many DoFs");
  check(x, "x", dt, {len});
  if (mask) check(*mask, "mask", dt, {len});
  if (b) check(*b, "b", dt, {len});
  if (dinv) check(*dinv, "dinv", dt, {len});
  if (out) check(*out, "out", dt, {len});
  TORCH_CHECK(mode >= 0 && mode <= 2, "mode must be 0, 1 or 2");
  TORCH_CHECK(mode == 0 || b, "mode ", mode, " needs b");
  TORCH_CHECK(mode != 2 || dinv, "mode 2 needs dinv");
  const c10::cuda::CUDAGuard guard(x.device());
  auto y = out ? *out : torch::empty_like(x);
  auto stream = c10::cuda::getCurrentCUDAStream().stream();
  cudaError_t err;
  if (dt == torch::kFloat) {
    using T = float;
    err = tigar::stencil_apply_launch<T>(
        ny, nx, ptr<T>(S), ptr<T>(x), mask ? ptr<T>(*mask) : nullptr,
        b ? ptr<T>(*b) : nullptr, dinv ? ptr<T>(*dinv) : nullptr, omega,
        (int)mode, (int)base, (int)fstride, y.data_ptr<T>(), stream);
  } else {
    using T = double;
    err = tigar::stencil_apply_launch<T>(
        ny, nx, ptr<T>(S), ptr<T>(x), mask ? ptr<T>(*mask) : nullptr,
        b ? ptr<T>(*b) : nullptr, dinv ? ptr<T>(*dinv) : nullptr, omega,
        (int)mode, (int)base, (int)fstride, y.data_ptr<T>(), stream);
  }
  check_launch(err, "stencil_apply");
  return y;
}

namespace {

template <typename T>
cudaError_t run_sumfac(const torch::Tensor& W,
                       const std::vector<torch::Tensor>& B,
                       const std::vector<torch::Tensor>& D,
                       const std::vector<torch::Tensor>& starts,
                       const std::vector<torch::Tensor>& w,
                       const std::optional<torch::Tensor>& G,
                       const std::optional<torch::Tensor>& Gm,
                       const std::optional<torch::Tensor>& mask,
                       const std::vector<int64_t>& ncp, double ck, double cm,
                       torch::Tensor& r) {
  tigar::SumfacArgs<T> a{};
  a.dim = (int)ncp.size();
  a.nq = (int)B[0].size(1);
  a.p1 = (int)B[0].size(2);
  for (int d = 0; d < a.dim; ++d) {
    a.nel[d] = (int)B[d].size(0);
    a.ncp[d] = (int)ncp[d];
    a.B[d] = ptr<T>(B[d]);
    a.D[d] = ptr<T>(D[d]);
    a.starts[d] = starts[d].data_ptr<int>();
    a.w[d] = w.empty() ? nullptr : ptr<T>(w[d]);
  }
  a.G = G ? ptr<T>(*G) : nullptr;
  a.Gm = Gm ? ptr<T>(*Gm) : nullptr;
  a.W = ptr<T>(W);
  a.mask = mask ? ptr<T>(*mask) : nullptr;
  a.ck = T(ck);
  a.cm = T(cm);
  a.r = r.data_ptr<T>();
  return tigar::sumfac_apply_launch<T>(
      a, c10::cuda::getCurrentCUDAStream().stream());
}

}  // namespace

torch::Tensor sumfac_apply(torch::Tensor W, std::vector<torch::Tensor> B,
                           std::vector<torch::Tensor> D,
                           std::vector<torch::Tensor> starts,
                           std::vector<torch::Tensor> w,
                           std::optional<torch::Tensor> G,
                           std::optional<torch::Tensor> Gm,
                           std::optional<torch::Tensor> mask,
                           std::vector<int64_t> ncp, double ck, double cm) {
  const auto dt = W.scalar_type();
  check_float(dt);
  const int64_t dim = (int64_t)ncp.size();
  TORCH_CHECK(dim == 2 || dim == 3, "sumfac_apply is 2D or 3D, got ", dim);
  TORCH_CHECK((int64_t)B.size() == dim && (int64_t)D.size() == dim &&
                  (int64_t)starts.size() == dim,
              "sumfac_apply needs B, D and starts per direction");
  TORCH_CHECK(B[0].dim() == 3, "B must be [nel_d, nq, p + 1]");
  const int64_t nq = B[0].size(1), p1 = B[0].size(2);
  TORCH_CHECK(p1 >= 2 && p1 <= 4 && (nq == p1 || nq == p1 + 1),
              "sumfac_apply takes p in 1..3 and nq in {p + 1, p + 2}, got p ",
              p1 - 1, ", nq ", nq);
  int64_t nel = 1, ndof = 1, npt = 1;
  for (int64_t d = 0; d < dim; ++d) {
    const int64_t nel_d = B[d].size(0);
    check(B[d], "B", dt, {nel_d, nq, p1});
    check(D[d], "D", dt, {nel_d, nq, p1});
    check(starts[d], "starts", torch::kInt, {nel_d});
    TORCH_CHECK(ncp[d] >= p1, "direction ", d, " has ", ncp[d],
                " functions, fewer than p + 1");
    nel *= nel_d;
    ndof *= ncp[d];
    npt *= nq;
  }
  check(W, "W", dt, {ndof});
  if (mask) check(*mask, "mask", dt, {ndof});
  if (G) {
    TORCH_CHECK(Gm && w.empty(), "a metric G comes with Gm and no 1D weights");
    check(*G, "G", dt, {nel, npt, dim, dim});
    check(*Gm, "Gm", dt, {nel, npt});
  } else {
    TORCH_CHECK(!Gm && (int64_t)w.size() == dim,
                "identity geometry needs the 1D weights per direction");
    for (int64_t d = 0; d < dim; ++d)
      check(w[d], "w", dt, {B[d].size(0), nq});
  }
  TORCH_CHECK(ndof < (int64_t(1) << 31) && nel < (int64_t(1) << 31),
              "too many elements or DoFs");
  const c10::cuda::CUDAGuard guard(W.device());
  auto r = torch::empty({ndof}, W.options());
  cudaError_t err;
  if (dt == torch::kFloat)
    err = run_sumfac<float>(W, B, D, starts, w, G, Gm, mask, ncp, ck, cm, r);
  else
    err = run_sumfac<double>(W, B, D, starts, w, G, Gm, mask, ncp, ck, cm,
                             r);
  check_launch(err, "sumfac_apply");
  return r;
}

void iface_block(torch::Tensor B, torch::Tensor idx,
                 std::optional<torch::Tensor> mask, torch::Tensor v,
                 double alpha, torch::Tensor out) {
  const auto dt = v.scalar_type();
  check_float(dt);
  TORCH_CHECK(B.dim() == 2 && B.size(0) == B.size(1),
              "B must be a square [m, m] block");
  const int64_t m = B.size(0), n = v.size(0);
  TORCH_CHECK(v.dim() == 1 && n < (int64_t(1) << 31), "v must be a vector");
  check(B, "B", dt, {m, m});
  check(idx, "idx", torch::kInt, {m});
  check(v, "v", dt, {n});
  check(out, "out", dt, {n});
  if (mask) check(*mask, "mask", dt, {n});
  TORCH_CHECK(out.data_ptr() != v.data_ptr(), "out must not alias v");
  TORCH_CHECK(alpha == 1.0 || alpha == -1.0, "alpha must be +1 or -1");
  const size_t smem = dt == torch::kFloat
                          ? tigar::iface_block_smem<float>(m, mask.has_value())
                          : tigar::iface_block_smem<double>(m, mask.has_value());
  TORCH_CHECK(smem <= 227 * 1024, "an interface block of ", m,
              " DoFs exceeds shared memory (", smem, " bytes)");
  const c10::cuda::CUDAGuard guard(v.device());
  auto stream = c10::cuda::getCurrentCUDAStream().stream();
  cudaError_t err;
  if (dt == torch::kFloat) {
    using T = float;
    err = tigar::iface_block_launch<T>(
        (int)m, ptr<T>(B), idx.data_ptr<int>(), mask ? ptr<T>(*mask) : nullptr,
        ptr<T>(v), alpha, out.data_ptr<T>(), stream);
  } else {
    using T = double;
    err = tigar::iface_block_launch<T>(
        (int)m, ptr<T>(B), idx.data_ptr<int>(), mask ? ptr<T>(*mask) : nullptr,
        ptr<T>(v), alpha, out.data_ptr<T>(), stream);
  }
  check_launch(err, "iface_block");
}

namespace {

// one interface side's tensors, checked: conn [nq, 3, 9] int32, R0
// [nq, 3, 9], R1 [nq, 3, 9, 2], DF [nq, 3, 2]
template <typename T>
tigar::IfaceSide<T> iface_side(const std::vector<torch::Tensor>& s,
                               torch::ScalarType dt, int64_t nq) {
  TORCH_CHECK(s.size() == 4, "a side is (conn, R0, R1, DF)");
  check(s[0], "conn", torch::kInt, {nq, 3, 9});
  check(s[1], "R0", dt, {nq, 3, 9});
  check(s[2], "R1", dt, {nq, 3, 9, 2});
  check(s[3], "DF", dt, {nq, 3, 2});
  return {s[0].data_ptr<int>(), ptr<T>(s[1]), ptr<T>(s[2]), ptr<T>(s[3])};
}

}  // namespace

torch::Tensor shell_iface_residual(std::vector<torch::Tensor> side_a,
                                   std::vector<torch::Tensor> side_b,
                                   torch::Tensor wq, torch::Tensor U,
                                   std::vector<double> consts) {
  const auto dt = U.scalar_type();
  check_float(dt);
  TORCH_CHECK(wq.dim() == 1 && U.dim() == 1, "wq and U must be vectors");
  const int64_t nq = wq.size(0), ndof = U.size(0);
  check(wq, "wq", dt, {nq});
  check(U, "U", dt, {ndof});
  TORCH_CHECK(consts.size() == 3, "shell_iface_residual takes 3 constants");
  TORCH_CHECK(ndof < (int64_t(1) << 31), "too many DoFs");
  const c10::cuda::CUDAGuard guard(U.device());
  auto r = torch::zeros({ndof}, U.options());
  auto stream = c10::cuda::getCurrentCUDAStream().stream();
  cudaError_t err;
  if (dt == torch::kFloat) {
    using T = float;
    err = tigar::shell_iface_residual_launch<T>(
        (int)nq, iface_side<T>(side_a, dt, nq), iface_side<T>(side_b, dt, nq),
        ptr<T>(wq), ptr<T>(U), consts.data(), r.data_ptr<T>(), stream);
  } else {
    using T = double;
    err = tigar::shell_iface_residual_launch<T>(
        (int)nq, iface_side<T>(side_a, dt, nq), iface_side<T>(side_b, dt, nq),
        ptr<T>(wq), ptr<T>(U), consts.data(), r.data_ptr<T>(), stream);
  }
  check_launch(err, "shell_iface_residual");
  return r;
}

torch::Tensor shell_iface_tangent(std::vector<torch::Tensor> side_a,
                                  std::vector<torch::Tensor> side_b,
                                  torch::Tensor pos_a, torch::Tensor pos_b,
                                  torch::Tensor wq, torch::Tensor u_sub,
                                  std::vector<double> consts) {
  const auto dt = u_sub.scalar_type();
  check_float(dt);
  TORCH_CHECK(wq.dim() == 1 && u_sub.dim() == 1, "wq and u_sub must be "
              "vectors");
  const int64_t nq = wq.size(0), m = u_sub.size(0);
  check(wq, "wq", dt, {nq});
  check(u_sub, "u_sub", dt, {m});
  check(pos_a, "pos_a", torch::kInt, {nq, 3, 9});
  check(pos_b, "pos_b", torch::kInt, {nq, 3, 9});
  TORCH_CHECK(consts.size() == 3, "shell_iface_tangent takes 3 constants");
  TORCH_CHECK(m < (int64_t(1) << 31), "support too large");
  const c10::cuda::CUDAGuard guard(u_sub.device());
  auto K = torch::zeros({m, m}, u_sub.options());
  auto stream = c10::cuda::getCurrentCUDAStream().stream();
  cudaError_t err;
  if (dt == torch::kFloat) {
    using T = float;
    err = tigar::shell_iface_tangent_launch<T>(
        (int)nq, (int)m, iface_side<T>(side_a, dt, nq),
        iface_side<T>(side_b, dt, nq), pos_a.data_ptr<int>(),
        pos_b.data_ptr<int>(), ptr<T>(wq), ptr<T>(u_sub), consts.data(),
        K.data_ptr<T>(), stream);
  } else {
    using T = double;
    err = tigar::shell_iface_tangent_launch<T>(
        (int)nq, (int)m, iface_side<T>(side_a, dt, nq),
        iface_side<T>(side_b, dt, nq), pos_a.data_ptr<int>(),
        pos_b.data_ptr<int>(), ptr<T>(wq), ptr<T>(u_sub), consts.data(),
        K.data_ptr<T>(), stream);
  }
  check_launch(err, "shell_iface_tangent");
  return K;
}

namespace {

// one Nitsche interface side's tensors, checked: conn [nq, 3, 9] int32,
// R0 [nq, 3, 9], R1 [.., 2], R2 [.., 2, 2], R3 [.., 2, 2, 2], DF
// [nq, 3, 2], d2F [nq, 3, 2, 2], d3F [nq, 3, 2, 2, 2], pinv [nq, 2, 3],
// nu [nq, 2]; cols is conn, or pos (the support positions) when given
template <typename T>
tigar::NitscheSide<T> nitsche_side(const std::vector<torch::Tensor>& s,
                                   torch::ScalarType dt, int64_t nq,
                                   const torch::Tensor* pos) {
  TORCH_CHECK(s.size() == 10, "a Nitsche side is (conn, R0, R1, R2, R3, DF, "
              "d2F, d3F, pinv, nu)");
  check(s[0], "conn", torch::kInt, {nq, 3, 9});
  check(s[1], "R0", dt, {nq, 3, 9});
  check(s[2], "R1", dt, {nq, 3, 9, 2});
  check(s[3], "R2", dt, {nq, 3, 9, 2, 2});
  check(s[4], "R3", dt, {nq, 3, 9, 2, 2, 2});
  check(s[5], "DF", dt, {nq, 3, 2});
  check(s[6], "d2F", dt, {nq, 3, 2, 2});
  check(s[7], "d3F", dt, {nq, 3, 2, 2, 2});
  check(s[8], "pinv", dt, {nq, 2, 3});
  check(s[9], "nu", dt, {nq, 2});
  if (pos) check(*pos, "pos", torch::kInt, {nq, 3, 9});
  return {(pos ? *pos : s[0]).data_ptr<int>(), ptr<T>(s[1]), ptr<T>(s[2]),
          ptr<T>(s[3]), ptr<T>(s[4]), ptr<T>(s[5]), ptr<T>(s[6]),
          ptr<T>(s[7]), ptr<T>(s[8]), ptr<T>(s[9])};
}

}  // namespace

torch::Tensor nitsche_iface_residual(std::vector<torch::Tensor> side_a,
                                     std::vector<torch::Tensor> side_b,
                                     torch::Tensor wq, torch::Tensor surfJ,
                                     torch::Tensor U,
                                     std::vector<double> consts) {
  const auto dt = U.scalar_type();
  check_float(dt);
  TORCH_CHECK(wq.dim() == 1 && U.dim() == 1, "wq and U must be vectors");
  const int64_t nq = wq.size(0), ndof = U.size(0);
  check(wq, "wq", dt, {nq});
  check(surfJ, "surfJ", dt, {nq});
  check(U, "U", dt, {ndof});
  TORCH_CHECK(consts.size() == 8, "nitsche_iface_residual takes 8 "
              "constants");
  TORCH_CHECK(ndof < (int64_t(1) << 31), "too many DoFs");
  const c10::cuda::CUDAGuard guard(U.device());
  auto r = torch::zeros({ndof}, U.options());
  auto stream = c10::cuda::getCurrentCUDAStream().stream();
  cudaError_t err;
  if (dt == torch::kFloat) {
    using T = float;
    err = tigar::nitsche_iface_residual_launch<T>(
        (int)nq, nitsche_side<T>(side_a, dt, nq, nullptr),
        nitsche_side<T>(side_b, dt, nq, nullptr), ptr<T>(wq), ptr<T>(surfJ),
        ptr<T>(U), consts.data(), r.data_ptr<T>(), stream);
  } else {
    using T = double;
    err = tigar::nitsche_iface_residual_launch<T>(
        (int)nq, nitsche_side<T>(side_a, dt, nq, nullptr),
        nitsche_side<T>(side_b, dt, nq, nullptr), ptr<T>(wq), ptr<T>(surfJ),
        ptr<T>(U), consts.data(), r.data_ptr<T>(), stream);
  }
  check_launch(err, "nitsche_iface_residual");
  return r;
}

torch::Tensor nitsche_iface_tangent(std::vector<torch::Tensor> side_a,
                                    std::vector<torch::Tensor> side_b,
                                    torch::Tensor pos_a, torch::Tensor pos_b,
                                    torch::Tensor wq, torch::Tensor surfJ,
                                    torch::Tensor u_sub,
                                    std::vector<double> consts) {
  const auto dt = u_sub.scalar_type();
  check_float(dt);
  TORCH_CHECK(wq.dim() == 1 && u_sub.dim() == 1, "wq and u_sub must be "
              "vectors");
  const int64_t nq = wq.size(0), m = u_sub.size(0);
  check(wq, "wq", dt, {nq});
  check(surfJ, "surfJ", dt, {nq});
  check(u_sub, "u_sub", dt, {m});
  TORCH_CHECK(consts.size() == 8, "nitsche_iface_tangent takes 8 constants");
  TORCH_CHECK(m < (int64_t(1) << 31), "support too large");
  const c10::cuda::CUDAGuard guard(u_sub.device());
  auto K = torch::zeros({m, m}, u_sub.options());
  auto stream = c10::cuda::getCurrentCUDAStream().stream();
  cudaError_t err;
  if (dt == torch::kFloat) {
    using T = float;
    err = tigar::nitsche_iface_tangent_launch<T>(
        (int)nq, (int)m, nitsche_side<T>(side_a, dt, nq, &pos_a),
        nitsche_side<T>(side_b, dt, nq, &pos_b), ptr<T>(wq), ptr<T>(surfJ),
        ptr<T>(u_sub), consts.data(), K.data_ptr<T>(), stream);
  } else {
    using T = double;
    err = tigar::nitsche_iface_tangent_launch<T>(
        (int)nq, (int)m, nitsche_side<T>(side_a, dt, nq, &pos_a),
        nitsche_side<T>(side_b, dt, nq, &pos_b), ptr<T>(wq), ptr<T>(surfJ),
        ptr<T>(u_sub), consts.data(), K.data_ptr<T>(), stream);
  }
  check_launch(err, "nitsche_iface_tangent");
  return K;
}

namespace {

// K15/K16's plan and column layout, checked: tabs [nel_d, nq, nders + 1,
// pp_d] (dt), win [nel_d, pp_d] int32 for gather directions (an empty
// tensor marks a slide direction: start/stride); returns the argument
// struct with everything but the output columns filled in
template <typename T>
tigar::SumfacJetsArgs<T> jets_plan(const std::vector<torch::Tensor>& tabs,
                                   const std::vector<torch::Tensor>& win,
                                   bool inverse,
                                   const std::vector<int64_t>& starts,
                                   const std::vector<int64_t>& strides,
                                   const std::vector<int64_t>& ncp,
                                   int64_t nders, torch::ScalarType dt) {
  const int64_t dim = (int64_t)tabs.size();
  TORCH_CHECK(dim == 2 || dim == 3, "sum-factorized jets are 2D or 3D, got ",
              dim, " tables");
  TORCH_CHECK((int64_t)win.size() == dim && (int64_t)starts.size() == dim &&
                  (int64_t)strides.size() == dim &&
                  (int64_t)ncp.size() == dim,
              "windows, starts, strides and ncp are needed per direction");
  TORCH_CHECK(nders == 1 || nders == 2, "nders must be 1 or 2, got ", nders);
  TORCH_CHECK(tabs[0].dim() == 4, "tables must be [nel, nq, nders + 1, pp]");
  tigar::SumfacJetsArgs<T> a{};
  a.dim = (int)dim;
  a.nders = (int)nders;
  a.nq = (int)tabs[0].size(1);
  TORCH_CHECK(a.nq >= 1 && a.nq <= 16, "nq must be in 1..16, got ", a.nq);
  int64_t npts = 1;
  for (int64_t d = 0; d < 3; ++d) {
    if (d >= dim) {
      a.nel[d] = a.pp[d] = a.ncp[d] = a.stride[d] = 1;
      continue;
    }
    TORCH_CHECK(tabs[d].dim() == 4, "tables must be [nel, nq, nders + 1, pp]");
    const int64_t nel = tabs[d].size(0), pp = tabs[d].size(3);
    TORCH_CHECK(pp >= 1 && pp <= 4, "degrees must be at most 3, got ",
                pp - 1);
    TORCH_CHECK(nel >= 1 && ncp[d] >= pp && ncp[d] < (int64_t(1) << 20),
                "bad direction ", d, ": nel ", nel, ", ncp ", ncp[d]);
    check(tabs[d], "table", dt, {nel, a.nq, nders + 1, pp});
    a.nel[d] = (int)nel;
    a.pp[d] = (int)pp;
    a.ncp[d] = (int)ncp[d];
    a.tab[d] = ptr<T>(tabs[d]);
    if (win[d].numel() == 0) {
      TORCH_CHECK(starts[d] >= 0 && strides[d] >= 1 &&
                      starts[d] + strides[d] * (nel - 1) + pp <= ncp[d],
                  "slide windows (start ", starts[d], ", stride ",
                  strides[d], ") leave the ", ncp[d], " coefficients");
      a.start[d] = (int)starts[d];
      a.stride[d] = (int)strides[d];
    } else if (inverse) {
      check(win[d], "inverse windows", torch::kInt,
            {ncp[d] + 1 + nel * pp});
      a.inv[d] = win[d].data_ptr<int>();
      a.stride[d] = 1;
    } else {
      check(win[d], "windows", torch::kInt, {nel, pp});
      a.idx[d] = win[d].data_ptr<int>();
      a.stride[d] = 1;
    }
    npts *= nel * a.nq;
  }
  TORCH_CHECK(npts < (int64_t(1) << 40), "too many points");
  a.npts = npts;
  return a;
}

// the coefficient columns: ncols columns at base + c col_stride + i
// cp_stride inside a vector of n entries
template <typename T>
void jets_columns(tigar::SumfacJetsArgs<T>& a, int64_t n, int64_t base,
                  int64_t ncols, int64_t col_stride, int64_t cp_stride,
                  int64_t col0, int64_t M) {
  const int64_t ncp_tot = (int64_t)a.ncp[0] * a.ncp[1] * a.ncp[2];
  TORCH_CHECK(ncols >= 1 && col0 >= 0 && col0 + ncols <= M,
              "columns ", col0, "..", col0 + ncols, " do not fit ", M);
  TORCH_CHECK(base >= 0 && col_stride >= 0 && cp_stride >= 1 &&
                  base + (ncols - 1) * col_stride +
                          (ncp_tot - 1) * cp_stride < n,
              "coefficient columns (base ", base, ", strides ", col_stride,
              ", ", cp_stride, ") leave the vector of ", n, " entries");
  a.base = base;
  a.col_stride = col_stride;
  a.cp_stride = cp_stride;
  a.ncols = (int)ncols;
  a.col0 = (int)col0;
  a.M = (int)M;
}

}  // namespace

void sumfac_jets(torch::Tensor W, std::vector<torch::Tensor> tabs,
                 std::vector<torch::Tensor> win, std::vector<int64_t> starts,
                 std::vector<int64_t> strides, std::vector<int64_t> ncp,
                 int64_t nders, int64_t base, int64_t ncols,
                 int64_t col_stride, int64_t cp_stride, torch::Tensor val,
                 torch::Tensor g, std::optional<torch::Tensor> h,
                 int64_t col0) {
  const auto dt = W.scalar_type();
  check_float(dt);
  TORCH_CHECK(W.dim() == 1 && val.dim() == 2, "W must be a vector and val "
              "[npts, M]");
  check(W, "W", dt, {W.size(0)});
  const c10::cuda::CUDAGuard guard(W.device());
  auto stream = c10::cuda::getCurrentCUDAStream().stream();
  const int64_t M = val.size(1);
  cudaError_t err;
  if (dt == torch::kFloat) {
    using T = float;
    auto a = jets_plan<T>(tabs, win, false, starts, strides, ncp, nders, dt);
    jets_columns<T>(a, W.size(0), base, ncols, col_stride, cp_stride, col0,
                    M);
    check(val, "val", dt, {a.npts, M});
    check(g, "g", dt, {a.npts, M, a.dim});
    TORCH_CHECK(nders < 2 || h, "nders 2 needs h");
    if (nders >= 2) check(*h, "h", dt, {a.npts, M, a.dim, a.dim});
    err = tigar::sumfac_jets_launch<T>(a, ptr<T>(W), val.data_ptr<T>(),
                                       g.data_ptr<T>(),
                                       nders >= 2 ? h->data_ptr<T>() : nullptr,
                                       stream);
  } else {
    using T = double;
    auto a = jets_plan<T>(tabs, win, false, starts, strides, ncp, nders, dt);
    jets_columns<T>(a, W.size(0), base, ncols, col_stride, cp_stride, col0,
                    M);
    check(val, "val", dt, {a.npts, M});
    check(g, "g", dt, {a.npts, M, a.dim});
    TORCH_CHECK(nders < 2 || h, "nders 2 needs h");
    if (nders >= 2) check(*h, "h", dt, {a.npts, M, a.dim, a.dim});
    err = tigar::sumfac_jets_launch<T>(a, ptr<T>(W), val.data_ptr<T>(),
                                       g.data_ptr<T>(),
                                       nders >= 2 ? h->data_ptr<T>() : nullptr,
                                       stream);
  }
  check_launch(err, "sumfac_jets");
}

void sumfac_scatter_jets(torch::Tensor cval, torch::Tensor cg,
                         std::optional<torch::Tensor> ch,
                         std::vector<torch::Tensor> tabs,
                         std::vector<torch::Tensor> inv,
                         std::vector<int64_t> starts,
                         std::vector<int64_t> strides,
                         std::vector<int64_t> ncp, int64_t nders,
                         int64_t col0, int64_t ncols, int64_t col_stride,
                         int64_t cp_stride, torch::Tensor out,
                         int64_t base) {
  const auto dt = cval.scalar_type();
  check_float(dt);
  TORCH_CHECK(cval.dim() == 2 && out.dim() == 1, "cval must be [npts, M] "
              "and out a vector");
  check(out, "out", dt, {out.size(0)});
  const c10::cuda::CUDAGuard guard(out.device());
  auto stream = c10::cuda::getCurrentCUDAStream().stream();
  const int64_t M = cval.size(1);
  cudaError_t err;
  if (dt == torch::kFloat) {
    using T = float;
    auto a = jets_plan<T>(tabs, inv, true, starts, strides, ncp, nders, dt);
    jets_columns<T>(a, out.size(0), base, ncols, col_stride, cp_stride, col0,
                    M);
    check(cval, "cval", dt, {a.npts, M});
    check(cg, "cg", dt, {a.npts, M, a.dim});
    TORCH_CHECK(nders < 2 || ch, "nders 2 needs ch");
    if (nders >= 2) check(*ch, "ch", dt, {a.npts, M, a.dim, a.dim});
    auto local = torch::empty({tigar::sumfac_scatter_local_size(a)},
                              out.options());
    err = tigar::sumfac_scatter_jets_launch<T>(
        a, ptr<T>(cval), ptr<T>(cg), nders >= 2 ? ptr<T>(*ch) : nullptr,
        local.data_ptr<T>(), out.data_ptr<T>(), stream);
  } else {
    using T = double;
    auto a = jets_plan<T>(tabs, inv, true, starts, strides, ncp, nders, dt);
    jets_columns<T>(a, out.size(0), base, ncols, col_stride, cp_stride, col0,
                    M);
    check(cval, "cval", dt, {a.npts, M});
    check(cg, "cg", dt, {a.npts, M, a.dim});
    TORCH_CHECK(nders < 2 || ch, "nders 2 needs ch");
    if (nders >= 2) check(*ch, "ch", dt, {a.npts, M, a.dim, a.dim});
    auto local = torch::empty({tigar::sumfac_scatter_local_size(a)},
                              out.options());
    err = tigar::sumfac_scatter_jets_launch<T>(
        a, ptr<T>(cval), ptr<T>(cg), nders >= 2 ? ptr<T>(*ch) : nullptr,
        local.data_ptr<T>(), out.data_ptr<T>(), stream);
  }
  check_launch(err, "sumfac_scatter_jets");
}

// the per-thread stack (local memory) the context reserves now, bytes
int64_t stack_limit() {
  size_t v = 0;
  const cudaError_t err = cudaDeviceGetLimit(&v, cudaLimitStackSize);
  TORCH_CHECK(err == cudaSuccess, "cudaDeviceGetLimit: ",
              cudaGetErrorString(err));
  return (int64_t)v;
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("stack_limit", &stack_limit,
        "cudaDeviceGetLimit(cudaLimitStackSize): bytes of stack a thread");
  m.def("nitsche_iface_residual", &nitsche_iface_residual,
        "K8: consistent (Nitsche) SVK shell interface residual");
  m.def("nitsche_iface_tangent", &nitsche_iface_tangent,
        "K9: consistent (Nitsche) SVK shell interface tangent block");
  m.def("iface_block", &iface_block,
        "K5: dense interface block apply (in place on out)");
  m.def("shell_iface_residual", &shell_iface_residual,
        "K6: shell-penalty interface residual");
  m.def("shell_iface_tangent", &shell_iface_tangent,
        "K7: shell-penalty interface tangent block");
  m.def("sumfac_apply", &sumfac_apply,
        "K4: sum-factorized stiffness/mass apply");
  m.def("shell_residual", &shell_residual, "K1: SVK shell residual");
  m.def("tangent_stencil", &tangent_stencil,
        "K2: SVK shell tangent stencil");
  m.def("tangent_elements", &tangent_elements,
        "K2, element mode: masked SVK shell element matrices");
  m.def("elem_tangent_apply", &elem_tangent_apply,
        "K10: element-batch tangent apply, BC-masked");
  m.def("elem_tangent_diagonal", &elem_tangent_diagonal,
        "K10: element-batch tangent diagonal");
  m.def("ell_spmv", &ell_spmv,
        "K11: sliced ELL product / residual / Jacobi / add");
  m.def("laplace_apply", &laplace_apply,
        "K12: f32 scalar stiffness apply over explicit connectivity");
  m.attr("LAPLACE_WINDOW") = tigar::LAPLACE_WINDOW;
  m.def("contact_residual", &contact_residual,
        "K13: all-pairs penalty contact forces");
  m.def("contact_tangent", &contact_tangent,
        "K14: all-pairs penalty contact tangent action");
  m.def("sumfac_jets", &sumfac_jets,
        "K15: sum-factorized jets of coefficient columns");
  m.def("sumfac_scatter_jets", &sumfac_scatter_jets,
        "K16: transpose of K15 (jet cotangents to coefficients)");
  m.def("stencil_apply", &stencil_apply,
        "K3: stencil apply / residual / Jacobi sweep");
}
