// PyTorch binding of the fused Krylov kernels in cg_fused.cu.
//
// The only file that includes torch/extension.h (the kernels themselves are
// plain CUDA C, so nvcc compiles them quickly). Each function checks its
// tensors, allocates outputs and scratch, launches on the current stream and
// checks every launch with C10_CUDA_KERNEL_LAUNCH_CHECK().

#include <torch/extension.h>

#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime.h>

extern "C" {
int cg_reduce_blocks(int64_t n);
void cg_dot2_partial(const float* u, const float* v, int64_t n, float* part, int nb,
                     cudaStream_t stream);
void cg_residual_dots_partial(const float* s, const float* As, const float* r0s,
                              const float* gamma, int64_t n, float* r, float* part,
                              int nb, cudaStream_t stream);
void cg_sum2_final(const float* part, int nb, float* out, cudaStream_t stream);
void cg_x_update(const float* x, const float* p, const float* s, const float* alpha,
                 const float* gamma, int64_t n, float* out, cudaStream_t stream);
}

namespace {

void check_vec(const at::Tensor& t, const char* name, const at::Tensor& like) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.device() == like.device(), name, " must be on ", like.device());
  TORCH_CHECK(t.scalar_type() == at::kFloat, name, " must be float32");
  TORCH_CHECK(t.dim() == 1 && t.size(0) == like.size(0), name,
              " must be 1-D of length ", like.size(0));
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
}

void check_scalar(const at::Tensor& t, const char* name, const at::Tensor& like) {
  TORCH_CHECK(t.is_cuda() && t.device() == like.device(), name,
              " must be a CUDA tensor on ", like.device());
  TORCH_CHECK(t.scalar_type() == at::kFloat, name, " must be float32");
  TORCH_CHECK(t.numel() == 1, name, " must hold one value");
}

void check_len(const at::Tensor& t) {
  TORCH_CHECK(t.dim() == 1 && t.size(0) > 0, "vectors must be 1-D and non-empty");
}

at::Tensor sum2(const at::Tensor& part, int nb, cudaStream_t stream) {
  auto out = at::empty({2}, part.options());
  cg_sum2_final(part.data_ptr<float>(), nb, out.data_ptr<float>(), stream);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

}  // namespace

// (<u,v>, <v,v>) as a (2,) tensor.
at::Tensor dot2(const at::Tensor& u, const at::Tensor& v) {
  check_len(u);
  check_vec(u, "u", u);
  check_vec(v, "v", u);
  c10::cuda::CUDAGuard guard(u.device());
  cudaStream_t stream = c10::cuda::getCurrentCUDAStream().stream();
  const int64_t n = u.size(0);
  const int nb = cg_reduce_blocks(n);
  auto part = at::empty({2 * nb}, u.options());
  cg_dot2_partial(u.data_ptr<float>(), v.data_ptr<float>(), n, part.data_ptr<float>(),
                  nb, stream);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return sum2(part, nb, stream);
}

// x + alpha*p + gamma*s.
at::Tensor x_update(const at::Tensor& x, const at::Tensor& p, const at::Tensor& s,
                    const at::Tensor& alpha, const at::Tensor& gamma) {
  check_len(x);
  check_vec(x, "x", x);
  check_vec(p, "p", x);
  check_vec(s, "s", x);
  check_scalar(alpha, "alpha", x);
  check_scalar(gamma, "gamma", x);
  c10::cuda::CUDAGuard guard(x.device());
  cudaStream_t stream = c10::cuda::getCurrentCUDAStream().stream();
  auto out = at::empty_like(x);
  cg_x_update(x.data_ptr<float>(), p.data_ptr<float>(), s.data_ptr<float>(),
              alpha.data_ptr<float>(), gamma.data_ptr<float>(), x.size(0),
              out.data_ptr<float>(), stream);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

// r = s - gamma*As; returns [r, (<r,r0s>, <r,r>) as a (2,) tensor].
std::vector<at::Tensor> residual_dots(const at::Tensor& s, const at::Tensor& As,
                                      const at::Tensor& r0s, const at::Tensor& gamma) {
  check_len(s);
  check_vec(s, "s", s);
  check_vec(As, "As", s);
  check_vec(r0s, "r0s", s);
  check_scalar(gamma, "gamma", s);
  c10::cuda::CUDAGuard guard(s.device());
  cudaStream_t stream = c10::cuda::getCurrentCUDAStream().stream();
  const int64_t n = s.size(0);
  const int nb = cg_reduce_blocks(n);
  auto r = at::empty_like(s);
  auto part = at::empty({2 * nb}, s.options());
  cg_residual_dots_partial(s.data_ptr<float>(), As.data_ptr<float>(), r0s.data_ptr<float>(),
                           gamma.data_ptr<float>(), n, r.data_ptr<float>(),
                           part.data_ptr<float>(), nb, stream);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return {r, sum2(part, nb, stream)};
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("dot2", &dot2, "(<u,v>, <v,v>) of flat f32 CUDA vectors");
  m.def("x_update", &x_update, "x + alpha*p + gamma*s of flat f32 CUDA vectors");
  m.def("residual_dots", &residual_dots, "r = s - gamma*As with <r,r0s> and <r,r>");
}
