// PyTorch binding of the port's kernels: the fused Krylov recurrences in
// cg_fused.cu, the flash-attention passes in flash_attention.cu, the
// split-K flash-decode kernels in flash_decode.cu and the SSD intra-chunk
// kernel in ssd_scan.cu.
//
// The only file that includes torch/extension.h (the kernels themselves are
// plain CUDA C, so nvcc compiles them quickly). Each function checks its
// tensors, allocates outputs and scratch, launches on the current stream and
// checks every launch (C10_CUDA_KERNEL_LAUNCH_CHECK() for the Krylov
// kernels; the flash, flash-decode and SSD launchers return
// cudaGetLastError(), raised here).

#include <torch/extension.h>

#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>

#include "flash_attention.h"
#include "flash_decode.h"
#include "ssd_scan.h"

extern "C" {
int cg_reduce_blocks(int64_t n);
int cg_dot2_scratch_floats();
void cg_dot2(const float* u, const float* v, int64_t n, float* scratch, float* out,
             cudaStream_t stream);
void cg_residual_dots_partial(const float* s, const float* As, const float* r0s,
                              const float* gamma, int64_t n, float* r, float* part,
                              int nb, cudaStream_t stream);
void cg_sum2_final(const float* part, int nb, float* out, cudaStream_t stream);
void cg_x_update(const float* x, const float* p, const float* s, const float* alpha,
                 const float* gamma, int64_t n, float* out, cudaStream_t stream);
int cg_gram_max_rows();
int cg_gram_blocks(int su, int sv, int64_t n);
void cg_dots_block_partial(const float* U, const float* V, int su, int sv, int64_t n,
                           float* part, int nb, cudaStream_t stream);
void cg_gram_final(const float* part, int nb, int entries, float* out,
                   cudaStream_t stream);
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

// dot2's scratch slots and counter for one device and stream, zeroed at
// first use and kept for the process: every dot2 leaves its counter at 0,
// and launches on one stream never overlap. Never freed (the map outlives
// the CUDA context's teardown at exit).
float* dot2_scratch(const at::Tensor& like, cudaStream_t stream) {
  static std::mutex mu;
  static auto* bufs = new std::map<std::pair<int, cudaStream_t>, at::Tensor>();
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair((int)like.get_device(), stream);
  auto it = bufs->find(key);
  if (it == bufs->end())
    it = bufs->emplace(key, at::zeros({cg_dot2_scratch_floats()}, like.options())).first;
  return it->second.data_ptr<float>();
}

at::Tensor sum2(const at::Tensor& part, int nb, cudaStream_t stream) {
  auto out = at::empty({2}, part.options());
  cg_sum2_final(part.data_ptr<float>(), nb, out.data_ptr<float>(), stream);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

}  // namespace

// (<u,v>, <v,v>) as a (2,) tensor, in one launch.
at::Tensor dot2(const at::Tensor& u, const at::Tensor& v) {
  check_len(u);
  check_vec(u, "u", u);
  check_vec(v, "v", u);
  c10::cuda::CUDAGuard guard(u.device());
  cudaStream_t stream = c10::cuda::getCurrentCUDAStream().stream();
  auto out = at::empty({2}, u.options());
  cg_dot2(u.data_ptr<float>(), v.data_ptr<float>(), u.size(0), dot2_scratch(u, stream),
          out.data_ptr<float>(), stream);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
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
  // out at x's offset mod 16 bytes (a view into n + 3 floats), so that the
  // kernel's 16-byte body covers out wherever x, p and s share an offset.
  const int64_t n = x.size(0);
  const int64_t off = (int64_t)((reinterpret_cast<uintptr_t>(x.data_ptr<float>()) & 15) / 4);
  auto out = at::empty({n + 3}, x.options()).narrow(0, off, n);
  cg_x_update(x.data_ptr<float>(), p.data_ptr<float>(), s.data_ptr<float>(),
              alpha.data_ptr<float>(), gamma.data_ptr<float>(), n, out.data_ptr<float>(),
              stream);
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

// The (su, sv) Gram matrix U V^T of two stacked (rows, n) f32 blocks.
at::Tensor dots_block(const at::Tensor& U, const at::Tensor& V) {
  for (const auto* t : {&U, &V}) {
    TORCH_CHECK(t->is_cuda(), "U and V must be CUDA tensors");
    TORCH_CHECK(t->scalar_type() == at::kFloat, "U and V must be float32");
    TORCH_CHECK(t->dim() == 2 && t->size(1) > 0, "U and V must be 2-D with n > 0 columns");
    TORCH_CHECK(t->is_contiguous(), "U and V must be contiguous");
    TORCH_CHECK(t->size(0) >= 1 && t->size(0) <= cg_gram_max_rows(),
                "U and V must have 1 to ", cg_gram_max_rows(), " rows, got ", t->size(0));
  }
  TORCH_CHECK(V.device() == U.device(), "V must be on ", U.device());
  TORCH_CHECK(V.size(1) == U.size(1), "U and V must have the same number of columns");
  c10::cuda::CUDAGuard guard(U.device());
  cudaStream_t stream = c10::cuda::getCurrentCUDAStream().stream();
  const int su = (int)U.size(0);
  const int sv = (int)V.size(0);
  const int64_t n = U.size(1);
  const int nb = cg_gram_blocks(su, sv, n);
  auto part = at::empty({(int64_t)nb * su * sv}, U.options());
  auto out = at::empty({su, sv}, U.options());
  cg_dots_block_partial(U.data_ptr<float>(), V.data_ptr<float>(), su, sv, n,
                        part.data_ptr<float>(), nb, stream);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  cg_gram_final(part.data_ptr<float>(), nb, su * sv, out.data_ptr<float>(), stream);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

// ------------------------------------------------------ flash attention --
namespace {

void check_attn(const at::Tensor& t, const char* name, const at::Tensor& q) {
  TORCH_CHECK(t.is_cuda() && t.device() == q.device(), name, " must be a CUDA tensor on ",
              q.device());
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
  TORCH_CHECK(t.dim() == 4 && t.size(3) == q.size(3), name, " must be 4-D with head dim ",
              q.size(3));
  TORCH_CHECK(t.scalar_type() == q.scalar_type(), name, " must have q's dtype");
}

void check_f32(const at::Tensor& t, const char* name, const at::Tensor& q,
               at::IntArrayRef shape) {
  TORCH_CHECK(t.is_cuda() && t.device() == q.device(), name, " must be a CUDA tensor on ",
              q.device());
  TORCH_CHECK(t.is_contiguous() && t.scalar_type() == at::kFloat, name,
              " must be contiguous float32");
  TORCH_CHECK(t.sizes() == shape, name, " must have shape ", shape);
}

// Arguments shared by every pass; ``bias`` is empty for none, ``window`` and
// ``valid_len`` negative for none.
FaArgs fa_args(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
               const at::Tensor& bias, bool causal, int64_t window, int64_t valid_len,
               double scale) {
  check_attn(q, "q", q);
  check_attn(k, "k", q);
  check_attn(v, "v", q);
  TORCH_CHECK(q.scalar_type() == at::kFloat || q.scalar_type() == at::kBFloat16,
              "q, k, v must be float32 or bfloat16");
  TORCH_CHECK(k.sizes() == v.sizes() && k.size(0) == q.size(0), "k and v must be (B, Sk, KV, hd)");
  TORCH_CHECK(q.size(2) % k.size(2) == 0, "heads must be a multiple of kv heads");
  FaArgs a{};
  a.q = q.data_ptr();
  a.k = k.data_ptr();
  a.v = v.data_ptr();
  a.B = (int)q.size(0);
  a.Sq = (int)q.size(1);
  a.H = (int)q.size(2);
  a.hd = (int)q.size(3);
  a.Sk = (int)k.size(1);
  a.KV = (int)k.size(2);
  a.dtype = q.scalar_type() == at::kFloat ? 0 : 1;
  a.scale = (float)scale;
  a.causal = causal ? 1 : 0;
  a.has_window = window >= 0 ? 1 : 0;
  a.window = (int)(window >= 0 ? window : 0);
  a.valid_len = (int)(valid_len >= 0 ? valid_len : -1);
  if (bias.numel() > 0) {
    TORCH_CHECK(bias.dim() == 3 && (bias.size(0) == 1 || bias.size(0) == q.size(0)),
                "bias must be (B|1, Sq, Sk)");
    check_f32(bias, "bias", q, {bias.size(0), q.size(1), k.size(1)});
    a.bias = bias.data_ptr<float>();
    a.bias_b = (int)bias.size(0);
  }
  return a;
}

void fa_check(int err, const char* what) {
  TORCH_CHECK(err == 0, what, ": launch failed: ", cudaGetErrorString((cudaError_t)err));
}

}  // namespace

// (o, lse) of the forward pass.
std::vector<at::Tensor> flash_fwd(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
                                  const at::Tensor& bias, bool causal, int64_t window,
                                  int64_t valid_len, double scale) {
  FaArgs a = fa_args(q, k, v, bias, causal, window, valid_len, scale);
  c10::cuda::CUDAGuard guard(q.device());
  auto o = at::empty_like(q);
  auto lse = at::empty({q.size(0), q.size(2), q.size(1)}, q.options().dtype(at::kFloat));
  a.o = o.data_ptr();
  a.lse_out = lse.data_ptr<float>();
  fa_check(fa_forward(&a, c10::cuda::getCurrentCUDAStream().stream()), "flash_attention_fwd");
  return {o, lse};
}

// dq of the backward pass (in q's dtype).
at::Tensor flash_dq(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
                    const at::Tensor& dout, const at::Tensor& lse, const at::Tensor& delta,
                    const at::Tensor& bias, bool causal, int64_t window, int64_t valid_len,
                    double scale) {
  FaArgs a = fa_args(q, k, v, bias, causal, window, valid_len, scale);
  check_attn(dout, "do", q);
  TORCH_CHECK(dout.sizes() == q.sizes(), "do must have q's shape");
  check_f32(lse, "lse", q, {q.size(0), q.size(2), q.size(1)});
  check_f32(delta, "delta", q, {q.size(0), q.size(2), q.size(1)});
  c10::cuda::CUDAGuard guard(q.device());
  auto dq = at::empty_like(q);
  a.dout = dout.data_ptr();
  a.lse = lse.data_ptr<float>();
  a.delta = delta.data_ptr<float>();
  a.o = dq.data_ptr();
  fa_check(fa_dq(&a, c10::cuda::getCurrentCUDAStream().stream()), "flash_attention_dq");
  return dq;
}

// Per-q-head (dk_h, dv_h), each (B, Sk, H, hd) float32.
std::vector<at::Tensor> flash_dkv(const at::Tensor& q, const at::Tensor& k,
                                  const at::Tensor& v, const at::Tensor& dout,
                                  const at::Tensor& lse, const at::Tensor& delta,
                                  const at::Tensor& bias, bool causal, int64_t window,
                                  int64_t valid_len, double scale) {
  FaArgs a = fa_args(q, k, v, bias, causal, window, valid_len, scale);
  check_attn(dout, "do", q);
  TORCH_CHECK(dout.sizes() == q.sizes(), "do must have q's shape");
  check_f32(lse, "lse", q, {q.size(0), q.size(2), q.size(1)});
  check_f32(delta, "delta", q, {q.size(0), q.size(2), q.size(1)});
  c10::cuda::CUDAGuard guard(q.device());
  auto opts = q.options().dtype(at::kFloat);
  auto dk = at::empty({q.size(0), k.size(1), q.size(2), q.size(3)}, opts);
  auto dv = at::empty({q.size(0), k.size(1), q.size(2), q.size(3)}, opts);
  a.dout = dout.data_ptr();
  a.lse = lse.data_ptr<float>();
  a.delta = delta.data_ptr<float>();
  a.dk = dk.data_ptr<float>();
  a.dv = dv.data_ptr<float>();
  fa_check(fa_dkv(&a, c10::cuda::getCurrentCUDAStream().stream()), "flash_attention_dkv");
  return {dk, dv};
}

// (g (B, Sq, H, hd), t (B, H, Sq)) of the tangent pass, both float32.
std::vector<at::Tensor> flash_jvp(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
                                  const at::Tensor& qt, const at::Tensor& kt,
                                  const at::Tensor& vt, const at::Tensor& lse,
                                  const at::Tensor& bias, bool causal, int64_t window,
                                  int64_t valid_len, double scale) {
  FaArgs a = fa_args(q, k, v, bias, causal, window, valid_len, scale);
  check_attn(qt, "qt", q);
  check_attn(kt, "kt", q);
  check_attn(vt, "vt", q);
  TORCH_CHECK(qt.sizes() == q.sizes() && kt.sizes() == k.sizes() && vt.sizes() == v.sizes(),
              "tangents must have their primals' shapes");
  check_f32(lse, "lse", q, {q.size(0), q.size(2), q.size(1)});
  c10::cuda::CUDAGuard guard(q.device());
  auto opts = q.options().dtype(at::kFloat);
  auto g = at::empty(q.sizes(), opts);
  auto t = at::empty({q.size(0), q.size(2), q.size(1)}, opts);
  a.qt = qt.data_ptr();
  a.kt = kt.data_ptr();
  a.vt = vt.data_ptr();
  a.lse = lse.data_ptr<float>();
  a.g = g.data_ptr<float>();
  a.t = t.data_ptr<float>();
  fa_check(fa_jvp(&a, c10::cuda::getCurrentCUDAStream().stream()), "flash_attention_jvp");
  return {g, t};
}

// --------------------------------------------------------- flash decode --
namespace {

void check_decode_q(const at::Tensor& q) {
  TORCH_CHECK(q.is_cuda() && q.is_contiguous() && q.dim() == 3,
              "q must be a contiguous (B, H, hd) CUDA tensor");
  TORCH_CHECK(q.scalar_type() == at::kFloat || q.scalar_type() == at::kBFloat16,
              "q must be float32 or bfloat16");
}

FdArgs fd_args(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
               const at::Tensor& bias, double scale) {
  check_decode_q(q);
  for (const auto* t : {&k, &v}) {
    TORCH_CHECK(t->is_cuda() && t->device() == q.device() && t->is_contiguous(),
                "k and v must be contiguous CUDA tensors on ", q.device());
    TORCH_CHECK(t->dim() == 4 && t->size(3) == q.size(2), "k and v must be 4-D with head dim ",
                q.size(2));
    TORCH_CHECK(t->scalar_type() == q.scalar_type(), "k and v must have q's dtype");
  }
  TORCH_CHECK(k.sizes() == v.sizes(), "k and v must have one shape");
  TORCH_CHECK(k.size(2) > 0 && q.size(1) % k.size(2) == 0,
              "heads must be a multiple of kv heads");
  TORCH_CHECK(bias.is_cuda() && bias.device() == q.device() && bias.is_contiguous() &&
                  bias.scalar_type() == at::kFloat && bias.dim() == 2,
              "bias must be a contiguous 2-D float32 CUDA tensor on ", q.device());
  FdArgs a{};
  a.q = q.data_ptr();
  a.k = k.data_ptr();
  a.v = v.data_ptr();
  a.bias = bias.data_ptr<float>();
  a.B = (int)q.size(0);
  a.H = (int)q.size(1);
  a.hd = (int)q.size(2);
  a.KV = (int)k.size(2);
  a.scale = (float)scale;
  a.dtype = q.scalar_type() == at::kFloat ? 0 : 1;
  return a;
}

// The merged outputs of both decode kernels: o (B, H, hd) in q's dtype, m
// and l (B, H) float32.
std::vector<at::Tensor> fd_outputs(FdArgs& a, const at::Tensor& q) {
  auto o = at::empty_like(q);
  auto opts = q.options().dtype(at::kFloat);
  auto m = at::empty({a.B, a.H}, opts);
  auto l = at::empty({a.B, a.H}, opts);
  a.o = o.data_ptr();
  a.m = m.data_ptr<float>();
  a.l = l.data_ptr<float>();
  return {o, m, l};
}

}  // namespace

// The merged (o (B, H, hd) in q's dtype, m (B, H), l (B, H)) of the dense
// split-K decode, in one launch: n_splits (1 to 8) splits of ``span`` keys
// each over the (B, W, KV, hd) cache, merged inside the kernel.
std::vector<at::Tensor> flash_decode(const at::Tensor& q, const at::Tensor& k,
                                     const at::Tensor& v, const at::Tensor& bias,
                                     int64_t n_splits, int64_t span, double scale) {
  FdArgs a = fd_args(q, k, v, bias, scale);
  TORCH_CHECK(k.size(0) == q.size(0), "k must be (B, W, KV, hd) with q's batch");
  const int64_t W = k.size(1);
  TORCH_CHECK(W > 0 && span > 0 && n_splits > 0 && n_splits * span >= W &&
                  (n_splits - 1) * span < W,
              "splits of ", span, " keys x ", n_splits, " do not cover W = ", W);
  TORCH_CHECK(n_splits <= 8, "the dense decode merges at most 8 splits, got ", n_splits);
  TORCH_CHECK((bias.size(0) == 1 || bias.size(0) == q.size(0)) && bias.size(1) == W,
              "bias must be (B|1, W)");
  a.W = (int)W;
  a.bias_b = (int)bias.size(0);
  a.ns = (int)n_splits;
  a.span = (int)span;
  c10::cuda::CUDAGuard guard(q.device());
  auto out = fd_outputs(a, q);
  fa_check(fd_dense(&a, c10::cuda::getCurrentCUDAStream().stream()), "flash_decode");
  return out;
}

// The merged (o (B, H, hd) in q's dtype, m (B, H), l (B, H)) of the paged
// decode over the (P, ps, KV, hd) pools, one page per split, in one launch:
// the pages' partials are merged inside the kernel.
std::vector<at::Tensor> flash_decode_paged(const at::Tensor& q, const at::Tensor& k_pool,
                                           const at::Tensor& v_pool,
                                           const at::Tensor& page_table,
                                           const at::Tensor& bias, double scale) {
  FdArgs a = fd_args(q, k_pool, v_pool, bias, scale);
  TORCH_CHECK(page_table.is_cuda() && page_table.device() == q.device() &&
                  page_table.is_contiguous() && page_table.scalar_type() == at::kInt &&
                  page_table.dim() == 2 && page_table.size(0) == q.size(0) &&
                  page_table.size(1) > 0,
              "page_table must be a contiguous (B, max_pages) int32 CUDA tensor");
  const int64_t ps = k_pool.size(1), maxp = page_table.size(1);
  TORCH_CHECK(k_pool.size(0) > 0 && ps > 0, "the pools must hold pages");
  TORCH_CHECK(bias.size(0) == q.size(0) && bias.size(1) == maxp * ps,
              "bias must be (B, max_pages * page_size)");
  a.page_table = page_table.data_ptr<int>();
  a.P = (int)k_pool.size(0);
  a.ns = (int)maxp;
  a.span = (int)ps;
  c10::cuda::CUDAGuard guard(q.device());
  auto out = fd_outputs(a, q);
  fa_check(fd_paged(&a, c10::cuda::getCurrentCUDAStream().stream()), "flash_decode_paged");
  return out;
}

// ------------------------------------------------------------ SSD scan --
// (y, S, g, l) of the SSD intra-chunk kernel: u (B, nc, H, Q, P) and log_a
// (B, nc, H, Q) float32, Bv and Cv (B, nc, Q, N) float32 or bfloat16.
std::vector<at::Tensor> ssd_intra_fwd(const at::Tensor& u, const at::Tensor& log_a,
                                      const at::Tensor& Bv, const at::Tensor& Cv) {
  TORCH_CHECK(u.is_cuda() && u.is_contiguous() && u.scalar_type() == at::kFloat && u.dim() == 5,
              "u must be a contiguous float32 (B, nc, H, Q, P) CUDA tensor");
  const int64_t B = u.size(0), nc = u.size(1), H = u.size(2), Q = u.size(3), P = u.size(4);
  TORCH_CHECK(log_a.is_cuda() && log_a.device() == u.device() && log_a.is_contiguous() &&
                  log_a.scalar_type() == at::kFloat && log_a.sizes() == u.sizes().slice(0, 4),
              "log_a must be a contiguous float32 (B, nc, H, Q) tensor on u's device");
  for (const auto* t : {&Bv, &Cv}) {
    TORCH_CHECK(t->is_cuda() && t->device() == u.device() && t->is_contiguous() &&
                    t->dim() == 4 && t->size(0) == B && t->size(1) == nc && t->size(2) == Q,
                "Bv and Cv must be contiguous (B, nc, Q, N) tensors on u's device");
    TORCH_CHECK(t->scalar_type() == Bv.scalar_type() &&
                    (t->scalar_type() == at::kFloat || t->scalar_type() == at::kBFloat16),
                "Bv and Cv must both be float32 or both bfloat16");
  }
  TORCH_CHECK(Cv.sizes() == Bv.sizes(), "Bv and Cv must have one shape");
  const int64_t N = Bv.size(3);
  c10::cuda::CUDAGuard guard(u.device());
  auto y = at::empty_like(u);
  auto S = at::empty({B, nc, H, N, P}, u.options());
  auto g = at::empty({B, nc, H}, u.options());
  auto l = at::empty({B, nc, H, Q}, u.options());
  SsdArgs a{};
  a.u = u.data_ptr<float>();
  a.log_a = log_a.data_ptr<float>();
  a.Bv = Bv.data_ptr();
  a.Cv = Cv.data_ptr();
  a.y = y.data_ptr<float>();
  a.S = S.data_ptr<float>();
  a.g = g.data_ptr<float>();
  a.l = l.data_ptr<float>();
  a.B = (int)B;
  a.nc = (int)nc;
  a.H = (int)H;
  a.Q = (int)Q;
  a.N = (int)N;
  a.P = (int)P;
  a.bc_dtype = Bv.scalar_type() == at::kFloat ? 0 : 1;
  fa_check(ssd_intra(&a, c10::cuda::getCurrentCUDAStream().stream()), "ssd_intra");
  return {y, S, g, l};
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("dot2", &dot2, "(<u,v>, <v,v>) of flat f32 CUDA vectors");
  m.def("x_update", &x_update, "x + alpha*p + gamma*s of flat f32 CUDA vectors");
  m.def("residual_dots", &residual_dots, "r = s - gamma*As with <r,r0s> and <r,r>");
  m.def("dots_block", &dots_block, "Gram matrix U V^T of two stacked f32 CUDA blocks");
  m.def("gram_max_rows", &cg_gram_max_rows, "most rows of U and of V dots_block takes");
  m.def("flash_fwd", &flash_fwd, "flash attention forward: (o, lse)");
  m.def("flash_dq", &flash_dq, "flash attention backward: dq");
  m.def("flash_dkv", &flash_dkv, "flash attention backward: per-q-head (dk, dv)");
  m.def("flash_jvp", &flash_jvp, "flash attention tangent pass: (g, t)");
  m.def("flash_decode", &flash_decode, "split-K flash decode, splits merged: (o, m, l)");
  m.def("flash_decode_paged", &flash_decode_paged, "paged flash decode, merged: (o, m, l)");
  m.def("ssd_intra", &ssd_intra_fwd, "SSD intra-chunk: (y, S, g, l)");
  m.def("ssd_intra_smem_bytes", &ssd_intra_smem_bytes,
        "dynamic shared memory of one ssd_intra block at (Q, N, P)");
}
