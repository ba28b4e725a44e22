// Fused Krylov vector recurrences for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/cg_fused.py:
//   dot2_partial + sum2_final   <- _dot2_kernel / dot2            (<u,v>, <v,v>)
//   x_update                    <- _x_update_kernel / x_update    x + a*p + g*s
//   residual_dots_partial + sum2_final
//                               <- _residual_dots_kernel / residual_dots
//                                  r = s - g*As, <r,r0s>, <r,r>
//
// Bound on the card: bytes. Each is one streaming pass over flat f32 vectors
// (a few flops per 4-byte element, far below the H100's ~20 flop/byte
// balance for f32), so the only lever is to read each input once and write
// each output once: the axpy chain and the dots it feeds are fused into one
// pass. The TPU kernel zero-padded n up to its 64k block and carried one
// partial per block; here a grid-stride loop masks the ragged tail, and each
// thread block writes its partial sum to its own slot. sum2_final then adds
// the slots in a fixed order in one block. No float atomics: the result is
// the same from run to run, which the flat Krylov backend's parity needs.
//
// The scalars (alpha, gamma) are read from device memory, so the solver
// never copies them to the host. Kernels launch on the caller's stream and
// allocate nothing; the binding (cg_fused_bind.cpp) allocates outputs and
// scratch and checks every launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxReduceBlocks = 1024;
constexpr int kMaxElementwiseBlocks = 132 * 16;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sums v[0] and v[1] over the block in a fixed order; thread 0 holds the result.
__device__ __forceinline__ void block_sum2(float v[2]) {
  __shared__ float sh[2][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v[0] = warp_sum(v[0]);
  v[1] = warp_sum(v[1]);
  if (lane == 0) {
    sh[0][warp] = v[0];
    sh[1][warp] = v[1];
  }
  __syncthreads();
  if (warp == 0) {
    v[0] = lane < kWarps ? sh[0][lane] : 0.f;
    v[1] = lane < kWarps ? sh[1][lane] : 0.f;
    v[0] = warp_sum(v[0]);
    v[1] = warp_sum(v[1]);
  }
}

__global__ void __launch_bounds__(kThreads)
dot2_partial(const float* __restrict__ u, const float* __restrict__ v, int64_t n,
             float* __restrict__ part) {
  float acc[2] = {0.f, 0.f};
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const float a = u[i];
    const float b = v[i];
    acc[0] += a * b;
    acc[1] += b * b;
  }
  block_sum2(acc);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = acc[0];
    part[gridDim.x + blockIdx.x] = acc[1];
  }
}

__global__ void __launch_bounds__(kThreads)
residual_dots_partial(const float* __restrict__ s, const float* __restrict__ As,
                      const float* r0s, const float* __restrict__ gamma, int64_t n,
                      float* __restrict__ r, float* __restrict__ part) {
  const float g = *gamma;
  float acc[2] = {0.f, 0.f};
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const float ri = s[i] - g * As[i];
    r[i] = ri;
    acc[0] += ri * r0s[i];
    acc[1] += ri * ri;
  }
  block_sum2(acc);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = acc[0];
    part[gridDim.x + blockIdx.x] = acc[1];
  }
}

// One block: out[0] = sum(part[0:nb]), out[1] = sum(part[nb:2nb]), fixed order.
__global__ void __launch_bounds__(kThreads)
sum2_final(const float* __restrict__ part, int nb, float* __restrict__ out) {
  float acc[2] = {0.f, 0.f};
  for (int i = threadIdx.x; i < nb; i += kThreads) {
    acc[0] += part[i];
    acc[1] += part[nb + i];
  }
  block_sum2(acc);
  if (threadIdx.x == 0) {
    out[0] = acc[0];
    out[1] = acc[1];
  }
}

__global__ void __launch_bounds__(kThreads)
x_update(const float* __restrict__ x, const float* __restrict__ p,
         const float* __restrict__ s, const float* __restrict__ alpha,
         const float* __restrict__ gamma, int64_t n, float* __restrict__ out) {
  const float a = *alpha;
  const float g = *gamma;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    out[i] = x[i] + a * p[i] + g * s[i];
  }
}

int blocks_for(int64_t n, int cap) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return (int)(b < 1 ? 1 : (b > cap ? cap : b));
}

}  // namespace

extern "C" {

// Number of partial-sum slots (thread blocks) the reductions use for n elements.
int cg_reduce_blocks(int64_t n) { return blocks_for(n, kMaxReduceBlocks); }

void cg_dot2_partial(const float* u, const float* v, int64_t n, float* part, int nb,
                     cudaStream_t stream) {
  dot2_partial<<<nb, kThreads, 0, stream>>>(u, v, n, part);
}

void cg_residual_dots_partial(const float* s, const float* As, const float* r0s,
                              const float* gamma, int64_t n, float* r, float* part,
                              int nb, cudaStream_t stream) {
  residual_dots_partial<<<nb, kThreads, 0, stream>>>(s, As, r0s, gamma, n, r, part);
}

void cg_sum2_final(const float* part, int nb, float* out, cudaStream_t stream) {
  sum2_final<<<1, kThreads, 0, stream>>>(part, nb, out);
}

void cg_x_update(const float* x, const float* p, const float* s, const float* alpha,
                 const float* gamma, int64_t n, float* out, cudaStream_t stream) {
  x_update<<<blocks_for(n, kMaxElementwiseBlocks), kThreads, 0, stream>>>(
      x, p, s, alpha, gamma, n, out);
}

}  // extern "C"
