// Fused Krylov vector recurrences for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/cg_fused.py:
//   dot2_partial + sum2_final   <- _dot2_kernel / dot2            (<u,v>, <v,v>)
//   x_update                    <- _x_update_kernel / x_update    x + a*p + g*s
//   residual_dots_partial + sum2_final
//                               <- _residual_dots_kernel / residual_dots
//                                  r = s - g*As, <r,r0s>, <r,r>
//   dots_block_partial + gram_final
//                               <- _dots_block_kernel / dots_block
//                                  the (s_u, s_v) Gram U V^T of two stacked blocks
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
// dots_block is bound by bytes too: at the s-step shapes (s_u <= 17 rows
// against s_v <= 20, n = 1.7M) it does s_u*s_v / (s_u + s_v) ~ 9 FMAs per
// 4-byte element read, half the f32 balance. Each element of U and V is read
// from device memory once: a block stages a column tile of all s_u + s_v
// rows in shared memory, and every value there feeds s_v (or s_u) FMAs from
// registers. Warp g of a block owns U rows 2g, 2g+1 against every V row, so
// its accumulators (2 x MV) stay in registers, and its lanes split the
// tile's columns. Staging issues eight independent loads per thread before
// storing any, so a tile costs about one memory latency, not one per load,
// and up to s_v = 24 two blocks share an SM, so one stages while the other
// computes.
// The TPU kernel zero-padded the rows to 8 and the columns to its 16k block
// and carried one partial per grid step; here the tail is masked, each
// block reduces its lanes in a fixed order and writes its (s_u, s_v) partial
// to its own slot, and gram_final adds the slots in block order.
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

// ---------------------------------------------------------------- Gram --
constexpr int kGramMaxRows = 32;  // most rows of U and of V
constexpr int kGramRU = 2;        // U rows per warp
constexpr int kGramTile = 128;    // columns staged per step
constexpr int kGramUnroll = 8;    // loads in flight per thread while staging

// Warp g owns U rows 2g, 2g+1 against every V row; its 32 lanes split the
// tile's columns, and a warp reduction in a fixed order gives the block's
// (su, sv) partial, which lane 0 writes to part[blockIdx.x].
template <int MV>
__global__ void __launch_bounds__(32 * kGramMaxRows / kGramRU, MV <= 24 ? 2 : 1)
dots_block_partial(const float* __restrict__ U, const float* __restrict__ V, int su,
                   int sv, int64_t n, float* __restrict__ part) {
  __shared__ float tu[kGramMaxRows][kGramTile];
  __shared__ float tv[kGramMaxRows][kGramTile];
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * kGramRU;
  const int total = (su + sv) * kGramTile;
  float acc[kGramRU][MV];
#pragma unroll
  for (int i = 0; i < kGramRU; ++i)
#pragma unroll
    for (int j = 0; j < MV; ++j) acc[i][j] = 0.f;

  const int64_t ntiles = (n + kGramTile - 1) / kGramTile;
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int64_t c0 = t * kGramTile;
    // Stage the tile: kGramUnroll independent loads per thread in flight,
    // then their stores; the ragged tail reads as zero.
    for (int base = threadIdx.x; base < total; base += kGramUnroll * blockDim.x) {
      float val[kGramUnroll];
#pragma unroll
      for (int k = 0; k < kGramUnroll; ++k) {
        const int idx = base + k * blockDim.x;
        const int row = idx / kGramTile;
        const int64_t col = c0 + idx % kGramTile;
        val[k] = 0.f;
        if (idx < total && col < n) {
          val[k] = row < su ? U[(int64_t)row * n + col] : V[(int64_t)(row - su) * n + col];
        }
      }
#pragma unroll
      for (int k = 0; k < kGramUnroll; ++k) {
        const int idx = base + k * blockDim.x;
        if (idx < total) {
          const int row = idx / kGramTile;
          const int c = idx % kGramTile;
          if (row < su) tu[row][c] = val[k];
          else tv[row - su][c] = val[k];
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kGramTile / 32; ++k) {
      const int c = lane + 32 * k;
      float u[kGramRU];
#pragma unroll
      for (int i = 0; i < kGramRU; ++i) u[i] = r0 + i < su ? tu[r0 + i][c] : 0.f;
#pragma unroll
      for (int j = 0; j < MV; ++j) {
        const float v = j < sv ? tv[j][c] : 0.f;
#pragma unroll
        for (int i = 0; i < kGramRU; ++i) acc[i][j] = fmaf(u[i], v, acc[i][j]);
      }
    }
    __syncthreads();
  }

  const int64_t slot = (int64_t)blockIdx.x * su * sv;
#pragma unroll
  for (int i = 0; i < kGramRU; ++i)
#pragma unroll
    for (int j = 0; j < MV; ++j) {
      const float w = warp_sum(acc[i][j]);
      if (lane == 0 && r0 + i < su && j < sv) part[slot + (r0 + i) * sv + j] = w;
    }
}

// out[e] = sum over blocks b = 0, 1, ... of part[b][e], in that order.
__global__ void __launch_bounds__(kThreads)
gram_final(const float* __restrict__ part, int nb, int entries, float* __restrict__ out) {
  for (int e = threadIdx.x; e < entries; e += kThreads) {
    float acc = 0.f;
    for (int b = 0; b < nb; ++b) acc += part[(int64_t)b * entries + e];
    out[e] = acc;
  }
}

using GramKernel = void (*)(const float*, const float*, int, int, int64_t, float*);

GramKernel gram_kernel(int sv) {
  if (sv <= 8) return dots_block_partial<8>;
  if (sv <= 16) return dots_block_partial<16>;
  if (sv <= 24) return dots_block_partial<24>;
  return dots_block_partial<32>;
}

int gram_threads(int su) { return 32 * ((su + kGramRU - 1) / kGramRU); }

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

// Most rows of U and of V that cg_dots_block_partial takes.
int cg_gram_max_rows() { return kGramMaxRows; }

// Partial slots (thread blocks) for an (su, sv) Gram over n columns: one
// tile each at most, and no more blocks than fit on the card at once.
int cg_gram_blocks(int su, int sv, int64_t n) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gram_kernel(sv),
                                                gram_threads(su), 0);
  const int64_t resident = (int64_t)(per_sm < 1 ? 1 : per_sm) * (sms < 1 ? 1 : sms);
  const int64_t ntiles = (n + kGramTile - 1) / kGramTile;
  return (int)(ntiles < resident ? ntiles : resident);
}

void cg_dots_block_partial(const float* U, const float* V, int su, int sv, int64_t n,
                           float* part, int nb, cudaStream_t stream) {
  gram_kernel(sv)<<<nb, gram_threads(su), 0, stream>>>(U, V, su, sv, n, part);
}

void cg_gram_final(const float* part, int nb, int entries, float* out,
                   cudaStream_t stream) {
  gram_final<<<1, kThreads, 0, stream>>>(part, nb, entries, out);
}

}  // extern "C"
