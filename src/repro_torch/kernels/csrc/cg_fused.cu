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
// 4-byte element read, half the f32 balance, so what it needs is enough
// copies in flight and few instructions per element. Each block streams
// column tiles of all s_u + s_v rows through a ring of kGramStages stages in
// shared memory, filled by cp.async: while one tile is consumed the next
// three are in flight (at 17 x 20 a block holds 78 KB of ring and two blocks
// share an SM, so up to 117 KB of copies an SM). One __syncthreads a tile,
// and no thread waits for a load it issued in the same step. Rows are copied
// 4 bytes at a time (cp.async.ca): a row of n = 1,722,293 columns starts at
// no 16-byte boundary. The product is register-tiled f32 FFMA: warp (a, b)
// owns a sub-block of U rows against V rows, fitted to the shape (6 x 7 at
// 17 x 20: 378 FMAs per column against 340 needed; 8 x 8 for shapes outside
// the s-step ones), each lane its accumulators over its column pairs of
// every tile (8-byte shared loads), so each value read from shared memory
// feeds 6 or 7 FMAs. FFMA and not split-TF32 mma.sync: every partial is an
// exact f32 fma chain, rounded to nearest, where an mma accumulator would
// sum a 1.7M-long dot product with truncation; and 0.02 ms of FMAs at the
// f32 rate sit under the 0.076 ms byte bound. The ring's rows are padded to
// whole sub-blocks with zeros, so no row index is clamped.
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
constexpr int kGramSide = 8;      // a warp's sub-block: 8 U rows x 8 V rows
constexpr int kGramTile = 128;    // columns of a stage
constexpr int kGramStages = 4;    // stages of the ring

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes from device to shared memory; with ``ok`` false nothing is read
// and the destination is zero-filled.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Every group but the newest kGramStages - 2 has landed.
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kGramStages - 2) : "memory");
}

// How a Gram of su x sv rows is cut among warps: gu x gv warps, warp (a, c)
// owning ru U rows from a * ru and rv V rows from c * rv (rows past su or sv
// are zero in the ring).
struct GramCut {
  int gu, gv, ru, rv;
};

// Block b takes column tiles b, b + gridDim.x, ... in order. Warp (a, c)
// (warp = a * gv + c) owns the RU x RV sub-block of U rows a * RU.. and V
// rows c * RV..; lane L takes column pairs 2L, 2L + 1 and 64 + 2L, 65 + 2L of
// each tile (8-byte shared loads). A reduction over the lanes in a fixed
// order gives the block's (su, sv) partial, which lane 0 writes to
// part[blockIdx.x]. Up to 9 warps (every s-step shape), two blocks share an
// SM; the general instance takes up to 16.
template <int RU, int RV, int kMaxWarps>
__global__ void __launch_bounds__(32 * kMaxWarps, kMaxWarps <= 9 ? 2 : 1)
    dots_block_partial(const float* __restrict__ U, const float* __restrict__ V, int su, int sv,
                       int64_t n, float* __restrict__ part) {
  extern __shared__ __align__(16) float ring[];
  const int gu = (su + RU - 1) / RU, gv = (sv + RV - 1) / RV;
  const int rows = RU * gu + RV * gv;  // rows of a stage
  const int stage = rows * kGramTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int wu = warp / gv, wv = warp - wu * gv;
  const int64_t ntiles = (n + kGramTile - 1) / kGramTile;
  const int mine = (int)((ntiles - 1 - blockIdx.x) / gridDim.x + 1);  // gridDim.x <= ntiles

  // The padding rows stay zero: no copy writes them.
  for (int idx = threadIdx.x; idx < kGramStages * stage; idx += blockDim.x) {
    const int r = (idx % stage) / kGramTile;
    if ((r >= su && r < RU * gu) || r >= RU * gu + sv) ring[idx] = 0.f;
  }

  // Copies of tile k of this block into stage k % kGramStages: warp w
  // copies rows w, w + nwarps, ...; a column past n is zero-filled.
  auto issue = [&](int k) {
    const int64_t c0 = ((int64_t)blockIdx.x + (int64_t)k * gridDim.x) * kGramTile;
    float* dst = ring + (k % kGramStages) * stage;
    const bool full = c0 + kGramTile <= n;
    for (int r = warp; r < su + sv; r += nwarps) {
      const float* src = (r < su ? U + (int64_t)r * n : V + (int64_t)(r - su) * n) + c0;
      float* row = dst + (r < su ? r : RU * gu + r - su) * kGramTile;
#pragma unroll
      for (int q = 0; q < kGramTile / 32; ++q) {
        const int c = lane + 32 * q;
        const bool ok = full || c0 + c < n;
        cp_async4(row + c, ok ? src + c : U, ok);
      }
    }
  };

#pragma unroll
  for (int k = 0; k < kGramStages - 1; ++k) {
    if (k < mine) issue(k);
    cp_async_commit();
  }
  float acc[RU][RV];
#pragma unroll
  for (int i = 0; i < RU; ++i)
#pragma unroll
    for (int j = 0; j < RV; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < mine; ++k) {
    cp_async_wait_ring();
    __syncthreads();  // tile k is in; every warp is done with tile k - 1
    if (k + kGramStages - 1 < mine) issue(k + kGramStages - 1);
    cp_async_commit();
    const float* tile = ring + (k % kGramStages) * stage;
    const float2* tu = reinterpret_cast<const float2*>(tile + RU * wu * kGramTile) + lane;
    const float2* tv =
        reinterpret_cast<const float2*>(tile + (RU * gu + RV * wv) * kGramTile) + lane;
#pragma unroll
    for (int q = 0; q < kGramTile / 64; ++q) {
      float2 u[RU];
#pragma unroll
      for (int i = 0; i < RU; ++i) u[i] = tu[i * (kGramTile / 2) + 32 * q];
#pragma unroll
      for (int j = 0; j < RV; ++j) {
        const float2 v = tv[j * (kGramTile / 2) + 32 * q];
#pragma unroll
        for (int i = 0; i < RU; ++i) acc[i][j] = fmaf(u[i].y, v.y, fmaf(u[i].x, v.x, acc[i][j]));
      }
    }
  }

  const int64_t slot = (int64_t)blockIdx.x * su * sv;
#pragma unroll
  for (int i = 0; i < RU; ++i)
#pragma unroll
    for (int j = 0; j < RV; ++j) {
      const float w = warp_sum(acc[i][j]);
      const int r = RU * wu + i, c = RV * wv + j;
      if (lane == 0 && r < su && c < sv) part[slot + r * sv + c] = w;
    }
}

using GramKernel = void (*)(const float*, const float*, int, int, int64_t, float*);

// The instance cut for an s-step Gram (17 x 20, 17 x 17, 9 x 12, 9 x 9 rows
// and the like), or none.
GramKernel fitted_kernel(int ru, int rv) {
  if (ru == 6 && rv == 7) return dots_block_partial<6, 7, 9>;
  if (ru == 6 && rv == 6) return dots_block_partial<6, 6, 9>;
  if (ru == 5 && rv == 6) return dots_block_partial<5, 6, 9>;
  if (ru == 5 && rv == 5) return dots_block_partial<5, 5, 9>;
  return nullptr;
}

// The cut of an su x sv Gram: up to 8 rows a side for each warp, evened out
// where an instance fits it, else 8 x 8.
GramCut gram_cut(int su, int sv) {
  GramCut c;
  c.gu = (su + kGramSide - 1) / kGramSide;
  c.gv = (sv + kGramSide - 1) / kGramSide;
  c.ru = (su + c.gu - 1) / c.gu;
  c.rv = (sv + c.gv - 1) / c.gv;
  if (c.gu * c.gv > 9 || !fitted_kernel(c.ru, c.rv)) c.ru = c.rv = kGramSide;
  return c;
}

GramKernel gram_kernel(const GramCut& c) {
  const GramKernel k = c.gu * c.gv <= 9 ? fitted_kernel(c.ru, c.rv) : nullptr;
  return k ? k : dots_block_partial<kGramSide, kGramSide, 16>;
}

size_t gram_smem_bytes(const GramCut& c) {
  return sizeof(float) * kGramStages * kGramTile * (size_t)(c.gu * c.ru + c.gv * c.rv);
}

// out[e] = sum over blocks b = 0, 1, ... of part[b][e], in that order; the
// loads of kAhead slots are issued before their adds.
__global__ void __launch_bounds__(kThreads)
gram_final(const float* __restrict__ part, int nb, int entries, float* __restrict__ out) {
  constexpr int kAhead = 64;
  for (int e = threadIdx.x; e < entries; e += kThreads) {
    const float* p = part + e;
    float acc = 0.f;
    int b = 0;
    for (; b + kAhead <= nb; b += kAhead) {
      float v[kAhead];
#pragma unroll
      for (int i = 0; i < kAhead; ++i) v[i] = __ldg(p + (int64_t)(b + i) * entries);
#pragma unroll
      for (int i = 0; i < kAhead; ++i) acc += v[i];
    }
    for (; b < nb; ++b) acc += __ldg(p + (int64_t)b * entries);
    out[e] = acc;
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

// Most rows of U and of V that cg_dots_block_partial takes.
int cg_gram_max_rows() { return kGramMaxRows; }

// Partial slots (thread blocks) for an (su, sv) Gram over n columns: one
// tile each at most, and no more blocks than fit on the card at once.
int cg_gram_blocks(int su, int sv, int64_t n) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const GramCut c = gram_cut(su, sv);
  const size_t smem = gram_smem_bytes(c);
  cudaFuncSetAttribute(gram_kernel(c), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gram_kernel(c), 32 * c.gu * c.gv, smem);
  const int64_t resident = (int64_t)(per_sm < 1 ? 1 : per_sm) * (sms < 1 ? 1 : sms);
  const int64_t ntiles = (n + kGramTile - 1) / kGramTile;
  return (int)(ntiles < resident ? ntiles : resident);
}

// Launches after cg_gram_blocks(su, sv, n), which sets the kernel's shared
// memory limit; nb must be at most its result.
void cg_dots_block_partial(const float* U, const float* V, int su, int sv, int64_t n,
                           float* part, int nb, cudaStream_t stream) {
  const GramCut c = gram_cut(su, sv);
  gram_kernel(c)<<<nb, 32 * c.gu * c.gv, gram_smem_bytes(c), stream>>>(U, V, su, sv, n, part);
}

void cg_gram_final(const float* part, int nb, int entries, float* out,
                   cudaStream_t stream) {
  gram_final<<<1, kThreads, 0, stream>>>(part, nb, entries, out);
}

}  // extern "C"
