// Fused Krylov vector recurrences for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/cg_fused.py:
//   dot2_single                 <- _dot2_kernel / dot2            (<u,v>, <v,v>)
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
// pass. No float atomics anywhere: every result is the same from run to run,
// which the flat Krylov backend's parity needs; the order of summation
// depends on n, the inputs' alignment and the SM count, never on timing.
//
// dot2 and x_update are what is left of a Krylov iteration once its products
// are taken: a few MB at the MLP's n = 1,722,293, where the launch, the
// tail and a cold L2 cost as much as the bytes, and GB at a transformer's n,
// where only the bytes in flight count. Both launch at most one resident wave (the SM count
// times the blocks of 256 threads that fit an SM, read once per device;
// fewer blocks at small n, see stream_blocks) and walk the vectors as
// "vectors" of four consecutive floats: thread t of the G in the grid takes
// vectors t, t + G, t + 2G, ..., kDotUnroll (dot2) or kAxpyUnroll
// (x_update) of them per operand loaded before any is used.
// Where every operand has the same address mod 16 bytes, a vector is one
// 16-byte load (__ldg); the first h < 4 elements (the head, up to the first
// 16-byte boundary) and the last (n - h) mod 4 (the tail) are taken one
// element each by threads 0, 1, 2 of the grid. Where the offsets differ (a
// row of an (s, n) block with odd n against a fresh vector), the same kernel
// runs with four 4-byte loads a vector and no head. x_update lays its fresh
// output at x's offset mod 16 (the binding allocates n + 3 floats and
// returns a view), so one shared offset of x, p and s is enough. The TPU
// kernels zero-padded n up to their 64k block and carried one partial per
// grid step; here the ragged head and tail are masked.
//
// dot2 is one launch. Each thread keeps one f32 fma chain per lane of its
// vectors (four for <u,v>, four for <v,v>), ends with the head and tail
// elements in lane 0, and adds its lanes as (l0 + l1) + (l2 + l3); the block
// adds its threads by the warp shuffle tree of block_sum2 and writes its two
// partials to a scratch slot. Then thread 0 fences and takes a ticket from a
// counter (atomicAdd); the block that draws the last ticket reads every
// slot back from L2, adds them in a fixed order (thread i the slots i,
// i + 256, ..., then block_sum2), writes out[0..1] and sets the counter back
// to 0. A last-block counter and not a cooperative launch with a grid sync:
// every other block exits as soon as its partials are out, and the launch
// is an ordinary one. The binding owns the scratch and the counter, one
// buffer per device and stream, zeroed once, so two dot2s in flight on two
// streams never share a counter and no memset is launched per call.
//
// residual_dots still writes one partial per block and sum2_final adds the
// slots in a fixed order in one block (two launches).
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

// -------------------------------------------------------- dot2, x_update --
constexpr int kDotUnroll = 4;      // vectors of each operand in flight, dot2
constexpr int kAxpyUnroll = 2;     // the same, x_update (three operands)
constexpr int kMaxStreamBlocks = 4096;  // scratch slots of dot2 (132 SMs x 8 need 1056)

// Elements 4j..4j+3 from p: one 16-byte load where kVec (p 16-byte aligned),
// else four 4-byte loads.
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* __restrict__ p, int64_t j) {
  if (kVec) return __ldg(reinterpret_cast<const float4*>(p) + j);
  const float* q = p + 4 * j;
  return make_float4(__ldg(q), __ldg(q + 1), __ldg(q + 2), __ldg(q + 3));
}

template <bool kVec>
__device__ __forceinline__ void store4(float* __restrict__ p, int64_t j, float4 w) {
  if (kVec) {
    reinterpret_cast<float4*>(p)[j] = w;
  } else {
    float* q = p + 4 * j;
    q[0] = w.x;
    q[1] = w.y;
    q[2] = w.z;
    q[3] = w.w;
  }
}

// (<u,v>, <v,v>) into out[0..1] in one launch (header). The body is the
// m = (n - h) / 4 vectors from element h; part holds 2 * gridDim.x slots and
// *count is 0 on entry and on exit.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
dot2_single(const float* __restrict__ u, const float* __restrict__ v, int64_t n, int h,
            float* __restrict__ part, unsigned int* __restrict__ count,
            float* __restrict__ out) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t G = (int64_t)gridDim.x * kThreads;
  const int64_t m = (n - h) >> 2;
  const float* __restrict__ ub = u + h;
  const float* __restrict__ vb = v + h;
  float uv[4] = {0.f, 0.f, 0.f, 0.f}, vv[4] = {0.f, 0.f, 0.f, 0.f};
  for (int64_t j0 = t; j0 < m; j0 += G * kDotUnroll) {
    float4 a[kDotUnroll], b[kDotUnroll];
#pragma unroll
    for (int k = 0; k < kDotUnroll; ++k) {
      const int64_t j = j0 + k * G;
      a[k] = j < m ? load4<kVec>(ub, j) : make_float4(0.f, 0.f, 0.f, 0.f);
      b[k] = j < m ? load4<kVec>(vb, j) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < kDotUnroll; ++k) {
      uv[0] = fmaf(a[k].x, b[k].x, uv[0]);
      uv[1] = fmaf(a[k].y, b[k].y, uv[1]);
      uv[2] = fmaf(a[k].z, b[k].z, uv[2]);
      uv[3] = fmaf(a[k].w, b[k].w, uv[3]);
      vv[0] = fmaf(b[k].x, b[k].x, vv[0]);
      vv[1] = fmaf(b[k].y, b[k].y, vv[1]);
      vv[2] = fmaf(b[k].z, b[k].z, vv[2]);
      vv[3] = fmaf(b[k].w, b[k].w, vv[3]);
    }
  }
  if (t < h) {  // head element t
    const float a = __ldg(u + t), b = __ldg(v + t);
    uv[0] = fmaf(a, b, uv[0]);
    vv[0] = fmaf(b, b, vv[0]);
  }
  if (t < ((n - h) & 3)) {  // tail element t
    const int64_t i = h + 4 * m + t;
    const float a = __ldg(u + i), b = __ldg(v + i);
    uv[0] = fmaf(a, b, uv[0]);
    vv[0] = fmaf(b, b, vv[0]);
  }
  float acc[2] = {(uv[0] + uv[1]) + (uv[2] + uv[3]), (vv[0] + vv[1]) + (vv[2] + vv[3])};
  block_sum2(acc);

  __shared__ bool last;
  if (threadIdx.x == 0) {
    part[blockIdx.x] = acc[0];
    part[gridDim.x + blockIdx.x] = acc[1];
    __threadfence();  // the slots are visible before the ticket is drawn
    last = atomicAdd(count, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float sum[2] = {0.f, 0.f};
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads) {
    sum[0] += __ldcg(part + b);  // from L2: other SMs wrote the slots
    sum[1] += __ldcg(part + gridDim.x + b);
  }
  block_sum2(sum);
  if (threadIdx.x == 0) {
    out[0] = sum[0];
    out[1] = sum[1];
    *count = 0u;
  }
}

// out = x + alpha*p + gamma*s, elementwise (header); out shares x's offset
// mod 16 bytes, so the head h is the same for all four.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
x_update(const float* __restrict__ x, const float* __restrict__ p,
         const float* __restrict__ s, const float* __restrict__ alpha,
         const float* __restrict__ gamma, int64_t n, int h, float* __restrict__ out) {
  const float a = *alpha;
  const float g = *gamma;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t G = (int64_t)gridDim.x * kThreads;
  const int64_t m = (n - h) >> 2;
  for (int64_t j0 = t; j0 < m; j0 += G * kAxpyUnroll) {
    float4 xv[kAxpyUnroll], pv[kAxpyUnroll], sv[kAxpyUnroll];
#pragma unroll
    for (int k = 0; k < kAxpyUnroll; ++k) {
      const int64_t j = j0 + k * G;
      if (j < m) {
        xv[k] = load4<kVec>(x + h, j);
        pv[k] = load4<kVec>(p + h, j);
        sv[k] = load4<kVec>(s + h, j);
      }
    }
#pragma unroll
    for (int k = 0; k < kAxpyUnroll; ++k) {
      const int64_t j = j0 + k * G;
      if (j < m) {
        float4 o;
        o.x = xv[k].x + a * pv[k].x + g * sv[k].x;
        o.y = xv[k].y + a * pv[k].y + g * sv[k].y;
        o.z = xv[k].z + a * pv[k].z + g * sv[k].z;
        o.w = xv[k].w + a * pv[k].w + g * sv[k].w;
        store4<kVec>(out + h, j, o);
      }
    }
  }
  if (t < h) out[t] = x[t] + a * p[t] + g * s[t];
  if (t < ((n - h) & 3)) {
    const int64_t i = h + 4 * m + t;
    out[i] = x[i] + a * p[i] + g * s[i];
  }
}

// The SM count and one resident wave of a kernel (blocks of kThreads), read
// once per device and instance; kinds: 0, 1 dot2 (4-byte, 16-byte body),
// 2, 3 x_update.
struct Wave {
  int sms, resident;
};

Wave wave(int kind) {
  constexpr int kMaxDevices = 64;
  static Wave cache[kMaxDevices][4] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  Wave& w = cache[dev < kMaxDevices ? dev : 0][kind];
  if (w.resident == 0) {
    const void* k = kind == 0 ? (const void*)dot2_single<false>
                  : kind == 1 ? (const void*)dot2_single<true>
                  : kind == 2 ? (const void*)x_update<false>
                              : (const void*)x_update<true>;
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads, 0);
    sms = sms < 1 ? 1 : sms;
    const int r = sms * (per_sm < 1 ? 1 : per_sm);
    w.sms = sms;
    w.resident = r < kMaxStreamBlocks ? r : kMaxStreamBlocks;
  }
  return w;
}

// Blocks for m vectors at ``unroll`` a thread an iteration: as many as give
// each thread ``unroll`` vectors, but at least one an SM while every thread
// still has a vector, and at most one resident wave. Fewer, fuller blocks
// mean fewer partials and tickets at the MLP's n; the wave keeps every SM
// streaming at a transformer's.
int stream_blocks(int kind, int64_t m, int unroll) {
  const Wave w = wave(kind);
  const int64_t per_thread = (m + (int64_t)kThreads * unroll - 1) / ((int64_t)kThreads * unroll);
  const int64_t busy = (m + kThreads - 1) / kThreads;
  int64_t b = per_thread > w.sms ? per_thread : (busy < w.sms ? busy : w.sms);
  b = b > w.resident ? w.resident : b;
  return (int)(b < 1 ? 1 : b);
}

// The head of a pass over vectors at byte addresses a, b and c: the elements
// before a's first 16-byte boundary where b and c have a's offset mod 16,
// else -1 (the 4-byte body).
int head_of(const void* a, const void* b, const void* c, int64_t n) {
  const uintptr_t o = reinterpret_cast<uintptr_t>(a) & 15;
  if ((reinterpret_cast<uintptr_t>(b) & 15) != o || (reinterpret_cast<uintptr_t>(c) & 15) != o)
    return -1;
  const int64_t h = (int64_t)((16 - o) & 15) / 4;
  return (int)(h < n ? h : n);
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

// Floats of dot2's scratch: 2 slots a block, then the counter.
int cg_dot2_scratch_floats() { return 2 * kMaxStreamBlocks + 1; }

// scratch: cg_dot2_scratch_floats() floats whose last is a zeroed counter,
// owned by the caller for this stream alone.
void cg_dot2(const float* u, const float* v, int64_t n, float* scratch, float* out,
             cudaStream_t stream) {
  const int h = head_of(u, v, v, n);
  unsigned int* count = reinterpret_cast<unsigned int*>(scratch + 2 * kMaxStreamBlocks);
  if (h >= 0) {
    const int nb = stream_blocks(1, (n - h) >> 2, kDotUnroll);
    dot2_single<true><<<nb, kThreads, 0, stream>>>(u, v, n, h, scratch, count, out);
  } else {
    const int nb = stream_blocks(0, n >> 2, kDotUnroll);
    dot2_single<false><<<nb, kThreads, 0, stream>>>(u, v, n, 0, scratch, count, out);
  }
}

void cg_residual_dots_partial(const float* s, const float* As, const float* r0s,
                              const float* gamma, int64_t n, float* r, float* part,
                              int nb, cudaStream_t stream) {
  residual_dots_partial<<<nb, kThreads, 0, stream>>>(s, As, r0s, gamma, n, r, part);
}

void cg_sum2_final(const float* part, int nb, float* out, cudaStream_t stream) {
  sum2_final<<<1, kThreads, 0, stream>>>(part, nb, out);
}

// out must have x's address mod 16 bytes.
void cg_x_update(const float* x, const float* p, const float* s, const float* alpha,
                 const float* gamma, int64_t n, float* out, cudaStream_t stream) {
  const int h = head_of(x, p, s, n);
  if (h >= 0) {
    x_update<true><<<stream_blocks(3, (n - h) >> 2, kAxpyUnroll), kThreads, 0, stream>>>(
        x, p, s, alpha, gamma, n, h, out);
  } else {
    x_update<false><<<stream_blocks(2, n >> 2, kAxpyUnroll), kThreads, 0, stream>>>(
        x, p, s, alpha, gamma, n, 0, out);
  }
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
