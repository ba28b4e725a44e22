// Split-K flash decode for Hopper (sm_90a): one query row per sequence
// against a dense rolling KV cache or a shared page pool; plain C interface
// (flash_decode.h).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_decode.py:
//   fd_dense_kernel <- _fd_kernel + combine_splits / flash_decode   merged (o, m, l)
//   fd_kernel       <- _fd_paged_kernel / flash_decode_paged        per-page (o, m, l)
// Each split computes what one TPU split computes: an online softmax over
// its keys of q·k·scale + bias, the weights p rounded to v's dtype before
// the product with V (accumulated in f32), and the split's o normalised by
// its own mass l and rounded to q's dtype, with m and l in f32. The fully
// masked guard is the reference's: m_safe = 0 where m <= NEG_INF/2,
// alpha = 0 while no live key was seen, norm = 1 where l <= 0, so a split
// (or a whole row) with no live key gives (o, m, l) = (0, NEG_INF, 0). The
// dense kernel then merges its splits itself, with the algebra and guards
// of combine_splits (m_safe, l clamped at 1e-20), summing the splits in
// split order, and writes o (B, H, hd) in q's dtype with the global m and
// l; the paged kernel's per-page partials are merged outside, in torch
// (kernels/flash_decode.py combine_splits), as the reference merges them in
// jnp.
//
// What bounds them on this card. Decoding one token does two multiply-adds
// per (query head, key, element of the head dim) and reads every live K and
// V element once: about G/2 operations per byte of bf16 K/V, against the
// ~295 at which the H100's tensor cores would become the limit. So both
// kernels are bound by the bytes of K and V. At the serving slice's dense
// shape (B 16, W 1024, KV 2, hd 128, bf16) that is 16.8 MB, 5.0 us at
// 3.35 TB/s; at such a batch one launch's time is mostly launch latency and
// the tail of 256 short blocks.
//
// The dense kernel (fd_dense_kernel):
//   * One block per (split, kv head, b) and one thread-block cluster per
//     (kv head, b): the ns <= 8 split blocks of a row (8 is the portable
//     cluster size). Each block leaves its split's (o, m, l) in shared
//     memory; after cluster.sync() every block of the cluster merges a
//     share of the G x hd outputs, reading its peers' partials through
//     distributed shared memory, so the partials never reach device memory
//     and no second launch (or torch merge) is needed.
//   * K and V stay in their own type in shared memory and come by cp.async,
//     16 bytes a thread, in rounds of 4 tiles of 32 keys: every live tile of
//     a round is in flight before the first is used (a 128-key split, the
//     reference's default block, is one round), and with room for two
//     rounds the next round's tiles load while this one is computed. Each
//     warp reads its tile's bias and puts the tile's loads in flight
//     itself, behind the query rows' loads, so the first K/V bytes leave
//     one memory latency after the launch. The 16-byte pieces of a row are
//     XOR-swizzled by row instead of padded, so lane j reading key j's row
//     hits 8 distinct bank groups and a block of the serving slice takes
//     74.6 KB: three fit on an SM (padded rows, 78.8 KB, would leave two,
//     too few slots for the slice's 32 clusters of 8, each on one GPC, to
//     be resident at once). The head dim is padded in shared memory to HD,
//     32, 64 or 128 (zero columns, never stored).
//   * Keys, not rows, are split across warps when the group is small: warp
//     w takes tiles w, w + 4, ... of each round for the G <= 8 query rows
//     of the kv head (G = 1 for zamba2-7b, 6 for Qwen2-1.5B), so every
//     warp's multiply-adds fall on live rows; at G up to 16 (32) two (four)
//     groups of rows share the tiles two (one) ways. Each warp keeps its own
//     (m, l, acc) in f32 registers, lane j owns key j of a tile (a score
//     needs no reduction; the row max and sum come from warp shuffles), and
//     the product with V reads the warp's weights back as float4 broadcasts
//     while lanes split the head dim (lane + 32c). The warps merge in shared
//     memory, in warp order, before the cluster merge.
//   * A tile whose bias is NEG_INF (or below) for every key is skipped, K/V
//     reads included: its logits round to NEG_INF in f32 and add exactly
//     nothing. The ragged tail of a split (W not a multiple of blk_k) is
//     masked in the kernel, where the reference pads K, V and bias with a
//     copy of the whole cache on every call; the (1, W) bias row of a shared
//     position row is read with batch stride 0, not broadcast.
//
// The paged kernel (fd_kernel): one block per (page, kv head, b); the page
// is staged in tiles of 32 keys widened to f32 rows of HD + 4 floats, warp
// w owns rows [w*RPW, (w+1)*RPW) of the group, and the block reads
// page_table[b, j] itself and clamps -1 (unmapped) to page 0, as the TPU
// index map does; only the bias masks what it reads.
//
// Kernels launch on the caller's stream and allocate nothing; the binding
// (cg_fused_bind.cpp) allocates the outputs and checks every launch.

#include "flash_decode.h"

#include <cooperative_groups.h>
#include <cuda_bf16.h>

namespace {

namespace cg = cooperative_groups;

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 32;       // keys per tile, one per lane
constexpr int kRound = kWarps;  // dense: tiles a round, one per warp
constexpr int kMaxSplits = 8;   // dense: the portable cluster size
constexpr int kMaxSmem = 227 * 1024;

// 16 bytes of T, widened to floats.
__device__ __forceinline__ void widen(const uint4& u, float* x, const float*) {
  x[0] = __uint_as_float(u.x); x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z); x[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void widen(const uint4& u, float* x, const __nv_bfloat16*) {
  // Eight bf16 values as four 32-bit words; element 2i is the low half of word i.
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 16 bytes of a row as floats.
template <class T>
__device__ __forceinline__ void load16(const T* p, float* x) {
  widen(*reinterpret_cast<const uint4*>(p), x, p);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// p rounded to V's type, as the reference's p.astype(v.dtype).
__device__ __forceinline__ float to_type(float x, const float*) { return x; }
__device__ __forceinline__ float to_type(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows [0, NR) of a tensor whose rows lie ``stride`` elements apart, hd
// values each, into shared memory as f32 rows of HD + 4 (HD >= hd, the
// register width); rows at or past n and columns [hd, HD) are zero (and not
// read), so they add exact zeros to every dot product.
template <class T, int HD, int NR>
__device__ __forceinline__ void stage(float* sm, const T* base, int64_t stride, int n,
                                      int hd) {
  constexpr int LD = HD + 4, C = 16 / sizeof(T), PER_ROW = HD / C;
  for (int idx = threadIdx.x; idx < NR * PER_ROW; idx += kThreads) {
    const int r = idx / PER_ROW, c = (idx - r * PER_ROW) * C;
    float x[C];
    if (r < n && c < hd) {
      load16(base + (int64_t)r * stride + c, x);
    } else {
#pragma unroll
      for (int i = 0; i < C; ++i) x[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < C; i += 4)
      *reinterpret_cast<float4*>(sm + r * LD + c + i) = make_float4(x[i], x[i + 1], x[i + 2],
                                                                     x[i + 3]);
  }
}

// ------------------------------------------------------------- paged --
template <class T, int HD, int RPW>
__global__ void __launch_bounds__(kThreads) fd_kernel(const FdArgs a) {
  constexpr int LD = HD + 4, DPL = HD / 32, ROWS = kWarps * RPW;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // ROWS x LD: the group's query rows
  float* sK = sQ + ROWS * LD;                   // kKeys x LD
  float* sV = sK + kKeys * LD;                  // kKeys x LD
  float* sP = sV + kKeys * LD;                  // ROWS x kKeys: weights, per warp
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = a.H / a.KV;
  const int64_t kstride = (int64_t)a.KV * a.hd;  // elements between neighbouring keys

  int page = a.page_table[(int64_t)b * a.ns + split];
  page = min(max(page, 0), a.P - 1);  // -1 (unmapped) reads page 0, masked by the bias
  const int64_t off = (int64_t)page * a.span * kstride + (int64_t)kvh * a.hd;
  const T* kb = static_cast<const T*>(a.k) + off;
  const T* vb = static_cast<const T*>(a.v) + off;
  const float* bias = a.bias + ((int64_t)b * a.ns + split) * a.span;
  const int n_keys = a.span;
  stage<T, HD, ROWS>(sQ,
                     static_cast<const T*>(a.q) + ((int64_t)b * a.H + (int64_t)kvh * G) * a.hd,
                     a.hd, G, a.hd);

  float acc[RPW][DPL], m[RPW], l[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }
  const float* wQ = sQ + warp * RPW * LD;
  float* wP = sP + warp * RPW * kKeys;
  for (int t0 = 0; t0 < n_keys; t0 += kKeys) {
    const int key = t0 + lane;
    const float bv = key < n_keys ? bias[key] : kNegInf;
    // The same test in every warp, so the whole block skips or none does.
    if (!__any_sync(0xffffffffu, bv > kNegInf)) continue;
    __syncthreads();
    stage<T, HD, kKeys>(sK, kb + t0 * kstride, kstride, n_keys - t0, a.hd);
    stage<T, HD, kKeys>(sV, vb + t0 * kstride, kstride, n_keys - t0, a.hd);
    __syncthreads();

    float s[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = 0.f;
    const float* kr = sK + lane * LD;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 kx = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float4 qx = *reinterpret_cast<const float4*>(wQ + r * LD + d);
        s[r] = fmaf(qx.x, kx.x, s[r]);
        s[r] = fmaf(qx.y, kx.y, s[r]);
        s[r] = fmaf(qx.z, kx.z, s[r]);
        s[r] = fmaf(qx.w, kx.w, s[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      // logits = (q·k)·scale + bias, two roundings as in the reference
      const float x = key < n_keys ? __fadd_rn(__fmul_rn(s[r], a.scale), bv) : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float m_safe = m_new <= kNegInf / 2 ? 0.f : m_new;
      const float p = expf(x - m_safe);  // masked keys: exactly 0
      const float alpha = m[r] <= kNegInf / 2 ? 0.f : expf(m[r] - m_safe);
      l[r] = alpha * l[r] + warp_sum(p);
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] *= alpha;
      m[r] = m_new;
      wP[r * kKeys + lane] = to_type(p, static_cast<const T*>(nullptr));
    }
    __syncwarp();
#pragma unroll 2
    for (int j = 0; j < kKeys; j += 4) {
      float vv[4][DPL];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < DPL; ++c) vv[jj][c] = sV[(j + jj) * LD + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float4 w = *reinterpret_cast<const float4*>(wP + r * kKeys + j);
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          acc[r][c] = fmaf(w.x, vv[0][c], acc[r][c]);
          acc[r][c] = fmaf(w.y, vv[1][c], acc[r][c]);
          acc[r][c] = fmaf(w.z, vv[2][c], acc[r][c]);
          acc[r][c] = fmaf(w.w, vv[3][c], acc[r][c]);
        }
      }
    }
  }

  const int64_t row0 = (((int64_t)b * a.KV + kvh) * a.ns + split) * G;
  T* o = static_cast<T*>(a.o);
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int g = warp * RPW + r;
    if (g >= G) continue;
    const float norm = l[r] <= 0.f ? 1.f : l[r];
#pragma unroll
    for (int c = 0; c < DPL; ++c)
      if (lane + 32 * c < a.hd) store1(o + (row0 + g) * a.hd + lane + 32 * c, acc[r][c] / norm);
    if (lane == 0) {
      a.m[row0 + g] = m[r];
      a.l[row0 + g] = l[r];
    }
  }
}

// ------------------------------------------------------------- dense --
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory, in flight until waited for; with
// ``ok`` false nothing is read and the destination is filled with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {  // all but the last group
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Element (r, e) of a K or V tile in shared memory: rows of HD elements,
// their 16-byte pieces XOR-swizzled by row, so that lane j reading piece c
// of row j, and a warp reading along one row, hit distinct banks without
// padding.
template <class T, int HD>
__device__ __forceinline__ int tile_at(int r, int e) {
  constexpr int C = 16 / sizeof(T), ROW_BYTES = HD * (int)sizeof(T);
  const int sw = ROW_BYTES >= 128 ? (r & 7) : ((r >> 1) & 3);
  return r * HD + (((e / C) ^ sw) * C) + (e % C);
}

// Keys [0, kKeys) of a tile, rows ``stride`` elements apart, into shared
// memory (tile_at) by the calling warp: columns [0, hd) of rows below n
// copied, the rest zero-filled (hd is a multiple of 8, so every 16-byte
// piece is either).
template <class T, int HD>
__device__ __forceinline__ void stage_tile_async(T* sm, const T* base, int64_t stride, int n,
                                                 int hd, int lane) {
  constexpr int C = 16 / sizeof(T), CH = HD / C;
#pragma unroll 4
  for (int idx = lane; idx < kKeys * CH; idx += 32) {
    const int r = idx / CH, c = (idx - r * CH) * C;
    const bool ok = r < n && c < hd;
    cp_async16(sm + tile_at<T, HD>(r, c), ok ? base + (int64_t)r * stride + c : base, ok);
  }
}

// Shared memory of one dense block: the K and V rings (nbuf rounds of
// kRound tiles each), the group's query rows in f32, the warps' weights,
// the rounds' bias and live flags, and the merge's statistics. After the
// key loop the ring holds the warps' partial sums and the split's o, and
// then the merge weights of the splits.
template <class T, int HD, int RPW, int WK>
struct DenseSmem {
  static constexpr int ROWS = kWarps / WK * RPW;
  static constexpr int kSlot = kKeys * HD;  // elements of one K (or V) tile
  static constexpr size_t bytes(int nbuf) {
    return sizeof(T) * (size_t)2 * nbuf * kRound * kSlot +
           sizeof(float) * ((size_t)ROWS * HD + kWarps * RPW * kKeys +
                            (size_t)nbuf * kRound * kKeys + 2 * WK * ROWS + 2 * ROWS) +
           sizeof(int) * (size_t)nbuf * kRound;
  }
  // the merge's scratch fits in one round of the ring
  static_assert(sizeof(float) * (WK + 1) * ROWS * HD <= sizeof(T) * 2 * kRound * kSlot &&
                    (kMaxSplits + 1) * ROWS <= WK * ROWS * HD,
                "merge scratch exceeds the ring");
};

template <class T, int HD, int RPW, int WK>
__global__ void __launch_bounds__(kThreads) fd_dense_kernel(const FdArgs a, const int nbuf) {
  using Sm = DenseSmem<T, HD, RPW, WK>;
  constexpr int ROWS = Sm::ROWS, kSlot = Sm::kSlot, C = 16 / sizeof(T), DPL = HD / 32;
  constexpr int QCH = HD / C, NQ = (ROWS * QCH + kThreads - 1) / kThreads;
  extern __shared__ float4 smem4[];
  T* sK = reinterpret_cast<T*>(smem4);
  T* sV = sK + nbuf * kRound * kSlot;
  float* sQ = reinterpret_cast<float*>(sV + nbuf * kRound * kSlot);  // ROWS x HD
  float* sP = sQ + ROWS * HD;                    // per warp RPW x kKeys weights
  float* sBias = sP + kWarps * RPW * kKeys;      // nbuf x kRound x kKeys
  float* sM = sBias + nbuf * kRound * kKeys;     // WK x ROWS: each key group's m, then scale
  float* sL = sM + WK * ROWS;                    // WK x ROWS: each key group's l
  float* sPm = sL + WK * ROWS;                   // ROWS: the split's m
  float* sPl = sPm + ROWS;                       // ROWS: the split's l
  int* sLive = reinterpret_cast<int*>(sPl + ROWS);  // nbuf x kRound
  float* sAcc = reinterpret_cast<float*>(smem4);    // after the loop: WK x ROWS x HD
  float* sPart = sAcc + WK * ROWS * HD;             // after the loop: ROWS x HD, o in T
  float* sW = sAcc;  // after the split's partial: (kMaxSplits + 1) x ROWS merge weights

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp / WK, wk = warp % WK;
  const int G = a.H / a.KV;
  const int64_t kstride = (int64_t)a.KV * a.hd;  // elements between neighbouring keys
  const int k0 = split * a.span;
  const int n_keys = min(a.span, a.W - k0);
  const int n_rounds = (n_keys + kRound * kKeys - 1) / (kRound * kKeys);
  const int64_t off = ((int64_t)b * a.W + k0) * kstride + (int64_t)kvh * a.hd;
  const T* kb = static_cast<const T*>(a.k) + off;
  const T* vb = static_cast<const T*>(a.v) + off;
  const float* bias = a.bias + (int64_t)(a.bias_b > 1 ? b : 0) * a.W + k0;
  const T* qb = static_cast<const T*>(a.q) + ((int64_t)b * a.H + (int64_t)kvh * G) * a.hd;

  // Warp w reads the bias of tile w of round r (lane = key) into shared
  // memory, marks the tile live if any key of it is, and then puts the
  // tile's K and V in flight itself (one commit group a round): no barrier
  // stands between the bias and the loads.
  auto fetch = [&](int r) {
    const int slot = (r % nbuf) * kRound + warp, t0 = (r * kRound + warp) * kKeys;
    const float bv = t0 + lane < n_keys ? bias[t0 + lane] : kNegInf;
    sBias[slot * kKeys + lane] = bv;
    const bool live = __any_sync(0xffffffffu, bv > kNegInf);
    if (lane == 0) sLive[slot] = live;
    if (live) {
      stage_tile_async<T, HD>(sK + slot * kSlot, kb + t0 * kstride, kstride, n_keys - t0, a.hd,
                              lane);
      stage_tile_async<T, HD>(sV + slot * kSlot, vb + t0 * kstride, kstride, n_keys - t0, a.hd,
                              lane);
    }
    cp_async_commit();
  };

  // The group's query rows: their loads go out before the first round's
  // bias and K/V, and land in shared memory (widened, rows past G and
  // columns past hd zero) while those are in flight.
  uint4 qr[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const int idx = threadIdx.x + i * kThreads, r = idx / QCH, c = (idx - r * QCH) * C;
    qr[i] = idx < ROWS * QCH && r < G && c < a.hd
                ? *reinterpret_cast<const uint4*>(qb + (int64_t)r * a.hd + c)
                : make_uint4(0u, 0u, 0u, 0u);
  }
  fetch(0);
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const int idx = threadIdx.x + i * kThreads, r = idx / QCH, c = (idx - r * QCH) * C;
    if (idx >= ROWS * QCH) continue;
    float x[C];
    widen(qr[i], x, static_cast<const T*>(nullptr));
#pragma unroll
    for (int j = 0; j < C; j += 4)
      *reinterpret_cast<float4*>(sQ + r * HD + c + j) = make_float4(x[j], x[j + 1], x[j + 2],
                                                                     x[j + 3]);
  }

  float acc[RPW][DPL], m[RPW], l[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }
  const float* wQ = sQ + wr * RPW * HD;  // read as broadcasts: no padding needed
  float* wP = sP + warp * RPW * kKeys;
  for (int rd = 0; rd < n_rounds; ++rd) {
    if (nbuf == 2 && rd + 1 < n_rounds) {
      fetch(rd + 1);
      cp_async_wait_one();  // round rd has landed, rd + 1 is in flight
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    for (int j = wk; j < kRound; j += WK) {
      const int slot = (rd % nbuf) * kRound + j, t0 = (rd * kRound + j) * kKeys;
      if (!sLive[slot]) continue;  // the same in every warp of a key group
      const T* cK = sK + slot * kSlot;
      const T* cV = sV + slot * kSlot;
      const float bv = sBias[slot * kKeys + lane];
      const int key = t0 + lane;

      float s[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) s[r] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; d += C) {
        float kx[C];
        load16(cK + tile_at<T, HD>(lane, d), kx);
#pragma unroll
        for (int r = 0; r < RPW; ++r)
#pragma unroll
          for (int i = 0; i < C; i += 4) {
            const float4 qx = *reinterpret_cast<const float4*>(wQ + r * HD + d + i);
            s[r] = fmaf(qx.x, kx[i], s[r]);
            s[r] = fmaf(qx.y, kx[i + 1], s[r]);
            s[r] = fmaf(qx.z, kx[i + 2], s[r]);
            s[r] = fmaf(qx.w, kx[i + 3], s[r]);
          }
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        // logits = (q·k)·scale + bias, two roundings as in the reference
        const float x = key < n_keys ? __fadd_rn(__fmul_rn(s[r], a.scale), bv) : kNegInf;
        const float m_new = fmaxf(m[r], warp_max(x));
        const float m_safe = m_new <= kNegInf / 2 ? 0.f : m_new;
        const float p = expf(x - m_safe);  // masked keys: exactly 0
        const float alpha = m[r] <= kNegInf / 2 ? 0.f : expf(m[r] - m_safe);
        l[r] = alpha * l[r] + warp_sum(p);
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[r][c] *= alpha;
        m[r] = m_new;
        wP[r * kKeys + lane] = to_type(p, static_cast<const T*>(nullptr));
      }
      __syncwarp();
#pragma unroll 2
      for (int jk = 0; jk < kKeys; jk += 4) {
        float vv[4][DPL];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int c = 0; c < DPL; ++c)
            vv[jj][c] = to_f32(cV[tile_at<T, HD>(jk + jj, lane + 32 * c)]);
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const float4 w = *reinterpret_cast<const float4*>(wP + r * kKeys + jk);
#pragma unroll
          for (int c = 0; c < DPL; ++c) {
            acc[r][c] = fmaf(w.x, vv[0][c], acc[r][c]);
            acc[r][c] = fmaf(w.y, vv[1][c], acc[r][c]);
            acc[r][c] = fmaf(w.z, vv[2][c], acc[r][c]);
            acc[r][c] = fmaf(w.w, vv[3][c], acc[r][c]);
          }
        }
      }
      __syncwarp();  // the weights are read before the next tile writes them
    }
    __syncthreads();  // every warp is done with round rd's stage
    if (nbuf == 1 && rd + 1 < n_rounds) fetch(rd + 1);
  }

  // The split's (o, m, l): the key groups' partials merged in group order,
  // o normalised by the split's l and rounded to T, as the reference stores it.
  if (WK == 1) {
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = wr * RPW + r;
      const float norm = l[r] <= 0.f ? 1.f : l[r];
#pragma unroll
      for (int c = 0; c < DPL; ++c)
        sPart[row * HD + lane + 32 * c] =
            to_type(acc[r][c] / norm, static_cast<const T*>(nullptr));
      if (lane == 0) {
        sPm[row] = m[r];
        sPl[row] = l[r];
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = wr * RPW + r;
#pragma unroll
      for (int c = 0; c < DPL; ++c) sAcc[(wk * ROWS + row) * HD + lane + 32 * c] = acc[r][c];
      if (lane == 0) {
        sM[wk * ROWS + row] = m[r];
        sL[wk * ROWS + row] = l[r];
      }
    }
    __syncthreads();
    // per row: the split's m and l, and each key group's scale in place of its m
    for (int row = threadIdx.x; row < ROWS; row += kThreads) {
      float mx = kNegInf;
#pragma unroll
      for (int k = 0; k < WK; ++k) mx = fmaxf(mx, sM[k * ROWS + row]);
      const float ms = mx <= kNegInf / 2 ? 0.f : mx;
      float lsum = 0.f;
#pragma unroll
      for (int k = 0; k < WK; ++k) {
        const float mk = sM[k * ROWS + row];
        const float e = mk <= kNegInf / 2 ? 0.f : expf(mk - ms);
        lsum = fmaf(e, sL[k * ROWS + row], lsum);
        sM[k * ROWS + row] = e;
      }
      sPm[row] = mx;
      sPl[row] = lsum;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < ROWS * HD; idx += kThreads) {
      const int row = idx / HD;
      float o = 0.f;
#pragma unroll
      for (int k = 0; k < WK; ++k) o = fmaf(sM[k * ROWS + row], sAcc[k * ROWS * HD + idx], o);
      const float norm = sPl[row] <= 0.f ? 1.f : sPl[row];
      sPart[idx] = to_type(o / norm, static_cast<const T*>(nullptr));
    }
  }

  // The cluster's merge, combine_splits' algebra, every split read in split
  // order through distributed shared memory: each block weighs the splits
  // of every row, then takes a share of the G x hd outputs.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int ns = a.ns;
  for (int g = threadIdx.x; g < G; g += kThreads) {
    float mg = kNegInf;
    for (int s = 0; s < ns; ++s) mg = fmaxf(mg, cluster.map_shared_rank(sPm, s)[g]);
    const float m_safe = mg <= kNegInf / 2 ? 0.f : mg;
    float lg = 0.f;
    for (int s = 0; s < ns; ++s) {
      const float w = cluster.map_shared_rank(sPl, s)[g] *
                      expf(cluster.map_shared_rank(sPm, s)[g] - m_safe);
      sW[s * ROWS + g] = w;
      lg += w;
    }
    sW[kMaxSplits * ROWS + g] = fmaxf(lg, 1e-20f);
    if (split == 0) {
      const int64_t row = (int64_t)b * a.H + (int64_t)kvh * G + g;
      a.m[row] = mg <= kNegInf / 2 ? kNegInf : mg;
      a.l[row] = lg;
    }
  }
  __syncthreads();
  T* out = static_cast<T*>(a.o) + ((int64_t)b * a.H + (int64_t)kvh * G) * a.hd;
  for (int idx = split * kThreads + threadIdx.x; idx < G * a.hd; idx += ns * kThreads) {
    const int g = idx / a.hd, d = idx - g * a.hd;
    float o = 0.f;
    for (int s = 0; s < ns; ++s) o += cluster.map_shared_rank(sPart, s)[g * HD + d] * sW[s * ROWS + g];
    store1(out + idx, o / sW[kMaxSplits * ROWS + g]);
  }
  cluster.sync();  // no block leaves while a peer may still read its shared memory
}

// -------------------------------------------------------------- launch --
template <class T, int HD, int RPW>
int launch_paged(const FdArgs& a, cudaStream_t stream) {
  constexpr int LD = HD + 4, ROWS = kWarps * RPW;
  const size_t smem =
      sizeof(float) * ((size_t)(ROWS + 2 * kKeys) * LD + (size_t)ROWS * kKeys);
  void (*kern)(const FdArgs) = fd_kernel<T, HD, RPW>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(a.ns, a.KV, a.B);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <class T, int HD>
int paged_rows(const FdArgs& a, cudaStream_t stream) {
  const int G = a.H / a.KV;
  if (G <= 2 * kWarps) return launch_paged<T, HD, 2>(a, stream);
  if (G <= 4 * kWarps) return launch_paged<T, HD, 4>(a, stream);
  if (G <= 8 * kWarps) return launch_paged<T, HD, 8>(a, stream);
  return (int)cudaErrorInvalidValue;
}

// Two rounds of ring when a split has more than one round and they fit.
template <class T, int HD, int RPW, int WK>
int launch_dense(const FdArgs& a, cudaStream_t stream) {
  using Sm = DenseSmem<T, HD, RPW, WK>;
  const int nbuf = a.span > kRound * kKeys && Sm::bytes(2) <= (size_t)kMaxSmem ? 2 : 1;
  const size_t smem = Sm::bytes(nbuf);
  void (*kern)(const FdArgs, const int) = fd_dense_kernel<T, HD, RPW, WK>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.ns, a.KV, a.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.ns;  // the splits of one (kv head, b)
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, a, nbuf);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Keys split across 4, 2 or 1 warps: the rows of a kv head's group a warp
// holds (RPW) is the least power of two at or above G up to 8.
template <class T, int HD>
int dense_rows(const FdArgs& a, cudaStream_t stream) {
  const int G = a.H / a.KV;
  if (G <= 1) return launch_dense<T, HD, 1, 4>(a, stream);
  if (G <= 2) return launch_dense<T, HD, 2, 4>(a, stream);
  if (G <= 4) return launch_dense<T, HD, 4, 4>(a, stream);
  if (G <= 8) return launch_dense<T, HD, 8, 4>(a, stream);
  if (G <= 16) return launch_dense<T, HD, 8, 2>(a, stream);
  if (G <= 32) return launch_dense<T, HD, 8, 1>(a, stream);
  return (int)cudaErrorInvalidValue;
}

// The register and shared-memory width: the smallest of 32, 64 and 128 at
// or above the head dim, which may be any multiple of 8 up to 128.
template <class T>
int dispatch_hd(const FdArgs& a, int paged, cudaStream_t stream) {
  if (a.hd < 8 || a.hd > 128 || a.hd % 8) return (int)cudaErrorInvalidValue;
  if (paged) {
    if (a.hd <= 32) return paged_rows<T, 32>(a, stream);
    if (a.hd <= 64) return paged_rows<T, 64>(a, stream);
    return paged_rows<T, 128>(a, stream);
  }
  if (a.ns < 1 || a.ns > kMaxSplits) return (int)cudaErrorInvalidValue;
  if (a.hd <= 32) return dense_rows<T, 32>(a, stream);
  if (a.hd <= 64) return dense_rows<T, 64>(a, stream);
  return dense_rows<T, 128>(a, stream);
}

int dispatch(const FdArgs* a, int paged, cudaStream_t stream) {
  if (a->KV <= 0 || a->H % a->KV) return (int)cudaErrorInvalidValue;
  if (a->dtype == 0) return dispatch_hd<float>(*a, paged, stream);
  if (a->dtype == 1) return dispatch_hd<__nv_bfloat16>(*a, paged, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int fd_dense(const FdArgs* a, cudaStream_t stream) { return dispatch(a, 0, stream); }
int fd_paged(const FdArgs* a, cudaStream_t stream) { return dispatch(a, 1, stream); }
}
