// Split-K flash decode for Hopper (sm_90a): one query row per sequence
// against a dense rolling KV cache or a shared page pool; plain C interface
// (flash_decode.h).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_decode.py:
//   fd_dense_kernel <- _fd_kernel + combine_splits / flash_decode
//   fd_paged_kernel <- _fd_paged_kernel + combine_splits / flash_decode_paged
// Each returns the merged (o, m, l) in one launch. A split (dense) or a page
// (paged, one page = one split) computes what its TPU split computes: a
// softmax over its keys of q·k·scale + bias, the weights p rounded to v's
// dtype before the product with V (accumulated in f32), and its o
// normalised by its own mass l and rounded to q's dtype, with m and l in
// f32. The fully masked guard is the reference's: m_safe = 0 where m <=
// NEG_INF/2, alpha = 0 while no live key was seen, norm = 1 where l <= 0, so
// a split, a page or a whole row with no live key gives (o, m, l) = (0,
// NEG_INF, 0). The partials are merged with the algebra and guards of
// combine_splits (m_safe, l clamped at 1e-20) in f32, and o is written
// (B, H, hd) in q's dtype with the global m and l. Dense: each block is one
// split, and the cluster sums the splits in split order. Paged: each block
// takes a run of consecutive pages and folds their rounded partials in page
// order into one running (m, Σw, Σw·o), rescaling by exp(m_old − m_new) where
// combine_splits weighs every page against the global max at once (the two
// differ at f32 round-off); the cluster then merges the blocks in block order.
// Neither order depends on which block finishes first.
//
// What bounds them on this card. Decoding one token does two multiply-adds
// per (query head, key, element of the head dim) and reads every live K and
// V element once: about G/2 operations per byte of bf16 K/V, against the
// ~295 at which the H100's tensor cores would become the limit. So both
// kernels are bound by the bytes of K and V. At the serving slice's shapes
// (B 16, 1024 keys a row, KV 2, hd 128, bf16) that is 16.8 MB, 5.0 us at
// 3.35 TB/s; at such a batch one launch's time is mostly launch latency and
// the tail of 256 short blocks.
//
// The common design:
//   * One block per (split, kv head, b) and one thread-block cluster per
//     (kv head, b): at most 8 blocks (the portable cluster size). Each block
//     leaves its partial (o, m, l) in shared memory; after cluster.sync()
//     every block of the cluster merges a share of the G x hd outputs,
//     reading its peers' partials through distributed shared memory, so the
//     partials never reach device memory and no second launch (or torch
//     merge) is needed.
//   * K and V stay in their own type in shared memory and come by cp.async,
//     16 bytes a thread, in rounds of 4 tiles of 32 keys: every live tile of
//     a round is in flight before the first is used, and with room for two
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
//   * Keys, not rows, are split across warps when the group is small: the
//     warps are key groups taking the tiles of a round in turn, each for
//     the G <= 8 query rows of the kv head (G = 1 for zamba2-7b, 6 for
//     Qwen2-1.5B), so every warp's multiply-adds fall on live rows; at G up
//     to 16 (32) two (four) groups of rows share the tiles two (one) ways.
//     Each warp keeps its own (m, l, acc) in f32 registers, lane j owns key
//     j of a tile (a score needs no reduction; the row max and sum come
//     from warp shuffles), and the product with V reads the warp's weights
//     back as float4 broadcasts while lanes split the head dim (lane + 32c).
//     The key groups merge in shared memory, in group order, before the
//     cluster merge.
//   * A tile whose bias is NEG_INF (or below) for every key is skipped, K/V
//     reads included: its logits round to NEG_INF in f32 and add exactly
//     nothing.
//
// The dense kernel: split s holds keys [s·span, (s + 1)·span), taken by the
// key groups a tile each in turn. The ragged tail of a split (W not a
// multiple of blk_k) is masked in the kernel, where the reference pads K, V
// and bias with a copy of the whole cache on every call; the (1, W) bias row
// of a shared position row is read with batch stride 0, not broadcast.
//
// The paged kernel: block s holds logical pages [s·pps, (s + 1)·pps), pps =
// ceil(max_pages / 8), and each key group takes whole pages: a tile of 32
// keys is one unit of 32 / ps pages at page size 8 or 16 (the serving
// slice's 16: two pages a tile), each page's max and sum reduced over its
// own lanes only, or one page of ceil(ps / 32) tiles, whose softmax runs
// online across them. The lane of a key reads page_table[b, j] itself and
// clamps -1 (unmapped) to page 0, as the TPU index map does (only the bias
// masks what it reads); a key whose bias is NEG_INF (or below) is not read
// at all, and a unit with no live key is skipped.
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
constexpr int kRound = kWarps;  // tiles a round, one fetched by each warp
constexpr int kMaxSplits = 8;   // blocks a cluster: the portable cluster size
constexpr int kMaxSmem = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;

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

// x rounded to T, as the reference's .astype(T).
template <class T>
__device__ __forceinline__ float to_type(float x) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16(x));
  return x;
}

// Max and sum over aligned groups of ``seg`` lanes (a power of two up to 32).
__device__ __forceinline__ float seg_max(float x, int seg) {
  for (int o = seg >> 1; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float seg_sum(float x, int seg) {
  for (int o = seg >> 1; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

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

// Shared memory of one block: the K and V rings (nbuf rounds of kRound
// tiles each), the group's query rows in f32, the warps' weights, the
// rounds' bias and live flags, and the merge's statistics. After the key
// loop the ring holds the key groups' partial sums and the block's o, and
// then the cluster merge's weights.
template <class T, int HD, int RPW, int WK>
struct Smem {
  static constexpr int ROWS = kWarps / WK * RPW;
  static constexpr int kSlot = kKeys * HD;  // elements of one K (or V) tile
  __host__ __device__ static constexpr size_t bytes(int nbuf) {
    return sizeof(T) * (size_t)2 * nbuf * kRound * kSlot +
           sizeof(float) * ((size_t)ROWS * HD + kWarps * RPW * kKeys +
                            (size_t)nbuf * kRound * kKeys + 2 * WK * ROWS + 2 * ROWS) +
           sizeof(int) * (size_t)nbuf * kRound;
  }
  // the merge's scratch fits in one round of the ring
  static_assert(sizeof(float) * (WK + 1) * ROWS * HD <= sizeof(T) * 2 * kRound * kSlot &&
                    (kMaxSplits + 1) * ROWS <= WK * ROWS * HD,
                "merge scratch exceeds the ring");

  T* K;          // nbuf x kRound tiles
  T* V;          // nbuf x kRound tiles
  float* Q;      // ROWS x HD
  float* P;      // per warp RPW x kKeys weights
  float* bias;   // nbuf x kRound x kKeys
  float* m;      // WK x ROWS: each key group's m, then its scale
  float* l;      // WK x ROWS: each key group's l
  float* pm;     // ROWS: the block's m
  float* pl;     // ROWS: the block's l
  int* live;     // nbuf x kRound
  float* acc;    // after the loop: WK x ROWS x HD
  float* part;   // after the loop: ROWS x HD, the block's o
  float* w;      // after the block's partial: (kMaxSplits + 1) x ROWS merge weights

  __device__ __forceinline__ Smem(float4* base, int nbuf) {
    K = reinterpret_cast<T*>(base);
    V = K + nbuf * kRound * kSlot;
    Q = reinterpret_cast<float*>(V + nbuf * kRound * kSlot);
    P = Q + ROWS * HD;
    bias = P + kWarps * RPW * kKeys;
    m = bias + nbuf * kRound * kKeys;
    l = m + WK * ROWS;
    pm = l + WK * ROWS;
    pl = pm + ROWS;
    live = reinterpret_cast<int*>(pl + ROWS);
    acc = reinterpret_cast<float*>(base);
    part = acc + WK * ROWS * HD;
    w = acc;
  }
};

// The group's query rows into shared memory as f32 rows of HD (rows past G
// and columns past hd zero): their loads go out before ``first`` (the first
// round's bias and K/V loads) and land while those are in flight.
template <class T, int HD, int ROWS, class F>
__device__ __forceinline__ void stage_group(float* sQ, const T* qb, int G, int hd, F&& first) {
  constexpr int C = 16 / sizeof(T), QCH = HD / C, NQ = (ROWS * QCH + kThreads - 1) / kThreads;
  uint4 qr[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const int idx = threadIdx.x + i * kThreads, r = idx / QCH, c = (idx - r * QCH) * C;
    qr[i] = idx < ROWS * QCH && r < G && c < hd
                ? *reinterpret_cast<const uint4*>(qb + (int64_t)r * hd + c)
                : make_uint4(0u, 0u, 0u, 0u);
  }
  first();
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
}

// s[r] = <query row r of the warp, key ``lane`` of the tile>; the query rows
// are read as broadcasts (no padding needed).
template <class T, int HD, int RPW>
__device__ __forceinline__ void scores(float (&s)[RPW], const float* wQ, const T* cK, int lane) {
  constexpr int C = 16 / sizeof(T);
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
}

// One tile's step of each row's online softmax over segments of ``seg``
// lanes: logits = (q·k)·scale + bias with two roundings, as in the
// reference (a key that was not read has s = 0 and bias NEG_INF, so its
// logit is NEG_INF and its weight exactly 0); the weights, rounded to T,
// go to the warp's row of wP.
template <class T, int HD, int RPW>
__device__ __forceinline__ void softmax_step(const float (&s)[RPW], float bv, float scale,
                                             int seg, float (&m)[RPW], float (&l)[RPW],
                                             float (&acc)[RPW][HD / 32], float* wP, int lane) {
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const float x = __fadd_rn(__fmul_rn(s[r], scale), bv);
    const float m_new = fmaxf(m[r], seg_max(x, seg));
    const float m_safe = m_new <= kNegInf / 2 ? 0.f : m_new;
    const float p = expf(x - m_safe);  // masked keys: exactly 0
    const float alpha = m[r] <= kNegInf / 2 ? 0.f : expf(m[r] - m_safe);
    l[r] = alpha * l[r] + seg_sum(p, seg);
#pragma unroll
    for (int c = 0; c < HD / 32; ++c) acc[r][c] *= alpha;
    m[r] = m_new;
    wP[r * kKeys + lane] = to_type<T>(p);
  }
}

// acc[r][c] += Σ_j wP[r][j] · V[j][lane + 32c] over keys [j0, j1) of the
// tile (a multiple of 4 of them).
template <class T, int HD, int RPW>
__device__ __forceinline__ void pv(float (&acc)[RPW][HD / 32], const float* wP, const T* cV,
                                   int lane, int j0, int j1) {
  constexpr int DPL = HD / 32;
#pragma unroll 2
  for (int jk = j0; jk < j1; jk += 4) {
    float vv[4][DPL];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int c = 0; c < DPL; ++c) vv[jj][c] = to_f32(cV[tile_at<T, HD>(jk + jj, lane + 32 * c)]);
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
}

// The end of both kernels. Each warp holds (acc, m, l) of its rows over the
// keys it took, acc unnormalised against m. The key groups' partials are
// merged in group order into the block's (o, m, l), o normalised by the
// block's l and, under ROUND (the dense kernel's split, as the reference
// stores it), rounded to T. Then the cluster's merge, combine_splits'
// algebra, every block read in block order through distributed shared
// memory: each block weighs the blocks of every row, then takes a share of
// the G x hd outputs.
template <class T, int HD, int RPW, int WK, bool ROUND>
__device__ __forceinline__ void finish(const FdArgs& a, const Smem<T, HD, RPW, WK>& sm,
                                       float (&acc)[RPW][HD / 32], const float (&m)[RPW],
                                       const float (&l)[RPW], int wr, int wk, int lane) {
  constexpr int ROWS = Smem<T, HD, RPW, WK>::ROWS, DPL = HD / 32;
  auto rounded = [](float x) { return ROUND ? to_type<T>(x) : x; };
  if (WK == 1) {
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = wr * RPW + r;
      const float norm = l[r] <= 0.f ? 1.f : l[r];
#pragma unroll
      for (int c = 0; c < DPL; ++c) sm.part[row * HD + lane + 32 * c] = rounded(acc[r][c] / norm);
      if (lane == 0) {
        sm.pm[row] = m[r];
        sm.pl[row] = l[r];
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = wr * RPW + r;
#pragma unroll
      for (int c = 0; c < DPL; ++c) sm.acc[(wk * ROWS + row) * HD + lane + 32 * c] = acc[r][c];
      if (lane == 0) {
        sm.m[wk * ROWS + row] = m[r];
        sm.l[wk * ROWS + row] = l[r];
      }
    }
    __syncthreads();
    // per row: the block's m and l, and each key group's scale in place of its m
    for (int row = threadIdx.x; row < ROWS; row += kThreads) {
      float mx = kNegInf;
#pragma unroll
      for (int k = 0; k < WK; ++k) mx = fmaxf(mx, sm.m[k * ROWS + row]);
      const float ms = mx <= kNegInf / 2 ? 0.f : mx;
      float lsum = 0.f;
#pragma unroll
      for (int k = 0; k < WK; ++k) {
        const float mk = sm.m[k * ROWS + row];
        const float e = mk <= kNegInf / 2 ? 0.f : expf(mk - ms);
        lsum = fmaf(e, sm.l[k * ROWS + row], lsum);
        sm.m[k * ROWS + row] = e;
      }
      sm.pm[row] = mx;
      sm.pl[row] = lsum;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < ROWS * HD; idx += kThreads) {
      const int row = idx / HD;
      float o = 0.f;
#pragma unroll
      for (int k = 0; k < WK; ++k) o = fmaf(sm.m[k * ROWS + row], sm.acc[k * ROWS * HD + idx], o);
      const float norm = sm.pl[row] <= 0.f ? 1.f : sm.pl[row];
      sm.part[idx] = rounded(o / norm);
    }
  }

  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int split = blockIdx.x, ns = gridDim.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KV;
  for (int g = threadIdx.x; g < G; g += kThreads) {
    float mg = kNegInf;
    for (int s = 0; s < ns; ++s) mg = fmaxf(mg, cluster.map_shared_rank(sm.pm, s)[g]);
    const float m_safe = mg <= kNegInf / 2 ? 0.f : mg;
    float lg = 0.f;
    for (int s = 0; s < ns; ++s) {
      const float w = cluster.map_shared_rank(sm.pl, s)[g] *
                      expf(cluster.map_shared_rank(sm.pm, s)[g] - m_safe);
      sm.w[s * ROWS + g] = w;
      lg += w;
    }
    sm.w[kMaxSplits * ROWS + g] = fmaxf(lg, 1e-20f);
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
    for (int s = 0; s < ns; ++s)
      o += cluster.map_shared_rank(sm.part, s)[g * HD + d] * sm.w[s * ROWS + g];
    store1(out + idx, o / sm.w[kMaxSplits * ROWS + g]);
  }
  cluster.sync();  // no block leaves while a peer may still read its shared memory
}

// ------------------------------------------------------------- dense --
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

template <class T, int HD, int RPW, int WK>
__global__ void __launch_bounds__(kThreads) fd_dense_kernel(const FdArgs a, const int nbuf) {
  using Sm = Smem<T, HD, RPW, WK>;
  constexpr int kSlot = Sm::kSlot, DPL = HD / 32;
  extern __shared__ float4 smem4[];
  const Sm sm(smem4, nbuf);
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
  // stands between the bias and the loads. Keys past the split read bias
  // NEG_INF and zero rows.
  auto fetch = [&](int r) {
    const int slot = (r % nbuf) * kRound + warp, t0 = (r * kRound + warp) * kKeys;
    const float bv = t0 + lane < n_keys ? bias[t0 + lane] : kNegInf;
    sm.bias[slot * kKeys + lane] = bv;
    const bool live = __any_sync(kFull, bv > kNegInf);
    if (lane == 0) sm.live[slot] = live;
    if (live) {
      stage_tile_async<T, HD>(sm.K + slot * kSlot, kb + t0 * kstride, kstride, n_keys - t0,
                              a.hd, lane);
      stage_tile_async<T, HD>(sm.V + slot * kSlot, vb + t0 * kstride, kstride, n_keys - t0,
                              a.hd, lane);
    }
    cp_async_commit();
  };
  stage_group<T, HD, Sm::ROWS>(sm.Q, qb, G, a.hd, [&] { fetch(0); });

  float acc[RPW][DPL], m[RPW], l[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }
  const float* wQ = sm.Q + wr * RPW * HD;
  float* wP = sm.P + warp * RPW * kKeys;
  for (int rd = 0; rd < n_rounds; ++rd) {
    if (nbuf == 2 && rd + 1 < n_rounds) {
      fetch(rd + 1);
      cp_async_wait_one();  // round rd has landed, rd + 1 is in flight
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    for (int j = wk; j < kRound; j += WK) {
      const int slot = (rd % nbuf) * kRound + j;
      if (!sm.live[slot]) continue;  // the same in every warp of a key group
      float s[RPW];
      scores<T, HD, RPW>(s, wQ, sm.K + slot * kSlot, lane);
      softmax_step<T, HD, RPW>(s, sm.bias[slot * kKeys + lane], a.scale, kKeys, m, l, acc, wP,
                               lane);
      __syncwarp();
      pv<T, HD, RPW>(acc, wP, sm.V + slot * kSlot, lane, 0, kKeys);
      __syncwarp();  // the weights are read before the next tile writes them
    }
    __syncthreads();  // every warp is done with round rd's stage
    if (nbuf == 1 && rd + 1 < n_rounds) fetch(rd + 1);
  }
  finish<T, HD, RPW, WK, true>(a, sm, acc, m, l, wr, wk, lane);
}

// ------------------------------------------------------------- paged --
// How the pages of one (kv head, b) are laid out: runs of ``pps``
// consecutive logical pages to the cluster's ``nsb`` blocks; in a block,
// units of ``ppt`` pages in one tile (ps 8 and 16: ``seg`` = ps lanes a
// page) or of ``tpp`` tiles of one page (``seg`` = 32) go to the key groups
// in turn, the k-th unit of a group taking its next ``tpp`` tiles.
struct PagedLayout {
  int pps, nsb, seg, ppt, tpp;
  __host__ __device__ PagedLayout(int maxp, int ps)
      : pps((maxp + kMaxSplits - 1) / kMaxSplits), nsb((maxp + pps - 1) / pps),
        seg(ps == 8 || ps == 16 ? ps : kKeys), ppt(kKeys / seg),
        tpp(seg == kKeys ? (ps + kKeys - 1) / kKeys : 1) {}
  // rounds of a block of npb pages whose WK key groups take kRound / WK
  // tiles a round each
  __host__ __device__ int rounds(int npb, int WK) const {
    const int units = (npb + ppt - 1) / ppt, per_round = kRound / WK;
    return ((units + WK - 1) / WK * tpp + per_round - 1) / per_round;
  }
};

// Blocks of the paged kernel an SM should hold: 3 (the dense kernel's
// occupancy at the serving slice) where one round's shared memory lets them
// fit, so that ptxas keeps a thread's registers to 168; else no bound.
template <class T, int HD, int RPW, int WK>
constexpr int paged_min_blocks() {
  return 3 * Smem<T, HD, RPW, WK>::bytes(1) <= (size_t)kMaxSmem ? 3 : 1;
}

template <class T, int HD, int RPW, int WK>
__global__ void __launch_bounds__(kThreads, (paged_min_blocks<T, HD, RPW, WK>()))
    fd_paged_kernel(const FdArgs a, const int nbuf) {
  using Sm = Smem<T, HD, RPW, WK>;
  constexpr int kSlot = Sm::kSlot, C = 16 / sizeof(T), CH = HD / C, DPL = HD / 32;
  extern __shared__ float4 smem4[];
  const Sm sm(smem4, nbuf);
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp / WK, wk = warp % WK;
  const int G = a.H / a.KV, ps = a.span, maxp = a.ns;
  const PagedLayout L(maxp, ps);
  const int p0 = split * L.pps, npb = min(L.pps, maxp - p0);  // this block's pages
  const int n_rounds = L.rounds(npb, WK), per_round = kRound / WK;
  const int64_t kstride = (int64_t)a.KV * a.hd;  // elements between neighbouring keys
  const T* kp = static_cast<const T*>(a.k) + (int64_t)kvh * a.hd;
  const T* vp = static_cast<const T*>(a.v) + (int64_t)kvh * a.hd;
  const float* bias = a.bias + ((int64_t)b * maxp + p0) * ps;
  const int* tbl = a.page_table + (int64_t)b * maxp + p0;
  const T* qb = static_cast<const T*>(a.q) + ((int64_t)b * a.H + (int64_t)kvh * G) * a.hd;

  // Slot j of round rd: the key group j % WK's tile at position pos of its
  // stream, tile ti of its unit.
  auto locate = [&](int rd, int j, int& unit, int& ti) {
    const int pos = rd * per_round + j / WK;
    unit = j % WK + WK * (pos / L.tpp);
    ti = pos - pos / L.tpp * L.tpp;
  };

  // As the dense kernel's fetch, with each lane's key gathered through the
  // page table: lane = (page unit·ppt + lane / seg of the block, key ti·32 +
  // lane % seg of the page). A key past the block's pages or past the page
  // reads bias NEG_INF; a key whose bias is NEG_INF (or below) is not read.
  auto fetch = [&](int r) {
    const int slot = (r % nbuf) * kRound + warp;
    int unit, ti;
    locate(r, warp, unit, ti);
    const int pg = unit * L.ppt + lane / L.seg, key = ti * kKeys + lane % L.seg;
    float bv = kNegInf;
    int64_t row = 0;
    if (pg < npb && key < ps) {
      bv = bias[pg * ps + key];
      const int page = min(max(tbl[pg], 0), a.P - 1);  // -1 (unmapped) reads page 0
      row = ((int64_t)page * ps + key) * kstride;
    }
    sm.bias[slot * kKeys + lane] = bv;
    const int live = bv > kNegInf;
    const bool any = __any_sync(kFull, live);
    if (lane == 0) sm.live[slot] = any;
    if (any) {
#pragma unroll 4
      for (int idx = lane; idx < kKeys * CH; idx += 32) {
        const int rr = idx / CH, c = (idx - rr * CH) * C;
        const int64_t src = __shfl_sync(kFull, row, rr);
        const bool ok = __shfl_sync(kFull, live, rr) && c < a.hd;
        const int at = slot * kSlot + tile_at<T, HD>(rr, c);
        cp_async16(sm.K + at, ok ? kp + src + c : kp, ok);
        cp_async16(sm.V + at, ok ? vp + src + c : vp, ok);
      }
    }
    cp_async_commit();
  };
  stage_group<T, HD, Sm::ROWS>(sm.Q, qb, G, a.hd, [&] { fetch(0); });

  // (m, l, acc) of the unit in hand (each lane: the page of its segment),
  // and the warp's fold of its finished pages: fa = Σ w·o against the
  // running max, whose value fm and Σ w fl lane r holds for row r.
  float acc[RPW][DPL], m[RPW], l[RPW], fa[RPW][DPL], fm = kNegInf, fl = 0.f;
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int c = 0; c < DPL; ++c) fa[r][c] = 0.f;
  // Fold a page with a live key whose (m, l) the lanes of segment ``src``
  // hold: its o = acc · (1/l) rounded to T, as the reference stores a
  // page's partial (acc / l, within an f32 ulp). Lane r does row r's
  // scalar work (lanes past RPW fold nothing), then broadcasts it.
  auto fold = [&](int src) {
    float mp = kNegInf, lp = 0.f;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const float mr = __shfl_sync(kFull, m[r], src), lr = __shfl_sync(kFull, l[r], src);
      if (lane == r) {
        mp = mr;
        lp = lr;
      }
    }
    const float m_new = fmaxf(fm, mp);
    const float m_safe = m_new <= kNegInf / 2 ? 0.f : m_new;
    const float keep = fm <= kNegInf / 2 ? 0.f : expf(fm - m_safe);
    const float w = lp * expf(mp - m_safe);
    const float inv = 1.f / (lp <= 0.f ? 1.f : lp);
    fl = keep * fl + w;
    fm = m_new;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const float keep_r = __shfl_sync(kFull, keep, r), w_r = __shfl_sync(kFull, w, r);
      const float inv_r = __shfl_sync(kFull, inv, r);
#pragma unroll
      for (int c = 0; c < DPL; ++c)
        fa[r][c] = keep_r * fa[r][c] + w_r * to_type<T>(acc[r][c] * inv_r);
    }
  };
  const float* wQ = sm.Q + wr * RPW * HD;
  float* wP = sm.P + warp * RPW * kKeys;
  for (int rd = 0; rd < n_rounds; ++rd) {
    if (nbuf == 2 && rd + 1 < n_rounds) {
      fetch(rd + 1);
      cp_async_wait_one();  // round rd has landed, rd + 1 is in flight
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    for (int j = wk; j < kRound; j += WK) {
      int unit, ti;
      locate(rd, j, unit, ti);
      if (unit * L.ppt >= npb) continue;  // past the block's pages
      const int slot = (rd % nbuf) * kRound + j;
      if (ti == 0) {
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          m[r] = kNegInf;
          l[r] = 0.f;
#pragma unroll
          for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
        }
      }
      if (sm.live[slot]) {  // the same in every warp of a key group
        const T* cV = sm.V + slot * kSlot;
        float s[RPW];
        scores<T, HD, RPW>(s, wQ, sm.K + slot * kSlot, lane);
        softmax_step<T, HD, RPW>(s, sm.bias[slot * kKeys + lane], a.scale, L.seg, m, l, acc,
                                 wP, lane);
        __syncwarp();
        if (L.ppt == 1) {
          pv<T, HD, RPW>(acc, wP, cV, lane, 0, min(kKeys, ps - ti * kKeys));
        } else {
          for (int q = 0; q < L.ppt; ++q) {  // the tile's pages in page order
            if (!(__shfl_sync(kFull, m[0], q * L.seg) > kNegInf / 2)) continue;
#pragma unroll
            for (int r = 0; r < RPW; ++r)
#pragma unroll
              for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
            pv<T, HD, RPW>(acc, wP, cV, lane, q * L.seg, (q + 1) * L.seg);
            fold(q * L.seg);
          }
        }
        __syncwarp();  // the weights are read before the next tile writes them
      }
      // the page's last tile, if the page had a live key
      if (L.ppt == 1 && ti == L.tpp - 1 && __shfl_sync(kFull, m[0], 0) > kNegInf / 2) fold(0);
    }
    __syncthreads();  // every warp is done with round rd's stage
    if (nbuf == 1 && rd + 1 < n_rounds) fetch(rd + 1);
  }
  float rm[RPW], rl[RPW];  // each row's (max, Σ w), as finish takes them
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    rm[r] = __shfl_sync(kFull, fm, r);
    rl[r] = __shfl_sync(kFull, fl, r);
  }
  finish<T, HD, RPW, WK, false>(a, sm, fa, rm, rl, wr, wk, lane);
}

// -------------------------------------------------------------- launch --
// One cluster of nsb blocks per (kv head, b); two rounds of ring when a
// block has more than one round and they fit.
template <class T, int HD, int RPW, int WK>
int launch(const FdArgs& a, int paged, cudaStream_t stream) {
  using Sm = Smem<T, HD, RPW, WK>;
  int nsb = a.ns;
  bool more = a.span > kRound * kKeys;
  if (paged) {
    const PagedLayout L(a.ns, a.span);
    nsb = L.nsb;
    more = L.rounds(L.pps, WK) > 1;
  }
  const int nbuf = more && Sm::bytes(2) <= (size_t)kMaxSmem ? 2 : 1;
  const size_t smem = Sm::bytes(nbuf);
  void (*kern)(const FdArgs, const int) =
      paged ? &fd_paged_kernel<T, HD, RPW, WK> : &fd_dense_kernel<T, HD, RPW, WK>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsb, a.KV, a.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsb;  // the blocks of one (kv head, b)
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
int launch_rows(const FdArgs& a, int paged, cudaStream_t stream) {
  const int G = a.H / a.KV;
  if (G <= 1) return launch<T, HD, 1, 4>(a, paged, stream);
  if (G <= 2) return launch<T, HD, 2, 4>(a, paged, stream);
  if (G <= 4) return launch<T, HD, 4, 4>(a, paged, stream);
  if (G <= 8) return launch<T, HD, 8, 4>(a, paged, stream);
  if (G <= 16) return launch<T, HD, 8, 2>(a, paged, stream);
  if (G <= 32) return launch<T, HD, 8, 1>(a, paged, stream);
  return (int)cudaErrorInvalidValue;
}

// The register and shared-memory width: the smallest of 32, 64 and 128 at
// or above the head dim, which may be any multiple of 8 up to 128.
template <class T>
int dispatch_hd(const FdArgs& a, int paged, cudaStream_t stream) {
  if (a.hd < 8 || a.hd > 128 || a.hd % 8) return (int)cudaErrorInvalidValue;
  if (paged ? (a.ns < 1 || a.span < 8 || a.span > 128 || a.span % 8 || a.P < 1)
            : (a.ns < 1 || a.ns > kMaxSplits))
    return (int)cudaErrorInvalidValue;
  if (a.hd <= 32) return launch_rows<T, 32>(a, paged, stream);
  if (a.hd <= 64) return launch_rows<T, 64>(a, paged, stream);
  return launch_rows<T, 128>(a, paged, stream);
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
