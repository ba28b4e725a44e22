// Split-K flash decode for Hopper (sm_90a): one query row per sequence
// against a dense rolling KV cache or a shared page pool; plain C interface
// (flash_decode.h).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_decode.py:
//   fd_kernel, dense <- _fd_kernel / flash_decode              per-split (o, m, l)
//   fd_kernel, paged <- _fd_paged_kernel / flash_decode_paged  per-page (o, m, l)
// Each block computes what one TPU split computes: an online softmax over
// its keys of q·k·scale + bias, the weights p rounded to v's dtype before
// the product with V (accumulated in f32), and the split's o normalised by
// its own mass l, stored in q's dtype, with m and l in f32. The fully
// masked guard is the reference's: m_safe = 0 where m <= NEG_INF/2,
// alpha = 0 while no live key was seen, norm = 1 where l <= 0, so a split
// (or a whole row) with no live key gives (o, m, l) = (0, NEG_INF, 0). The
// splits are merged outside, in torch (kernels/flash_decode.py
// combine_splits), as the reference merges them in jnp.
//
// What bounds them on this card. Decoding one token does two multiply-adds
// per (query head, key, element of the head dim) and reads every live K and
// V element once: about G/2 operations per byte of bf16 K/V, against the
// ~295 at which the H100's tensor cores would become the limit. So both
// kernels are bound by the bytes of K and V. At the serving slice's dense
// shape (B 16, W 1024, KV 2, hd 128, bf16) that is 16.8 MB, 5.0 us at
// 3.35 TB/s; at such a batch one launch's time is mostly launch latency and
// the tail of 256 short blocks. What the design does about the bytes:
//   * One block per (b, kv head, split): the TPU grid's sequential axis
//     (n_inner key blocks, carried in VMEM scratch) becomes a loop over
//     tiles of 32 keys inside the block, with m, l and acc in f32
//     registers. The paged kernel's block reads page_table[b, j] itself
//     and clamps -1 (unmapped) to page 0, as the TPU index map does; only
//     the bias masks what it reads.
//   * GQA: the G query rows of one kv head share each K/V tile the block
//     stages, so K and V are read from device memory once per kv head,
//     not once per query head. Warp w owns rows [w*RPW, (w+1)*RPW) of the
//     group; lane j owns key j of the tile, so a score needs no reduction,
//     and the row max and row sum come from warp shuffles. The product
//     with V reads the warp's weights back as float4 broadcasts while lanes
//     split the head dim (lane + 32c), so V reads and o writes coalesce.
//   * Loads are 16 bytes a thread over neighbouring elements of a row;
//     tiles are widened to f32 rows padded to HD + 4 floats in shared
//     memory, so lane j's float4 reads of row j hit distinct banks. HD, the
//     register width, is 32, 64 or 128, the smallest at or above the head
//     dim hd (any multiple of 8 up to 128: 16-byte loads in f32 and bf16);
//     columns [hd, HD) are staged as zeros and never stored, and every
//     stride and offset in memory is hd's.
//   * A tile whose bias is NEG_INF (or below) for every key is skipped,
//     K/V reads included: its logits round to NEG_INF in f32 and add
//     exactly nothing. Unmapped pages, inactive slots and the empty part
//     of a rolling window cost one read of their bias.
//   * The ragged tail of a dense split (W not a multiple of blk_k) is
//     masked in the kernel, where the reference pads K, V and bias with a
//     copy of the whole cache on every call; the (1, W) bias row of a
//     shared position row is read with batch stride 0, not broadcast.
//
// Kernels launch on the caller's stream and allocate nothing; the binding
// (cg_fused_bind.cpp) allocates the outputs and checks every launch.

#include "flash_decode.h"

#include <cuda_bf16.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 32;  // keys per tile, one per lane

// 16 bytes of a row as floats.
__device__ __forceinline__ void load16(const float* p, float* x) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* x) {
  // Eight bf16 values as four 32-bit words; element 2i is the low half of word i.
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  x[0] = __uint_as_float(u.x << 16);
  x[1] = __uint_as_float(u.x & 0xffff0000u);
  x[2] = __uint_as_float(u.y << 16);
  x[3] = __uint_as_float(u.y & 0xffff0000u);
  x[4] = __uint_as_float(u.z << 16);
  x[5] = __uint_as_float(u.z & 0xffff0000u);
  x[6] = __uint_as_float(u.w << 16);
  x[7] = __uint_as_float(u.w & 0xffff0000u);
}

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

template <class T, int HD, int RPW>
__global__ void __launch_bounds__(kThreads) fd_kernel(const FdArgs a, const int paged) {
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

  const T* kb;
  const T* vb;
  const float* bias;
  int n_keys;
  if (paged) {
    int page = a.page_table[(int64_t)b * a.ns + split];
    page = min(max(page, 0), a.P - 1);  // -1 (unmapped) reads page 0, masked by the bias
    const int64_t off = (int64_t)page * a.span * kstride + (int64_t)kvh * a.hd;
    kb = static_cast<const T*>(a.k) + off;
    vb = static_cast<const T*>(a.v) + off;
    bias = a.bias + ((int64_t)b * a.ns + split) * a.span;
    n_keys = a.span;
  } else {
    const int k0 = split * a.span;
    const int64_t off = ((int64_t)b * a.W + k0) * kstride + (int64_t)kvh * a.hd;
    kb = static_cast<const T*>(a.k) + off;
    vb = static_cast<const T*>(a.v) + off;
    bias = a.bias + (int64_t)(a.bias_b > 1 ? b : 0) * a.W + k0;
    n_keys = min(a.span, a.W - k0);
  }
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

template <class T, int HD, int RPW>
int launch(const FdArgs& a, int paged, cudaStream_t stream) {
  constexpr int LD = HD + 4, ROWS = kWarps * RPW;
  const size_t smem =
      sizeof(float) * ((size_t)(ROWS + 2 * kKeys) * LD + (size_t)ROWS * kKeys);
  void (*kern)(const FdArgs, const int) = fd_kernel<T, HD, RPW>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(a.ns, a.KV, a.B);
  kern<<<grid, kThreads, smem, stream>>>(a, paged);
  return (int)cudaGetLastError();
}

template <class T, int HD>
int dispatch_rows(const FdArgs& a, int paged, cudaStream_t stream) {
  const int G = a.H / a.KV;
  if (G <= 2 * kWarps) return launch<T, HD, 2>(a, paged, stream);
  if (G <= 4 * kWarps) return launch<T, HD, 4>(a, paged, stream);
  if (G <= 8 * kWarps) return launch<T, HD, 8>(a, paged, stream);
  return (int)cudaErrorInvalidValue;
}

// The register and shared-memory width: the smallest of 32, 64 and 128 at
// or above the head dim, which may be any multiple of 8 up to 128.
template <class T>
int dispatch_hd(const FdArgs& a, int paged, cudaStream_t stream) {
  if (a.hd < 8 || a.hd > 128 || a.hd % 8) return (int)cudaErrorInvalidValue;
  if (a.hd <= 32) return dispatch_rows<T, 32>(a, paged, stream);
  if (a.hd <= 64) return dispatch_rows<T, 64>(a, paged, stream);
  return dispatch_rows<T, 128>(a, paged, stream);
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
