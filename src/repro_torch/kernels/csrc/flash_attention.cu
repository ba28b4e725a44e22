// Flash attention for Hopper (sm_90a): forward, dQ, dK/dV and JVP passes,
// plain C interface (flash_attention.h).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_attention.py:
//   fa_forward_kernel <- _fa_kernel / flash_attention_fwd      o, lse
//   fa_dq_kernel      <- _fa_dq_kernel / flash_attention_dq    dQ
//   fa_dkv_kernel     <- _fa_dkv_kernel / flash_attention_dkv  dK, dV per q-head
//   fa_jvp_kernel     <- _fa_jvp_kernel / flash_attention_jvp  g, t
// Each computes what its TPU kernel computes: causal, sliding-window and
// valid_len masks, GQA (kv head = h / (H / KV)), the optional additive f32
// bias (B|1, Sq, Sk), and the fully-masked-row guard (m_safe; lse = 0, o = 0).
//
// What bounds them on this card. At the training shapes (hd 64, S 512) a
// pass reads each of its inputs once and does about S/2 multiply-adds per
// element of Q (causal): well above the bytes, so a kernel that stays out of
// device memory is bound by its arithmetic. The tensor cores would take
// that arithmetic at 989 TFLOP/s in bf16; these kernels run it as f32 FFMA
// from shared memory (67 TFLOP/s), which is the simple and exact first form.
// What the design does about the rest:
//   * The TPU grid's sequential innermost axis (key blocks for forward, dQ
//     and JVP; query blocks for dK/dV) and its VMEM scratch become a loop
//     inside one CUDA block, with the m/l/acc recurrence in f32 registers.
//     One block per (b, h, 32-row tile); every output element is written by
//     exactly one block, with no float atomics, so the results are as
//     deterministic as the reference's.
//   * Tiles of 32 rows are staged in shared memory as f32 (bf16 inputs are
//     widened on load), rows padded to HD + 4 floats so that lane j reading
//     row j as float4 hits distinct banks. HD, the register width, is 32, 64
//     or 128, the smallest at or above the head dim hd (any multiple of 8 up
//     to 128); columns [hd, HD) are staged as zeros and never stored, and
//     every stride and offset in memory is hd's. Warp w owns 8 rows of its block's
//     side; lane j owns row j of the staged tile on the other side, so the
//     32-wide score row of a warp comes from float4 dot products with no
//     reduction, and its softmax statistics from warp shuffles. The product
//     with V (or K, Q, dO) reads the scores back from shared memory as
//     float4 broadcasts while lanes split the head dim (lane + 32c), so
//     loads and stores of the outputs are coalesced.
//   * Key tiles that the causal or window test masks wholly are skipped
//     (the TPU kernel runs them as no-ops), as are tiles past valid_len.
//   * P is recomputed from the stored logsumexp in dQ, dK/dV and JVP; the
//     (S, S) weights never reach device memory.
// Left outside, as in the reference: Δ = rowsum(dO * O), the GQA group-sum
// of dK/dV and ȯ = g − t * o.
//
// Kernels launch on the caller's stream and allocate nothing; the binding
// (cg_fused_bind.cpp) allocates the outputs and checks every launch.

#include "flash_attention.h"

#include <cuda_bf16.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 8;              // rows of the block's own side per warp
constexpr int kTile = kWarps * kRows; // rows of the block's own side (32)
constexpr int kCols = 32;             // rows of the other side per inner tile (one per lane)

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  // Four bf16 values as two 32-bit words; element 0 is the low half of x.
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows [r0, r0 + 32) of a (rows, row_stride) tensor, hd values each, into
// shared memory as f32 rows of HD + 4 (HD >= hd, the register width);
// rows at or past n and columns [hd, HD) are zero, so they add exact zeros
// to every dot product.
template <class T, int HD>
__device__ __forceinline__ void stage(float* sm, const T* base, int64_t row_stride, int r0,
                                      int n, int hd) {
  constexpr int LD = HD + 4, V = HD / 4;
  for (int idx = threadIdx.x; idx < kCols * V; idx += kThreads) {
    const int r = idx / V, c = (idx - r * V) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n && c < hd) x = load4(base + (int64_t)(r0 + r) * row_stride + c);
    *reinterpret_cast<float4*>(sm + r * LD + c) = x;
  }
}

// s[r] = <rows[r], col> for the warp's kRows rows (read as broadcasts) and
// the lane's own row ``col`` of the other side.
template <int HD>
__device__ __forceinline__ void dots(float (&s)[kRows], const float* rows, const float* col) {
  constexpr int LD = HD + 4;
#pragma unroll
  for (int r = 0; r < kRows; ++r) s[r] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    const float4 c = *reinterpret_cast<const float4*>(col + d);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(rows + r * LD + d);
      s[r] = fmaf(x.x, c.x, s[r]);
      s[r] = fmaf(x.y, c.y, s[r]);
      s[r] = fmaf(x.z, c.z, s[r]);
      s[r] = fmaf(x.w, c.w, s[r]);
    }
  }
}

// acc[r][c] += sum_j w[r][j] * M[j][lane + 32c] over the kCols staged rows
// of M; w is the warp's (kRows, kCols) block of weights in shared memory.
template <int HD>
__device__ __forceinline__ void accumulate(float (&acc)[kRows][HD / 32], const float* w,
                                           const float* M, int lane) {
  constexpr int LD = HD + 4, DPL = HD / 32;
#pragma unroll 2
  for (int j = 0; j < kCols; j += 4) {
    float mv[4][DPL];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int c = 0; c < DPL; ++c) mv[jj][c] = M[(j + jj) * LD + lane + 32 * c];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 wr = *reinterpret_cast<const float4*>(w + r * kCols + j);
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        acc[r][c] = fmaf(wr.x, mv[0][c], acc[r][c]);
        acc[r][c] = fmaf(wr.y, mv[1][c], acc[r][c]);
        acc[r][c] = fmaf(wr.z, mv[2][c], acc[r][c]);
        acc[r][c] = fmaf(wr.w, mv[3][c], acc[r][c]);
      }
    }
  }
}

// The one mask of the kernels (the semantics of flash_ad.position_mask),
// plus the ragged edges of the staged tiles.
__device__ __forceinline__ bool allowed(const FaArgs& a, int qp, int kp) {
  if (qp >= a.Sq || kp >= a.Sk) return false;
  if (a.causal && kp > qp) return false;
  if (a.has_window && kp <= qp - a.window) return false;
  if (a.valid_len >= 0 && kp >= a.valid_len) return false;
  return true;
}

__device__ __forceinline__ float logit(const FaArgs& a, float s, int b, int qp, int kp) {
  float x = s * a.scale;
  if (a.bias != nullptr) {
    const int bb = a.bias_b > 1 ? b : 0;
    x += a.bias[((int64_t)bb * a.Sq + qp) * a.Sk + kp];
  }
  return x;
}

// Keys a tile of queries [q0, q0 + kTile) can see: the rest are masked for
// every row of the tile.
__device__ __forceinline__ void key_range(const FaArgs& a, int q0, int& kb, int& ke) {
  kb = 0;
  ke = a.Sk;
  if (a.causal) ke = min(ke, q0 + kTile);
  if (a.has_window) kb = max(kb, q0 - a.window + 1);
  if (a.valid_len >= 0) ke = min(ke, a.valid_len);
}

// Queries that can see a tile of keys [k0, k0 + kTile).
__device__ __forceinline__ void query_range(const FaArgs& a, int k0, int& qb, int& qe) {
  qb = 0;
  qe = a.Sq;
  if (a.causal) qb = max(qb, k0);
  if (a.has_window) qe = min(qe, k0 + kTile - 1 + a.window);
  if (a.valid_len >= 0 && k0 >= a.valid_len) qe = qb;
}

struct Heads {
  int64_t q_stride, k_stride;  // elements between sequence positions
  int64_t q_off, k_off;        // start of (b, h) and (b, kv head)
};

__device__ __forceinline__ Heads heads(const FaArgs& a, int b, int h, int hd) {
  Heads x;
  x.q_stride = (int64_t)a.H * hd;
  x.k_stride = (int64_t)a.KV * hd;
  x.q_off = (int64_t)b * a.Sq * x.q_stride + (int64_t)h * hd;
  x.k_off = (int64_t)b * a.Sk * x.k_stride + (int64_t)(h / (a.H / a.KV)) * hd;
  return x;
}

// ------------------------------------------------------------- forward --
template <class T, int HD>
__global__ void __launch_bounds__(kThreads) fa_forward_kernel(const FaArgs a) {
  constexpr int LD = HD + 4, DPL = HD / 32;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kTile * LD;
  float* sV = sK + kCols * LD;
  float* sP = sV + kCols * LD;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Heads hx = heads(a, b, h, a.hd);
  const T* k = static_cast<const T*>(a.k) + hx.k_off;
  const T* v = static_cast<const T*>(a.v) + hx.k_off;
  stage<T, HD>(sQ, static_cast<const T*>(a.q) + hx.q_off, hx.q_stride, q0, a.Sq, a.hd);

  float acc[kRows][DPL], m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }
  float* wP = sP + warp * kRows * kCols;
  int kb, ke;
  key_range(a, q0, kb, ke);
  for (int k0 = kb; k0 < ke; k0 += kCols) {
    __syncthreads();
    stage<T, HD>(sK, k, hx.k_stride, k0, a.Sk, a.hd);
    stage<T, HD>(sV, v, hx.k_stride, k0, a.Sk, a.hd);
    __syncthreads();
    float s[kRows];
    dots<HD>(s, sQ + warp * kRows * LD, sK + lane * LD);
    const int kp = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qp = q0 + warp * kRows + r;
      const bool ok = allowed(a, qp, kp);
      const float x = ok ? logit(a, s[r], b, qp, kp) : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(x));
      // guard fully-masked rows: exp(NEG_INF - NEG_INF) would be 1
      const float m_safe = m_new <= kNegInf / 2 ? 0.f : m_new;
      const float p = ok ? expf(x - m_safe) : 0.f;
      const float alpha = m[r] <= kNegInf / 2 ? 0.f : expf(m[r] - m_safe);
      l[r] = alpha * l[r] + warp_sum(p);
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] *= alpha;
      m[r] = m_new;
      wP[r * kCols + lane] = p;
    }
    __syncwarp();
    accumulate<HD>(acc, wP, sV, lane);
  }

  T* o = static_cast<T*>(a.o) + hx.q_off;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + warp * kRows + r;
    if (qp >= a.Sq) continue;
    const float norm = l[r] <= 0.f ? 1.f : l[r];
#pragma unroll
    for (int c = 0; c < DPL; ++c)
      if (lane + 32 * c < a.hd) store1(o + qp * hx.q_stride + lane + 32 * c, acc[r][c] / norm);
    if (lane == 0) {
      const float m_fin = m[r] <= kNegInf / 2 ? 0.f : m[r];
      a.lse_out[((int64_t)b * a.H + h) * a.Sq + qp] = m_fin + logf(norm);
    }
  }
}

// ------------------------------------------------------------------ dQ --
template <class T, int HD>
__global__ void __launch_bounds__(kThreads) fa_dq_kernel(const FaArgs a) {
  constexpr int LD = HD + 4, DPL = HD / 32;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sDO = sQ + kTile * LD;
  float* sK = sDO + kTile * LD;
  float* sV = sK + kCols * LD;
  float* sS = sV + kCols * LD;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Heads hx = heads(a, b, h, a.hd);
  const T* k = static_cast<const T*>(a.k) + hx.k_off;
  const T* v = static_cast<const T*>(a.v) + hx.k_off;
  stage<T, HD>(sQ, static_cast<const T*>(a.q) + hx.q_off, hx.q_stride, q0, a.Sq, a.hd);
  stage<T, HD>(sDO, static_cast<const T*>(a.dout) + hx.q_off, hx.q_stride, q0, a.Sq, a.hd);

  float acc[kRows][DPL], lse[kRows], delta[kRows];
  const int64_t row0 = ((int64_t)b * a.H + h) * a.Sq;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + warp * kRows + r;
    lse[r] = qp < a.Sq ? a.lse[row0 + qp] : 0.f;
    delta[r] = qp < a.Sq ? a.delta[row0 + qp] : 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }
  float* wS = sS + warp * kRows * kCols;
  int kb, ke;
  key_range(a, q0, kb, ke);
  for (int k0 = kb; k0 < ke; k0 += kCols) {
    __syncthreads();
    stage<T, HD>(sK, k, hx.k_stride, k0, a.Sk, a.hd);
    stage<T, HD>(sV, v, hx.k_stride, k0, a.Sk, a.hd);
    __syncthreads();
    float s[kRows], dp[kRows];
    dots<HD>(s, sQ + warp * kRows * LD, sK + lane * LD);
    dots<HD>(dp, sDO + warp * kRows * LD, sV + lane * LD);  // dO V^T
    const int kp = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qp = q0 + warp * kRows + r;
      const bool ok = allowed(a, qp, kp);
      const float p = ok ? expf(logit(a, s[r], b, qp, kp) - lse[r]) : 0.f;
      wS[r * kCols + lane] = p * (dp[r] - delta[r]);
    }
    __syncwarp();
    accumulate<HD>(acc, wS, sK, lane);  // dS K
  }

  T* dq = static_cast<T*>(a.o) + hx.q_off;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + warp * kRows + r;
    if (qp >= a.Sq) continue;
#pragma unroll
    for (int c = 0; c < DPL; ++c)
      if (lane + 32 * c < a.hd) store1(dq + qp * hx.q_stride + lane + 32 * c, acc[r][c] * a.scale);
  }
}

// --------------------------------------------------------------- dK/dV --
template <class T, int HD>
__global__ void __launch_bounds__(kThreads) fa_dkv_kernel(const FaArgs a) {
  constexpr int LD = HD + 4, DPL = HD / 32;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + kTile * LD;
  float* sQ = sV + kTile * LD;
  float* sDO = sQ + kCols * LD;
  float* sP = sDO + kCols * LD;
  float* sS = sP + kTile * kCols;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Heads hx = heads(a, b, h, a.hd);
  const T* q = static_cast<const T*>(a.q) + hx.q_off;
  const T* dout = static_cast<const T*>(a.dout) + hx.q_off;
  stage<T, HD>(sK, static_cast<const T*>(a.k) + hx.k_off, hx.k_stride, k0, a.Sk, a.hd);
  stage<T, HD>(sV, static_cast<const T*>(a.v) + hx.k_off, hx.k_stride, k0, a.Sk, a.hd);

  float dk[kRows][DPL], dv[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < DPL; ++c) dk[r][c] = dv[r][c] = 0.f;
  const int64_t row0 = ((int64_t)b * a.H + h) * a.Sq;
  float* wP = sP + warp * kRows * kCols;
  float* wS = sS + warp * kRows * kCols;
  int qb, qe;
  query_range(a, k0, qb, qe);
  for (int i0 = qb; i0 < qe; i0 += kCols) {
    __syncthreads();
    stage<T, HD>(sQ, q, hx.q_stride, i0, a.Sq, a.hd);
    stage<T, HD>(sDO, dout, hx.q_stride, i0, a.Sq, a.hd);
    __syncthreads();
    const int qp = i0 + lane;
    const float lse = qp < a.Sq ? a.lse[row0 + qp] : 0.f;
    const float delta = qp < a.Sq ? a.delta[row0 + qp] : 0.f;
    float s[kRows], dp[kRows];
    dots<HD>(s, sK + warp * kRows * LD, sQ + lane * LD);
    dots<HD>(dp, sV + warp * kRows * LD, sDO + lane * LD);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int kp = k0 + warp * kRows + r;
      const bool ok = allowed(a, qp, kp);
      const float p = ok ? expf(logit(a, s[r], b, qp, kp) - lse) : 0.f;
      wP[r * kCols + lane] = p;
      wS[r * kCols + lane] = p * (dp[r] - delta);
    }
    __syncwarp();
    accumulate<HD>(dv, wP, sDO, lane);  // P^T dO
    accumulate<HD>(dk, wS, sQ, lane);   // dS^T Q
  }

  const int64_t o_stride = (int64_t)a.H * a.hd;
  const int64_t o_off = (int64_t)b * a.Sk * o_stride + (int64_t)h * a.hd;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int kp = k0 + warp * kRows + r;
    if (kp >= a.Sk) continue;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      if (lane + 32 * c >= a.hd) continue;
      a.dk[o_off + kp * o_stride + lane + 32 * c] = dk[r][c] * a.scale;
      a.dv[o_off + kp * o_stride + lane + 32 * c] = dv[r][c];
    }
  }
}

// ----------------------------------------------------------------- JVP --
template <class T, int HD>
__global__ void __launch_bounds__(kThreads) fa_jvp_kernel(const FaArgs a) {
  constexpr int LD = HD + 4, DPL = HD / 32;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sQT = sQ + kTile * LD;
  float* sK = sQT + kTile * LD;
  float* sKT = sK + kCols * LD;
  float* sV = sKT + kCols * LD;
  float* sVT = sV + kCols * LD;
  float* sP = sVT + kCols * LD;
  float* sR = sP + kTile * kCols;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Heads hx = heads(a, b, h, a.hd);
  const T* k = static_cast<const T*>(a.k) + hx.k_off;
  const T* kt = static_cast<const T*>(a.kt) + hx.k_off;
  const T* v = static_cast<const T*>(a.v) + hx.k_off;
  const T* vt = static_cast<const T*>(a.vt) + hx.k_off;
  stage<T, HD>(sQ, static_cast<const T*>(a.q) + hx.q_off, hx.q_stride, q0, a.Sq, a.hd);
  stage<T, HD>(sQT, static_cast<const T*>(a.qt) + hx.q_off, hx.q_stride, q0, a.Sq, a.hd);

  float acc[kRows][DPL], lse[kRows], t[kRows];
  const int64_t row0 = ((int64_t)b * a.H + h) * a.Sq;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + warp * kRows + r;
    lse[r] = qp < a.Sq ? a.lse[row0 + qp] : 0.f;
    t[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }
  float* wP = sP + warp * kRows * kCols;
  float* wR = sR + warp * kRows * kCols;
  int kb, ke;
  key_range(a, q0, kb, ke);
  for (int k0 = kb; k0 < ke; k0 += kCols) {
    __syncthreads();
    stage<T, HD>(sK, k, hx.k_stride, k0, a.Sk, a.hd);
    stage<T, HD>(sKT, kt, hx.k_stride, k0, a.Sk, a.hd);
    stage<T, HD>(sV, v, hx.k_stride, k0, a.Sk, a.hd);
    stage<T, HD>(sVT, vt, hx.k_stride, k0, a.Sk, a.hd);
    __syncthreads();
    float s[kRows], st1[kRows], st2[kRows];
    dots<HD>(s, sQ + warp * kRows * LD, sK + lane * LD);
    dots<HD>(st1, sQT + warp * kRows * LD, sK + lane * LD);   // Q' K^T
    dots<HD>(st2, sQ + warp * kRows * LD, sKT + lane * LD);   // Q K'^T
    const int kp = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qp = q0 + warp * kRows + r;
      const bool ok = allowed(a, qp, kp);
      const float p = ok ? expf(logit(a, s[r], b, qp, kp) - lse[r]) : 0.f;
      const float rr = ok ? p * ((st1[r] + st2[r]) * a.scale) : 0.f;  // P * S'
      t[r] += warp_sum(rr);
      wP[r * kCols + lane] = p;
      wR[r * kCols + lane] = rr;
    }
    __syncwarp();
    accumulate<HD>(acc, wR, sV, lane);   // (P * S') V
    accumulate<HD>(acc, wP, sVT, lane);  // P V'
  }

  float* g = a.g + hx.q_off;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + warp * kRows + r;
    if (qp >= a.Sq) continue;
#pragma unroll
    for (int c = 0; c < DPL; ++c)
      if (lane + 32 * c < a.hd) g[qp * hx.q_stride + lane + 32 * c] = acc[r][c];
    if (lane == 0) a.t[row0 + qp] = t[r];
  }
}

// -------------------------------------------------------------- launch --
enum Kind { kForward, kDq, kDkv, kJvp };

template <class T, int HD>
int launch(Kind kind, const FaArgs& a, cudaStream_t stream) {
  constexpr int LD = HD + 4;
  void (*kern)(const FaArgs);
  int row_tiles, own_rows, other_tiles, weights;
  switch (kind) {
    case kForward:
      kern = fa_forward_kernel<T, HD>; own_rows = a.Sq; row_tiles = 1; other_tiles = 2; weights = 1;
      break;
    case kDq:
      kern = fa_dq_kernel<T, HD>; own_rows = a.Sq; row_tiles = 2; other_tiles = 2; weights = 1;
      break;
    case kDkv:
      kern = fa_dkv_kernel<T, HD>; own_rows = a.Sk; row_tiles = 2; other_tiles = 2; weights = 2;
      break;
    default:
      kern = fa_jvp_kernel<T, HD>; own_rows = a.Sq; row_tiles = 2; other_tiles = 4; weights = 2;
      break;
  }
  const size_t smem =
      sizeof(float) * ((size_t)(row_tiles * kTile + other_tiles * kCols) * LD +
                       (size_t)weights * kTile * kCols);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((own_rows + kTile - 1) / kTile, a.H, a.B);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The register and shared-memory width: the smallest of 32, 64 and 128 at
// or above the head dim, which may be any multiple of 8 up to 128.
template <class T>
int dispatch_hd(Kind kind, const FaArgs& a, cudaStream_t stream) {
  if (a.hd < 8 || a.hd > 128 || a.hd % 8) return (int)cudaErrorInvalidValue;
  if (a.hd <= 32) return launch<T, 32>(kind, a, stream);
  if (a.hd <= 64) return launch<T, 64>(kind, a, stream);
  return launch<T, 128>(kind, a, stream);
}

int dispatch(Kind kind, const FaArgs* a, cudaStream_t stream) {
  if (a->dtype == 0) return dispatch_hd<float>(kind, *a, stream);
  if (a->dtype == 1) return dispatch_hd<__nv_bfloat16>(kind, *a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int fa_forward(const FaArgs* a, cudaStream_t stream) { return dispatch(kForward, a, stream); }
int fa_dq(const FaArgs* a, cudaStream_t stream) { return dispatch(kDq, a, stream); }
int fa_dkv(const FaArgs* a, cudaStream_t stream) { return dispatch(kDkv, a, stream); }
int fa_jvp(const FaArgs* a, cudaStream_t stream) { return dispatch(kJvp, a, stream); }
}
