// Flash attention for Hopper (sm_90a): forward, dQ, dK/dV and JVP passes,
// plain C interface (flash_attention.h).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_attention.py:
//   forward  <- _fa_kernel / flash_attention_fwd      o, lse
//   dQ       <- _fa_dq_kernel / flash_attention_dq    dQ
//   dK/dV    <- _fa_dkv_kernel / flash_attention_dkv  dK, dV per q-head
//   JVP      <- _fa_jvp_kernel / flash_attention_jvp  g, t
// Each computes what its TPU kernel computes: causal, sliding-window and
// valid_len masks, GQA (kv head = h / (H / KV)), the optional additive f32
// bias (B|1, Sq, Sk), and the fully-masked-row guard (m_safe; lse = 0, o = 0).
// Like the reference, the bf16 passes round the softmax weights to bf16
// before their second product (P in the forward, dS in dQ, P and dS in
// dK/dV, R = P∘Ṡ and P in the JVP) and sum l and t from the unrounded f32
// values; the f32 passes round nothing.
//
// What bounds them on this card. At the training shapes (hd 64, S 512) a
// pass reads each of its inputs once and does about S/2 multiply-adds per
// element of Q (causal): in bf16 on the tensor cores (989 TFLOP/s) that is
// about the time the bytes take (forward: 0.0101 ms on bytes against 0.0044
// on operations at B 8, 16 heads), in f32 FFMA (67 TFLOP/s) the operations
// bound. Two routes:
//
//   * bf16, all four passes: tensor-core tiles (fa_forward_mma, fa_dq_mma,
//     fa_dkv_mma, fa_jvp_mma), mma.sync.m16n8k16 with f32 accumulation, in
//     the shape of FlashAttention-2. One block of 4 warps per (64 rows of
//     its own side, h, b); each warp owns 16 rows. The other side's tiles
//     (64 keys for the forward; 64 keys or queries for dQ, dK/dV and the
//     JVP, 32 at head dims above 64) come in bf16 by cp.async into a
//     two-stage ring, the next tile in flight while the current one is
//     computed, rows padded by 16 bytes so that ldmatrix hits 8 distinct
//     bank groups. The head dim is the k-dimension of the score product and
//     is padded with zero columns in shared memory to the next multiple of
//     16 (the template width HDP); every stride in memory is the true hd's.
//     Scores stay in f32 C fragments; the mask and bias are applied per
//     element only on tiles the mask cuts (tile_open), and the softmax
//     statistics need only quad shuffles. The weights (P, dS in dQ and dK/dV, R and P
//     in the JVP), rounded to bf16, go from the C fragments of one product
//     straight into the A fragments of the next, never through shared
//     memory; V, V̇, dO, Q and (in dQ) K are read as B operands with
//     ldmatrix.trans. dQ forms S = Q·Kᵀ and dP = dO·Vᵀ with lse and Δ of
//     the warp's rows in registers and keeps dQ in f32 registers; dK/dV
//     forms Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ directly, so that Pᵀ and dSᵀ are its A
//     operands, and keeps dK and dV in f32 registers; the JVP forms S = Q·Kᵀ
//     and Ṡ = Q̇·Kᵀ + Q·K̇ᵀ (both products in one f32 accumulator), then g =
//     round(R)·V + round(P)·V̇ in one f32 accumulator, and t from the
//     unrounded R. Blocks launch longest first (the tile index is the
//     grid's slowest axis), which shortens the causal tail. Not yet: wgmma,
//     TMA and warp specialisation (the producer warp, a deeper ring), which
//     would reach the operation bound.
//   * f32, all four passes: f32 FFMA from shared memory, the simple and
//     exact first form (TF32 would not hold the f32 1e-5 gates). The TPU
//     grid's sequential innermost axis becomes a loop inside one block,
//     with the m/l/acc recurrence in f32 registers. One block per (b, h,
//     32-row tile). Tiles of 32 rows are staged in shared memory, rows
//     padded to HD + 4 floats so that lane j reading row j as float4 hits
//     distinct banks. HD, the register width, is 32, 64 or 128, the
//     smallest at or above hd; columns [hd, HD) are staged as zeros and
//     never stored. Warp w owns 8 rows of
//     its block's side; lane j owns row j of the staged tile on the other
//     side, so a warp's 32-wide score row comes from float4 dot products and
//     its softmax statistics from warp shuffles. The product with V (or K,
//     Q, dO) reads the weights back from shared memory as float4 broadcasts
//     while lanes split the head dim (lane + 32c).
//
// Both routes skip key tiles that the causal or window test masks wholly
// (the TPU kernel runs them as no-ops), and tiles past valid_len; P is
// recomputed from the stored logsumexp in dQ, dK/dV and JVP, so the (S, S)
// weights never reach device memory; every output element is written by
// exactly one block, with no float atomics, so the results are as
// deterministic as the reference's. Left outside, as in the reference:
// Δ = rowsum(dO * O), the GQA group-sum of dK/dV and ȯ = g − t * o.
//
// Kernels launch on the caller's stream and allocate nothing; the binding
// (cg_fused_bind.cpp) allocates the outputs and checks every launch.

#include "flash_attention.h"

#include <cuda_bf16.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 8;              // FFMA: rows of the block's own side per warp
constexpr int kTile = kWarps * kRows; // FFMA: rows of the block's own side (32)
constexpr int kCols = 32;             // FFMA: rows of the other side per inner tile
constexpr int kBlockRows = 64;        // MMA: rows of the block's own side (4 warps x 16)
constexpr int kKeyTile = 64;          // MMA forward: keys per inner tile

// ------------------------------------------------------ shared helpers --
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

// Keys a tile of queries [q0, q0 + rows) can see: the rest are masked for
// every row of the tile.
__device__ __forceinline__ void key_range(const FaArgs& a, int q0, int rows, int& kb, int& ke) {
  kb = 0;
  ke = a.Sk;
  if (a.causal) ke = min(ke, q0 + rows);
  if (a.has_window) kb = max(kb, q0 - a.window + 1);
  if (a.valid_len >= 0) ke = min(ke, a.valid_len);
}

// Queries that can see a tile of keys [k0, k0 + rows).
__device__ __forceinline__ void query_range(const FaArgs& a, int k0, int rows, int& qb, int& qe) {
  qb = 0;
  qe = a.Sq;
  if (a.causal) qb = max(qb, k0);
  if (a.has_window) qe = min(qe, k0 + rows - 1 + a.window);
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

// ====================================================== f32 FFMA route ==
__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows [r0, r0 + 32) of a (rows, row_stride) f32 tensor, hd values each,
// into shared memory as rows of HD + 4 (HD >= hd, the register width); rows
// at or past n and columns [hd, HD) are zero, so they add exact zeros to
// every dot product.
template <int HD>
__device__ __forceinline__ void stage(float* sm, const float* base, int64_t row_stride, int r0,
                                      int n, int hd) {
  constexpr int LD = HD + 4, V = HD / 4;
  for (int idx = threadIdx.x; idx < kCols * V; idx += kThreads) {
    const int r = idx / V, c = (idx - r * V) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n && c < hd)
      x = *reinterpret_cast<const float4*>(base + (int64_t)(r0 + r) * row_stride + c);
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

// ------------------------------------------------------ forward (f32) --
template <int HD>
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
  const float* k = static_cast<const float*>(a.k) + hx.k_off;
  const float* v = static_cast<const float*>(a.v) + hx.k_off;
  stage<HD>(sQ, static_cast<const float*>(a.q) + hx.q_off, hx.q_stride, q0, a.Sq, a.hd);

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
  key_range(a, q0, kTile, kb, ke);
  for (int k0 = kb; k0 < ke; k0 += kCols) {
    __syncthreads();
    stage<HD>(sK, k, hx.k_stride, k0, a.Sk, a.hd);
    stage<HD>(sV, v, hx.k_stride, k0, a.Sk, a.hd);
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

  float* o = static_cast<float*>(a.o) + hx.q_off;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + warp * kRows + r;
    if (qp >= a.Sq) continue;
    const float norm = l[r] <= 0.f ? 1.f : l[r];
#pragma unroll
    for (int c = 0; c < DPL; ++c)
      if (lane + 32 * c < a.hd) o[qp * hx.q_stride + lane + 32 * c] = acc[r][c] / norm;
    if (lane == 0) {
      const float m_fin = m[r] <= kNegInf / 2 ? 0.f : m[r];
      a.lse_out[((int64_t)b * a.H + h) * a.Sq + qp] = m_fin + logf(norm);
    }
  }
}

// ---------------------------------------------------------- dQ (f32) --
template <int HD>
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
  const float* k = static_cast<const float*>(a.k) + hx.k_off;
  const float* v = static_cast<const float*>(a.v) + hx.k_off;
  stage<HD>(sQ, static_cast<const float*>(a.q) + hx.q_off, hx.q_stride, q0, a.Sq, a.hd);
  stage<HD>(sDO, static_cast<const float*>(a.dout) + hx.q_off, hx.q_stride, q0, a.Sq,
                   a.hd);

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
  key_range(a, q0, kTile, kb, ke);
  for (int k0 = kb; k0 < ke; k0 += kCols) {
    __syncthreads();
    stage<HD>(sK, k, hx.k_stride, k0, a.Sk, a.hd);
    stage<HD>(sV, v, hx.k_stride, k0, a.Sk, a.hd);
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

  float* dq = static_cast<float*>(a.o) + hx.q_off;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + warp * kRows + r;
    if (qp >= a.Sq) continue;
#pragma unroll
    for (int c = 0; c < DPL; ++c)
      if (lane + 32 * c < a.hd) dq[qp * hx.q_stride + lane + 32 * c] = acc[r][c] * a.scale;
  }
}

// -------------------------------------------------------- dK/dV (f32) --
template <int HD>
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
  const float* q = static_cast<const float*>(a.q) + hx.q_off;
  const float* dout = static_cast<const float*>(a.dout) + hx.q_off;
  stage<HD>(sK, static_cast<const float*>(a.k) + hx.k_off, hx.k_stride, k0, a.Sk, a.hd);
  stage<HD>(sV, static_cast<const float*>(a.v) + hx.k_off, hx.k_stride, k0, a.Sk, a.hd);

  float dk[kRows][DPL], dv[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < DPL; ++c) dk[r][c] = dv[r][c] = 0.f;
  const int64_t row0 = ((int64_t)b * a.H + h) * a.Sq;
  float* wP = sP + warp * kRows * kCols;
  float* wS = sS + warp * kRows * kCols;
  int qb, qe;
  query_range(a, k0, kTile, qb, qe);
  for (int i0 = qb; i0 < qe; i0 += kCols) {
    __syncthreads();
    stage<HD>(sQ, q, hx.q_stride, i0, a.Sq, a.hd);
    stage<HD>(sDO, dout, hx.q_stride, i0, a.Sq, a.hd);
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

// --------------------------------------------------------- JVP (f32) --
template <int HD>
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
  const float* k = static_cast<const float*>(a.k) + hx.k_off;
  const float* kt = static_cast<const float*>(a.kt) + hx.k_off;
  const float* v = static_cast<const float*>(a.v) + hx.k_off;
  const float* vt = static_cast<const float*>(a.vt) + hx.k_off;
  stage<HD>(sQ, static_cast<const float*>(a.q) + hx.q_off, hx.q_stride, q0, a.Sq, a.hd);
  stage<HD>(sQT, static_cast<const float*>(a.qt) + hx.q_off, hx.q_stride, q0, a.Sq, a.hd);

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
  key_range(a, q0, kTile, kb, ke);
  for (int k0 = kb; k0 < ke; k0 += kCols) {
    __syncthreads();
    stage<HD>(sK, k, hx.k_stride, k0, a.Sk, a.hd);
    stage<HD>(sKT, kt, hx.k_stride, k0, a.Sk, a.hd);
    stage<HD>(sV, v, hx.k_stride, k0, a.Sk, a.hd);
    stage<HD>(sVT, vt, hx.k_stride, k0, a.Sk, a.hd);
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

// ============================================== bf16 tensor-core route ==
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from device to shared memory, in flight until
// cp_async_wait_all; with ``ok`` false nothing is read and the destination
// is filled with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8x8 bf16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8 and gets (row lane / 4, columns 2 (lane % 4) + {0, 1}) of each, or
// with ``.trans`` (rows 2 (lane % 4) + {0, 1}, column lane / 4).
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += A (16 x 16, row) · B (16 x 8, col), bf16 in, f32 accumulate. With
// g = lane / 4 and t = lane % 4: a = {(g, 2t..), (g + 8, 2t..), (g, 2t + 8..),
// (g + 8, 2t + 8..)}, b = {(k 2t.., n g), (k 2t + 8.., n g)}, d = {(g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)}.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to bf16 in one 32-bit register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The C fragments of two adjacent n-tiles as the A fragment of the next
// product, whose k-dimension is their 16 columns.
__device__ __forceinline__ void c_to_a(uint32_t (&x)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  x[0] = pack_bf16(c0[0], c0[1]);
  x[1] = pack_bf16(c0[2], c0[3]);
  x[2] = pack_bf16(c1[0], c1[1]);
  x[3] = pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ float exp_f(float x) { return exp2f(x * kLog2e); }

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows [r0, r0 + R) of a (rows, row_stride) bf16 tensor into shared rows of
// HDP + 8: columns [0, hd) copied, columns [hd, HDP) and rows at or past n
// zero-filled (hd is a multiple of 8, so every 16-byte chunk is either).
template <int HDP, int R>
__device__ __forceinline__ void stage_async(bf16* sm, const bf16* base, int64_t row_stride,
                                            int r0, int n, int hd) {
  constexpr int LD = HDP + 8, CH = HDP / 8;
  for (int idx = threadIdx.x; idx < R * CH; idx += kThreads) {
    const int r = idx / CH, c = (idx - r * CH) * 8;
    const bool ok = r0 + r < n && c < hd;
    cp_async16(sm + r * LD + c, ok ? base + (int64_t)(r0 + r) * row_stride + c : base, ok);
  }
}

// Entries [i0, i0 + R) of a row of (B, H, Sq) f32 statistics, zero past n.
template <int R>
__device__ __forceinline__ void stage_rows_async(float* sm, const float* row, int i0, int n) {
  for (int i = threadIdx.x; i < R; i += kThreads) {
    const bool ok = i0 + i < n;
    cp_async4(sm + i, ok ? row + i0 + i : row, ok);
  }
}

// True when every pair of the tile (queries [q0, q0 + nq), keys [k0, k0 +
// nk)) lies inside both sequences and passes the mask: its elements skip
// the per-element test.
__device__ __forceinline__ bool tile_open(const FaArgs& a, int q0, int nq, int k0, int nk) {
  if (q0 + nq > a.Sq || k0 + nk > a.Sk) return false;
  if (a.causal && k0 + nk - 1 > q0) return false;
  if (a.has_window && k0 <= q0 + nq - 1 - a.window) return false;
  if (a.valid_len >= 0 && k0 + nk > a.valid_len) return false;
  return true;
}

// ldmatrix row and column of this lane for an A tile (rows, k) and for a B
// tile stored as (n, k) rows; a B tile stored as (k, n) rows and read with
// .trans takes the A offsets.
struct Lanes {
  int a_row, a_col, b_row, b_col, g, t;
  __device__ __forceinline__ explicit Lanes(int lane)
      : a_row((lane & 7) + ((lane >> 3) & 1) * 8), a_col((lane >> 4) * 8),
        b_row((lane & 7) + (lane >> 4) * 8), b_col(((lane >> 3) & 1) * 8),
        g(lane >> 2), t(lane & 3) {}
};

// Scores of the warp's 16 query rows (r0 and r0 + 8) against keys [k0, k0 +
// 8 NT) → masked logits.
template <bool MASKED, int NT>
__device__ __forceinline__ void fwd_logits(float (&s)[NT][4], const FaArgs& a, int b, int r0,
                                           int k0, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qp = r0 + (e >> 1) * 8, kp = k0 + nt * 8 + 2 * t + (e & 1);
      s[nt][e] = MASKED && !allowed(a, qp, kp) ? kNegInf : logit(a, s[nt][e], b, qp, kp);
    }
}

// ------------------------------------------------ forward (bf16, MMA) --
template <int HDP>
__global__ void __launch_bounds__(kThreads) fa_forward_mma(const FaArgs a) {
  constexpr int LD = HDP + 8, KS = HDP / 16, NT = kKeyTile / 8, DT = HDP / 8;
  constexpr int kStage = kKeyTile * LD;
  extern __shared__ float4 smem4[];
  bf16* sQ = reinterpret_cast<bf16*>(smem4);
  bf16* sK = sQ + kBlockRows * LD;  // two stages
  bf16* sV = sK + 2 * kStage;       // two stages
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBlockRows;  // longest causal rows first
  const int warp = threadIdx.x >> 5;
  const Lanes ln(threadIdx.x & 31);
  const Heads hx = heads(a, b, h, a.hd);
  const bf16* k = static_cast<const bf16*>(a.k) + hx.k_off;
  const bf16* v = static_cast<const bf16*>(a.v) + hx.k_off;
  int kb, ke;
  key_range(a, q0, kBlockRows, kb, ke);
  stage_async<HDP, kBlockRows>(sQ, static_cast<const bf16*>(a.q) + hx.q_off, hx.q_stride, q0,
                               a.Sq, a.hd);
  if (kb < ke) {
    stage_async<HDP, kKeyTile>(sK, k, hx.k_stride, kb, a.Sk, a.hd);
    stage_async<HDP, kKeyTile>(sV, v, hx.k_stride, kb, a.Sk, a.hd);
  }
  cp_async_commit();

  float o[DT][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldsm4(qf[ks], sQ + (warp * 16 + ln.a_row) * LD + ks * 16 + ln.a_col);

  const int r0 = q0 + warp * 16 + ln.g;  // query of C elements 0, 1; r0 + 8 of 2, 3
  for (int it = 0, k0 = kb; k0 < ke; ++it, k0 += kKeyTile) {
    if (it > 0) {
      cp_async_wait_all();  // tile it has landed
      __syncthreads();      // and every warp is done with tile it - 1's stage
    }
    const int st = it & 1;
    if (k0 + kKeyTile < ke) {
      stage_async<HDP, kKeyTile>(sK + (st ^ 1) * kStage, k, hx.k_stride, k0 + kKeyTile, a.Sk,
                                 a.hd);
      stage_async<HDP, kKeyTile>(sV + (st ^ 1) * kStage, v, hx.k_stride, k0 + kKeyTile, a.Sk,
                                 a.hd);
    }
    cp_async_commit();
    const bf16* cK = sK + st * kStage;
    const bf16* cV = sV + st * kStage;

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kf[4];
        ldsm4(kf, cK + (np * 16 + ln.b_row) * LD + ks * 16 + ln.b_col);
        mma16816(s[2 * np], qf[ks], kf[0], kf[1]);
        mma16816(s[2 * np + 1], qf[ks], kf[2], kf[3]);
      }
    if (tile_open(a, q0, kBlockRows, k0, kKeyTile))
      fwd_logits<false>(s, a, b, r0, k0, ln.t);
    else
      fwd_logits<true>(s, a, b, r0, k0, ln.t);

    // online softmax over the tile; rows r0 (i = 0) and r0 + 8 (i = 1)
    float ms[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * i], s[nt][2 * i + 1]));
      mx = quad_max(mx);
      // guard fully-masked rows: exp(NEG_INF - NEG_INF) would be 1
      ms[i] = mx <= kNegInf / 2 ? 0.f : mx;
      const float alpha = m[i] <= kNegInf / 2 ? 0.f : exp_f(m[i] - ms[i]);
      m[i] = mx;
      l[i] *= alpha;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        o[dt][2 * i] *= alpha;
        o[dt][2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp_f(s[nt][e] - ms[e >> 1]);
        l[e >> 1] += s[nt][e];  // l from the unrounded p, as the reference sums it
      }
    // o += round(P) · V
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t pf[4];
      c_to_a(pf, s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vf[4];
        ldsm4_t(vf, cV + (j * 16 + ln.a_row) * LD + dp * 16 + ln.a_col);
        mma16816(o[2 * dp], pf, vf[0], vf[1]);
        mma16816(o[2 * dp + 1], pf, vf[2], vf[3]);
      }
    }
  }

  // o / l through the warp's own Q rows in shared memory, then out in
  // 16-byte rows; lse from the quad's lane 0.
  float norm[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = quad_sum(l[i]);
    norm[i] = l[i] <= 0.f ? 1.f : l[i];
  }
  __syncthreads();
  bf16* wO = sQ + warp * 16 * LD;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = dt * 8 + 2 * ln.t;
    *reinterpret_cast<uint32_t*>(wO + ln.g * LD + c) =
        pack_bf16(o[dt][0] / norm[0], o[dt][1] / norm[0]);
    *reinterpret_cast<uint32_t*>(wO + (ln.g + 8) * LD + c) =
        pack_bf16(o[dt][2] / norm[1], o[dt][3] / norm[1]);
  }
  __syncwarp();
  bf16* og = static_cast<bf16*>(a.o) + hx.q_off;
  const int CH = a.hd / 8, lane = threadIdx.x & 31;
  for (int idx = lane; idx < 16 * CH; idx += 32) {
    const int r = idx / CH, c = (idx - r * CH) * 8, qp = q0 + warp * 16 + r;
    if (qp < a.Sq)
      *reinterpret_cast<uint4*>(og + (int64_t)qp * hx.q_stride + c) =
          *reinterpret_cast<const uint4*>(wO + r * LD + c);
  }
  if (ln.t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qp = r0 + 8 * i;
      if (qp < a.Sq)
        a.lse_out[((int64_t)b * a.H + h) * a.Sq + qp] =
            (m[i] <= kNegInf / 2 ? 0.f : m[i]) + logf(norm[i]);
    }
  }
}

// Sᵀ and dPᵀ of the warp's 16 key rows (r0 and r0 + 8) against queries [i0,
// i0 + 8 NT) → Pᵀ = exp(logit − lse) in s and dSᵀ = Pᵀ∘(dPᵀ − Δ) in dp,
// unrounded; lse and Δ of the tile's queries are in shared memory.
template <bool MASKED, int NT>
__device__ __forceinline__ void dkv_weights(float (&s)[NT][4], float (&dp)[NT][4],
                                            const FaArgs& a, int b, int r0, int i0, int t,
                                            const float* lse, const float* delta) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kp = r0 + (e >> 1) * 8, c = nt * 8 + 2 * t + (e & 1), qp = i0 + c;
      const float x =
          MASKED && !allowed(a, qp, kp) ? kNegInf : logit(a, s[nt][e], b, qp, kp);
      const float p = exp_f(x - lse[c]);
      s[nt][e] = p;
      dp[nt][e] = p * (dp[nt][e] - delta[c]);
    }
}

// -------------------------------------------------- dK/dV (bf16, MMA) --
template <int HDP, int BQ>
__global__ void __launch_bounds__(kThreads) fa_dkv_mma(const FaArgs a) {
  constexpr int LD = HDP + 8, KS = HDP / 16, NT = BQ / 8, DT = HDP / 8;
  constexpr int kStage = BQ * LD;
  extern __shared__ float4 smem4[];
  bf16* sK = reinterpret_cast<bf16*>(smem4);
  bf16* sV = sK + kBlockRows * LD;
  bf16* sQ = sV + kBlockRows * LD;  // two stages
  bf16* sO = sQ + 2 * kStage;       // dO, two stages
  float* sL = reinterpret_cast<float*>(sO + 2 * kStage);  // lse, two stages
  float* sD = sL + 2 * BQ;                                // Δ, two stages
  const int h = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * kBlockRows;  // longest first
  const int warp = threadIdx.x >> 5;
  const Lanes ln(threadIdx.x & 31);
  const Heads hx = heads(a, b, h, a.hd);
  const bf16* q = static_cast<const bf16*>(a.q) + hx.q_off;
  const bf16* dout = static_cast<const bf16*>(a.dout) + hx.q_off;
  const int64_t row0 = ((int64_t)b * a.H + h) * a.Sq;
  int qb, qe;
  query_range(a, k0, kBlockRows, qb, qe);
  stage_async<HDP, kBlockRows>(sK, static_cast<const bf16*>(a.k) + hx.k_off, hx.k_stride, k0,
                               a.Sk, a.hd);
  stage_async<HDP, kBlockRows>(sV, static_cast<const bf16*>(a.v) + hx.k_off, hx.k_stride, k0,
                               a.Sk, a.hd);
  if (qb < qe) {
    stage_async<HDP, BQ>(sQ, q, hx.q_stride, qb, a.Sq, a.hd);
    stage_async<HDP, BQ>(sO, dout, hx.q_stride, qb, a.Sq, a.hd);
    stage_rows_async<BQ>(sL, a.lse + row0, qb, a.Sq);
    stage_rows_async<BQ>(sD, a.delta + row0, qb, a.Sq);
  }
  cp_async_commit();

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;
  const int kr = warp * 16;     // the warp's key rows in the block
  const int r0 = k0 + kr + ln.g;  // key of C elements 0, 1; r0 + 8 of 2, 3
  for (int it = 0, i0 = qb; i0 < qe; ++it, i0 += BQ) {
    cp_async_wait_all();  // tile it has landed
    __syncthreads();      // and every warp is done with tile it - 1's stage
    const int st = it & 1;
    if (i0 + BQ < qe) {
      stage_async<HDP, BQ>(sQ + (st ^ 1) * kStage, q, hx.q_stride, i0 + BQ, a.Sq, a.hd);
      stage_async<HDP, BQ>(sO + (st ^ 1) * kStage, dout, hx.q_stride, i0 + BQ, a.Sq, a.hd);
      stage_rows_async<BQ>(sL + (st ^ 1) * BQ, a.lse + row0, i0 + BQ, a.Sq);
      stage_rows_async<BQ>(sD + (st ^ 1) * BQ, a.delta + row0, i0 + BQ, a.Sq);
    }
    cp_async_commit();
    const bf16* cQ = sQ + st * kStage;
    const bf16* cO = sO + st * kStage;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ for the warp's 16 keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t kf[4], vf[4];
      ldsm4(kf, sK + (kr + ln.a_row) * LD + ks * 16 + ln.a_col);
      ldsm4(vf, sV + (kr + ln.a_row) * LD + ks * 16 + ln.a_col);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t qf[4], of[4];
        ldsm4(qf, cQ + (np * 16 + ln.b_row) * LD + ks * 16 + ln.b_col);
        mma16816(s[2 * np], kf, qf[0], qf[1]);
        mma16816(s[2 * np + 1], kf, qf[2], qf[3]);
        ldsm4(of, cO + (np * 16 + ln.b_row) * LD + ks * 16 + ln.b_col);
        mma16816(dp[2 * np], vf, of[0], of[1]);
        mma16816(dp[2 * np + 1], vf, of[2], of[3]);
      }
    }
    if (tile_open(a, i0, BQ, k0, kBlockRows))
      dkv_weights<false>(s, dp, a, b, r0, i0, ln.t, sL + st * BQ, sD + st * BQ);
    else
      dkv_weights<true>(s, dp, a, b, r0, i0, ln.t, sL + st * BQ, sD + st * BQ);

    // dV += round(Pᵀ)·dO, dK += round(dSᵀ)·Q
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t pa[4], da[4];
      c_to_a(pa, s[2 * j], s[2 * j + 1]);
      c_to_a(da, dp[2 * j], dp[2 * j + 1]);
#pragma unroll
      for (int dd = 0; dd < DT / 2; ++dd) {
        uint32_t of[4], qf[4];
        ldsm4_t(of, cO + (j * 16 + ln.a_row) * LD + dd * 16 + ln.a_col);
        mma16816(dv[2 * dd], pa, of[0], of[1]);
        mma16816(dv[2 * dd + 1], pa, of[2], of[3]);
        ldsm4_t(qf, cQ + (j * 16 + ln.a_row) * LD + dd * 16 + ln.a_col);
        mma16816(dk[2 * dd], da, qf[0], qf[1]);
        mma16816(dk[2 * dd + 1], da, qf[2], qf[3]);
      }
    }
  }
  cp_async_wait_all();

  const int64_t o_stride = (int64_t)a.H * a.hd;
  const int64_t o_off = (int64_t)b * a.Sk * o_stride + (int64_t)h * a.hd;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = dt * 8 + 2 * ln.t;
    if (c >= a.hd) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kp = r0 + 8 * i;
      if (kp >= a.Sk) continue;
      const int64_t at = o_off + kp * o_stride + c;
      *reinterpret_cast<float2*>(a.dk + at) =
          make_float2(dk[dt][2 * i] * a.scale, dk[dt][2 * i + 1] * a.scale);
      *reinterpret_cast<float2*>(a.dv + at) = make_float2(dv[dt][2 * i], dv[dt][2 * i + 1]);
    }
  }
}

// S and dP of the warp's 16 query rows (r0 and r0 + 8) against keys [k0, k0
// + 8 NT) → dS = P∘(dP − Δ) in dp, unrounded, with P = exp(logit − lse).
template <bool MASKED, int NT>
__device__ __forceinline__ void dq_weights(const float (&s)[NT][4], float (&dp)[NT][4],
                                           const FaArgs& a, int b, int r0, int k0, int t,
                                           const float (&lse)[2], const float (&delta)[2]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qp = r0 + (e >> 1) * 8, kp = k0 + nt * 8 + 2 * t + (e & 1);
      const float x =
          MASKED && !allowed(a, qp, kp) ? kNegInf : logit(a, s[nt][e], b, qp, kp);
      dp[nt][e] = exp_f(x - lse[e >> 1]) * (dp[nt][e] - delta[e >> 1]);
    }
}

// ----------------------------------------------------- dQ (bf16, MMA) --
// S = Q·Kᵀ and dP = dO·Vᵀ with K and V as B operands read without .trans;
// dQ += round(dS)·K with K read with .trans. Q and dO are staged once; the
// warp's lse and Δ stay in registers.
template <int HDP, int BK>
__global__ void __launch_bounds__(kThreads) fa_dq_mma(const FaArgs a) {
  constexpr int LD = HDP + 8, KS = HDP / 16, NT = BK / 8, DT = HDP / 8;
  constexpr int kStage = BK * LD;
  extern __shared__ float4 smem4[];
  bf16* sQ = reinterpret_cast<bf16*>(smem4);
  bf16* sO = sQ + kBlockRows * LD;  // dO
  bf16* sK = sO + kBlockRows * LD;  // two stages
  bf16* sV = sK + 2 * kStage;       // two stages
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBlockRows;  // longest causal rows first
  const int warp = threadIdx.x >> 5;
  const Lanes ln(threadIdx.x & 31);
  const Heads hx = heads(a, b, h, a.hd);
  const bf16* k = static_cast<const bf16*>(a.k) + hx.k_off;
  const bf16* v = static_cast<const bf16*>(a.v) + hx.k_off;
  int kb, ke;
  key_range(a, q0, kBlockRows, kb, ke);
  stage_async<HDP, kBlockRows>(sQ, static_cast<const bf16*>(a.q) + hx.q_off, hx.q_stride, q0,
                               a.Sq, a.hd);
  stage_async<HDP, kBlockRows>(sO, static_cast<const bf16*>(a.dout) + hx.q_off, hx.q_stride,
                               q0, a.Sq, a.hd);
  if (kb < ke) {
    stage_async<HDP, BK>(sK, k, hx.k_stride, kb, a.Sk, a.hd);
    stage_async<HDP, BK>(sV, v, hx.k_stride, kb, a.Sk, a.hd);
  }
  cp_async_commit();

  const int r0 = q0 + warp * 16 + ln.g;  // query of C elements 0, 1; r0 + 8 of 2, 3
  const int64_t row0 = ((int64_t)b * a.H + h) * a.Sq;
  float lse[2], delta[2], dq[DT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = r0 + 8 * i;
    lse[i] = qp < a.Sq ? a.lse[row0 + qp] : 0.f;
    delta[i] = qp < a.Sq ? a.delta[row0 + qp] : 0.f;
  }
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[dt][e] = 0.f;
  const bf16* wQ = sQ + (warp * 16 + ln.a_row) * LD + ln.a_col;
  const bf16* wO = sO + (warp * 16 + ln.a_row) * LD + ln.a_col;
  for (int it = 0, k0 = kb; k0 < ke; ++it, k0 += BK) {
    cp_async_wait_all();  // tile it has landed
    __syncthreads();      // and every warp is done with tile it - 1's stage
    const int st = it & 1;
    if (k0 + BK < ke) {
      stage_async<HDP, BK>(sK + (st ^ 1) * kStage, k, hx.k_stride, k0 + BK, a.Sk, a.hd);
      stage_async<HDP, BK>(sV + (st ^ 1) * kStage, v, hx.k_stride, k0 + BK, a.Sk, a.hd);
    }
    cp_async_commit();
    const bf16* cK = sK + st * kStage;
    const bf16* cV = sV + st * kStage;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qf[4], of[4];
      ldsm4(qf, wQ + ks * 16);
      ldsm4(of, wO + ks * 16);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kf[4], vf[4];
        ldsm4(kf, cK + (np * 16 + ln.b_row) * LD + ks * 16 + ln.b_col);
        mma16816(s[2 * np], qf, kf[0], kf[1]);
        mma16816(s[2 * np + 1], qf, kf[2], kf[3]);
        ldsm4(vf, cV + (np * 16 + ln.b_row) * LD + ks * 16 + ln.b_col);
        mma16816(dp[2 * np], of, vf[0], vf[1]);
        mma16816(dp[2 * np + 1], of, vf[2], vf[3]);
      }
    }
    if (tile_open(a, q0, kBlockRows, k0, BK))
      dq_weights<false>(s, dp, a, b, r0, k0, ln.t, lse, delta);
    else
      dq_weights<true>(s, dp, a, b, r0, k0, ln.t, lse, delta);

    // dQ += round(dS)·K
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t da[4];
      c_to_a(da, dp[2 * j], dp[2 * j + 1]);
#pragma unroll
      for (int dd = 0; dd < DT / 2; ++dd) {
        uint32_t kf[4];
        ldsm4_t(kf, cK + (j * 16 + ln.a_row) * LD + dd * 16 + ln.a_col);
        mma16816(dq[2 * dd], da, kf[0], kf[1]);
        mma16816(dq[2 * dd + 1], da, kf[2], kf[3]);
      }
    }
  }
  cp_async_wait_all();

  // scale·dQ through the warp's own Q rows in shared memory (only this warp
  // reads them), then out in 16-byte rows.
  __syncwarp();
  bf16* wD = sQ + warp * 16 * LD;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = dt * 8 + 2 * ln.t;
    *reinterpret_cast<uint32_t*>(wD + ln.g * LD + c) =
        pack_bf16(dq[dt][0] * a.scale, dq[dt][1] * a.scale);
    *reinterpret_cast<uint32_t*>(wD + (ln.g + 8) * LD + c) =
        pack_bf16(dq[dt][2] * a.scale, dq[dt][3] * a.scale);
  }
  __syncwarp();
  bf16* dqg = static_cast<bf16*>(a.o) + hx.q_off;
  const int CH = a.hd / 8, lane = threadIdx.x & 31;
  for (int idx = lane; idx < 16 * CH; idx += 32) {
    const int r = idx / CH, c = (idx - r * CH) * 8, qp = q0 + warp * 16 + r;
    if (qp < a.Sq)
      *reinterpret_cast<uint4*>(dqg + (int64_t)qp * hx.q_stride + c) =
          *reinterpret_cast<const uint4*>(wD + r * LD + c);
  }
}

// S and Ṡ of the warp's 16 query rows (r0 and r0 + 8) against keys [k0, k0
// + 8 NT) → P = exp(logit − lse) in s and R = P∘(scale·Ṡ) in st, zero where
// masked, both unrounded; t gets the lane's share of rowsum(R).
template <bool MASKED, int NT>
__device__ __forceinline__ void jvp_weights(float (&s)[NT][4], float (&st)[NT][4],
                                            const FaArgs& a, int b, int r0, int k0, int t,
                                            const float (&lse)[2], float (&tsum)[2]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qp = r0 + (e >> 1) * 8, kp = k0 + nt * 8 + 2 * t + (e & 1);
      const bool ok = !MASKED || allowed(a, qp, kp);
      const float p = ok ? exp_f(logit(a, s[nt][e], b, qp, kp) - lse[e >> 1]) : 0.f;
      const float r = ok ? p * (st[nt][e] * a.scale) : 0.f;
      s[nt][e] = p;
      st[nt][e] = r;
      tsum[e >> 1] += r;  // t from the unrounded R, as the reference sums it
    }
}

// ---------------------------------------------------- JVP (bf16, MMA) --
// S = Q·Kᵀ and Ṡ = Q̇·Kᵀ + Q·K̇ᵀ (one f32 accumulator) with K and K̇ as B
// operands read without .trans; g += round(R)·V + round(P)·V̇ into one f32
// accumulator, V and V̇ read with .trans. Q and Q̇ are staged once; the
// warp's lse stays in registers.
template <int HDP, int BK>
__global__ void __launch_bounds__(kThreads) fa_jvp_mma(const FaArgs a) {
  constexpr int LD = HDP + 8, KS = HDP / 16, NT = BK / 8, DT = HDP / 8;
  constexpr int kStage = BK * LD;
  extern __shared__ float4 smem4[];
  bf16* sQ = reinterpret_cast<bf16*>(smem4);
  bf16* sQt = sQ + kBlockRows * LD;  // Q̇
  bf16* sK = sQt + kBlockRows * LD;  // two stages each
  bf16* sKt = sK + 2 * kStage;
  bf16* sV = sKt + 2 * kStage;
  bf16* sVt = sV + 2 * kStage;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBlockRows;  // longest causal rows first
  const int warp = threadIdx.x >> 5;
  const Lanes ln(threadIdx.x & 31);
  const Heads hx = heads(a, b, h, a.hd);
  const bf16* ks[4] = {static_cast<const bf16*>(a.k) + hx.k_off,
                       static_cast<const bf16*>(a.kt) + hx.k_off,
                       static_cast<const bf16*>(a.v) + hx.k_off,
                       static_cast<const bf16*>(a.vt) + hx.k_off};
  // the four key-side tiles of key block k0 into stage st
  auto stage_keys = [&](int st, int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      stage_async<HDP, BK>(sK + (2 * i + st) * kStage, ks[i], hx.k_stride, k0, a.Sk, a.hd);
  };
  int kb, ke;
  key_range(a, q0, kBlockRows, kb, ke);
  stage_async<HDP, kBlockRows>(sQ, static_cast<const bf16*>(a.q) + hx.q_off, hx.q_stride, q0,
                               a.Sq, a.hd);
  stage_async<HDP, kBlockRows>(sQt, static_cast<const bf16*>(a.qt) + hx.q_off, hx.q_stride, q0,
                               a.Sq, a.hd);
  if (kb < ke) stage_keys(0, kb);
  cp_async_commit();

  const int r0 = q0 + warp * 16 + ln.g;  // query of C elements 0, 1; r0 + 8 of 2, 3
  const int64_t row0 = ((int64_t)b * a.H + h) * a.Sq;
  float lse[2], tsum[2] = {0.f, 0.f}, g[DT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = r0 + 8 * i;
    lse[i] = qp < a.Sq ? a.lse[row0 + qp] : 0.f;
  }
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) g[dt][e] = 0.f;
  const bf16* wQ = sQ + (warp * 16 + ln.a_row) * LD + ln.a_col;
  const bf16* wQt = sQt + (warp * 16 + ln.a_row) * LD + ln.a_col;
  for (int it = 0, k0 = kb; k0 < ke; ++it, k0 += BK) {
    cp_async_wait_all();  // tile it has landed
    __syncthreads();      // and every warp is done with tile it - 1's stage
    const int st = it & 1;
    if (k0 + BK < ke) stage_keys(st ^ 1, k0 + BK);
    cp_async_commit();
    const bf16* cK = sK + st * kStage;
    const bf16* cKt = sKt + st * kStage;
    const bf16* cV = sV + st * kStage;
    const bf16* cVt = sVt + st * kStage;

    float s[NT][4], sd[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = sd[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qf[4], qtf[4];
      ldsm4(qf, wQ + kk * 16);
      ldsm4(qtf, wQt + kk * 16);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kf[4], ktf[4];
        ldsm4(kf, cK + (np * 16 + ln.b_row) * LD + kk * 16 + ln.b_col);
        mma16816(s[2 * np], qf, kf[0], kf[1]);
        mma16816(s[2 * np + 1], qf, kf[2], kf[3]);
        mma16816(sd[2 * np], qtf, kf[0], kf[1]);
        mma16816(sd[2 * np + 1], qtf, kf[2], kf[3]);
        ldsm4(ktf, cKt + (np * 16 + ln.b_row) * LD + kk * 16 + ln.b_col);
        mma16816(sd[2 * np], qf, ktf[0], ktf[1]);
        mma16816(sd[2 * np + 1], qf, ktf[2], ktf[3]);
      }
    }
    if (tile_open(a, q0, kBlockRows, k0, BK))
      jvp_weights<false>(s, sd, a, b, r0, k0, ln.t, lse, tsum);
    else
      jvp_weights<true>(s, sd, a, b, r0, k0, ln.t, lse, tsum);

    // g += round(R)·V + round(P)·V̇
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t ra[4], pa[4];
      c_to_a(ra, sd[2 * j], sd[2 * j + 1]);
      c_to_a(pa, s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int dd = 0; dd < DT / 2; ++dd) {
        uint32_t vf[4], vtf[4];
        ldsm4_t(vf, cV + (j * 16 + ln.a_row) * LD + dd * 16 + ln.a_col);
        mma16816(g[2 * dd], ra, vf[0], vf[1]);
        mma16816(g[2 * dd + 1], ra, vf[2], vf[3]);
        ldsm4_t(vtf, cVt + (j * 16 + ln.a_row) * LD + dd * 16 + ln.a_col);
        mma16816(g[2 * dd], pa, vtf[0], vtf[1]);
        mma16816(g[2 * dd + 1], pa, vtf[2], vtf[3]);
      }
    }
  }
  cp_async_wait_all();

  // g (f32) straight from the C fragments; t from the quad's lane 0
  float* gg = a.g + hx.q_off;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = dt * 8 + 2 * ln.t;
    if (c >= a.hd) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qp = r0 + 8 * i;
      if (qp < a.Sq)
        *reinterpret_cast<float2*>(gg + (int64_t)qp * hx.q_stride + c) =
            make_float2(g[dt][2 * i], g[dt][2 * i + 1]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float ti = quad_sum(tsum[i]);
    const int qp = r0 + 8 * i;
    if (ln.t == 0 && qp < a.Sq) a.t[row0 + qp] = ti;
  }
}

// -------------------------------------------------------------- launch --
enum Kind { kForward, kDq, kDkv, kJvp };

// grid (row tiles, H, B), or with ``tiles_last`` (H, B, row tiles): blocks
// launch in the order of their linear index, so the tile index varies
// slowest and a kernel that starts with its longest tiles runs them first.
int run(void (*kern)(const FaArgs), size_t smem, int own_rows, int tile, const FaArgs& a,
        cudaStream_t stream, bool tiles_last = false) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned tiles = (own_rows + tile - 1) / tile;
  const dim3 grid = tiles_last ? dim3(a.H, a.B, tiles) : dim3(tiles, a.H, a.B);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The FFMA route: all four passes in f32.
template <int HD>
int launch_ffma(Kind kind, const FaArgs& a, cudaStream_t stream) {
  constexpr int LD = HD + 4;
  void (*kern)(const FaArgs) = nullptr;
  int own_rows = a.Sq, row_tiles = 2, other_tiles = 2, weights = 1;
  switch (kind) {
    case kForward:
      kern = fa_forward_kernel<HD>; row_tiles = 1;
      break;
    case kDq:
      kern = fa_dq_kernel<HD>;
      break;
    case kDkv:
      kern = fa_dkv_kernel<HD>; own_rows = a.Sk; weights = 2;
      break;
    default:
      kern = fa_jvp_kernel<HD>; other_tiles = 4; weights = 2;
      break;
  }
  const size_t smem =
      sizeof(float) * ((size_t)(row_tiles * kTile + other_tiles * kCols) * LD +
                       (size_t)weights * kTile * kCols);
  return run(kern, smem, own_rows, kTile, a, stream);
}

// The register and shared-memory width: the smallest of 32, 64 and 128 at
// or above the head dim.
int dispatch_ffma(Kind kind, const FaArgs& a, cudaStream_t stream) {
  if (a.hd <= 32) return launch_ffma<32>(kind, a, stream);
  if (a.hd <= 64) return launch_ffma<64>(kind, a, stream);
  return launch_ffma<128>(kind, a, stream);
}

// The tensor-core route: all four bf16 passes at the head dim padded to
// HDP, a multiple of 16. Above HDP 64 the other side's tiles are 32 rows
// (dQ, dK/dV and the JVP: their two score tiles in registers).
template <int HDP>
int launch_mma(Kind kind, const FaArgs& a, cudaStream_t stream) {
  constexpr int LD = HDP + 8, BT = HDP > 64 ? 32 : 64;
  switch (kind) {
    case kForward:
      return run(fa_forward_mma<HDP>, sizeof(bf16) * (size_t)(kBlockRows + 4 * kKeyTile) * LD,
                 a.Sq, kBlockRows, a, stream, true);
    case kDq:
      return run(fa_dq_mma<HDP, BT>, sizeof(bf16) * (size_t)(2 * kBlockRows + 4 * BT) * LD,
                 a.Sq, kBlockRows, a, stream, true);
    case kDkv:
      return run(fa_dkv_mma<HDP, BT>,
                 sizeof(bf16) * (size_t)(2 * kBlockRows + 4 * BT) * LD + sizeof(float) * 4 * BT,
                 a.Sk, kBlockRows, a, stream, true);
    default:
      return run(fa_jvp_mma<HDP, BT>, sizeof(bf16) * (size_t)(2 * kBlockRows + 8 * BT) * LD,
                 a.Sq, kBlockRows, a, stream, true);
  }
}

int dispatch_mma(Kind kind, const FaArgs& a, cudaStream_t stream) {
  switch ((a.hd + 15) / 16) {
    case 1: return launch_mma<16>(kind, a, stream);
    case 2: return launch_mma<32>(kind, a, stream);
    case 3: return launch_mma<48>(kind, a, stream);
    case 4: return launch_mma<64>(kind, a, stream);
    case 5: return launch_mma<80>(kind, a, stream);
    case 6: return launch_mma<96>(kind, a, stream);
    case 7: return launch_mma<112>(kind, a, stream);
    default: return launch_mma<128>(kind, a, stream);
  }
}

// Head dims: any multiple of 8 from 8 to 128.
int dispatch(Kind kind, const FaArgs* a, cudaStream_t stream) {
  if (a->hd < 8 || a->hd > 128 || a->hd % 8) return (int)cudaErrorInvalidValue;
  if (a->dtype == 0) return dispatch_ffma(kind, *a, stream);
  if (a->dtype != 1) return (int)cudaErrorInvalidValue;
  return dispatch_mma(kind, *a, stream);
}

}  // namespace

extern "C" {

int fa_forward(const FaArgs* a, cudaStream_t stream) { return dispatch(kForward, a, stream); }
int fa_dq(const FaArgs* a, cudaStream_t stream) { return dispatch(kDq, a, stream); }
int fa_dkv(const FaArgs* a, cudaStream_t stream) { return dispatch(kDkv, a, stream); }
int fa_jvp(const FaArgs* a, cudaStream_t stream) { return dispatch(kJvp, a, stream); }
}
