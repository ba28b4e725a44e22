// SSD (Mamba2) intra-chunk kernel for Hopper (sm_90a) on the tensor cores;
// plain C interface (ssd_scan.h).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd_scan.py:
//   ssd_intra_kernel <- _ssd_intra_kernel / ssd_intra
// For each (batch b, chunk c, head h), with B and C shared across heads:
//   l = cumsum(log_a)                                   (Q,)
//   y = ((C Bᵀ) ∘ exp(l_i − l_j) ∘ [i >= j]) u          (Q, P)
//   S = Bᵀ (u ∘ exp(l_Q − l))                           (N, P)
//   g = exp(l_Q)
// every product accumulated in f32, B and C widened from f32 or bf16 as the
// TPU kernel's astype(f32) does. The scan between chunks stays in torch
// (kernels/ssd_scan.py), as it stays in jnp.
//
// What bounds it on this card. At the serving slice's prefill (zamba2-7b:
// B 8, L 896 -> nc 7 chunks of Q 128, H 112 heads of P 64, state N 64) the
// function needs 13.26 GFLOP on the causal triangle and must move u and y
// (205.5 MB each), S (102.8 MB), log_a and l (3.2 MB each) and B, C: 521 MB,
// 0.156 ms at 3.35 TB/s. Its products run on the tensor cores in split TF32
// (three TF32 products for each f32 one; with bf16 B and C, C Bᵀ one bf16
// product and S two), 0.067 ms at the dense peaks, so on paper it is bound
// by bytes. In practice it is bound by issue: each mma triple needs its
// operands split, and the decay formed, by ordinary instructions, and 128
// registers a thread (two blocks an SM) leave little room to overlap them.
// What the design does:
//   * Tensor cores at f32 accuracy. Each f32 operand x is split as
//     hi = tf32(x), lo = tf32(x − hi), rounded as cvt.rna rounds but by
//     integer operations on the bits, and a product is summed as
//     lo·hi + hi·lo, then hi·hi, by mma.sync.m16n8k8 TF32 into f32 (the lo·lo
//     term is below f32's rounding). Where an operand is exact in TF32 (bf16
//     B in S = Bᵀ(u ∘ w)) two products suffice. With bf16 B and C, C Bᵀ is
//     one mma.sync.m16n8k16 bf16 product: exact products, f32 sums.
//   * One block per (b, c, group of 8 heads): B and C depend on (b, c) only,
//     so C Bᵀ is formed once for 8 heads, and it stays in registers. Warp m
//     owns the 8-row tiles m and R - 1 - m (R = Q/8): one m16n8 product forms
//     both tiles' rows against a key tile, and the pair holds R + 1 key tiles
//     of C Bᵀ (in 48 registers), the same for every warp.
//   * Decay in registers. Per head, warp m multiplies its C Bᵀ fragments by
//     exp(l_i − l_j) and feeds them as the B operand of yᵀ = uᵀ Dᵀ (uᵀ, 16
//     columns by 8 keys, is the A operand), one row tile at a time, kPass
//     column tiles of 16 at once (all 64 columns at the slice with bf16 B and
//     C), so a key tile's decay is formed once for them. The C fragment of a
//     key tile holds keys 2t and 2t + 1 where the B fragment wants k = t and
//     t + 4; the sum over keys does not care about their order, so u's rows
//     are read in the matching order (key 2t for k = t, 2t + 1 for k = t + 4).
//     Tiles above the diagonal are skipped; on the diagonal the mask
//     selects, never multiplies (exp(l_i − l_j) above the diagonal may be
//     inf, and 0·inf is NaN).
//   * Work split. y costs every warp with rows the same, R + 1 key tiles;
//     the tiles of S (16 state rows by 8 columns, Q/8 key steps each) are
//     cut into contiguous runs so that each warp's total is near the mean
//     (at the slice: 4 tiles each). With bf16 B a run is a column of tiles
//     sharing the split of u ∘ w; with f32 B a row sharing the split of Bᵀ.
//   * Copies in flight. u of the next head is fetched by cp.async into the
//     other half of a two-slot ring while the block computes this head; one
//     __syncthreads a head. At the slice a block holds 110 KB of shared
//     memory and 256 threads of at most 128 registers (kPass and kRun are
//     the widths that fit them without a spill), so two blocks share an SM.
//   * l stays exact. At the start warp w scans log_a of head w of the block
//     (lane L sums its run in double, a warp scan adds the lanes before it)
//     and rounds each l_i once, so the plain version (kernels/ref.py
//     ssd_intra_ref) gets the same bits of l and of g = expf(l_Q). The decay
//     of S, w_j = expf(l_Q − l_j), is formed there too; the decay inside the
//     triangle is one ex2.approx.ftz, whose error (a few 1e-7 where the term
//     matters) is far inside the 1e-5 gate.
// Shapes: Q from 1 to 128, N and P from 1 to 256, padded to whole tiles by
// zero fill (Q, N and P to 16); no row is read past its end.
//
// Shared memory of a block: B (Qp x LN), two u slots (Qp x LP each), l and
// w of the block's heads (8 x Qp each), all f32, with LN and LP a multiple
// of 32 plus 4 floats so that the fragment reads of a warp hit 32 banks.
//
// The kernel launches on the caller's stream and allocates nothing; the
// binding (cg_fused_bind.cpp) allocates the outputs and checks the launch.

#include "ssd_scan.h"

#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeadsPerBlock = kWarps;     // warp w scans head w of the block
constexpr int kMaxQ = 128;
constexpr int kMaxNP = 256;
constexpr int kKeyTiles = kMaxQ / 8;       // key tiles of C Bᵀ a warp may hold
constexpr int kHalf = kKeyTiles / 2;       // of them, for its first row tile
// Column tiles of 16 that y sums at once, and S tiles of a run, with bf16
// (true) and f32 B and C: what 128 registers hold without a spill (f32 B
// splits its Bᵀ fragments, and its C Bᵀ prologue holds more).
template <bool kBf16> constexpr int kPass = kBf16 ? 4 : 1;
template <bool kBf16> constexpr int kRun = kBf16 ? 2 : 4;
constexpr int64_t kMaxSmemBytes = 232448;  // what one block may use on Hopper

using bf16 = __nv_bfloat16;

struct Dims {
  int Qp, Np, Pp, LN, LP;
};

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

__host__ __device__ __forceinline__ Dims dims(int Q, int N, int P) {
  Dims d;
  d.Qp = round_up(Q, 16);
  d.Np = round_up(N, 16);
  d.Pp = round_up(P, 16);
  d.LN = round_up(d.Np, 32) + 4;
  d.LP = round_up(d.Pp, 32) + 4;
  return d;
}

int64_t smem_floats(int Q, int N, int P) {
  const Dims d = dims(Q, N, P);
  return (int64_t)d.Qp * d.LN + 2LL * d.Qp * d.LP + 2LL * kHeadsPerBlock * d.Qp;
}

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

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest on the 13
// dropped bits, ties away from zero), as the bits of an f32. Done on the
// bits with integer operations, which issue at the full rate, where the
// conversion does not; the same result for every finite x below 2^128.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// e^x for x <= 0 inside the causal triangle: one ex2.approx with denormal
// results flushed to zero (a term below 2^-126 of a product is far below its
// rounding); about 2 ulp where the result is normal.
__device__ __forceinline__ float exp_ftz(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x * 1.4426950408889634f));
  return r;
}

// x = hi + lo to about 2^-22 of x, hi and lo in TF32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += A (16 x 8, row) · B (8 x 8, col), TF32 in, f32 accumulate. With
// g = lane / 4 and t = lane % 4: a = {(g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4)}, b = {(k t, n g), (k t + 4, n g)}, d = {(g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)}.
__device__ __forceinline__ void mma1688(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A (16 x 16, row) · B (16 x 8, col), bf16 in, f32 accumulate:
// a = {(g, 2t..), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..)},
// b = {(k 2t.., n g), (k 2t + 8.., n g)}, d as mma1688.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The split product of f32 A and B: the small terms first, then hi·hi.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const float b0, const float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma1688(d, al, bh0, bh1);
  mma1688(d, ah, bl0, bl1);
  mma1688(d, ah, bh0, bh1);
}

// Two bf16 values in one 32-bit register, lo in the low half (exact: the
// inputs are bf16 values widened to f32).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// C[i][n], C[i][n + 1] of a bf16 (Q, N) chunk as one register; zero outside.
__device__ __forceinline__ uint32_t c_pair(const bf16* C, int i, int n, int Q, int N) {
  const unsigned short* c = reinterpret_cast<const unsigned short*>(C) + (int64_t)i * N + n;
  const bool row = i < Q;
  const uint32_t lo = row && n < N ? c[0] : 0u;
  const uint32_t hi = row && n + 1 < N ? c[1] : 0u;
  return lo | (hi << 16);
}

__device__ __forceinline__ float c_at(const float* C, int i, int n, int Q, int N) {
  return i < Q && n < N ? C[(int64_t)i * N + n] : 0.f;
}

// The Qp x Pp tile of u of one head into a slot (row stride LP); rows past
// Q and columns past P are zero-filled.
__device__ __forceinline__ void load_u(float* dst, const float* ug, int Q, int P, const Dims& d,
                                       bool vec) {
  if (vec) {
    const int cpr = d.Pp >> 2;  // 16-byte chunks of a row
    for (int idx = threadIdx.x; idx < d.Qp * cpr; idx += kThreads) {
      const int j = idx / cpr, c = (idx - j * cpr) << 2;
      const bool ok = j < Q && c < P;
      cp_async16(dst + j * d.LP + c, ok ? ug + (int64_t)j * P + c : ug, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < d.Qp * d.Pp; idx += kThreads) {
      const int j = idx / d.Pp, c = idx - j * d.Pp;
      const bool ok = j < Q && c < P;
      cp_async4(dst + j * d.LP + c, ok ? ug + (int64_t)j * P + c : ug, ok);
    }
  }
}

// y on one 8-row tile as yᵀ = uᵀ Dᵀ: A is uᵀ (16 columns p by 8 keys), B the
// tile's C Bᵀ fragments c[kt] (its row r against keys 8kt + 2t, 8kt + 2t + 1,
// kt < nk) decayed by exp(l_r − l_j) and masked; kP column tiles of 16
// at a time, so the decay of a key tile is formed once for them. The output
// fragment holds rows i, i + 1 (i = r - g + 2t) at columns g and g + 8.
template <int kP, int KT>
__device__ __forceinline__ void y_tile(const float (&c)[KT][2], int nk, int r, int i,
                                       const float* sl, const float* su, const Dims& d,
                                       float* yg, int Q, int P, int t, int g) {
  const float lr = sl[r];
  for (int p0 = 0; p0 < d.Pp; p0 += 16 * kP) {
    float acc[kP][4];
#pragma unroll
    for (int cc = 0; cc < kP; ++cc)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[cc][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      if (kt < nk) {
        const int j0 = 8 * kt + 2 * t;
        uint32_t h[2], o[2];
        const float lj0 = sl[j0], lj1 = sl[j0 + 1];
        split(j0 <= r ? c[kt][0] * exp_ftz(lr - lj0) : 0.f, h[0], o[0]);
        split(j0 < r ? c[kt][1] * exp_ftz(lr - lj1) : 0.f, h[1], o[1]);
        const float* ur = su + j0 * d.LP + p0 + g;
#pragma unroll
        for (int cc = 0; cc < kP; ++cc) {
          if (p0 + 16 * cc < d.Pp) {
            const float* uc = ur + 16 * cc;
            uint32_t ah[4], al[4];
            split(uc[0], ah[0], al[0]);
            split(uc[8], ah[1], al[1]);
            split(uc[d.LP], ah[2], al[2]);
            split(uc[d.LP + 8], ah[3], al[3]);
            mma1688(acc[cc], al, h[0], h[1]);
            mma1688(acc[cc], ah, o[0], o[1]);
            mma1688(acc[cc], ah, h[0], h[1]);
          }
        }
      }
    }
#pragma unroll
    for (int cc = 0; cc < kP; ++cc) {
      const int p = p0 + 16 * cc + g;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pe = p + (e >> 1) * 8, ie = i + (e & 1);
        if (pe < P && ie < Q) yg[(int64_t)ie * P + pe] = acc[cc][e];
      }
    }
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_intra_kernel(const SsdArgs a, const bool vec_u, const bool vec_b) {
  extern __shared__ __align__(16) float smem[];
  const int Q = a.Q, N = a.N, P = a.P;
  const Dims d = dims(Q, N, P);
  float* sB = smem;                        // Qp x LN: B of the chunk, widened
  float* sU = sB + d.Qp * d.LN;            // 2 x Qp x LP: u of a head, two slots
  float* sL = sU + 2 * d.Qp * d.LP;        // 8 x Qp: l of each head of the block
  float* sW = sL + kHeadsPerBlock * d.Qp;  // 8 x Qp: w = exp(l_Q − l)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t bc = (int64_t)blockIdx.z * a.nc + blockIdx.y;
  const int h0 = blockIdx.x * kHeadsPerBlock;
  const int nh = min(kHeadsPerBlock, a.H - h0);
  const int64_t uhead = (int64_t)Q * P;

  // B of the chunk and u of the first head, in flight during the scans.
  if constexpr (kBf16) {
    const bf16* Bg = static_cast<const bf16*>(a.Bv) + bc * Q * N;
    for (int idx = tid; idx < d.Qp * d.Np; idx += kThreads) {
      const int j = idx / d.Np, n = idx - j * d.Np;
      sB[j * d.LN + n] = j < Q && n < N ? __bfloat162float(Bg[(int64_t)j * N + n]) : 0.f;
    }
  } else {
    const float* Bg = static_cast<const float*>(a.Bv) + bc * Q * N;
    if (vec_b) {
      const int cpr = d.Np >> 2;
      for (int idx = tid; idx < d.Qp * cpr; idx += kThreads) {
        const int j = idx / cpr, n = (idx - j * cpr) << 2;
        const bool ok = j < Q && n < N;
        cp_async16(sB + j * d.LN + n, ok ? Bg + (int64_t)j * N + n : Bg, ok);
      }
    } else {
      for (int idx = tid; idx < d.Qp * d.Np; idx += kThreads) {
        const int j = idx / d.Np, n = idx - j * d.Np;
        const bool ok = j < Q && n < N;
        cp_async4(sB + j * d.LN + n, ok ? Bg + (int64_t)j * N + n : Bg, ok);
      }
    }
  }
  load_u(sU, a.u + (bc * a.H + h0) * uhead, Q, P, d, vec_u);
  cp_async_commit();

  // l = cumsum(log_a) of head h0 + warp: lane L sums elements [L E, L E + E)
  // in double, a warp scan adds the lanes before it, each l_i is rounded
  // once; then g and w.
  if (warp < nh) {
    const int64_t bch = bc * a.H + h0 + warp;
    const float* la = a.log_a + bch * Q;
    float* sl = sL + warp * d.Qp;
    const int E = (Q + 31) / 32;
    double loc[kMaxQ / 32];
    double run = 0.0;
#pragma unroll
    for (int e = 0; e < kMaxQ / 32; ++e) {
      const int i = lane * E + e;
      if (e < E && i < Q) run += (double)la[i];
      loc[e] = run;
    }
    double incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    double excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.0;
#pragma unroll
    for (int e = 0; e < kMaxQ / 32; ++e) {
      const int i = lane * E + e;
      if (e < E && i < Q) {
        const float li = (float)(excl + loc[e]);
        sl[i] = li;
        a.l[bch * Q + i] = li;
      }
    }
    __syncwarp();
    const float lQ = sl[Q - 1];
    if (lane == 0) a.g[bch] = expf(lQ);
    for (int j = lane; j < d.Qp; j += 32) {
      sW[warp * d.Qp + j] = j < Q ? expf(lQ - sl[j]) : 0.f;
      if (j >= Q) sl[j] = 0.f;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // C Bᵀ of the warp's two 8-row tiles, m and R - 1 - m (rows r1 = 8m + g
  // and r2 = 8(R - 1 - m) + g of lane (g, t)), against their keys, kept in
  // registers: c1[kt] = {(r1, 8kt + 2t), (r1, 8kt + 2t + 1)} for kt <= m,
  // c2[kt] the same for r2 and kt <= R - 1 - m. One m16n8 product gives both:
  // its A rows are the two tiles' rows.
  const int R = d.Qp >> 3;                 // 8-row tiles (even)
  const bool rows = warp < R / 2;
  const int nk1 = warp + 1, nk2 = R - warp;
  const int r1 = 8 * warp + g, r2 = 8 * (R - 1 - warp) + g;
  float c1[kHalf][2], c2[kKeyTiles][2];
#pragma unroll
  for (int kt = 0; kt < kKeyTiles; ++kt) {
    if (kt < kHalf) c1[kt % kHalf][0] = c1[kt % kHalf][1] = 0.f;
    c2[kt][0] = c2[kt][1] = 0.f;
  }
  if (rows) {
    if constexpr (kBf16) {
      const bf16* Cg = static_cast<const bf16*>(a.Cv) + bc * Q * N;
      for (int k0 = 0; k0 < d.Np; k0 += 16) {
        const uint32_t af[4] = {c_pair(Cg, r1, k0 + 2 * t, Q, N), c_pair(Cg, r2, k0 + 2 * t, Q, N),
                                c_pair(Cg, r1, k0 + 2 * t + 8, Q, N),
                                c_pair(Cg, r2, k0 + 2 * t + 8, Q, N)};
#pragma unroll
        for (int kt = 0; kt < kKeyTiles; ++kt) {
          if (kt < nk2) {
            const float* br = sB + (8 * kt + g) * d.LN + k0 + 2 * t;
            float acc[4] = {0.f, 0.f, c2[kt][0], c2[kt][1]};
            if (kt < kHalf) acc[0] = c1[kt % kHalf][0], acc[1] = c1[kt % kHalf][1];
            mma16816(acc, af, pack_bf16(br[0], br[1]), pack_bf16(br[8], br[9]));
            if (kt < kHalf) c1[kt % kHalf][0] = acc[0], c1[kt % kHalf][1] = acc[1];
            c2[kt][0] = acc[2], c2[kt][1] = acc[3];
          }
        }
      }
    } else {
      const float* Cg = static_cast<const float*>(a.Cv) + bc * Q * N;
      for (int k0 = 0; k0 < d.Np; k0 += 8) {
        uint32_t ah[4], al[4];
        split(c_at(Cg, r1, k0 + t, Q, N), ah[0], al[0]);
        split(c_at(Cg, r2, k0 + t, Q, N), ah[1], al[1]);
        split(c_at(Cg, r1, k0 + t + 4, Q, N), ah[2], al[2]);
        split(c_at(Cg, r2, k0 + t + 4, Q, N), ah[3], al[3]);
#pragma unroll
        for (int kt = 0; kt < kKeyTiles; ++kt) {
          if (kt < nk2) {
            const float* br = sB + (8 * kt + g) * d.LN + k0;
            float acc[4] = {0.f, 0.f, c2[kt][0], c2[kt][1]};
            if (kt < kHalf) acc[0] = c1[kt % kHalf][0], acc[1] = c1[kt % kHalf][1];
            mma3(acc, ah, al, br[t], br[t + 4]);
            if (kt < kHalf) c1[kt % kHalf][0] = acc[0], c1[kt % kHalf][1] = acc[1];
            c2[kt][0] = acc[2], c2[kt][1] = acc[3];
          }
        }
      }
    }
  }

  // This warp's run of S tiles: a tile is 16 state rows by 8 columns, listed
  // by columns with bf16 B and by rows with f32 B (see S below). Costs in key steps x (8 x 8) output blocks:
  // y of a warp with rows is (R + 1) PT, a tile of S is 2 Qp / 8; the runs
  // follow each warp's room under the mean.
  const int PT = d.Pp >> 3, MT = d.Np >> 4, NS = MT * PT;
  int s_begin, s_end;
  {
    const int64_t yw = (int64_t)(R + 1) * PT, nrows = R / 2;
    const int64_t total = (int64_t)NS * 2 * (d.Qp >> 3) + nrows * yw;
    int64_t F = 0, cum = 0, mine = 0;
    for (int v = 0; v < kWarps; ++v) {
      const int64_t yv = v < nrows ? yw : 0;
      const int64_t room = total - kWarps * yv > 0 ? total - kWarps * yv : 0;
      if (v < warp) cum += room;
      if (v == warp) mine = room;
      F += room;
    }
    s_begin = (int)((2 * NS * cum + F) / (2 * F));
    s_end = (int)((2 * NS * (cum + mine) + F) / (2 * F));
  }

  for (int hh = 0; hh < nh; ++hh) {
    cp_async_wait_all();
    __syncthreads();  // u of head hh is in; every warp is done with head hh - 1
    if (hh + 1 < nh)
      load_u(sU + ((hh + 1) & 1) * d.Qp * d.LP, a.u + (bc * a.H + h0 + hh + 1) * uhead, Q, P,
             d, vec_u);
    cp_async_commit();
    const float* su = sU + (hh & 1) * d.Qp * d.LP;
    const float* sl = sL + hh * d.Qp;
    const float* sw = sW + hh * d.Qp;
    const int64_t bch = bc * a.H + h0 + hh;

    // y on the warp's two row tiles, one after the other.
    if (rows) {
      float* yg = a.y + bch * uhead;
      constexpr int kP = kPass<kBf16>;
      y_tile<kP>(c1, nk1, r1, 8 * warp + 2 * t, sl, su, d, yg, Q, P, t, g);
      y_tile<kP>(c2, nk2, r2, 8 * (R - 1 - warp) + 2 * t, sl, su, d, yg, Q, P, t, g);
    }

    // S = Bᵀ (u ∘ w) on the warp's run of tiles, up to kR at a time that
    // share an operand: with bf16 B (exact in TF32, never split) tiles of
    // one column share the split of u ∘ w; with f32 B tiles of one row share
    // the split of Bᵀ.
    float* Sg = a.S + bch * N * P;
    constexpr int kR = kRun<kBf16>;
    for (int s = s_begin; s < s_end;) {
      int ms, nt, cnt;
      if constexpr (kBf16) {
        nt = s / MT, ms = s - nt * MT;
        cnt = min(kR, min(MT - ms, s_end - s));
      } else {
        ms = s / PT, nt = s - ms * PT;
        cnt = min(kR, min(PT - nt, s_end - s));
      }
      float acc[kR][4];
#pragma unroll
      for (int c = 0; c < kR; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
      for (int k0 = 0; k0 < d.Qp; k0 += 8) {
        const int j0 = k0 + 2 * t;
        const float w0 = sw[j0], w1 = sw[j0 + 1];
        const float* br = sB + j0 * d.LN + 16 * ms + g;  // Bᵀ rows 16 ms + g, + 8
        const float* ur = su + j0 * d.LP + 8 * nt + g;   // u ∘ w columns 8 nt + g
        if constexpr (kBf16) {
          uint32_t bh0, bl0, bh1, bl1;
          split(ur[0] * w0, bh0, bl0);
          split(ur[d.LP] * w1, bh1, bl1);
#pragma unroll
          for (int c = 0; c < kR; ++c) {
            if (c < cnt) {
              const float* bc = br + 16 * c;
              const uint32_t af[4] = {__float_as_uint(bc[0]), __float_as_uint(bc[8]),
                                      __float_as_uint(bc[d.LN]), __float_as_uint(bc[d.LN + 8])};
              mma1688(acc[c], af, bl0, bl1);
              mma1688(acc[c], af, bh0, bh1);
            }
          }
        } else {
          uint32_t ah[4], al[4];
          split(br[0], ah[0], al[0]);
          split(br[8], ah[1], al[1]);
          split(br[d.LN], ah[2], al[2]);
          split(br[d.LN + 8], ah[3], al[3]);
#pragma unroll
          for (int c = 0; c < kR; ++c)
            if (c < cnt) mma3(acc[c], ah, al, ur[8 * c] * w0, ur[d.LP + 8 * c] * w1);
        }
      }
#pragma unroll
      for (int c = 0; c < kR; ++c) {
        if (c >= cnt) continue;
        const int r0 = 16 * (kBf16 ? ms + c : ms) + g, r1 = r0 + 8;
        const int p = 8 * (kBf16 ? nt : nt + c) + 2 * t;
        if (r0 < N) {
          if (p < P) Sg[(int64_t)r0 * P + p] = acc[c][0];
          if (p + 1 < P) Sg[(int64_t)r0 * P + p + 1] = acc[c][1];
        }
        if (r1 < N) {
          if (p < P) Sg[(int64_t)r1 * P + p] = acc[c][2];
          if (p + 1 < P) Sg[(int64_t)r1 * P + p + 1] = acc[c][3];
        }
      }
      s += cnt;
    }
  }
}

template <bool kBf16>
int launch(const SsdArgs& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)smem_floats(a.Q, a.N, a.P);
  void (*kern)(const SsdArgs, const bool, const bool) = ssd_intra_kernel<kBf16>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec_u = a.P % 4 == 0 && reinterpret_cast<uintptr_t>(a.u) % 16 == 0;
  const bool vec_b = !kBf16 && a.N % 4 == 0 && reinterpret_cast<uintptr_t>(a.Bv) % 16 == 0;
  const dim3 grid((a.H + kHeadsPerBlock - 1) / kHeadsPerBlock, a.nc, a.B);
  kern<<<grid, kThreads, smem, stream>>>(a, vec_u, vec_b);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int64_t ssd_intra_smem_bytes(int Q, int N, int P) {
  return (int64_t)sizeof(float) * smem_floats(Q, N, P);
}

int ssd_intra(const SsdArgs* a, cudaStream_t stream) {
  if (a->B < 1 || a->B > 65535 || a->nc < 1 || a->nc > 65535 || a->H < 1 || a->Q < 1 ||
      a->Q > kMaxQ || a->N < 1 || a->N > kMaxNP || a->P < 1 || a->P > kMaxNP ||
      ssd_intra_smem_bytes(a->Q, a->N, a->P) > kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  if (a->bc_dtype == 0) return launch<false>(*a, stream);
  if (a->bc_dtype == 1) return launch<true>(*a, stream);
  return (int)cudaErrorInvalidValue;
}
}
