// SSD (Mamba2) intra-chunk kernel for Hopper (sm_90a); plain C interface
// (ssd_scan.h).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd_scan.py:
//   ssd_intra_kernel <- _ssd_intra_kernel / ssd_intra
// For each (batch b, chunk c, head h), with B and C shared across heads:
//   l = cumsum(log_a)                                   (Q,)
//   y = ((C Bᵀ) ∘ exp(l_i − l_j) ∘ [i >= j]) u          (Q, P)
//   S = Bᵀ (u ∘ exp(l_Q − l))                           (N, P)
//   g = exp(l_Q)
// every product accumulated in f32, B and C widened on load from f32 or
// bf16 as the TPU kernel's astype(f32) does. The scan between chunks stays
// in torch (kernels/ssd_scan.py), as it stays in jnp.
//
// What bounds it on this card. At the serving slice's prefill (zamba2-7b:
// B 8, L 896 -> nc 7 chunks of Q 128, H 112 heads of P 64, state N 64) the
// causal triangle's Q(Q+1)/2 pairs need 2N of them once per (b, c) for
// C Bᵀ and, per head, 2P for y and 2NQP for S: 13.26 GFLOP, 0.198 ms at
// the 67 TFLOP/s of f32 FFMA (19.85 GFLOP and 0.296 ms if the full Q x Q
// square is counted). It must move u and y (205.5 MB each), S (102.8 MB),
// log_a and l (3.2 MB each) and B, C: 521 MB, 0.156 ms at 3.35 TB/s. So it
// is bound by its f32 operations. What the design does about them:
//   * One block per (b, c, group of 8 heads), not per (b, c, h): B and C are
//     indexed by (b, c) alone, so the block stages them once and forms
//     C Bᵀ once for its 8 heads, where the TPU kernel forms it per head.
//     Groups of 8 give 784 blocks at the slice's shape (about 6 waves of one
//     block per SM), and C Bᵀ costs 6% on top of the heads' own work.
//   * Only the causal triangle is formed: C Bᵀ and its decayed copy are
//     packed lower triangles in shared memory, and the key loop of y skips
//     the pairs above the diagonal. The mask selects (exp(l_i − l_j) above
//     the diagonal may be inf, and 0·inf is NaN); it never multiplies.
//   * Per head, warp 0 scans log_a (a warp scan over lanes holding Q/32
//     elements each) while the other warps stage u. The sum is kept in
//     double and rounded to f32 once, so l is the correctly rounded cumsum
//     and the plain version (kernels/ref.py ssd_intra_ref) gets the same
//     bits: g = exp(l_Q) is then held to 1e-5 even where l_Q is near -100.
//   * The products y = D u and S = Bᵀ(u ∘ w) run as f32 FFMA from shared
//     memory on a 16 x 16 thread grid, each thread holding up to 8 rows x
//     P/16 columns of accumulators in registers; rows of B, C and u are
//     padded by one float so that a warp's column reads hit distinct banks.
// Left for later (ROADMAP): mma.sync or wgmma tiles in TF32 or bf16 where
// parity allows, and a second u tile in flight.
//
// Shared memory of a block: B and C (Q x (N+1) each), the two triangles
// (Q(Q+1)/2 each), u (Q x (P+1)), l and w (Q each), in f32: 163 KB at
// Q 128, N 64, P 64, so the launch raises the dynamic shared memory limit.
//
// The kernel launches on the caller's stream and allocates nothing; the
// binding (cg_fused_bind.cpp) allocates the outputs and checks the launch.

#include "ssd_scan.h"

#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeadsPerBlock = 8;
constexpr int kMaxDim = 128;               // most Q, N and P
constexpr int kSide = 16;                  // the products' thread grid is kSide x kSide
constexpr int kMaxRows = kMaxDim / kSide;  // rows of a product per thread, at most
constexpr int64_t kMaxSmemBytes = 232448;  // what one block may use on Hopper

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// Start of row i in a packed lower triangle (row i holds i + 1 entries).
__host__ __device__ __forceinline__ int tri(int i) { return i * (i + 1) / 2; }

int64_t smem_floats(int Q, int N, int P) {
  return 2LL * Q * (N + 1) + 2LL * tri(Q) + (int64_t)Q * (P + 1) + 2LL * Q;
}

template <class T, int CM>
__global__ void __launch_bounds__(kThreads) ssd_intra_kernel(const SsdArgs a) {
  extern __shared__ float smem[];
  const int Q = a.Q, N = a.N, P = a.P, LN = N + 1, LP = P + 1;
  float* sB = smem;           // Q x LN: B of the chunk
  float* sC = sB + Q * LN;    // Q x LN: C of the chunk
  float* sS = sC + Q * LN;    // triangle: C Bᵀ
  float* sD = sS + tri(Q);    // triangle: C Bᵀ ∘ exp(l_i − l_j) of one head
  float* sU = sD + tri(Q);    // Q x LP: u of one head, then u ∘ w
  float* sL = sU + Q * LP;    // Q: l of one head
  float* sW = sL + Q;         // Q: w = exp(l_Q − l)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t bc = (int64_t)blockIdx.z * a.nc + blockIdx.y;

  const T* Bg = static_cast<const T*>(a.Bv) + bc * Q * N;
  const T* Cg = static_cast<const T*>(a.Cv) + bc * Q * N;
  for (int idx = tid; idx < Q * N; idx += kThreads) {
    const int j = idx / N, n = idx - j * N;
    sB[j * LN + n] = widen(Bg[idx]);
    sC[j * LN + n] = widen(Cg[idx]);
  }
  __syncthreads();
  // C Bᵀ on and below the diagonal: warp w takes rows w, w + 8, ...; lane j
  // reads row j of B.
  for (int i = warp; i < Q; i += kWarps) {
    const float* ci = sC + i * LN;
    for (int j = lane; j <= i; j += 32) {
      const float* bj = sB + j * LN;
      float s = 0.f;
      for (int n = 0; n < N; ++n) s = fmaf(ci[n], bj[n], s);
      sS[tri(i) + j] = s;
    }
  }

  const int rt = tid / kSide, ct = tid - rt * kSide;
  const int h_end = min((int)(blockIdx.x + 1) * kHeadsPerBlock, a.H);
  for (int h = blockIdx.x * kHeadsPerBlock; h < h_end; ++h) {
    const int64_t bch = bc * a.H + h;
    if (warp == 0) {
      // l = cumsum(log_a): lane L sums elements [L E, L E + E) in double,
      // a warp scan adds the lanes before it, and each l_i is rounded once.
      const float* la = a.log_a + bch * Q;
      const int E = (Q + 31) / 32;
      double loc[kMaxDim / 32];
      double run = 0.0;
#pragma unroll
      for (int e = 0; e < kMaxDim / 32; ++e) {
        const int i = lane * E + e;
        if (e < E && i < Q) run += (double)la[i];
        loc[e] = run;
      }
      double incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      double excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.0;
#pragma unroll
      for (int e = 0; e < kMaxDim / 32; ++e) {
        const int i = lane * E + e;
        if (e < E && i < Q) {
          const float li = (float)(excl + loc[e]);
          sL[i] = li;
          a.l[bch * Q + i] = li;
        }
      }
    } else {
      const float* ug = a.u + bch * Q * P;
      for (int idx = tid - 32; idx < Q * P; idx += kThreads - 32) {
        const int j = idx / P, p = idx - j * P;
        sU[j * LP + p] = ug[idx];
      }
    }
    __syncthreads();

    const float lQ = sL[Q - 1];
    if (tid == 0) a.g[bch] = expf(lQ);
    for (int i = warp; i < Q; i += kWarps) {
      const float li = sL[i];
      for (int j = lane; j <= i; j += 32) sD[tri(i) + j] = sS[tri(i) + j] * expf(li - sL[j]);
    }
    for (int j = tid; j < Q; j += kThreads) sW[j] = expf(lQ - sL[j]);
    __syncthreads();

    // y = D u: thread (rt, ct) owns rows rt + 16m and columns ct + 16k; a
    // key j reaches only the rows at or below it.
    float acc[kMaxRows][CM];
#pragma unroll
    for (int m = 0; m < kMaxRows; ++m)
#pragma unroll
      for (int k = 0; k < CM; ++k) acc[m][k] = 0.f;
    for (int j = 0; j < Q; ++j) {
      float uv[CM];
#pragma unroll
      for (int k = 0; k < CM; ++k) {
        const int p = ct + kSide * k;
        uv[k] = p < P ? sU[j * LP + p] : 0.f;
      }
#pragma unroll
      for (int m = 0; m < kMaxRows; ++m) {
        const int i = rt + kSide * m;
        if (i >= Q || j > i) continue;
        const float w = sD[tri(i) + j];
#pragma unroll
        for (int k = 0; k < CM; ++k) acc[m][k] = fmaf(w, uv[k], acc[m][k]);
      }
    }
    float* yg = a.y + bch * Q * P;
#pragma unroll
    for (int m = 0; m < kMaxRows; ++m) {
      const int i = rt + kSide * m;
      if (i >= Q) continue;
#pragma unroll
      for (int k = 0; k < CM; ++k) {
        const int p = ct + kSide * k;
        if (p < P) yg[(int64_t)i * P + p] = acc[m][k];
      }
    }
    __syncthreads();  // every read of u is done
    for (int idx = tid; idx < Q * P; idx += kThreads) {
      const int j = idx / P, p = idx - j * P;
      sU[j * LP + p] *= sW[j];
    }
    __syncthreads();

    // S = Bᵀ (u ∘ w): thread (rt, ct) owns state rows rt + 16m and columns
    // ct + 16k.
#pragma unroll
    for (int m = 0; m < kMaxRows; ++m)
#pragma unroll
      for (int k = 0; k < CM; ++k) acc[m][k] = 0.f;
    for (int j = 0; j < Q; ++j) {
      float uv[CM];
#pragma unroll
      for (int k = 0; k < CM; ++k) {
        const int p = ct + kSide * k;
        uv[k] = p < P ? sU[j * LP + p] : 0.f;
      }
#pragma unroll
      for (int m = 0; m < kMaxRows; ++m) {
        const int n = rt + kSide * m;
        if (n >= N) continue;
        const float bv = sB[j * LN + n];
#pragma unroll
        for (int k = 0; k < CM; ++k) acc[m][k] = fmaf(bv, uv[k], acc[m][k]);
      }
    }
    float* Sg = a.S + bch * N * P;
#pragma unroll
    for (int m = 0; m < kMaxRows; ++m) {
      const int n = rt + kSide * m;
      if (n >= N) continue;
#pragma unroll
      for (int k = 0; k < CM; ++k) {
        const int p = ct + kSide * k;
        if (p < P) Sg[(int64_t)n * P + p] = acc[m][k];
      }
    }
    __syncthreads();  // before the next head writes l, D and u
  }
}

template <class T, int CM>
int launch(const SsdArgs& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)smem_floats(a.Q, a.N, a.P);
  void (*kern)(const SsdArgs) = ssd_intra_kernel<T, CM>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.H + kHeadsPerBlock - 1) / kHeadsPerBlock, a.nc, a.B);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Accumulator columns per thread: P / 16, rounded up to 1, 2, 4 or 8.
template <class T>
int dispatch_p(const SsdArgs& a, cudaStream_t stream) {
  if (a.P <= 16) return launch<T, 1>(a, stream);
  if (a.P <= 32) return launch<T, 2>(a, stream);
  if (a.P <= 64) return launch<T, 4>(a, stream);
  return launch<T, 8>(a, stream);
}

}  // namespace

extern "C" {

int64_t ssd_intra_smem_bytes(int Q, int N, int P) {
  return (int64_t)sizeof(float) * smem_floats(Q, N, P);
}

int ssd_intra(const SsdArgs* a, cudaStream_t stream) {
  if (a->B < 1 || a->B > 65535 || a->nc < 1 || a->nc > 65535 || a->H < 1 || a->Q < 1 ||
      a->Q > kMaxDim || a->N < 1 || a->N > kMaxDim || a->P < 1 || a->P > kMaxDim ||
      ssd_intra_smem_bytes(a->Q, a->N, a->P) > kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  if (a->bc_dtype == 0) return dispatch_p<float>(*a, stream);
  if (a->bc_dtype == 1) return dispatch_p<__nv_bfloat16>(*a, stream);
  return (int)cudaErrorInvalidValue;
}
}
