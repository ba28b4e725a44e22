// Plain C interface of the SSD intra-chunk kernel (ssd_scan.cu), shared by
// the kernel and its PyTorch binding (cg_fused_bind.cpp).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

extern "C" {

// Everything a launch needs. Pointers are to contiguous tensors in the
// reference's layout: u (B, nc, H, Q, P) and log_a (B, nc, H, Q) float32;
// Bv, Cv (B, nc, Q, N), shared across heads, float32 (bc_dtype 0) or
// bfloat16 (1). Outputs, all float32: y (B, nc, H, Q, P), S (B, nc, H, N, P),
// g (B, nc, H) and l (B, nc, H, Q).
struct SsdArgs {
  const float* u;
  const float* log_a;
  const void* Bv;
  const void* Cv;
  float* y;
  float* S;
  float* g;
  float* l;
  int B, nc, H, Q, N, P;
  int bc_dtype;
};

// Dynamic shared memory of one block, in bytes, at (Q, N, P).
int64_t ssd_intra_smem_bytes(int Q, int N, int P);

// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue for a
// shape or dtype the kernel does not take (1 <= Q <= 128, 1 <= N, P <= 256
// and ssd_intra_smem_bytes(Q, N, P) <= 232448).
int ssd_intra(const SsdArgs* a, cudaStream_t stream);
}
