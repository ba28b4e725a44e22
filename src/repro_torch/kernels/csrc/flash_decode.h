// Plain C interface of the split-K flash-decode kernels (flash_decode.cu),
// shared by the kernels and their PyTorch binding (cg_fused_bind.cpp).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

extern "C" {

// Everything a launch needs. Pointers are to contiguous tensors in the
// reference's layout: q (B, H, hd); dense k, v (B, W, KV, hd) with bias
// (bias_b, W), bias_b 1 (one row for every sequence) or B; paged pools
// k, v (P, ps, KV, hd) with page_table (B, maxp) int32 and bias
// (B, maxp * ps). Outputs of both kernels, their splits (dense) or pages
// (paged) merged: o (B, H, hd) in q's dtype, m and l (B, H) float32.
// Element type of q, k, v, o: dtype 0 = float32, 1 = bfloat16.
struct FdArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  const int* page_table;  // paged only; null for the dense kernel
  void* o;
  float* m;
  float* l;
  int B, H, KV, hd;
  int W;       // dense: keys per sequence
  int bias_b;  // dense: rows of bias (1 or B)
  int ns;      // splits (dense, 1 to 8) or logical pages a row (paged, max_pages)
  int span;    // dense: keys per split; paged: page size
  int P;       // paged: pages in the pool
  float scale;
  int dtype;
};

// Each returns cudaGetLastError() after its launch; cudaErrorInvalidValue
// for a head dim (any multiple of 8 from 8 to 128 is taken), group size
// (up to 32), split count (dense: up to 8), page size (paged: a multiple
// of 8 up to 128) or dtype the kernels do not take.
int fd_dense(const FdArgs* a, cudaStream_t stream);
int fd_paged(const FdArgs* a, cudaStream_t stream);
}
