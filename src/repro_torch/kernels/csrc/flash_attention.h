// Plain C interface of the flash-attention kernels (flash_attention.cu),
// shared by the kernels and their PyTorch binding (cg_fused_bind.cpp).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

extern "C" {

// Everything a launch needs. Pointers are to contiguous tensors in the
// reference's layout: q, o, do, qt, dq, g (B, Sq, H, hd); k, v, kt, vt
// (B, Sk, KV, hd); dk_h, dv_h (B, Sk, H, hd); lse, delta, t (B, H, Sq);
// bias (bias_b, Sq, Sk) with bias_b 1 (broadcast over the batch) or B.
// Element type of q, k, v, o, do, qt, kt, vt, dq: dtype 0 = float32,
// 1 = bfloat16. lse, delta, bias, dk_h, dv_h, g and t are float32.
struct FaArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;   // dO (dq, dkv)
  const void* qt;     // tangents (jvp)
  const void* kt;
  const void* vt;
  const float* lse;   // (dq, dkv, jvp)
  const float* delta; // rowsum(dO * O) (dq, dkv)
  const float* bias;  // may be null
  void* o;            // fwd: o; dq: dq
  float* lse_out;     // fwd
  float* dk;          // dkv: dk_h
  float* dv;          // dkv: dv_h
  float* g;           // jvp
  float* t;           // jvp
  int B, Sq, Sk, H, KV, hd;
  int bias_b;
  float scale;
  int causal;
  int has_window, window;
  int valid_len;      // < 0: none
  int dtype;
};

// Each returns cudaGetLastError() after its launch (cudaSuccess when no
// block was needed); cudaErrorInvalidValue for a head dim (any multiple of
// 8 from 8 to 128 is taken) or dtype the kernels do not take.
int fa_forward(const FaArgs* a, cudaStream_t stream);
int fa_dq(const FaArgs* a, cudaStream_t stream);
int fa_dkv(const FaArgs* a, cudaStream_t stream);
int fa_jvp(const FaArgs* a, cudaStream_t stream);
}
