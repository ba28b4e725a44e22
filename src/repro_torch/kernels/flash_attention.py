"""Launches the flash-attention CUDA kernels (``csrc/flash_attention.cu``).

Twins of the Pallas kernels in ``repro/kernels/flash_attention.py``:
``flash_attention_fwd`` (o, lse), ``flash_attention_dq`` (dq),
``flash_attention_dkv`` (per-q-head dk_h, dv_h in f32) and
``flash_attention_jvp`` (g, t in f32), with the reference's layout: q
(B, Sq, H, hd), k/v (B, Sk, KV, hd), lse and Δ (B, H, Sq), bias (B|1, Sq, Sk)
f32. In bf16 all four run on the tensor cores; in f32 all four run in f32
FFMA. They are built into the port's one extension (``cg_fused.extension``)
at first use. Every wrapper checks device, dtype, shape, head dim and
contiguity and raises on anything else; it never falls back to the plain
version.
"""
from __future__ import annotations

import torch

from .cg_fused import extension

MAX_HEAD_DIM = 128  # head dims: multiples of 8 up to this (csrc: FFMA widths 32, 64, 128;
                    # tensor-core widths the multiples of 16)
DTYPES = (torch.float32, torch.bfloat16)


def check_head_dim(hd):
    """Raise unless the kernels take head dim ``hd``: a multiple of 8 (16-byte
    loads in f32 and bf16) from 8 to ``MAX_HEAD_DIM``."""
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} is not a multiple of 8 from 8 to {MAX_HEAD_DIM}")


def _check_qkv(q, k, v):
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor")
        if t.ndim != 4:
            raise ValueError(f"{name} must be 4-D, got {tuple(t.shape)}")
        if t.dtype not in DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    B, Sq, H, hd = q.shape
    check_head_dim(hd)
    if min(B, Sq, H) == 0 or k.shape[1] == 0 or k.shape[2] == 0:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)}, {tuple(v.shape)} do not fit q "
                         f"{tuple(q.shape)} (B, Sk, KV, hd with KV dividing H)")
    for t, name in ((k, "k"), (v, "v")):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{name} must have q's dtype and device")
    _check_layout((q, k, v), ("q", "k", "v"))


def _check_layout(tensors, names):
    for t, name in zip(tensors, names):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _check_like(t, name, like):
    if not isinstance(t, torch.Tensor) or t.shape != like.shape or t.dtype != like.dtype \
            or t.device != like.device:
        raise ValueError(f"{name} must match {tuple(like.shape)} {like.dtype} on "
                         f"{like.device}")
    _check_layout((t,), (name,))


def _check_rows(t, name, q):
    B, Sq, H, _ = q.shape
    if not isinstance(t, torch.Tensor) or t.shape != (B, H, Sq) or t.dtype != torch.float32 \
            or t.device != q.device:
        raise ValueError(f"{name} must be float32 ({B}, {H}, {Sq}) on {q.device}")
    _check_layout((t,), (name,))


def _bias_arg(bias, q, k):
    if bias is None:
        return torch.empty(0, dtype=torch.float32, device=q.device)
    B, Sq = q.shape[:2]
    if bias.ndim != 3 or bias.shape[0] not in (1, B) or bias.shape[1:] != (Sq, k.shape[1]):
        raise ValueError(f"bias must be (B|1, {Sq}, {k.shape[1]}), got {tuple(bias.shape)}")
    if bias.dtype != torch.float32 or bias.device != q.device:
        raise TypeError("bias must be float32 on q's device")
    _check_layout((bias,), ("bias",))
    return bias


def _opts(q, causal, window, valid_len, scale):
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0 or None, got {window}")
    if valid_len is not None and valid_len < 0:
        raise ValueError(f"valid_len must be >= 0 or None, got {valid_len}")
    scale = float(scale if scale is not None else 1.0 / q.shape[3] ** 0.5)
    return (bool(causal), -1 if window is None else int(window),
            -1 if valid_len is None else int(valid_len), scale)


def flash_attention_fwd(q, k, v, *, causal=True, window=None, valid_len=None, scale=None,
                        bias=None):
    """(o (B, Sq, H, hd) in q's dtype, lse (B, H, Sq) f32)."""
    _check_qkv(q, k, v)
    b = _bias_arg(bias, q, k)
    o, lse = extension().flash_fwd(q, k, v, b, *_opts(q, causal, window, valid_len, scale))
    return o, lse


def flash_attention_dq(q, k, v, do, lse, delta, *, causal=True, window=None,
                       valid_len=None, scale=None, bias=None):
    """dq (B, Sq, H, hd) in q's dtype, from the stored lse and Δ = rowsum(dO∘O)."""
    _check_qkv(q, k, v)
    _check_like(do, "do", q)
    _check_rows(lse, "lse", q)
    _check_rows(delta, "delta", q)
    b = _bias_arg(bias, q, k)
    return extension().flash_dq(q, k, v, do, lse, delta, b,
                                *_opts(q, causal, window, valid_len, scale))


def flash_attention_dkv(q, k, v, do, lse, delta, *, causal=True, window=None,
                        valid_len=None, scale=None, bias=None):
    """Per-q-head (dk_h, dv_h), each (B, Sk, H, hd) f32; the caller sums each
    GQA group."""
    _check_qkv(q, k, v)
    _check_like(do, "do", q)
    _check_rows(lse, "lse", q)
    _check_rows(delta, "delta", q)
    b = _bias_arg(bias, q, k)
    dk, dv = extension().flash_dkv(q, k, v, do, lse, delta, b,
                                   *_opts(q, causal, window, valid_len, scale))
    return dk, dv


def flash_attention_jvp(q, k, v, qt, kt, vt, lse, *, causal=True, window=None,
                        valid_len=None, scale=None, bias=None):
    """(g (B, Sq, H, hd) f32, t (B, H, Sq) f32) of the tangent pass; the caller
    forms ȯ = g − t∘o."""
    _check_qkv(q, k, v)
    _check_like(qt, "qt", q)
    _check_like(kt, "kt", k)
    _check_like(vt, "vt", v)
    _check_rows(lse, "lse", q)
    b = _bias_arg(bias, q, k)
    g, t = extension().flash_jvp(q, k, v, qt, kt, vt, lse, b,
                                 *_opts(q, causal, window, valid_len, scale))
    return g, t
