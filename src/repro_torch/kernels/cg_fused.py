"""Builds and launches the fused Krylov CUDA kernels (``csrc/cg_fused.cu``).

Twins of the Pallas kernels in ``repro/kernels/cg_fused.py`` (``dot2``,
``x_update``, ``residual_dots``). The extension is compiled for ``sm_90a``
with ``torch.utils.cpp_extension.load`` at first use, into ``_build/`` beside
this file (listed in ``.gitignore``); nothing is built when the module is
imported. Every wrapper checks device, dtype, shape and contiguity and
raises on anything else; it never falls back to the plain version.
"""
from __future__ import annotations

import time
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = (_CSRC / "cg_fused_bind.cpp", _CSRC / "cg_fused.cu")
CUDA_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17")

_ext = None
build_seconds = None  # wall time of the one build in this process


def extension():
    """The compiled extension; builds it on the first call."""
    global _ext, build_seconds
    if _ext is None:
        from torch.utils.cpp_extension import load

        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        _ext = load(
            name="repro_torch_cg_fused",
            sources=[str(s) for s in SOURCES],
            build_directory=str(BUILD_DIR),
            extra_cflags=["-O2"],
            extra_cuda_cflags=list(CUDA_FLAGS),
        )
        build_seconds = time.perf_counter() - t0
    return _ext


def _check_vec(t, name, n):
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.ndim != 1 or t.shape[0] != n or n == 0:
        raise ValueError(f"{name} must be 1-D of length {n} > 0, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_scalar(t, name, like):
    if not isinstance(t, torch.Tensor) or t.device != like.device:
        raise ValueError(f"{name} must be a tensor on {like.device}")
    if t.dtype != torch.float32 or t.numel() != 1:
        raise TypeError(f"{name} must be one float32 value")


def dot2(u, v):
    """(<u,v>, <v,v>) of flat f32 CUDA vectors, as two 0-dim tensors."""
    n = u.shape[0] if isinstance(u, torch.Tensor) and u.ndim == 1 else -1
    _check_vec(u, "u", n)
    _check_vec(v, "v", n)
    d = extension().dot2(u, v)
    return d[0], d[1]


def x_update(x, p, s, alpha, gamma):
    """x + alpha*p + gamma*s; alpha and gamma are one-element f32 tensors
    on the same card (read there, never copied to the host)."""
    n = x.shape[0] if isinstance(x, torch.Tensor) and x.ndim == 1 else -1
    for t, name in ((x, "x"), (p, "p"), (s, "s")):
        _check_vec(t, name, n)
    _check_scalar(alpha, "alpha", x)
    _check_scalar(gamma, "gamma", x)
    return extension().x_update(x, p, s, alpha, gamma)


def residual_dots(s, As, r0s, gamma):
    """r = s - gamma*As; returns (r, <r,r0s>, <r,r>)."""
    n = s.shape[0] if isinstance(s, torch.Tensor) and s.ndim == 1 else -1
    for t, name in ((s, "s"), (As, "As"), (r0s, "r0s")):
        _check_vec(t, name, n)
    _check_scalar(gamma, "gamma", s)
    r, d = extension().residual_dots(s, As, r0s, gamma)
    return r, d[0], d[1]
