"""Primitive layers: norms, MLPs, embeddings, RoPE (twin of
``repro/models/layers.py``).

Functional style: ``*_init`` builds a parameter dict (keys sorted, as
``jax.tree_util`` flattens them), the apply functions are pure. Weights are
``w`` of shape (d_in, d_out), as in the reference. Every initializer draws
from a ``torch.Generator`` on the generator's device and takes ``lead``, the
leading (stacked layer) dims of each leaf; the numbers differ from
``jax.random``'s, so parity tests carry the reference's weights over
(``interop.params_from_numpy``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .._device import resolve_device


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _randn(gen, shape):
    return torch.randn(shape, generator=gen, device=gen.device)


def dense_init(gen, d_in, d_out, dtype, scale=None, bias=False, lead=()):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {}
    if bias:
        p["b"] = torch.zeros(tuple(lead) + (d_out,), dtype=dtype, device=gen.device)
    p["w"] = (_randn(gen, tuple(lead) + (d_in, d_out)) * scale).to(dtype)
    return p


def dense(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def norm_init(d, dtype, kind="rmsnorm", lead=(), device="cuda"):
    """Norm parameters on ``device`` (the card unless the caller asks for
    the CPU): scale 1 and, for a layernorm, bias 0."""
    device = resolve_device(device)
    p = {}
    if kind == "layernorm":
        p["bias"] = torch.zeros(tuple(lead) + (d,), dtype=dtype, device=device)
    p["scale"] = torch.ones(tuple(lead) + (d,), dtype=dtype, device=device)
    return p


def apply_norm(p, x, eps=1e-5):
    xf = x.float()
    if "bias" in p:  # layernorm
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps)
    return (y * p["scale"].float()).to(x.dtype)


def mlp_init(gen, d, d_ff, dtype, act="swiglu", lead=()):
    if act == "swiglu":
        return {
            "wg": dense_init(gen, d, d_ff, dtype, lead=lead),
            "wi": dense_init(gen, d, d_ff, dtype, lead=lead),
            "wo": dense_init(gen, d_ff, d, dtype, lead=lead),
        }
    return {"wi": dense_init(gen, d, d_ff, dtype, lead=lead),
            "wo": dense_init(gen, d_ff, d, dtype, lead=lead)}


def apply_mlp(p, x):
    if "wg" in p:
        h = F.silu(dense(p["wg"], x)) * dense(p["wi"], x)
    else:
        h = F.gelu(dense(p["wi"], x), approximate="tanh")  # jax.nn.gelu's default
    return dense(p["wo"], h)


def embedding_init(gen, vocab, d, dtype):
    return {"table": (_randn(gen, (vocab, d)) * 0.02).to(dtype)}


def embed(p, tokens):
    return F.embedding(tokens, p["table"])


def unembed(p, x):
    """Tied head: logits in f32 for loss stability."""
    return x.float() @ p["table"].float().T


# ---------------------------------------------------------------- RoPE ----
def rope_freqs(head_dim, rope_fraction, theta, device="cuda"):
    """Rotary frequencies over the first ``fraction`` of the head dim, on
    ``device`` (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    rot = int(head_dim * rope_fraction)
    rot -= rot % 2
    inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot))
    return inv, rot


def apply_rope(x, positions, *, rope_fraction=1.0, theta=1e4):
    """x: (..., S, H, hd); positions: broadcastable to (..., S).
    ``rope_fraction < 1`` rotates only the leading slice (ChatGLM-style
    partial rotary); the rest passes through."""
    hd = x.shape[-1]
    inv, rot = rope_freqs(hd, rope_fraction, theta, device=x.device)
    if rot == 0:
        return x
    ang = positions[..., :, None].float() * inv          # (..., S, rot/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    xr = x[..., :rot].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    xr = torch.stack([r1, r2], dim=-1).reshape(xr.shape)
    return torch.cat([xr.to(x.dtype), x[..., rot:]], dim=-1)
