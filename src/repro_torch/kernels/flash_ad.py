"""Differentiable flash attention: the AD closure over the four flash
kernels (twin of ``repro/kernels/flash_ad.py``).

``flash_mha`` is the training-path entry point (``models.attention`` routes
``attend_full`` here under ``cfg.use_flash_attention``). It composes with
every product the HF optimizer takes of the loss:

* the gradient (``torch.func.grad_and_value`` in ``core.hf``) runs the
  forward, dQ and dK/dV kernels;
* the Gauss-Newton product of ``core.curvature`` runs its Jᵀu as a backward
  (dQ and dK/dV kernels) and its J·v as the backward of that Jᵀu graph with
  respect to u (the JVP kernel); the in-call form (``torch.func.jvp``) runs
  the JVP kernel through ``FlashAttention.jvp``;
* the Armijo line search and every loss-only evaluation run the forward
  kernel under ``torch.no_grad()``.

**First-order structure.** The reference pairs its tangent rule with its
transpose through ``linear_call``. Here two ``torch.autograd.Function``\\ s
give the same pairing:

* ``FlashAttention(q, k, v, bias) → (o, lse)``: the forward kernel; its
  ``backward`` is ``FlashAttentionVJP`` applied to dO, its ``jvp`` the JVP
  kernel with ȯ = g − t∘o.
* ``FlashAttentionVJP(do, q, k, v, o, lse, bias) → (dq, dk, dv)``: Δ in
  torch, the dQ and dK/dV kernels and the GQA group-sum. The residuals enter
  detached, so its graph is linear in dO alone, and its ``backward`` is the
  transpose of that linear map, J applied to (q̄, k̄, v̄): the JVP kernel.

Reverse mode saves only (q, k, v, o, lse), O(S) residuals per row instead of
the (S, S) weights.

**Second-order structure.** The detached residuals drop the terms of the
second derivative of attention in (q, k, v). That is exact for the GN
product, and wrong for an exact Hessian (reverse-over-reverse in the cached
modes, forward-over-reverse in the in-call ones). As in the reference, every
exact-Hessian build runs under ``second_order_tangents()``; there
``flash_mha`` routes to ``_chunked_attention``, plain torch over query
blocks, which autograd differentiates twice by its own rules. The curvature
engine (``core.curvature``) does this for every exact-Hessian mode, and
``core.hf`` for the GN operator of the s-step solvers, whose batched block
products have no rule through the Functions. **A Hessian written by hand
outside the context silently misses attention's second-order terms** under
reverse-over-reverse; forward-over-reverse reaches
``FlashAttentionVJP.jvp``, which raises with the remedy.

Lengths that are not a multiple of 128 are zero-padded to the next one (as
the reference pads to the TPU's lane tile), the padded key tail is masked
with ``valid_len`` and the padded query rows are sliced off; the pad and the
slice are ordinary torch, transparent to every product above.
"""
from __future__ import annotations

import contextlib

import torch
import torch.utils.checkpoint
import torch.nn.functional as F

from . import ops

NEG_INF = -1e30

_SECOND_ORDER_DEPTH = 0


@contextlib.contextmanager
def second_order_tangents():
    """Route flash attention to the AD-closed chunked torch form while the
    operator of an exact-Hessian product is built (and, for the in-call
    modes, while it is applied)."""
    global _SECOND_ORDER_DEPTH
    _SECOND_ORDER_DEPTH += 1
    try:
        yield
    finally:
        _SECOND_ORDER_DEPTH -= 1


def second_order_active() -> bool:
    return _SECOND_ORDER_DEPTH > 0


def position_mask(q_pos, k_pos, *, causal, window, valid_len):
    """Broadcast attention mask from query and key positions: the one
    definition of the causal / sliding-window / valid-length semantics, used
    by the chunked route (the kernels apply the same test per element; the
    plain versions in ``kernels.ref`` keep an independent copy)."""
    mask = torch.ones(torch.broadcast_shapes(q_pos.shape, k_pos.shape), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    if valid_len is not None:
        mask = mask & (k_pos < valid_len)
    return mask


# ---------------------------------------------------- the AD passes --
def flash_bwd_passes(q, k, v, o, lse, do, **kw):
    """The attention VJP from the stored lse: Δ = rowsum(dO∘O) in torch, the
    dQ and dK/dV kernels, and the GQA group-sum of the f32 per-q-head
    partials. Returns (dq, dk, dv) in the inputs' dtypes."""
    do = do.to(q.dtype).contiguous()
    delta = torch.einsum("bshd,bshd->bhs", o.float(), do.float()).contiguous()
    dq = ops.flash_attention_dq(q, k, v, do, lse, delta, **kw)
    dkh, dvh = ops.flash_attention_dkv(q, k, v, do, lse, delta, **kw)
    B, _, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    dk = dkh.reshape(B, Sk, KV, G, hd).sum(3)
    dv = dvh.reshape(B, Sk, KV, G, hd).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_jvp_pass(q, k, v, o, lse, qt, kt, vt, **kw):
    """The attention JVP from the stored lse: the JVP kernel and the finish
    ȯ = g − t∘o in torch. Returns (ȯ in o's dtype, l̇se = t)."""
    tangents = [x.to(p.dtype).contiguous() for x, p in ((qt, q), (kt, k), (vt, v))]
    g, t = ops.flash_attention_jvp(q, k, v, *tangents, lse, **kw)
    ot = g - t.transpose(1, 2)[..., None] * o.float()
    return ot.to(o.dtype), t


class FlashAttentionVJP(torch.autograd.Function):
    """do ↦ (dq, dk, dv), linear in do; its backward is the JVP kernel."""

    @staticmethod
    def forward(do, q, k, v, o, lse, bias, opts):
        return flash_bwd_passes(q, k, v, o, lse, do, bias=bias, **opts)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, q, k, v, o, lse, bias, opts = inputs
        ctx.save_for_backward(q, k, v, o, lse, bias)
        ctx.opts = opts

    @staticmethod
    def backward(ctx, gq, gk, gv):
        q, k, v, o, lse, bias = ctx.saved_tensors
        ot, _ = flash_jvp_pass(q, k, v, o, lse, gq, gk, gv, bias=bias, **ctx.opts)
        return ot, None, None, None, None, None, None, None

    @staticmethod
    def jvp(ctx, *tangents):
        raise NotImplementedError(
            "flash attention: an exact-Hessian (forward-over-reverse) product must be "
            "built under kernels.flash_ad.second_order_tangents(); core.curvature does "
            "this, a hand-written jvp-of-grad must do it too")


class FlashAttention(torch.autograd.Function):
    """(q, k, v, bias) ↦ (o, lse) through the forward kernel; lse is not
    differentiable."""

    @staticmethod
    def forward(q, k, v, bias, opts):
        return ops.flash_attention_fwd(q, k, v, bias=bias, **opts)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, bias, opts = inputs
        o, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, o, lse, bias)
        ctx.save_for_forward(q, k, v, o, lse, bias)
        ctx.opts = opts

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse, bias = ctx.saved_tensors
        res = [x.detach() for x in (q, k, v, o, lse)]
        dq, dk, dv = FlashAttentionVJP.apply(do, *res, bias, ctx.opts)
        return dq, dk, dv, None, None

    @staticmethod
    def jvp(ctx, qt, kt, vt, _bias_t, _opts_t):
        q, k, v, o, lse, bias = ctx.saved_tensors
        zero = lambda t, p: torch.zeros_like(p) if t is None else t
        ot, _ = flash_jvp_pass(q, k, v, o, lse, zero(qt, q), zero(kt, k), zero(vt, v),
                               bias=bias, **ctx.opts)
        return ot, None


# ----------------------------------------------- the second-order route --
def _attention_block(qb, k, v, bb, i0, causal, window, scale, valid_len):
    """softmax(q_blk Kᵀ·scale + bias) V for one block of query rows, in f32."""
    B, n, H, hd = qb.shape
    T, KV = k.shape[1], k.shape[2]
    s = torch.einsum("bskgh,btkh->bkgst", qb.float().reshape(B, n, KV, H // KV, hd),
                     k.float()) * scale
    if bb is not None:
        s = s + bb.float()[:, None, None]
    mask = position_mask(i0 + torch.arange(n, device=qb.device)[:, None],
                         torch.arange(T, device=qb.device)[None, :], causal=causal,
                         window=window, valid_len=valid_len)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    # the max only shifts the exponent (the softmax does not depend on it)
    m = s.detach().amax(dim=-1, keepdim=True)
    m = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    w = p / torch.where(l <= 0.0, torch.ones_like(l), l)
    ob = torch.einsum("bkgst,btkh->bskgh", w, v.float())
    return ob.reshape(B, n, H, hd).to(qb.dtype)


def _functorch_active() -> bool:
    return torch._C._functorch.peek_interpreter_stack() is not None


def _chunked_attention(q, k, v, bias=None, *, causal, window, scale, valid_len, blk):
    """Attention over blocks of ``blk`` query rows, each block under a
    non-reentrant checkpoint: O(Sk·blk) activation memory in the forward,
    and the (Sq, Sk) weights are never held whole. Plain torch, so autograd
    and ``torch.func`` differentiate it to any order. Under ``torch.func``
    transforms (which refuse the checkpoint's saved-tensor hooks) the blocks
    run without it."""
    S = q.shape[1]
    blk = min(blk, S)
    remat = not _functorch_active()
    outs = []
    for i0 in range(0, S, blk):
        args = (q[:, i0:i0 + blk], k, v, None if bias is None else bias[:, i0:i0 + blk], i0,
                causal, window, scale, valid_len)
        if remat:
            outs.append(torch.utils.checkpoint.checkpoint(_attention_block, *args,
                                                          use_reentrant=False))
        else:
            outs.append(_attention_block(*args))
    return torch.cat(outs, dim=1)


# -------------------------------------------------------- entry point --
def flash_mha(q, k, v, *, causal=True, window=None, scale=None, blk=128, bias=None):
    """Differentiable flash attention. q (B, Sq, H, hd), k/v (B, Sk, KV, hd)
    → (B, Sq, H, hd). ``bias``: optional (B|1, Sq, Sk) f32 additive logit
    bias (0 attend, -1e30 drop), a constant under differentiation. The route
    (kernels, or the chunked torch form under ``second_order_tangents()``)
    is read at each call."""
    Sq, hd = q.shape[1], q.shape[3]
    Sk = k.shape[1]
    scale = float(scale if scale is not None else 1.0 / hd ** 0.5)
    Sqp = -(-Sq // 128) * 128
    Skp = -(-Sk // 128) * 128
    valid_len = Sk if Skp != Sk else None
    if Sqp != Sq:
        q = F.pad(q, (0, 0, 0, 0, 0, Sqp - Sq))
    if Skp != Sk:
        k = F.pad(k, (0, 0, 0, 0, 0, Skp - Sk))
        v = F.pad(v, (0, 0, 0, 0, 0, Skp - Sk))
    if bias is not None:
        bias = F.pad(bias.float(), (0, Skp - Sk, 0, Sqp - Sq), value=NEG_INF).detach()
    if second_order_active():
        o = _chunked_attention(q, k, v, bias, causal=causal, window=window, scale=scale,
                               valid_len=valid_len, blk=blk)
    else:
        opts = dict(causal=causal, window=window, valid_len=valid_len, scale=scale)
        o = FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                 None if bias is None else bias.contiguous(), opts)[0]
    return o[:, :Sq] if Sqp != Sq else o
