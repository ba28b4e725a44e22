"""Curvature-operator engine (twin of ``repro/core/curvature.py``): Hessian
and Gauss-Newton vector products in three modes.

* ``"naive"``     — every application re-runs the primal pass:
  ``torch.func.jvp`` of ``torch.func.grad`` (forward-over-reverse, as the
  reference), and jvp/vjp for the GN product.
* ``"linearize"`` — the primal forward and backward run once per build, and
  each application runs only a tangent pass over the cached graph. JAX gets
  this from ``jax.linearize``; here the autograd graph of the gradient is
  built once with ``create_graph=True`` and every H·v is one backward
  through it (reverse-over-reverse; H is symmetric, so it is the same
  product). ``torch.func.linearize`` would re-trace the function with
  ``make_fx`` on every build, which costs about a second of host time at
  the TIMIT width. The GN product caches the network's graph the same way:
  Jᵀu is a backward, J·v the backward of the Jᵀu graph with respect to u.
* ``"chunked"``   — the curvature batch is swept in microbatches of
  ``chunk_size`` examples, weighted so a non-divisor remainder is exact.
  With ``remat`` (the default) each application re-computes one chunk's
  primal at a time, so memory is flat in the batch; without it the chunked
  loss's graph is cached as in "linearize".

``grad_reduce`` is applied once per product.

**Flash attention.** Every exact-Hessian build runs under
``kernels.flash_ad.second_order_tangents()``, as in the reference: the flash
Functions' backward is linear in dO with detached residuals (exact for the
GN product, blind to the second-order terms of attention), so under the
context the model routes attention to the chunked torch form, which
autograd differentiates twice. The cached modes enter the context once, for
the primal build; the naive and remat'd chunked products recompute the
primal in every call and enter it there. The GN operator captures the
context's state at build time and re-enters it in those per-call bodies
(``core.hf`` builds it under the context for the s-step solvers). For a
model without flash attention the context changes nothing.

**Block products.** Every operator built here also carries ``op.block``:
the same operator applied to a stacked tree of s tangents (a leading s axis
on every leaf), which ``core.blocks.block_op_from_single`` hands to the
s-step solvers. The reference gets it from ``jax.vmap`` over the cached map.
``torch.func.vmap`` cannot trace through ``torch.autograd.grad`` on a graph
built outside it, so in the cached modes a block is ONE batched backward
(``is_grads_batched=True``) through the same cached graph: s tangents, one
sweep, no second primal pass. ``naive`` and the remat'd ``chunked`` bodies
recompute the primal in-call, so there the direct product is vmapped
(still once per chunk, as the single product). ``grad_reduce`` is applied
once per block.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Optional

import torch
import torch.utils.checkpoint
from torch.func import grad, jvp, vjp, vmap
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map, tree_unflatten

from ..kernels.flash_ad import second_order_active, second_order_tangents

LossFn = Callable[[Any, Any], torch.Tensor]
OutFn = Callable[[Any, Any], Any]
OutLossFn = Callable[[Any, Any], torch.Tensor]
Op = Callable[[Any], Any]

MODES = ("naive", "linearize", "chunked")


def _cast_like(v, params):
    """Krylov vectors live in f32; cast the tangent to the params' dtypes."""
    return tree_map(lambda t, p: t.to(p.dtype), v, params)


def _maybe_reduce(out, grad_reduce):
    return out if grad_reduce is None else grad_reduce(out)


def _with_block(single: Op, block: Op) -> Op:
    """Attach the block form (stacked tangents → stacked products) to a
    single-tangent operator."""
    single.block = block
    return single


def _reduced(fn: Op, grad_reduce) -> Op:
    return lambda v: _maybe_reduce(fn(v), grad_reduce)


def _block_reduce(grad_reduce):
    """``grad_reduce`` for a block of stacked tangents: its ``block`` form
    where it has one (the data-parallel step's, which counts the block's
    tangents), else itself."""
    return getattr(grad_reduce, "block", grad_reduce)


def _batch_size(batch) -> int:
    sizes = {x.shape[0] for x in tree_leaves(batch)}
    if len(sizes) != 1:
        raise ValueError(f"batch leaves disagree on leading dim: {sorted(sizes)}")
    return sizes.pop()


def split_chunks(batch, chunk_size: int):
    """Split a batch along the leading axis into (main, rem, n_chunks, n_rem):
    ``main`` stacks the ⌊B/chunk⌋ full microbatches on a new leading axis,
    ``rem`` is the remainder slice (None if B divides evenly)."""
    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    B = _batch_size(batch)
    n_chunks, n_rem = divmod(B, chunk_size)
    main = None
    if n_chunks:
        main = tree_map(
            lambda x: x[: n_chunks * chunk_size].reshape(
                (n_chunks, chunk_size) + tuple(x.shape[1:])),
            batch,
        )
    rem = None
    if n_rem:
        rem = tree_map(lambda x: x[B - n_rem:], batch)
    return main, rem, n_chunks, n_rem


def _chunks(main, n_chunks):
    return [tree_map(lambda x: x[c], main) for c in range(n_chunks)]


def chunked_scalar_fn(fn: LossFn, batch, chunk_size: int, remat: bool = True
                      ) -> Callable[[Any], torch.Tensor]:
    """Rewrite a mean-over-batch scalar ``fn(params, batch)`` as an exact sum
    over microbatches: params ↦ (1/B) Σ_c n_c · fn(params, chunk_c). With
    ``remat`` each chunk is checkpointed for first-order gradients."""
    B = _batch_size(batch)
    if chunk_size <= 0 or chunk_size >= B:
        return lambda p: fn(p, batch)
    main, rem, n_chunks, n_rem = split_chunks(batch, chunk_size)
    chunks = _chunks(main, n_chunks)
    if remat:
        body = lambda p, c: torch.utils.checkpoint.checkpoint(
            fn, p, c, use_reentrant=False)
    else:
        body = fn

    def chunked(p):
        total = torch.zeros((), dtype=torch.float32, device=tree_leaves(p)[0].device)
        for c in chunks:
            total = total + body(p, c).float()
        total = total * chunk_size
        if rem is not None:
            total = total + n_rem * body(p, rem).float()
        return total / B

    return chunked


def _check_mode(mode: str):
    if mode not in MODES:
        raise ValueError(f"curvature mode must be one of {MODES}, got {mode!r}")


def _grad_outputs(outs, cotangents, wrt, batched: bool = False):
    """Σ cotangentᵀ ∂outs/∂wrt, with zeros for inputs the outputs miss.
    ``batched``: each cotangent carries a leading s axis and the result is
    the s products from one batched backward."""
    lead = (tree_leaves(cotangents)[0].shape[0],) if batched else ()
    zeros = lambda w: torch.zeros(lead + tuple(w.shape), dtype=w.dtype, device=w.device)
    pairs = [(o, c) for o, c in zip(outs, cotangents)
             if o is not None and o.requires_grad]
    if not pairs:
        return [zeros(w) for w in wrt]
    res = torch.autograd.grad(
        [o for o, _ in pairs], wrt, grad_outputs=[c for _, c in pairs],
        retain_graph=True, allow_unused=True, is_grads_batched=batched)
    return [zeros(w) if r is None else r for r, w in zip(res, wrt)]


def _cached_hessian(scalar_fn, params):
    """Primal forward+backward once: returns (f0, g, hvp) where each hvp
    application is one backward through the cached gradient graph."""
    leaves, spec = tree_flatten(params)
    with torch.enable_grad():
        prim = [l.detach().requires_grad_(True) for l in leaves]
        f = scalar_fn(tree_unflatten(prim, spec))
        g = torch.autograd.grad(f, prim, create_graph=True, allow_unused=True)
    g = [torch.zeros_like(p) if x is None else x for x, p in zip(g, prim)]

    def product(v, batched):
        with torch.enable_grad():
            out = _grad_outputs(g, tree_leaves(v), prim, batched)
        return tree_unflatten(out, spec)

    hvp = _with_block(lambda v: product(v, False), lambda V: product(V, True))
    return (f.detach(), tree_unflatten([x.detach() for x in g], spec), hvp)


def _chunked_product(direct, params, batch, chunk_size, grad_reduce) -> Op:
    """v ↦ (1/B) Σ_c n_c · direct(v, chunk_c): one chunk's primal at a time,
    so memory is flat in the batch; ``grad_reduce`` once per product."""
    B = _batch_size(batch)
    main, rem, n_chunks, n_rem = split_chunks(batch, chunk_size)
    parts = [(c, chunk_size) for c in _chunks(main, n_chunks)]
    if rem is not None:
        parts.append((rem, n_rem))

    def product(v, fn, lead):
        vc = _cast_like(v, params)
        acc = tree_map(lambda p: torch.zeros(lead + tuple(p.shape), dtype=torch.float32,
                                             device=p.device), params)
        for c, n_c in parts:
            acc = tree_map(lambda a, g: a + n_c * g.float(), acc, fn(vc, c))
        out = tree_map(lambda a, p: (a / B).to(p.dtype), acc, params)
        return _maybe_reduce(out, _block_reduce(grad_reduce) if lead else grad_reduce)

    block_direct = vmap(direct, in_dims=(0, None))
    return _with_block(
        lambda v: product(v, direct, ()),
        lambda V: product(V, block_direct, (tree_leaves(V)[0].shape[0],)))


def _hvp_direct(loss_fn, params, vc, batch):
    """One H·v with the primal recomputed in-call (forward-over-reverse),
    under ``second_order_tangents()``."""
    with second_order_tangents():
        return jvp(grad(lambda p: loss_fn(p, batch)), (params,), (vc,))[1]


def make_hvp_op(
    loss_fn: LossFn,
    params,
    batch,
    *,
    mode: str = "linearize",
    chunk_size: int = 0,
    remat: bool = True,
    grad_reduce: Optional[Callable[[Any], Any]] = None,
) -> Op:
    """Exact stochastic Hessian operator in the given mode (module docstring)."""
    _check_mode(mode)
    if mode == "naive":
        direct = lambda vc: _hvp_direct(loss_fn, params, vc, batch)
        return _with_block(
            _reduced(lambda v: direct(_cast_like(v, params)), grad_reduce),
            _reduced(lambda V: vmap(direct)(_cast_like(V, params)), _block_reduce(grad_reduce)))

    B = _batch_size(batch)
    if mode == "chunked" and remat and 0 < chunk_size < B:
        return _chunked_product(
            lambda vc, c: _hvp_direct(loss_fn, params, vc, c),
            params, batch, chunk_size, grad_reduce)

    if mode == "chunked":
        scalar = chunked_scalar_fn(loss_fn, batch, chunk_size, remat=False)
    else:
        scalar = lambda p: loss_fn(p, batch)
    with second_order_tangents():
        _, _, lin = _cached_hessian(scalar, params)
    return _lift_cached(lin, params, grad_reduce)


def shared_primal_hvp(
    loss_fn: LossFn,
    params,
    batch,
    *,
    grad_reduce: Optional[Callable[[Any], Any]] = None,
):
    """One primal pass for the whole outer step: (f0, g, hvp_op). The cached
    gradient graph gives f0 and g, and every H·v is a backward through it."""
    # The fused gradient comes through the second-order route too (the price
    # of one primal pass for g and the Hessian, as in the reference).
    with second_order_tangents():
        f0, g, lin = _cached_hessian(lambda p: loss_fn(p, batch), params)
    return f0, _maybe_reduce(g, grad_reduce), _lift_cached(lin, params, grad_reduce)


def _lift_cached(inner: Op, params, grad_reduce) -> Op:
    """A product over a cached graph (``inner`` and ``inner.block``) as an
    operator: tangents cast to the params' dtypes, ``grad_reduce`` once per
    product or block."""
    return _with_block(
        _reduced(lambda v: inner(_cast_like(v, params)), grad_reduce),
        _reduced(lambda V: inner.block(_cast_like(V, params)), _block_reduce(grad_reduce)))


def _gnvp_once(model_out_fn: OutFn, out_loss_fn: OutLossFn, params, batch) -> Op:
    """GN product over one cached forward: J·v, ∇²_z ℓ·u and Jᵀ·u all run as
    backwards through graphs built once here."""
    leaves, spec = tree_flatten(params)
    with torch.enable_grad():
        prim = [l.detach().requires_grad_(True) for l in leaves]
        z = model_out_fn(tree_unflatten(prim, spec), batch)
        z_leaves, z_spec = tree_flatten(z)
        # Jᵀu as a graph in u (linear in u): its backward in u is J·v.
        u = [torch.zeros_like(zl, requires_grad=True) for zl in z_leaves]
        jt = torch.autograd.grad(z_leaves, prim, grad_outputs=u,
                                 create_graph=True, allow_unused=True)
        zd = [zl.detach().requires_grad_(True) for zl in z_leaves]
        gz = torch.autograd.grad(out_loss_fn(tree_unflatten(zd, z_spec), batch),
                                 zd, create_graph=True, allow_unused=True)
        gz = [torch.zeros_like(d) if x is None else x for x, d in zip(gz, zd)]

    def product(v, batched):
        vl = tree_leaves(v)
        with torch.enable_grad():
            jv = _grad_outputs(jt, vl, u, batched)
            hjv = _grad_outputs(gz, jv, zd, batched)
            hjv = [h.to(zl.dtype) for h, zl in zip(hjv, z_leaves)]
            out = _grad_outputs(z_leaves, hjv, prim, batched)
        return tree_unflatten(out, spec)

    return _with_block(lambda v: product(v, False), lambda V: product(V, True))


def _gnvp_direct(model_out_fn: OutFn, out_loss_fn: OutLossFn, params, vc, batch):
    """One GN product with the primal recomputed in-call (the naive body and
    the chunked body)."""
    f = lambda p: model_out_fn(p, batch)
    z, jv = jvp(f, (params,), (vc,))
    g_out = grad(lambda zz: out_loss_fn(zz, batch))
    hjv = jvp(g_out, (z,), (jv,))[1]
    _, vjp_fn = vjp(f, params)
    return vjp_fn(hjv)[0]


def make_gnvp_op(
    model_out_fn: OutFn,
    out_loss_fn: OutLossFn,
    params,
    batch,
    *,
    mode: str = "linearize",
    chunk_size: int = 0,
    remat: bool = True,
    grad_reduce: Optional[Callable[[Any], Any]] = None,
) -> Op:
    """Gauss-Newton operator Jᵀ(∇²_z ℓ)J. Same modes as ``make_hvp_op``; the
    chunked path sums per-microbatch GN products (J is block-diagonal over
    examples) with each chunk's primal recomputed in-call, so its memory is
    flat with or without ``remat``. The ``second_order_tangents()`` state at
    build time is re-entered around every in-call primal."""
    _check_mode(mode)
    ctx = second_order_tangents if second_order_active() else contextlib.nullcontext

    def in_call(vc, c):
        with ctx():
            return _gnvp_direct(model_out_fn, out_loss_fn, params, vc, c)

    if mode == "naive":
        direct = lambda vc: in_call(vc, batch)
        return _with_block(
            _reduced(lambda v: direct(_cast_like(v, params)), grad_reduce),
            _reduced(lambda V: vmap(direct)(_cast_like(V, params)), _block_reduce(grad_reduce)))

    B = _batch_size(batch)
    if mode == "linearize" or chunk_size <= 0 or chunk_size >= B:
        return _lift_cached(_gnvp_once(model_out_fn, out_loss_fn, params, batch),
                            params, grad_reduce)

    return _chunked_product(in_call, params, batch, chunk_size, grad_reduce)


def make_damped(op: Op, lam) -> Op:
    """B(v) = G(v) + λ v  (Algorithm 1 line 4); a block form of ``op``
    carries over, so the damped block is G's block plus λ·V."""

    def damped(v):
        return tree_map(lambda g, x: g + lam * x, op(v), v)

    block = getattr(op, "block", None)
    if block is not None:
        damped.block = lambda V: tree_map(lambda g, x: g + lam * x, block(V), V)
    return damped
