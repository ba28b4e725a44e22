"""Multi-tangent block curvature products (twin of ``repro/core/blocks.py``):
s tangents through one cached operator.

A block is a stacked tree of s tangents, a leading ``s`` axis on every leaf
(the tree Krylov backend's native block form, and what
``FlatVectorBackend.lower_block`` makes of an ``(s, n)`` matrix). The
curvature engine (``core/curvature.py``) gives every operator a block form,
``op.block``: in the cached modes one batched backward through the cached
graph, so the graph's saved activations are read once for all s products;
in ``naive`` and the remat'd ``chunked`` mode the in-call product vmapped
over the stack. ``grad_reduce`` is applied once per block.

``block_op_from_single`` is the hot-path entry: ``hf_step`` builds its
single-tangent operator once (one primal pass) and takes the block form of
the SAME cached graph, with no second primal. ``pair_apply`` is the s-step
solvers' view: the p and r chains advance in lock-step, so each basis level
is one width-2 block product.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch
from torch.func import vmap
from torch.utils._pytree import tree_leaves, tree_map

from .curvature import _block_reduce, _maybe_reduce, make_gnvp_op, make_hvp_op

Op = Callable[[Any], Any]


def stack_tangents(tangents: Sequence[Any]):
    """Stack s tangent trees into one block (leading s axis per leaf)."""
    return tree_map(lambda *xs: torch.stack(xs), *tangents)


def unstack_tangents(block):
    """Inverse of ``stack_tangents``: block → list of s tangent trees."""
    s = tree_leaves(block)[0].shape[0]
    return [tree_map(lambda x, j=j: x[j], block) for j in range(s)]


def pair_apply(be, A_, Ab_):
    """Advance two Krylov chains one level: (A w, A u) as ONE width-2 block
    product when a block operator is available, two singles otherwise.
    ``be`` is the Krylov vector backend, ``A_``/``Ab_`` the backend-wrapped
    single/block operators (``Ab_`` may be None)."""
    if Ab_ is None:
        return lambda w, u: (A_(w), A_(u))

    def pair(w, u):
        out = Ab_(be.block_stack([w, u]))
        return be.block_col(out, 0), be.block_col(out, 1)

    return pair


def block_op_from_single(op: Op) -> Op:
    """The block form of a single-tangent operator over the SAME cached
    graph: ``op.block`` where the curvature engine (or ``make_damped``)
    attached one, else ``torch.func.vmap(op)`` (an operator written in plain
    tensor ops, such as a matrix product)."""
    block = getattr(op, "block", None)
    return vmap(op) if block is None else block


def make_block_hvp_op(
    loss_fn,
    params,
    batch,
    *,
    mode: str = "linearize",
    chunk_size: int = 0,
    remat: bool = True,
    grad_reduce: Optional[Callable[[Any], Any]] = None,
) -> Op:
    """Block Hessian operator: stacked tangents V ↦ stacked products H·V.
    Same mode semantics as ``make_hvp_op``; ``grad_reduce`` once per block."""
    single = make_hvp_op(loss_fn, params, batch, mode=mode, chunk_size=chunk_size,
                         remat=remat, grad_reduce=None)
    blk = block_op_from_single(single)
    return lambda tangents: _maybe_reduce(blk(tangents), _block_reduce(grad_reduce))


def make_block_gnvp_op(
    model_out_fn,
    out_loss_fn,
    params,
    batch,
    *,
    mode: str = "linearize",
    chunk_size: int = 0,
    remat: bool = True,
    grad_reduce: Optional[Callable[[Any], Any]] = None,
) -> Op:
    """Block Gauss-Newton operator: stacked V ↦ stacked Jᵀ(∇²_z ℓ)J·V, the
    network's graph built once as in ``make_gnvp_op``."""
    single = make_gnvp_op(model_out_fn, out_loss_fn, params, batch, mode=mode,
                          chunk_size=chunk_size, remat=remat, grad_reduce=None)
    blk = block_op_from_single(single)
    return lambda tangents: _maybe_reduce(blk(tangents), _block_reduce(grad_reduce))
