"""Pytree vector algebra used by the Krylov solvers (twin of
``repro.core.tree_math``), over ``torch.utils._pytree``.

Leaf order matters: ``jax.tree_util`` flattens a dict in sorted-key order,
``torch.utils._pytree`` in insertion order. The port's parameter trees are
built with sorted keys (an MLP layer is ``{"b": ..., "w": ...}``), so both
packages see the same leaf sequence — ``tree_pseudo_noise`` hashes the leaf
index, and the flat Krylov backend lays leaves out in that order.
"""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map, tree_unflatten


def tree_dot(a, b) -> torch.Tensor:
    """<a, b> in f32 regardless of leaf dtype: a sum of per-leaf f32 products."""
    leaves = [
        torch.sum(x.float() * y.float())
        for x, y in zip(tree_leaves(a), tree_leaves(b))
    ]
    return torch.sum(torch.stack(leaves))


def tree_norm(a) -> torch.Tensor:
    return torch.sqrt(tree_dot(a, a))


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(alpha, a):
    return tree_map(lambda x: alpha * x, a)


def tree_axpy(alpha, x, y):
    """alpha * x + y."""
    return tree_map(lambda u, v: alpha * u + v, x, y)


def tree_axpy_cast(alpha, x, y):
    """(alpha * x + y) cast back to y's leaf dtypes."""
    return tree_map(lambda u, v: (alpha * u.float() + v.float()).to(v.dtype), x, y)


def tree_axpby(alpha, x, beta, y):
    """alpha * x + beta * y."""
    return tree_map(lambda u, v: alpha * u + beta * v, x, y)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_where(cond, a, b):
    """Select whole trees on a scalar predicate (a 0-dim bool tensor)."""
    return tree_map(lambda x, y: torch.where(cond, x, y), a, b)


def tree_cast(a, dtype):
    return tree_map(lambda x: x.to(dtype), a)


def tree_size(a) -> int:
    return sum(x.numel() for x in tree_leaves(a))


def tree_pseudo_noise(tree, step):
    """Deterministic elementwise pseudo-noise in [-1, 1] with the same tree
    structure: sin of a position/value/step hash. Formula for formula the
    reference's, so the Krylov jitter agrees between the two packages."""
    leaves, spec = tree_flatten(tree)
    out = []
    for i, x in enumerate(leaves):
        sf = torch.as_tensor(step, device=x.device).to(torch.float32)
        pos = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        for d in range(x.ndim):
            shape = [1] * x.ndim
            shape[d] = x.shape[d]
            iota = torch.arange(x.shape[d], dtype=torch.float32, device=x.device)
            pos = pos + iota.reshape(shape) * (0.7391 + 0.2113 * d)
        n = torch.sin(
            x.float() * 1234.567
            + pos * (1.0 + 0.13 * i)
            + sf * 0.61803
            + 0.5 * (i + 1)
        )
        out.append(n)
    return tree_unflatten(out, spec)
