"""Carries weights and batches between numpy (e.g. the JAX package's arrays)
and the port's trees.

Dicts are rebuilt in sorted-key order, which is the order ``jax.tree_util``
flattens them in; ``torch.utils._pytree`` keeps insertion order, so the
port's trees then flatten leaf for leaf like the reference's.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils._pytree import tree_map

from ._device import resolve_device


def _to_tensor(x, dev):
    a = np.asarray(x)
    if np.issubdtype(a.dtype, np.integer):
        a = a.astype(np.int64)
    return torch.tensor(a, device=dev)


def _convert(tree, dev):
    if isinstance(tree, dict):
        return {k: _convert(tree[k], dev) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_convert(t, dev) for t in tree]
    return _to_tensor(tree, dev)


def params_from_numpy(tree, device="cuda"):
    """A tree of arrays (e.g. the JAX MLP's ``[{"b", "w"}, ...]``) → the
    port's tree on ``device``, in JAX's leaf order. Integer arrays become
    int64."""
    return _convert(tree, resolve_device(device))


def batch_from_numpy(batch, device="cuda"):
    """A batch dict of arrays → tensors on ``device`` (labels as int64)."""
    return _convert(batch, resolve_device(device))


def params_to_numpy(tree):
    """The port's tree → the same tree of numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
