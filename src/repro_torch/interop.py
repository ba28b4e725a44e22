"""Carries weights and batches between numpy (e.g. the JAX package's arrays)
and the port's trees.

Dicts are rebuilt in sorted-key order at every level of nesting, which is
the order ``jax.tree_util`` flattens them in; ``torch.utils._pytree`` keeps
insertion order, so the port's trees then flatten leaf for leaf like the
reference's (the transformer's stacked ``blocks`` dict included).

bfloat16 arrays (numpy's ``ml_dtypes.bfloat16``, what the JAX package's
bf16 weights become) cross bit for bit through a 16-bit integer view, since
``torch.tensor`` does not take that numpy dtype.

The generic conversion turns every tuple into a list and every integer
array into int64, so the serving caches, which are NamedTuples holding
int32 positions and page tables (the flash-decode kernel's type), cross
through their own functions: ``kv_cache_from_numpy``,
``paged_cache_from_numpy``, ``mamba_cache_from_numpy`` (the Mamba block's
(conv, state)), ``hybrid_cache_from_numpy`` (the zamba hybrid's dict of
them, whose ``tail`` may be None) and their ``_to_numpy`` twins.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils._pytree import tree_map

from ._device import resolve_device


def _to_tensor(x, dev):
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(dev)
    if np.issubdtype(a.dtype, np.integer):
        a = a.astype(np.int64)
    return torch.tensor(a, device=dev)


def _to_numpy(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bfloat16 type; only needed for bf16 leaves

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


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
    """The port's tree → the same tree of numpy arrays (bf16 leaves as
    ``ml_dtypes.bfloat16``)."""
    return tree_map(_to_numpy, tree)


def _int32(x, dev):
    return torch.from_numpy(np.asarray(x).astype(np.int32)).to(dev)


def kv_cache_from_numpy(cache, device="cuda"):
    """A dense cache (k, v, pos), e.g. the reference's ``KVCache`` of arrays,
    per layer or stacked → the port's ``KVCache`` on ``device``, pos int32."""
    from .models.attention import KVCache

    dev = resolve_device(device)
    k, v, pos = cache
    return KVCache(_to_tensor(k, dev), _to_tensor(v, dev), _int32(pos, dev))


def paged_cache_from_numpy(cache, device="cuda"):
    """A paged cache (k_pool, v_pool, page_table, seq_len, free_pages,
    n_free), e.g. the reference's ``PagedKVCache`` of arrays → the port's
    ``PagedKVCache`` on ``device``, its five bookkeeping arrays int32."""
    from .models.kv_paged import PagedKVCache

    dev = resolve_device(device)
    k_pool, v_pool, *book = cache
    return PagedKVCache(_to_tensor(k_pool, dev), _to_tensor(v_pool, dev),
                        *(_int32(x, dev) for x in book))


def kv_cache_to_numpy(cache):
    """The port's ``KVCache`` or ``PagedKVCache`` → the same NamedTuple of
    numpy arrays."""
    return type(cache)(*(_to_numpy(t) for t in cache))


paged_cache_to_numpy = kv_cache_to_numpy


def mamba_cache_from_numpy(cache, device="cuda"):
    """A Mamba block's cache (conv, state), e.g. the reference's
    ``MambaCache`` of arrays, per layer or stacked → the port's
    ``MambaCache`` on ``device`` (state stays f32)."""
    from .models.ssm import MambaCache

    dev = resolve_device(device)
    conv, state = cache
    return MambaCache(_to_tensor(conv, dev), _to_tensor(state, dev))


mamba_cache_to_numpy = kv_cache_to_numpy


def hybrid_cache_from_numpy(cache, device="cuda"):
    """The zamba hybrid's cache dict (``groups_attn`` a KV cache,
    ``groups_mamba`` and ``tail`` ``{"b0_mamba": MambaCache}``, ``tail``
    possibly None) → the port's, keys sorted."""
    def mamba(c):
        return None if c is None else {"b0_mamba": mamba_cache_from_numpy(c["b0_mamba"], device)}

    return {"groups_attn": kv_cache_from_numpy(cache["groups_attn"], device),
            "groups_mamba": mamba(cache["groups_mamba"]), "tail": mamba(cache["tail"])}


def hybrid_cache_to_numpy(cache):
    """The port's hybrid cache → the same dict of NamedTuples of numpy arrays."""
    def mamba(c):
        return None if c is None else {"b0_mamba": mamba_cache_to_numpy(c["b0_mamba"])}

    return {"groups_attn": kv_cache_to_numpy(cache["groups_attn"]),
            "groups_mamba": mamba(cache["groups_mamba"]), "tail": mamba(cache["tail"])}
