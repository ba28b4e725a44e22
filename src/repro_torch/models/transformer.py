"""Decoder stacks (twin of ``repro/models/transformer.py``): the dense
decoders, whose repeating unit is one attention block (``block_pattern ==
("attn",)``: the qwen, granite and chatglm configurations), and the zamba2
hybrid, a Mamba2 backbone (``block_pattern == ("mamba",)``) with one
weight-shared attention + MLP block after every ``attn_every`` Mamba blocks.

The parameter tree is the reference's: ``params["blocks"]`` is a dict whose
leaves are stacked on a leading layer axis, beside ``embed``,
``final_norm`` and (untied) ``lm_head``, every dict in sorted-key order. So
the flat Krylov layout and ``tree_pseudo_noise`` match the reference's leaf
for leaf. The reference scans the stack with ``lax.scan``; the backbone here
is a Python loop over the layer axis.

``loss_fn`` is twice differentiable. The serving paths are the reference's:
``prefill``/``decode_step`` over a dense rolling cache, the per-slot
``decode_step_ragged``, and ``prefill_paged``/``decode_step_paged`` over the
shared page pool (``models.kv_paged``). The caches keep the reference's
stacked layout, ``{"b0_attn": KVCache}`` with (L, B, W, KV, hd) K/V and
(L, W) (ragged: (L, B, W)) positions, and (L, P, page_size, KV, hd) pools;
the decode steps write them **in place** and return them (the reference's
serving loop donates them to XLA for the same effect).

The hybrid's tree is the reference's zamba layout: ``groups`` with every
leaf stacked (G, k, ...), ``tail`` (R, ...) for the Mamba blocks past the
last whole group, and ``shared``, the one attention block, beside ``embed``,
``final_norm`` and ``lm_head`` (``hybrid_layout`` gives (G, k, R)). Its
cache is ``{"groups_attn": KVCache (G, ...), "groups_mamba": {"b0_mamba":
MambaCache (G, k, ...)}, "tail": {"b0_mamba": MambaCache (R, ...)} or
None}``, written in place by ``decode_step``. Under
``cfg.use_flash_attention`` its prefill runs each Mamba block's SSD through
the intra-chunk kernel (``ops.ssd_chunked_pallas``, forward only; run the
prefill under ``torch.no_grad()``, as ``launch.serve`` does), besides the
flash kernels; ``loss_fn`` and ``logits_fn`` always run the plain
``ssd_chunked``. The hybrid has no continuous batching, as in the
reference. The other families (MoE, SSM alone, xLSTM, encoder-decoder, vlm)
are ROADMAP item 18; chunked cross-entropy (``ce_chunk > 0``) and the
reference's ``remat`` of the layer scan are not ported yet.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from .._device import resolve_device
from . import kv_paged as kvp
from .attention import (
    KVCache,
    attend_full,
    attend_full_with_cache,
    attn_init,
    decode_attend,
    decode_attend_ragged,
    init_kv_cache,
)
from .ssm import MambaCache, apply_mamba, init_mamba_cache, mamba_decode_step, mamba_init
from .layers import (
    apply_mlp,
    apply_norm,
    dense,
    dense_init,
    dtype_of,
    embed,
    embedding_init,
    mlp_init,
    norm_init,
    unembed,
)


class ModelApi(NamedTuple):
    config: Any
    init: Callable           # (generator) -> params
    loss_fn: Callable        # (params, batch) -> scalar  (twice differentiable)
    logits_fn: Callable      # (params, batch) -> (B, S, V) f32   [GN split: network]
    out_loss_fn: Callable    # (logits, batch) -> scalar          [GN split: loss]
    prefill: Callable        # (params, batch, max_len) -> (logits (B,1,V), caches)
    decode_step: Callable    # (params, token (B,1), t, caches) -> (logits, caches)
    init_cache: Callable     # (batch_size, max_len) -> caches
    # Continuous batching over per-slot positions and the paged pool: set for
    # the dense decoders, None for the hybrid (as the reference's gate
    # makes them; it leaves them None for the vlm family too).
    decode_step_ragged: Optional[Callable] = None
    # (params, token (B,1), t (B,), caches, active (B,)) -> (logits, caches)
    init_cache_ragged: Optional[Callable] = None
    # (batch_size, max_len) -> caches with per-slot position rows
    decode_step_paged: Optional[Callable] = None
    # (params, token (B,1), paged_cache, active (B,)) -> (logits, paged_cache)
    init_cache_paged: Optional[Callable] = None
    # (batch_size, max_len, n_pages, page_size) -> PagedKVCache
    prefill_paged: Optional[Callable] = None
    # (params, batch (one prompt), paged_cache, slot) -> (logits, paged_cache)


def _attn_block_init(gen, cfg, dtype, lead):
    d = cfg.d_model
    return {
        "attn": attn_init(gen, cfg, dtype, lead=lead),
        "mlp": mlp_init(gen, d, cfg.d_ff, dtype, cfg.mlp_act, lead=lead),
        "norm1": norm_init(d, dtype, cfg.norm_kind, lead=lead, device=gen.device),
        "norm2": norm_init(d, dtype, cfg.norm_kind, lead=lead, device=gen.device),
    }


def _unit_init(gen, cfg, dtype, lead):
    """One repeating unit's parameters, each leaf with leading dims ``lead``:
    ``{"b0_attn": ...}`` or, for ``block_pattern == ("mamba",)``,
    ``{"b0_mamba": {"mamba", "norm"}}``."""
    if cfg.block_pattern == ("mamba",):
        return {"b0_mamba": {
            "mamba": mamba_init(gen, cfg, dtype, lead=lead),
            "norm": norm_init(cfg.d_model, dtype, cfg.norm_kind, lead=lead, device=gen.device),
        }}
    return {"b0_attn": _attn_block_init(gen, cfg, dtype, lead)}


def _unit_apply(unit, x, positions, cfg):
    """One ``("attn",)`` unit: pre-norm attention and MLP, each residual."""
    p = unit["b0_attn"]
    a = attend_full(p["attn"], apply_norm(p["norm1"], x, cfg.norm_eps), positions, cfg)
    return _block_rest(p, x, a, cfg)


def _decoder_backbone(params, x, positions, cfg):
    """The stacked units applied in order. Each leaf is unbound once along
    the layer axis: the backward of ``unbind`` is one ``stack``, where
    indexing layer by layer would add a zero-filled copy of the whole stack
    per layer."""
    for unit in _layers(params["blocks"]):
        x = _unit_apply(unit, x, positions, cfg)
    return x


def _layers(tree):
    """The per-layer slices of a tree stacked on a leading layer axis, each
    leaf unbound once."""
    leaves, spec = tree_flatten(tree)
    per_layer = [t.unbind(0) for t in leaves]
    return [tree_unflatten([t[i] for t in per_layer], spec) for i in range(len(per_layer[0]))]


def _block_rest(p, x, a, cfg):
    """The unit after its attention ``a``: the residual, then the MLP."""
    x = x + a
    return x + apply_mlp(p["mlp"], apply_norm(p["norm2"], x, cfg.norm_eps))


def _stack(cache, n):
    """A layer's cache repeated along a new leading layer axis (a copy per
    layer, each written in place by the decode steps)."""
    return tree_map(lambda a: a[None].repeat((n,) + (1,) * a.ndim), cache)


def _ce_loss(logits, batch):
    targets = batch["targets"]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32, device=targets.device)
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def _head(params, x, cfg):
    x = apply_norm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return unembed(params["embed"], x)
    return dense(params["lm_head"], x).float()


def _loss_fn(cfg, logits_fn):
    def loss_fn(params, batch):
        if cfg.ce_chunk:
            raise NotImplementedError(
                "chunked cross-entropy (ce_chunk > 0) is not ported yet (ROADMAP item 16)")
        return _ce_loss(logits_fn(params, batch), batch)
    return loss_fn


# ------------------------------------------------------- the zamba hybrid --
def hybrid_layout(cfg):
    """(n_groups, per_group, n_tail) of the zamba stack."""
    k = cfg.attn_every
    G = cfg.n_layers // k
    return G, k, cfg.n_layers - G * k


def _mamba_apply(unit, x, cfg, *, ssd_kernel=False):
    """One ``("mamba",)`` unit: pre-norm Mamba2 block, residual. Returns (x,
    the block's MambaCache)."""
    p = unit["b0_mamba"]
    y, c = apply_mamba(p["mamba"], apply_norm(p["norm"], x, cfg.norm_eps), cfg,
                       ssd_kernel=ssd_kernel)
    return x + y, c


def _mamba_decode(unit, x, cache, cfg):
    p = unit["b0_mamba"]
    y, _ = mamba_decode_step(p["mamba"], apply_norm(p["norm"], x, cfg.norm_eps), cache, cfg)
    return x + y


def _stack_mamba(caches, lead):
    """Per-block MambaCaches, in stack order, as one with leading dims ``lead``."""
    return MambaCache(*(torch.stack(t).reshape(tuple(lead) + t[0].shape)
                        for t in zip(*caches)))


def _hybrid_backbone(params, x, positions, cfg, *, produce_cache=False, max_len=None,
                     ssd_kernel=False):
    """The groups (k Mamba blocks, then the shared attention block), then the
    tail's Mamba blocks. Returns (x, caches or None)."""
    G, k, R = hybrid_layout(cfg)
    shared = params["shared"]
    mamba, kvs, tail = [], [], []
    for group in _layers(params["groups"]):
        for unit in _layers(group):
            x, c = _mamba_apply(unit, x, cfg, ssd_kernel=ssd_kernel)
            mamba.append(c)
        if produce_cache:
            a, kv = attend_full_with_cache(shared["attn"],
                                           apply_norm(shared["norm1"], x, cfg.norm_eps),
                                           positions, cfg, max_len)
            x = _block_rest(shared, x, a, cfg)
            kvs.append(kv)
        else:
            x = _unit_apply({"b0_attn": shared}, x, positions, cfg)
    if R:
        for unit in _layers(params["tail"]):
            x, c = _mamba_apply(unit, x, cfg, ssd_kernel=ssd_kernel)
            tail.append(c)
    if not produce_cache:
        return x, None
    return x, {"groups_attn": KVCache(*(torch.stack(t) for t in zip(*kvs))),
               "groups_mamba": {"b0_mamba": _stack_mamba(mamba, (G, k))},
               "tail": {"b0_mamba": _stack_mamba(tail, (R,))} if R else None}


def _hybrid_decode(params, x, t, caches, cfg):
    """One token through the stack, each layer's cache slice written in place."""
    shared = params["shared"]
    gm, ga = caches["groups_mamba"]["b0_mamba"], caches["groups_attn"]
    for group, conv_g, state_g, k, v, pos in zip(
            _layers(params["groups"]), gm.conv.unbind(0), gm.state.unbind(0), ga.k.unbind(0),
            ga.v.unbind(0), ga.pos.unbind(0)):
        for unit, conv, state in zip(_layers(group), conv_g.unbind(0), state_g.unbind(0)):
            x = _mamba_decode(unit, x, MambaCache(conv, state), cfg)
        a, _ = decode_attend(shared["attn"], apply_norm(shared["norm1"], x, cfg.norm_eps), t,
                             KVCache(k, v, pos), cfg)
        x = _block_rest(shared, x, a, cfg)
    if caches["tail"] is not None:
        tm = caches["tail"]["b0_mamba"]
        for unit, conv, state in zip(_layers(params["tail"]), tm.conv.unbind(0),
                                     tm.state.unbind(0)):
            x = _mamba_decode(unit, x, MambaCache(conv, state), cfg)
    return x, caches


def _build_hybrid(cfg, dev) -> ModelApi:
    dtype = dtype_of(cfg)
    G, k, R = hybrid_layout(cfg)

    def init(generator: torch.Generator):
        params = {
            "embed": embedding_init(generator, cfg.padded_vocab, cfg.d_model, dtype),
            "final_norm": norm_init(cfg.d_model, dtype, cfg.norm_kind, device=generator.device),
            "groups": _unit_init(generator, cfg, dtype, (G, k)),
            "shared": _attn_block_init(generator, cfg, dtype, ()),
        }
        if R:
            params["tail"] = _unit_init(generator, cfg, dtype, (R,))
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(generator, cfg.d_model, cfg.padded_vocab, dtype)
        return {key: tree_map(lambda t: t.to(dev), params[key]) for key in sorted(params)}

    def logits_fn(params, batch):
        x = embed(params["embed"], batch["tokens"])
        positions = torch.arange(x.shape[1], device=x.device)
        return _head(params, _hybrid_backbone(params, x, positions, cfg)[0], cfg)

    def init_cache(batch_size, max_len):
        mc = {"b0_mamba": init_mamba_cache(cfg, batch_size, dtype, device=dev)}
        return {"groups_attn": _stack(init_kv_cache(cfg, batch_size, max_len, dtype, device=dev),
                                      G),
                "groups_mamba": _stack(_stack(mc, k), G),
                "tail": _stack(mc, R) if R else None}

    def prefill(params, batch, max_len):
        x = embed(params["embed"], batch["tokens"])
        positions = torch.arange(x.shape[1], device=x.device)
        x, caches = _hybrid_backbone(params, x, positions, cfg, produce_cache=True,
                                     max_len=max_len, ssd_kernel=cfg.use_flash_attention)
        return _head(params, x[:, -1:], cfg), caches

    def decode_step(params, token, t, caches):
        x, caches = _hybrid_decode(params, embed(params["embed"], token), t, caches, cfg)
        return _head(params, x, cfg), caches

    return ModelApi(cfg, init, _loss_fn(cfg, logits_fn), logits_fn, _ce_loss, prefill,
                    decode_step, init_cache)


# ------------------------------------------------------------ build model --
def build_model(cfg, *, device="cuda") -> ModelApi:
    """The model's pure functions over a parameter tree on ``device``."""
    is_hybrid = (cfg.family == "hybrid" and cfg.attn_every > 0
                 and cfg.block_pattern == ("mamba",))
    if not is_hybrid and (cfg.block_pattern != ("attn",) or cfg.family != "dense"
                          or cfg.is_encoder_decoder):
        raise NotImplementedError(
            f"{cfg.arch_id}: only dense decoder stacks (block_pattern ('attn',)) and the "
            f"zamba2 hybrid are ported; family {cfg.family!r} is ROADMAP item 18")
    dev = resolve_device(device)
    if is_hybrid:
        return _build_hybrid(cfg, dev)
    dtype = dtype_of(cfg)
    V = cfg.padded_vocab
    n_units = cfg.n_layers // len(cfg.block_pattern)

    def init(generator: torch.Generator):
        params = {
            "blocks": _unit_init(generator, cfg, dtype, (n_units,)),
            "embed": embedding_init(generator, V, cfg.d_model, dtype),
            "final_norm": norm_init(cfg.d_model, dtype, cfg.norm_kind,
                                    device=generator.device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(generator, cfg.d_model, V, dtype)
        return tree_map(lambda t: t.to(dev), params)

    def logits_fn(params, batch):
        x = embed(params["embed"], batch["tokens"])
        positions = torch.arange(x.shape[1], device=x.device)
        x = _decoder_backbone(params, x, positions, cfg)
        return _head(params, x, cfg)

    loss_fn = _loss_fn(cfg, logits_fn)

    # ------------------------------------------------------- serving --
    def init_cache(batch_size, max_len, *, ragged=False):
        return {"b0_attn": _stack(init_kv_cache(cfg, batch_size, max_len, dtype,
                                                ragged=ragged, device=dev), n_units)}

    def prefill(params, batch, max_len):
        x = embed(params["embed"], batch["tokens"])
        positions = torch.arange(x.shape[1], device=x.device)
        kvs = []
        for unit in _layers(params["blocks"]):
            p = unit["b0_attn"]
            a, kv = attend_full_with_cache(p["attn"], apply_norm(p["norm1"], x, cfg.norm_eps),
                                           positions, cfg, max_len)
            x = _block_rest(p, x, a, cfg)
            kvs.append(kv)
        caches = {"b0_attn": KVCache(*(torch.stack(t) for t in zip(*kvs)))}
        return _head(params, x[:, -1:], cfg), caches

    def _decode(params, token, caches, attend):
        """Embed, then every layer with ``attend(p, h, layer_cache)``
        writing its cache slice in place, then the head."""
        x = embed(params["embed"], token)
        kv = caches["b0_attn"]
        for unit, k, v, pos in zip(_layers(params["blocks"]), kv.k.unbind(0),
                                   kv.v.unbind(0), kv.pos.unbind(0)):
            p = unit["b0_attn"]
            a, _ = attend(p["attn"], apply_norm(p["norm1"], x, cfg.norm_eps), KVCache(k, v, pos))
            x = _block_rest(p, x, a, cfg)
        return _head(params, x, cfg), caches

    def decode_step(params, token, t, caches):
        return _decode(params, token, caches,
                       lambda p, h, c: decode_attend(p, h, t, c, cfg))

    def decode_step_ragged(params, token, t, caches, active=None):
        return _decode(params, token, caches,
                       lambda p, h, c: decode_attend_ragged(p, h, t, c, cfg, active=active))

    def init_cache_ragged(batch_size, max_len):
        return init_cache(batch_size, max_len, ragged=True)

    def init_cache_paged(batch_size, max_len, n_pages, page_size=128):
        return kvp.init_paged_cache(cfg, n_units, batch_size, max_len, n_pages, dtype,
                                    page_size, device=dev)

    def prefill_paged(params, batch, cache, slot):
        """Admit one prompt (batch["tokens"] (1, S)) into ``slot``: the dense
        prefill, pages mapped for the slot, and each layer's K/V written
        into the pool in logical order. The slot's row must be released.
        Returns (last-token logits, cache)."""
        S = batch["tokens"].shape[1]
        logits, dcaches = prefill(params, batch, S)
        kv = dcaches["b0_attn"]                    # k (L, 1, W, KV, hd)
        B = cache.page_table.shape[0]
        admit = torch.arange(B, device=dev) == slot
        cache = kvp.alloc_prefill(cache, torch.where(admit, S, 0), admit,
                                  window=cfg.sliding_window)
        row = cache.page_table[slot][None]
        # logical position i sits in rolling slot i % W; positions below the
        # live window alias newer ones but land on unmapped pages (the null
        # page), so the gather is safe
        idx = torch.arange(S, device=dev) % kv.k.shape[2]
        length = torch.full((1,), S, dtype=torch.int32, device=dev)
        for kp, vp, k1, v1 in zip(cache.k_pool.unbind(0), cache.v_pool.unbind(0),
                                  kv.k[:, :, idx].unbind(0), kv.v[:, :, idx].unbind(0)):
            kvp.write_prefill_kv(kp, vp, row, k1, v1, length)
        return logits, cache

    def decode_step_paged(params, token, cache, active=None):
        if active is None:
            active = torch.ones((token.shape[0],), dtype=torch.bool, device=token.device)
        cache = kvp.alloc_decode_page(cache, active)
        x = embed(params["embed"], token)
        for unit, kp, vp in zip(_layers(params["blocks"]), cache.k_pool.unbind(0),
                                cache.v_pool.unbind(0)):
            p = unit["b0_attn"]
            a, _ = kvp.paged_decode_attend(p["attn"], apply_norm(p["norm1"], x, cfg.norm_eps),
                                           (kp, vp), cache.page_table, cache.seq_len, cfg,
                                           active=active)
            x = _block_rest(p, x, a, cfg)
        cache = kvp.advance_and_free(cache, active, window=cfg.sliding_window)
        return _head(params, x, cfg), cache

    return ModelApi(cfg, init, loss_fn, logits_fn, _ce_loss, prefill, decode_step,
                    init_cache, decode_step_ragged=decode_step_ragged,
                    init_cache_ragged=init_cache_ragged, decode_step_paged=decode_step_paged,
                    init_cache_paged=init_cache_paged, prefill_paged=prefill_paged)
