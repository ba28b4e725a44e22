"""Dense decoder transformers (twin of ``repro/models/transformer.py`` for
stacks whose repeating unit is one attention block, ``block_pattern ==
("attn",)``: the qwen, granite and chatglm configurations).

The parameter tree is the reference's: ``params["blocks"]`` is a dict whose
leaves are stacked on a leading layer axis, beside ``embed``,
``final_norm`` and (untied) ``lm_head``, every dict in sorted-key order. So
the flat Krylov layout and ``tree_pseudo_noise`` match the reference's leaf
for leaf. The reference scans the stack with ``lax.scan``; the backbone here
is a Python loop over the layer axis.

``loss_fn`` is twice differentiable. The other families (MoE, SSM, hybrid,
xLSTM, encoder-decoder, vlm) are ROADMAP item 18; ``prefill`` and
``decode_step`` belong to serving (item 20); chunked cross-entropy
(``ce_chunk > 0``) and the reference's ``remat`` of the layer scan are not
ported yet.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from .._device import resolve_device
from .attention import attend_full, attn_init
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
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


def _unit_init(gen, cfg, dtype, lead):
    d = cfg.d_model
    return {"b0_attn": {
        "attn": attn_init(gen, cfg, dtype, lead=lead),
        "mlp": mlp_init(gen, d, cfg.d_ff, dtype, cfg.mlp_act, lead=lead),
        "norm1": norm_init(d, dtype, cfg.norm_kind, lead=lead, device=gen.device),
        "norm2": norm_init(d, dtype, cfg.norm_kind, lead=lead, device=gen.device),
    }}


def _unit_apply(unit, x, positions, cfg):
    """One ``("attn",)`` unit: pre-norm attention and MLP, each residual."""
    p = unit["b0_attn"]
    h = apply_norm(p["norm1"], x, cfg.norm_eps)
    x = x + attend_full(p["attn"], h, positions, cfg)
    h = apply_norm(p["norm2"], x, cfg.norm_eps)
    return x + apply_mlp(p["mlp"], h)


def _decoder_backbone(params, x, positions, cfg):
    """The stacked units applied in order. Each leaf is unbound once along
    the layer axis: the backward of ``unbind`` is one ``stack``, where
    indexing layer by layer would add a zero-filled copy of the whole stack
    per layer."""
    leaves, spec = tree_flatten(params["blocks"])
    per_layer = [t.unbind(0) for t in leaves]
    for i in range(len(per_layer[0])):
        x = _unit_apply(tree_unflatten([t[i] for t in per_layer], spec), x, positions, cfg)
    return x


def _ce_loss(logits, batch):
    targets = batch["targets"]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32, device=targets.device)
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def _unported(what):
    def fn(*args, **kwargs):
        raise NotImplementedError(what)
    return fn


def build_model(cfg, *, device="cuda") -> ModelApi:
    """The model's pure functions over a parameter tree on ``device``."""
    if (cfg.block_pattern != ("attn",) or cfg.family != "dense"
            or cfg.is_encoder_decoder):
        raise NotImplementedError(
            f"{cfg.arch_id}: only dense decoder stacks (block_pattern ('attn',)) are "
            f"ported; family {cfg.family!r} is ROADMAP item 18")
    dev = resolve_device(device)
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

    def head(params, x):
        x = apply_norm(params["final_norm"], x, cfg.norm_eps)
        if cfg.tie_embeddings:
            return unembed(params["embed"], x)
        return dense(params["lm_head"], x).float()

    def logits_fn(params, batch):
        x = embed(params["embed"], batch["tokens"])
        positions = torch.arange(x.shape[1], device=x.device)
        x = _decoder_backbone(params, x, positions, cfg)
        return head(params, x)

    def out_loss_fn(logits, batch):
        return _ce_loss(logits, batch)

    def loss_fn(params, batch):
        if cfg.ce_chunk:
            raise NotImplementedError(
                "chunked cross-entropy (ce_chunk > 0) is not ported yet (ROADMAP item 16)")
        return _ce_loss(logits_fn(params, batch), batch)

    serving = "prefill and decoding are serving's (ROADMAP item 20, slice 5)"
    return ModelApi(cfg, init, loss_fn, logits_fn, out_loss_fn, _unported(serving),
                    _unported(serving), _unported(serving))
