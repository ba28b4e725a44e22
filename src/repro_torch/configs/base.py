"""Configuration schema for models and the HF optimizer (twin of
``repro/configs/base.py``: ``ModelConfig`` with every field, its derived
sizes and ``param_count``, and ``HFOptConfig``).

The port keeps its own copy so that it imports nothing of the reference.
Only the dense decoder stacks (``block_pattern == ("attn",)``) are built by
``models.transformer`` so far; the other families' fields are kept so that
a configuration means the same in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm", "mlp")
BLOCK_KINDS = ("attn", "moe", "mamba", "slstm", "mlstm")


def pad_vocab(v: int, multiple: int = 256) -> int:
    return ((v + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None            # default d_model // n_heads
    # --- attention ---
    qkv_bias: bool = False
    rope_theta: float = 1e4
    rope_fraction: float = 1.0                # chatglm3: 0.5 (partial RoPE)
    sliding_window: Optional[int] = None
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    # --- hybrid (zamba2): one weight-shared attn block every k mamba blocks
    attn_every: int = 0
    # --- heterogeneous stacks: repeating unit of BLOCK_KINDS ---
    block_pattern: Tuple[str, ...] = ("attn",)
    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    n_audio_frames: int = 1500
    max_target_positions: Optional[int] = None
    # --- vlm (phi-3-vision) ---
    n_vision_tokens: int = 0
    vision_dim: int = 1024
    # --- numerics / misc ---
    ce_chunk: int = 0                         # chunked cross-entropy (not ported)
    shard_hints: bool = False
    # Route attention through the hand-written flash-attention kernels
    # (kernels.flash_ad.flash_mha): forward, dQ, dK/dV and JVP kernels on the
    # card, their plain versions on the CPU.
    use_flash_attention: bool = False
    dtype: str = "float32"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    mlp_act: str = "swiglu"                   # swiglu | gelu
    norm_kind: str = "rmsnorm"                # rmsnorm | layernorm
    source: str = ""
    notes: str = ""

    def __post_init__(self):
        assert self.family in FAMILIES, self.family
        for b in self.block_pattern:
            assert b in BLOCK_KINDS, b

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head), as the
        reference counts it."""
        d, f, V = self.d_model, self.d_ff, self.padded_vocab
        hd, H, KV = self.resolved_head_dim, self.n_heads, self.n_kv_heads
        attn = d * (H * hd) + 2 * d * (KV * hd) + (H * hd) * d
        if self.qkv_bias:
            attn += (H + 2 * KV) * hd
        mlp = 3 * d * f if self.mlp_act == "swiglu" else 2 * d * f
        moe_mlp = self.n_experts * mlp + d * self.n_experts
        din, N = self.d_inner, self.ssm_state
        nh = self.ssm_n_heads if self.ssm_state else 0
        mamba = (
            d * (2 * din + 2 * N + nh)
            + self.ssm_conv * din
            + din * d
            + 3 * nh
        ) if self.ssm_state else 0
        mlstm = 4 * d * d + d * d + 2 * d + d * d
        slstm = 4 * d * d + 4 * (d // max(self.n_heads, 1)) * d + 4 * d

        def block_cost(kind: str) -> int:
            return {
                "attn": attn + mlp + 2 * d,
                "moe": attn + moe_mlp + 2 * d,
                "mamba": mamba + d,
                "mlstm": mlstm + 2 * d,
                "slstm": slstm + 2 * d,
            }[kind]

        n_units = self.n_layers // len(self.block_pattern)
        blocks = n_units * sum(block_cost(k) for k in self.block_pattern)
        if self.family == "hybrid" and self.attn_every:
            blocks += attn + mlp + 2 * d
        if self.is_encoder_decoder:
            blocks += self.n_encoder_layers * (attn + mlp + 2 * d)
            blocks += self.n_layers // len(self.block_pattern) * (attn + 2 * d)
        emb = V * d
        head = 0 if self.tie_embeddings else V * d
        return emb + blocks + head + d


@dataclasses.dataclass(frozen=True)
class HFOptConfig:
    """Optimizer selection and the paper's hyper-parameters (fields and
    defaults as ``repro.configs.base.HFOptConfig``; see ``core.hf.HFConfig``
    for what each means)."""
    name: str = "bicgstab"     # sgd | momentum | adam | gn_cg | hessian_cg | hybrid_cg | bicgstab
    lr: float = 0.1            # first-order only
    momentum: float = 0.9
    max_cg_iters: int = 16
    cg_tol: float = 5e-3
    init_damping: float = 1.0
    cg_decay: float = 0.95
    hvp_batch_frac: float = 0.25     # curvature mini-batch fraction
    precondition: bool = False
    krylov_backend: str = "tree"     # "tree" | "flat" (fused CUDA kernels)
    curvature_mode: str = "linearize"
    curvature_chunk_size: int = 0
    sstep_s: int = 1
    sstep_solver: str = "auto"
    sstep_basis: str = "monomial"
    overlap: bool = False
    nc_mode: str = "truncate"
    reject_nonfinite: bool = True
    strict_descent: bool = False
    descent_guard: float = 0.0
    reject_boost: float = 0.0
