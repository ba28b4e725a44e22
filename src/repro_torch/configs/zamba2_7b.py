"""zamba2-7b — 81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000,
ssm_state=64; Mamba2 backbone + one weight-shared full-attention block every
6 mamba blocks (the Zamba trick). [arXiv:2411.15242]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="zamba2-7b",
        family="hybrid",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        d_ff=14336,
        vocab_size=32000,
        head_dim=112,
        ssm_state=64,
        ssm_head_dim=64,
        attn_every=6,
        block_pattern=("mamba",),
        dtype="bfloat16",
        source="[arXiv:2411.15242]",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=5, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=512, ssm_state=16, ssm_head_dim=16,
        attn_every=2, ssm_chunk=16, dtype="float32",
    )
