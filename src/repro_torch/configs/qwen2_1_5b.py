"""qwen2-1.5b — 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936,
QKV bias. [arXiv:2407.10671]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen2-1.5b",
        family="dense",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        d_ff=8960,
        vocab_size=151936,
        qkv_bias=True,
        tie_embeddings=True,
        block_pattern=("attn",),
        dtype="bfloat16",
        source="[arXiv:2407.10671]",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=512, dtype="float32",
    )
