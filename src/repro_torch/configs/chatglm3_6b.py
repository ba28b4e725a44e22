"""chatglm3-6b — 28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024,
RoPE 2d (partial rotary, fraction 0.5), QKV bias. [arXiv:2406.12793]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="chatglm3-6b",
        family="dense",
        n_layers=28,
        d_model=4096,
        n_heads=32,
        n_kv_heads=2,
        d_ff=13696,
        vocab_size=65024,
        qkv_bias=True,
        rope_fraction=0.5,
        block_pattern=("attn",),
        dtype="bfloat16",
        source="[arXiv:2406.12793]",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=512, dtype="float32",
    )
