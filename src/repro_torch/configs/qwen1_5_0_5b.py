"""qwen1.5-0.5b — 24L d_model=1024 16H (kv=16) d_ff=2816 vocab=151936,
QKV bias. [hf:Qwen/Qwen1.5-0.5B]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen1.5-0.5b",
        family="dense",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=2816,
        vocab_size=151936,
        qkv_bias=True,
        tie_embeddings=True,
        block_pattern=("attn",),
        dtype="bfloat16",
        source="[hf:Qwen/Qwen1.5-0.5B]",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab_size=512, dtype="float32",
    )
