"""granite-3-8b — 40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155.
[hf:ibm-granite/granite-3.0-8b-base]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="granite-3-8b",
        family="dense",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=12800,
        vocab_size=49155,
        block_pattern=("attn",),
        dtype="bfloat16",
        source="[hf:ibm-granite/granite-3.0-2b-base]",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=512, dtype="float32",
    )
