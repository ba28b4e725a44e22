"""Model configurations of the port (copies of ``repro.configs`` entries):
the paper's MLPs (``paper_mlp``), the dense decoder architectures and the
zamba2 hybrid, by their dashed ids."""
from .base import HFOptConfig, ModelConfig, pad_vocab
from . import chatglm3_6b, granite_3_8b, qwen1_5_0_5b, qwen2_1_5b, zamba2_7b

_MODULES = {
    "qwen1.5-0.5b": qwen1_5_0_5b,
    "chatglm3-6b": chatglm3_6b,
    "granite-3-8b": granite_3_8b,
    "qwen2-1.5b": qwen2_1_5b,
    "zamba2-7b": zamba2_7b,
}

# The reference's other architectures; their families (MoE, xLSTM, whisper,
# vlm) are ROADMAP item 18 and not ported yet.
UNPORTED_ARCH_IDS = ("mixtral-8x22b", "xlstm-1.3b", "granite-moe-1b-a400m", "whisper-small",
                     "phi-3-vision-4.2b")

ARCH_IDS = tuple(_MODULES)


def _module(arch_id: str):
    if arch_id in _MODULES:
        return _MODULES[arch_id]
    if arch_id in UNPORTED_ARCH_IDS:
        raise NotImplementedError(
            f"{arch_id}: its family is not ported yet (ROADMAP item 18); the "
            f"port builds {ARCH_IDS}")
    raise KeyError(f"unknown architecture {arch_id!r}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()


__all__ = ["ARCH_IDS", "HFOptConfig", "ModelConfig", "UNPORTED_ARCH_IDS",
           "get_config", "get_smoke_config", "pad_vocab"]
