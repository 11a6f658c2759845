"""Architecture registry: ``--arch <id>`` resolves here.

Ported: the paper's acoustic models and the dense token LM qwen2.5-3b
(decode serving).  Every other arch id of the reference registry, and
every ``+swa`` variant, raises ``KeyError`` naming it as not ported yet.
"""
from repro_torch.configs.base import (EncoderConfig, LayerSpec, MLAConfig,
                                      ModelConfig, Segment, reduced)
from repro_torch.configs import lstm_am_7khr, qwen2_5_3b

ARCHS = {
    "lstm-am-7khr": lstm_am_7khr.CONFIG,
    "lstm-am-teacher": lstm_am_7khr.TEACHER,
    "qwen2.5-3b": qwen2_5_3b.CONFIG,
}

# arch ids the reference registers that this package does not serve yet
NOT_PORTED = ("recurrentgemma-2b", "gemma3-27b", "deepseek-67b",
              "h2o-danube-3-4b", "whisper-medium", "qwen3-moe-30b-a3b",
              "chameleon-34b", "deepseek-v3-671b", "xlstm-350m")


def get_arch(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    base = name[: -len("+swa")] if name.endswith("+swa") else name
    if base in NOT_PORTED or base in ARCHS:
        raise KeyError(f"arch {name!r} is not ported yet; available: "
                       f"{sorted(ARCHS)}")
    raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")


__all__ = ["ARCHS", "get_arch", "reduced", "ModelConfig", "LayerSpec",
           "Segment", "MLAConfig", "EncoderConfig"]
