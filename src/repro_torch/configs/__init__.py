"""Architecture registry: ``--arch <id>`` resolves here.

Only the paper's acoustic models are ported; every other arch id of the
reference registry raises ``KeyError`` naming it as not ported yet.
"""
from repro_torch.configs.base import (EncoderConfig, LayerSpec, MLAConfig,
                                      ModelConfig, Segment, reduced)
from repro_torch.configs import lstm_am_7khr

ARCHS = {
    "lstm-am-7khr": lstm_am_7khr.CONFIG,
    "lstm-am-teacher": lstm_am_7khr.TEACHER,
}

# arch ids the reference registers that this package does not serve yet
NOT_PORTED = ("recurrentgemma-2b", "gemma3-27b", "deepseek-67b",
              "h2o-danube-3-4b", "whisper-medium", "qwen3-moe-30b-a3b",
              "qwen2.5-3b", "chameleon-34b", "deepseek-v3-671b",
              "xlstm-350m")


def get_arch(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    base = name[: -len("+swa")] if name.endswith("+swa") else name
    if base in NOT_PORTED:
        raise KeyError(f"arch {name!r} is not ported yet; available: "
                       f"{sorted(ARCHS)}")
    raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")


__all__ = ["ARCHS", "get_arch", "reduced", "ModelConfig", "LayerSpec",
           "Segment", "MLAConfig", "EncoderConfig"]
