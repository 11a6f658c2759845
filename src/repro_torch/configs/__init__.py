"""Architecture registry: ``--arch <id>`` resolves here.

Ported: the paper's acoustic models, the dense token LMs qwen2.5-3b,
h2o-danube-3-4b, gemma3-27b, deepseek-67b and chameleon-34b, the
mixture-of-experts LM qwen3-moe-30b-a3b, the encoder-decoder
whisper-medium, and the
``+swa`` variant of each ported arch (``swa_variant``, as in the
reference).  Every other arch id of the reference registry, and its
``+swa`` variant, raises ``KeyError`` naming it as not ported yet.
"""
from repro_torch.configs.base import (EncoderConfig, LayerSpec, MLAConfig,
                                      ModelConfig, Segment, reduced,
                                      swa_variant)
from repro_torch.configs import (chameleon_34b, deepseek_67b, gemma3_27b,
                                 h2o_danube3_4b, lstm_am_7khr, qwen2_5_3b,
                                 qwen3_moe_30b_a3b, whisper_medium)

ARCHS = {
    "h2o-danube-3-4b": h2o_danube3_4b.CONFIG,
    "qwen2.5-3b": qwen2_5_3b.CONFIG,
    "gemma3-27b": gemma3_27b.CONFIG,
    "deepseek-67b": deepseek_67b.CONFIG,
    "chameleon-34b": chameleon_34b.CONFIG,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b.CONFIG,
    "lstm-am-7khr": lstm_am_7khr.CONFIG,
    "lstm-am-teacher": lstm_am_7khr.TEACHER,
    "whisper-medium": whisper_medium.CONFIG,
}

# arch ids the reference registers that this package does not serve yet
NOT_PORTED = ("recurrentgemma-2b", "deepseek-v3-671b", "xlstm-350m")


def get_arch(name: str) -> ModelConfig:
    if name.endswith("+swa"):
        base = name[: -len("+swa")]
        if base in ARCHS:
            return swa_variant(ARCHS[base])
        name = base
    if name in ARCHS:
        return ARCHS[name]
    if name in NOT_PORTED:
        raise KeyError(f"arch {name!r} is not ported yet; available: "
                       f"{sorted(ARCHS)}")
    raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")


__all__ = ["ARCHS", "get_arch", "reduced", "swa_variant", "ModelConfig",
           "LayerSpec", "Segment", "MLAConfig", "EncoderConfig"]
