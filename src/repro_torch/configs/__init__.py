"""Architecture registry: ``--arch <id>`` resolves here.

Ported: the paper's acoustic models and the dense token LMs qwen2.5-3b
and h2o-danube-3-4b, and the ``+swa`` variant of each ported dense LM
(``swa_variant``, as in the reference).  Every other arch id of the
reference registry, and its ``+swa`` variant, raises ``KeyError``
naming it as not ported yet.
"""
from repro_torch.configs.base import (EncoderConfig, LayerSpec, MLAConfig,
                                      ModelConfig, Segment, reduced,
                                      swa_variant)
from repro_torch.configs import h2o_danube3_4b, lstm_am_7khr, qwen2_5_3b

ARCHS = {
    "h2o-danube-3-4b": h2o_danube3_4b.CONFIG,
    "qwen2.5-3b": qwen2_5_3b.CONFIG,
    "lstm-am-7khr": lstm_am_7khr.CONFIG,
    "lstm-am-teacher": lstm_am_7khr.TEACHER,
}

# arch ids the reference registers that this package does not serve yet
NOT_PORTED = ("recurrentgemma-2b", "gemma3-27b", "deepseek-67b",
              "whisper-medium", "qwen3-moe-30b-a3b", "chameleon-34b",
              "deepseek-v3-671b", "xlstm-350m")


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
