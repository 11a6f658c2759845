"""Architecture registry: ``--arch <id>`` resolves here.

Every arch id of the reference registry: the paper's acoustic models,
the dense token LMs qwen2.5-3b, h2o-danube-3-4b, gemma3-27b,
deepseek-67b and chameleon-34b, the mixture-of-experts LMs
qwen3-moe-30b-a3b and deepseek-v3-671b (with multi-head latent
attention and multi-token prediction), the recurrent hybrids
recurrentgemma-2b (RG-LRU and local attention) and xlstm-350m (mLSTM and
sLSTM), the encoder-decoder whisper-medium, and the ``+swa`` variant of
each (``swa_variant``, as in the reference).  An unknown id raises
``KeyError``.  ``SHAPES`` and ``supports`` are the reference's input
shapes and its rule for which (arch, shape) pairs run, which
``launch/dryrun.py`` walks.
"""
from repro_torch.configs.base import (SHAPES, EncoderConfig, LayerSpec,
                                      MLAConfig, ModelConfig, Segment,
                                      ShapeConfig, reduced, supports,
                                      swa_variant)
from repro_torch.configs import (chameleon_34b, deepseek_67b,
                                 deepseek_v3_671b, gemma3_27b,
                                 h2o_danube3_4b, lstm_am_7khr, qwen2_5_3b,
                                 qwen3_moe_30b_a3b, recurrentgemma_2b,
                                 whisper_medium, xlstm_350m)

ARCHS = {
    "h2o-danube-3-4b": h2o_danube3_4b.CONFIG,
    "qwen2.5-3b": qwen2_5_3b.CONFIG,
    "gemma3-27b": gemma3_27b.CONFIG,
    "deepseek-67b": deepseek_67b.CONFIG,
    "chameleon-34b": chameleon_34b.CONFIG,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b.CONFIG,
    "deepseek-v3-671b": deepseek_v3_671b.CONFIG,
    "recurrentgemma-2b": recurrentgemma_2b.CONFIG,
    "xlstm-350m": xlstm_350m.CONFIG,
    "lstm-am-7khr": lstm_am_7khr.CONFIG,
    "lstm-am-teacher": lstm_am_7khr.TEACHER,
    "whisper-medium": whisper_medium.CONFIG,
}

ASSIGNED = [k for k in ARCHS if not k.startswith("lstm-am")]


def get_arch(name: str) -> ModelConfig:
    if name.endswith("+swa"):
        return swa_variant(get_arch(name[: -len("+swa")]))
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]


__all__ = ["ARCHS", "ASSIGNED", "SHAPES", "get_arch", "get_shape",
           "supports", "reduced", "swa_variant", "ModelConfig",
           "ShapeConfig", "LayerSpec", "Segment", "MLAConfig",
           "EncoderConfig"]
