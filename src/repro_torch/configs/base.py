"""Config dataclasses: model topology.

A model is a stack of *segments*; each segment is a repeating *pattern* of
LayerSpecs executed ``repeat`` times.  The port's own copy of the
reference's config types, field for field (minus the XLA cost-probe
switches ``scan_unroll`` and ``remat``), so ``reduced`` and
``swa_variant`` size a model exactly as the reference does.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class LayerSpec:
    """One block = sequence mixer + channel mixer (ffn)."""
    mixer: str = "attn"      # attn | swa | rglru | mlstm | slstm | lstm | bilstm
    ffn: str = "mlp"         # mlp | moe | none
    window: int = 0          # sliding window size for mixer == "swa"


@dataclass(frozen=True)
class Segment:
    pattern: Tuple[LayerSpec, ...]
    repeat: int = 1

    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.repeat


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 Multi-head Latent Attention dims."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style bidirectional encoder."""
    n_layers: int = 24


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str              # dense | moe | ssm | hybrid | audio | vlm | lstm_am
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    segments: Tuple[Segment, ...]
    source: str = ""         # citation for the config
    head_dim: int = 0        # 0 -> d_model // n_heads
    # norm / act / embeddings
    norm: str = "rmsnorm"    # rmsnorm | layernorm
    act: str = "silu"        # silu | gelu
    pos_emb: str = "rope"    # rope | learned | none
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    qk_norm: bool = False
    tie_embeddings: bool = False
    emb_scale: bool = False
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    moe_renorm_topk: bool = True
    # MLA (deepseek-v3)
    mla: Optional[MLAConfig] = None
    # recurrent
    lru_width: int = 0
    conv_width: int = 4
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    # enc-dec (whisper)
    encoder: Optional[EncoderConfig] = None
    max_target_len: int = 448
    # lstm AM (paper baseline)
    lstm_hidden: int = 768
    n_senones: int = 3183
    feat_dim: int = 192              # 64 log-mel x3 stacked
    lookahead: int = 3
    # MTP (deepseek-v3 multi-token prediction)
    mtp_depth: int = 0
    # the reference's cost-probe switch: the plain full-sequence
    # attention runs as one whole-sequence chunk
    attn_whole_seq: bool = False

    @property
    def n_layers(self) -> int:
        return sum(s.n_layers for s in self.segments)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def mixers(self) -> Tuple[str, ...]:
        out = []
        for s in self.segments:
            for _ in range(s.repeat):
                out.extend(spec.mixer for spec in s.pattern)
        return tuple(out)

    @property
    def subquadratic(self) -> bool:
        """True if every sequence mixer has bounded-per-token prefill cost."""
        return all(m in ("swa", "rglru", "mlstm", "slstm", "lstm", "bilstm")
                   for m in self.mixers())

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                # train | prefill | decode


SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}


def supports(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch, shape) is runnable; reason string if not."""
    if shape.name == "long_500k":
        if cfg.encoder is not None:
            return False, "enc-dec full attention; 500k context not meaningful"
        if cfg.family == "lstm_am":
            return False, "frame-synchronous hybrid AM; no autoregressive decode"
        if not cfg.subquadratic:
            # sliding-window-dominant hybrids (gemma3's 5:1 local:global)
            # run: their few global layers decode with an O(S) cache;
            # pure full-attention archs skip (use +swa)
            mixers = cfg.mixers()
            full = sum(m == "attn" for m in mixers)
            if full / max(len(mixers), 1) > 0.25:
                return False, ("pure full-attention arch "
                               "(use --variant swa to run)")
    if shape.kind == "decode" and cfg.family == "lstm_am":
        return False, "hybrid AM has no autoregressive decode step"
    return True, ""


def swa_variant(cfg: ModelConfig, window: int = 4096) -> ModelConfig:
    """Sliding-window variant of a full-attention arch (for long_500k)."""
    segs = tuple(
        Segment(tuple(
            dataclasses.replace(sp, mixer="swa", window=window)
            if sp.mixer == "attn" else sp for sp in s.pattern), s.repeat)
        for s in cfg.segments)
    return cfg.replace(name=cfg.name + "+swa", segments=segs)


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test variant: <=2 layers per distinct pattern element, tiny dims."""
    d_model = min(cfg.d_model, 256)
    n_heads = max(2, min(cfg.n_heads, 4))
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    # keep one group of each distinct segment pattern, truncated to <=2 layers
    segs = []
    for s in cfg.segments[:2]:
        pat = s.pattern[: max(1, min(2, len(s.pattern)))]
        segs.append(Segment(pat, 1))
    mla = MLAConfig(q_lora_rank=64, kv_lora_rank=32, qk_rope_head_dim=16,
                    qk_nope_head_dim=32, v_head_dim=32) if cfg.mla else None
    n_sen = min(cfg.n_senones, 97)
    return cfg.replace(
        name=cfg.name + "-smoke",
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=64 if cfg.head_dim else 0,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=(n_sen if cfg.family == "lstm_am"
                    else min(cfg.vocab_size, 512)),
        segments=tuple(segs),
        n_experts=min(cfg.n_experts, 4),
        n_shared_experts=min(cfg.n_shared_experts, 1),
        moe_top_k=min(cfg.moe_top_k, 2),
        moe_d_ff=min(cfg.moe_d_ff, 128),
        capacity_factor=4.0,
        mla=mla,
        lru_width=min(cfg.lru_width, d_model) if cfg.lru_width else 0,
        encoder=EncoderConfig(n_layers=2) if cfg.encoder else None,
        lstm_hidden=min(cfg.lstm_hidden, 128),
        n_senones=n_sen,
        feat_dim=min(cfg.feat_dim, 48),
        max_target_len=min(cfg.max_target_len, 64),
        mtp_depth=min(cfg.mtp_depth, 1),
    )
