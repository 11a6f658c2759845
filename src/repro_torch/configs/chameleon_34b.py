"""Chameleon-34B: early-fusion mixed-modal decoder; VQ image tokens live in the
same vocab (the VQ tokenizer itself is the stubbed frontend — inputs are token
ids that may index the image-code range).

[arXiv:2405.09818] 48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.
QK-norm for mixed-modal logit stability (per the paper).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, Segment

B = LayerSpec(mixer="attn", ffn="mlp")

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    source="arXiv:2405.09818",
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65_536,
    segments=(Segment((B,), repeat=48),),
    norm="rmsnorm",
    act="silu",
    pos_emb="rope",
    rope_theta=10_000.0,
    qk_norm=True,
)
