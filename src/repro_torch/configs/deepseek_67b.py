"""DeepSeek-LLM 67B: llama-architecture dense decoder.

[arXiv:2401.02954] 95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, Segment

B = LayerSpec(mixer="attn", ffn="mlp")

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    source="arXiv:2401.02954",
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=102_400,
    segments=(Segment((B,), repeat=95),),
    norm="rmsnorm",
    act="silu",
    pos_emb="rope",
    rope_theta=10_000.0,
)
