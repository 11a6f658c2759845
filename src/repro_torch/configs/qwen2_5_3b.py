"""Qwen2.5-3B: dense, GQA kv=2, QKV bias.

[hf:Qwen/Qwen2.5-0.5B family card, 3B dims] 36L d_model=2048 16H (GQA kv=2)
d_ff=11008 vocab=151936.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, Segment

B = LayerSpec(mixer="attn", ffn="mlp")

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    source="hf:Qwen/Qwen2.5-0.5B",
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab_size=151_936,
    segments=(Segment((B,), repeat=36),),
    norm="rmsnorm",
    act="silu",
    pos_emb="rope",
    rope_theta=1_000_000.0,
    qkv_bias=True,
    tie_embeddings=True,
)
