"""Gemma-3 27B: dense, 5 local (sliding-window 1024) : 1 global, 128k context.

[hf:google/gemma-3-1b-pt family card, 27B dims] 62L d_model=5376 32H (GQA kv=16)
d_ff=21504 vocab=262144.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, Segment

LOCAL = LayerSpec(mixer="swa", ffn="mlp", window=1024)
GLOBAL = LayerSpec(mixer="attn", ffn="mlp")

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    source="hf:google/gemma-3-1b-pt",
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262_144,
    # 62 layers = 10 x (5 local + 1 global) + 2 local tail
    segments=(
        Segment((LOCAL,) * 5 + (GLOBAL,), repeat=10),
        Segment((LOCAL, LOCAL), repeat=1),
    ),
    norm="rmsnorm",
    act="gelu",
    pos_emb="rope",
    rope_theta=1_000_000.0,
    qk_norm=True,
    emb_scale=True,
    tie_embeddings=True,
)
