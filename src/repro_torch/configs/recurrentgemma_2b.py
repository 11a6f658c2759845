"""RecurrentGemma-2B (Griffin): RG-LRU recurrent blocks + local attention, 2:1.

[arXiv:2402.19427] 26L d_model=2560 10H (GQA kv=1, MQA) d_ff=7680 vocab=256000.
Pattern: (recurrent, recurrent, local-attn) repeated; window 2048.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, Segment

R = LayerSpec(mixer="rglru", ffn="mlp")
L = LayerSpec(mixer="swa", ffn="mlp", window=2048)

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    source="arXiv:2402.19427",
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    # 26 layers = 8 full (R,R,L) groups + (R,R) tail
    segments=(
        Segment((R, R, L), repeat=8),
        Segment((R, R), repeat=1),
    ),
    norm="rmsnorm",
    act="gelu",
    pos_emb="rope",
    rope_theta=10_000.0,
    emb_scale=True,
    tie_embeddings=True,
    logit_softcap=30.0,
    lru_width=2560,
    conv_width=4,
)
