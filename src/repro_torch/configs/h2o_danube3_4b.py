"""H2O-Danube3-4B: llama+mistral mix with sliding-window attention.

[arXiv:2401.16818 / danube3 card] 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000, SWA window 4096.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, Segment

B = LayerSpec(mixer="swa", ffn="mlp", window=4096)

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    source="arXiv:2401.16818",
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32_000,
    segments=(Segment((B,), repeat=24),),
    norm="rmsnorm",
    act="silu",
    pos_emb="rope",
    rope_theta=500_000.0,
)
