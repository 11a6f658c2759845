"""Qwen3-30B-A3B: MoE, 128 experts top-8, all layers MoE.

[hf:Qwen/Qwen3-30B-A3B] 48L d_model=2048 32H (GQA kv=4) expert d_ff=768
vocab=151936.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, Segment

B = LayerSpec(mixer="attn", ffn="moe")

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=6144,               # dense-equivalent (unused; all layers MoE)
    vocab_size=151_936,
    segments=(Segment((B,), repeat=48),),
    norm="rmsnorm",
    act="silu",
    pos_emb="rope",
    rope_theta=1_000_000.0,
    qk_norm=True,
    n_experts=128,
    moe_top_k=8,
    moe_d_ff=768,
    moe_renorm_topk=True,
)
