"""DeepSeek-V3 671B: MLA attention, 1 shared + 256 routed experts top-8, MTP.

[arXiv:2412.19437] 61L d_model=7168 128H (MLA; spec lists kv=128) expert
d_ff=2048 vocab=129280. First 3 layers dense (d_ff=18432), rest MoE.
"""
from repro_torch.configs.base import LayerSpec, MLAConfig, ModelConfig, Segment

DENSE = LayerSpec(mixer="attn", ffn="mlp")
MOE = LayerSpec(mixer="attn", ffn="moe")

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    source="arXiv:2412.19437",
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=18432,              # dense layers (first 3)
    vocab_size=129_280,
    segments=(
        Segment((DENSE,), repeat=3),
        Segment((MOE,), repeat=58),
    ),
    norm="rmsnorm",
    act="silu",
    pos_emb="rope",
    rope_theta=10_000.0,
    n_experts=256,
    n_shared_experts=1,
    moe_top_k=8,
    moe_d_ff=2048,
    moe_renorm_topk=True,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_rope_head_dim=64,
                  qk_nope_head_dim=128, v_head_dim=128),
    mtp_depth=1,
)
