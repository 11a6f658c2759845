"""xLSTM-350M: alternating mLSTM (matrix memory, parallelizable) and sLSTM
(scalar memory, strictly recurrent) blocks.

[arXiv:2405.04517] 24L d_model=1024 4H d_ff=0 (blocks carry their own
up-projections) vocab=50304.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, Segment

M = LayerSpec(mixer="mlstm", ffn="none")
S = LayerSpec(mixer="slstm", ffn="none")

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    source="arXiv:2405.04517",
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50_304,
    # xLSTM[7:1]-ish mix: mostly mLSTM with periodic sLSTM
    segments=(Segment((M, M, M, S), repeat=6),),
    norm="layernorm",
    act="gelu",
    pos_emb="none",
    mlstm_proj_factor=2.0,
    slstm_proj_factor=4.0 / 3.0,
    conv_width=4,
)
