"""Whisper-medium: encoder-decoder; the conv/mel frontend is a stub
(precomputed frame embeddings are the encoder input).

[arXiv:2212.04356] 24+24L d_model=1024 16H (MHA, kv=16) d_ff=4096 vocab=51865.
"""
from repro_torch.configs.base import (EncoderConfig, LayerSpec, ModelConfig,
                                      Segment)

B = LayerSpec(mixer="attn", ffn="mlp")

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    source="arXiv:2212.04356",
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51_865,
    segments=(Segment((B,), repeat=24),),   # decoder stack
    encoder=EncoderConfig(n_layers=24),
    norm="layernorm",
    act="gelu",
    pos_emb="learned",
    max_target_len=448,
)
