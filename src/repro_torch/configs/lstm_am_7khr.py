"""The paper's baseline acoustic model (Section 2): HMM-LSTM hybrid.

5x768 unidirectional LSTM student (~24M params), 3,183 senones, 64-d log-mel
stacked x3 / subsampled to 30ms (feat_dim 192), 3-frame look-ahead.
Teacher: 5x768 bidirectional LSTM (~78M params).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, Segment

B = LayerSpec(mixer="lstm", ffn="none")

CONFIG = ModelConfig(
    name="lstm-am-7khr",
    family="lstm_am",
    source="arXiv:1904.01624 (the paper)",
    d_model=768,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab_size=3183,         # senone outputs
    segments=(Segment((B,), repeat=5),),
    norm="layernorm",
    pos_emb="none",
    lstm_hidden=768,
    n_senones=3183,
    feat_dim=192,
    lookahead=3,
)

TEACHER = CONFIG.replace(
    name="lstm-am-teacher",
    segments=(Segment((LayerSpec(mixer="bilstm", ffn="none"),), repeat=5),),
)
