"""xLSTM-125M [arXiv:2405.04517; unverified].

SSM-family: 12L, d_model=768, 4 heads, vocab=50304, d_ff=0 (xLSTM blocks
carry their own projections). Interleaves sLSTM (scalar memory, recurrent)
and mLSTM (matrix memory, parallelizable) blocks at a 1:7-style ratio —
here a period-4 pattern with one sLSTM per period (xLSTM[7:1] family).
Linear recurrence => sub-quadratic: runs long_500k.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    d_ff=0,
    vocab_size=50304,
    attention=AttentionConfig(kind="gqa", n_heads=4, n_kv_heads=4,
                              head_dim=192, rope="none"),
    ssm=SSMConfig(kind="mlstm", num_heads=4, proj_factor=2.0,
                  chunk_size=256),
    layer_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    norm="layernorm",
    activation="gelu",
    tie_embeddings=True,
    supports_long_context=True,
    max_seq_len=1 << 20,
)
