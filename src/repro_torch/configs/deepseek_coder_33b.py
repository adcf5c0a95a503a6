"""DeepSeek-Coder-33B [arXiv:2401.14196; hf].

Llama-arch dense decoder: 62L, d_model=7168, 56H (GQA kv=8), d_ff=19200,
vocab=32256.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    d_ff=19200,
    vocab_size=32256,
    attention=AttentionConfig(
        kind="gqa", n_heads=56, n_kv_heads=8, head_dim=128, rope="rope",
    ),
    layer_pattern=("attn",),
    norm="rmsnorm",
    activation="swiglu",
    supports_long_context=False,
)
