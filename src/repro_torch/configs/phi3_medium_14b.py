"""Phi-3-medium 14B [arXiv:2404.14219; unverified].

Dense decoder: 40L, d_model=5120, 40H (GQA kv=10), d_ff=17920,
vocab=100352. RoPE + SwiGLU + RMSNorm.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    d_ff=17920,
    vocab_size=100352,
    attention=AttentionConfig(
        kind="gqa", n_heads=40, n_kv_heads=10, head_dim=128, rope="rope",
    ),
    layer_pattern=("attn",),
    norm="rmsnorm",
    activation="swiglu",
    supports_long_context=False,
)
