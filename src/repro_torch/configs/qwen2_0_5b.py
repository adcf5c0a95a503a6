"""Qwen2-0.5B [arXiv:2407.10671; hf].

Dense decoder: 24L, d_model=896, 14H (GQA kv=2), d_ff=4864, vocab=151936.
Distinctive: QKV bias; tied embeddings.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    d_ff=4864,
    vocab_size=151936,
    attention=AttentionConfig(
        kind="gqa", n_heads=14, n_kv_heads=2, head_dim=64,
        qkv_bias=True, rope="rope", rope_theta=1000000.0,
    ),
    layer_pattern=("attn",),
    norm="rmsnorm",
    activation="swiglu",
    tie_embeddings=True,
    supports_long_context=False,
)
