"""OLMo-1B [arXiv:2402.00838; hf].

Dense decoder: 16L, d_model=2048, 16H (kv=16), d_ff=8192, vocab=50304.
Distinctive: non-parametric LayerNorm (no scale/bias).
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    d_ff=8192,
    vocab_size=50304,
    attention=AttentionConfig(
        kind="gqa", n_heads=16, n_kv_heads=16, head_dim=128, rope="rope",
    ),
    layer_pattern=("attn",),
    norm="nonparametric_ln",
    activation="swiglu",
    tie_embeddings=True,
    supports_long_context=False,
)
