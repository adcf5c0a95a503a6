"""Qwen2-VL-72B backbone [arXiv:2409.12191; hf].

VLM decoder: 80L, d_model=8192, 64H (GQA kv=8), d_ff=29568, vocab=152064.
Distinctive: M-RoPE (multimodal rotary with (t, h, w) sections). The vision
frontend is a STUB — ``input_specs()`` supplies precomputed patch embeddings.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    d_ff=29568,
    vocab_size=152064,
    attention=AttentionConfig(
        kind="gqa", n_heads=64, n_kv_heads=8, head_dim=128,
        qkv_bias=True, rope="mrope", rope_theta=1000000.0,
        mrope_sections=(16, 24, 24),   # t/h/w split of head_dim/2 = 64
    ),
    layer_pattern=("attn",),
    norm="rmsnorm",
    activation="swiglu",
    frontend="vision",
    frontend_dim=8192,
    supports_long_context=False,
)
