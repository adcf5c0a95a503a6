"""SeamlessM4T-medium backbone [arXiv:2308.11596; hf].

Enc-dec transformer, 12L each side, d_model=1024, 16H (kv=16), d_ff=4096,
vocab=256206. Multimodal: the audio frontend is a STUB — ``input_specs()``
supplies precomputed frame embeddings of dim ``frontend_dim`` (the w2v-BERT
feature dim equals d_model here).
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="enc_dec",
    num_layers=12,               # decoder layers
    encoder_layers=12,
    d_model=1024,
    d_ff=4096,
    vocab_size=256206,
    attention=AttentionConfig(
        kind="gqa", n_heads=16, n_kv_heads=16, head_dim=64,
        rope="sinusoidal",
    ),
    layer_pattern=("attn",),
    norm="layernorm",
    activation="gelu",
    frontend="audio",
    frontend_dim=1024,
    supports_long_context=False,   # full-attention enc-dec: skip long_500k
    max_seq_len=32768,
)
