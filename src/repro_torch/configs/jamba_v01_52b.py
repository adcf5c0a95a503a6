"""Jamba-v0.1 52B [arXiv:2403.19887; hf].

Hybrid Mamba+attention 1:7 interleave, 32L, d_model=4096, 32H (GQA kv=8),
d_ff=14336, vocab=65536, MoE 16 experts top-2 every other layer.
Mamba-dominant => sub-quadratic: runs long_500k (the 4 attention layers use
a sliding window in the long-context decode regime).
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig, SSMConfig

# period-8 pattern: attention at position 3 (1 attn : 7 mamba, Jamba §2)
_PATTERN = ("mamba", "mamba", "mamba", "attn",
            "mamba", "mamba", "mamba", "mamba")

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=65536,
    attention=AttentionConfig(
        kind="gqa", n_heads=32, n_kv_heads=8, head_dim=128,
        rope="none",                 # Jamba uses no positional encoding
        window=4096,                 # applied only in long-context decode
    ),
    moe=MoEConfig(
        num_experts=16, top_k=2, expert_d_ff=14336,
        every_k_layers=2, capacity_factor=1.25,
    ),
    ssm=SSMConfig(kind="mamba", d_state=16, d_conv=4, expand=2,
                  chunk_size=256),
    layer_pattern=_PATTERN,
    norm="rmsnorm",
    activation="swiglu",
    supports_long_context=True,
    max_seq_len=1 << 20,
)
