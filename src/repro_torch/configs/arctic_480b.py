"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base; hf].

Dense-MoE hybrid: 35L, d_model=7168, 56H (GQA kv=8), MoE 128 experts top-2
(expert d_ff=4864) with a dense residual FFN (d_ff=4864) in parallel.
vocab=32000. Full attention => skip long_500k.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    d_ff=4864,
    vocab_size=32000,
    attention=AttentionConfig(
        kind="gqa", n_heads=56, n_kv_heads=8, head_dim=128, rope="rope",
    ),
    moe=MoEConfig(
        num_experts=128, top_k=2, expert_d_ff=4864,
        dense_residual=True, dense_residual_d_ff=4864,
        capacity_factor=1.25,
    ),
    layer_pattern=("attn",),
    norm="rmsnorm",
    activation="swiglu",
    supports_long_context=False,
)
