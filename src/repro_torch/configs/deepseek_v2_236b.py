"""DeepSeek-V2 236B [arXiv:2405.04434; hf].

MoE with Multi-head Latent Attention: 60L, d_model=5120, 128 heads,
kv_lora=512, q_lora=1536, qk_nope=128, qk_rope=64, v_head=128.
MoE: 2 shared + 160 routed experts, top-6, expert d_ff=1536; layer 0 dense.
vocab=102400. MLA is still full attention => skip long_500k.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    d_ff=12288,                     # dense layer-0 FFN width
    vocab_size=102400,
    attention=AttentionConfig(
        kind="mla", n_heads=128, n_kv_heads=128, head_dim=128,
        rope="rope",
        q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=160, top_k=6, expert_d_ff=1536,
        num_shared_experts=2, shared_d_ff=1536,
        first_dense_layers=1, capacity_factor=1.25,
    ),
    layer_pattern=("attn",),
    norm="rmsnorm",
    activation="swiglu",
    supports_long_context=False,
)
