"""Snowflake Arctic (480B) — dense-MoE hybrid: 128-expert top-2 MoE in parallel
with a dense residual MLP on every layer. [hf:Snowflake/snowflake-arctic-base]
35L d_model=7168 56H GQA kv=8 d_ff=4864 (both the dense residual and each
expert) vocab=32000.
"""
from repro_torch.configs.base import ModelConfig, SlotSpec

CONFIG = ModelConfig(
    name="arctic-480b",
    arch_type="moe",
    source="hf:Snowflake/snowflake-arctic-base",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    pattern=(SlotSpec("attn", "moe_dense"),),
    num_experts=128,
    top_k=2,
    moe_d_ff=4864,
)
