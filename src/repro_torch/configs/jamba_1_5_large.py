"""Jamba-1.5-Large (398B) — hybrid Mamba+attention 1:7 with MoE every 2nd layer.

[arXiv:2403.19887] 72L d_model=8192, attn slots: 64H GQA kv=8; MoE 16 experts
top-2, d_ff=24576. Pattern cycle of 8: attn at slot 0, mamba at 1..7; MoE on
odd slots (every 2nd layer). Deviation: the mamba mixer uses Mamba-2 SSD (the
TPU/MXU-friendly dual form) instead of Mamba-1 — documented in DESIGN.md §8.
"""
from repro_torch.configs.base import ModelConfig, SlotSpec

_CYCLE = tuple(
    SlotSpec("attn" if i == 0 else "mamba", "moe" if i % 2 == 1 else "dense")
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    source="arXiv:2403.19887",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    pattern=_CYCLE,
    num_experts=16,
    top_k=2,
    moe_d_ff=24576,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
)
