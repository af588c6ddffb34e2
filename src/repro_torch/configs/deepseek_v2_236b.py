"""DeepSeek-V2 (236B) — MLA + fine-grained MoE. [arXiv:2405.04434]

60L d_model=5120, 128 heads MLA (kv_lora_rank=512, q_lora_rank=1536,
qk_nope=128, qk_rope=64, v=128); MoE: 160 routed experts top-6 + 2 shared,
expert d_ff=1536; layer 0 dense with d_ff=12288 (model card).
"""
from repro_torch.configs.base import ModelConfig, SlotSpec

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    source="arXiv:2405.04434",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,  # MLA: per-head KV reconstructed from the latent
    head_dim=128,
    d_ff=12288,  # dense d_ff (first_k_dense layers)
    vocab_size=102400,
    pattern=(SlotSpec("mla", "moe"),),
    first_k_dense=1,
    num_experts=160,
    num_shared_experts=2,
    top_k=6,
    moe_d_ff=1536,
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
)
