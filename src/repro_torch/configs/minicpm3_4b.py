"""MiniCPM3-4B — small dense decoder with MLA. [hf:openbmb/MiniCPM3-4B]
62L d_model=2560 40H (MLA) d_ff=6400 vocab=73448; kv_lora_rank=256,
q_lora_rank=768, qk_nope=64, qk_rope=32, v=64.
"""
from repro_torch.configs.base import ModelConfig, SlotSpec

CONFIG = ModelConfig(
    name="minicpm3-4b",
    arch_type="dense",
    source="hf:openbmb/MiniCPM3-4B",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    head_dim=96,  # qk_nope + qk_rope
    d_ff=6400,
    vocab_size=73448,
    pattern=(SlotSpec("mla", "dense"),),
    kv_lora_rank=256,
    q_lora_rank=768,
    qk_nope_head_dim=64,
    qk_rope_head_dim=32,
    v_head_dim=64,
    tie_embeddings=True,
)
