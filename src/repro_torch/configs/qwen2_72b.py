"""Qwen2-72B — dense GQA decoder with QKV bias. [arXiv:2407.10671]"""
from repro_torch.configs.base import ModelConfig, SlotSpec

CONFIG = ModelConfig(
    name="qwen2-72b",
    arch_type="dense",
    source="arXiv:2407.10671",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    pattern=(SlotSpec("attn", "dense"),),
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
