"""Mamba2-780m — attention-free SSD (state-space duality). [arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig, SlotSpec

CONFIG = ModelConfig(
    name="mamba2-780m",
    arch_type="ssm",
    source="arXiv:2405.21060",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    pattern=(SlotSpec("mamba", "dense"),),  # mamba block has no separate MLP;
    # d_ff=0 makes the dense MLP a no-op passthrough (see blocks.py)
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    tie_embeddings=True,
)
