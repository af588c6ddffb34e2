"""Granite-3.0-2B — dense GQA decoder. [hf:ibm-granite/granite-3.0-2b-base]
40L d_model=2048 32H GQA kv=8 d_ff=8192 vocab=49155.
"""
from repro_torch.configs.base import ModelConfig, SlotSpec

CONFIG = ModelConfig(
    name="granite-3-2b",
    arch_type="dense",
    source="hf:ibm-granite/granite-3.0-2b-base",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=49155,
    pattern=(SlotSpec("attn", "dense"),),
    tie_embeddings=True,
)
