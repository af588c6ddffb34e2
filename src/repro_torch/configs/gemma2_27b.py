"""Gemma2-27B — dense GQA with alternating local(SWA-4096)/global attention and
logit softcapping. [arXiv:2408.00118]
46L d_model=4608 32H GQA kv=16 head_dim=128 d_ff=36864 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig, SlotSpec

CONFIG = ModelConfig(
    name="gemma2-27b",
    arch_type="dense",
    source="arXiv:2408.00118",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    pattern=(SlotSpec("swa", "dense"), SlotSpec("attn", "dense")),
    sliding_window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    tie_embeddings=True,
    use_post_norm=True,
    scale_embed=True,
)
