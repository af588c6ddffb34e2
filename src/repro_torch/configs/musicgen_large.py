"""MusicGen-Large — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284] 48L d_model=2048 32H (MHA, kv=32) d_ff=8192 vocab=2048,
4 EnCodec codebooks with delay interleave. The EnCodec codec itself is the
modality-frontend stub (carve-out): the decoder consumes/predicts the 4
codebook token streams directly.
"""
from repro_torch.configs.base import ModelConfig, SlotSpec

CONFIG = ModelConfig(
    name="musicgen-large",
    arch_type="audio",
    source="arXiv:2306.05284",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    pattern=(SlotSpec("attn", "dense"),),
    num_codebooks=4,
    rope_theta=10000.0,
)
