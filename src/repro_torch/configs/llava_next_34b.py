"""LLaVA-NeXT-34B — VLM: dense GQA language backbone consuming precomputed
patch embeddings (anyres tiling). [hf:llava-hf/llava-v1.6-mistral-7b-hf]
60L d_model=7168 56H GQA kv=8 d_ff=20480 vocab=64000. The ViT/SigLIP encoder +
projector is the modality-frontend stub (carve-out): ``input_specs`` supplies
(B, num_image_tokens, d_model) patch embeddings prepended to the text tokens.
"""
from repro_torch.configs.base import ModelConfig, SlotSpec

CONFIG = ModelConfig(
    name="llava-next-34b",
    arch_type="vlm",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    pattern=(SlotSpec("attn", "dense"),),
    num_image_tokens=576,  # one anyres base tile (24x24 patches)
    rope_theta=1_000_000.0,
)
