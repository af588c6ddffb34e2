"""Configuration system: model configs, slot specs, input shapes, registry.

A model is a stack of ``num_layers`` blocks generated by cycling a
``pattern`` of :class:`SlotSpec`. The decoder scans over *cycles* so the HLO
is O(len(pattern)) regardless of depth.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Tuple

# ---------------------------------------------------------------------------
# Slot specification: one block = mixer + mlp
# ---------------------------------------------------------------------------

MIXERS = ("attn", "swa", "mla", "mla_swa", "mamba")
MLPS = ("dense", "moe", "moe_dense")  # moe_dense = MoE + parallel dense residual


@dataclass(frozen=True)
class SlotSpec:
    """One block template inside the layer-pattern cycle."""

    mixer: str  # one of MIXERS
    mlp: str  # one of MLPS

    def __post_init__(self):
        assert self.mixer in MIXERS, self.mixer
        assert self.mlp in MLPS, self.mlp


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    source: str  # citation (arXiv id / model card)

    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    pattern: Tuple[SlotSpec, ...] = (SlotSpec("attn", "dense"),)
    # Slots (by index within pattern) whose mlp is dense even if pattern says moe:
    first_k_dense: int = 0  # first k *layers* use dense mlp (deepseek-v2)

    # attention
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0  # window size for "swa" mixer slots
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0
    attn_window_override: int = 0  # >0: force SWA at serve time (long_500k variant)

    # MLA (deepseek-v2 / minicpm3)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    # experts a device holds of each MoE layer (the first ones): 0 holds
    # all ``num_experts``; fewer is one card's share of expert parallelism,
    # routed over all ``num_experts`` with no exchange (``models/moe.py``)
    experts_held: int = 0

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # embeddings / heads
    tie_embeddings: bool = False
    num_codebooks: int = 0  # musicgen: >0 → multi-codebook token IO
    num_image_tokens: int = 0  # llava: patch embeddings prepended

    # numerics / block style
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    use_post_norm: bool = False  # gemma2: extra RMSNorm after each sublayer
    scale_embed: bool = False  # gemma2: hidden *= sqrt(d_model) after embed

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 (TP-16 divisible, MXU-aligned).
        Embedding rows / logit columns beyond ``vocab_size`` are masked."""
        return -(-self.vocab_size // 256) * 256

    @property
    def num_cycles(self) -> int:
        assert self.num_layers % len(self.pattern) == 0, (
            f"{self.name}: num_layers={self.num_layers} not divisible by "
            f"pattern length {len(self.pattern)}"
        )
        return self.num_layers // len(self.pattern)

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_mla(self) -> bool:
        return any(s.mixer.startswith("mla") for s in self.pattern)

    @property
    def has_attention(self) -> bool:
        return any(s.mixer != "mamba" for s in self.pattern)

    @property
    def has_moe(self) -> bool:
        return any(s.mlp != "dense" for s in self.pattern)

    @property
    def has_ssm(self) -> bool:
        return any(s.mixer == "mamba" for s in self.pattern)

    @property
    def subquadratic(self) -> bool:
        """True if no slot does unwindowed full attention (long_500k native)."""
        full = {"attn", "mla"}
        return (
            all(s.mixer not in full for s in self.pattern)
            or self.attn_window_override > 0
        )

    @property
    def kv_cache_width(self) -> int:
        """Per-token per-layer KV cache width (elements) for attention slots."""
        if not self.has_attention:
            return 0
        if self.is_mla:
            return self.kv_lora_rank + self.qk_rope_head_dim
        return 2 * self.num_kv_heads * self.head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests (≤2 slots, d≤512, ≤4 experts)."""
        pattern = self.pattern
        if len(pattern) > 2:
            # keep the *distinct* slot kinds (e.g. jamba: attn + mamba)
            seen, keep = set(), []
            for s in pattern:
                k = (s.mixer, s.mlp)
                if k not in seen:
                    seen.add(k)
                    keep.append(s)
                if len(keep) == 2:
                    break
            pattern = tuple(keep)
        if self.num_kv_heads == 0:
            red_kv = 0
        elif self.num_kv_heads == self.num_heads:
            red_kv = 4  # MHA / MLA keep kv == heads
        else:
            red_kv = 2
        kw = dict(
            pattern=pattern,
            d_model=256,
            num_heads=4,
            num_kv_heads=red_kv,
            head_dim=64,
            d_ff=512,
            vocab_size=512,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            attn_window_override=0,
        )
        kw["num_layers"] = len(pattern)  # one cycle
        if self.num_experts:
            kw.update(num_experts=4, top_k=min(self.top_k, 2), moe_d_ff=256,
                      num_shared_experts=min(self.num_shared_experts, 1))
        if self.kv_lora_rank:
            kw.update(kv_lora_rank=64, q_lora_rank=128, qk_nope_head_dim=32,
                      qk_rope_head_dim=16, v_head_dim=32)
        if self.ssm_state:
            kw.update(ssm_state=32, ssm_head_dim=32, ssm_chunk=32)
        if self.num_image_tokens:
            kw.update(num_image_tokens=8)
        if self.num_codebooks:
            kw.update(num_codebooks=self.num_codebooks)
        return self.replace(**kw)


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

SMOKE_SHAPE = ShapeConfig("smoke", 128, 2, "train")


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_IDS = [
    "musicgen-large",
    "qwen2-72b",
    "mamba2-780m",
    "jamba-1.5-large-398b",
    "arctic-480b",
    "llava-next-34b",
    "deepseek-v2-236b",
    "gemma2-27b",
    "granite-3-2b",
    "minicpm3-4b",
]

_MODULES = {
    "musicgen-large": "musicgen_large",
    "qwen2-72b": "qwen2_72b",
    "mamba2-780m": "mamba2_780m",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "arctic-480b": "arctic_480b",
    "llava-next-34b": "llava_next_34b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "gemma2-27b": "gemma2_27b",
    "granite-3-2b": "granite_3_2b",
    "minicpm3-4b": "minicpm3_4b",
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}
