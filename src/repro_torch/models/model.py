"""Top-level decoder (the port of ``repro.models.model``): token embedding,
the block stack, the LM head, and the two serving entry points

  * ``forward``      — full-sequence logits (+ prefill caches)
  * ``decode_step``  — single-token cached decoding

Parameters for slot ``i`` are stacked over ``num_cycles`` (dim 0), as in
JAX; JAX's ``lax.scan`` over cycles is a Python loop over that dim here.
Chunked prefill (``extend_step``), the training loss, multi-codebook and
image-prefix embeddings and ``first_k_dense`` preludes are not ported yet
(ROADMAP A3, A10, A11).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import (RunConfig, slot_cache_specs,
                                       slot_decode, slot_forward, slot_specs)
from repro_torch.models.common import (ParamSpec, rms_norm, softcap,
                                       torch_dtype, tree_map)


def _check_config(cfg: ModelConfig) -> None:
    if cfg.num_codebooks or cfg.num_image_tokens or cfg.first_k_dense:
        raise NotImplementedError(
            f"{cfg.name}: multi-codebook, image-prefix and first_k_dense "
            "models are not ported yet (ROADMAP A11)")


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def model_specs(cfg: ModelConfig) -> Dict[str, Any]:
    _check_config(cfg)
    V, D = cfg.padded_vocab, cfg.d_model
    s: Dict[str, Any] = {"embed": ParamSpec((V, D), ("vocab", "embed"))}
    cycles = main_cycles(cfg)
    s["slots"] = {
        f"slot{i}": slot_specs(cfg, slot, cycles)
        for i, slot in enumerate(cfg.pattern)
    }
    s["final_norm"] = ParamSpec((D,), ("embed",), init="zeros")
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamSpec((D, V), ("embed", "vocab"))
    return s


def main_cycles(cfg: ModelConfig) -> int:
    return (cfg.num_layers - cfg.first_k_dense) // len(cfg.pattern)


def cache_specs(cfg: ModelConfig, batch: int, s_max: int,
                dtype: str = "bfloat16", kv_quant: bool = False) -> Dict[str, Any]:
    _check_config(cfg)
    cycles = main_cycles(cfg)
    return {"slots": {
        f"slot{i}": slot_cache_specs(cfg, slot, cycles, batch, s_max, dtype,
                                     kv_quant)
        for i, slot in enumerate(cfg.pattern)
    }}


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def embed_tokens(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    if "image_embeds" in batch:
        raise NotImplementedError("image-prefix inputs are not ported yet "
                                  "(ROADMAP A11)")
    h = params["embed"][batch["tokens"]]
    if cfg.scale_embed:
        h = h * np.sqrt(cfg.d_model)
    return h.to(torch_dtype(cfg.dtype))


def lm_logits(params, h, cfg: ModelConfig):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = h @ w
    if cfg.padded_vocab != cfg.vocab_size:  # mask padding columns
        valid = torch.arange(cfg.padded_vocab, device=h.device) < cfg.vocab_size
        logits = logits.masked_fill(~valid, -1e30)
    return softcap(logits, cfg.logit_softcap)


def cast_params(params, cfg: ModelConfig):
    """Compute-dtype parameters: every float32 leaf cast to ``cfg.dtype``.

    JAX casts its fp32 masters on every call; the serving engines call this
    once at load time and keep no fp32 copy (the values are identical).
    ``forward``/``decode_step`` call it too, which costs nothing for
    parameters already cast."""
    dt = torch_dtype(cfg.dtype)
    return tree_map(lambda a: a.to(dt) if a.dtype == torch.float32 else a,
                    params)


def _layer(tree, i: int):
    """Cycle ``i`` of a tree of stacked (cycles, ...) tensors, as views."""
    return tree_map(lambda a: a[i], tree)


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------


def forward(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            run: RunConfig, with_cache: bool = False):
    """Full-sequence forward over ``batch["tokens"]`` (B,S).  Returns
    (logits, caches, aux_loss); caches are stacked (cycles, B, S, KV, hd)
    per slot."""
    params = cast_params(params, cfg)
    h = embed_tokens(params, batch, cfg)
    B, S = h.shape[:2]
    positions = torch.arange(S, device=h.device)[None].expand(B, S)
    slot_names = [f"slot{i}" for i in range(len(cfg.pattern))]
    per_cycle = []
    for i in range(main_cycles(cfg)):
        caches = {}
        for n, slot in zip(slot_names, cfg.pattern):
            h, caches[n], _ = slot_forward(_layer(params["slots"][n], i), h,
                                           positions, cfg, slot, run)
        if with_cache:
            per_cycle.append(caches)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = lm_logits(params, h, cfg)
    if not with_cache:
        return logits, None, 0.0
    stacked = {n: {k: torch.stack([c[n][k] for c in per_cycle])
                   for k in per_cycle[0][n]} for n in slot_names}
    return logits, {"slots": stacked}, 0.0


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def decode_step(params, tokens: torch.Tensor, pos: torch.Tensor, caches,
                cfg: ModelConfig, run: RunConfig):
    """One decoding step.

    tokens (B,1) int; pos (B,) int absolute positions; caches as produced
    by ``cache_specs``.  Returns (logits, new_caches).  The caches are
    written in place (each layer's new K/V at ``pos``); a cache whose dtype
    is narrower than the compute dtype is first widened, the dtype JAX's
    one-hot cache write promotes it to, so the returned tree may hold new
    tensors."""
    params = cast_params(params, cfg)
    h = embed_tokens(params, {"tokens": tokens}, cfg)
    slot_names = [f"slot{i}" for i in range(len(cfg.pattern))]
    caches = {n: dict(caches["slots"][n]) for n in slot_names}
    for n in slot_names:
        for k, c in caches[n].items():
            dt = torch.promote_types(c.dtype, h.dtype)
            if dt != c.dtype:
                caches[n][k] = c.to(dt)
    for i in range(main_cycles(cfg)):
        for n, slot in zip(slot_names, cfg.pattern):
            # the per-layer cache views alias the stacked tensors, so the
            # in-place write lands in caches[n]
            h, _ = slot_decode(_layer(params["slots"][n], i), h, pos,
                               _layer(caches[n], i), cfg, slot, run)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = lm_logits(params, h, cfg)
    return logits, {"slots": caches}
