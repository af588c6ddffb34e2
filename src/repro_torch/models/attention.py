"""GQA attention mixer (the port of ``repro.models.attention``, GQA only):
full-sequence path (prefill) and cached single-token decode.

``impl`` names the attention algorithm:

* ``"dense"``  — the plain reference (:func:`dense_attention`, the model-
  level oracle the JAX package also keeps);
* ``"kernel"`` — the hand-written CUDA kernels, the counterpart of JAX's
  ``"pallas"``: prefill goes to the flash kernel, decode to the decode
  kernel.  On CPU tensors they run their plain versions.

Shapes: x (B, S, D); caches are per-slot dicts of (B, S_max, KV, hd).
MLA, int8 KV caches and chunked prefill are not ported yet (ROADMAP A10,
A11) and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamSpec, rope, softcap

NEG_INF = -2.0e38
IMPLS = ("dense", "kernel")


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------


def gqa_specs(cfg: ModelConfig, layers: int) -> Dict[str, ParamSpec]:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    L = (layers,)
    la = ("layers",)
    s = {
        "wq": ParamSpec(L + (D, H, hd), la + ("embed", "q_heads", None)),
        "wk": ParamSpec(L + (D, KV, hd), la + ("embed", "kv_heads", None)),
        "wv": ParamSpec(L + (D, KV, hd), la + ("embed", "kv_heads", None)),
        "wo": ParamSpec(L + (H, hd, D), la + ("q_heads", None, "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec(L + (H, hd), la + ("q_heads", None), init="zeros")
        s["bk"] = ParamSpec(L + (KV, hd), la + ("kv_heads", None), init="zeros")
        s["bv"] = ParamSpec(L + (KV, hd), la + ("kv_heads", None), init="zeros")
    return s


def attn_specs(cfg: ModelConfig, mixer: str, layers: int) -> Dict[str, ParamSpec]:
    if mixer.startswith("mla"):
        raise NotImplementedError("MLA attention is not ported yet (ROADMAP A11)")
    return gqa_specs(cfg, layers)


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------


def _mask(q_pos, k_pos, window: int):
    """(..., Sq, Sk) boolean mask: causal + optional sliding window.
    Negative k_pos marks invalid (unwritten ring-buffer) slots."""
    m = (k_pos[..., None, :] <= q_pos[..., :, None]) & (k_pos[..., None, :] >= 0)
    if window:
        m &= (q_pos[..., :, None] - k_pos[..., None, :]) < window
    return m


def dense_attention(q, k, v, q_pos, k_pos, *, scale, window=0, cap=0.0):
    """q (B,Sq,H,dk), k (B,Sk,KV,dk), v (B,Sk,KV,dv); GQA via head groups."""
    B, Sq, H, dk = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, dk)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() * scale
    logits = softcap(logits, cap)
    m = _mask(q_pos, k_pos, window)[:, None, None]  # (B,1,1,Sq,Sk)
    logits = logits.masked_fill(~m, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, H, v.shape[-1])


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"attn impl must be one of {IMPLS}, got {impl!r}")


def attention(q, k, v, q_pos, k_pos, *, scale, window=0, cap=0.0,
              impl="dense"):
    """Full-sequence attention.  ``impl="kernel"`` takes no positions: the
    flash kernel is causal from position 0, which holds for whole-prompt
    prefill, the only caller."""
    _check_impl(impl)
    if impl == "kernel":
        from repro_torch.kernels import ops as kops
        return kops.flash_attention(q, k, v, scale=scale, window=window,
                                    cap=cap)
    return dense_attention(q, k, v, q_pos, k_pos, scale=scale, window=window,
                           cap=cap)


# ---------------------------------------------------------------------------
# GQA mixer
# ---------------------------------------------------------------------------


def _window_for(cfg: ModelConfig, mixer: str) -> int:
    if mixer in ("swa", "mla_swa"):
        return cfg.sliding_window
    return cfg.attn_window_override  # 0 unless long-context SWA variant


def _qkv(p, x, cfg: ModelConfig):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def gqa_forward(p, x, positions, cfg: ModelConfig, mixer: str, *,
                impl="dense"):
    q, k, v = _qkv(p, x, cfg)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = attention(
        q, k, v, positions, positions,
        scale=1.0 / np.sqrt(cfg.head_dim),
        window=_window_for(cfg, mixer),
        cap=cfg.attn_softcap,
        impl=impl,
    )
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), {"k": k, "v": v}


def gqa_decode(p, x, pos, cache, cfg: ModelConfig, mixer: str, *,
               impl="dense"):
    """x (B,1,D); pos (B,) int current position; cache dict k/v
    (B,Smax,KV,hd).

    Unlike JAX, the cache is updated in place (no second copy of the
    working cache per step) and returned.  When the new K/V have a wider
    dtype than the cache, the cache is widened first, as JAX's one-hot
    blend (``_cache_write``) promotes it."""
    _check_impl(impl)
    if "k_scale" in cache:
        raise NotImplementedError("int8 KV caches are not ported yet "
                                  "(ROADMAP A10)")
    B = x.shape[0]
    q, k, v = _qkv(p, x, cfg)
    q = rope(q, pos[:, None], cfg.rope_theta)
    k = rope(k, pos[:, None], cfg.rope_theta)
    window = _window_for(cfg, mixer)
    s_cache = cache["k"].shape[1]
    ring = bool(window) and s_cache <= window
    if ring and impl == "kernel":
        raise NotImplementedError(
            "the decode kernel reads linear caches; ring caches for sliding-"
            "window slots are not ported to it yet (ROADMAP A10)")
    wpos, k_pos = _ring_positions(pos, s_cache, window, B)
    ck = _cache_write(cache["k"], k, wpos)
    cv = _cache_write(cache["v"], v, wpos)
    scale = 1.0 / np.sqrt(cfg.head_dim)
    if impl == "kernel":
        from repro_torch.kernels import ops as kops
        out = kops.decode_attention(q, ck, cv, pos, scale=scale,
                                    window=window, cap=cfg.attn_softcap)
    else:
        out = dense_attention(q, ck, cv, pos[:, None], k_pos, scale=scale,
                              window=window, cap=cfg.attn_softcap)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), {"k": ck, "v": cv}


def _ring_positions(pos, s_cache: int, window: int, batch: int):
    """Write index + absolute positions held by each cache slot.

    If the cache is window-sized (ring buffer for SWA slots), slot j holds
    absolute position pos - ((pos - j) mod S); unwritten slots come out
    negative and are masked. Otherwise the cache is linear: slot j = pos j."""
    ring = bool(window) and s_cache <= window
    j = torch.arange(s_cache, device=pos.device)[None]
    if ring:
        wpos = pos % s_cache
        k_pos = pos[:, None] - torch.remainder(pos[:, None] - j, s_cache)
    else:
        wpos = pos
        k_pos = j.expand(batch, s_cache)
    return wpos, k_pos


def _cache_write(cache, new, pos):
    """Write new (B,1,...) into cache (B,Smax,...) at per-example pos (B,),
    in place, after widening the cache to the promoted dtype of cache and
    new (a new tensor then), as JAX's one-hot blend does."""
    dt = torch.promote_types(cache.dtype, new.dtype)
    if dt != cache.dtype:
        cache = cache.to(dt)
    b_idx = torch.arange(cache.shape[0], device=cache.device)
    cache[b_idx, pos.long()] = new[:, 0].to(cache.dtype)
    return cache


# ---------------------------------------------------------------------------
# Cache allocation
# ---------------------------------------------------------------------------


def attn_cache_specs(cfg: ModelConfig, mixer: str, layers: int, batch: int,
                     s_max: int, dtype: str = "bfloat16",
                     kv_quant: bool = False):
    """ParamSpec-style descriptors for the per-slot KV cache (stacked layers)."""
    if mixer.startswith("mla"):
        raise NotImplementedError("MLA caches are not ported yet (ROADMAP A11)")
    if kv_quant:
        raise NotImplementedError("int8 KV caches are not ported yet "
                                  "(ROADMAP A10)")
    L = (layers, batch)
    la = ("layers", "batch")
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": ParamSpec(L + (s_max, KV, hd), la + ("kv_seq", None, None),
                       dtype=dtype, init="zeros"),
        "v": ParamSpec(L + (s_max, KV, hd), la + ("kv_seq", None, None),
                       dtype=dtype, init="zeros"),
    }
