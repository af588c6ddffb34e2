"""Attention mixers (the port of ``repro.models.attention``): GQA
(optionally sliding-window / softcapped) and MLA (DeepSeek-V2 multi-head
latent attention), each with a full-sequence path (train / prefill) and
a cached single-token decode (MLA's in the absorbed-latent form).

``impl`` names the attention algorithm:

* ``"dense"``   — the plain reference (:func:`dense_attention`, the model-
  level oracle the JAX package also keeps);
* ``"chunked"`` — :func:`chunked_attention`, the blocked online-softmax
  attention in plain PyTorch (JAX's XLA flash reference);
* ``"auto"``    — the training path's: on the card, fp32 inputs that the
  fp32 flash kernels with a backward take
  (``kernels.flash_attention_train.takes``: no cap, one head dim of 64 or
  128, Sq == Sk) run them at every length; everything else runs
  ``chunked`` when the key length exceeds 2048, else ``dense``, as in JAX
  (every CPU tensor, so the CPU follows JAX's choice);
* ``"kernel"``  — the hand-written CUDA kernels, the counterpart of JAX's
  ``"pallas"``: prefill goes to the flash kernel, decode to the decode
  kernel.  On CPU tensors they run their plain versions.  They have no
  backward (neither have JAX's Pallas kernels), so training uses the other
  three.

MLA runs on the first three: its q/k head dim (``qk_nope + qk_rope``)
differs from v's (``v_head_dim``), and the flash kernel, like JAX's Pallas
kernel, takes one head dim for q, k and v, so ``mla_forward`` refuses
``"kernel"`` with a ``ValueError``.

Shapes: x (B, S, D); caches are per-slot dicts of (B, S_max, KV, hd)
(GQA) or ``ckv`` (B, S_max, kv_lora_rank) and ``k_rope`` (B, S_max,
qk_rope_head_dim) (MLA).  A GQA cache may be int8 (``kv_quant``: per-
(token, head) fp32 scales ``k_scale``/``v_scale`` (B, S_max, KV) beside
the int8 ``k``/``v``); its decode dequantizes into the plain dense
attention, as JAX's does, on every ``impl``.  :func:`gqa_extend` appends
a chunk of C tokens to a linear cache (chunked prefill), in plain
PyTorch, as JAX's runs ``"dense"``.

Decode on ``impl="kernel"`` (B2) reads a cache whose slot j holds
position j: every linear cache, whatever its length.  A sliding-window
slot's cache that is a ring (shorter than the ``s_max`` it was placed
for: the static engine folds its prefill into a ring of ``window`` slots
when ``window < s_max``, and ``cache_specs`` sizes one so) can wrap, and
decodes on ``"dense"``, as JAX decodes every slot: the layout decides,
never a failure (:func:`decode_impl`).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import spmd
from repro_torch.kernels import flash_attention_train as flash_train
from repro_torch.models import spans
from repro_torch.models.common import ParamSpec, rms_norm, rope, softcap

NEG_INF = -2.0e38
IMPLS = ("dense", "chunked", "auto", "kernel")
# "auto" switches to the chunked path above this key length, as JAX does
AUTO_CHUNKED_ABOVE = 2048


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


def mla_specs(cfg: ModelConfig, layers: int) -> Dict[str, ParamSpec]:
    D, H = cfg.d_model, cfg.num_heads
    nope, rdim, vdim = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    qlr, kvlr = cfg.q_lora_rank, cfg.kv_lora_rank
    L = (layers,)
    la = ("layers",)
    return {
        "wq_down": ParamSpec(L + (D, qlr), la + ("embed", "lora")),
        "q_norm": ParamSpec(L + (qlr,), la + ("lora",), init="zeros"),
        "wq_up": ParamSpec(L + (qlr, H, nope + rdim), la + ("lora", "q_heads", None)),
        "wkv_down": ParamSpec(L + (D, kvlr + rdim), la + ("embed", None)),
        "kv_norm": ParamSpec(L + (kvlr,), la + (None,), init="zeros"),
        "wkv_up": ParamSpec(L + (kvlr, H, nope + vdim), la + (None, "q_heads", None)),
        "wo": ParamSpec(L + (H, vdim, D), la + ("q_heads", None, "embed")),
    }


def attn_specs(cfg: ModelConfig, mixer: str, layers: int) -> Dict[str, ParamSpec]:
    return mla_specs(cfg, layers) if mixer.startswith("mla") else gqa_specs(cfg, layers)


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


def chunked_attention(q, k, v, q_pos, k_pos, *, scale, window=0, cap=0.0,
                      kv_block=1024, q_block=2048):
    """Triangular blocked online-softmax attention (JAX's XLA flash
    reference, ``chunked_attention``).

    An outer loop over query blocks, each seeing a static KV prefix (no
    work on fully-masked future blocks; a sliding window also bounds the
    prefix from below), and an inner loop over KV blocks with a running
    (max, denom, acc) in fp32.  Padded query rows carry position -1 and
    padded keys position 2**30, so both are masked.  Live memory is
    O(q_block * kv_block * H)."""
    B, Sq, H, dk = q.shape
    Sk, KV, dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // KV
    q_block = min(q_block, Sq)
    kv_block = min(kv_block, Sk)
    q_pad = -Sq % q_block
    if q_pad:
        q = F.pad(q, (0, 0, 0, 0, 0, q_pad))
        q_pos = F.pad(q_pos, (0, q_pad), value=-1)
    k_pad = -Sk % kv_block
    if k_pad:
        k = F.pad(k, (0, 0, 0, 0, 0, k_pad))
        v = F.pad(v, (0, 0, 0, 0, 0, k_pad))
        k_pos = F.pad(k_pos, (0, k_pad), value=2**30)
    Sk_p = Sk + k_pad

    def one_q_block(qi: int):
        q_lo, q_hi = qi * q_block, (qi + 1) * q_block
        qg = q[:, q_lo:q_hi].reshape(B, q_block, KV, G, dk) * scale
        qp = q_pos[:, q_lo:q_hi]
        # static KV range this q block can see (positions are monotone:
        # q_pos = offset + arange on the train and prefill paths)
        kv_hi = min(-(-q_hi // kv_block) * kv_block, Sk_p)
        kv_lo = 0
        if window:
            kv_lo = max(0, (q_lo - window) // kv_block * kv_block)
        m_run = torch.full((B, KV, G, q_block), NEG_INF, dtype=torch.float32,
                           device=q.device)
        l_run = torch.zeros((B, KV, G, q_block), dtype=torch.float32,
                            device=q.device)
        acc = torch.zeros((B, KV, G, q_block, dv), dtype=torch.float32,
                          device=q.device)
        for lo in range(kv_lo, kv_hi, kv_block):
            kc, vc = k[:, lo:lo + kv_block], v[:, lo:lo + kv_block]
            pc = k_pos[:, lo:lo + kv_block]
            logits = torch.einsum("bqkgd,bskd->bkgqs", qg, kc).float()
            logits = softcap(logits, cap)
            msk = _mask(qp, pc, window)[:, None, None]
            logits = logits.masked_fill(~msk, NEG_INF)
            m_new = torch.maximum(m_run, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p.to(vc.dtype), vc).float()
            m_run = m_new
        out = acc / torch.clamp(l_run, min=1e-30)[..., None]
        return out.permute(0, 3, 1, 2, 4).reshape(B, q_block, H, dv)

    blocks = [one_q_block(i) for i in range((Sq + q_pad) // q_block)]
    out = torch.cat(blocks, dim=1) if len(blocks) > 1 else blocks[0]
    return out[:, :Sq].to(v.dtype)


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"attn impl must be one of {IMPLS}, got {impl!r}")


def attention(q, k, v, q_pos, k_pos, *, scale, window=0, cap=0.0,
              impl="dense", kv_block=1024, q_block=2048):
    """Full-sequence attention, inside the span ``attn/core``
    (``models/spans.py``; its backward holds the gradients of q, k and v).
    ``impl="kernel"`` takes no positions: the flash kernel is causal from
    position 0, which holds for whole-prompt prefill, the only caller."""
    _check_impl(impl)
    return spans.layer(
        "attn/core",
        lambda q, k, v: _attention(q, k, v, q_pos, k_pos, scale=scale,
                                   window=window, cap=cap, impl=impl,
                                   kv_block=kv_block, q_block=q_block),
        q, k, v)


def _attention(q, k, v, q_pos, k_pos, *, scale, window, cap, impl,
               kv_block, q_block):
    if impl == "kernel":
        from repro_torch.kernels import ops as kops
        return kops.flash_attention(q, k, v, scale=scale, window=window,
                                    cap=cap)
    if impl == "auto":
        if flash_train.takes(q, k, v, cap):
            return flash_train.flash_attention_train(
                q, k, v, q_pos, k_pos, scale=scale, window=window)
        impl = "chunked" if k.shape[1] > AUTO_CHUNKED_ABOVE else "dense"
    if impl == "chunked":
        return chunked_attention(q, k, v, q_pos, k_pos, scale=scale,
                                 window=window, cap=cap, kv_block=kv_block,
                                 q_block=q_block)
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


def _qkv_at(p, x, positions, cfg: ModelConfig):
    """q, k, v of x (B,S,D) with rope at ``positions`` (B,S)."""
    q, k, v = _qkv(p, x, cfg)
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def local_kv(k, v, cfg: ModelConfig, head_offset: int, h_loc: int):
    """The kv heads that q heads ``head_offset .. + h_loc`` read, for a
    rank that holds those q heads and every kv head: q head h uses kv head
    h // (H / KV).  Returns (k, v) whose head grouping matches the local q
    heads (a slice where the groups line up, else one kv head per q
    head)."""
    H, KV = cfg.num_heads, cfg.num_kv_heads
    if h_loc == H:
        return k, v
    G = H // KV
    lo = head_offset // G
    if head_offset % G == 0 and h_loc % G == 0:
        n = h_loc // G
    elif G % h_loc == 0 and head_offset // G == (head_offset + h_loc - 1) // G:
        n = 1
    else:
        idx = (head_offset + torch.arange(h_loc, device=k.device)) // G
        return k.index_select(2, idx), v.index_select(2, idx)
    return k[:, :, lo:lo + n], v[:, :, lo:lo + n]


def gqa_forward(p, x, positions, cfg: ModelConfig, mixer: str, *,
                impl="dense", kv_block=1024, q_block=2048, head_offset=0):
    """``head_offset``: the first q head a rank holds where ``p["wq"]``
    holds a slice of the heads (the caches keep every kv head)."""
    q, k, v = _qkv_at(p, x, positions, cfg)
    ka, va = local_kv(k, v, cfg, head_offset, q.shape[2])
    out = attention(
        q, ka, va, positions, positions,
        scale=1.0 / np.sqrt(cfg.head_dim),
        window=_window_for(cfg, mixer),
        cap=cfg.attn_softcap,
        impl=impl, kv_block=kv_block, q_block=q_block,
    )
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), {"k": k, "v": v}


def decode_impl(impl: str, s_cache: int, window: int,
                s_max: Optional[int]) -> str:
    """The algorithm a GQA decode runs: ``"dense"`` in place of
    ``"kernel"`` for a sliding-window slot whose cache is a ring, else
    ``impl``.  A cache shorter than the ``s_max`` it was placed for is a
    ring (``window < s_max``): it can wrap, and B2 reads slot j as
    position j.  A cache ``s_max`` long is linear, even one exactly as
    long as the window (``s_max == window``).  With ``s_max`` unknown
    (None) a cache as long as the window is either, and ``"kernel"``
    refuses it (``ValueError``) rather than guess."""
    if impl != "kernel" or not window:
        return impl
    if s_max is None:
        if s_cache == window:
            raise ValueError(
                f"a sliding-window cache of {s_cache} slots (the window) "
                "is a ring when placed for s_max > window and linear when "
                "s_max == window; pass s_max to decode on 'kernel'")
        return impl
    return "dense" if s_cache < s_max else impl


def quantize_kv(x):
    """Per-(token, head) int8 quantization, JAX's: x (B,1,KV,hd) -> (int8
    values, fp32 scales (B,1,KV)), scale ``max|x| / 127 + 1e-8``, values
    rounded half to even and clipped to +-127."""
    xf = x.float()
    s = xf.abs().amax(dim=-1) / 127.0 + 1e-8
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def dequantize_kv(q, s, dtype):
    return (q.float() * s[..., None].float()).to(dtype)


def gqa_decode(p, x, pos, cache, cfg: ModelConfig, mixer: str, *,
               impl="dense", s_max: Optional[int] = None):
    """x (B,1,D); pos (B,) int current position; cache dict k/v
    (B,Smax,KV,hd), int8 with ``k_scale``/``v_scale`` (B,Smax,KV) when
    quantized.

    Unlike JAX, the cache is updated in place (no second copy of the
    working cache per step) and returned.  When the new K/V have a wider
    dtype than a bf16 or fp32 cache, the cache is widened first, as JAX's
    one-hot blend (``_cache_write``) promotes it; an int8 cache and its
    scales keep their dtypes (JAX's scatter write).  ``impl`` is resolved
    by :func:`decode_impl` from the cache's length and ``s_max``, the
    length the caches were placed for; a quantized cache decodes on
    ``"dense"``."""
    _check_impl(impl)
    B = x.shape[0]
    q, k, v = _qkv_at(p, x, pos[:, None], cfg)
    window = _window_for(cfg, mixer)
    s_cache = cache["k"].shape[1]
    wpos, k_pos = _ring_positions(pos, s_cache, window, B)
    scale = 1.0 / np.sqrt(cfg.head_dim)
    if "k_scale" in cache:
        new = {}
        for name, val in (("k", k), ("v", v)):
            vq, vs = quantize_kv(val)
            new[name] = _cache_write(cache[name], vq, wpos)
            new[f"{name}_scale"] = _cache_write(cache[f"{name}_scale"], vs,
                                                wpos)
        out = dense_attention(
            q, dequantize_kv(new["k"], new["k_scale"], x.dtype),
            dequantize_kv(new["v"], new["v_scale"], x.dtype), pos[:, None],
            k_pos, scale=scale, window=window, cap=cfg.attn_softcap)
        return torch.einsum("bshk,hkd->bsd", out, p["wo"]), new
    ck = _cache_write(cache["k"], k, wpos)
    cv = _cache_write(cache["v"], v, wpos)
    if decode_impl(impl, s_cache, window, s_max) == "kernel":
        from repro_torch.kernels import ops as kops
        out = kops.decode_attention(q, ck, cv, pos, scale=scale,
                                    window=window, cap=cfg.attn_softcap)
    else:
        out = dense_attention(q, ck, cv, pos[:, None], k_pos, scale=scale,
                              window=window, cap=cfg.attn_softcap)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), {"k": ck, "v": cv}


def gqa_extend(p, x, pos0, cache, cfg: ModelConfig, mixer: str):
    """Chunked-prefill extension (JAX's ``gqa_extend``): append a chunk of
    C tokens to a *linear* cache.  x (B,C,D); pos0 (B,) absolute position
    of the chunk's first token; cache dict k/v (B,Smax,KV,hd), written in
    place at positions pos0 .. pos0 + C - 1 (:func:`_cache_write_chunk`).
    The chunk attends causally to the cache, which holds every earlier
    position at its own slot, plus itself, in plain PyTorch
    (``dense_attention``), as JAX's does."""
    B, C = x.shape[:2]
    positions = pos0[:, None] + torch.arange(C, device=x.device)[None]
    q, k, v = _qkv_at(p, x, positions, cfg)
    ck = _cache_write_chunk(cache["k"], k, positions)
    cv = _cache_write_chunk(cache["v"], v, positions)
    s_cache = ck.shape[1]
    k_pos = torch.arange(s_cache, device=x.device)[None].expand(B, s_cache)
    # a cache narrower than the compute dtype (bf16 under fp32) is read as
    # JAX promotes it: q.k in the wider dtype, the softmax cast to v's
    dt = torch.promote_types(q.dtype, ck.dtype)
    out = dense_attention(q.to(dt), ck.to(dt), cv, positions, k_pos,
                          scale=1.0 / np.sqrt(cfg.head_dim),
                          window=_window_for(cfg, mixer),
                          cap=cfg.attn_softcap)
    return (torch.einsum("bshk,hkd->bsd", out.to(dt), p["wo"]),
            {"k": ck, "v": cv})


def _cache_write_chunk(cache, new, positions):
    """Write new (B,C,...) into cache (B,Smax,...) at per-example positions
    (B,C), in place, in the cache's dtype (JAX's ``.at[].set``).  Rows at
    positions past the cache are dropped, as JAX's ``.at[].set`` drops
    them: the pad rows of a prompt's last chunk land there when the chunk
    runs past ``s_max`` (the scheduler keeps every real token within
    it)."""
    keep = positions < cache.shape[1]
    b_idx = torch.arange(cache.shape[0], device=cache.device)[:, None]
    cache[b_idx.expand_as(positions)[keep], positions[keep].long()] = \
        new[keep].to(cache.dtype)
    return cache


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
    in place, after widening a floating cache to the promoted dtype of
    cache and new (a new tensor then), as JAX's one-hot blend does; an
    int8 cache keeps its dtype (JAX's scatter write)."""
    dt = torch.promote_types(cache.dtype, new.dtype)
    if dt != cache.dtype and cache.is_floating_point():
        cache = cache.to(dt)
    b_idx = torch.arange(cache.shape[0], device=cache.device)
    cache[b_idx, pos.long()] = new[:, 0].to(cache.dtype)
    return cache


# ---------------------------------------------------------------------------
# MLA mixer
# ---------------------------------------------------------------------------


def _mla_qkv(p, x, positions, cfg: ModelConfig):
    nope = cfg.qk_nope_head_dim
    cq = rms_norm(x @ p["wq_down"], p["q_norm"], cfg.norm_eps)
    q = torch.einsum("bsl,lhk->bshk", cq, p["wq_up"])
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)

    ckv_full = x @ p["wkv_down"]  # (B,S,kvlr+rdim)
    kvlr = cfg.kv_lora_rank
    ckv, k_rope = ckv_full[..., :kvlr], ckv_full[..., kvlr:]
    ckv = rms_norm(ckv, p["kv_norm"], cfg.norm_eps)
    # one shared rope head: rope takes (..., S, H, D), so add H = 1
    k_rope = rope(k_rope[..., None, :], positions, cfg.rope_theta)[..., 0, :]
    return q_nope, q_rope, ckv, k_rope


def _mla_scale(cfg: ModelConfig) -> float:
    """1/sqrt of the q/k head dim, ``qk_nope + qk_rope`` (not head_dim)."""
    return 1.0 / np.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def _check_mla_impl(cfg: ModelConfig, impl: str) -> None:
    _check_impl(impl)
    if impl == "kernel":
        raise ValueError(
            "MLA has no kernel path: its q/k head dim (qk_nope + qk_rope = "
            f"{cfg.qk_nope_head_dim + cfg.qk_rope_head_dim}) differs from v's "
            f"({cfg.v_head_dim}), and the flash kernel (B1), like JAX's "
            "Pallas kernel, takes one head dim for q, k and v; use dense, "
            "chunked or auto")


def mla_forward(p, x, positions, cfg: ModelConfig, mixer: str, *,
                impl="dense", kv_block=1024, q_block=2048):
    """Full-sequence MLA: per-head K/V reconstructed from the latent
    (train / prefill).  Returns (out, {"ckv", "k_rope"})."""
    _check_mla_impl(cfg, impl)
    nope = cfg.qk_nope_head_dim
    q_nope, q_rope, ckv, k_rope = _mla_qkv(p, x, positions, cfg)
    kv = torch.einsum("bsl,lhk->bshk", ckv, p["wkv_up"])
    k_nope, v = kv[..., :nope], kv[..., nope:]
    k = torch.cat([k_nope, k_rope[:, :, None].expand(
        k_nope.shape[:3] + (q_rope.shape[-1],))], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = attention(
        q, k, v, positions, positions,
        scale=_mla_scale(cfg),
        window=_window_for(cfg, mixer),
        cap=cfg.attn_softcap,
        impl=impl, kv_block=kv_block, q_block=q_block,
    )
    return (torch.einsum("bshv,hvd->bsd", out, p["wo"]),
            {"ckv": ckv, "k_rope": k_rope})


def mla_decode(p, x, pos, cache, cfg: ModelConfig, mixer: str, *,
               impl="dense"):
    """Absorbed-latent decode: attend in the compressed kv_lora space (no
    kernel carries it: ``impl="kernel"`` raises, as in the forward).
    cache: ckv (B,Smax,kvlr), k_rope (B,Smax,rdim), written in place at
    ``pos`` (widened first where the new entries are wider, as
    :func:`gqa_decode`).  Logits in fp32 with the softcap and the mask;
    the softmax is cast to the cache dtype."""
    _check_mla_impl(cfg, impl)
    nope = cfg.qk_nope_head_dim
    B = x.shape[0]
    q_nope, q_rope, ckv_new, k_rope_new = _mla_qkv(p, x, pos[:, None], cfg)
    window = _window_for(cfg, mixer)
    wpos, k_pos = _ring_positions(pos, cache["ckv"].shape[1], window, B)
    ckv = _cache_write(cache["ckv"], ckv_new, wpos)
    krope = _cache_write(cache["k_rope"], k_rope_new, wpos)

    w_uk = p["wkv_up"][..., :nope]  # (kvlr, H, nope)
    w_uv = p["wkv_up"][..., nope:]  # (kvlr, H, vdim)
    q_abs = torch.einsum("bshn,lhn->bshl", q_nope, w_uk)  # absorbed query
    logits = (
        torch.einsum("bshl,bkl->bhsk", q_abs, ckv)
        + torch.einsum("bshr,bkr->bhsk", q_rope, krope)
    ).float() * _mla_scale(cfg)
    logits = softcap(logits, cfg.attn_softcap)
    m = _mask(pos[:, None], k_pos, window)[:, None]
    logits = logits.masked_fill(~m, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(ckv.dtype)
    ctx = torch.einsum("bhsk,bkl->bshl", probs, ckv)  # latent context
    out = torch.einsum("bshl,lhv->bshv", ctx, w_uv)
    return (torch.einsum("bshv,hvd->bsd", out, p["wo"]),
            {"ckv": ckv, "k_rope": krope})


# ---------------------------------------------------------------------------
# Decode over sequence-sharded caches (one rank of a mesh)
# ---------------------------------------------------------------------------


def _seq_shard(ctx, s_loc: int):
    """(group, first global slot, global length) of this rank's ``kv_seq``
    slice of ``s_loc`` slots."""
    axes = ctx.rules["kv_seq"]
    n = ctx.size(axes)
    return ctx.group(axes), ctx.index(axes) * s_loc, s_loc * n


def _ring_positions_at(pos, s_glob: int, window: int, lo: int, s_loc: int):
    """:func:`_ring_positions` for global slots ``lo .. lo + s_loc``."""
    ring = bool(window) and s_glob <= window
    j = (lo + torch.arange(s_loc, device=pos.device))[None]
    if ring:
        return pos % s_glob, pos[:, None] - torch.remainder(pos[:, None] - j,
                                                            s_glob)
    return pos, j.expand(pos.shape[0], s_loc)


def _owned_write(cache, new, wpos, lo: int):
    """:func:`_cache_write` of global slot ``wpos`` into a slice that holds
    slots ``lo .. lo + S_loc``: only the rank that owns a row's slot
    writes it (the others rewrite what they hold)."""
    dt = torch.promote_types(cache.dtype, new.dtype)
    if dt != cache.dtype and cache.is_floating_point():
        cache = cache.to(dt)
    s_loc = cache.shape[1]
    local = wpos.long() - lo
    own = (local >= 0) & (local < s_loc)
    li = local.clamp(0, s_loc - 1)
    b_idx = torch.arange(cache.shape[0], device=cache.device)
    val = new[:, 0].to(cache.dtype)
    own = own.reshape((-1,) + (1,) * (val.dim() - 1))
    cache[b_idx, li] = torch.where(own, val, cache[b_idx, li])
    return cache


def _combine(m, lsum, acc, ctx, s_group, heads_sharded: bool):
    """Join every sequence shard's partial softmax (B, 1, H) max and sum
    and (B, 1, H, d) unnormalised values, as B2's split-K combine joins
    its blocks: rescale to the group's max, then sum.  With the heads
    split over ``model`` and the sequence over ``model`` alone the sum is
    a reduce-scatter onto this rank's heads; otherwise an all-reduce over
    the sequence's group and this rank's heads.  Returns the normalised
    (B, 1, H_loc, d) fp32 output."""
    g_model = ctx.group("model")
    big = spmd.all_reduce_max(m, s_group)
    corr = torch.exp(m - big)
    packed = torch.cat([acc * corr[..., None], (lsum * corr)[..., None]],
                       dim=-1)
    if heads_sharded and ctx.axes(ctx.rules["kv_seq"]) == ("model",):
        packed = spmd.scatter_dim(packed, g_model, 2)
    else:
        packed = spmd.reduce_from(packed, s_group)
        if heads_sharded:
            packed = spmd.local_chunk(packed, g_model, 2)
    return packed[..., :-1] / packed[..., -1:]


def gqa_decode_sharded(p, x, pos, cache, cfg: ModelConfig, mixer: str, ctx):
    """:func:`gqa_decode` as one rank of ``ctx``: x (B, 1, D) replicated
    over ``model``, q heads (and ``wq``/``wo``) split over it where the
    rules split them, the caches (B, S/n, KV, hd) this rank's ``kv_seq``
    slice (n = ``model``, or data x model when the batch cannot cover the
    data axes).

    The q heads meet the sequence shards so: the step's q is all-gathered
    over heads (every rank holds every kv head of its positions), each
    rank runs a partial softmax over its slice for every head, and the
    shards combine (:func:`_combine`) into this rank's heads for the
    row-parallel ``wo``, whose output is all-reduced.  Only the rank that
    owns ``pos`` writes it.  Plain PyTorch (the dry run's ``"dense"``);
    int8 caches are dequantized per slice."""
    g_model = ctx.group("model")
    q, k, v = _qkv_at(p, x, pos[:, None], cfg)
    heads_sharded = q.shape[2] != cfg.num_heads
    if heads_sharded:
        q = spmd.gather_dim(q, g_model, 2)
    window = _window_for(cfg, mixer)
    s_group, lo, s_glob = _seq_shard(ctx, cache["k"].shape[1])
    wpos, k_pos = _ring_positions_at(pos, s_glob, window, lo,
                                     cache["k"].shape[1])
    if "k_scale" in cache:
        new = {}
        for name, val in (("k", k), ("v", v)):
            vq, vs = quantize_kv(val)
            new[name] = _owned_write(cache[name], vq, wpos, lo)
            new[f"{name}_scale"] = _owned_write(cache[f"{name}_scale"], vs,
                                                wpos, lo)
        ck = dequantize_kv(new["k"], new["k_scale"], x.dtype)
        cv = dequantize_kv(new["v"], new["v_scale"], x.dtype)
    else:
        new = {"k": _owned_write(cache["k"], k, wpos, lo),
               "v": _owned_write(cache["v"], v, wpos, lo)}
        ck, cv = new["k"], new["v"]
    B, _, H, dk = q.shape
    KV = ck.shape[2]
    qg = q.reshape(B, 1, KV, H // KV, dk)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, ck).float() \
        * (1.0 / np.sqrt(cfg.head_dim))
    logits = softcap(logits, cfg.attn_softcap)
    msk = _mask(pos[:, None], k_pos, window)[:, None, None]
    logits = logits.masked_fill(~msk, NEG_INF)
    m = logits.amax(dim=-1)  # (B, KV, G, 1)
    pexp = torch.exp(logits - m[..., None])
    acc = torch.einsum("bkgqs,bskd->bqkgd", pexp.to(cv.dtype), cv).float()
    out = _combine(m.permute(0, 3, 1, 2).reshape(B, 1, H),
                   pexp.sum(dim=-1).permute(0, 3, 1, 2).reshape(B, 1, H),
                   acc.reshape(B, 1, H, cv.shape[-1]), ctx, s_group,
                   heads_sharded)
    y = torch.einsum("bshk,hkd->bsd", out.to(cv.dtype), p["wo"])
    if heads_sharded:
        y = spmd.reduce_from(y, g_model)
    return y, new


def mla_decode_sharded(p, x, pos, cache, cfg: ModelConfig, mixer: str, ctx):
    """:func:`mla_decode` as one rank of ``ctx``, over ``ckv``/``k_rope``
    slices of the sequence: the absorbed query (and its rope part) is
    all-gathered over heads, each rank attends in the latent space over
    its slice, and the shards combine (:func:`_combine`) into this rank's
    heads' latent context for ``w_uv`` and the row-parallel ``wo``."""
    g_model = ctx.group("model")
    nope = cfg.qk_nope_head_dim
    q_nope, q_rope, ckv_new, k_rope_new = _mla_qkv(p, x, pos[:, None], cfg)
    heads_sharded = q_nope.shape[2] != cfg.num_heads
    w_uk = p["wkv_up"][..., :nope]
    w_uv = p["wkv_up"][..., nope:]
    q_abs = torch.einsum("bshn,lhn->bshl", q_nope, w_uk)
    if heads_sharded:
        q_abs = spmd.gather_dim(q_abs, g_model, 2)
        q_rope = spmd.gather_dim(q_rope, g_model, 2)
    window = _window_for(cfg, mixer)
    s_group, lo, s_glob = _seq_shard(ctx, cache["ckv"].shape[1])
    wpos, k_pos = _ring_positions_at(pos, s_glob, window, lo,
                                     cache["ckv"].shape[1])
    ckv = _owned_write(cache["ckv"], ckv_new, wpos, lo)
    krope = _owned_write(cache["k_rope"], k_rope_new, wpos, lo)
    logits = (
        torch.einsum("bshl,bkl->bhsk", q_abs, ckv)
        + torch.einsum("bshr,bkr->bhsk", q_rope, krope)
    ).float() * _mla_scale(cfg)
    logits = softcap(logits, cfg.attn_softcap)
    logits = logits.masked_fill(~_mask(pos[:, None], k_pos, window)[:, None],
                                NEG_INF)
    m = logits.amax(dim=-1)  # (B, H, 1)
    pexp = torch.exp(logits - m[..., None])
    lat = torch.einsum("bhsk,bkl->bshl", pexp.to(ckv.dtype), ckv).float()
    ctxv = _combine(m.transpose(1, 2), pexp.sum(dim=-1).transpose(1, 2), lat,
                    ctx, s_group, heads_sharded)
    out = torch.einsum("bshl,lhv->bshv", ctxv.to(ckv.dtype), w_uv)
    y = torch.einsum("bshv,hvd->bsd", out, p["wo"])
    if heads_sharded:
        y = spmd.reduce_from(y, g_model)
    return y, {"ckv": ckv, "k_rope": krope}


# ---------------------------------------------------------------------------
# Cache allocation
# ---------------------------------------------------------------------------


def attn_cache_specs(cfg: ModelConfig, mixer: str, layers: int, batch: int,
                     s_max: int, dtype: str = "bfloat16",
                     kv_quant: bool = False):
    """ParamSpec-style descriptors for the per-slot KV cache (stacked
    layers): GQA's k/v (``kv_quant``: int8 values and per-(token, head)
    fp32 scales), or MLA's latent ``ckv`` and shared ``k_rope``."""
    L = (layers, batch)
    la = ("layers", "batch")
    if mixer.startswith("mla"):
        return {
            "ckv": ParamSpec(L + (s_max, cfg.kv_lora_rank), la + ("kv_seq", None),
                             dtype=dtype, init="zeros"),
            "k_rope": ParamSpec(L + (s_max, cfg.qk_rope_head_dim),
                                la + ("kv_seq", None), dtype=dtype, init="zeros"),
        }
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    vdt = "int8" if kv_quant else dtype
    specs = {
        "k": ParamSpec(L + (s_max, KV, hd), la + ("kv_seq", None, None),
                       dtype=vdt, init="zeros"),
        "v": ParamSpec(L + (s_max, KV, hd), la + ("kv_seq", None, None),
                       dtype=vdt, init="zeros"),
    }
    if kv_quant:
        specs["k_scale"] = ParamSpec(L + (s_max, KV), la + ("kv_seq", None),
                                     dtype="float32", init="zeros")
        specs["v_scale"] = ParamSpec(L + (s_max, KV), la + ("kv_seq", None),
                                     dtype="float32", init="zeros")
    return specs
