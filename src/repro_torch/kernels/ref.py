"""Plain PyTorch versions of the hand-written kernels, in kernel layout.

Each computes the same function as its kernel, in fp32, with the same
masks and conventions: masked scores are ``NEG_INF = -2e38`` (not -inf),
the softmax denominator is clamped to ``1e-30``, the result is cast to
q's dtype.  The kernel wrappers run these for CPU tensors; the tests hold
them to the JAX package's Pallas kernels, and ``chip_smoke.py`` holds the
CUDA kernels to them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import softcap

NEG_INF = -2.0e38


def _softmax_pv(s, mask, v):
    """Masked running-softmax result in one pass: acc / max(l, 1e-30)."""
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    return torch.matmul(p, v) / torch.clamp_min(l, 1e-30)


def flash_attention_ref(q, k, v, *, scale, window=0, cap=0.0):
    """q (B,H,Sq,D), k/v (B,KV,Sk,D) -> (B,H,Sq,D); causal from position 0."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, KV, G, Sq, D)
    kf = k.float()[:, :, None]  # (B,KV,1,Sk,D)
    vf = v.float()[:, :, None]
    s = softcap(torch.matmul(qf, kf.transpose(-1, -2)) * scale, cap)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None]
    mask = kpos <= qpos
    if window:
        mask = mask & ((qpos - kpos) < window)
    out = _softmax_pv(s, mask, vf)
    return out.reshape(B, H, Sq, D).to(q.dtype)


def decode_attention_ref(q, k, v, pos, *, scale, window=0, cap=0.0):
    """q (B,H,D), k/v (B,KV,S,D), pos (B,) -> (B,H,D)."""
    B, H, D = q.shape
    KV, S = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, KV, G, 1, D)
    kf = k.float()[:, :, None]  # (B,KV,1,S,D)
    vf = v.float()[:, :, None]
    s = softcap(torch.matmul(qf, kf.transpose(-1, -2)) * scale, cap)  # (B,KV,G,1,S)
    p = pos.to(torch.int64).view(B, 1, 1, 1, 1)
    kpos = torch.arange(S, device=q.device)
    mask = kpos <= p
    if window:
        mask = mask & ((p - kpos) < window)
    out = _softmax_pv(s, mask, vf)
    return out.reshape(B, H, D).to(q.dtype)
