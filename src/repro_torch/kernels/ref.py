"""Plain PyTorch versions of the hand-written kernels, in kernel layout.

Each computes the same function as its kernel, in fp32, with the same
masks and conventions.  Attention: masked scores are ``NEG_INF = -2e38``
(not -inf), the softmax denominator is clamped to ``1e-30``, the result is
cast to q's dtype.  SSD scan: fp32 cumsum and state, y cast to x's dtype,
the final state kept in fp32.  The kernel wrappers run these for CPU
tensors; the tests hold them to the JAX package's Pallas kernels, and
``chip_smoke.py`` holds the CUDA kernels to them on the card.
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


def decode_attention_split_ref(q, k, v, pos, *, scale, splits, tiles,
                               window=0, cap=0.0, tile=64):
    """:func:`decode_attention_ref` computed as the split-K kernel computes
    it: split s takes the keys of the ``tile``-key tiles [s * tiles,
    (s + 1) * tiles) and keeps an unnormalised partial (acc_s, m_s, l_s);
    a split with no key of its row keeps (0, NEG_INF, 0).  The partials are
    combined as M = max_s m_s, out = sum_s e^(m_s - M) acc_s /
    max(sum_s e^(m_s - M) l_s, 1e-30).  For the tests only: the kernel
    wrappers never call it."""
    B, H, D = q.shape
    KV, S = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, KV, G, 1, D)
    kf = k.float()[:, :, None]  # (B,KV,1,S,D)
    vf = v.float()[:, :, None]
    s = softcap(torch.matmul(qf, kf.transpose(-1, -2)) * scale, cap)  # (B,KV,G,1,S)
    p = pos.to(torch.int64).view(B, 1, 1, 1, 1)
    kpos = torch.arange(S, device=q.device)
    mask = (kpos <= p).expand(s.shape)
    if window:
        mask = mask & ((p - kpos) < window)
    s = s.masked_fill(~mask, NEG_INF)
    accs, ms, ls = [], [], []
    for i in range(splits):
        lo, hi = i * tiles * tile, min(S, (i + 1) * tiles * tile)
        si, vi = s[..., lo:hi], vf[..., lo:hi, :]
        m = si.amax(dim=-1, keepdim=True)
        e = torch.exp(si - m)
        seen = mask[..., lo:hi].any(dim=-1, keepdim=True)
        accs.append(torch.where(seen, torch.matmul(e, vi), 0.0))
        ms.append(torch.where(seen, m, NEG_INF))
        ls.append(torch.where(seen, e.sum(dim=-1, keepdim=True), 0.0))
    m_all = torch.stack(ms)
    w = torch.exp(m_all - m_all.amax(dim=0))
    out = (w * torch.stack(accs)).sum(dim=0) / torch.clamp_min(
        (w * torch.stack(ls)).sum(dim=0), 1e-30)
    return out.reshape(B, H, D).to(q.dtype)


def paged_decode_attention_ref(q, k_pool, v_pool, table, pos, *, scale,
                               window=0, cap=0.0):
    """q (B,H,D), pools (N,KV,bs,D), table (B,nb), pos (B,) -> (B,H,D):
    :func:`decode_attention_ref` on the linear caches gathered through the
    table (the JAX package's ``gather_ref`` tuning variant).  Every table
    entry is read."""
    def gather(pool):  # (N,KV,bs,D) -> (B,nb,bs,KV,D) -> (B,KV,nb*bs,D)
        g = pool.transpose(1, 2)[table.long()]
        return g.reshape(g.shape[0], -1, *g.shape[3:]).transpose(1, 2)

    return decode_attention_ref(q, gather(k_pool), gather(v_pool), pos,
                                scale=scale, window=window, cap=cap)


def ssd_scan_ref(x, dt, a_neg, b, c, *, chunk=256):
    """Mamba-2 SSD chunked scan, the function of the Pallas body
    ``repro/kernels/ssd_scan.py::_kernel``: x (B,H,L,P), dt (B,H,L),
    a_neg (H,), b/c (B,L,N) -> y (B,H,L,P) in x's dtype, h_final
    (B,H,N,P) fp32.  ``L % min(chunk, L) == 0``.

    The body's steps, chunk by chunk for every (batch, head) at once, on
    the inputs cast to fp32: the cumsum of dt * a, the intra-chunk term
    ``(C Bᵀ ∘ L ∘ dt) x``, the carried state's term ``C h · exp(cl)`` and
    the state update.  The causal mask is applied before the ``exp`` (the
    Pallas body exponentiates first, which gives ``inf`` above the
    diagonal)."""
    B, H, L, P = x.shape
    N = b.shape[-1]
    Q = min(chunk, L)
    if L % Q:
        raise ValueError(f"ssd_scan_ref: L={L} is not a multiple of chunk {Q}")
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    a = a_neg.float()[None, :, None]  # (1,H,1)
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for s in range(0, L, Q):
        xc = xf[:, :, s:s + Q]  # (B,H,Q,P)
        dtc = dtf[:, :, s:s + Q]  # (B,H,Q)
        bc = bf[:, None, s:s + Q]  # (B,1,Q,N)
        cc = cf[:, None, s:s + Q]
        cl = torch.cumsum(dtc * a, dim=-1)  # (B,H,Q)
        diff = cl[..., :, None] - cl[..., None, :]  # (B,H,Q(i),Q(j))
        lmat = torch.exp(diff.masked_fill(~causal, float("-inf")))
        w = torch.matmul(cc, bc.transpose(-1, -2)) * lmat * dtc[..., None, :]
        y = torch.matmul(w, xc) + torch.matmul(cc, h) * torch.exp(cl)[..., None]
        ys.append(y)
        decay_end = torch.exp(cl[..., -1:] - cl) * dtc  # (B,H,Q)
        h = h * torch.exp(cl[..., -1])[..., None, None] + torch.matmul(
            bc.transpose(-1, -2), xc * decay_end[..., None])
    return torch.cat(ys, dim=2).to(x.dtype), h


# The SSD scan as the CUDA kernel decomposes it (csrc/ssd_scan.cu): three
# passes over the same function as ssd_scan_ref, in fp32.  For the tests
# only: the kernel wrappers never call them.


def ssd_chunk_states_ref(x, dt, a_neg, b, *, chunk):
    """Pass 1: each chunk's own state S_c = Bᵀ (s ∘ x), s_j = exp(cl_last -
    cl_j) dt_j, and its cl_last.  x (B,H,L,P), dt (B,H,L), b (B,L,N) ->
    states (B,nc,H,N,P), cl_last (B,nc,H), fp32."""
    B, H, L, P = x.shape
    Q = min(chunk, L)
    nc = L // Q
    xf = x.float().reshape(B, H, nc, Q, P)
    dtf = dt.float().reshape(B, H, nc, Q)
    bf = b.float().reshape(B, nc, Q, -1)
    cl = torch.cumsum(dtf * a_neg.float()[None, :, None, None], dim=-1)
    s = torch.exp(cl[..., -1:] - cl) * dtf  # (B,H,nc,Q)
    states = torch.einsum("bcjn,bhcjp->bchnp", bf, xf * s[..., None])
    return states, cl[..., -1].transpose(1, 2).contiguous()


def ssd_state_pass_ref(states, cl_last):
    """Pass 2: h <- h exp(cl_last) + S_c over the chunks in order, from
    h = 0.  Returns each chunk's starting state (B,nc,H,N,P) and the final
    state (B,H,N,P)."""
    h = torch.zeros_like(states[:, 0])
    starts = []
    for ci in range(states.shape[1]):
        starts.append(h)
        h = h * torch.exp(cl_last[:, ci])[..., None, None] + states[:, ci]
    return torch.stack(starts, dim=1), h


def ssd_output_ref(x, dt, a_neg, b, c, starts, *, chunk):
    """Pass 3: y = (C Bᵀ ∘ L ∘ dt) x + exp(cl_i) C_i h_start per chunk, in
    x's dtype; the mask is applied before the exp."""
    B, H, L, P = x.shape
    Q = min(chunk, L)
    nc = L // Q
    xf = x.float().reshape(B, H, nc, Q, P)
    dtf = dt.float().reshape(B, H, nc, Q)
    bf = b.float().reshape(B, 1, nc, Q, -1)
    cf = c.float().reshape(B, 1, nc, Q, -1)
    cl = torch.cumsum(dtf * a_neg.float()[None, :, None, None], dim=-1)
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    diff = (cl[..., :, None] - cl[..., None, :]).masked_fill(~causal,
                                                            float("-inf"))
    w = torch.matmul(cf, bf.transpose(-1, -2)) * torch.exp(diff) \
        * dtf[..., None, :]
    y = torch.matmul(w, xf) + torch.matmul(cf, starts.transpose(1, 2)) \
        * torch.exp(cl)[..., None]
    return y.reshape(B, H, L, P).to(x.dtype)


def ssd_scan_passes_ref(x, dt, a_neg, b, c, *, chunk):
    """The three passes composed: {"chunk_states", "chunk_decay",
    "starts", "y", "h"} (chunk_decay is cl_last)."""
    states, cl_last = ssd_chunk_states_ref(x, dt, a_neg, b, chunk=chunk)
    starts, h = ssd_state_pass_ref(states, cl_last)
    y = ssd_output_ref(x, dt, a_neg, b, c, starts, chunk=chunk)
    return {"chunk_states": states, "chunk_decay": cl_last, "starts": starts,
            "y": y, "h": h}
