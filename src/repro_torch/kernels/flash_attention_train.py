"""Causal GQA flash attention for training in fp32, with its backward: the
wrapper of the CUDA kernels in ``csrc/flash_attention_train.cu``.

Replaces no TPU kernel: the JAX package trains attention on ``"auto"``
(dense or chunked XLA code), and its Pallas flash kernel has no
``custom_vjp``.  On the card these kernels take the place of
``models.attention.chunked_attention`` and ``dense_attention`` on the
training path: ``attention(impl="auto")`` sends every input that
:func:`takes` accepts to :func:`flash_attention_train`.

Bound on the H100: the operations, all fp32 FFMAs (no TF32, no bf16).
The forward does 4 * D FLOPs per kept (query, key) pair and head (137
GFLOP at B 2, S 4096, H 32, D 64: 2.05 ms at 67 TFLOP/s); the backward
3.5 times that.  The design (register micro-tiles over shared-memory
tiles, one block per 64 rows) is in the source.

Layout: the model's, q (B,S,H,D), k/v (B,S,KV,D), positions (B,S) int64;
the kernels read (B,H,S,D) views through strides, as ``ops.
flash_attention`` hands B1.  Three entries, each one launch and each with
its counter (``.launches``, CUDA launches only): :func:`flash_forward` (O
and the per-row log-sum-exp, (B,H,S)), :func:`flash_backward_dq` (Delta =
rowsum(dO * O), then dQ) and :func:`flash_backward_dkdv` (dK and dV, the G
query heads of a kv head summed inside the block).  CPU tensors take the
plain versions (``*_ref``): the same math in plain PyTorch, with the same
backward formulas; CUDA tensors launch the kernels or raise.

Masking is ``models.attention._mask``'s, by the positions given; which
tiles the kernels visit rests on ``chunked_attention``'s assumption
(``q_pos = k_pos = offset + arange(S)``), which the training path meets.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _launch

HEAD_DIMS = _launch.HEAD_DIMS
NEG_INF = -2.0e38
OP = "flash_attention_train"

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    # pointers, B H KV S D, strides, positions' strides, scale window device
    # stream
    "flash_train_fwd": [_P] * 7 + [_I] * 5 + [_L] * 12 + [_L] * 4
    + [ctypes.c_float, _I, _I, _P],
    "flash_train_dq": [_P] * 10 + [_I] * 5 + [_L] * 18 + [_L] * 4
    + [ctypes.c_float, _I, _I, _P],
    "flash_train_dkdv": [_P] * 10 + [_I] * 5 + [_L] * 18 + [_L] * 4
    + [ctypes.c_float, _I, _I, _P],
}
_FNS: dict = {}


def _kernel(name: str):
    fn = _FNS.get(name)
    if fn is None:
        fn = _FNS[name] = getattr(_build.library(OP), name)
        fn.argtypes, fn.restype = _ARGTYPES[name], ctypes.c_int
    return fn


def takes(q, k, v, cap: float = 0.0) -> bool:
    """Whether ``attention(impl="auto")`` runs these kernels: q, k and v
    fp32 on a CUDA device, no tanh cap, one head dim of 64 or 128 for all
    three, as many queries as keys, and H a multiple of KV.  It reads only
    what the inputs show.  Outside: gemma2's cap, MLA's unequal head dims,
    bf16, a query shorter than its keys, and every CPU tensor."""
    B, S, H, D = q.shape
    return (q.device.type == "cuda" and not cap
            and q.dtype == k.dtype == v.dtype == torch.float32
            and D in HEAD_DIMS and tuple(k.shape) == tuple(v.shape)
            and k.shape[0] == B and k.shape[1] == S and k.shape[3] == D
            and H % k.shape[2] == 0)


def _positions(pos, B, S, device):
    return pos.to(device=device, dtype=torch.int64).expand(B, S)


def _check(q, k, v):
    B, S, H, D = q.shape
    if (k.shape != v.shape or k.shape[0] != B or k.shape[1] != S
            or k.shape[3] != D or H % k.shape[2]):
        raise ValueError(f"{OP}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: the kernels take q (B,S,H,D) "
                         "and k, v (B,S,KV,D) with H % KV == 0")


def _check_cuda(tensors, q):
    if q.device.type != "cuda":
        raise ValueError(f"{OP}: unsupported device {q.device}")
    _launch.check_inputs(OP, tensors, q.shape[-1], dtype=torch.float32)


def _heads_view(t):
    """(B,S,H,D) -> the (batch, head, sequence) strides of (B,H,S,D)."""
    return t.transpose(1, 2).stride()[:3]


# ---------------------------------------------------------------------------
# Plain versions (CPU tensors)
# ---------------------------------------------------------------------------


def _scores(q, k, q_pos, k_pos, scale, window):
    """Scaled scores (B,KV,G,S,S) and the visibility mask (B,1,1,S,S)."""
    from repro_torch.models.attention import _mask
    B, S, H, D = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k) * scale
    return s, _mask(q_pos, k_pos, window)[:, None, None]


def forward_ref(q, k, v, q_pos, k_pos, *, scale, window=0):
    """(O (B,S,H,D), LSE (B,H,S)) as the forward kernel computes them:
    masked scores NEG_INF, O = sum_j e^(s_j - m) v_j / max(l, 1e-30),
    LSE = m + log(l)."""
    B, S, H, D = q.shape
    s, vis = _scores(q, k, q_pos, k_pos, scale, window)
    s = s.masked_fill(~vis, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v) \
        / torch.clamp_min(l, 1e-30).permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(torch.clamp_min(l, 1e-30)))[..., 0]
    return o.reshape(B, S, H, D), lse.reshape(B, H, S)


def _probs(q, k, lse, q_pos, k_pos, scale, window):
    """P recomputed from the LSE, 0 where masked: (B,KV,G,S,S)."""
    B, S, H, _ = q.shape
    KV = k.shape[2]
    s, vis = _scores(q, k, q_pos, k_pos, scale, window)
    p = torch.exp(s - lse.reshape(B, KV, H // KV, S)[..., None])
    return torch.where(vis, p, torch.zeros_like(p))


def _ds(q, k, v, p, delta, dout):
    """dS = P * (dO V^T - Delta): (B,KV,G,S,S)."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    dog = dout.reshape(B, S, KV, H // KV, D)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, v)
    return p * (dp - delta.reshape(B, KV, H // KV, S)[..., None])


def dq_ref(q, k, v, o, lse, dout, q_pos, k_pos, *, scale, window=0):
    """(dQ (B,S,H,D), Delta (B,H,S)), Delta = rowsum(dO * O)."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    delta = (dout * o).sum(dim=-1).transpose(1, 2)
    p = _probs(q, k, lse, q_pos, k_pos, scale, window)
    ds = _ds(q, k, v, p, delta, dout)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k) * scale
    return dq.reshape(B, S, H, D), delta


def dkdv_ref(q, k, v, lse, delta, dout, q_pos, k_pos, *, scale, window=0):
    """(dK, dV), each (B,S,KV,D), summed over the G query heads."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, D)
    dog = dout.reshape(B, S, KV, H // KV, D)
    p = _probs(q, k, lse, q_pos, k_pos, scale, window)
    ds = _ds(q, k, v, p, delta, dout)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg) * scale
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    return dk, dv


# ---------------------------------------------------------------------------
# The three entries
# ---------------------------------------------------------------------------


def flash_forward(q, k, v, q_pos, k_pos, *, scale: float, window: int = 0):
    """(O (B,S,H,D), LSE (B,H,S) fp32): the forward kernel on the card,
    :func:`forward_ref` on the CPU."""
    _check(q, k, v)
    B, S, H, D = q.shape
    q_pos, k_pos = (_positions(p, B, S, q.device) for p in (q_pos, k_pos))
    if q.device.type == "cpu":
        return forward_ref(q, k, v, q_pos, k_pos, scale=scale, window=window)
    _check_cuda((q, k, v), q)
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    err = _kernel("flash_train_fwd")(
        _launch.ptr(q), _launch.ptr(k), _launch.ptr(v), _launch.ptr(o),
        _launch.ptr(lse), _launch.ptr(q_pos), _launch.ptr(k_pos),
        B, H, k.shape[2], S, D, *_heads_view(q), *_heads_view(k),
        *_heads_view(v), *_heads_view(o), *q_pos.stride(), *k_pos.stride(),
        float(scale), int(window), q.device.index or 0, _launch.stream(q))
    _launch.raise_on_error("flash_train_fwd", err)
    flash_forward.launches += 1
    return o, lse


def flash_backward_dq(q, k, v, o, lse, dout, q_pos, k_pos, *, scale: float,
                      window: int = 0):
    """(dQ (B,S,H,D), Delta (B,H,S)): the dQ kernel, which writes Delta
    for :func:`flash_backward_dkdv`, on the card; :func:`dq_ref` on the
    CPU."""
    _check(q, k, v)
    B, S, H, D = q.shape
    q_pos, k_pos = (_positions(p, B, S, q.device) for p in (q_pos, k_pos))
    if q.device.type == "cpu":
        return dq_ref(q, k, v, o, lse, dout, q_pos, k_pos, scale=scale,
                      window=window)
    _check_cuda((q, k, v, o, dout), q)
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    err = _kernel("flash_train_dq")(
        _launch.ptr(q), _launch.ptr(k), _launch.ptr(v), _launch.ptr(o),
        _launch.ptr(dout), _launch.ptr(lse), _launch.ptr(delta),
        _launch.ptr(dq), _launch.ptr(q_pos), _launch.ptr(k_pos),
        B, H, k.shape[2], S, D, *_heads_view(q), *_heads_view(k),
        *_heads_view(v), *_heads_view(o), *_heads_view(dout),
        *_heads_view(dq), *q_pos.stride(), *k_pos.stride(),
        float(scale), int(window), q.device.index or 0, _launch.stream(q))
    _launch.raise_on_error("flash_train_dq", err)
    flash_backward_dq.launches += 1
    return dq, delta


def flash_backward_dkdv(q, k, v, lse, delta, dout, q_pos, k_pos, *,
                        scale: float, window: int = 0):
    """(dK, dV), each (B,S,KV,D): the dK/dV kernel on the card (after
    :func:`flash_backward_dq`, whose Delta it reads), :func:`dkdv_ref` on
    the CPU."""
    _check(q, k, v)
    B, S, H, D = q.shape
    q_pos, k_pos = (_positions(p, B, S, q.device) for p in (q_pos, k_pos))
    if q.device.type == "cpu":
        return dkdv_ref(q, k, v, lse, delta, dout, q_pos, k_pos, scale=scale,
                        window=window)
    _check_cuda((q, k, v, dout), q)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    err = _kernel("flash_train_dkdv")(
        _launch.ptr(q), _launch.ptr(k), _launch.ptr(v), _launch.ptr(dout),
        _launch.ptr(lse), _launch.ptr(delta),
        _launch.ptr(dk), _launch.ptr(dv), _launch.ptr(q_pos),
        _launch.ptr(k_pos), B, H, k.shape[2], S, D, *_heads_view(q),
        *_heads_view(k), *_heads_view(v), *_heads_view(dout),
        *_heads_view(dk), *_heads_view(dv), *q_pos.stride(), *k_pos.stride(),
        float(scale), int(window), q.device.index or 0, _launch.stream(q))
    _launch.raise_on_error("flash_train_dkdv", err)
    flash_backward_dkdv.launches += 1
    return dk, dv


flash_forward.launches = 0
flash_backward_dq.launches = 0
flash_backward_dkdv.launches = 0
ENTRIES = {"flash_train_fwd": flash_forward,
           "flash_train_dkdv": flash_backward_dkdv,
           "flash_train_dq": flash_backward_dq}


class _FlashAttentionTrain(torch.autograd.Function):
    """Saves q, k, v, O, the LSE and the positions; the backward runs dQ,
    then dK/dV."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, scale, window):
        o, lse = flash_forward(q, k, v, q_pos, k_pos, scale=scale,
                               window=window)
        ctx.save_for_backward(q, k, v, o, lse, q_pos, k_pos)
        ctx.scale, ctx.window = scale, window
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse, q_pos, k_pos = ctx.saved_tensors
        dout = dout.contiguous()
        dq, delta = flash_backward_dq(q, k, v, o, lse, dout, q_pos, k_pos,
                                      scale=ctx.scale, window=ctx.window)
        dk, dv = flash_backward_dkdv(q, k, v, lse, delta, dout, q_pos, k_pos,
                                     scale=ctx.scale, window=ctx.window)
        return dq, dk, dv, None, None, None, None


def flash_attention_train(q, k, v, q_pos, k_pos, *, scale: float,
                          window: int = 0):
    """Causal attention with autograd: q (B,S,H,D), k/v (B,S,KV,D),
    positions (B,S) (or (S,)) -> (B,S,H,D).  The kernels on CUDA tensors,
    the plain versions on CPU tensors."""
    return _FlashAttentionTrain.apply(q, k, v, q_pos, k_pos, float(scale),
                                      int(window))
