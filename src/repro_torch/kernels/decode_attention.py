"""Flash-decoding over a linear KV cache: the wrapper of the CUDA kernel in
``csrc/decode_attention.cu``.

Replaces ``repro/kernels/decode_attention.py::decode_attention`` (the
Pallas TPU kernel).  Same function and layout: q (B,H,D), k/v (B,KV,S,D),
pos (B,) -> (B,H,D); row b attends to cache positions <= pos[b] (and
within the window), optional tanh cap.

Bound on the H100: the bytes of K/V up to pos (~33.5 MB at B = 4,
S = 4096, KV = 8, D = 64: ~10 us at 3.35 TB/s).  The kernel gives each
(row, kv head) one block, so the G = H/KV query heads of a group share one
read of the cache; with B * KV = 32 blocks on 132 SMs it cannot reach the
bandwidth, which a split-K pass (later work) fixes.

The paged variant (``paged_decode_attention``, reading the block pools
through a block table) is not ported yet: the serving path decodes on a
gathered working cache, as the JAX package does.

CPU tensors take the plain version (``ref.decode_attention_ref``); CUDA
tensors launch the kernel or raise.  ``decode_attention.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _launch, ref

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 10
             + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                ctypes.c_void_p])


def _kernel():
    fn = _build.library("decode_attention").decode_attention_bf16
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def decode_attention(q, k, v, pos, *, scale: float, window: int = 0,
                     cap: float = 0.0):
    """q (B,H,D), k/v (B,KV,S,D), pos (B,) int -> (B,H,D).

    Strided views are taken as they are (the model passes a transposed
    view of each layer's (B,S,KV,D) cache)."""
    B, H, D = q.shape
    KV, S = k.shape[1], k.shape[2]
    if H % KV or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D \
            or tuple(pos.shape) != (B,):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"pos {tuple(pos.shape)}")
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, pos, scale=scale,
                                        window=window, cap=cap)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    _launch.check_inputs("decode_attention", (q, k, v), D)
    if H // KV > 16:
        raise ValueError(f"decode_attention: {H // KV} query heads per kv "
                         "head; the kernel holds at most 16")
    pos32 = pos.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    err = _kernel()(
        _launch.ptr(q), _launch.ptr(k), _launch.ptr(v), _launch.ptr(pos32),
        _launch.ptr(out), B, H, KV, S, D,
        *q.stride()[:2], *k.stride()[:3], *v.stride()[:3], *out.stride()[:2],
        float(scale), int(window), float(cap), q.device.index or 0,
        _launch.stream(q))
    _launch.raise_on_error("decode_attention", err)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
