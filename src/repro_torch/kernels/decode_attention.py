"""Flash-decoding over a linear or a paged KV cache: the wrappers of the
CUDA kernels in ``csrc/decode_attention.cu``.

``decode_attention`` replaces ``repro/kernels/decode_attention.py::
decode_attention`` (the Pallas TPU kernel).  Same function and layout: q
(B,H,D), k/v (B,KV,S,D), pos (B,) -> (B,H,D); row b attends to cache
positions <= pos[b] (and within the window), optional tanh cap.

``paged_decode_attention`` replaces ``repro/kernels/decode_attention.py::
paged_decode_attention``: the same function over block pools (N,KV,bs,D)
read through a block table (B,nb), with no gathered copy.  The CUDA kernel
is the linear one with another tile load, so on the same cache content its
output is bit-identical to ``decode_attention`` on the
``ops.gather_kv_blocks`` copy, for every block size.  The serving engine
decodes on a regathered working cache, as the JAX package's does; the
paged kernel runs on the tuning path (``kernels/ops.py::TUNABLE_OPS``).

Bound on the H100: the bytes of K/V up to pos (~33.5 MB at B = 4,
S = 4096, KV = 8, D = 64: ~10 us at 3.35 TB/s).  The kernel gives each
(row, kv head) one block, so the G = H/KV query heads of a group share one
read of the cache; with B * KV = 32 blocks on 132 SMs it cannot reach the
bandwidth, which a split-K pass (later work) fixes.

CPU tensors take the plain versions (``ref.decode_attention_ref``,
``ref.paged_decode_attention_ref``); CUDA tensors launch the kernel or
raise.  ``decode_attention.launches`` and
``paged_decode_attention.launches`` count kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _launch, ref

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 10
             + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                ctypes.c_void_p])
_PAGED_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 10
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                      ctypes.c_int, ctypes.c_void_p])


def _kernel(name: str, argtypes):
    fn = getattr(_build.library("decode_attention"), name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def _check_cuda(op: str, q, kv, G: int, D: int) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{op}: unsupported device {q.device}")
    _launch.check_inputs(op, (q,) + tuple(kv), D)
    if G > 16:
        raise ValueError(f"{op}: {G} query heads per kv head; the kernel "
                         "holds at most 16")


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
    _check_cuda("decode_attention", q, (k, v), H // KV, D)
    pos32 = pos.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    err = _kernel("decode_attention_bf16", _ARGTYPES)(
        _launch.ptr(q), _launch.ptr(k), _launch.ptr(v), _launch.ptr(pos32),
        _launch.ptr(out), B, H, KV, S, D,
        *q.stride()[:2], *k.stride()[:3], *v.stride()[:3], *out.stride()[:2],
        float(scale), int(window), float(cap), q.device.index or 0,
        _launch.stream(q))
    _launch.raise_on_error("decode_attention", err)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def paged_decode_attention(q, k_pool, v_pool, table, pos, *, scale: float,
                           window: int = 0, cap: float = 0.0):
    """q (B,H,D), pools (N,KV,bs,D), table (B,nb) int, pos (B,) int ->
    (B,H,D).  Row b reads logical block i from pool block table[b, i];
    entries past a row's length (pos // bs) are never read.

    The pools are read through their strides (the serving pools hold
    (N, cycles, bs, KV, D), and a layer is a strided view of them)."""
    B, H, D = q.shape
    N, KV, bs = k_pool.shape[:3]
    nb = table.shape[1] if table.dim() == 2 else -1
    if H % KV or k_pool.shape != v_pool.shape or k_pool.shape[3] != D \
            or tuple(table.shape) != (B, nb) or tuple(pos.shape) != (B,):
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)}, "
                         f"pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)}, "
                         f"table {tuple(table.shape)}, pos {tuple(pos.shape)}")
    if q.device.type == "cpu":
        return ref.paged_decode_attention_ref(q, k_pool, v_pool, table, pos,
                                              scale=scale, window=window,
                                              cap=cap)
    _check_cuda("paged_decode_attention", q, (k_pool, v_pool), H // KV, D)
    tbl = table.to(device=q.device, dtype=torch.int32).contiguous()
    pos32 = pos.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    err = _kernel("paged_decode_attention_bf16", _PAGED_ARGTYPES)(
        _launch.ptr(q), _launch.ptr(k_pool), _launch.ptr(v_pool),
        _launch.ptr(tbl), _launch.ptr(pos32), _launch.ptr(out),
        B, H, KV, nb, bs, D,
        *q.stride()[:2], *k_pool.stride()[:3], *v_pool.stride()[:3],
        *out.stride()[:2], float(scale), int(window), float(cap),
        q.device.index or 0, _launch.stream(q))
    _launch.raise_on_error("paged_decode_attention", err)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
