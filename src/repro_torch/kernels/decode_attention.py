"""Split-K flash-decoding over a linear or a paged KV cache: the wrappers
of the CUDA kernels in ``csrc/decode_attention.cu``.

``decode_attention`` replaces ``repro/kernels/decode_attention.py::
decode_attention`` (the Pallas TPU kernel).  Same function and layout: q
(B,H,D), k/v (B,KV,S,D), pos (B,) -> (B,H,D); row b attends to cache
positions <= pos[b] (and within the window), optional tanh cap.

``paged_decode_attention`` replaces ``repro/kernels/decode_attention.py::
paged_decode_attention``: the same function over block pools (N,KV,bs,D)
read through a block table (B,nb), with no gathered copy.  The CUDA kernel
is the linear one with another tile load and the same splits (from the
logical length nb * bs), so on the same cache content its output is
bit-identical to ``decode_attention`` on the ``ops.gather_kv_blocks`` copy,
for every block size.  The serving engine decodes on a regathered working
cache, as the JAX package's does; the paged kernel runs on the tuning path
(``kernels/ops.py::TUNABLE_OPS``).

Bound on the H100: the bytes of K/V up to pos (14.7 MB at B = 4, S = 4096,
KV = 8, D = 64, pos 4095/1000/2047/17: 4.4 us at 3.35 TB/s).  One block
per (row, kv head) lets the G = H/KV query heads of a group share one read
of the cache, but gives only B * KV blocks (32 at the serving shape) to
132 SMs.  So the kv walk is split across blocks: :func:`decode_splits`
picks the splits from B, KV and S alone (never from ``pos``, which would
make the host wait for the card), aiming at about four blocks per SM once
the cache has enough 64-key tiles: with rows of different lengths, the
blocks of short rows have little or nothing to do, and a block walks its
tiles one after another, so the card needs more blocks in flight than
SMs to hide the loads' latency.  Each split writes an unnormalised fp32
partial to a scratch tensor (one per device and stream, kept between
calls); a combine kernel, launched from the same C call, merges them (it reads splits * B * H * (D + 2) floats, ~0.54 MB at
the shape above).  With one split (S <= 64) there is no combine.

CPU tensors take the plain versions (``ref.decode_attention_ref``,
``ref.paged_decode_attention_ref``); CUDA tensors launch the kernel or
raise.  On either device a wrapper raises when autograd would record it
(the kernels have no backward).  ``decode_attention.launches`` and
``paged_decode_attention.launches`` count wrapper calls that launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _launch, ref

# scale, window, cap, splits, tiles per split, scratch, device, stream
_TAIL = [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
    + [ctypes.c_longlong] * 10 + _TAIL
_PAGED_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
    + [ctypes.c_longlong] * 10 + _TAIL

TILE = 64  # keys per K/V tile (rt::BK)
TARGET_BLOCKS = 528  # about four blocks on each of the H100's 132 SMs


def decode_splits(B: int, KV: int, S: int):
    """(splits, tiles per split) of the kv walk over a cache of S
    positions, from host-known sizes only.  The ceil(S / 64) tiles are cut
    into equal runs so that B * KV * splits reaches ``TARGET_BLOCKS`` where
    there are tiles enough; every split holds at least one tile, the last
    one possibly fewer than the others, and S <= 64 gives one split."""
    tiles = -(-S // TILE)
    want = max(1, min(tiles, -(-TARGET_BLOCKS // (B * KV))))
    per = -(-tiles // want)
    return -(-tiles // per), per


# fp32 scratch of the split partials, one per (device, stream), grown as
# needed: calls on one stream run in order, so they can share it, and a
# call allocates nothing
_SCRATCH: dict = {}
_FNS: dict = {}


def _split_args(q, B: int, H: int, KV: int, S: int, D: int, stream):
    """splits, tiles per split and the scratch pointer for one call."""
    splits, per = decode_splits(B, KV, S)
    if splits == 1:
        return splits, per, ctypes.c_void_p(0)
    n = splits * B * H * (D + 2)
    key = (q.device.index, stream.value)
    scratch = _SCRATCH.get(key)
    if scratch is None or scratch.numel() < n:
        scratch = _SCRATCH[key] = torch.empty(n, dtype=torch.float32,
                                              device=q.device)
    return splits, per, _launch.ptr(scratch)


def _kernel(name: str, argtypes):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.library("decode_attention"), name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _FNS[name] = fn
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
    _launch.refuse_autograd("decode_attention", (q, k, v),
                            _launch.ATTENTION_USE)
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, pos, scale=scale,
                                        window=window, cap=cap)
    _check_cuda("decode_attention", q, (k, v), H // KV, D)
    pos32 = pos.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    stream = _launch.stream(q)
    splits, per, part = _split_args(q, B, H, KV, S, D, stream)
    err = _kernel("decode_attention_bf16", _ARGTYPES)(
        _launch.ptr(q), _launch.ptr(k), _launch.ptr(v), _launch.ptr(pos32),
        _launch.ptr(out), B, H, KV, S, D,
        *q.stride()[:2], *k.stride()[:3], *v.stride()[:3], *out.stride()[:2],
        float(scale), int(window), float(cap), splits, per, part,
        q.device.index or 0, stream)
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
    _launch.refuse_autograd("paged_decode_attention", (q, k_pool, v_pool),
                            _launch.ATTENTION_USE)
    if q.device.type == "cpu":
        return ref.paged_decode_attention_ref(q, k_pool, v_pool, table, pos,
                                              scale=scale, window=window,
                                              cap=cap)
    _check_cuda("paged_decode_attention", q, (k_pool, v_pool), H // KV, D)
    tbl = table.to(device=q.device, dtype=torch.int32).contiguous()
    pos32 = pos.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    stream = _launch.stream(q)
    splits, per, part = _split_args(q, B, H, KV, nb * bs, D, stream)
    err = _kernel("paged_decode_attention_bf16", _PAGED_ARGTYPES)(
        _launch.ptr(q), _launch.ptr(k_pool), _launch.ptr(v_pool),
        _launch.ptr(tbl), _launch.ptr(pos32), _launch.ptr(out),
        B, H, KV, nb, bs, D,
        *q.stride()[:2], *k_pool.stride()[:3], *v_pool.stride()[:3],
        *out.stride()[:2], float(scale), int(window), float(cap), splits,
        per, part, q.device.index or 0, stream)
    _launch.raise_on_error("paged_decode_attention", err)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
