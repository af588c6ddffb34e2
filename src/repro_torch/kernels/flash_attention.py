"""Causal GQA flash attention: the wrapper of the CUDA kernel in
``csrc/flash_attention.cu``.

Replaces ``repro/kernels/flash_attention.py::flash_attention`` (the Pallas
TPU kernel).  Same function and layout: q (B,H,Sq,D), k/v (B,KV,Sk,D) ->
(B,H,Sq,D), causal from position 0, optional sliding window and tanh cap.

Bound on the H100: the FLOPs for long prompts (17.2 GFLOP at Sq = 2048,
H = 32, D = 64: 17.4 us at 989 TFLOP/s bf16); the launch for the serving
path's prompts of <= 64 tokens.  The kernel runs on the tensor cores
(wgmma, bf16 operands, fp32 softmax state): one block of two warpgroups per
128 q rows and head, 64-key K/V tiles staged by cp.async in a two-stage
ring of 128-byte-swizzled bf16 shared memory, tiles past the causal
diagonal or before the window never loaded; see the source for the
layouts.

CPU tensors take the plain version (``ref.flash_attention_ref``); CUDA
tensors launch the kernel or raise.  On either device the wrapper raises
when autograd would record it (the kernel has no backward).
``flash_attention.launches`` counts wrapper calls that launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _launch, ref

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 12
             + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                ctypes.c_void_p])


_FNS: dict = {}


def _kernel():
    fn = _FNS.get("flash")
    if fn is None:
        fn = _FNS["flash"] = _build.library("flash_attention").flash_attention_bf16
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def flash_attention(q, k, v, *, scale: float, window: int = 0,
                    cap: float = 0.0):
    """q (B,H,Sq,D), k/v (B,KV,Sk,D) -> (B,H,Sq,D). Causal.

    Strided views are taken as they are (the model passes transposed views
    of its (B,S,H,D) tensors); the output has q's strides."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if H % KV or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    _launch.refuse_autograd("flash_attention", (q, k, v),
                            _launch.ATTENTION_USE)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, scale=scale, window=window,
                                       cap=cap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _launch.check_inputs("flash_attention", (q, k, v), D)
    out = torch.empty_like(q)
    err = _kernel()(
        _launch.ptr(q), _launch.ptr(k), _launch.ptr(v), _launch.ptr(out),
        B, H, KV, Sq, Sk, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        float(scale), int(window), float(cap), q.device.index or 0,
        _launch.stream(q))
    _launch.raise_on_error("flash_attention", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
