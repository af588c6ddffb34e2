"""Mamba-2 SSD chunked scan: the wrapper of the CUDA kernel in
``csrc/ssd_scan.cu``.

Replaces ``repro/kernels/ssd_scan.py::ssd_scan`` (the Pallas TPU kernel).
Same function and layout: x (B,H,L,P), dt (B,H,L), a_neg (H,), b/c (B,L,N)
shared across heads -> y (B,H,L,P) in x's dtype and the final state
(B,H,N,P) in fp32; ``L % min(chunk, L) == 0``.  The plain version is
``ref.ssd_scan_ref``.

Bound on the H100 at mamba2-780m width: the bytes (~28 MB, ~8.4 us), just
above the operations (~4.9 GFLOP, ~5 us at the bf16 tensor-core rate).
The kernel gives one block to each (batch, head) and walks the chunks in
order with the fp32 state in shared memory, on CUDA cores in fp32: B * H =
48 blocks on 132 SMs at full width.  See the source for the design.

The kernel takes P in {32, 64}, N in {16, 32, 64, 128} and chunks that are
multiples of 4 whose staged x, B, C and state fit the block's shared
memory (every chunk up to 256 does).  dt is read through its strides (the
model passes a (B,H,L) view of its (B,L,H) tensor).

CPU tensors take the plain version; CUDA tensors launch the kernel or
raise.  ``ssd_scan.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _launch, ref

P_SIZES = (32, 64)
N_SIZES = (16, 32, 64, 128)

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 13 + [ctypes.c_int, ctypes.c_void_p])


def _kernel():
    fn = _build.library("ssd_scan").ssd_scan_bf16
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def ssd_scan(x, dt, a_neg, b, c, *, chunk: int = 256):
    """x (B,H,L,P), dt (B,H,L), a_neg (H,), b/c (B,L,N) -> (y, h_final)."""
    B, H, L, P = x.shape
    N = b.shape[-1]
    Q = min(chunk, L)
    if tuple(dt.shape) != (B, H, L) or tuple(a_neg.shape) != (H,) \
            or tuple(b.shape) != (B, L, N) or b.shape != c.shape:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"a {tuple(a_neg.shape)}, b {tuple(b.shape)}, "
                         f"c {tuple(c.shape)}")
    if L % Q:
        raise ValueError(f"ssd_scan: L={L} is not a multiple of chunk {Q}")
    if x.device.type == "cpu":
        return ref.ssd_scan_ref(x, dt, a_neg, b, c, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    _launch.check_inputs("ssd_scan", (x, b, c))
    if dt.dtype != torch.bfloat16 or dt.device != x.device:
        raise TypeError(f"ssd_scan: dt must be bfloat16 on {x.device}, got "
                        f"{dt.dtype} on {dt.device}")
    if P not in P_SIZES or N not in N_SIZES or Q % 4:
        raise ValueError(f"ssd_scan: the kernel takes P in {P_SIZES}, N in "
                         f"{N_SIZES} and chunks that are multiples of 4; got "
                         f"P={P}, N={N}, chunk={Q}")
    a32 = a_neg.to(device=x.device, dtype=torch.float32).contiguous()
    y = torch.empty_like(x)
    h = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device)
    err = _kernel()(
        _launch.ptr(x), _launch.ptr(dt), _launch.ptr(a32), _launch.ptr(b),
        _launch.ptr(c), _launch.ptr(y), _launch.ptr(h), B, H, L, P, N, Q,
        *x.stride()[:3], *dt.stride(), b.stride(0), b.stride(1),
        c.stride(0), c.stride(1), *y.stride()[:3], x.device.index or 0,
        _launch.stream(x))
    _launch.raise_on_error("ssd_scan", err)
    ssd_scan.launches += 1
    return y, h


ssd_scan.launches = 0
