"""Mamba-2 SSD chunked scan: the wrapper of the CUDA kernels in
``csrc/ssd_scan.cu``.

Replaces ``repro/kernels/ssd_scan.py::ssd_scan`` (the Pallas TPU kernel).
Same function and layout: x (B,H,L,P), dt (B,H,L), a_neg (H,), b/c (B,L,N)
shared across heads -> y (B,H,L,P) in x's dtype and the final state
(B,H,N,P) in fp32; ``L % min(chunk, L) == 0``.  The plain version is
``ref.ssd_scan_ref``; ``ref.ssd_scan_passes_ref`` computes it as the
kernels do.

Bound on the H100 at mamba2-780m width: the bytes (~28 MB, ~8.4 us), just
above the operations (~4.9 GFLOP, ~5 us at the bf16 tensor-core rate).
One C call launches three passes on the caller's stream, all on the
tensor cores (mma.sync): the chunks' own states, the fp32 recurrence over
the chunks, and the output, with C Bᵀ computed once per (batch, chunk)
and shared by a group of heads (:func:`launch_shape`).  With one chunk the
recurrence is not launched (:func:`ssd_kernels`).  The chunk states live
in an fp32 scratch (B * chunks * H * N * P values, 12.6 MB at full width),
one per device and stream, kept between calls.  See the source for the
design.

The kernels take P in {32, 64}, N in {16, 32, 64, 128} and chunks that
are multiples of 4.  A chunk above 256 rows runs as the largest chunk of
at most 256 rows that divides it (:func:`kernel_chunk`): the scan's
function does not depend on the chunk.  dt is read through its strides
(the model passes a (B,H,L) view of its (B,L,H) tensor), b and c through
their row strides (slices of the model's (x, B, C) tensor).

CPU tensors take the plain version; CUDA tensors launch the kernels or
raise.  On either device the wrapper raises when autograd would record it
(the kernels have no backward).  ``ssd_scan.launches`` counts wrapper
calls that launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _launch, ref

P_SIZES = (32, 64)
N_SIZES = (16, 32, 64, 128)
MAX_CHUNK = 256  # rows of the kernels' shared-memory tiles
MAX_GROUP = 8  # heads per block: the chunk pass scans one head a warp
H100_SMS = 132

_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
             + [ctypes.c_longlong] * 13 + [ctypes.c_int, ctypes.c_void_p])

# fp32 scratch of the chunk states and the cumsums cl, one per (device,
# stream), grown as needed: calls on one stream run in order
_SCRATCH: dict = {}
_SMS: dict = {}  # SMs per device index
_FN: list = []


def kernel_chunk(Q: int) -> int:
    """The chunk the kernels run for a scan chunk of Q rows (Q % 4 == 0):
    Q itself up to 256, else its largest divisor of at most 256 rows that
    is a multiple of 4."""
    if Q <= MAX_CHUNK:
        return Q
    return max(d for d in range(4, MAX_CHUNK + 1, 4) if Q % d == 0)


def ssd_kernels(B: int, H: int, L: int, chunk: int) -> int:
    """Kernels one call launches: the chunk and output passes, and the
    recurrence between them when there is more than one chunk."""
    return 3 if L // kernel_chunk(min(chunk, L)) > 1 else 2


def _group(blocks: int, H: int, sms: int) -> int:
    """The fewest heads per block that keep ``blocks`` * ceil(H / G)
    within one wave of ``sms`` blocks, evened out over the groups."""
    G = min(H, MAX_GROUP, max(1, -(-blocks * H // sms)))
    return -(-H // -(-H // G))


@functools.lru_cache(maxsize=256)
def launch_shape(B: int, H: int, L: int, chunk: int, sms: int = H100_SMS):
    """(G1, G3, R): heads per block of the chunk pass (G1) and of the output
    pass (G3), and the output pass's row blocks per chunk (R).  Each pass
    takes most of an SM's shared memory, so each aims at one wave of
    blocks: B * chunks * ceil(H / G1) and B * chunks * R * ceil(H / G3).
    R = 2 (two sets of strip pairs, each keeping its own C Bᵀ tiles) where
    the chunk has two pairs of 16-row strips or more, else 1."""
    Qk = kernel_chunk(min(chunk, L))
    nc = L // Qk
    R = min(2, (-(-Qk // 16) + 1) // 2)
    return _group(B * nc, H, sms), _group(B * nc * R, H, sms), R


def _kernel():
    if not _FN:
        fn = _build.library("ssd_scan").ssd_scan_bf16
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        _FN.append(fn)
    return _FN[0]


def _check(x, dt, a_neg, b, c, chunk):
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
    return B, H, L, P, N, Q


def _run(x, dt, a_neg, b, c, Q: int, upto: int):
    """One C call running passes 1..``upto`` on CUDA tensors; returns y,
    h_out and the flat scratch: the chunk states, then every step's cl."""
    B, H, L, P = x.shape
    N = b.shape[-1]
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
    Qk = kernel_chunk(Q)
    nc = L // Qk
    a32 = a_neg.to(device=x.device, dtype=torch.float32).contiguous()
    y = torch.empty_like(x)
    h = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device)
    stream = _launch.stream(x)
    n_state, n_cl = B * nc * H * N * P, B * H * L
    key = (x.device.index, stream.value)
    scratch = _SCRATCH.get(key)
    if scratch is None or scratch.numel() < n_state + n_cl:
        scratch = _SCRATCH[key] = torch.empty(n_state + n_cl,
                                              dtype=torch.float32,
                                              device=x.device)
    sms = _SMS.get(x.device.index)
    if sms is None:
        sms = _SMS[x.device.index] = torch.cuda.get_device_properties(
            x.device).multi_processor_count
    err = _kernel()(
        _launch.ptr(x), _launch.ptr(dt), _launch.ptr(a32), _launch.ptr(b),
        _launch.ptr(c), _launch.ptr(y), _launch.ptr(h), _launch.ptr(scratch),
        ctypes.c_void_p(scratch.data_ptr() + 4 * n_state), B, H, L, P, N, Qk,
        *launch_shape(B, H, L, Qk, sms), upto, *x.stride()[:3], *dt.stride(),
        b.stride(0), b.stride(1), c.stride(0), c.stride(1), *y.stride()[:3],
        x.device.index or 0, stream)
    _launch.raise_on_error("ssd_scan", err)
    ssd_scan.launches += 1
    return y, h, scratch


def ssd_scan(x, dt, a_neg, b, c, *, chunk: int = 256):
    """x (B,H,L,P), dt (B,H,L), a_neg (H,), b/c (B,L,N) -> (y, h_final)."""
    Q = _check(x, dt, a_neg, b, c, chunk)[-1]
    _launch.refuse_autograd("ssd_scan", (x, dt, a_neg, b, c),
                            "training runs the Mamba mixer with impl 'auto'")
    if x.device.type == "cpu":
        return ref.ssd_scan_ref(x, dt, a_neg, b, c, chunk=chunk)
    y, h, _ = _run(x, dt, a_neg, b, c, Q, upto=3)
    return y, h


ssd_scan.launches = 0


def ssd_scan_passes(x, dt, a_neg, b, c, *, chunk: int = 256) -> dict:
    """The kernels' intermediates, for the tests: {"chunk_states",
    "chunk_decay", "starts", "y", "h"} as ``ref.ssd_scan_passes_ref``
    gives them, at the kernels' chunk.  On the card: one call that stops
    after pass 1 (the chunk states), then the whole scan (the scratch then
    holds the starting states); with one chunk the starting state is 0."""
    Qk = kernel_chunk(_check(x, dt, a_neg, b, c, chunk)[-1])
    if x.device.type == "cpu":
        return ref.ssd_scan_passes_ref(x, dt, a_neg, b, c, chunk=Qk)
    B, H, L, P = x.shape
    N, nc = b.shape[-1], L // Qk

    def views(h, scratch):
        n = B * nc * H * N * P
        return (h[:, None] if nc == 1 else scratch[:n].view(B, nc, H, N, P),
                scratch[n:n + B * H * L].view(B, nc, H, Qk)[..., -1])

    _, h1, scratch = _run(x, dt, a_neg, b, c, Qk, upto=1)
    states, decay = (t.clone() for t in views(h1, scratch))
    y, h, scratch = _run(x, dt, a_neg, b, c, Qk, upto=3)
    starts = torch.zeros_like(states) if nc == 1 else \
        views(h, scratch)[0].clone()
    return {"chunk_states": states, "chunk_decay": decay, "starts": starts,
            "y": y, "h": h}
