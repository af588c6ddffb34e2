"""Model-layout wrappers for the kernels (the port of ``repro.kernels.ops``).

Model code passes (B, S, H, D) tensors; the kernels take (B, H, S, D).
The wrappers hand the kernels transposed *views* (the CUDA kernels read
through strides), so no layout copy is made on the card.

The second half is the tuning registry, the autotuner's view of this layer
(``repro_torch.core.autotune.bench_kernels`` times it).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import decode_attention as dec_k
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ssd_k


def gather_kv_blocks(pool, table):
    """Linear caches from a block pool: pool (N, bs, *tail), table (B, nb)
    -> (B, nb * bs, *tail).  Every table entry is read."""
    g = pool[table.long()]  # (B, nb, bs, *tail)
    return g.reshape((g.shape[0], g.shape[1] * g.shape[2]) + tuple(g.shape[3:]))


def flash_attention(q, k, v, *, scale, window=0, cap=0.0):
    """(B,S,H,D) x (B,S,KV,D) -> (B,S,H,D), causal from position 0.

    Takes no positions: the caller guarantees they are ``arange(S)``
    (whole-prompt prefill), as ``repro.kernels.ops.flash_attention`` does."""
    out = fa_k.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), scale=scale, window=window,
                               cap=cap)
    return out.transpose(1, 2)


def decode_attention(q, k, v, pos, *, scale, window=0, cap=0.0):
    """q (B,1,H,D), linear cache k/v (B,S,KV,D), pos (B,) -> (B,1,H,D)."""
    out = dec_k.decode_attention(q[:, 0], k.transpose(1, 2), v.transpose(1, 2),
                                 pos, scale=scale, window=window, cap=cap)
    return out[:, None]


def paged_decode_attention(q, k_pool, v_pool, table, pos, *, scale, window=0,
                           cap=0.0):
    """q (B,1,H,D), pools (N,bs,KV,D) in model layout, table (B,nb),
    pos (B,) -> (B,1,H,D).  Streams each row's pool blocks through the
    table; no gathered linear cache is made."""
    out = dec_k.paged_decode_attention(
        q[:, 0], k_pool.transpose(1, 2), v_pool.transpose(1, 2), table, pos,
        scale=scale, window=window, cap=cap)
    return out[:, None]


def ssd_scan(x, dt, a_neg, b_mat, c_mat, *, chunk=256):
    """Model layout x (B,L,H,P), dt (B,L,H) -> y (B,L,H,P), h (B,H,N,P).

    A sequence shorter than ``chunk`` takes any length, as the plain
    ``ssd_chunked`` does, although the kernels run chunks that are
    multiples of 4: x, dt, B and C get zero rows up to the next multiple
    of 4, whose outputs are dropped.  A row with dt = 0 neither decays the
    state (exp(0 * a) = 1) nor feeds it, so y and the final state are the
    unpadded scan's.  A longer sequence must be a multiple of ``chunk``,
    as JAX asserts.  The padding is made on every device, so the CPU runs
    the code the card does."""
    L = x.shape[1]
    pad = -L % 4 if L < chunk else 0
    if pad:
        x, dt, b_mat, c_mat = (F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
                               for t in (x, dt, b_mat, c_mat))
    y, h = ssd_k.ssd_scan(x.transpose(1, 2), dt.transpose(1, 2), a_neg, b_mat,
                          c_mat, chunk=chunk)
    return y.transpose(1, 2)[:, :L], h


# ---------------------------------------------------------------------------
# Tuning registry
# ---------------------------------------------------------------------------
# Every op the paper's "choose the computation algorithm" procedure can pick
# between: ``tune_inputs(op)`` builds representative kernel-layout inputs,
# ``tune_candidates(op)`` the named variants (the CUDA kernel against the
# plain version, and one kernel variant per chunk for the scan), with the
# JAX package's shapes and keys (``pallas*`` is ``kernel*`` here).

TUNABLE_OPS = ("flash_attention", "decode_attention",
               "paged_decode_attention", "ssd_scan")


def tune_inputs(op: str, *, seed: int = 0, batch: int = 1, seq: int = 128,
                heads: int = 2, head_dim: int = 64, ssm_p: int = 32,
                ssm_n: int = 16, device="cuda", dtype=torch.bfloat16):
    """Representative random inputs for ``op`` in KERNEL layout (B,H,S,D),
    drawn from a ``torch.Generator`` seeded with ``seed`` on ``device``.

    The shapes are the JAX package's.  The type is not: its inputs are
    fp32, which the port's CUDA kernels refuse (they take bf16, see
    ``_launch.check_inputs``), so every kernel variant would raise and the
    procedure would quietly choose the plain version.  The default here is
    bf16; ``a_neg`` stays fp32 and positions and tables int32."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    if op == "flash_attention":
        return (normal(batch, heads, seq, head_dim),
                normal(batch, heads, seq, head_dim),
                normal(batch, heads, seq, head_dim))
    if op == "decode_attention":
        pos = torch.full((batch,), seq - 1, dtype=torch.int32, device=dev)
        return (normal(batch, heads, head_dim),
                normal(batch, heads, seq, head_dim),
                normal(batch, heads, seq, head_dim), pos)
    if op == "paged_decode_attention":
        bs = 16
        nb = max(seq // bs, 1)
        n_pool = 2 * batch * nb  # half-occupied pool, non-contiguous tables
        q = normal(batch, heads, head_dim)
        k_pool = normal(n_pool, heads, bs, head_dim)
        v_pool = normal(n_pool, heads, bs, head_dim)
        table = torch.randperm(n_pool, generator=g, device=dev)[: batch * nb]
        pos = torch.full((batch,), nb * bs - 1, dtype=torch.int32, device=dev)
        return (q, k_pool, v_pool,
                table.reshape(batch, nb).to(torch.int32), pos)
    if op == "ssd_scan":
        x = normal(batch, heads, seq, ssm_p)
        dt = torch.nn.functional.softplus(
            torch.randn((batch, heads, seq), generator=g, device=dev)).to(dtype)
        a_neg = -torch.exp(torch.randn((heads,), generator=g, device=dev) * 0.5)
        return (x, dt, a_neg, normal(batch, seq, ssm_n),
                normal(batch, seq, ssm_n))
    raise KeyError(f"unknown tunable op {op!r}; known: {TUNABLE_OPS}")


def tune_candidates(op: str, *, ssd_chunks=(32, 64, 128)):
    """Named algorithm variants for ``op``, each a callable on the tensors
    from :func:`tune_inputs`.  ``kernel*`` variants launch the CUDA kernel
    on CUDA tensors (and run the plain version on CPU tensors, as every
    wrapper does); ``ref`` and ``gather_ref`` are the plain versions."""

    def scale(q):
        return 1.0 / (q.shape[-1] ** 0.5)

    if op == "flash_attention":
        return {
            "kernel": lambda q, k, v: fa_k.flash_attention(
                q, k, v, scale=scale(q)),
            "ref": lambda q, k, v: ref.flash_attention_ref(
                q, k, v, scale=scale(q)),
        }
    if op == "decode_attention":
        return {
            "kernel": lambda q, k, v, pos: dec_k.decode_attention(
                q, k, v, pos, scale=scale(q)),
            "ref": lambda q, k, v, pos: ref.decode_attention_ref(
                q, k, v, pos, scale=scale(q)),
        }
    if op == "paged_decode_attention":
        return {
            "kernel": lambda q, kp, vp, tbl, pos: dec_k.paged_decode_attention(
                q, kp, vp, tbl, pos, scale=scale(q)),
            "gather_ref": lambda q, kp, vp, tbl, pos:
                ref.paged_decode_attention_ref(q, kp, vp, tbl, pos,
                                               scale=scale(q)),
        }
    if op == "ssd_scan":
        def chunk_variant(c):
            return lambda *a: ssd_k.ssd_scan(*a, chunk=c)
        out = {f"kernel_chunk{c}": chunk_variant(c) for c in ssd_chunks}
        out["ref"] = lambda *a: ref.ssd_scan_ref(*a)
        return out
    raise KeyError(f"unknown tunable op {op!r}; known: {TUNABLE_OPS}")
