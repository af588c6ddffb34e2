"""Model-layout wrappers for the kernels (the port of ``repro.kernels.ops``).

Model code passes (B, S, H, D) tensors; the kernels take (B, H, S, D).
The wrappers hand the kernels transposed *views* (the CUDA kernels read
through strides), so no layout copy is made on the card.
"""
from __future__ import annotations

from repro_torch.kernels import decode_attention as dec_k
from repro_torch.kernels import flash_attention as fa_k


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
