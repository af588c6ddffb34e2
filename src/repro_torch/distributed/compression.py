"""Gradient compression (the port of ``repro.distributed.compression``):
shrink S_p before it hits the wire.

Each compressor is a per-rank transform applied to the local gradient
before the sync collective (compress -> decompress -> sync), so the
collectives stay fp32 while the wire cost Lemma 3.2 prices is the
compressed size:

- ``bf16``  — round to bf16 and back, round-to-nearest-even as JAX's
  ``lax.reduce_precision`` (2x). Stateless.
- ``int8``  — per-leaf symmetric int8 quantization (4x) with error
  feedback: the residual is carried to the next step.
- ``topk``  — magnitude top-k sparsification (keep ``ratio`` of the
  entries; wire ~ 2*ratio for value + index) with error feedback.

Error-feedback state is a tree shaped like the gradients, kept in the
rank's optimizer state under ``"ef"`` (``optim.adamw.init_state(...,
error_feedback=True)``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.models.common import tree_items, tree_map, tree_unflatten


@dataclass(frozen=True)
class Compressor:
    """Named compressor: (grads, ef_state) -> (decompressed grads, new ef).
    ``ef_state`` is None for stateless compressors; ``wire_ratio`` is the
    compressed-bytes / fp32-bytes factor of the Lemma 3.2 prediction."""

    name: str
    wire_ratio: float
    stateful: bool
    _apply: Callable[[Any, Optional[Any]], Tuple[Any, Optional[Any]]]

    def apply(self, grads, ef_state=None):
        return self._apply(grads, ef_state)

    def wire_bytes(self, s_p: float) -> float:
        return s_p * self.wire_ratio


def _identity(grads, ef):
    return grads, ef


def _bf16(grads, ef):
    return tree_map(lambda g: g.float().to(torch.bfloat16).float(), grads), ef


def _with_ef(fn):
    """(leaf transform v -> kept) -> a compressor body with error
    feedback: v = g + e is compressed, v - kept carries over."""

    def apply(grads, ef):
        if ef is None:
            ef = tree_map(torch.zeros_like, grads)
        kept, resid = [], []
        for (path, g), (_, e) in zip(tree_items(grads), tree_items(ef)):
            v = g.float() + e
            k = fn(v)
            kept.append((path, k))
            resid.append((path, v - k))
        return tree_unflatten(kept), tree_unflatten(resid)

    return apply


def _int8(v):
    scale = torch.clamp(v.abs().max(), min=1e-12) / 127.0
    return torch.clamp(torch.round(v / scale), -127, 127) * scale


def _topk(ratio: float):
    def sparsify(v):
        flat = v.reshape(-1)
        k = max(int(flat.numel() * ratio), 1)
        thresh = torch.topk(flat.abs(), k).values[-1]
        return (flat * (flat.abs() >= thresh).float()).reshape(v.shape)

    return sparsify


def get_compressor(name: str, *, topk_ratio: float = 0.1) -> Compressor:
    if name in ("none", "", None):
        return Compressor("none", 1.0, False, _identity)
    if name == "bf16":
        return Compressor("bf16", 0.5, False, _bf16)
    if name == "int8":
        return Compressor("int8", 0.25, True, _with_ef(_int8))
    if name == "topk":
        # value (4 B) + index (4 B) per kept entry
        return Compressor("topk", 2.0 * topk_ratio, True,
                          _with_ef(_topk(topk_ratio)))
    raise KeyError(f"unknown compressor {name!r}; known: {COMPRESSORS}")


COMPRESSORS: Tuple[str, ...] = ("none", "bf16", "int8", "topk")
