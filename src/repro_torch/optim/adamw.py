"""Optimizers over the fp32 master parameters (the port of
``repro.optim.adamw``): ``adamw`` (default) and ``momentum`` (the
paper-era SGD with momentum), with JAX's warmup-then-cosine schedule and
global-norm clipping.

The update order and the decoupled decay are JAX's, written out in plain
tensor ops per leaf (``torch.optim`` orders and decays differently).
Unlike JAX's functional update, :func:`apply_updates` writes the new
parameters and moments into the tensors it is given, as XLA does when the
train step donates them (``donate_argnums``): at full width a second copy
of the masters and moments would not fit beside the first.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.common import tree_items, tree_map

KINDS = ("adamw", "momentum")


@dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"  # adamw | momentum
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    momentum: float = 0.9
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def schedule(opt: OptConfig, step: int) -> float:
    """Linear warmup + cosine decay, in float32 arithmetic as JAX's."""
    f32 = np.float32
    step = f32(step)
    warm = min(step / f32(max(opt.warmup_steps, 1)), f32(1.0))
    frac = np.clip((step - f32(opt.warmup_steps))
                   / f32(max(opt.total_steps - opt.warmup_steps, 1)),
                   f32(0.0), f32(1.0))
    return float(f32(opt.lr) * warm * f32(0.5)
                 * (f32(1.0) + np.cos(f32(np.pi) * frac, dtype=f32)))


def init_state(opt: OptConfig, params, *,
               error_feedback: bool = False) -> Dict[str, Any]:
    """``{"step": 0, "m": ..., "v": ...}`` with fp32 zeros shaped like
    ``params``.  ``error_feedback=True`` adds an ``"ef"`` slot for
    gradient-compression residuals (``repro_torch.distributed.
    compression``); it rides through :func:`apply_updates` untouched."""
    if opt.kind not in KINDS:
        raise ValueError(opt.kind)

    def zeros():
        return tree_map(torch.zeros_like, params)

    state: Dict[str, Any] = {"step": 0, "m": zeros()}
    if opt.kind == "adamw":
        state["v"] = zeros()
    if error_feedback:
        state["ef"] = zeros()
    return state


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32 (a 0-d tensor on
    the leaves' device; no host sync)."""
    sq = [torch.sum(torch.square(g.float())) for _, g in tree_items(grads)]
    return torch.sqrt(torch.stack(sq).sum())


def _clip_scale(grads, max_norm: float):
    """(min(1, max_norm / norm), norm), both 0-d tensors."""
    gn = global_norm(grads)
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0), gn


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / norm), norm); new tensors."""
    scale, gn = _clip_scale(grads, max_norm)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), gn


def apply_updates(opt: OptConfig, params, grads, state):
    """Returns (params, state, grad_norm), with ``params`` and the moments
    updated in place.  Grads may be bf16; each leaf is taken to fp32 and
    clipped on its own (a temporary per leaf, not per tree).  Other state
    keys (``"ef"``) pass through untouched."""
    scale = gnorm = None
    if opt.grad_clip:
        scale, gnorm = _clip_scale(grads, opt.grad_clip)
    step = int(state["step"]) + 1
    lr = schedule(opt, step)
    leaves = zip(*[[t for _, t in tree_items(tree)]
                   for tree in (params, grads, state["m"],
                                state.get("v", state["m"]))])
    t = np.float32(step)
    bc1 = float(np.float32(1) - np.float32(opt.b1) ** t)
    bc2 = float(np.float32(1) - np.float32(opt.b2) ** t)
    with torch.no_grad():
        for p, g, m, v in leaves:
            g = g.float()
            if scale is not None:
                g = g * scale
            if opt.kind == "adamw":
                m.mul_(opt.b1).add_(g, alpha=1 - opt.b1)
                v.mul_(opt.b2).addcmul_(g, g, value=1 - opt.b2)
                u = (m / bc1).div_(torch.sqrt(v / bc2).add_(opt.eps))
            else:
                u = m.mul_(opt.momentum).add_(g).clone()
            p.add_(u.add_(p, alpha=opt.weight_decay), alpha=-lr)
    if gnorm is None:
        gnorm = torch.zeros((), dtype=torch.float32)
    return params, dict(state, step=step), gnorm
