"""The reference's training steps: the loss and gradients of a global
batch in blocks of rows, and AdamW with the warmup-cosine schedule and
the global-norm clip, written in the update order of the program's
``optim/adamw.py`` (clip, first moment, second moment, bias-corrected
step, decoupled decay on every leaf).

:func:`follow` runs ``steps`` steps from the benchmark's initial
parameters on the benchmark's batches and returns what the comparison
reads: each step's loss, the first step's clipped gradient per leaf, the
raw gradient's norm per leaf, and each leaf's change after the steps.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from bench.reference import model as ref


def schedule(opt: Dict, step: int) -> float:
    """Linear warmup and cosine decay, in float32 as the program's."""
    f32 = np.float32
    s = f32(step)
    warm = min(s / f32(max(opt["warmup_steps"], 1)), f32(1.0))
    frac = np.clip((s - f32(opt["warmup_steps"]))
                   / f32(max(opt["total_steps"] - opt["warmup_steps"], 1)),
                   f32(0.0), f32(1.0))
    return float(f32(opt["lr"]) * warm * f32(0.5)
                 * (f32(1.0) + np.cos(f32(np.pi) * frac, dtype=f32)))


def loss_and_grads(config: Dict, params: Dict, tokens, labels,
                   num: ref.Numerics, rows_per_block: int) -> float:
    """The mean NLL of the batch; the gradients accumulate in ``.grad``."""
    total = tokens.numel()
    loss = 0.0
    for lo in range(0, tokens.shape[0], rows_per_block):
        part = ref.block_nll_sum(config, params, tokens[lo: lo + rows_per_block],
                                 labels[lo: lo + rows_per_block], num) / total
        part.backward()
        loss += float(part.detach())
    return loss


def adamw_step(opt: Dict, leaves: Sequence[torch.Tensor], m, v, step: int):
    """One update of ``leaves`` in place from their ``.grad``; returns the
    clip scale."""
    with torch.no_grad():
        gnorm = torch.sqrt(sum(torch.sum(p.grad * p.grad) for p in leaves))
        scale = torch.clamp(opt["grad_clip"] / torch.clamp(gnorm, min=1e-9),
                            max=1.0) if opt["grad_clip"] else None
        lr = schedule(opt, step)
        t = np.float32(step)
        bc1 = float(np.float32(1) - np.float32(opt["b1"]) ** t)
        bc2 = float(np.float32(1) - np.float32(opt["b2"]) ** t)
        for p, mi, vi in zip(leaves, m, v):
            g = p.grad if scale is None else p.grad * scale
            mi.mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
            vi.mul_(opt["b2"]).addcmul_(g, g, value=1 - opt["b2"])
            u = (mi / bc1) / (torch.sqrt(vi / bc2) + opt["eps"])
            p.sub_(lr * (u + opt["weight_decay"] * p))
            p.grad = None
    return scale


def _norms(params: Dict, fn) -> Dict[str, float]:
    out = {}
    for path, v in params.items():
        parts = v if isinstance(v, list) else [v]
        out[path] = math.sqrt(sum(float(torch.sum(fn(t).double() ** 2))
                                  for t in parts))
    return out


def follow(config: Dict, flat0: Dict[str, torch.Tensor],
           batches: List[Tuple[torch.Tensor, torch.Tensor]], *,
           steps: int, numerics: str = "fp32",
           rows_per_block: int = 1) -> Dict:
    """Run ``steps`` reference steps; ``flat0`` is {path: initial tensor}
    (copied, never written), ``batches`` (tokens, labels) on the device."""
    opt = config["optimizer"]
    num = ref.Numerics(numerics)
    params = ref.per_layer(flat0, int(config["model"]["num_layers"]))
    leaves = ref.tensors(params)
    m = [torch.zeros_like(p) for p in leaves]
    v = [torch.zeros_like(p) for p in leaves]
    losses, grad, raw = [], {}, {}
    for k in range(steps):
        tokens, labels = batches[k]
        losses.append(loss_and_grads(config, params, tokens, labels, num,
                                     rows_per_block))
        if k == 0:
            raw = _norms(params, lambda t: t.grad)
        scale = adamw_step(opt, leaves, m, v, k + 1)
        if k == 0:  # the optimizer's first moment holds (1 - b1) * g
            s = 1.0 if scale is None else float(scale)
            grad = {p: n * s for p, n in raw.items()}
    change = {}
    for path, val in params.items():
        parts = val if isinstance(val, list) else [val]
        first = flat0[path] if isinstance(val, list) else [flat0[path]]
        change[path] = math.sqrt(sum(
            float(torch.sum((a.detach() - b.float()).double() ** 2))
            for a, b in zip(parts, first)))
    return {"losses": losses, "grad_norms": grad, "raw_grad_norms": raw,
            "change_norms": change}
