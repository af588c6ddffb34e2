"""The model's spans: ``model/embed``, ``model/block`` (one remat unit, a
cycle of slots), ``model/mixer``, ``model/mlp`` and ``model/head_loss``,
on the process's current tracer (``obs.trace.current()``, set by the
train step for its duration), so no model function takes a tracer.

Each span's name carries its phase, so a profile alone tells them apart:
``<name>@fwd`` in the forward pass, ``<name>@recompute`` when block remat
runs the layer again inside the backward pass (on the autograd engine's
thread), and ``<name>@bwd`` for the layer's backward.  The backward span
is opened by an identity autograd function at the layer's output when
the output's gradient arrives, and closed by one at the layer's input
when the input's gradient leaves.  They are applied only while the
current tracer is enabled: a disabled tracer adds no autograd node.
"""
from __future__ import annotations

import torch

from repro_torch.obs import trace


class _Backward:
    """A layer's backward span, opened and closed by the identities."""

    __slots__ = ("tracer", "name", "span")

    def __init__(self, tracer: trace.Tracer, name: str):
        self.tracer, self.name, self.span = tracer, name, None

    def open(self) -> None:
        if self.span is None:
            self.span = self.tracer.span(self.name)
            self.span.__enter__()

    def close(self) -> None:
        if self.span is not None:
            self.span.__exit__(None, None, None)
            self.span = None


class _OnGrad(torch.autograd.Function):
    """The identity; its backward calls ``action`` as the gradient passes."""

    @staticmethod
    def forward(ctx, x, action):
        ctx.action = action
        return x.detach()

    @staticmethod
    def backward(ctx, g):
        ctx.action()
        return g, None


def _in_backward() -> bool:
    """Whether the calling thread runs inside a backward pass (block
    remat's recompute)."""
    return torch._C._current_graph_task_id() >= 0


def layer(name: str, fn, x):
    """``fn(x)`` inside span ``name``: ``x`` is the layer's input tensor
    (the backward span closes when its gradient leaves), and the output
    (or the first element of a tuple output) is the layer's output."""
    tr = trace.current()
    if not tr.enabled:
        return fn(x)
    recompute = _in_backward()
    bwd = None
    if not recompute and torch.is_grad_enabled() and x.requires_grad:
        bwd = _Backward(tr, f"{name}@bwd")
        x = _OnGrad.apply(x, bwd.close)
    with tr.span(f"{name}@{'recompute' if recompute else 'fwd'}"):
        out = fn(x)
    if bwd is None:
        return out
    first = out[0] if isinstance(out, tuple) else out
    if not first.requires_grad:
        return out
    first = _OnGrad.apply(first, bwd.open)
    return (first,) + tuple(out[1:]) if isinstance(out, tuple) else first
