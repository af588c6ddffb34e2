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

:func:`layer` spans a piece inside a layer the same way, outside the
``model/`` area so that a layer still holds every kernel of its pieces:
``attn/core`` (the attention core, ``models/attention.py``) and
``moe/route``, ``moe/dispatch``, ``moe/experts``, ``moe/combine`` and
``moe/shared`` (``models/moe.py``).  :func:`count` adds to a counter of
the current tracer in the forward pass (``moe.kept``, ``moe.dropped``);
the value stays on the device until the tracer's counts are read.
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
    """The identity on ``xs``; its backward calls ``action`` once, when the
    gradients of all of them have arrived."""

    @staticmethod
    def forward(ctx, action, *xs):
        ctx.action = action
        return tuple(x.detach() for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        ctx.action()
        return (None,) + gs


def _in_backward() -> bool:
    """Whether the calling thread runs inside a backward pass (block
    remat's recompute)."""
    return torch._C._current_graph_task_id() >= 0


def layer(name: str, fn, *xs):
    """``fn(*xs)`` inside span ``name``: ``xs`` are the layer's input
    tensors (the backward span closes when the gradients of all of them
    that take one have left), and the output (or the first element of a
    tuple output) is the layer's output."""
    tr = trace.current()
    if not tr.enabled:
        return fn(*xs)
    recompute = _in_backward()
    bwd = None
    grads = [i for i, x in enumerate(xs) if x.requires_grad]
    if not recompute and torch.is_grad_enabled() and grads:
        bwd = _Backward(tr, f"{name}@bwd")
        xs = list(xs)
        for i, x in zip(grads, _OnGrad.apply(bwd.close,
                                             *[xs[i] for i in grads])):
            xs[i] = x
    with tr.span(f"{name}@{'recompute' if recompute else 'fwd'}"):
        out = fn(*xs)
    if bwd is None:
        return out
    first = out[0] if isinstance(out, tuple) else out
    if not first.requires_grad:
        return out
    (first,) = _OnGrad.apply(bwd.open, first)
    return (first,) + tuple(out[1:]) if isinstance(out, tuple) else first


def count(name: str, value) -> None:
    """Add ``value()`` (a device tensor, not read here) to counter ``name``
    of the current tracer while it is enabled, in the forward pass only:
    block remat's recompute counts nothing twice."""
    tr = trace.current()
    if tr.enabled and not _in_backward():
        tr.count(name, value())
