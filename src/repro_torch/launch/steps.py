"""Step builders for training (the port of ``repro.launch.steps``'s
``build_grad_fn`` and ``build_train_step``; the dry-run input specs stay
in the JAX package).

Gradients are taken with ``torch.autograd.grad`` with respect to detached
aliases of the fp32 masters (or, with ``bf16_grads``, of their bf16
compute copies), so the parameter tensors themselves carry no autograd
state between steps.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models.blocks import RunConfig
from repro_torch.models.common import tree_items, tree_unflatten
from repro_torch.optim import adamw as opt_lib


def build_grad_fn(cfg: ModelConfig, run: RunConfig):
    """(params, batch[, on_leaf]) -> (loss, metrics, grads), with microbatch
    gradient accumulation when ``run.microbatch > 0`` (the paper's X_mini
    knob): the batch splits into n = B // microbatch pieces, their
    gradients are summed in fp32 and divided by n.  Shared by
    :func:`build_train_step` and the data-parallel trainer, which calls it
    per rank.

    ``on_leaf(j, g)`` (optional) is called during the last microbatch's
    backward pass, as soon as autograd has finished leaf j's gradient (j
    in flatten order), with that leaf's final gradient: the tensor the
    returned tree holds.  A leaf the loss does not reach is not reported."""

    def value_and_grad(params, batch, hook=None):
        if run.bf16_grads:
            # mixed precision: differentiate wrt the bf16 compute params so
            # the gradient sync moves half the bytes; the optimizer applies
            # them to the fp32 masters
            params = M.cast_params(params, cfg)
        items = [(path, p.detach().requires_grad_())
                 for path, p in tree_items(params)]
        if hook is not None:
            for j, (_, p) in enumerate(items):
                p.register_hook(functools.partial(hook, j))
        loss, metrics = M.loss_fn(tree_unflatten(items), batch, cfg, run)
        grads = torch_grad(loss, [p for _, p in items])
        return (loss.detach(), _detached(metrics),
                tree_unflatten((path, g) for (path, _), g in zip(items, grads)))

    def grads_of(params, batch, on_leaf=None):
        if not run.microbatch:
            return value_and_grad(params, batch, on_leaf)
        B = batch["tokens"].shape[0]
        n = max(B // run.microbatch, 1)
        if B % n:
            raise ValueError(f"batch {B} does not split into {n} equal "
                             f"microbatches of {run.microbatch}")
        size = B // n
        acc: dict = {}  # leaf index -> fp32 running sum
        folded = set()  # leaves of the last microbatch folded by the hook

        def fold(j, x, first, last):
            acc[j] = x.float().clone() if first else acc[j].add_(x)
            return acc[j].div_(n) if last else acc[j]

        def hook(j, x):
            folded.add(j)
            on_leaf(j, fold(j, x, n == 1, True))

        lsum, paths = 0.0, []
        for i in range(n):
            mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            last = i == n - 1
            loss, _, g = value_and_grad(
                params, mb, hook if last and on_leaf is not None else None)
            paths = []
            for j, (path, x) in enumerate(tree_items(g)):
                paths.append(path)
                if j not in folded:
                    fold(j, x, i == 0, last)
            lsum = lsum + loss
        return lsum / n, {}, tree_unflatten((path, acc[j])
                                            for j, path in enumerate(paths))

    return grads_of


def torch_grad(loss, leaves, cotangent=None):
    """d loss / d leaves (the vector-Jacobian product with ``cotangent``
    when ``loss`` is not a scalar); a leaf the loss does not reach gets
    zeros, as ``jax.grad`` gives."""
    grads = torch.autograd.grad(loss, leaves, grad_outputs=cotangent,
                                allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)]


def _detached(metrics):
    return {k: v.detach() if hasattr(v, "detach") else v
            for k, v in (metrics or {}).items()}


def build_train_step(cfg: ModelConfig, run: RunConfig, opt: opt_lib.OptConfig,
                     *, grad_sync=None):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``grad_sync`` (optional) is applied to the gradient tree between the
    backward pass and the optimizer update: the hook through which a
    gradient-sync strategy (``repro_torch.distributed``) runs its
    collectives.  The parameters and moments are updated in place
    (``optim.adamw.apply_updates``)."""

    grads_of = build_grad_fn(cfg, run)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = grads_of(params, batch)
        if grad_sync is not None:
            grads = grad_sync(grads)
        params, opt_state, gnorm = opt_lib.apply_updates(opt, params, grads,
                                                         opt_state)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   **metrics}

    return train_step
