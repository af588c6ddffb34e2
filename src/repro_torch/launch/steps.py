"""Step builders (train / prefill / decode) and the dry run's abstract
inputs: the port of ``repro.launch.steps``.

Gradients are taken with ``torch.autograd.grad`` with respect to detached
aliases of the fp32 masters (or, with ``bf16_grads``, of their bf16
compute copies), so the parameter tensors themselves carry no autograd
state between steps.

With ``run.shard`` (``distributed.spmd.ShardContext``) each step is one
rank's program on the leaves' local shapes; the train step then lands the
data-axis gradient sum on the ZeRO-1 layout (``embed`` on the data axes,
by reduce-scatter), runs the port's AdamW on this rank's shard of the
parameters and moments, and all-gathers the updated shard back to the
parameter layout.  :func:`input_specs`, :func:`abstract_params` and
:func:`abstract_opt_state` give one rank's arguments as ``meta`` tensors
(JAX's ``ShapeDtypeStruct`` stand-ins): the dry run's.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import spmd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as M
from repro_torch.models.blocks import RunConfig
from repro_torch.models.common import (abstractify, tree_items, tree_map,
                                       tree_unflatten)
from repro_torch.obs import trace
from repro_torch.optim import adamw as opt_lib


def build_grad_fn(cfg: ModelConfig, run: RunConfig, tracer=None):
    """(params, batch[, on_leaf]) -> (loss, metrics, grads), with microbatch
    gradient accumulation when ``run.microbatch > 0`` (the paper's X_mini
    knob): the batch splits into n = B // microbatch pieces, their
    gradients are summed in fp32 and divided by n.  Shared by
    :func:`build_train_step` and the data-parallel trainer, which calls it
    per rank.

    ``on_leaf(j, g)`` (optional) is called during the last microbatch's
    backward pass, as soon as autograd has finished leaf j's gradient (j
    in flatten order), with that leaf's final gradient: the tensor the
    returned tree holds.  A leaf the loss does not reach is not reported.

    ``tracer`` (``obs.trace``; None: ``PROFILER_TRACER``, whose spans
    exist only in a running ``torch.profiler``) is the process's current
    tracer while the gradients are taken, so the model opens its spans on
    it (``models/spans.py``); each pass is a ``train/forward`` span around
    the loss and a ``train/backward`` span around its gradient.

    Under ``run.shard``: one rank's gradients of the whole batch's loss,
    landed on the ZeRO-1 layout (:func:`_build_sharded_grad_fn`)."""
    tr = trace.PROFILER_TRACER if tracer is None else tracer
    if run.shard is not None:
        sharded = _build_sharded_grad_fn(cfg, run)

        def sharded_grads_of(params, batch):
            with trace.use(tr):
                return sharded(params, batch)

        return sharded_grads_of

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
        with tr.span("train/forward"):
            loss, metrics = M.loss_fn(tree_unflatten(items), batch, cfg, run)
        with tr.span("train/backward"):
            grads = torch_grad(loss, [p for _, p in items])
        return (loss.detach(), _detached(metrics),
                tree_unflatten((path, g) for (path, _), g in zip(items, grads)))

    def grads_of(params, batch, on_leaf=None):
        with trace.use(tr):
            return accumulated(params, batch, on_leaf)

    def accumulated(params, batch, on_leaf):
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
                     *, grad_sync=None, tracer=None):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``grad_sync`` (optional) is applied to the gradient tree between the
    backward pass and the optimizer update: the hook through which a
    gradient-sync strategy (``repro_torch.distributed``) runs its
    collectives.  The parameters and moments are updated in place
    (``optim.adamw.apply_updates``).  ``tracer`` (None:
    ``obs.trace.PROFILER_TRACER``): a ``train/step`` span a step, with the
    optimizer's step count, around :func:`build_grad_fn`'s spans and a
    ``train/optimizer`` span around the update."""
    tr = trace.PROFILER_TRACER if tracer is None else tracer
    if run.shard is not None:
        if grad_sync is not None:
            raise ValueError("a sharded step lands its own gradients; "
                             "grad_sync is for the data-parallel trainers")
        return _build_sharded_train_step(cfg, run, opt, tr)
    grads_of = build_grad_fn(cfg, run, tracer=tr)

    def train_step(params, opt_state, batch):
        with tr.span("train/step", step=opt_state.get("step")):
            loss, metrics, grads = grads_of(params, batch)
            if grad_sync is not None:
                grads = grad_sync(grads)
            with tr.span("train/optimizer"):
                params, opt_state, gnorm = opt_lib.apply_updates(
                    opt, params, grads, opt_state)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   **metrics}

    return train_step


def _build_sharded_grad_fn(cfg: ModelConfig, run: RunConfig):
    """(params, batch) -> (loss, metrics, grads) as one rank of
    ``run.shard``: the gradients of the rank's objective
    (``models.model._loss_sharded``), landed on the ZeRO-1 layout
    (``spmd.land_grads``): summed over every rank, they are the whole
    batch's.  ``loss`` and ``metrics`` are the whole batch's.

    With ``run.microbatch`` the unsharded path's semantics on the global
    batch: n = max(B // microbatch, 1) passes, pass i over microbatch i's
    rows spread over the batch ranks (``spmd.microbatches``), its CE
    normalised by microbatch i's global token count (the n counts
    all-reduced once, up front); the local gradients are summed in fp32,
    divided by n and landed once.  ``loss`` is then the mean of the
    passes' losses and ``metrics`` empty, as the unsharded path returns."""
    ctx = run.shard

    def grads_of(params, batch):
        src = M.cast_params(params, cfg) if run.bf16_grads else params
        items = [(path, p.detach().requires_grad_())
                 for path, p in tree_items(src)]
        tree, leaves = tree_unflatten(items), [p for _, p in items]
        if run.microbatch:
            B = batch["tokens"].shape[0] * ctx.size(ctx.rules["batch"])
            n = max(B // run.microbatch, 1)
            passes = spmd.microbatches(batch, n, ctx)
            counts = spmd.reduce_from(
                torch.stack([torch.sum(mb["labels"] >= 0) for mb in passes])
                .float(), ctx.group(ctx.rules["batch"]))
            grads, loss, metrics = None, 0.0, {}
            for i, mb in enumerate(passes):
                objective, m = M.loss_fn(tree, mb, cfg, run, count=counts[i])
                g = torch_grad(objective, leaves)
                grads = ([x.float() for x in g] if grads is None
                         else [a.add_(x) for a, x in zip(grads, g)])
                del g  # one pass's gradient alive at a time
                loss = loss + m["loss"].detach()
            grads, loss = [a.div_(n) for a in grads], loss / n
        else:
            objective, metrics = M.loss_fn(tree, batch, cfg, run)
            grads = torch_grad(objective, leaves)
            metrics = _detached(metrics)
            loss = metrics.pop("loss")
        grads = spmd.land_grads(
            tree_unflatten((path, g) for (path, _), g in zip(items, grads)),
            ctx)
        return loss, metrics, grads

    return grads_of


def _build_sharded_train_step(cfg: ModelConfig, run: RunConfig,
                              opt: opt_lib.OptConfig, tracer):
    """The train step as one rank of ``run.shard``: the landed gradients
    (:func:`_build_sharded_grad_fn`), clipped by the norm of the whole
    gradient, AdamW (``optim.adamw.apply_updates``, unchanged, its clip
    off since the shards' norm is not the gradient's) on this rank's
    shard, and the shard all-gathered back into the parameters."""
    ctx = run.shard
    grads_of = build_grad_fn(cfg, run, tracer=tracer)
    inner = dataclasses.replace(opt, grad_clip=0.0)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = grads_of(params, batch)
        gnorm = spmd.global_norm(grads, ctx)
        if opt.grad_clip:
            scale = torch.clamp(opt.grad_clip / torch.clamp(gnorm, min=1e-9),
                                max=1.0)
            grads = tree_unflatten((path, g.float() * scale)
                                   for path, g in tree_items(grads))
        shards = spmd.opt_shards(params, ctx)
        _, opt_state, _ = opt_lib.apply_updates(inner, shards, grads,
                                                opt_state)
        spmd.gather_params(params, ctx)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   **metrics}

    return train_step


def build_prefill_step(cfg: ModelConfig, run: RunConfig):
    """(params, batch) -> (last position's logits (B, 1, ...), caches).
    Sharded: this rank's vocab columns of the last position, its batch
    rows and its ``kv_seq`` slice of the caches."""
    def prefill_step(params, batch):
        with torch.no_grad():
            if run.shard is not None:
                logits, caches, _ = M.forward(params, batch, cfg, run,
                                              with_cache=True, last_only=True)
                return logits, caches
            logits, caches, _ = M.forward(params, batch, cfg, run,
                                          with_cache=True)
            return logits[:, -1:], caches

    return prefill_step


def build_decode_step(cfg: ModelConfig, run: RunConfig):
    """(params, tokens, pos, caches) -> (logits, caches), the caches
    written in place (``models.model.decode_step``)."""
    def decode_step(params, tokens, pos, caches):
        with torch.no_grad():
            return M.decode_step(params, tokens, pos, caches, cfg, run)

    return decode_step


# ---------------------------------------------------------------------------
# Abstract inputs (dry run): one rank's arguments as meta tensors
# ---------------------------------------------------------------------------


def token_shape(cfg: ModelConfig, batch: int, seq: int):
    if cfg.num_codebooks:
        return (batch, seq, cfg.num_codebooks)
    return (batch, seq)


def _local_batch(mesh, shape: ShapeConfig, batch: int) -> int:
    n = 1
    for a in mesh.axes(mesh_lib.batch_spec(mesh, shape)[0]):
        n *= mesh.shape[a]
    if batch % n:
        raise ValueError(f"batch {batch} does not divide over {n} ranks")
    return batch // n


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                rules: Optional[Dict[str, Any]] = None,
                kv_quant: bool = False) -> Dict[str, Any]:
    """One rank's model inputs for the (arch x input-shape) pair as meta
    tensors, JAX's dtypes (int32 tokens, bf16 image embeddings): the batch
    split as ``batch_spec`` gives, caches as the rules give."""
    if rules is None:
        rules = mesh_lib.sharding_rules(mesh, cfg, shape)
    B, S = shape.global_batch, shape.seq_len
    b = _local_batch(mesh, shape, B)

    def tok(seq):
        return torch.empty(token_shape(cfg, b, seq), dtype=torch.int32,
                           device="meta")

    if shape.kind in ("train", "prefill"):
        text_len = S - (cfg.num_image_tokens or 0)
        specs: Dict[str, Any] = {"tokens": tok(text_len)}
        if cfg.num_image_tokens:
            specs["image_embeds"] = torch.empty(
                (b, cfg.num_image_tokens, cfg.d_model), dtype=torch.bfloat16,
                device="meta")
        if shape.kind == "train":
            specs["labels"] = tok(text_len)
        return specs
    return {
        "tokens": tok(1),
        "pos": torch.empty((b,), dtype=torch.int32, device="meta"),
        "caches": abstractify(M.cache_specs(cfg, B, S, kv_quant=kv_quant),
                              mesh, rules),
    }


def abstract_params(cfg: ModelConfig, mesh, rules, dtype: Optional[str] = None):
    return abstractify(M.model_specs(cfg), mesh, rules, dtype_override=dtype)


def abstract_opt_state(cfg: ModelConfig, mesh, rules, opt: opt_lib.OptConfig):
    """Optimizer state: ZeRO-1, always sharded over the data axes on
    ``embed`` (``m`` and ``v`` for AdamW, ``m`` alone for momentum); the
    step count is a host int, as ``optim.adamw.init_state`` keeps it."""
    zrules = mesh_lib.zero_rules(mesh, rules)
    state: Dict[str, Any] = {"step": 0,
                             "m": abstractify(M.model_specs(cfg), mesh,
                                              zrules)}
    if opt.kind == "adamw":
        state["v"] = abstractify(M.model_specs(cfg), mesh, zrules)
    return state


def zero_state(cfg: ModelConfig, mesh, rules, opt: opt_lib.OptConfig,
               device) -> Dict[str, Any]:
    """A real optimizer state of :func:`abstract_opt_state`'s local shapes
    (zeros on ``device``), for one rank of a sharded run."""
    return {k: v if k == "step" else tree_map(
        lambda t: torch.zeros(t.shape, dtype=t.dtype, device=device), v)
        for k, v in abstract_opt_state(cfg, mesh, rules, opt).items()}
