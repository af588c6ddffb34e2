"""Top-level decoder (the port of ``repro.models.model``): token embedding,
the ``first_k_dense`` prelude, the block stack, the LM head, the loss, and
the three entry points

  * ``forward``      — full-sequence logits (+ prefill caches)
  * ``loss_fn``      — masked next-token cross-entropy + 0.01 x MoE aux
  * ``decode_step``  — single-token cached decoding

Parameters for slot ``i`` are stacked over ``num_cycles`` (dim 0), as in
JAX; JAX's ``lax.scan`` over cycles is a Python loop over that dim here,
and ``remat="block"`` recomputes each cycle in the backward pass
(``torch.utils.checkpoint``, JAX's ``jax.checkpoint`` of the cycle).
``model_specs`` gives the parameter shapes of every architecture (the
planner prices the full model); :func:`init_params`, which every entry
point materializes through, refuses a model the port cannot run before
any parameter exists.  The prelude (``first_k_dense`` layers: slot 0's
mixer with the dense MLP at ``cfg.d_ff``) runs before the cycles in
every entry point, and the slots' MoE aux losses are summed over the
cycles, one at a time in layer order.  Attention and Mamba-2 slots mix
in one cycle (jamba): their caches sit side by side under ``slots``, a
Mamba slot's as its recurrent ``state`` and ``conv`` tail.

A multi-codebook model (musicgen) takes tokens (B, S, K): the embedding
sums its K tables' rows and the head gives logits (B, S, K, V).  An
image-prefix model (llava) takes ``batch["image_embeds"]`` (B, n_img,
D) before the text.  ``extend_step`` appends a chunk of prompt tokens to
linear caches (chunked prefill), on attention-only stacks
(``supports_extend``), as JAX's.

With ``run.shard`` (a ``distributed.spmd.ShardContext``) ``forward``,
``loss_fn`` and ``decode_step`` run as one rank of a mesh, on the
leaves' local shapes (``launch/steps.py`` builds the steps): the
vocab-parallel embedding and LM head, the residual sequence-sharded over
``model``, FSDP's per-layer gather, and a loss whose gradient summed over
the ranks is the whole batch's.  Without it, every path is the one above.

The embedding, each cycle, each mixer and MLP, and the head with the loss
are spans on the process's current tracer (``models/spans.py``), which
a train step sets for its duration.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, SlotSpec
from repro_torch.distributed import spmd
from repro_torch.models import spans
from repro_torch.models.blocks import (RunConfig, check_slot,
                                       slot_cache_specs, slot_decode,
                                       slot_extend, slot_forward, slot_specs)
from repro_torch.models.common import (ParamSpec, cross_entropy,
                                       local_shape, materialize, rms_norm,
                                       softcap, torch_dtype, tree_map)


def prelude_slot(cfg: ModelConfig) -> SlotSpec:
    """The ``first_k_dense`` layers' slot: slot 0's mixer, dense MLP."""
    return SlotSpec(cfg.pattern[0].mixer, "dense")


def supports_extend(cfg: ModelConfig) -> bool:
    """Whether the config runs chunked prefill (``extend_step``):
    attention-only stacks, as in JAX.  Mamba state folds the whole prefix
    and MLA decodes in absorbed-latent form, so both take whole-prompt
    prefill."""
    return all(s.mixer in ("attn", "swa") for s in cfg.pattern)


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def check_ported(cfg: ModelConfig) -> None:
    """Raise unless the port runs every layer of ``cfg`` (forward, decode,
    caches): every arch of the catalog passes."""
    for slot in cfg.pattern:
        check_slot(slot)


def init_params(cfg: ModelConfig, seed: int, device):
    """Random parameters of ``cfg`` (``materialize`` of its specs), after
    :func:`check_ported`: a model the port cannot run is refused before
    a byte is allocated."""
    check_ported(cfg)
    return materialize(model_specs(cfg), seed, device)


def model_specs(cfg: ModelConfig) -> Dict[str, Any]:
    V, D = cfg.padded_vocab, cfg.d_model
    s: Dict[str, Any] = {}
    if cfg.num_codebooks:
        s["embed"] = ParamSpec((cfg.num_codebooks, V, D), (None, "vocab", "embed"))
    else:
        s["embed"] = ParamSpec((V, D), ("vocab", "embed"))
    if cfg.first_k_dense:
        # prelude layers: same mixer as slot 0, dense MLP at cfg.d_ff
        s["prelude"] = slot_specs(cfg, prelude_slot(cfg), cfg.first_k_dense)
    cycles = main_cycles(cfg)
    s["slots"] = {
        f"slot{i}": slot_specs(cfg, slot, cycles)
        for i, slot in enumerate(cfg.pattern)
    }
    s["final_norm"] = ParamSpec((D,), ("embed",), init="zeros")
    if not cfg.tie_embeddings:
        if cfg.num_codebooks:
            s["lm_head"] = ParamSpec((cfg.num_codebooks, D, V), (None, "embed", "vocab"))
        else:
            s["lm_head"] = ParamSpec((D, V), ("embed", "vocab"))
    return s


def main_cycles(cfg: ModelConfig) -> int:
    return (cfg.num_layers - cfg.first_k_dense) // len(cfg.pattern)


def cache_specs(cfg: ModelConfig, batch: int, s_max: int,
                dtype: str = "bfloat16", kv_quant: bool = False) -> Dict[str, Any]:
    """Per-slot cache descriptors; ``kv_quant``: int8 GQA k/v with fp32
    per-(token, head) scales (MLA and Mamba slots keep ``dtype``)."""
    c: Dict[str, Any] = {}
    if cfg.first_k_dense:
        c["prelude"] = slot_cache_specs(cfg, prelude_slot(cfg),
                                        cfg.first_k_dense, batch, s_max,
                                        dtype, kv_quant)
    cycles = main_cycles(cfg)
    c["slots"] = {
        f"slot{i}": slot_cache_specs(cfg, slot, cycles, batch, s_max, dtype,
                                     kv_quant)
        for i, slot in enumerate(cfg.pattern)
    }
    return c


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def embed_tokens(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    tokens = batch["tokens"]
    if cfg.num_codebooks:  # (B,S,K) -> sum_k embed_k[token_k], in k order
        h = params["embed"][0][tokens[..., 0]]
        for k in range(1, cfg.num_codebooks):
            h = h + params["embed"][k][tokens[..., k]]
    else:
        h = params["embed"][tokens]
    if "image_embeds" in batch:  # (B, n_img, D) prefix before the text
        h = torch.cat([batch["image_embeds"].to(h.dtype), h], dim=1)
    if cfg.scale_embed:
        h = h * np.sqrt(cfg.d_model)
    return h.to(torch_dtype(cfg.dtype))


def lm_logits(params, h, cfg: ModelConfig, v_lo: int = 0):
    """(B,S,V) logits, or (B,S,K,V) for a K-codebook model.  ``v_lo``: the
    first vocab id of the head's columns, where they are one rank's slice
    of the vocabulary."""
    if cfg.num_codebooks:
        w = (params["embed"].transpose(1, 2) if cfg.tie_embeddings
             else params["lm_head"])
        logits = torch.einsum("bsd,kdv->bskv", h, w)
    else:
        w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        logits = h @ w
    if cfg.padded_vocab != cfg.vocab_size:  # mask padding columns
        cols = v_lo + torch.arange(logits.shape[-1], device=h.device)
        logits = logits.masked_fill(~(cols < cfg.vocab_size), -1e30)
    return softcap(logits, cfg.logit_softcap)


def cast_params(params, cfg: ModelConfig):
    """Compute-dtype parameters: every float32 leaf cast to ``cfg.dtype``.

    JAX casts its fp32 masters on every call.  Training does the same:
    ``forward`` casts inside the autograd graph each step, so the gradients
    land on the fp32 masters.  The serving engines call this once at load
    time and keep no fp32 copy (the values are identical); ``forward`` and
    ``decode_step`` then cost nothing for parameters already cast."""
    dt = torch_dtype(cfg.dtype)
    return tree_map(lambda a: a.to(dt) if a.dtype == torch.float32 else a,
                    params)


def _layer(tree, i: int):
    """Cycle ``i`` of a tree of stacked (cycles, ...) tensors, as views."""
    return tree_map(lambda a: a[i], tree)


def _layers(tree, n: int):
    """All ``n`` cycles of a tree of stacked tensors, as views.  One
    ``unbind`` per leaf, whose backward stacks the cycles' gradients once
    (a per-cycle ``a[i]`` would add a full-size zero-padded gradient per
    cycle)."""
    per_leaf = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda xs: xs[i], per_leaf) for i in range(n)]


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------


def positions_of(h: torch.Tensor) -> torch.Tensor:
    """Positions 0..S-1 of every row of ``h`` (B,S,...)."""
    B, S = h.shape[:2]
    return torch.arange(S, device=h.device)[None].expand(B, S)


def run_cycles(slots, h, positions, cfg: ModelConfig, run: RunConfig,
               n_cycles: int, with_cache: bool = False, aux=0.0,
               pattern=None):
    """The block stack over ``n_cycles`` stacked cycles of ``slots`` (the
    whole model's, or a pipeline stage's slice of it).  ``pattern`` is a
    list of (name, SlotSpec) pairs, each cycle's slots in order (default:
    ``slot{i}`` of ``cfg.pattern``); the prelude passes its one slot with
    ``slots`` as ``{"prelude": params["prelude"]}``.  Returns (h, the
    per-cycle caches when ``with_cache``, else [], aux): ``aux`` plus
    every slot's MoE aux loss, added one at a time in layer order, so a
    pipeline stage that starts from the previous stage's sum ends where
    the whole stack does."""
    if pattern is None:
        pattern = [(f"slot{i}", slot) for i, slot in enumerate(cfg.pattern)]

    def cycle(h, layer, aux):
        if run.shard is not None:  # FSDP: this cycle's leaves, gathered
            layer = {n: spmd.fsdp_gather(layer[n], run.shard.layer_spec(n),
                                         run.shard, 1) for n in layer}

        def slots_of(h):
            caches, a_sum = {}, aux
            for n, slot in pattern:
                h, caches[n], a = slot_forward(layer[n], h, positions, cfg,
                                               slot, run)
                a_sum = a_sum + a
            return h, caches, a_sum

        return spans.layer("model/block", slots_of, h)

    # remat only where there is a backward to recompute for (training)
    remat = run.remat == "block" and h.requires_grad and not with_cache
    per_cycle = []
    for layer in _layers(slots, n_cycles):
        if remat:
            h, aux = checkpoint(
                lambda x, a, lp=layer: cycle(x, lp, a)[::2], h, aux,
                use_reentrant=False, preserve_rng_state=False)
            continue
        h, caches, aux = cycle(h, layer, aux)
        if with_cache:
            per_cycle.append(caches)
    return h, per_cycle, aux


def run_prelude(params, h, positions, cfg: ModelConfig, run: RunConfig,
                with_cache: bool = False):
    """The ``first_k_dense`` prelude (no-op without one).  Returns (h, its
    per-layer caches when ``with_cache``); its dense slots carry no aux."""
    if not cfg.first_k_dense:
        return h, []
    h, per_layer, _ = run_cycles(
        {"prelude": params["prelude"]}, h, positions, cfg, run,
        cfg.first_k_dense, with_cache,
        pattern=[("prelude", prelude_slot(cfg))])
    return h, per_layer


def _stack_caches(per_cycle):
    """{name: {leaf: (cycles, ...)}} from a non-empty list of per-cycle
    caches."""
    return {n: {k: torch.stack([c[n][k] for c in per_cycle])
                for k in per_cycle[0][n]} for n in per_cycle[0]}


def head_logits(params, h, cfg: ModelConfig):
    """Final norm and LM head: ``params`` holds ``final_norm`` and the head
    (``embed`` when tied, else ``lm_head``)."""
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return lm_logits(params, h, cfg)


# the MoE aux loss's weight in the training loss (d loss / d aux)
AUX_WEIGHT = 0.01


def masked_loss(logits, labels, aux, aux_weight: float = AUX_WEIGHT):
    """(ce + aux_weight * aux, ce): the CE over ``labels`` >= 0."""
    mask = (labels >= 0).float()
    ce = cross_entropy(logits, torch.clamp(labels, min=0), mask)
    return ce + aux_weight * aux, ce


def _stack(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
           run: RunConfig, with_cache: bool):
    """Everything before the final norm: (the compute-dtype params, the
    last hidden state, positions, the FSDP-gathered top leaves under
    ``run.shard`` (else None), the prelude's and the cycles' caches, aux)."""
    check_ported(cfg)
    params = cast_params(params, cfg)
    ctx = run.shard
    top = None
    if ctx is None:
        h = spans.layer(
            "model/embed",
            lambda table: embed_tokens({**params, "embed": table}, batch, cfg),
            params["embed"])
        positions = positions_of(h)
    else:
        top = _top_leaves(params, ctx)
        h = _embed_sharded(top, batch, cfg, ctx, ctx.seq_parallel)
        s_full = batch["tokens"].shape[1] + (
            batch["image_embeds"].shape[1] if "image_embeds" in batch else 0)
        positions = torch.arange(s_full, device=h.device)[None].expand(
            h.shape[0], s_full)
    h, pre = run_prelude(params, h, positions, cfg, run, with_cache)
    h, per_cycle, aux = run_cycles(params["slots"], h, positions, cfg, run,
                                   main_cycles(cfg), with_cache)
    return params, h, positions, top, pre, per_cycle, aux


def forward(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            run: RunConfig, with_cache: bool = False, last_only: bool = False):
    """Full-sequence forward over ``batch["tokens"]`` (B,S) or (B,S,K),
    after ``batch["image_embeds"]`` (B,n_img,D) where given.  Returns
    (logits, caches, aux_loss); caches are stacked (cycles, B, S, ...) per
    slot (and (first_k_dense, B, S, ...) under ``prelude``).  Under
    ``run.shard`` the logits are this rank's vocab columns, and
    ``last_only`` gives the last position's alone (prefill)."""
    params, h, positions, top, pre, per_cycle, aux = _stack(
        params, batch, cfg, run, with_cache)
    ctx = run.shard
    if ctx is None:
        logits = head_logits(params, h, cfg)
    else:
        h = rms_norm(h, top["final_norm"], cfg.norm_eps)
        h = (spmd.last_token(h, ctx, ctx.seq_parallel) if last_only
             else spmd.enter(h, ctx, ctx.seq_parallel))
        logits = _logits_sharded(top, h, cfg, ctx)
    if not with_cache:
        return logits, None, aux
    if per_cycle:
        caches = {"slots": _stack_caches(per_cycle)}
    else:  # no cycle (a reduced config that is all prelude): zero-size
        # leaves, as JAX's scan over zero cycles gives
        B, S = positions.shape
        shape_of = (lambda sp: sp.shape) if ctx is None else (
            lambda sp: local_shape(sp, ctx.rules, ctx.mesh))
        caches = {"slots": tree_map(
            lambda sp: torch.zeros(shape_of(sp), dtype=torch_dtype(sp.dtype),
                                   device=h.device),
            cache_specs(cfg, B * (1 if ctx is None else ctx.size(
                ctx.rules["batch"])), S, cfg.dtype)["slots"])}
    if cfg.first_k_dense:
        caches["prelude"] = _stack_caches(pre)["prelude"]
    return logits, caches, aux


def loss_fn(params, batch, cfg: ModelConfig, run: RunConfig,
            aux_weight: float = AUX_WEIGHT, count=None):
    """Masked next-token CE. ``labels`` < 0 are ignored. For image-prefix
    inputs the prefix positions carry no labels (the labels are padded
    with -1 in front).  Returns (loss, {"ce", "aux"}).  ``count`` (under
    ``run.shard`` only): the global token count the CE is normalised by,
    where the caller counted it (a microbatch's); None: this batch's."""
    if run.shard is not None:
        logits, _, aux = forward(params, batch, cfg, run)
        return _loss_sharded(logits, _labels(batch), aux, aux_weight, cfg,
                             run.shard, count)
    params, h, _, _, _, _, aux = _stack(params, batch, cfg, run, False)
    labels = _labels(batch)
    loss, ce = spans.layer(
        "model/head_loss",
        lambda x: masked_loss(head_logits(params, x, cfg), labels, aux,
                              aux_weight), h)
    return loss, {"ce": ce, "aux": aux}


def _labels(batch):
    """The labels over the whole sequence: an image prefix carries none
    (-1 in front)."""
    labels = batch["labels"]
    if "image_embeds" in batch:
        n_img = batch["image_embeds"].shape[1]
        pad = labels.new_full(labels.shape[:1] + (n_img,) + labels.shape[2:],
                              -1)
        labels = torch.cat([pad, labels], dim=1)
    return labels


# ---------------------------------------------------------------------------
# One rank of a mesh (run.shard)
# ---------------------------------------------------------------------------


def _top_leaves(params, ctx):
    """The embedding, the head and the final norm, FSDP-gathered."""
    keys = [k for k in ("embed", "lm_head", "final_norm") if k in params]
    return spmd.fsdp_gather({k: params[k] for k in keys},
                            {k: ctx.specs[k] for k in keys}, ctx)


def _embed_sharded(top, batch, cfg: ModelConfig, ctx, seq: bool):
    """:func:`embed_tokens` over vocab-sharded tables: each rank looks up
    the tokens in its rows (zero elsewhere; an image prefix on model rank
    0 alone), and ``spmd.leave`` sums the partials onto the residual's
    layout (a reduce-scatter over the sequence under ``seq``)."""
    table, tokens = top["embed"], batch["tokens"]
    v_lo = spmd.vocab_lo(ctx, table.shape[-2])
    if cfg.num_codebooks:
        h = spmd.embed_partial(table[0], tokens[..., 0], v_lo)
        for k in range(1, cfg.num_codebooks):
            h = h + spmd.embed_partial(table[k], tokens[..., k], v_lo)
    else:
        h = spmd.embed_partial(table, tokens, v_lo)
    if "image_embeds" in batch:
        img = batch["image_embeds"].to(h.dtype)
        if ctx.index("model"):
            img = torch.zeros_like(img)
        h = torch.cat([img, h], dim=1)
    h = spmd.leave(h, ctx, seq)
    if cfg.scale_embed:
        h = h * np.sqrt(cfg.d_model)
    return h.to(torch_dtype(cfg.dtype))


def _logits_sharded(top, h, cfg: ModelConfig, ctx):
    """:func:`lm_logits` on this rank's vocab columns (h replicated over
    ``model``): (B,S,V/tp), or (B,S,K,V/tp)."""
    return lm_logits(top, h, cfg, spmd.vocab_lo(ctx, top["embed"].shape[-2]))


def _loss_sharded(logits, labels, aux, aux_weight: float, cfg: ModelConfig,
                  ctx, count=None):
    """One rank's share of the loss.  Returns (objective, metrics): the
    objective is this rank's CE sum over the global token count
    (``count``, else counted over the batch's ranks here; its vocab
    columns differentiated, Megatron's form) plus the weighted aux, whose
    gradients summed over the ranks are the whole batch's; the metrics
    hold the whole batch's ``loss``, ``ce`` and ``aux``."""
    v_lo = spmd.vocab_lo(ctx, logits.shape[-1])
    nll = spmd.vocab_parallel_nll(logits.float(), torch.clamp(labels, min=0),
                                  v_lo, ctx)
    mask = (labels >= 0).float()
    g_batch = ctx.group(ctx.rules["batch"])
    if count is None:
        count = spmd.reduce_from(torch.sum(mask), g_batch)
    ce = torch.sum(nll * mask) / torch.clamp(count, min=1.0)
    ce_all = spmd.reduce_from(ce.detach(), g_batch)
    aux_all = aux.detach() if torch.is_tensor(aux) else aux
    return ce + aux_weight * aux, {"ce": ce_all, "aux": aux_all,
                                   "loss": ce_all + aux_weight * aux_all}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def decode_step(params, tokens: torch.Tensor, pos: torch.Tensor, caches,
                cfg: ModelConfig, run: RunConfig,
                s_max: Optional[int] = None):
    """One decoding step.

    tokens (B,1) or (B,1,K) int; pos (B,) int absolute positions; caches
    as produced by ``cache_specs`` or placed by the engines, for
    ``s_max`` positions: a sliding-window slot's cache shorter than that
    is a ring and decodes on ``"dense"`` where ``run.attn_impl`` is
    ``"kernel"`` (``attention.decode_impl``; None: the caller does not
    say).  Returns (logits, new_caches).  The
    caches are written in place (each attention layer's new entries at
    ``pos``, each Mamba layer's whole state and conv tail); a cache whose
    dtype is narrower than the compute dtype is first widened, the dtype
    JAX's one-hot cache write promotes it to, so the returned tree may
    hold new tensors.  An int8 cache and its scales keep their dtypes, as
    JAX's scatter write keeps them."""
    check_ported(cfg)
    params = cast_params(params, cfg)
    ctx = run.shard
    if ctx is None:
        h = embed_tokens(params, {"tokens": tokens}, cfg)
    else:
        top = _top_leaves(params, ctx)
        h = _embed_sharded(top, {"tokens": tokens}, cfg, ctx, seq=False)

    def layer(name, tree, i):
        lp = _layer(tree, i)
        if ctx is not None:
            lp = spmd.fsdp_gather(lp, ctx.layer_spec(name), ctx, 1)
        return lp

    def widen(tree):
        if "k_scale" in tree:
            return dict(tree)
        return {k: c.to(torch.promote_types(c.dtype, h.dtype))
                for k, c in tree.items()}

    slot_names = [f"slot{i}" for i in range(len(cfg.pattern))]
    new = {"slots": {n: widen(caches["slots"][n]) for n in slot_names}}
    # the per-layer cache views alias the stacked tensors, so the in-place
    # writes land in the returned tree
    if cfg.first_k_dense:
        new["prelude"] = widen(caches["prelude"])
        pre = prelude_slot(cfg)
        for i in range(cfg.first_k_dense):
            h, _ = slot_decode(layer("prelude", params["prelude"], i), h,
                               pos, _layer(new["prelude"], i), cfg, pre, run,
                               s_max)
    for i in range(main_cycles(cfg)):
        for n, slot in zip(slot_names, cfg.pattern):
            h, _ = slot_decode(layer(n, params["slots"][n], i), h, pos,
                               _layer(new["slots"][n], i), cfg, slot, run,
                               s_max)
    if ctx is not None:
        h = rms_norm(h, top["final_norm"], cfg.norm_eps)
        return _logits_sharded(top, h, cfg, ctx), new
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = lm_logits(params, h, cfg)
    return logits, new


def extend_step(params, tokens: torch.Tensor, pos0: torch.Tensor, caches,
                cfg: ModelConfig, run: RunConfig):
    """Chunked prefill (JAX's ``extend_step``): append C prompt tokens to
    linear caches in one call.

    tokens (B,C) or (B,C,K) int; pos0 (B,) absolute position of the
    chunk's first token; caches linear (non-ring), written in place.
    Returns (logits (B,C,V), caches): logits[:, i] is the next-token
    distribution after absolute position pos0 + i, what a whole-prompt
    ``forward`` gives there."""
    if not supports_extend(cfg):
        raise NotImplementedError(
            f"{cfg.name}: chunked prefill needs an attention-only pattern")
    check_ported(cfg)
    params = cast_params(params, cfg)
    h = embed_tokens(params, {"tokens": tokens}, cfg)
    if cfg.first_k_dense:
        pre = prelude_slot(cfg)
        for i in range(cfg.first_k_dense):
            h, _ = slot_extend(_layer(params["prelude"], i), h, pos0,
                               _layer(caches["prelude"], i), cfg, pre, run)
    for i in range(main_cycles(cfg)):
        for j, slot in enumerate(cfg.pattern):
            n = f"slot{j}"
            h, _ = slot_extend(_layer(params["slots"][n], i), h, pos0,
                               _layer(caches["slots"][n], i), cfg, slot, run)
    return head_logits(params, h, cfg), caches
