"""Mixture-of-Experts MLP with sort-based capacity dispatch and the dense
SwiGLU MLP (the port of ``repro.models.moe``; arctic's parallel dense +
MoE form is composed in ``blocks.py``, as in JAX), and its expert-parallel
form: :func:`_local_expert_pass` (the tokens through one shard's
experts) and :func:`moe_mlp_sharded` (JAX's ``shard_map`` body over the
port's ``Group``s: an all-gather of the tokens, the local experts, a
reduce-scatter of the partial sums).

Dispatch is gather/scatter, not a one-hot einsum: assignments are sorted
by expert (stable), each expert takes at most ``C`` of them into an
``(E, C, D)`` buffer, and the experts run as grouped einsums.  The
port's dispatch and combine pick JAX's assignments and JAX's order of
additions, and are deterministic on the card: no index a backward pass
accumulates into is hit twice (see :func:`moe_mlp`).

A device may hold fewer experts than the router routes over
(``cfg.experts_held``: one card's share of expert parallelism, the first
``experts_held`` of each layer): every token is still routed over all
``num_experts`` with the same capacity, the held experts compute their
kept assignments, and an assignment to an expert not held adds nothing.
There is no exchange, so this is a one-card cut, not a mesh layout;
:func:`moe_mlp_sharded` refuses it.

Inside ``model/mlp`` the pieces are spans of their own
(``models/spans.py``): ``moe/route``, ``moe/dispatch``, ``moe/experts``,
``moe/combine`` and ``moe/shared``; the counters ``moe.kept`` and
``moe.dropped`` add up the assignments to held experts that capacity
kept and dropped.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import spmd
from repro_torch.models import spans
from repro_torch.models.common import ParamSpec, swish


# ---------------------------------------------------------------------------
# Dense SwiGLU MLP
# ---------------------------------------------------------------------------


def dense_mlp_specs(d_model: int, d_ff: int, layers: int) -> Dict[str, ParamSpec]:
    L, la = (layers,), ("layers",)
    return {
        "w_gate": ParamSpec(L + (d_model, d_ff), la + ("embed", "ff")),
        "w_up": ParamSpec(L + (d_model, d_ff), la + ("embed", "ff")),
        "w_down": ParamSpec(L + (d_ff, d_model), la + ("ff", "embed")),
    }


def dense_mlp(p, x):
    return (swish(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def held_experts(cfg: ModelConfig) -> int:
    """The experts a device holds of each layer: ``experts_held``, or all
    ``num_experts`` where it is 0."""
    if not 0 <= cfg.experts_held <= cfg.num_experts:
        raise ValueError(f"experts_held {cfg.experts_held} is not within "
                         f"the {cfg.num_experts} experts")
    return cfg.experts_held or cfg.num_experts


def moe_specs(cfg: ModelConfig, layers: int) -> Dict[str, ParamSpec]:
    D, F_, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    H = held_experts(cfg)
    L, la = (layers,), ("layers",)
    s = {
        "router": ParamSpec(L + (D, E), la + ("embed", None), scale=0.1),
        "w_gate": ParamSpec(L + (H, D, F_), la + ("experts", "embed", None)),
        "w_up": ParamSpec(L + (H, D, F_), la + ("experts", "embed", None)),
        "w_down": ParamSpec(L + (H, F_, D), la + ("experts", None, "embed")),
    }
    if cfg.num_shared_experts:
        s["shared"] = dense_mlp_specs(D, cfg.moe_d_ff * cfg.num_shared_experts, layers)
    return s


def _router_topk(logits: torch.Tensor, top_k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits (T, E) -> (weights (T,k) fp32, experts (T,k), aux_loss scalar).

    Softmax in fp32, top-k, renormalise; the Switch-style load-balance aux
    ``E * sum_e f_e * p_e`` on the top-1 proxy.  Among equal probabilities
    the lower expert index comes first, as ``jax.lax.top_k`` orders them
    (a stable descending sort; ``torch.topk`` makes no such promise)."""
    probs = torch.softmax(logits.float(), dim=-1)
    idx = torch.sort(probs.detach(), dim=-1, descending=True,
                     stable=True).indices[:, :top_k]
    w = torch.gather(probs, -1, idx)
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    E = logits.shape[-1]
    me = probs.mean(dim=0)  # mean router prob per expert
    fe = F.one_hot(idx[:, 0], E).float().mean(dim=0)  # top-1 fraction
    aux = E * torch.sum(fe * me)
    return w, idx, aux


def route(p, xf: torch.Tensor, cfg: ModelConfig, capacity_factor: float):
    """The dispatch plan of tokens xf (T, D): (w, idx, aux) from the
    router, and per assignment in expert-sorted order ``order`` (indices
    into the flat (T*K,) assignments), its ``slot`` in the (E*C + 1)-row
    buffer (E*C is the drop bin), ``keep`` and its weight ``sw``."""
    T = xf.shape[0]
    E, K = cfg.num_experts, cfg.top_k
    w, idx, aux = _router_topk(xf @ p["router"], K)
    C = max(int(capacity_factor * T * K / E) + 1, 4)  # JAX's float order
    flat_e = idx.reshape(-1)  # (T*K,)
    order = torch.argsort(flat_e, stable=True)
    se, sw = flat_e[order], w.reshape(-1)[order]
    # position of each assignment within its expert group
    expert_start = torch.searchsorted(se, torch.arange(E, device=se.device))
    pos = torch.arange(T * K, device=se.device) - expert_start[se]
    keep = pos < C
    slot = torch.where(keep, se * C + pos, torch.full_like(se, E * C))
    return {"w": w, "idx": idx, "aux": aux, "C": C, "order": order,
            "slot": slot, "keep": keep, "sw": sw, "se": se}


def moe_mlp(p, x, cfg: ModelConfig, *, capacity_factor: float = 1.25):
    """x (B, S, D) -> ((B, S, D), aux); sort-based dispatch with
    per-expert capacity ``C = max(int(cf * T * K / E) + 1, 4)``: the held
    experts' pass (:func:`_local_expert_pass` over the first
    :func:`held_experts`, all E unless ``cfg.experts_held``), and the
    shared experts whole."""
    B, S, D = x.shape
    out, aux = _local_expert_pass(
        x.reshape(B * S, D), p["router"], p["w_gate"], p["w_up"],
        p["w_down"], cfg, capacity_factor, 0, held_experts(cfg))
    out = out.to(x.dtype).reshape(B, S, D)
    if cfg.num_shared_experts:
        out = out + spans.layer(
            "moe/shared", lambda u: dense_mlp(p["shared"], u), x)
    return out, aux


def _local_expert_pass(xf, router_w, wg, wu, wd, cfg: ModelConfig,
                       capacity_factor: float, e_lo: int, e_loc: int):
    """Tokens xf (T, D) through the local experts ``[e_lo, e_lo + e_loc)``
    only (``wg``/``wu``/``wd`` hold those e_loc experts).  Returns
    (partial_out (T, D) fp32, aux); the caller sums the partials across
    expert shards.  Every token is routed over all E experts and keeps
    JAX's capacity, so the shards' partials sum to :func:`moe_mlp`'s.

    Deterministic where JAX's literal form is not on the card:

    * the assignments' inputs are ``xf`` expanded K times and permuted
      (JAX's ``xf[st]``, whose backward would accumulate K duplicates a
      token with atomics); the permutation's backward hits each row once;
    * the dispatch writes each kept local assignment to its own buffer
      row; only the drop bin is written twice, and it is cut away;
    * the combine gathers each token's K weighted rows (a permutation)
      and adds them in ascending expert order from fp32 zeros: the order
      XLA's ``.at[st].add`` applies them in on the CPU.  The drop row of
      the expert output stays a constant zero row, as in JAX, and an
      assignment to another shard's expert adds that zero.
    """
    T, D = xf.shape
    K = cfg.top_k

    def routed(x):
        r = route({"router": router_w}, x, cfg, capacity_factor)
        return r["sw"], r

    sw, r = spans.layer("moe/route", routed, xf)
    C, order, se = r["C"], r["order"], r["se"]
    held = (se >= e_lo) & (se < e_lo + e_loc)
    local = held & r["keep"]
    spans.count("moe.kept", lambda: local.sum())
    spans.count("moe.dropped", lambda: (held & ~r["keep"]).sum())
    slot = torch.where(local, r["slot"] - e_lo * C,
                       torch.full_like(se, e_loc * C))

    def dispatch(x):
        xs = x[:, None].expand(T, K, D).reshape(T * K, D)[order]
        buf = x.new_zeros((e_loc * C + 1, D)).index_put((slot,), xs)
        return buf[: e_loc * C].reshape(e_loc, C, D)

    def experts(h):
        y = torch.einsum(
            "ecf,efd->ecd",
            swish(torch.einsum("ecd,edf->ecf", h, wg))
            * torch.einsum("ecd,edf->ecf", h, wu),
            wd)
        return torch.cat([y.reshape(e_loc * C, D), y.new_zeros((1, D))],
                         dim=0)

    # combine: v[i] is sorted assignment i's weighted output (fp32); a
    # token's assignments sit at the sorted positions inv[t*K:(t+1)*K],
    # whose ascending order is ascending expert order
    def combine(y, w):
        v = (y[slot] * torch.where(local, w, 0.0)[:, None]).float()
        inv = torch.empty_like(order)
        inv[order] = torch.arange(T * K, device=order.device)
        v_tok = v[torch.sort(inv.reshape(T, K), dim=-1).values]  # (T, K, D)
        out = torch.zeros((T, D), dtype=torch.float32, device=xf.device)
        for j in range(K):
            out = out + v_tok[:, j]
        return out

    h = spans.layer("moe/dispatch", dispatch, xf)
    y = spans.layer("moe/experts", experts, h)
    return spans.layer("moe/combine", combine, y, sw), r["aux"]


def moe_mlp_sharded(p, x, cfg: ModelConfig, *, mesh, axis: str = "model",
                    capacity_factor: float = 1.25, seq_sharded: bool = True):
    """Expert-parallel MoE as one rank (JAX's ``moe_mlp_sharded``, its
    ``shard_map`` body written over the port's groups).

    ``mesh``: this rank's ``distributed.spmd.ShardContext``; ``p`` holds
    the router whole and this rank's E/tp experts (``experts`` on
    ``axis``); ``x`` is this rank's (B/dp, S/tp, D) sequence shard
    (``seq_sharded``, JAX's layout) or all of its tokens (B/dp, S, D),
    replicated over ``axis`` (decode).  Each expert shard all-gathers the
    tokens once, runs only its local experts (:func:`_local_expert_pass`
    at ``e_lo = index * E/tp``), and the fp32 partials are reduce-scattered
    back onto the sequence shards (all-reduced when replicated); ``aux``
    is averaged over the batch's axes and ``axis`` (every axis, unless a
    batch smaller than the data axes is whole on every rank).  The
    capacity is a shard's: T is its B/dp * S tokens, as in JAX."""
    if cfg.experts_held:
        raise ValueError(
            f"experts_held {cfg.experts_held}: a held share of the experts "
            "is a one-card cut with no exchange, not a mesh layout; shard "
            "the experts over the mesh's axis instead")
    ctx = mesh
    g = ctx.group(axis)
    tp = ctx.size(axis)
    E = cfg.num_experts
    e_loc = p["w_gate"].shape[0]
    if e_loc * tp != E:
        raise ValueError(f"{E} experts do not split into {tp} shards of "
                         f"{e_loc}")
    x_full = spmd.gather_dim(x, g, 1) if seq_sharded else spmd.copy_to(x, g)
    Bl, Sl, D = x_full.shape
    out, aux = _local_expert_pass(
        x_full.reshape(Bl * Sl, D), p["router"], p["w_gate"], p["w_up"],
        p["w_down"], cfg, capacity_factor, ctx.index(axis) * e_loc, e_loc)
    out = out.reshape(Bl, Sl, D)
    out = (spmd.scatter_dim(out, g, 1) if seq_sharded
           else spmd.reduce_from(out, g)).to(x.dtype)
    aux = spmd.pmean(aux, ctx.group(ctx.rule("batch") + (axis,)))
    if cfg.num_shared_experts:
        shared = spans.layer(
            "moe/shared", lambda u: dense_mlp(p["shared"], u),
            spmd.gather_dim(x, g, 1) if seq_sharded else spmd.copy_to(x, g))
        out = out + (spmd.scatter_dim(shared, g, 1) if seq_sharded
                     else spmd.reduce_from(shared, g))
    return out, aux


def moe_mlp_ref(p, x, cfg: ModelConfig):
    """The all-experts plain reference (no capacity; test-only): every
    expert on every token, then each token's top-k outputs weighted."""
    B, S, D = x.shape
    xf = x.reshape(-1, D)
    w, idx, _ = _router_topk(xf @ p["router"], cfg.top_k)
    all_y = torch.einsum(
        "ecf,efd->ecd",
        swish(torch.einsum("td,edf->etf", xf, p["w_gate"]))
        * torch.einsum("td,edf->etf", xf, p["w_up"]),
        p["w_down"])  # (E, T, D)
    picked = all_y[idx, torch.arange(xf.shape[0], device=x.device)[:, None]]
    out = torch.sum(picked * w[..., None], dim=1).to(x.dtype).reshape(B, S, D)
    if cfg.num_shared_experts:
        out = out + dense_mlp(p["shared"], x)
    return out
