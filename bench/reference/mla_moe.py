"""Plain fp32 reference of DeepSeek-V2 (arXiv:2405.04434) as one card's
share of expert parallelism, written from the published description and
the configuration file, in plain PyTorch.  It imports nothing of the
program.

- the embedding; ``first_k_dense`` dense layers, then the MoE layers;
  each layer a pre-norm multi-head latent attention and a pre-norm MLP,
  each added to the residual; a final RMSNorm and the untied head;
- MLA: q = RMSNorm(x W_dq) W_uq, split per head into 128 + 64 (RoPE);
  [c_kv | k_rope] = x W_dkv, c_kv RMSNorm'd and lifted by W_ukv to the
  heads' k (128) and v (128); the one 64-dim RoPE key shared by every
  head; a causal softmax at scale 1/sqrt(192); the output projection;
- the dense layer's MLP: a SwiGLU of width ``d_ff``;
- the MoE layer: the router's logits over all ``num_experts``, softmax
  in fp32, a stable descending top-k (the lower expert first among equal
  probabilities) and the k weights renormalised; the Switch-style aux
  ``E * sum_e f_e p_e`` on the top-1 choice; capacity first come within
  each expert: the assignments in token order, each expert keeping its
  first ``C = max(int(1.25 T k / E) + 1, 4)`` of the T tokens given; only
  the first ``experts_held`` experts compute (the share of this card: an
  assignment to another card's expert adds nothing), each a SwiGLU of
  width ``moe_d_ff`` weighted by its assignment's weight; the shared
  experts, one SwiGLU of width ``num_shared_experts * moe_d_ff``, added
  whole;
- the loss: the mean next-token cross-entropy plus 0.01 times the MoE
  layers' summed aux.

Top-k is not continuous: where a token's k-th and (k+1)-th experts lie
within fp32's rounding of each other, two sound computations route it
differently, and through first-come capacity the tokens after it, and
their gradients part by far more than rounding.  Given the routes of the
computation under test, the reference takes them for the tokens whose
ranking differs from its own only among near-tied logits (within
:data:`TIE`, its own logits at every rank) and reports how many it took
and how far apart each differing token's logits lay; a ranking that
differs by more stays the reference's own.

Departures from the published model (each listed in the configuration
file's ``assumed``): the router is the program's (softmax top-k,
renormalised, no group-limited choice, no routed scaling factor), one
balance loss in place of the published three, first-come capacity in
place of dropping by affinity, plain RoPE without YaRN, RMSNorm scales
as (1 + w).

Attention is computed a block of query rows at a time, under
checkpoint: each row's plain softmax over all its keys, so no online
rescaling and the same mathematics, at a block's memory.  The capacity
rule depends on the tokens given together, so a batch's rows are taken
together.  Numerics (``reference/model.py``) give the control.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from bench.reference import model as ref
from bench.reference import train as ref_train

AUX_WEIGHT = 0.01  # the aux loss's weight in the training loss
CAPACITY_FACTOR = 1.25
QUERY_ROWS = 512  # query rows a block of the attention
# Router logits closer than this are a tie: fp32's rounding moves a logit
# (~N(0, 1) at these inits) by ~1e-6 between two orders of summation, so a
# token whose k-th and (k+1)-th experts lie closer goes either way
# (PERF.md, section 2, gives the distances measured on the card).
TIE = 1e-4


def _causal_rows(q, k, v, lo: int, scale: float, num: ref.Numerics):
    """Query rows [lo, lo + r): q (B, r, H, dqk) against the keys of
    positions [0, lo + r), k (B, lo + r, H, dqk) and v (B, lo + r, H, dv)."""
    r, n = q.shape[1], k.shape[1]
    s = num.mm(q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1)) * scale
    later = (torch.arange(n, device=q.device)[None, :]
             > torch.arange(lo, lo + r, device=q.device)[:, None])
    s = s.masked_fill(later, float("-inf"))
    return num.mm(torch.softmax(s, dim=-1), v.permute(0, 2, 1, 3)).permute(
        0, 2, 1, 3)


def mla(u, p: Dict[str, torch.Tensor], m: Dict, num: ref.Numerics):
    B, S, D = u.shape
    H = int(m["num_heads"])
    qlr, kvlr = int(m["q_lora_rank"]), int(m["kv_lora_rank"])
    nope, rdim, vdim = (int(m["qk_nope_head_dim"]), int(m["qk_rope_head_dim"]),
                        int(m["v_head_dim"]))
    eps, theta = float(m["norm_eps"]), float(m["rope_theta"])
    cq = ref.rms_norm(num.mm(u, p["mixer/wq_down"]), p["mixer/q_norm"], eps)
    q = num.mm(cq, p["mixer/wq_up"].reshape(qlr, -1)).reshape(
        B, S, H, nope + rdim)
    q = torch.cat([q[..., :nope], ref.rope(q[..., nope:], theta)], dim=-1)
    ckv = num.mm(u, p["mixer/wkv_down"])
    c = ref.rms_norm(ckv[..., :kvlr], p["mixer/kv_norm"], eps)
    k_rope = ref.rope(ckv[..., kvlr:][:, :, None, :], theta)  # (B, S, 1, r)
    kv = num.mm(c, p["mixer/wkv_up"].reshape(kvlr, -1)).reshape(
        B, S, H, nope + vdim)
    k = torch.cat([kv[..., :nope], k_rope.expand(B, S, H, rdim)], dim=-1)
    v = kv[..., nope:]
    scale = 1.0 / math.sqrt(nope + rdim)
    o = torch.cat([
        checkpoint(_causal_rows, q[:, lo: lo + QUERY_ROWS],
                   k[:, : lo + QUERY_ROWS], v[:, : lo + QUERY_ROWS], lo,
                   scale, num, use_reentrant=False)
        for lo in range(0, S, QUERY_ROWS)], dim=1)
    return num.mm(o.reshape(B, S, H * vdim), p["mixer/wo"].reshape(-1, D))


def swiglu(x, p: Dict[str, torch.Tensor], pre: str, num: ref.Numerics):
    return num.mm(ref.silu(num.mm(x, p[pre + "w_gate"]))
                  * num.mm(x, p[pre + "w_up"]), p[pre + "w_down"])


def near_ties(logits, idx, prefer):
    """Of ``prefer`` (another computation's experts (T, k), ranked as
    ``idx``): the rows that differ from ``idx`` only among near-tied
    experts, whose logits here lie within :data:`TIE` of each other at
    every rank; and the largest such distance of each row that differs.
    None for each where ``prefer`` is not of the batch's shape."""
    if prefer is None or prefer.shape != idx.shape:
        return None, None
    prefer = prefer.to(idx.device)
    gap = (torch.gather(logits, -1, prefer)
           - torch.gather(logits, -1, idx)).abs().amax(dim=-1)
    differ = (prefer != idx).any(dim=-1)
    return differ & (gap <= TIE), gap[differ]


def route(x, router, m: Dict, num: ref.Numerics, prefer=None):
    """(weights (T, k), experts (T, k), aux, ties) of tokens x (T, D).
    Where ``prefer`` ranks a token's experts otherwise only among
    near-tied logits (:func:`near_ties`), the token takes its ranking:
    ``ties`` is then (the tokens taken, the distance of each token whose
    ranking differed), else None."""
    E, K = int(m["num_experts"]), int(m["top_k"])
    logits = num.mm(x, router).float()
    probs = torch.softmax(logits, dim=-1)
    idx = torch.sort(probs.detach(), dim=-1, descending=True,
                     stable=True).indices[:, :K]
    take, gaps = near_ties(logits.detach(), idx, prefer)
    ties = None
    if take is not None:
        idx = torch.where(take[:, None], prefer.to(idx.device), idx)
        ties = (int(take.sum()), gaps.tolist())
    w = torch.gather(probs, -1, idx)
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    top1 = torch.zeros_like(probs).scatter_(-1, idx[:, :1], 1.0)
    aux = E * torch.sum(top1.mean(dim=0) * probs.mean(dim=0))
    return w, idx, aux, ties


def moe(u, p: Dict[str, torch.Tensor], m: Dict, num: ref.Numerics,
        routes: Dict, layer: int, prefer=None):
    """The MoE MLP of the held experts and the shared experts; returns
    (out, aux) and leaves the layer's experts in ``routes[layer]`` and,
    given ``prefer``, its near ties in ``routes[("ties", layer)]``."""
    B, S, D = u.shape
    T = B * S
    E, K = int(m["num_experts"]), int(m["top_k"])
    held = int(m.get("experts_held", 0)) or E
    x = u.reshape(T, D)
    w, idx, aux, ties = route(x, p["mlp/router"], m, num, prefer)
    routes[layer] = idx.detach()
    if ties is not None:
        routes[("ties", layer)] = ties
    C = max(int(CAPACITY_FACTOR * T * K / E) + 1, 4)
    flat_e, flat_w = idx.reshape(-1), w.reshape(-1)
    out = torch.zeros_like(x)
    for e in range(held):
        at = torch.nonzero(flat_e == e)[:C, 0]  # its first C, token order
        tok = at // K
        ye = swiglu(x[tok], {n: p["mlp/" + n][e]
                             for n in ("w_gate", "w_up", "w_down")}, "", num)
        out = out.index_add(0, tok, ye * flat_w[at][:, None])
    out = out.reshape(B, S, D)
    if int(m["num_shared_experts"]):
        out = out + swiglu(u, p, "mlp/shared/", num)
    return out, aux


def dense_layer(h, p, m: Dict, num: ref.Numerics):
    eps = float(m["norm_eps"])
    h = h + num.q(mla(ref.rms_norm(h, p["mixer_norm"], eps), p, m, num))
    return num.q(h + swiglu(ref.rms_norm(h, p["mlp_norm"], eps), p, "mlp/",
                            num))


def moe_layer(h, p, m: Dict, num: ref.Numerics, routes: Dict, layer: int,
              prefer=None):
    eps = float(m["norm_eps"])
    h = h + num.q(mla(ref.rms_norm(h, p["mixer_norm"], eps), p, m, num))
    out, aux = moe(ref.rms_norm(h, p["mlp_norm"], eps), p, m, num, routes,
                   layer, prefer)
    return num.q(h + out), aux


def _layer_params(params: Dict, prefix: str, i: int) -> Dict:
    return {k[len(prefix):]: v[i] for k, v in params.items()
            if k.startswith(prefix)}


def block_loss(config: Dict, params: Dict, tokens, labels, num: ref.Numerics,
               total: int, routes: Dict, prefer: Optional[List] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the NLL summed over ``tokens`` (B, S) over ``total``, the MoE
    layers' summed aux); ``prefer``: each MoE layer's experts (T, k) of
    another computation, taken at near ties."""
    m = config["model"]
    V, P = int(m["vocab_size"]), int(m["first_k_dense"])
    h = num.q(params["embed"][tokens])
    for i in range(P):
        lp = _layer_params(params, "prelude/", i)
        h = checkpoint(lambda x, *vals, keys=tuple(lp): dense_layer(
            x, dict(zip(keys, vals)), m, num), h, *lp.values(),
            use_reentrant=False)
    aux = torch.zeros((), device=h.device)
    for i in range(int(m["num_layers"]) - P):
        lp = _layer_params(params, "slots/slot0/", i)
        pref = prefer[i] if prefer is not None and i < len(prefer) \
            else None
        h, a = checkpoint(lambda x, *vals, keys=tuple(lp), i=i, pref=pref:
                          moe_layer(x, dict(zip(keys, vals)), m, num, routes,
                                    i, pref), h, *lp.values(),
                          use_reentrant=False)
        aux = aux + a
    h = ref.rms_norm(h, params["final_norm"], float(m["norm_eps"]))
    logits = num.mm(h, params["lm_head"])
    cols = torch.arange(logits.shape[-1], device=logits.device)
    logits = logits.masked_fill(cols >= V, float("-inf"))
    nll = torch.logsumexp(logits, dim=-1) - torch.gather(
        logits, -1, labels[..., None])[..., 0]
    return nll.sum() / total, aux


def per_layer(flat: Dict[str, torch.Tensor]) -> Dict:
    """The reference's own parameters: a copy of each leaf, the stacked
    layer leaves (``prelude/``, ``slots/``) split into per-layer tensors."""
    out: Dict = {}
    for path, t in flat.items():
        if path.startswith(("prelude/", "slots/")):
            out[path] = [t[i].detach().clone().float().requires_grad_()
                         for i in range(t.shape[0])]
        else:
            out[path] = t.detach().clone().float().requires_grad_()
    return out


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
           prefer: Optional[List[List[torch.Tensor]]] = None) -> Dict:
    """Run ``steps`` reference steps from ``flat0`` ({path: initial
    tensor}, copied, never written) on ``batches`` (tokens, labels) on the
    device, each batch's rows together.  Returns what the comparison reads
    (``reference/train.py::follow``'s keys) and ``routes``: each step's
    experts (T, k) of each MoE layer.  Given ``prefer`` (each step's
    experts of each MoE layer as the computation under test routed them),
    a token whose ranking differs from it only at near ties takes that
    ranking, and ``ties`` holds, a step and MoE layer, (the tokens taken,
    the logit distance of each token whose ranking differed)."""
    opt = config["optimizer"]
    num = ref.Numerics(numerics)
    params = per_layer(flat0)
    leaves = ref.tensors(params)
    m = [torch.zeros_like(p) for p in leaves]
    v = [torch.zeros_like(p) for p in leaves]
    losses, grad, raw, routes = [], {}, {}, []
    for k in range(steps):
        tokens, labels = batches[k]
        routes.append({})
        nll, aux = block_loss(config, params, tokens, labels, num,
                              tokens.numel(), routes[-1],
                              prefer[k] if prefer is not None else None)
        loss = nll + AUX_WEIGHT * aux
        loss.backward()
        losses.append(float(loss.detach()))
        if k == 0:
            raw = _norms(params, lambda t: t.grad)
        scale = ref_train.adamw_step(opt, leaves, m, v, k + 1)
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
    layers = int(config["model"]["num_layers"]) \
        - int(config["model"]["first_k_dense"])
    out = {"losses": losses, "grad_norms": grad, "raw_grad_norms": raw,
           "change_norms": change,
           "routes": [[r[i] for i in range(layers) if i in r]
                      for r in routes]}
    if prefer is not None:
        out["ties"] = [[r.get(("ties", i)) for i in range(layers)]
                       for r in routes]
    return out
