"""The weights of the MLA + MoE family (``mixer`` ``"mla_moe"``:
DeepSeek-V2's block), laid out as the program's parameter tree for a
configuration file's sizes, beside ``bench/weights.py``'s two families.

Leaves: the embedding and the untied head over the (padded) vocabulary,
the final norm; ``prelude/...`` for the ``first_k_dense`` dense layers
(MLA and a SwiGLU of width ``d_ff``) and ``slots/slot0/...`` for the MoE
layers after them (MLA, the router over all ``num_experts``, the first
``experts_held`` routed experts, the shared experts as one SwiGLU of
width ``num_shared_experts * moe_d_ff``).  Each leaf is made from the
seed by ``weights.make_leaf``, at granite's scales but the embedding's
(:data:`EMBED_SCALE`); :func:`check_layout` holds the layout to
the program's ``models/model.py::model_specs`` before a run starts.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from bench import weights
from bench.weights import Leaf


# the embedding's scale: each token's own row carries the residual stream
# at random init, so the router spreads the tokens as their ids do (at
# granite's 0.02 the attention's near-uniform average of the prefix
# dominates and every token routes to the same few experts)
EMBED_SCALE = 1.0


def _mla(pre: str, L: int, m: Dict) -> List[Leaf]:
    D, H = int(m["d_model"]), int(m["num_heads"])
    qlr, kvlr = int(m["q_lora_rank"]), int(m["kv_lora_rank"])
    nope, rdim, vdim = (int(m["qk_nope_head_dim"]), int(m["qk_rope_head_dim"]),
                        int(m["v_head_dim"]))
    p = pre + "mixer/"
    return [(pre + "mixer_norm", (L, D), "normal", 0.1),
            (p + "wq_down", (L, D, qlr), "normal", D ** -0.5),
            (p + "q_norm", (L, qlr), "normal", 0.1),
            (p + "wq_up", (L, qlr, H, nope + rdim), "normal", qlr ** -0.5),
            (p + "wkv_down", (L, D, kvlr + rdim), "normal", D ** -0.5),
            (p + "kv_norm", (L, kvlr), "normal", 0.1),
            (p + "wkv_up", (L, kvlr, H, nope + vdim), "normal", kvlr ** -0.5),
            (p + "wo", (L, H, vdim, D), "normal", (H * vdim) ** -0.5)]


def _swiglu(p: str, lead: Tuple[int, ...], D: int, F: int) -> List[Leaf]:
    return [(p + "w_gate", lead + (D, F), "normal", D ** -0.5),
            (p + "w_up", lead + (D, F), "normal", D ** -0.5),
            (p + "w_down", lead + (F, D), "normal", F ** -0.5)]


def held(m: Dict) -> int:
    """The routed experts held of each MoE layer (0 in the file: all)."""
    return int(m.get("experts_held", 0)) or int(m["num_experts"])


def layout(config: Dict) -> List[Leaf]:
    """(path, shape, init, scale) of every leaf, in sorted path order."""
    if config["mixer"] != "mla_moe":
        raise ValueError(f"not an MLA + MoE configuration: {config['mixer']!r}")
    m = config["model"]
    D, V = int(m["d_model"]), weights.padded_vocab(m)
    P = int(m["first_k_dense"])
    L = int(m["num_layers"]) - P
    Fm = int(m["moe_d_ff"])
    out: List[Leaf] = [("embed", (V, D), "normal", EMBED_SCALE),
                       ("final_norm", (D,), "normal", 0.1),
                       ("lm_head", (D, V), "normal", D ** -0.5)]
    if P:
        out += _mla("prelude/", P, m)
        out += [("prelude/mlp_norm", (P, D), "normal", 0.1)]
        out += _swiglu("prelude/mlp/", (P,), D, int(m["d_ff"]))
    pre = "slots/slot0/"
    out += _mla(pre, L, m)
    out += [(pre + "mlp_norm", (L, D), "normal", 0.1),
            (pre + "mlp/router", (L, D, int(m["num_experts"])), "normal",
             D ** -0.5)]
    out += _swiglu(pre + "mlp/", (L, held(m)), D, Fm)
    if int(m["num_shared_experts"]):
        out += _swiglu(pre + "mlp/shared/", (L,), D,
                       Fm * int(m["num_shared_experts"]))
    if bool(m.get("tie_embeddings", False)):
        raise ValueError("a tied head is not laid out here")
    return sorted(out)


def make(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{path: fp32 tensor} of every leaf."""
    return {leaf[0]: weights.make_leaf(leaf, seed, device)
            for leaf in layout(config)}


def check_layout(config: Dict, program_shapes: Dict[str, Tuple[int, ...]]):
    """Raise unless the program's parameter tree has exactly this layout."""
    mine = {p: tuple(s) for p, s, _, _ in layout(config)}
    theirs = {p: tuple(s) for p, s in program_shapes.items()}
    if mine != theirs:
        diff = sorted(set(mine.items()) ^ set(theirs.items()))
        raise ValueError(f"the program's parameter layout differs from the "
                         f"benchmark's: {diff[:6]}")


def count(config: Dict) -> int:
    return sum(math.prod(s) for _, s, _, _ in layout(config))
