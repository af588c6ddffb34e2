"""The yardstick of the MLA + MoE family and of the attention core, from
the configuration file's sizes, beside ``bench/flops.py``.

Model FLOPs count the work the model needs on this card, not what the
program does: 6 * N * T over the matrix parameters a token meets (the
untied head, not the embedding lookup; the routed experts at the
assignments to held experts that capacity kept, as the program counts
them in ``moe.kept``, or else at their expected share, k * experts_held /
num_experts of them a token), plus the attention core's sequence work,
forward times 3.  Recompute is not counted.

- the attention core, a layer forward: 2 * T * (S / 2) * H * (d_qk + d_v)
  (scores over the causal half at the q/k head dim, then the values);
- the held experts' GEMMs, forward: 2 * 3 * D * F an assignment kept.
  How many are kept follows the routing: T * k * held / E a MoE layer
  if it is balanced and none is dropped, far fewer where the tokens
  crowd onto a few experts.

A kernel's share of its roofline counts its forward 4 times: forward,
block remat's recompute, and a backward of twice the forward.
"""
from __future__ import annotations

from typing import Dict, Optional

from bench import flops
from bench.weights_mla_moe import held

PASSES = 4  # forward, recompute, backward (twice the forward)


def _m(config: Dict):
    return config["model"]


def mla_matrix_params(m: Dict) -> int:
    D, H = int(m["d_model"]), int(m["num_heads"])
    qlr, kvlr = int(m["q_lora_rank"]), int(m["kv_lora_rank"])
    nope, rdim, vdim = (int(m["qk_nope_head_dim"]), int(m["qk_rope_head_dim"]),
                        int(m["v_head_dim"]))
    return (D * qlr + qlr * H * (nope + rdim) + D * (kvlr + rdim)
            + kvlr * H * (nope + vdim) + H * vdim * D)


def routed_params(config: Dict) -> int:
    """Matrix parameters of one routed expert (an assignment's)."""
    m = _m(config)
    return 3 * int(m["d_model"]) * int(m["moe_d_ff"])


def expected_assignments(config: Dict, batch: int, seq: int) -> float:
    """Assignments to held experts a step over every MoE layer, were the
    routing balanced: T * k * held / E a layer."""
    m = _m(config)
    L = int(m["num_layers"]) - int(m["first_k_dense"])
    return L * batch * seq * int(m["top_k"]) * held(m) \
        / int(m["num_experts"])


def matrix_params(config: Dict) -> float:
    """Matrix parameters a token meets on this card, the routed experts at
    their expected share."""
    m = _m(config)
    D, V = int(m["d_model"]), int(m["vocab_size"])
    P = int(m["first_k_dense"])
    L = int(m["num_layers"]) - P
    E, K, F = int(m["num_experts"]), int(m["top_k"]), int(m["moe_d_ff"])
    dense = mla_matrix_params(m) + 3 * D * int(m["d_ff"])
    moe = (mla_matrix_params(m) + D * E
           + 3 * D * F * int(m["num_shared_experts"])
           + K * held(m) / E * routed_params(config))
    return P * dense + L * moe + D * V


def attn_core_flops_fwd(config: Dict, batch: int, seq: int
                        ) -> Optional[float]:
    """The attention core's forward FLOPs a step over every attention
    layer (granite's GQA or MLA); None for a model without attention."""
    m = _m(config)
    if config["mixer"] == "attn":
        return flops.mixer_flops_fwd(config, batch, seq)
    if config["mixer"] != "mla_moe":
        return None
    d_qk = int(m["qk_nope_head_dim"]) + int(m["qk_rope_head_dim"])
    return int(m["num_layers"]) * 2.0 * batch * seq * (seq / 2) \
        * int(m["num_heads"]) * (d_qk + int(m["v_head_dim"]))


def expert_flops_fwd(config: Dict, kept: float) -> float:
    """The held experts' GEMMs, forward, over ``kept`` assignments."""
    return kept * 2.0 * routed_params(config)


def train_flops(config: Dict, batch: int, seq: int,
                kept: Optional[float] = None) -> float:
    """Model FLOPs of one training step over ``batch`` rows of ``seq``;
    the routed experts at ``kept`` assignments a step (every MoE layer),
    or at their expected share where ``kept`` is None."""
    T = batch * seq
    routed = 0.0 if kept is None else \
        (kept - expected_assignments(config, batch, seq)) \
        * routed_params(config)
    return 6.0 * (matrix_params(config) * T + routed) \
        + 3.0 * attn_core_flops_fwd(config, batch, seq)
