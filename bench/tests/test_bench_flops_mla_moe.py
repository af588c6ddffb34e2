"""The MLA + MoE family's yardstick and weights against hand counts at
DeepSeek-V2's published widths (one card's share: 1 dense + 4 MoE layers,
20 of 160 experts, 12,800 vocabulary rows), and its layout against the
program's parameter tree."""
from __future__ import annotations

import pytest

from bench import flops, flops_mla_moe, harness, weights_mla_moe

CONF = "deepseek-v2-ep8-share-fp32"
D, H, QL, KVL, NOPE, ROPE, VD = 5120, 128, 1536, 512, 128, 64, 128
MLA = (D * QL + QL * H * (NOPE + ROPE) + D * (KVL + ROPE)
       + KVL * H * (NOPE + VD) + H * VD * D)


def test_parameters_on_the_card_by_hand():
    c = harness.config(CONF)
    assert MLA == 149_225_472
    mla_all = MLA + 2 * D + QL + KVL  # two block norms, q and kv norms
    dense = mla_all + 3 * D * 12288
    moe = mla_all + D * 160 + 20 * 3 * D * 1536 + 3 * D * 3072
    assert dense == 337_981_440 and moe == 669_102_080
    every = dense + 4 * moe + 2 * 12800 * D + D
    assert weights_mla_moe.count(c) == every == 3_145_466_880
    # fp32 weights, gradients and two moments
    assert 16 * every / 1e9 == pytest.approx(50.33, abs=0.01)


def test_model_flops_by_hand():
    c = harness.config(CONF)
    T = 4096
    routed = 6 * 20 / 160 * 3 * D * 1536  # a token's expected share
    n = (MLA + 3 * D * 12288) + 4 * (MLA + D * 160 + 3 * D * 3072 + routed) \
        + D * 12800
    assert flops_mla_moe.matrix_params(c) == n == 1_263_206_400
    core = 5 * 2 * T * (T / 2) * H * (NOPE + ROPE + VD)
    assert flops_mla_moe.attn_core_flops_fwd(c, 1, T) == core
    assert flops_mla_moe.train_flops(c, 1, T) == 6 * n * T + 3 * core
    assert flops_mla_moe.train_flops(c, 1, T) == pytest.approx(4.13525e13,
                                                               rel=1e-5)
    expected = 4 * T * 6 * 20 / 160
    assert flops_mla_moe.expected_assignments(c, 1, T) == expected == 12_288
    assert flops_mla_moe.expert_flops_fwd(c, expected) \
        == expected * 2 * 3 * D * 1536 == 579_820_584_960
    # at the kept assignments the routed experts' share follows them
    assert flops_mla_moe.train_flops(c, 1, T, kept=expected) == \
        flops_mla_moe.train_flops(c, 1, T)
    assert flops_mla_moe.train_flops(c, 1, T) - flops_mla_moe.train_flops(
        c, 1, T, kept=0) == 6 * expected * 3 * D * 1536


def test_granite_attention_core_is_the_mixers_work():
    g = harness.config("granite-3-2b-fp32")
    assert flops_mla_moe.attn_core_flops_fwd(g, 2, 4096) == \
        flops.mixer_flops_fwd(g, 2, 4096) == 40 * 2 * 8192 * 2048 * 32 * 128
    assert flops_mla_moe.attn_core_flops_fwd(
        harness.config("mamba2-780m-fp32"), 16, 2048) is None


def test_layout_is_the_programs():
    from repro_torch.models import model as M
    from repro_torch.models.common import tree_items

    from bench.drivers import shared

    c = harness.config(CONF)
    cfg = shared.program_config(c)
    assert (cfg.num_experts, cfg.experts_held, cfg.num_layers) == (160, 20, 5)
    weights_mla_moe.check_layout(c, {"/".join(p): s.shape for p, s in
                                     tree_items(M.model_specs(cfg))})
    shapes = dict((p, s) for p, s, _, _ in weights_mla_moe.layout(c))
    assert shapes["slots/slot0/mlp/w_gate"] == (4, 20, D, 1536)
    assert shapes["slots/slot0/mlp/router"] == (4, D, 160)
    assert shapes["prelude/mlp/w_down"] == (1, 12288, D)


def test_a_layout_that_differs_is_refused():
    c = harness.config(CONF)
    shapes = {p: s for p, s, _, _ in weights_mla_moe.layout(c)}
    shapes["slots/slot0/mlp/w_up"] = (4, 160, D, 1536)  # every expert
    with pytest.raises(ValueError):
        weights_mla_moe.check_layout(c, shapes)
    with pytest.raises(ValueError):
        weights_mla_moe.layout(harness.config("granite-3-2b-fp32"))


def test_the_file_is_the_catalogs_config_with_its_cut_named():
    """Every number of the published config.json under its own key,
    except the keys named in ``reduced``."""
    c = harness.config(CONF)
    published = {"first_k_dense_replace": 1, "hidden_size": 5120,
                 "intermediate_size": 12288, "kv_lora_rank": 512,
                 "moe_intermediate_size": 1536, "n_group": 8,
                 "n_shared_experts": 2, "num_attention_heads": 128,
                 "num_experts_per_tok": 6, "num_key_value_heads": 128,
                 "q_lora_rank": 1536, "qk_nope_head_dim": 128,
                 "qk_rope_head_dim": 64, "rope_theta": 10000,
                 "routed_scaling_factor": 16, "topk_group": 3,
                 "v_head_dim": 128, "num_hidden_layers": 60,
                 "n_routed_experts": 160, "vocab_size": 102400}
    changed = {k for k, v in published.items() if c[k] != v}
    assert changed == {"num_hidden_layers", "n_routed_experts",
                       "vocab_size"} <= set(c["reduced"])
    assert {k: c["published"][k] for k in changed} == {
        k: published[k] for k in changed}
    m = c["model"]
    assert (m["num_layers"], m["experts_held"], m["vocab_size"]) == (
        c["num_hidden_layers"], c["n_routed_experts"], c["vocab_size"])
    assert m["num_experts"] == 160 and m["vocab_size"] * 8 == 102400
