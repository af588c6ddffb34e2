"""The MLA + MoE family's driver and reference at a CPU size of the
DeepSeek-V2 cell (d_model 64, 4 heads, latents 32/16, 16 experts with 4
held, top-2, 1 dense + 2 MoE layers, vocab 300): the program against
the reference with seeded random weights (three compared steps), the
driver's line, each fault driving a run to ``correct`` false, the
control above the program, and the reference's imports."""
from __future__ import annotations

import copy
import time

import pytest

from conftest import ROOT  # noqa: F401  (the repository on the path)

from bench import check, harness
from bench import run as run_mod
from bench.drivers import train_mla_moe
from bench.reference import mla_moe as ref_mla_moe

CELL = "deepseek-v2-train-share-s4k-fp32"
TINY = dict(num_layers=3, first_k_dense=1, d_model=64, num_heads=4, d_ff=128,
            vocab_size=300, q_lora_rank=32, kv_lora_rank=16,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            num_experts=16, experts_held=4, top_k=2, moe_d_ff=32,
            num_shared_experts=2)


def tiny_run(*, seed: int = 2 ** 33 + 5, faults=(), batch: int = 1,
             seq: int = 64):
    r = harness.Run.of(CELL, seed, 0.2, False, time.time(), device="cpu",
                       faults=frozenset(faults))
    r.config = copy.deepcopy(r.config)
    r.config["model"].update(TINY)
    r.config["reduced"] = sorted(set(TINY) | set(r.config["reduced"]))
    r.traffic = dict(r.traffic, batch=batch, seq=seq, shard_tokens=4096)
    r.cell = dict(r.cell, reference_rows=batch)
    return r


def line_of(r, out):
    return run_mod.result(r, out, 1, "cpu")


@pytest.mark.parametrize("batch", [1, 2])
def test_reference_agrees_with_the_program(batch):
    r = tiny_run(batch=batch)
    out = train_mla_moe.run(r)
    line = line_of(r, out)
    prog, ref = out["readings"]["program"], out["readings"]["reference"]
    assert len(ref["losses"]) == len(prog["losses"]) == 3
    # both in fp32: they differ by the order of their sums alone
    assert max(check.readings(prog, ref).values()) < 1e-4
    assert set(line["metrics"]) == {
        "train_tokens_per_s", "train_peak_mem_gib", "setup_s"}
    # the same experts for every token, in every MoE layer and step
    assert out["route_flips"] == [[0, 0]] * 3
    assert len(ref["routes"]) == 3 and len(ref["routes"][0]) == 2


@pytest.mark.parametrize("fault", ["frozen", "half_batch", "leaf_altered",
                                   "routed_dropped"])
def test_a_fault_makes_the_run_incorrect(fault):
    r = tiny_run(faults=[fault], batch=2)
    line = line_of(r, train_mla_moe.run(r))
    assert not line["correct"], line["checks"]
    assert list(line)[-1] == "checks"


def test_control_reads_above_the_program():
    """The control (TF32 operands, the precision below fp32) in the
    program's place reads several times what the program reads."""
    r = tiny_run()
    out = train_mla_moe.run(r)
    ref = out["readings"]["reference"]
    prog = check.readings(out["readings"]["program"], ref)
    ctl = check.readings(train_mla_moe.reference(r, "cpu", batch=1,
                                                 numerics="tf32"), ref)
    assert ctl["loss_gap"] > 3 * prog["loss_gap"]
    assert ctl["grad_gap"] > 3 * prog["grad_gap"]


def test_routes_not_recorded_are_refused():
    """A compared step with fewer routes than MoE layers, the program's
    or the reference's, stops the run: its router was not seen."""
    import torch

    idx = torch.zeros(4, 2, dtype=torch.long)
    assert train_mla_moe.route_flips([[idx, idx]], [[idx, idx]], 2) == [[0, 0]]
    for prog, ref in (([[]], [[idx, idx]]), ([[idx, idx]], [[idx]]),
                      ([], [])):
        with pytest.raises(RuntimeError, match="not recorded"):
            train_mla_moe.route_flips(prog, ref, 2)


def test_the_reference_takes_the_programs_experts_at_near_ties_alone():
    """A token whose ranking differs from the reference's only among
    logits within TIE takes the given ranking; one that differs by more
    keeps the reference's own."""
    import torch

    m = dict(num_experts=4, top_k=2)
    tie = ref_mla_moe.TIE
    # logits of 3 tokens: a near tie of the 2nd and 3rd experts in the
    # first, of the 1st and 2nd in the second; the third token has none
    logits = torch.tensor([[3.0, 2.0, 2.0 - tie / 4, 0.0],
                           [1.0, 1.0 - tie / 2, 0.0, -1.0],
                           [4.0, 3.0, 2.0, 1.0]])
    num = ref_mla_moe.ref.Numerics()
    x, router = torch.eye(3), logits  # x @ router == logits
    own = ref_mla_moe.route(x, router, m, num)[1]
    assert own.tolist() == [[0, 1], [0, 1], [0, 1]]
    prefer = torch.tensor([[0, 2], [1, 0], [0, 2]])
    w, idx, aux, (taken, gaps) = ref_mla_moe.route(x, router, m, num, prefer)
    assert idx.tolist() == [[0, 2], [1, 0], [0, 1]]
    assert taken == 2 and len(gaps) == 3
    assert max(gaps[:2]) <= tie < gaps[2]
    torch.testing.assert_close(w.sum(-1), torch.ones(3))
    # a batch of another shape (half of the rows) is not taken
    assert ref_mla_moe.route(x, router, m, num, prefer[:1])[3] is None


def test_the_reference_takes_a_batchs_rows_together():
    r = tiny_run(batch=2)
    r.cell = dict(r.cell, reference_rows=1)
    with pytest.raises(ValueError, match="reference_rows"):
        train_mla_moe.reference(r, "cpu", batch=2)


def test_only_held_experts_add_to_the_reference():
    """The reference's MoE layer: the held experts' part and the shared
    experts; with every expert held it is the plain top-k mixture."""
    import torch

    m = dict(TINY, norm_eps=1e-6)
    g = torch.Generator().manual_seed(3)
    D, F, E = m["d_model"], m["moe_d_ff"], m["num_experts"]
    p = {"mlp/router": torch.randn(D, E, generator=g) * D ** -0.5,
         "mlp/w_gate": torch.randn(E, D, F, generator=g) * D ** -0.5,
         "mlp/w_up": torch.randn(E, D, F, generator=g) * D ** -0.5,
         "mlp/w_down": torch.randn(E, F, D, generator=g) * F ** -0.5}
    u = torch.randn(1, 8, D, generator=g)
    num = ref_mla_moe.ref.Numerics()
    whole = dict(m, experts_held=E, num_shared_experts=0)
    held = dict(m, num_shared_experts=0)
    out_all, aux = ref_mla_moe.moe(u, p, whole, num, {}, 0)
    out_held, aux_h = ref_mla_moe.moe(u, p, held, num, {}, 0)
    assert torch.equal(aux, aux_h)
    w, idx, _, ties = ref_mla_moe.route(u.reshape(8, D), p["mlp/router"],
                                        whole, num)
    assert ties is None
    assert int(torch.bincount(idx.reshape(-1)).max()) <= 4  # capacity 4
    mix = torch.zeros(8, D)
    part = torch.zeros(8, D)
    for t in range(8):
        for j in range(m["top_k"]):
            e = int(idx[t, j])
            y = ref_mla_moe.swiglu(u[0, t], {k: p["mlp/" + k][e] for k in
                                             ("w_gate", "w_up", "w_down")},
                                   "", num)
            mix[t] += w[t, j] * y
            if e < m["experts_held"]:
                part[t] += w[t, j] * y
    torch.testing.assert_close(out_all[0], mix, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(out_held[0], part, rtol=1e-5, atol=1e-6)


def test_the_reference_loads_nothing_of_the_program():
    from test_bench_imports import loaded

    tops = loaded(["bench.reference.mla_moe"])
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax",
                       "benchmarks"}
    tops = loaded(["bench.drivers.train_mla_moe", "bench.pieces",
                   "bench.flops_mla_moe", "repro_torch.api"])
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro", "benchmarks"}
