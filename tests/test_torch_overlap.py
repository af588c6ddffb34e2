"""The port's bucketed comm/compute overlap against the JAX package's, and
the H100 hardware and Lemma 3.1 it is priced with:

- ``core/amdahl.py`` and ``core/ps.py``'s overlap pricing equal JAX's on a
  grid; ``distributed/overlap.py``'s ``BucketPlan`` on a converted
  granite-3-2b tree equals JAX's on JAX's tree, index for index;
- the overlapped ``DataParallelTrainer`` (2 calibration + 2 fused steps)
  gives the serial trainer's parameters bitwise at dp 2, for the four
  strategies and three compressors (the port's form of
  tests/test_overlap.py:261-291), and at dp 4 for all_reduce; at dp 4 the
  flat strategies are held to 2e-4, since a bucket's flat vector puts an
  element at another place in gloo's ring chunks than the whole
  gradient's does, which changes the order of its 4-way sum;
- the SyncReport's overlap fields, the Session and the launcher;
- the H100 ``Chip`` and clusters, and the link the trainer prices on.

Ranks run in-process, one thread each, over gloo on a ``HashStore``
(groups with a 60 s timeout); inputs from ``np.random.default_rng``; fp32
2e-4 (tests/test_kernels.py).
"""
from datetime import timedelta

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.core import amdahl as jamdahl
from repro.core import pipeline as jpipe
from repro.core import ps as jps
from repro.distributed import overlap as jov
from repro.distributed import trainer as jtrainer
from repro.models import common as jcommon
from repro.models import model as JM
from repro.train import loop as jloop
from repro_torch.api import JobSpec, Session
from repro_torch.configs.base import get_config
from repro_torch.core import amdahl as tamdahl
from repro_torch.core import hardware as thw
from repro_torch.core import ps as tps
from repro_torch.distributed import overlap as tov
from repro_torch.distributed import trainer as ttrainer
from repro_torch.distributed.trainer import (DEFAULT_LINK_BW,
                                             DataParallelTrainer,
                                             default_link_bw)
from repro_torch.launch.steps import build_grad_fn
from repro_torch.models import model as TM
from repro_torch.models.blocks import RunConfig
from repro_torch.models.common import materialize, tree_items
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim.adamw import OptConfig

TOL = 2e-4
TIMEOUT = timedelta(seconds=60)
STRATEGIES = ("all_reduce", "reduce_scatter_all_gather", "parameter_server",
              "hier_all_reduce")


def _cfg():
    """tests/test_torch_distributed.py's small trainer config, in fp32."""
    return get_config("granite-3-2b").reduced().replace(
        vocab_size=256, d_model=64, num_heads=2, num_kv_heads=1, head_dim=32,
        d_ff=128, dtype="float32")


def _train(dp, strategy="all_reduce", compression="none", *, steps=4,
           run=None, **kw):
    tr = DataParallelTrainer(
        _cfg(), run or RunConfig(attn_impl="dense", remat="none"),
        OptConfig(lr=1e-3, warmup_steps=0, total_steps=8), strategy=strategy,
        compression=compression, devices=["cpu"] * dp, group_timeout=TIMEOUT,
        **kw)
    try:
        res = tr.train(batch=8, seq=16, steps=steps, log_every=0)
        return tr, res, tr.report()
    finally:
        tr.close()


def _pair(dp, strategy="all_reduce", compression="none", **kw):
    serial = _train(dp, strategy, compression, **kw)
    overlapped = _train(dp, strategy, compression, sync_overlap=True,
                        bucket_mb=0.05, **kw)
    assert overlapped[0]._plan.n_buckets > 1, "bucketing never engaged"
    return serial, overlapped


def _equal(a, b, what):
    for (path, x), (_, y) in zip(tree_items(a), tree_items(b)):
        assert torch.equal(x, y), f"{what}: {path}"


# ---------------------------------------------------------------------------
# Pure functions against JAX's
# ---------------------------------------------------------------------------


def test_amdahl_matches_jax():
    for g in (1, 2, 3, 4, 8, 64):
        for r_o in (0.0, 0.01, 0.1, 0.39, 1.0, 3.0):
            assert tamdahl.efficiency(g, r_o) == jamdahl.efficiency(g, r_o)
            assert tamdahl.speedup(g, r_o) == jamdahl.speedup(g, r_o)
            for alpha in (0.1, 0.5, 0.9, 1.0):
                assert tamdahl.max_overhead_for(g, alpha) == \
                    jamdahl.max_overhead_for(g, alpha)
        for target in (1.0, 1.5, 3.0):
            assert tamdahl.devices_for_speedup(target, 0.1) == \
                jamdahl.devices_for_speedup(target, 0.1)
    for r_o in (0.0, 0.1, 2.0):
        assert tamdahl.speedup_saturation(r_o) == \
            jamdahl.speedup_saturation(r_o)
    assert tamdahl.devices_for_speedup(3.0, 0.1) == 4  # the paper's example
    with pytest.raises(ValueError):
        tamdahl.efficiency(0, 0.1)
    with pytest.raises(ValueError):
        tamdahl.max_overhead_for(2, 0.0)


def test_ps_overlap_pricing_matches_jax():
    assert tps.DEFAULT_BUCKET_MB == jps.DEFAULT_BUCKET_MB
    assert tps.FWD_FRACTION == jps.FWD_FRACTION
    for grad_bytes in (0.0, 1.0, 3e6, 10.1e9):
        for mb in (0.0, 0.05, 1.0, 25.0):
            assert tps.bucket_count(grad_bytes, mb) == \
                jps.bucket_count(grad_bytes, mb)
    for t_comm in (0.0, 0.01, 0.034, 1.0):
        for t_bwd in (0.0, 0.19, 0.5):
            for n in (0, 1, 2, 13):
                for eff in (0.0, 0.5, 1.0, 1.5):
                    assert tps.overlap_exposed_comm(
                        t_comm, t_bwd, n, overlap_efficiency=eff) == \
                        jps.overlap_exposed_comm(t_comm, t_bwd, n,
                                                 overlap_efficiency=eff)
                    assert tps.overlap_step_time(
                        0.1, t_bwd, t_comm, n, overlap_efficiency=eff) == \
                        jps.overlap_step_time(0.1, t_bwd, t_comm, n,
                                              overlap_efficiency=eff)


@pytest.mark.parametrize("mb", [0.05, 0.25, 4.0])
def test_bucket_plan_matches_jax_on_granite(mb):
    """The port's plan for a converted granite-3-2b (reduced) tree equals
    JAX's plan for JAX's tree, index for index."""
    jcfg = jax_get_config("granite-3-2b").reduced()
    tcfg = get_config("granite-3-2b").reduced()
    jp = jcommon.materialize(JM.model_specs(jcfg), jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                           "cpu")
    jplan = jov.build_bucket_plan(jp, jov.mb_to_bytes(mb))
    tplan = tov.build_bucket_plan(tp, tov.mb_to_bytes(mb))
    assert tplan.to_dict() == jplan.to_dict()
    assert (tplan.n_buckets > 1) == (mb < 1)  # 2.4 MB of grads in all
    assert tov.build_bucket_plan(TM.model_specs(tcfg),
                                 tov.mb_to_bytes(mb)) == tplan
    for k in range(tplan.n_buckets):
        assert tov.bucket_span_args(tplan, k) == \
            jov.bucket_span_args(jplan, k)


def test_bucket_plan_round_trip_partition_and_inverse():
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal(100), "b": {
        "c": rng.standard_normal((30, 10)), "d": rng.standard_normal(7)},
        "e": rng.standard_normal((50, 3))}
    plan = tov.build_bucket_plan(tree, 1000.0)
    assert plan.n_buckets > 1
    assert tov.BucketPlan.from_json(plan.to_json()) == plan
    assert tov.BucketPlan.from_dict(plan.to_dict()).buckets == plan.buckets
    assert [i for b in plan.buckets for i in b] == [3, 2, 1, 0]
    assert plan.to_dict() == jov.build_bucket_plan(tree, 1000.0).to_dict()
    leaves = [v for _, v in tree_items(tree)]
    back = tov.unbucket_leaves(tov.bucket_leaves(leaves, plan), plan)
    assert all(a is b for a, b in zip(leaves, back))
    with pytest.raises(ValueError, match="partition"):
        tov.BucketPlan(bucket_bytes=64.0, buckets=((0, 1), (1, 2)),
                       leaf_bytes=(4.0, 4.0, 4.0))
    with pytest.raises(ValueError, match="partition"):
        tov.BucketPlan(bucket_bytes=64.0, buckets=((0,),),
                       leaf_bytes=(4.0, 4.0))
    with pytest.raises(ValueError):
        tov.BucketPlan(bucket_bytes=0.0, buckets=((0,),), leaf_bytes=(4.0,))
    with pytest.raises(ValueError):
        tov.bucket_leaves(leaves[:2], plan)
    with pytest.raises(ValueError):
        tov.unbucket_leaves([[1]], plan)


def test_grad_hook_reports_every_leaf_once():
    """build_grad_fn's on_leaf hook: each leaf once, with the tensor the
    returned tree holds, and the gradients bitwise those of a run without
    the hook; with microbatches, only on the last one."""
    cfg = _cfg()
    params = materialize(TM.model_specs(cfg), 0, "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 16)).astype(np.int64))
    batch = {"tokens": toks, "labels": toks}
    for micro in (0, 2):
        run = RunConfig(attn_impl="dense", remat="none", microbatch=micro)
        grads_of = build_grad_fn(cfg, run)
        seen = {}
        loss, _, grads = grads_of(params, batch,
                                  on_leaf=lambda j, g: seen.setdefault(j, g))
        _, _, plain = grads_of(params, batch)
        leaves = [g for _, g in tree_items(grads)]
        assert sorted(seen) == list(range(len(leaves)))
        assert all(seen[j] is g for j, g in enumerate(leaves))
        _equal(grads, plain, f"microbatch {micro}")


# ---------------------------------------------------------------------------
# The overlapped trainer against the serial one
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_overlapped_equals_serial_dp2(strategy):
    (s_tr, s_res, _), (o_tr, o_res, rep) = _pair(2, strategy)
    for r in range(2):
        _equal(o_tr.params[r], s_tr.params[r], f"{strategy} rank {r}")
    assert o_res.losses == s_res.losses
    assert rep.sync_overlap and rep.n_buckets == o_tr._plan.n_buckets


@pytest.mark.parametrize("compression", ["bf16", "int8", "topk"])
def test_overlapped_equals_serial_compressors(compression):
    """Every compressor, with the error-feedback state riding per bucket."""
    (s_tr, _, _), (o_tr, _, _) = _pair(2, "all_reduce", compression)
    for r in range(2):
        _equal(o_tr.params[r], s_tr.params[r], f"{compression} rank {r}")
        if "ef" in s_tr.opt_states[r]:
            _equal(o_tr.opt_states[r]["ef"], s_tr.opt_states[r]["ef"],
                   f"{compression} ef rank {r}")


def test_overlapped_equals_serial_with_microbatches():
    """The hook folds the last microbatch into the running sum: bitwise
    the serial trainer's accumulation."""
    run = RunConfig(attn_impl="dense", remat="none", microbatch=2)
    (s_tr, _, _), (o_tr, _, _) = _pair(2, "all_reduce", run=run)
    _equal(o_tr.params[0], s_tr.params[0], "microbatch 2")


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_overlapped_matches_serial_dp4(strategy):
    """dp 4: all_reduce (one collective per leaf, in both schedules) stays
    bitwise; the flat strategies reduce each bucket's own flat vector, so
    gloo's ring sums an element's four values in another order: 2e-4."""
    (s_tr, _, _), (o_tr, _, _) = _pair(4, strategy)
    for r in range(4):
        if strategy == "all_reduce":
            _equal(o_tr.params[r], s_tr.params[r], f"rank {r}")
            continue
        for (path, x), (_, y) in zip(tree_items(o_tr.params[r]),
                                     tree_items(s_tr.params[r])):
            bound = TOL + TOL * y.abs().max().item()
            assert (x - y).abs().max().item() <= bound, (strategy, path)


def test_overlap_report_fields():
    _, (tr, res, rep) = _pair(2, "reduce_scatter_all_gather")
    d = rep.as_dict()
    assert set(d) == set(jtrainer.SyncReport.__dataclass_fields__) | {
        "effective_link_bw"}
    assert 0.0 <= rep.overlap_fraction <= 1.0
    assert rep.exposed_comm_time <= rep.measured_comm_s
    assert len(rep.per_bucket_comm_s) == rep.n_buckets > 1
    assert rep.bucket_sizes_bytes == tr._plan.sizes_bytes
    assert sum(rep.bucket_sizes_bytes) == rep.grad_bytes
    assert rep.bucket_mb == 0.05 and rep.overlapped_step_s > 0
    assert len(res.step_times) == 4
    gauges = tr.metrics.section()["gauges"]
    assert gauges["train/overlap_fraction"] == rep.overlap_fraction
    assert gauges["train/exposed_comm_time_s"] == rep.exposed_comm_time
    assert gauges["train/n_buckets"] == rep.n_buckets
    hists = tr.metrics.section()["histograms"]
    assert hists["train/bucket_comm_s"]["count"] == 2 * rep.n_buckets
    assert hists["train/fused_step_s"]["count"] == 2
    spans = {e.name for e in tr.tracer.events()}
    assert {"bucket_sync", "fused_step", "compute"} <= spans
    # serial: fully exposed
    _, _, serial = _train(2, "reduce_scatter_all_gather", steps=3)
    assert serial.exposed_comm_time == serial.measured_comm_s
    assert serial.overlap_fraction == 0.0 and serial.n_buckets == 1


def test_overlap_with_fewer_steps_than_calibration():
    """No fused step ran: the sync is reported fully exposed."""
    _, _, rep = _train(2, sync_overlap=True, bucket_mb=0.05, steps=2)
    assert rep.exposed_comm_time == rep.measured_comm_s
    assert rep.overlap_fraction == 0.0 and rep.overlapped_step_s == 0.0
    with pytest.raises(ValueError, match="bucket_mb"):
        _train(2, sync_overlap=True, bucket_mb=0.0)


def test_session_overlap_returns_jax_keys():
    spec = JobSpec(arch="granite-3-2b", steps=4, batch=4, seq=16, dp=2,
                   sync="all_reduce", sync_overlap=True, bucket_mb=0.5,
                   log_every=0)
    rep = Session(spec, device="cpu").train()
    keys = set(jloop.TrainResult([1.0], [jpipe.StepTimes()], 1.0).summary())
    assert set(rep.measured) == keys | {"metrics", "sync"}
    sync = rep.measured["sync"]
    assert sync["sync_overlap"] and sync["bucket_mb"] == 0.5
    assert sync["n_buckets"] > 1
    gauges = rep.measured["metrics"]["gauges"]
    assert "train/overlap_fraction" in gauges


def test_train_launcher_overlap_flags(capsys, monkeypatch):
    """JAX's test_train_launcher_overlap_flags, and --overlap runs."""
    import json

    from repro_torch.launch import train as launcher

    ap = launcher.build_parser()
    spec = launcher.build_spec(ap.parse_args(["--arch", "granite-3-2b"]))
    assert not spec.sync_overlap and spec.bucket_mb == 0.0
    spec = launcher.build_spec(ap.parse_args(
        ["--arch", "granite-3-2b", "--overlap", "--bucket-mb", "2.5"]))
    assert spec.sync_overlap and spec.bucket_mb == 2.5
    spec = launcher.build_spec(ap.parse_args(
        ["--arch", "granite-3-2b", "--no-overlap"]))
    assert not spec.sync_overlap
    monkeypatch.setattr("sys.argv", [
        "train", "--arch", "granite-3-2b", "--steps", "4", "--batch", "4",
        "--seq", "16", "--device", "cpu", "--dp", "2", "--sync",
        "all_reduce", "--overlap", "--bucket-mb", "1"])
    launcher.main()
    out = capsys.readouterr().out
    assert "overlap: " in out and "buckets hide" in out
    last = json.loads(out.strip().splitlines()[-1])
    assert 0.0 <= last["overlap_fraction"] <= 1.0


# ---------------------------------------------------------------------------
# H100 hardware and the link the trainer prices on
# ---------------------------------------------------------------------------


def test_h100_chip_and_clusters():
    chip = thw.H100_SXM
    assert (chip.peak_flops, chip.hbm_bw, chip.hbm_bytes, chip.link_bw) == \
        (989e12, 3.35e12, 80e9, 450e9)
    node = thw.get_cluster("h100-8")
    assert node.chip is chip and node.n_chips == 8
    assert node.tier_sizes == (8,) and node.tier_bws == (450e9,)
    two = thw.get_cluster("h100-2x8")
    assert two.n_chips == 16 and two.tier_sizes == (8, 2)
    assert two.tier_bws == (450e9, 50e9)  # 400 Gb/s InfiniBand per card
    assert two.bottleneck_tier == "cluster" and two.min_bw == 50e9
    assert thw.H100_NODE is node
    assert JobSpec(arch="granite-3-2b", topology="h100-2x8").topology


def test_trainer_prices_cards_on_nvlink():
    """On cards with no link_bw, Lemma 3.2 is priced on the topology's
    narrowest spanning tier, or on the H100 node's NVLink tier when there
    is no topology; on the CPU on JAX's 4e9 default; an explicit link_bw
    always wins."""
    cuda = [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert default_link_bw(cuda, None) == 450e9
    assert default_link_bw(["cpu"], None) == DEFAULT_LINK_BW == 4e9
    assert default_link_bw(cuda, thw.get_cluster("h100-8")) == 450e9
    assert default_link_bw(cuda, thw.get_cluster("h100-2x8")) == 50e9
    assert default_link_bw(["cpu"], thw.get_cluster("h100-2x8")) == 4e9
    tr, _, rep = _train(2, steps=3)
    assert tr.link_bw == rep.link_bw == 4e9
    tr, _, rep = _train(2, steps=3, link_bw=450e9)
    assert rep.link_bw == 450e9
    payload = rep.grad_bytes
    assert rep.predicted_comm_s == tps.predicted_comm_time(
        "all_reduce", payload, 2, 450e9)


# ---------------------------------------------------------------------------
# Still unported
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,item", [
    (dict(pipe=2), "Next 3"),
    (dict(tune=True), "Next 6"),
])
def test_unported_options_name_their_roadmap_item(kw, item, monkeypatch):
    """Next 6 (tune) and Next 3 (pipe > 1) are ported: a tuned spec trains
    on the tuned knobs and reports them, a pipelined one runs the 1F1B
    trainer and reports its pipeline section.  pipe > 1 under torchrun
    (one process a stage, Next 19) raises naming its ROADMAP item."""
    spec = JobSpec(arch="granite-3-2b", steps=2, batch=4, seq=8, **kw)
    if item == "Next 6":
        assert "tuning" in Session(spec, device="cpu").train().measured
        return
    assert Session(spec, device="cpu").train().measured["pipeline"][
        "pipe"] == 2
    monkeypatch.setattr(ttrainer, "torchrun_env", lambda: ttrainer.TorchrunEnv(
        0, 2, 0, "localhost", 29500))
    with pytest.raises(NotImplementedError, match="ROADMAP Next 19"):
        Session(spec, device="cpu").train()
