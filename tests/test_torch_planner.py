"""The port's planner (``repro_torch.core.planner`` and what it stands on:
``ilp``, Part 2 and 3 of ``memory_model``, ``ps``'s sync and serving
lemmas, ``hardware``'s meshes and cluster JSON, the full-architecture
``model_specs``) against the JAX package's, on the same inputs.

The planner is Python arithmetic in both packages, copied in the same
order, so ints, strings and floats are held EXACTLY equal (no tolerance
anywhere in this file).  Meshes: ``SINGLE_POD``, ``MULTI_POD``, every
named cluster of the port (the TPU and K80 ones exist in both packages;
for ``h100-8`` / ``h100-2x8`` the JAX side gets a ``ClusterSpec`` built
here from the port's H100 constants — nothing in the JAX package
changes).  Tests are parametrized by arch and mesh; the shapes and
scalar variants run inside each case.
"""
import dataclasses
import json

import numpy as np
import pytest

from repro.configs.base import get_config as jget_config
from repro.configs.base import get_shape as jget_shape
from repro.core import hardware as jhw
from repro.core import ilp as jilp
from repro.core import memory_model as jmm
from repro.core import pipeline as jpipe
from repro.core import planner as jplanner
from repro.core import ps as jps
from repro.models import model as JM
from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config, get_shape
from repro_torch.core import hardware as thw
from repro_torch.core import ilp as tilp
from repro_torch.core import memory_model as tmm
from repro_torch.core import pipeline as tpipe
from repro_torch.core import planner as tplanner
from repro_torch.core import ps as tps
from repro_torch.models import model as TM
from repro_torch.models.common import tree_items

MESHES = ("single_pod", "multi_pod") + tuple(sorted(thw.CLUSTERS))


def _jax_chip(c: thw.Chip) -> jhw.Chip:
    return jhw.Chip(c.name, c.peak_flops, c.hbm_bytes, c.hbm_bw, c.link_bw)


def _jax_cluster(c: thw.ClusterSpec) -> jhw.ClusterSpec:
    """The JAX package's own cluster of that name, or (the H100 ones) one
    built from the port's constants."""
    if c.name in jhw.CLUSTERS:
        return jhw.CLUSTERS[c.name]
    return jhw.ClusterSpec(c.name, _jax_chip(c.chip),
                           tuple(jhw.Tier(t.name, t.size, t.bw, t.latency)
                                 for t in c.tiers))


def _meshes(name):
    """(port MeshSpec, JAX MeshSpec) for a mesh name of MESHES."""
    if name == "single_pod":
        return thw.SINGLE_POD, jhw.SINGLE_POD
    if name == "multi_pod":
        return thw.MULTI_POD, jhw.MULTI_POD
    c = thw.get_cluster(name)
    return (thw.MeshSpec.from_cluster(c),
            jhw.MeshSpec.from_cluster(_jax_cluster(c)))


def _cfgs(arch):
    return get_config(arch), jget_config(arch)


def _shapes(name):
    return get_shape(name), jget_shape(name)


# ---------------------------------------------------------------------------
# Hardware: the meshes, the clusters and their JSON form
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", MESHES)
def test_meshes_and_clusters_match_jax(mesh):
    tm, jm = _meshes(mesh)
    assert (tm.chips, tm.dp, tm.tp) == (jm.chips, jm.dp, jm.tp)
    assert tm.total_flops == jm.total_flops
    assert tm.total_hbm == jm.total_hbm
    tc, jc = tm.cluster, jm.cluster
    assert tc.to_dict() == jc.to_dict()
    assert (tc.uniform, tc.min_bw, tc.bottleneck_tier, tc.n_chips) == \
        (jc.uniform, jc.min_bw, jc.bottleneck_tier, jc.n_chips)
    assert tc.dp_view(tm.dp, tm.tp) == tuple(
        thw.Tier(t.name, t.size, t.bw, t.latency)
        for t in jc.dp_view(jm.dp, jm.tp))
    # the JSON round trip, and a dict the JAX package wrote
    assert thw.ClusterSpec.from_dict(tc.to_dict()) == tc
    assert thw.ClusterSpec.from_dict(
        json.loads(json.dumps(jc.to_dict()))).to_dict() == jc.to_dict()


def test_cluster_from_dict_reads_calibrated_and_refuses_unknown_chips():
    d = thw.get_cluster("h100-8").to_dict()
    d["chip"] = "h100-sxm" + thw.Chip.CAL_SUFFIX
    assert thw.ClusterSpec.from_dict(d).chip == thw.H100_SXM
    assert not thw.H100_SXM.calibrated
    assert thw.Chip("x" + thw.Chip.CAL_SUFFIX, 1, 1, 1, 1).calibrated
    d["chip"] = "a100"
    with pytest.raises(KeyError, match="a100"):
        thw.ClusterSpec.from_dict(d)
    # a serialized cluster without a chip is the JAX default, the TPU
    d.pop("chip")
    assert thw.ClusterSpec.from_dict(d).chip == thw.TPU_V5E


# ---------------------------------------------------------------------------
# Parameter specs of every architecture
# ---------------------------------------------------------------------------


def _jax_spec_shapes(cfg):
    import jax

    leaves = jax.tree_util.tree_flatten_with_path(
        JM.model_specs(cfg), is_leaf=lambda x: hasattr(x, "axes"))[0]
    return {"/".join(k.key for k in path): (s.shape, s.axes, s.dtype,
                                            s.init, s.scale)
            for path, s in leaves}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_specs_match_jax(arch):
    """Every leaf path, shape, axis name and init of the full and the
    reduced model, as JAX's; parameter counts follow."""
    for reduce in (False, True):
        tcfg, jcfg = _cfgs(arch)
        if reduce:
            tcfg, jcfg = tcfg.reduced(), jcfg.reduced()
        got = {"/".join(p): (s.shape, s.axes, s.dtype, s.init, s.scale)
               for p, s in tree_items(TM.model_specs(tcfg))}
        assert got == _jax_spec_shapes(jcfg), (arch, reduce)
        assert tmm.n_params(tcfg) == jmm.n_params(jcfg)
        assert tmm.n_active_params(tcfg) == jmm.n_active_params(jcfg)


# ---------------------------------------------------------------------------
# Memory model (Parts 2 and 3)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_memory_model_matches_jax(arch):
    tcfg, jcfg = _cfgs(arch)
    for shape in SHAPES:
        ts, js = _shapes(shape)
        for dp, tp in ((16, 16), (8, 1), (2, 4)):
            for mb, attn, remat, fsdp, opt in (
                    (1, "dense", "none", False, "adamw"),
                    (4, "chunked", "block", True, "momentum"),
                    (0, "dense", "block", False, "adamw")):
                kw = dict(dp=dp, tp=tp, fsdp=fsdp, microbatch=mb,
                          attn_impl=attn, remat=remat, seq_parallel=True,
                          opt_kind=opt)
                for pipe_kw in ({}, dict(pipe=2, n_microbatch=4)):
                    assert dataclasses.asdict(tmm.train_memory(
                        tcfg, ts, **kw, **pipe_kw)) == dataclasses.asdict(
                        jmm.train_memory(jcfg, js, **kw, **pipe_kw))
                kw.pop("microbatch")
                kw.pop("opt_kind")
                assert tmm.max_microbatch(
                    tcfg, ts, hbm_bytes=80e9, **kw) == jmm.max_microbatch(
                    jcfg, js, hbm_bytes=80e9, **kw)
            for fsdp in (False, True):
                for win in (0, 8192):
                    assert dataclasses.asdict(tmm.decode_memory(
                        tcfg, ts, dp=dp, tp=tp, fsdp=fsdp,
                        window_override=win)) == dataclasses.asdict(
                        jmm.decode_memory(jcfg, js, dp=dp, tp=tp, fsdp=fsdp,
                                          window_override=win))
        for stage in (0, 1):
            kw = dict(dp=4, tp=2, pipe=2, n_microbatch=4, stage=stage,
                      stage_cycles=3, attn_impl="dense", remat="none",
                      seq_parallel=True)
            assert tmm.stage_activation_bytes(tcfg, ts, **kw) == \
                jmm.stage_activation_bytes(jcfg, js, **kw)
    assert tmm.kv_token_bytes(tcfg) == jmm.kv_token_bytes(jcfg)
    assert tmm.request_state_bytes(tcfg) == jmm.request_state_bytes(jcfg)
    for hbm in (16 * 2**30, 80e9, 1e12):
        for bs, mb in ((16, 1), (64, 8)):
            assert tmm.kv_block_bytes(tcfg, bs) == jmm.kv_block_bytes(jcfg, bs)
            assert tmm.max_kv_blocks(tcfg, hbm, block_size=bs,
                                     max_batch=mb) == \
                jmm.max_kv_blocks(jcfg, hbm, block_size=bs, max_batch=mb)


# ---------------------------------------------------------------------------
# The step-time roofline and the plan itself
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plan_matches_jax(arch, mesh):
    """plan() for all four shapes: the Plan dict equal to JAX's (ints,
    strings, floats, notes, the serialized topology)."""
    tcfg, jcfg = _cfgs(arch)
    tm, jm = _meshes(mesh)
    for shape in SHAPES:
        ts, js = _shapes(shape)
        got = tplanner.plan(tcfg, ts, tm)
        want = jplanner.plan(jcfg, js, jm)
        assert got.to_dict() == want.to_dict(), (arch, mesh, shape)
        assert got.topology["chip"] == tm.chip.name


VARIANTS = {
    "overlap": dict(sync_overlap=True, bucket_mb=2.0),
    "overlap_derated": dict(sync_overlap=True, bucket_mb=0.0,
                            overlap_efficiency=0.4),
    "async": dict(staleness=2, backup_workers=1, mean_delay=0.01),
    "async_search": dict(staleness=(0, 1, 4), backup_workers=0,
                         mean_delay=0.05),
    "pipe2": dict(pipe=2),
    "pipe2_m8": dict(pipe=2, n_microbatch=8),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_plan_variants_match_jax(variant):
    """The overlap, async-PS and pipeline options of plan(), every arch,
    on the H100 clusters and a hierarchical TPU one."""
    kw = VARIANTS[variant]
    for arch in ARCH_IDS:
        tcfg, jcfg = _cfgs(arch)
        for mesh in ("h100-8", "h100-2x8", "2x4"):
            tm, jm = _meshes(mesh)
            ts, js = _shapes("train_4k")
            try:
                want = jplanner.plan(jcfg, js, jm, **kw).to_dict()
            except ValueError as e:  # no (pipe, m) candidate: both refuse
                with pytest.raises(ValueError, match="candidates"):
                    tplanner.plan(tcfg, ts, tm, **kw)
                assert "candidates" in str(e)
                continue
            assert tplanner.plan(tcfg, ts, tm, **kw).to_dict() == want, \
                (variant, arch, mesh)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_step_time_terms_match_jax(arch):
    tcfg, jcfg = _cfgs(arch)
    for mesh in ("single_pod", "h100-8", "h100-2x8", "4x4-ib"):
        tm, jm = _meshes(mesh)
        for shape in ("train_4k", "prefill_32k"):
            ts, js = _shapes(shape)
            for remat in ("block", "none"):
                assert tplanner.train_flops_per_step(tcfg, ts, remat) == \
                    jplanner.train_flops_per_step(jcfg, js, remat)
                for kw in ({}, dict(sync_overlap=True, bucket_mb=1.0),
                           dict(pipe=2, n_microbatch=4),
                           dict(staleness=3, backup_workers=1,
                                mean_delay=0.02)):
                    got = tplanner.estimate_step_time(tcfg, ts, tm, remat, 2,
                                                      **kw)
                    want = jplanner.estimate_step_time(jcfg, js, jm, remat, 2,
                                                       **kw)
                    assert got == want, (mesh, shape, remat, kw)
                    assert tplanner.r_o_from_terms(got) == \
                        jplanner.r_o_from_terms(want)


@pytest.mark.parametrize("mesh", ["h100-8", "2x4"])
@pytest.mark.parametrize("arch", ["granite-3-2b", "mamba2-780m",
                                  "deepseek-v2-236b"])
def test_search_space_matches_jax(arch, mesh):
    """train_search_space's dims, every cell's price and the lower bound,
    then search_bnb against search_exhaustive in both packages."""
    tcfg, jcfg = _cfgs(arch)
    tm, jm = _meshes(mesh)
    ts, js = _shapes("train_4k")
    tdims, teval, tlb = tplanner.train_search_space(
        tcfg, ts, tm, fsdp=False, opt_kind="adamw")
    jdims, jeval, jlb = jplanner.train_search_space(
        jcfg, js, jm, fsdp=False, opt_kind="adamw")
    assert [(d.name, d.values) for d in tdims] == \
        [(d.name, d.values) for d in jdims]
    import itertools

    for values in itertools.product(*(d.values for d in tdims)):
        cell = dict(zip((d.name for d in tdims), values))
        assert teval(dict(cell)) == jeval(dict(cell))
        assert tlb(dict(cell)) == jlb(dict(cell))
    got = tilp.search_bnb(tdims, teval, lower_bound=tlb)
    want = jilp.search_bnb(jdims, jeval, lower_bound=jlb)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tilp.search_exhaustive(tdims, teval).config == got.config


def test_plan_decode_and_resolve_sync_match_jax():
    """plan_decode alone; Plan.resolve_sync's strategy (name, PS shard
    count from Lemma 3.2, hierarchical tiers) for plans of every
    schedule; a decode plan refuses to resolve in both."""
    for arch in ARCH_IDS:
        tcfg, jcfg = _cfgs(arch)
        for mesh in ("h100-8", "h100-2x8", "multi_pod"):
            tm, jm = _meshes(mesh)
            ts, js = _shapes("decode_32k")
            assert tplanner.plan_decode(tcfg, ts, tm).to_dict() == \
                jplanner.plan_decode(jcfg, js, jm).to_dict()
    tcfg, jcfg = _cfgs("granite-3-2b")
    # (the JAX package's ClusterSpec.from_dict, which Plan.cluster calls,
    # knows no H100: the H100 plans resolve on the port's side alone)
    for mesh in ("h100-8", "h100-2x8"):
        tm, _ = _meshes(mesh)
        tp = tplanner.plan(tcfg, get_shape("train_4k"), tm)
        assert tp.cluster == thw.get_cluster(mesh)
        assert tp.link_bw == tp.cluster.min_bw
        for sched in tps.SCHEDULES:
            got = dataclasses.replace(tp, sync_schedule=sched).resolve_sync()
            assert got.name == sched
    for mesh in ("2x4", "4x4-ib", "p2-2x8", "flat8", "multi_pod"):
        tm, jm = _meshes(mesh)
        tp = tplanner.plan(tcfg, get_shape("train_4k"), tm)
        jp = jplanner.plan(jcfg, jget_shape("train_4k"), jm)
        for sched in tps.SCHEDULES:
            t = dataclasses.replace(tp, sync_schedule=sched)
            j = dataclasses.replace(jp, sync_schedule=sched)
            assert t.link_bw == j.link_bw
            assert t.dp_tiers() == tuple(
                thw.Tier(x.name, x.size, x.bw, x.latency)
                for x in j.dp_tiers())
            ts_, js_ = t.resolve_sync(), j.resolve_sync()
            assert (ts_.name, ts_.n_servers, ts_.tiers) == \
                (js_.name, js_.n_servers, js_.tiers), (mesh, sched)
    dec = tplanner.plan(tcfg, get_shape("decode_32k"), thw.SINGLE_POD)
    with pytest.raises(ValueError, match="no gradient sync"):
        dec.resolve_sync()


def test_plan_json_round_trips():
    """to_json/from_json, a plan dict the JAX package wrote, and a legacy
    dict that carries a scalar link_bw and no topology or pipe fields."""
    tcfg, jcfg = _cfgs("granite-3-2b")
    tm, jm = _meshes("h100-2x8")
    plan = tplanner.plan(tcfg, get_shape("train_4k"), tm,
                         sync_overlap=True, bucket_mb=2.0)
    assert tplanner.Plan.from_json(plan.to_json()) == plan
    assert plan.to_job_kwargs()["sync"] == plan.sync_schedule
    assert plan.run_config_kwargs() == dict(
        attn_impl=plan.attn_impl, remat=plan.remat,
        microbatch=plan.microbatch)
    jplan = jplanner.plan(jcfg, jget_shape("train_4k"), jm,
                          sync_overlap=True, bucket_mb=2.0)
    got = tplanner.Plan.from_json(jplan.to_json())
    assert got.to_dict() == jplan.to_dict()
    assert got.cluster == thw.get_cluster("h100-2x8")
    legacy = {k: v for k, v in jplan.to_dict().items()
              if k not in ("topology", "pipe", "n_microbatch", "stage_cut",
                           "staleness", "backup_workers")}
    legacy["link_bw"] = 12.5e9
    got = tplanner.Plan.from_dict(legacy)
    want = jplanner.Plan.from_dict(legacy)
    assert got.to_dict() == want.to_dict()
    assert got.link_bw == 12.5e9 and got.pipe == 1


# ---------------------------------------------------------------------------
# The searches (Eq. 6) on seeded random instances
# ---------------------------------------------------------------------------


def _random_layers(mod, rng, n_layers, n_algs):
    return [[mod.Choice(f"a{l}", float(rng.uniform(0.1, 10.0)),
                        float(rng.uniform(1.0, 100.0)))
             for l in range(n_algs)] for _ in range(n_layers)]


@pytest.mark.parametrize("seed", range(4))
def test_ilp_solutions_match_jax(seed):
    """solve_ilp and solve_ilp_dp (tests/test_core.py's instances: 2-8
    layers, 2-3 algorithms, bounds from tight to loose, and one
    infeasible bound) give JAX's solutions."""
    rng = np.random.default_rng(seed)
    for _ in range(10):
        n_layers, n_algs = int(rng.integers(2, 9)), int(rng.integers(2, 4))
        state = rng.bit_generator.state
        tl = _random_layers(tilp, rng, n_layers, n_algs)
        rng.bit_generator.state = state
        jl = _random_layers(jilp, rng, n_layers, n_algs)
        min_m = sum(min(c.memory for c in ch) for ch in tl)
        max_m = sum(max(c.memory for c in ch) for ch in tl)
        for bound in (min_m * 0.9, min_m * 1.5,
                      min_m + float(rng.uniform(0.1, 1.0)) * (max_m - min_m)):
            assert dataclasses.asdict(tilp.solve_ilp(tl, bound)) == \
                dataclasses.asdict(jilp.solve_ilp(jl, bound))
            assert dataclasses.asdict(
                tilp.solve_ilp_dp(tl, bound, buckets=2048)) == \
                dataclasses.asdict(jilp.solve_ilp_dp(jl, bound, buckets=2048))


@pytest.mark.parametrize("seed", range(4))
def test_search_bnb_matches_jax(seed):
    """search_bnb with and without an admissible bound, on seeded random
    grids (with infeasible cells), against JAX's; the bound only prunes."""
    rng = np.random.default_rng(100 + seed)
    for _ in range(5):
        sizes = rng.integers(1, 5, size=int(rng.integers(1, 5)))
        tdims = [tilp.Dim(f"d{i}", tuple(range(int(n))))
                 for i, n in enumerate(sizes)]
        jdims = [jilp.Dim(d.name, d.values) for d in tdims]
        table = {}

        def evaluate(cfg):
            key = tuple(sorted(cfg.items()))
            if key not in table:
                t = float(rng.uniform(1.0, 10.0))
                table[key] = (t, float(rng.uniform(0.0, 5.0)),
                              bool(rng.uniform() < 0.8))
            return table[key]

        def lb(partial):
            return 1.0

        for kw in ({}, dict(lower_bound=lb)):
            got = tilp.search_bnb(tdims, evaluate, **kw)
            want = jilp.search_bnb(jdims, evaluate, **kw)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert tilp.search_exhaustive(tdims, evaluate).config == \
            tilp.search_bnb(tdims, evaluate, lower_bound=lb).config
    with pytest.raises(ValueError):
        tilp.Dim("empty", ())


# ---------------------------------------------------------------------------
# Lemma 3.2 as a decision, the PS placement, the serving lemma, 1F1B
# ---------------------------------------------------------------------------


def test_sync_and_placement_plans_match_jax():
    for name in sorted(thw.CLUSTERS):
        tc = thw.get_cluster(name)
        jc = _jax_cluster(tc)
        for s_p in (1e6, 1.0e10):
            for t_c in (1e-3, 0.5, 2.0):
                for zero in (True, False):
                    got = tps.grad_sync_plan(s_p, tc.tiers, t_c,
                                             zero_sharded=zero)
                    want = jps.grad_sync_plan(s_p, jc.tiers, t_c,
                                              zero_sharded=zero)
                    assert dataclasses.asdict(got) == \
                        dataclasses.asdict(want), (name, s_p, t_c)
                assert tps.ps_placement_plan(s_p, tc.n_chips, tc, t_c) == \
                    jps.ps_placement_plan(s_p, jc.n_chips, jc, t_c)
                for place in tps.PS_PLACEMENTS:
                    assert tps.n_parameter_servers_tiered(
                        s_p, 8, tc, t_c, placement=place) == \
                        jps.n_parameter_servers_tiered(
                            s_p, 8, jc, t_c, placement=place)
    # a latency on a tier is priced in both schedules
    lat = (thw.Tier("node", 4, 50e9, 1e-5), thw.Tier("cluster", 2, 2.5e9, 1e-3))
    jlat = tuple(jhw.Tier(t.name, t.size, t.bw, t.latency) for t in lat)
    for tiers, jtiers in ((lat, jlat), (lat[1:], jlat[1:])):
        assert dataclasses.asdict(tps.grad_sync_plan(4e9, tiers, 0.1)) == \
            dataclasses.asdict(jps.grad_sync_plan(4e9, jtiers, 0.1))
    assert dataclasses.asdict(tps.tpu_grad_sync_plan(1e9, 8, 50e9, 0.1)) == \
        dataclasses.asdict(jps.tpu_grad_sync_plan(1e9, 8, 50e9, 0.1))
    with pytest.raises(KeyError, match="placement"):
        tps.ps_placement_bw(thw.get_cluster("2x4"), "moon")


def test_serving_lemma_matches_jax():
    for kw in (dict(arrival_rate=5.0, t_prefill_s=0.01, t_step_s=0.002,
                    n_new=32, batch=4, slo_s=1.0),
               dict(arrival_rate=200.0, t_prefill_s=0.05, t_step_s=0.01,
                    n_new=128, batch=8, slo_s=2.0),
               dict(arrival_rate=1.0, t_prefill_s=0.5, t_step_s=0.1,
                    n_new=64, batch=1, slo_s=1.0)):  # unattainable
        assert tps.serve_replica_plan(**kw) == jps.serve_replica_plan(**kw)
    assert tps.decode_step_time(5e9, 1e8, 3.35e12) == \
        jps.decode_step_time(5e9, 1e8, 3.35e12)
    assert tps.service_time(0.1, 32, 0.01) == jps.service_time(0.1, 32, 0.01)
    assert tps.md1_wait(0.7, 0.2) == jps.md1_wait(0.7, 0.2)
    assert tps.serve_utilization_bound(1.0, 0.3) == \
        jps.serve_utilization_bound(1.0, 0.3)
    assert tps.n_replicas(50.0, 0.4, 4, 0.8) == jps.n_replicas(50.0, 0.4, 4, 0.8)
    for bad in (lambda m: m.decode_step_time(1.0, 1.0, 0.0),
                lambda m: m.md1_wait(1.0, 1.0),
                lambda m: m.n_replicas(1.0, 1.0, 1, 0.0)):
        with pytest.raises(ValueError):
            bad(tps)


def test_pipeline_helpers_match_jax():
    for p in range(1, 9):
        for m in range(1, 17):
            assert tpipe.pipeline_bubble(p, m) == jpipe.pipeline_bubble(p, m)
        for n in range(p, 41):
            assert tpipe.balanced_stage_cut(n, p) == \
                jpipe.balanced_stage_cut(n, p)
    with pytest.raises(ValueError):
        tpipe.balanced_stage_cut(3, 4)
    with pytest.raises(ValueError):
        tpipe.pipeline_bubble(2, 0)
    assert tpipe.pipeline_bubble(4, 12) == 3 / 15
