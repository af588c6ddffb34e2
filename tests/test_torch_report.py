"""The port's Report schema and the Session methods built on the planner,
against the JAX package's, on the CPU.

- ``repro_torch.api.validate_report`` accepts the JAX package's goldens
  (``tests/goldens/``) and rejects the same single-field mutations as
  ``tests/test_goldens.py``; its requirement tables are JAX's.
- Every kind the port's ``Session`` emits passes both packages'
  ``validate_report``.
- Where both packages price the same cluster (a named TPU ``topology``),
  ``Session.plan()`` / ``dryrun()`` give JAX's ``plan`` and ``predicted``
  sections exactly, ``build_run_opt`` under ``use_planner`` JAX's knobs,
  and ``kv_pool_blocks`` JAX's pool; two planned steps give JAX's losses
  at fp32 2e-4 (tests/test_kernels.py's fp32 tolerance).
- ``sync="auto"`` with ``dp = 2`` resolves JAX's ``plan.resolve_sync()``
  schedule and trains bitwise as the trainer built with it by name, in
  both trainer modes (one-rank trainers on threads sharing a
  ``HashStore``, every group with a 60 s timeout; no test starts a
  process).
- ``--plan`` runs through the launcher's ``main([...])``, and a model
  the port cannot run is refused before a parameter is materialized.
"""
import copy
import json
import threading
from datetime import timedelta
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.api import JobSpec as JJobSpec
from repro.api import Session as JSession
from repro.api import report as jreport
from repro.api import validate_report as jax_validate_report
from repro.configs.base import get_config as jget_config
from repro.models import common as jcommon
from repro.models import model as JM
from repro.train import loop as jloop
from repro_torch.api import JobSpec, Report, Session, validate_report
from repro_torch.api import report as treport
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.core import hardware as thw
from repro_torch.distributed.trainer import DataParallelTrainer
from repro_torch.models import model as TM
from repro_torch.models.blocks import RunConfig
from repro_torch.models.common import tree_items
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim.adamw import OptConfig
from repro_torch.train import loop as tloop

GOLDENS = Path(__file__).resolve().parent / "goldens"
REPORT_GOLDENS = ("report_v1_plan.json", "report_v1_train.json",
                  "tuning_v1.json", "report_v1_serve.json")
TIMEOUT = timedelta(seconds=60)
JOIN_S = 120
# the TPU clusters both packages price identically
SHARED_TOPOLOGIES = ("2x4", "4x4-ib", "flat8", "p2-2x8")
# MLA, MoE and the dense prelude, and the Mamba slot: ported, so trained
# and served below
MOE_MLA = ("minicpm3-4b", "deepseek-v2-236b", "arctic-480b")
MAMBA = ("mamba2-780m", "jamba-1.5-large-398b")
# the sliding-window slot, the codebooks and the image prefix: the last
# three archs, ported too (once refused here)
LAST_THREE = ("musicgen-large", "llava-next-34b", "gemma2-27b")
assert set(ARCH_IDS) == set(("granite-3-2b", "qwen2-72b") + MOE_MLA + MAMBA
                            + LAST_THREE)


def _load(name):
    return json.loads((GOLDENS / name).read_text())


# ---------------------------------------------------------------------------
# The schema: JAX's goldens and their mutations
# ---------------------------------------------------------------------------


def test_requirement_tables_are_jax_s():
    for name in ("SCHEMA_ID", "TUNING_SCHEMA_ID", "SERVING_SCHEMA_ID",
                 "KINDS", "_MEASURED_REQUIRED", "_TUNING_REQUIRED",
                 "_SPEC_REQUIRED", "_PLAN_REQUIRED", "_PREDICTED_REQUIRED",
                 "_SYNC_OVERLAP_REQUIRED", "_ASYNC_REQUIRED",
                 "_SERVING_REQUIRED", "_SERVING_SUBKEYS", "_SERVING_MODES"):
        assert getattr(treport, name) == getattr(jreport, name), name


@pytest.mark.parametrize("name", REPORT_GOLDENS)
def test_golden_reports_validate(name):
    d = _load(name)
    assert validate_report(d) is d
    rep = Report.from_json(json.dumps(d))
    assert rep.to_dict() == d
    assert Report.from_dict(rep.to_dict()).validate() == rep


def _required_paths(d):
    """(section, key) deletions that must each break validation, from the
    validator's own tables (as tests/test_goldens.py)."""
    paths = [(None, k) for k in ("schema", "kind", "spec", "plan",
                                 "measured", "predicted")]
    paths += [("spec", k) for k in treport._SPEC_REQUIRED]
    paths += [("plan", k) for k in treport._PLAN_REQUIRED]
    paths += [("predicted", k) for k in treport._PREDICTED_REQUIRED]
    paths += [("measured", k)
              for k in treport._MEASURED_REQUIRED.get(d["kind"], ())]
    return paths


def _rejected(d):
    with pytest.raises(ValueError):
        validate_report(d)
    with pytest.raises(ValueError):  # and JAX agrees
        jax_validate_report(d)


@pytest.mark.parametrize("name", REPORT_GOLDENS)
def test_golden_rejects_deletions_and_corruption(name):
    golden = _load(name)
    for section, key in _required_paths(golden):
        d = copy.deepcopy(golden)
        (d if section is None else d[section]).pop(key)
        _rejected(d)
    for corrupt in (lambda d: d.update(schema="repro.api/report/v0"),
                    lambda d: d.update(kind="vibes"),
                    lambda d: d.update(spec=[])):
        d = copy.deepcopy(golden)
        corrupt(d)
        _rejected(d)


def test_golden_section_mutations_rejected():
    """The sync-overlap, pipe, tuning and serving sections' mutations of
    tests/test_goldens.py; the metrics section's schema too."""
    train = _load("report_v1_train.json")
    for key in treport._SYNC_OVERLAP_REQUIRED:
        d = copy.deepcopy(train)
        d["measured"]["sync"].pop(key)
        _rejected(d)
    for corrupt in (
            lambda s: s.update(overlap_fraction=2.0),
            lambda s: s.update(
                exposed_comm_time=s["measured_comm_s"] * 10 + 1.0)):
        d = copy.deepcopy(train)
        corrupt(d["measured"]["sync"])
        _rejected(d)
    d = copy.deepcopy(train)
    d["measured"]["metrics"]["schema"] = "repro.api/metrics/v0"
    _rejected(d)

    plan = _load("report_v1_plan.json")
    for corrupt in (
            lambda p: p.update(n_microbatch=p["pipe"] - 1),
            lambda p: p.pop("n_microbatch"),
            lambda p: p.update(pipe=p["pipe"] * 2),
            lambda p: p.update(pipe=0)):
        d = copy.deepcopy(plan)
        corrupt(d["plan"])
        _rejected(d)
    d = copy.deepcopy(plan)
    d["plan"].pop("pipe")  # a legacy plan dict still validates
    validate_report(d)

    tune = _load("tuning_v1.json")
    for key in treport._TUNING_REQUIRED:
        d = copy.deepcopy(tune)
        d["measured"]["tuning"].pop(key)
        _rejected(d)
    for corrupt in (
            lambda t: t.update(schema="repro.api/tuning/v0"),
            lambda t: t["overlap"].update(overlap_fraction=-0.5)):
        d = copy.deepcopy(tune)
        corrupt(d["measured"]["tuning"])
        _rejected(d)

    serve = _load("report_v1_serve.json")
    for key in treport._SERVING_REQUIRED:
        d = copy.deepcopy(serve)
        d["measured"]["serving"].pop(key)
        _rejected(d)
    for sect, keys in treport._SERVING_SUBKEYS.items():
        for key in keys:
            d = copy.deepcopy(serve)
            d["measured"]["serving"][sect].pop(key)
            _rejected(d)
    for corrupt in (
            lambda s: s.update(schema="repro.api/serving/v0"),
            lambda s: s.update(mode="adaptive"),
            lambda s: s["kv_cache"].update(peak_occupancy=1.5),
            lambda s: s["latency_s"].update(p50=s["latency_s"]["p99"] + 1.0),
            lambda s: s["replica_lemma"]["predicted"].pop("replicas")):
        d = copy.deepcopy(serve)
        corrupt(d["measured"]["serving"])
        _rejected(d)


def test_async_section_checked():
    d = _load("report_v1_train.json")
    d["spec"]["staleness"] = 2
    _rejected(d)  # a staleness spec needs a measured.async_ps section
    d["measured"]["async_ps"] = {
        "staleness": 2, "backup_workers": 0, "dp": 2, "steps": 4,
        "refreshes": 3, "mean_age": 0.5, "max_age": 2, "drops": 0,
        "t_step_model": {"push": 0.1, "pull": 0.05, "straggler_wait": 0.0,
                         "efficiency": 0.8, "wall_step": 1.0}}
    validate_report(d)
    jax_validate_report(d)
    for corrupt in (lambda a: a.update(max_age=3),
                    lambda a: a.update(drops=1),
                    lambda a: a["t_step_model"].pop("wall_step")):
        bad = copy.deepcopy(d)
        corrupt(bad["measured"]["async_ps"])
        _rejected(bad)


# ---------------------------------------------------------------------------
# Every kind the Session emits, through both validators
# ---------------------------------------------------------------------------

_TRAIN = dict(steps=2, batch=4, seq=16, log_every=0)
_SERVE = dict(requests=3, n_new=4, s_max=64, max_batch=2)
KIND_SPECS = {
    "plan": ("plan", {}),
    "dryrun": ("dryrun", dict(shape="decode_32k", mesh="multi")),
    "train_planned": ("train", dict(_TRAIN, use_planner=True)),
    "bench": ("bench", dict(_TRAIN)),
    "serve_continuous": ("serve", dict(_SERVE)),
    "serve_static": ("serve", dict(_SERVE, serve_mode="static")),
    "dp2_auto": ("train", dict(_TRAIN, dp=2)),
    "async_ps": ("train", dict(_TRAIN, dp=2, staleness=1, backup_workers=1)),
}


@pytest.mark.parametrize("case", sorted(KIND_SPECS))
def test_every_session_kind_passes_both_validators(case):
    method, kw = KIND_SPECS[case]
    sess = Session(JobSpec(arch="granite-3-2b", **kw), device="cpu")
    rep = getattr(sess, method)()
    d = json.loads(rep.to_json())
    assert validate_report(d) == d
    jax_validate_report(d)
    assert d["kind"] == method and d["schema"] == treport.SCHEMA_ID
    # the meshes name the H100 clusters: the plan is priced on the card
    assert d["plan"]["topology"]["chip"] == "h100-sxm"
    assert d["plan"]["topology"]["name"] == \
        ("h100-2x8" if kw.get("mesh") == "multi" else "h100-8")
    lemma31 = d["predicted"]["lemma31"]
    assert lemma31["source"] == ("measured" if method in ("train", "bench")
                                 else "model")
    if method in ("train", "bench"):
        assert lemma31["r_o"] == d["measured"]["r_o"]
    if case == "dp2_auto":
        assert d["measured"]["sync"]["strategy"] == \
            sess.resolved_plan.sync_schedule == "reduce_scatter_all_gather"
        assert d["measured"]["sync"]["link_bw"] == 4e9  # CPU ranks
    if case == "async_ps":
        assert d["measured"]["sync"]["strategy"] == "parameter_server"
        assert "async_ps" in d["predicted"]["lemma32"]
    if method == "serve":
        lemma = d["measured"]["serving"]["replica_lemma"]
        assert lemma["predicted"]["replicas"] >= 1
        assert lemma["predicted"]["t_step_s"] > 0
    if method == "dryrun":
        assert d["predicted"]["memory_bytes"]["kv_cache"] > 0
        assert d["predicted"]["fits"] == d["plan"]["fits"]


# ---------------------------------------------------------------------------
# Session-level parity where both packages price the same cluster
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_session_plan_and_dryrun_equal_jax_on_2x4(arch):
    for kw in ({}, dict(shape="prefill_32k", sync_overlap=True),
               dict(shape="decode_32k"),
               dict(dp=8, batch=8, staleness=1, backup_workers=1)):
        spec = dict(arch=arch, topology="2x4", **kw)
        tsess = Session(JobSpec(**spec), device="cpu")
        jsess = JSession(JJobSpec(**spec))
        for method in ("plan", "dryrun"):
            got = getattr(tsess, method)().to_dict()
            want = getattr(jsess, method)().to_dict()
            assert got["plan"] == want["plan"], (arch, kw, method)
            assert got["predicted"] == want["predicted"], (arch, kw, method)
            assert got["plan"]["topology"]["chip"] == "tpu-v5e"


def test_session_plan_equals_jax_on_every_shared_topology():
    for topo in SHARED_TOPOLOGIES:
        for kw in ({}, dict(pipe=2), dict(sync_overlap=True, bucket_mb=1.0)):
            spec = dict(arch="granite-3-2b", topology=topo, **kw)
            got = Session(JobSpec(**spec), device="cpu").plan().to_dict()
            want = JSession(JJobSpec(**spec)).plan().to_dict()
            assert got["plan"] == want["plan"], (topo, kw)
            assert got["predicted"] == want["predicted"], (topo, kw)


@pytest.mark.parametrize("topo", SHARED_TOPOLOGIES)
def test_build_run_opt_and_kv_pool_equal_jax(topo):
    for arch in ("granite-3-2b", "qwen2-72b", "mamba2-780m"):
        for planner in (True, False):
            spec = dict(arch=arch, topology=topo, use_planner=planner,
                        steps=40, batch=4, lr=2e-3)
            trun, topt = Session(JobSpec(**spec),
                                 device="cpu").build_run_opt()
            jrun, jopt = JSession(JJobSpec(**spec)).build_run_opt()
            for f in ("attn_impl", "remat", "microbatch", "kv_block",
                      "q_block", "bf16_grads"):
                assert getattr(trun, f) == getattr(jrun, f), (spec, f)
            assert vars(topt) == vars(jopt)
    for kw in (dict(), dict(max_batch=8, s_max=4096, kv_block=64),
               dict(reduced=False, max_batch=64, s_max=1 << 20),
               dict(max_kv_blocks=7)):
        for arch in ("granite-3-2b", "jamba-1.5-large-398b"):
            spec = dict(arch=arch, topology=topo, **kw)
            assert Session(JobSpec(**spec), device="cpu").kv_pool_blocks() \
                == JSession(JJobSpec(**spec)).kv_pool_blocks(), spec


def test_kv_pool_is_eq5_on_the_h100():
    """On the card the pool is the smaller of the run's working set and
    Eq. 5 on the H100's 80 GB."""
    from repro_torch.core import memory_model as mm

    spec = JobSpec(arch="granite-3-2b", reduced=False, max_batch=64,
                   s_max=1 << 20)
    sess = Session(spec, device="cpu")
    want = mm.max_kv_blocks(sess.cfg, 80e9, block_size=16, max_batch=64)
    assert 0 < want < 64 * (1 << 20) // 16
    assert sess.kv_pool_blocks() == want
    assert Session(JobSpec(arch="granite-3-2b"),
                   device="cpu").kv_pool_blocks() == 4 * 256 // 16


def _cfgs():
    kw = dict(vocab_size=512, dtype="float32")
    return (jget_config("granite-3-2b").reduced().replace(**kw),
            get_config("granite-3-2b").reduced().replace(**kw))


def test_planned_steps_match_jax_losses():
    """Two reduced steps with the knobs use_planner adopts on 2x4 (dense
    attention, no remat, microbatch 1 of a batch of 4: gradient
    accumulation), from the same params: JAX's losses at fp32 2e-4."""
    spec = dict(arch="granite-3-2b", topology="2x4", use_planner=True,
                steps=2, batch=4, seq=32)
    trun, topt = Session(JobSpec(**spec), device="cpu").build_run_opt()
    jrun, jopt = JSession(JJobSpec(**spec)).build_run_opt()
    assert (trun.attn_impl, trun.remat, trun.microbatch) == \
        ("dense", "none", 1)
    jcfg, tcfg = _cfgs()
    jp = jcommon.materialize(JM.model_specs(jcfg), jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                           "cpu")
    kw = dict(batch=4, seq=32, steps=2, seed=5, log_every=0)
    want = jloop.train(jcfg, jrun, jopt,
                       params=jax.tree_util.tree_map(jnp.array, jp), **kw)
    got = tloop.train(tcfg, trun, topt, device="cpu", params=tp, **kw)
    err = np.abs(np.asarray(got.losses) - np.asarray(want.losses)).max()
    assert err <= 2e-4 + 2e-4 * np.abs(want.losses).max(), \
        (got.losses, want.losses)


# ---------------------------------------------------------------------------
# sync="auto" with dp > 0: DataParallelTrainer.from_plan
# ---------------------------------------------------------------------------


def _small():
    return (get_config("granite-3-2b").reduced().replace(
                vocab_size=256, d_model=64, num_heads=2, num_kv_heads=1,
                head_dim=32, d_ff=128, dtype="float32"),
            RunConfig(attn_impl="dense", remat="none"),
            OptConfig(lr=1e-3, warmup_steps=0, total_steps=8))


def _equal(a, b):
    return all(torch.equal(x, y)
               for (_, x), (_, y) in zip(tree_items(a), tree_items(b)))


def _train(tr, steps=3):
    try:
        res = tr.train(batch=8, seq=16, steps=steps, log_every=0)
        return tr.params[0], res, tr.report()
    finally:
        tr.close()


@pytest.mark.parametrize("topo", ["", "2x4"])
def test_sync_auto_resolves_jax_s_schedule_and_trains_bitwise(topo):
    """The Session's dp = 2 ``sync="auto"`` trainer runs the plan's
    schedule (on 2x4, JAX's ``plan.resolve_sync()``), and from_plan's
    trainer equals the one built with that schedule by name, bitwise."""
    spec = JobSpec(arch="granite-3-2b", topology=topo, dp=2, **_TRAIN)
    sess = Session(spec, device="cpu")
    plan = sess.resolved_plan
    rep = sess.train()
    assert rep.measured["sync"]["strategy"] == plan.sync_schedule
    if topo:
        want = JSession(JJobSpec(arch="granite-3-2b", topology=topo, dp=2,
                                 **_TRAIN)).resolved_plan.resolve_sync()
        got = plan.resolve_sync()
        assert (got.name, got.n_servers, got.tiers) == \
            (want.name, want.n_servers, want.tiers) == \
            ("hier_all_reduce", None, (4, 2))
    kw = dict(devices=["cpu"] * 2, group_timeout=TIMEOUT)
    tr = DataParallelTrainer.from_plan(plan, *_small(), **kw)
    assert tr.topology == plan.cluster and tr.link_bw == 4e9
    p_plan, res_plan, rep_plan = _train(tr)
    p_name, res_name, rep_name = _train(DataParallelTrainer(
        *_small(), strategy=plan.sync_schedule, topology=plan.cluster, **kw))
    assert rep_plan.strategy == rep_name.strategy == plan.sync_schedule
    assert res_plan.losses == res_name.losses
    assert _equal(p_plan, p_name)


def test_from_plan_one_rank_trainers_in_threads_equal_threaded():
    """from_plan in one-rank mode (rank=r, world=2, store=...), each rank
    on its own thread over one HashStore, bitwise the all-ranks
    from_plan trainer; the rank keywords pass through."""
    plan = Session(JobSpec(arch="granite-3-2b", topology="2x4", dp=2,
                           **_TRAIN), device="cpu").resolved_plan
    want, _, _ = _train(DataParallelTrainer.from_plan(
        plan, *_small(), devices=["cpu"] * 2, group_timeout=TIMEOUT))
    store = dist.HashStore()
    out, errors = [None] * 2, []

    def rank(r):
        try:
            out[r] = _train(DataParallelTrainer.from_plan(
                plan, *_small(), devices=["cpu"], rank=r, world=2,
                store=store, group_timeout=TIMEOUT))
        except BaseException as e:  # surfaced in the test's thread
            errors.append(e)
            raise

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    if errors:
        raise errors[0]
    for r in range(2):
        assert out[r][2].strategy == "hier_all_reduce"
        assert _equal(out[r][0], want)


def test_from_plan_defaults_on_cards():
    """from_plan hands the constructor the plan's topology (h100-8) and no
    link bandwidth of its own, and the plan's overlap knobs."""
    plan = Session(JobSpec(arch="granite-3-2b", sync_overlap=True,
                           bucket_mb=2.0), device="cpu").resolved_plan
    seen = {}

    class Probe(DataParallelTrainer):
        def __init__(self, *a, **kw):
            seen.update(kw)

    Probe.from_plan(plan, *_small(), devices=["cuda:0"])
    assert seen["link_bw"] is None
    assert seen["topology"] == thw.get_cluster("h100-8")
    assert seen["sync_overlap"] is True and seen["bucket_mb"] == 2.0
    assert seen["strategy"].name == plan.sync_schedule
    Probe.from_plan(plan, *_small(), devices=["cpu"], link_bw=1e9,
                    sync_overlap=False)
    assert seen["link_bw"] == 1e9 and seen["sync_overlap"] is False


class _Built(Exception):
    pass


@pytest.mark.parametrize("topology", ["h100-8", "h100-2x8", ""])
def test_auto_and_named_trainers_price_one_link_on_cards(monkeypatch,
                                                          topology):
    """Session._trainer on two cards: sync="auto" (from_plan) and the
    plan's schedule by name (the constructor) price Lemma 3.2 on the same
    link, the topology's narrowest tier or h100-8's NVLink.  The real
    constructor runs up to its parameters; no card here, so the device
    check and model_specs are stubbed."""
    from repro_torch.distributed import trainer as trainer_mod

    def stop(cfg):
        raise _Built

    built = []
    init = DataParallelTrainer.__init__

    def grab(self, *a, **kw):
        built.append(self)
        init(self, *a, **kw)

    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    auto = Session(JobSpec(arch="granite-3-2b", dp=2, topology=topology),
                   device="cpu")
    named = Session(JobSpec(arch="granite-3-2b", dp=2, topology=topology,
                            sync=auto.resolved_plan.sync_schedule),
                    device="cpu")
    monkeypatch.setattr(trainer_mod, "resolve_device", torch.device)
    monkeypatch.setattr(trainer_mod.M, "model_specs", stop)
    monkeypatch.setattr(DataParallelTrainer, "__init__", grab)
    want = thw.get_cluster(topology or "h100-8").min_bw
    links = {}
    for sync, sess in (("auto", auto), ("named", named)):
        monkeypatch.setattr(sess, "_dp_devices", lambda: cards)
        with pytest.raises(_Built):
            sess._trainer(*_small()[1:], None, None)
        tr = built.pop()
        tr._pool.shutdown()
        links[sync] = (tr.link_bw, tr.strategy.name)
    assert links["auto"] == links["named"]
    assert links["auto"][0] == want


# ---------------------------------------------------------------------------
# The launcher's --plan, and the refusals
# ---------------------------------------------------------------------------


def test_launcher_plan_runs_in_process(capsys):
    from repro_torch.launch import train as launcher

    launcher.main(["--arch", "granite-3-2b", "--steps", "2", "--batch", "4",
                   "--seq", "16", "--device", "cpu", "--plan", "--dp", "2"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("planner: Plan(arch='granite-3-2b'")
    assert "topology={'name': 'h100-8', 'chip': 'h100-sxm'" in out[0]
    assert "sync resolved from planner: reduce_scatter_all_gather" in out
    assert any(line.startswith("sync report:") for line in out)
    assert json.loads(out[-1])["kind"] == "train"


@pytest.mark.parametrize("arch", MOE_MLA + MAMBA + LAST_THREE)
def test_moe_mla_archs_train_and_serve_through_both_validators(arch):
    """minicpm3-4b, deepseek-v2-236b, arctic-480b, mamba2-780m and
    jamba-1.5-large-398b (once refused here) train and serve at reduced
    size on the CPU: both serve modes, the MoE aux in the loss, and every
    report through both packages' validate_report.  The static engine
    prefills at the batch's longest prompt, and a Mamba scan takes a
    length past its chunk only if the chunk divides it (JAX asserts so):
    the workload's prompts of 33-47 tokens fail the reduced chunk of 32
    (ValueError), so static serving of a Mamba arch runs at chunk 64."""
    rep = Session(JobSpec(arch=arch, **_TRAIN), device="cpu").train()
    d = json.loads(rep.to_json())
    assert validate_report(d) == d
    jax_validate_report(d)
    assert all(np.isfinite(d["measured"]["losses"]))
    cfg = get_config(arch).reduced()
    if arch in MAMBA:
        with pytest.raises(ValueError, match="not a multiple of chunk 32"):
            Session(JobSpec(arch=arch, serve_mode="static", **_SERVE),
                    device="cpu").serve()
    for mode in ("continuous", "static"):
        config = (cfg.replace(ssm_chunk=64)
                  if arch in MAMBA and mode == "static" else None)
        rep = Session(JobSpec(arch=arch, serve_mode=mode, **_SERVE),
                      config=config, device="cpu").serve()
        d = json.loads(rep.to_json())
        assert validate_report(d) == d
        jax_validate_report(d)
        assert d["measured"]["n_tokens"] == sum(
            r["tokens"] for r in d["measured"]["per_request"])


@pytest.mark.parametrize("arch", LAST_THREE)
def test_unported_arch_refused_before_materializing(arch, monkeypatch):
    """Its specs exist (the planner prices it); what the port still
    refuses for it is refused before any parameter is made: a pipeline
    under torchrun (Next 19) for each, and any 1F1B pipeline for the
    codebook and image-prefix models, as JAX's pipeline refuses them."""

    def no_params(*a, **k):
        raise AssertionError("parameters were materialized")

    monkeypatch.setattr(TM, "materialize", no_params)
    assert TM.model_specs(get_config(arch))
    sess = Session(JobSpec(arch=arch, **_TRAIN), device="cpu")
    assert sess.plan().plan["arch"] == arch
    spec = JobSpec(arch=arch, pipe=2, n_microbatch=2, **_TRAIN)
    if arch != "gemma2-27b":
        with pytest.raises(NotImplementedError, match="pipeline"):
            Session(spec, device="cpu").train()
    from repro_torch.distributed import trainer as ttrainer

    monkeypatch.setattr(ttrainer, "torchrun_env", lambda: ttrainer.TorchrunEnv(
        0, 2, 0, "localhost", 29500))
    with pytest.raises(NotImplementedError, match="ROADMAP Next 19"):
        Session(spec, device="cpu").train()
