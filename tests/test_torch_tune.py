"""The port's closed-loop autotuner (``repro_torch.core.autotune`` beyond
the kernel stage, ``Chip.scaled`` and the ``Session`` plumbing) against
the JAX package's ``repro.core.autotune`` on the same inputs.

The calibration, the cache keys, the minibatch procedure and the
calibrated plans are Python arithmetic in both packages, copied in the
same order, so they are held EXACTLY equal.  The measured stages run here
on the CPU at a small size; on the card ``chip_smoke.py`` phase 12 runs
``Session.tune()`` at full width.  The one-process-per-rank path runs as
one-rank calls in threads on one shared ``HashStore``: no test in this
file starts a process.
"""
import dataclasses
import json
import threading
from datetime import timedelta

import pytest
import torch.distributed as dist

from repro.api import JobSpec as JJobSpec
from repro.api import Session as JSession
from repro.api import validate_report as jax_validate_report
from repro.configs.base import get_config as jget_config
from repro.configs.base import get_shape as jget_shape
from repro.core import autotune as jtune
from repro.core import hardware as jhw
from repro.core import planner as jplanner
from repro_torch.api import JobSpec, Session, validate_report
from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config, get_shape
from repro_torch.core import autotune as ttune
from repro_torch.core import hardware as thw
from repro_torch.core import memory_model as tmm
from repro_torch.core import planner as tplanner

JOIN_S = 120
# the shapes the minibatch procedure prices (plan_train's kinds)
TRAIN_SHAPES = tuple(n for n, s in SHAPES.items()
                     if s.kind in ("train", "prefill"))
CAL_FIELDS = dict(backend="torch-cuda", cluster="h100-8",
                  achieved_flops=7.5e13, matmul_flops=4.1e13, hbm_bw=2.9e12,
                  link_bw=0.0, arch="granite-3-2b@d2048L40",
                  measured={"best_compute_s": 0.21, "batch": 2.0})


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
    """(port MeshSpec, JAX MeshSpec): a named cluster, or ``flat``, the
    single-tier mesh without a topology."""
    if name == "flat":
        return (thw.MeshSpec(chips=8, dp=8, tp=1),
                jhw.MeshSpec(chips=8, dp=8, tp=1))
    c = thw.get_cluster(name)
    return (thw.MeshSpec.from_cluster(c),
            jhw.MeshSpec.from_cluster(_jax_cluster(c)))


def _chip_fields(c) -> tuple:
    return (c.name, c.peak_flops, c.hbm_bytes, c.hbm_bw, c.link_bw)


def _cals(**kw):
    """The same Calibration in both packages."""
    fields = dict(CAL_FIELDS, **kw)
    return ttune.Calibration(**fields), jtune.Calibration(**fields)


# ---------------------------------------------------------------------------
# Chip.scaled, Calibration.apply, cache keys, the fit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chip", [c.name for c in thw.CHIPS])
def test_chip_scaled_equals_jax(chip):
    tchip = next(c for c in thw.CHIPS if c.name == chip)
    jchip = _jax_chip(tchip)
    for kw in ({}, dict(peak_flops=1e12), dict(hbm_bw=2e11, link_bw=3e9),
               dict(peak_flops=0.0, hbm_bw=None, link_bw=5e8)):
        got, want = tchip.scaled(**kw), jchip.scaled(**kw)
        assert _chip_fields(got) == _chip_fields(want), kw
        assert got.calibrated and got.name == chip + "+cal"
        # scaling an overlay again keeps one marker
        assert _chip_fields(got.scaled(**kw)) == \
            _chip_fields(want.scaled(**kw))
        assert got.scaled().name == chip + "+cal"


@pytest.mark.parametrize("mesh", ["h100-8", "h100-2x8", "2x4", "flat"])
@pytest.mark.parametrize("link_bw", [0.0, 1.25e9])
def test_calibration_apply_equals_jax(mesh, link_bw):
    tmesh, jmesh = _meshes(mesh)
    tcal, jcal = _cals(link_bw=link_bw)
    got, want = tcal.apply(tmesh), jcal.apply(jmesh)
    assert _chip_fields(got.chip) == _chip_fields(want.chip)
    assert got.chip.name.endswith("+cal") and got.chip.peak_flops == 7.5e13
    assert (got.chips, got.dp, got.tp) == (want.chips, want.dp, want.tp)
    gc, wc = got.cluster, want.cluster
    assert gc.name == wc.name and gc.tier_sizes == wc.tier_sizes
    assert gc.tier_bws == wc.tier_bws
    base = tmesh.cluster
    if link_bw:  # the bottleneck tier is anchored at the measured link
        assert gc.min_bw == pytest.approx(link_bw, rel=1e-12)
    else:
        assert gc.tier_bws == base.tier_bws
    # the +cal chip round-trips through the plan's cluster JSON as its
    # data-sheet base, in both packages
    d = gc.to_dict()
    assert d == wc.to_dict() and d["chip"] == base.chip.name + "+cal"
    assert thw.ClusterSpec.from_dict(d).chip.name == base.chip.name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cfg_cache_key_equals_jax(arch):
    full, jfull = get_config(arch), jget_config(arch)
    assert ttune.cfg_cache_key(full) == jtune.cfg_cache_key(jfull)
    assert ttune.cfg_cache_key(full.reduced()) == \
        jtune.cfg_cache_key(jfull.reduced())
    assert ttune.cfg_cache_key(full) != ttune.cfg_cache_key(full.reduced())


MEASURED = {
    "dp0": {"steps": 3, "batch": 2, "seq": 512, "dp": 0,
            "best_step_s": 0.3125, "best_compute_s": 0.2175,
            "mean_step_s": 0.33, "mean_compute_s": 0.23, "mean_comm_s": 0.0},
    "dp2": {"steps": 3, "batch": 4, "seq": 256, "dp": 2,
            "best_step_s": 0.41, "best_compute_s": 0.0,
            "mean_compute_s": 0.19, "sync": {"effective_link_bw": 3.7e10}},
}
MICRO = {"matmul_flops": 5.2e13, "triad_bw": 2.61e12}


@pytest.mark.parametrize("case", sorted(MEASURED))
@pytest.mark.parametrize("arch", ["granite-3-2b", "mamba2-780m",
                                  "deepseek-v2-236b"])
def test_fit_calibration_equals_jax(case, arch):
    kw = dict(batch=MEASURED[case]["batch"], seq=MEASURED[case]["seq"],
              measured=MEASURED[case], micro=MICRO, backend="torch-cuda",
              cluster_name="h100-8")
    got = ttune.fit_calibration(get_config(arch), **kw).to_dict()
    want = jtune.fit_calibration(jget_config(arch), **kw).to_dict()
    got.pop("created")
    want.pop("created")
    assert got == want
    assert got["achieved_flops"] > 0
    assert got["link_bw"] == (3.7e10 if case == "dp2" else 0.0)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_tune_minibatch_and_calibrated_plans_equal_jax(arch):
    """The paper's procedure and the re-plan, for every train shape on
    both H100 clusters, with and without a measured link and overlap."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    for mesh in ("h100-8", "h100-2x8"):
        tmesh, jmesh = _meshes(mesh)
        for shape in TRAIN_SHAPES:
            tshape, jshape = get_shape(shape), jget_shape(shape)
            tbase = tplanner.plan(cfg, tshape, tmesh)
            jbase = jplanner.plan(jcfg, jshape, jmesh)
            got = ttune.tune_minibatch(cfg, tshape, tmesh, tbase)
            assert got == jtune.tune_minibatch(jcfg, jshape, jmesh, jbase)
            assert tmm.m_bound(tmm.ALEXNET, got["chosen"],
                               got["m_gpu_bytes"]) >= 0
            for kw in ({}, dict(link_bw=2e10, bucket_mb=4.0,
                                overlap_fraction=0.25)):
                tcal, jcal = _cals(**kw)
                assert tplanner.plan(cfg, tshape, tcal.apply(tmesh)).to_dict() \
                    == jplanner.plan(jcfg, jshape, jcal.apply(jmesh)).to_dict()


def test_granite_train_4k_numbers():
    """The numbers the H100 procedure gives the production job: Eq. 5 on
    80 GB and the plan's own microbatch."""
    tmesh, _ = _meshes("h100-8")
    cfg, shape = get_config("granite-3-2b"), get_shape("train_4k")
    got = ttune.tune_minibatch(cfg, shape, tmesh,
                               tplanner.plan(cfg, shape, tmesh))
    assert got["chosen"] == 21464
    assert got["microbatch"]["chosen"] == 7
    assert got["microbatch"]["plan_microbatch"] == 1


# ---------------------------------------------------------------------------
# The JSON cache, across packages
# ---------------------------------------------------------------------------


def test_each_package_reads_the_others_cache(tmp_path):
    path = tmp_path / "cache.json"
    tcal, jcal = _cals()
    jcal = dataclasses.replace(jcal, backend="cpu")  # jax.default_backend()
    ttune.save_calibration(path, tcal)
    jtune.save_calibration(path, jcal)  # merges, does not clobber
    assert tcal.key != jcal.key and tcal.key.count("/") == 2
    d = json.loads(path.read_text())
    assert d["schema"] == ttune.CACHE_SCHEMA_ID == jtune.CACHE_SCHEMA_ID
    assert sorted(d["calibrations"]) == sorted([tcal.key, jcal.key])
    for load in (ttune.load_cache, jtune.load_cache):
        assert load(path) == d["calibrations"]
    assert ttune.cached_calibration(path, jcal.key).to_dict() == \
        jcal.to_dict()
    assert jtune.cached_calibration(path, tcal.key).to_dict() == \
        tcal.to_dict()
    ttune.save_calibration(path, dataclasses.replace(tcal, hbm_bw=1.0))
    assert jtune.cached_calibration(path, tcal.key).hbm_bw == 1.0
    assert jtune.cached_calibration(path, jcal.key).to_dict() == \
        jcal.to_dict()
    # a file of another schema, or not JSON at all, reads as empty
    path.write_text(json.dumps({"schema": "other/v0",
                                "calibrations": d["calibrations"]}))
    assert ttune.load_cache(path) == jtune.load_cache(path) == {}
    path.write_text("{not json")
    assert ttune.load_cache(path) == jtune.load_cache(path) == {}
    assert ttune.load_cache(tmp_path / "missing.json") == {}
    assert ttune.DEFAULT_CACHE_PATH == jtune.DEFAULT_CACHE_PATH
    assert ttune.TUNING_SCHEMA_ID == jtune.TUNING_SCHEMA_ID


def _tune_result(kernels):
    cal, _ = _cals()
    return ttune.TuneResult(
        backend="torch-cuda", cluster="h100-8",
        minibatch={"chosen": 3, "microbatch": {"chosen": 5}},
        kernels=kernels, conv_alg={}, calibration=cal, measured={},
        replan={}, tuned_plan=None)


@pytest.mark.parametrize("flash,ssd,attn,chunk", [
    ("kernel", "kernel_chunk64", "auto", 64),
    ("ref", "kernel_chunk128", "dense", 128),
    ("kernel", "ref", "auto", None),
    ("", "", "auto", None),
])
def test_tune_result_choices(flash, ssd, attn, chunk):
    kernels = {"flash_attention": {"chosen": flash},
               "ssd_scan": {"chosen": ssd}}
    res = _tune_result(kernels if flash else {})
    assert res.attn_impl() == attn and res.ssd_chunk() == chunk
    assert (res.chosen_minibatch, res.chosen_microbatch) == (3, 5)
    sec = res.section()
    assert sec["schema"] == ttune.TUNING_SCHEMA_ID
    assert sec["calibration"] == res.calibration.to_dict()


# ---------------------------------------------------------------------------
# Session.tune() end to end on the CPU
# ---------------------------------------------------------------------------


def _spec(tmp_path, **kw):
    base = dict(arch="granite-3-2b", reduced=True, steps=2, batch=2, seq=16,
                log_every=0, tune=True, tune_steps=2,
                tune_cache=str(tmp_path / "cal.json"))
    base.update(kw)
    return JobSpec(**base)


def test_session_tune_acceptance(tmp_path):
    """JAX's acceptance test on the port: a tune report valid under both
    packages' validators whose chosen minibatch is the largest
    m_bound-feasible batch, whose calibrated re-plan beats the data sheet,
    and whose calibration is cached under backend/cluster/config; then a
    train() on the same session adopts the tuned knobs."""
    spec = _spec(tmp_path)
    sess = Session(spec, device="cpu")
    rep = sess.tune()
    d = json.loads(rep.to_json())
    validate_report(d)
    jax_validate_report(d)
    assert d["kind"] == "tune"
    t = d["measured"]["tuning"]
    assert t["schema"] == ttune.TUNING_SCHEMA_ID
    assert t["backend"] == "torch-cpu" and t["cluster"] == "h100-8"
    chosen, hbm = t["minibatch"]["chosen"], t["minibatch"]["m_gpu_bytes"]
    assert tmm.m_bound(tmm.ALEXNET, chosen, hbm) >= 0
    assert tmm.m_bound(tmm.ALEXNET, chosen + 1, hbm) < 0
    r = t["replan"]
    assert r["calibrated_closer"]
    assert r["abs_err_calibrated_s"] <= r["abs_err_uncalibrated_s"]
    assert set(t["kernels"]) == {"flash_attention", "decode_attention",
                                 "paged_decode_attention", "ssd_scan"}
    assert all(e["chosen"] in e["times_s"] and not e["errors"]
               for e in t["kernels"].values())
    assert t["overlap"] == {"measured": False,
                            "note": "needs dp >= 2 ranks (dp=0)"}
    key = ttune.Calibration.from_dict(t["calibration"]).key
    assert key == "torch-cpu/h100-8/" + ttune.cfg_cache_key(sess.cfg)
    cached = ttune.cached_calibration(spec.tune_cache, key)
    assert cached is not None and cached.achieved_flops > 0
    assert jtune.cached_calibration(spec.tune_cache, key) == \
        jtune.Calibration.from_dict(cached.to_dict())
    # every stage is a span, and the tune/* metrics ride in the report
    for name in ("bench_kernels", "measure", "tune_overlap", "replan"):
        assert len(sess.last_tracer.events(name)) == 1, name
    gauges = d["measured"]["metrics"]["gauges"]
    assert gauges["tune/calibration_from_cache"] == 0.0
    assert gauges["tune/measured_step_s"] == r["measured_step_s"]
    # the production re-plan is the plan on the calibrated mesh
    assert r["production"]["calibrated"]["est_step_time"] == \
        tplanner.plan(sess.cfg_full, sess.shape,
                      cached.apply(sess.mesh_spec)).est_step_time
    trep = sess.train()
    td = json.loads(trep.to_json())
    validate_report(td)
    jax_validate_report(td)
    assert td["measured"]["tuning"]["minibatch"]["chosen"] == chosen
    run, _ = sess.build_run_opt()
    mb = t["minibatch"]["microbatch"]["chosen"]
    assert run.attn_impl == ("dense" if t["kernels"]["flash_attention"]
                             ["chosen"] == "ref" else "auto")
    assert run.microbatch == max(min(mb, spec.batch), 1) == 2


def test_second_session_reads_the_cache(tmp_path):
    spec = _spec(tmp_path)
    first = Session(spec, device="cpu").tune().measured["tuning"]
    sess = Session(spec, device="cpu")
    rep = sess.tune()
    validate_report(rep.to_dict())
    m = rep.measured
    assert m["from_cache"] and m["cache_key"].startswith("torch-cpu/")
    assert sess.last_tracer.events("measure") == []
    assert len(sess.last_tracer.events("bench_kernels")) == 1
    t = m["tuning"]
    assert t["calibration"] == first["calibration"]
    # the prediction check re-uses the cached run's wall clock
    assert t["replan"]["measured_step_s"] == \
        first["calibration"]["measured"]["best_step_s"]
    assert t["replan"]["calibrated_closer"]
    gauges = m["metrics"]["gauges"]
    assert gauges["tune/calibration_from_cache"] == 1.0
    # use_cache off, or no cache: measured again
    res = ttune.autotune(sess.cfg, sess.cfg_full, sess.shape, sess.mesh_spec,
                         batch=2, seq=16, steps=2, cache_path=spec.tune_cache,
                         use_cache=False, device="cpu")
    assert "from_cache" not in res.measured


def test_calibration_timed_at_another_triad_size_is_measured_anew(tmp_path):
    """A card's calibration cached before the 256 MiB triad names no
    ``copy_mb`` (it was timed at 32 MiB) and is not reused on a card; on
    the CPU, where the triad stays at 32 MiB, such an entry is."""
    path = tmp_path / "cal.json"
    old, _ = _cals()  # a torch-cuda entry without copy_mb
    assert "copy_mb" not in old.measured
    ttune.save_calibration(path, old)
    card_mb = ttune.triad_mb("cuda")
    assert card_mb == ttune.CARD_TRIAD_MB == 256
    assert ttune.triad_mb("cpu") == 32
    assert ttune.cached_calibration(path, old.key, copy_mb=card_mb) is None
    assert ttune.cached_calibration(path, old.key, copy_mb=32) == old
    assert ttune.cached_calibration(path, old.key) == old
    new, _ = _cals(measured=dict(CAL_FIELDS["measured"], copy_mb=256.0))
    ttune.save_calibration(path, new)
    assert ttune.cached_calibration(path, new.key, copy_mb=card_mb) == new
    # autotune looks entries up at its device's size: a CPU entry timed at
    # 256 MiB is measured anew, at 32 MiB, and replaces the stale one
    tmesh, _ = _meshes("h100-8")
    cfg = _small_cfg()
    stale = dataclasses.replace(new, backend="torch-cpu",
                                arch=ttune.cfg_cache_key(cfg))
    ttune.save_calibration(path, stale)
    assert ttune.cached_calibration(path, stale.key) == stale

    def tune():
        return ttune.autotune(cfg, get_config("granite-3-2b"),
                              get_shape("train_4k"), tmesh, batch=2, seq=16,
                              steps=2, cache_path=str(path), repeats=1,
                              bench_seq=32, device="cpu")

    assert "from_cache" not in tune().measured
    assert ttune.cached_calibration(path, stale.key).measured["copy_mb"] \
        == 32.0
    assert tune().measured["from_cache"]


def _small_cfg():
    """tests/test_torch_distributed.py's small trainer config, in fp32."""
    return get_config("granite-3-2b").reduced().replace(
        vocab_size=256, d_model=64, num_heads=2, num_kv_heads=1, head_dim=32,
        d_ff=128, dtype="float32")


BUCKETS = (0.01, 0.04)  # MiB: several buckets of the small config's grads


def _autotune(cfg, tmp_path=None, **kw):
    tmesh, _ = _meshes("h100-8")
    return ttune.autotune(
        cfg, get_config("granite-3-2b"), get_shape("train_4k"), tmesh,
        batch=4, seq=16, steps=3, dp=2, overlap_bucket_mbs=BUCKETS,
        cache_path=str(tmp_path / "cal.json") if tmp_path else "",
        repeats=1, bench_seq=32, **kw)


def test_autotune_dp2_threaded_ranks_fit_the_link_and_overlap(tmp_path):
    """dp = 2 gloo ranks in threads: the measured SyncReport gives a link
    bandwidth, the overlap sweep picks one of the candidate buckets, and
    both land in the calibration and its cache."""
    res = _autotune(_small_cfg(), tmp_path, device="cpu")
    sync = res.measured["sync"]
    assert sync["dp"] == 2 and sync["strategy"] == "all_reduce"
    assert sync["effective_link_bw"] > 0
    cal = res.calibration
    assert cal.link_bw == sync["effective_link_bw"] > 0
    ov = res.overlap
    assert ov["measured"] and ov["chosen_bucket_mb"] in BUCKETS
    assert sorted(ov["candidates"]) == sorted(f"{b:g}" for b in BUCKETS)
    assert 0.0 <= ov["overlap_fraction"] <= 1.0
    assert (cal.bucket_mb, cal.overlap_fraction) == \
        (ov["chosen_bucket_mb"], ov["overlap_fraction"])
    assert ttune.cached_calibration(tmp_path / "cal.json", cal.key) == cal
    # the calibrated mesh re-prices the bottleneck tier at the measured link
    assert cal.apply(_meshes("h100-8")[0]).cluster.min_bw == \
        pytest.approx(cal.link_bw, rel=1e-12)


def test_autotune_one_rank_per_process_adopts_rank0(tmp_path, monkeypatch):
    """The torchrun path as one-rank calls in threads on one HashStore:
    every rank measures (the trainers are collective), yet every rank
    comes out with rank 0's kernel choice and calibration, and rank 0
    alone writes the cache.  The kernel stage is made to disagree across
    ranks, so that only the store can make them agree."""
    real = ttune.bench_kernels
    lock, calls = threading.Lock(), []

    def disagreeing(**kw):  # one rank picks the plain flash, one the kernel
        out = real(**kw)
        with lock:
            pick = "ref" if not calls else "kernel"
            calls.append(pick)
        out["flash_attention"]["chosen"] = pick
        return out

    saved = []
    real_save = ttune.save_calibration

    def spy(path, cal):
        with lock:
            saved.append(threading.current_thread().name)
        return real_save(path, cal)

    monkeypatch.setattr(ttune, "bench_kernels", disagreeing)
    monkeypatch.setattr(ttune, "save_calibration", spy)
    store = dist.HashStore()
    store.set_timeout(timedelta(seconds=60))
    out, errors = [None, None], []

    def rank(r):
        try:
            threading.current_thread().name = f"rank{r}"
            out[r] = _autotune(_small_cfg(), tmp_path, device="cpu",
                               rank=r, world=2, store=store)
        except BaseException as e:  # surfaced below, in the test's thread
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
    assert sorted(calls) == ["kernel", "ref"]  # the ranks did disagree
    a, b = out
    assert a.section() == b.section()
    assert a.attn_impl() == b.attn_impl()
    assert a.chosen_microbatch == b.chosen_microbatch
    assert a.calibration.link_bw > 0 and a.overlap["measured"]
    assert saved == ["rank0"]
    assert ttune.cached_calibration(tmp_path / "cal.json",
                                    a.calibration.key) == a.calibration


# ---------------------------------------------------------------------------
# Session(calibration=...) and the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen2-72b",
                                  "mamba2-780m"])
def test_calibrated_session_plan_and_dryrun_equal_jax_on_2x4(arch):
    """A session built with calibration= prices every plan and prediction
    on the measured constants, as JAX's does: the link re-priced, and the
    overlap window derated to the measured fraction (0.0 included, when
    the sweep ran)."""
    for cal_kw in (dict(link_bw=1.5e9),
                   dict(link_bw=1.5e9, bucket_mb=4.0, overlap_fraction=0.0),
                   dict(bucket_mb=1.0, overlap_fraction=0.6)):
        tcal, jcal = _cals(cluster="2x4", **cal_kw)
        for kw in ({}, dict(sync_overlap=True),
                   dict(shape="decode_32k")):
            spec = dict(arch=arch, topology="2x4", **kw)
            tsess = Session(JobSpec(**spec), calibration=tcal, device="cpu")
            jsess = JSession(JJobSpec(**spec), calibration=jcal)
            for method in ("plan", "dryrun"):
                got = getattr(tsess, method)().to_dict()
                want = getattr(jsess, method)().to_dict()
                assert got["plan"] == want["plan"], (cal_kw, kw, method)
                assert got["predicted"] == want["predicted"], (cal_kw, kw)
                assert got["meta"]["calibration"] == \
                    want["meta"]["calibration"]
                assert got["plan"]["topology"]["chip"] == "tpu-v5e+cal"
            if kw.get("sync_overlap"):
                eff = want["predicted"]["lemma32"]["overlap"][
                    "overlap_efficiency"]
                assert eff == (cal_kw["overlap_fraction"]
                               if cal_kw.get("bucket_mb") else 1.0)


def test_calibrated_session_prices_the_h100_on_measured_constants():
    tcal, _ = _cals()
    spec = JobSpec(arch="granite-3-2b", shape="train_4k")
    cal = Session(spec, calibration=tcal, device="cpu").plan().to_dict()
    sheet = Session(spec, device="cpu").plan().to_dict()
    assert cal["plan"]["topology"]["chip"] == "h100-sxm+cal"
    assert sheet["plan"]["topology"]["chip"] == "h100-sxm"
    # 7.5e13 FLOP/s achieved against 989e12: the compute term grows
    assert cal["plan"]["est_step_time"] > sheet["plan"]["est_step_time"]
    assert cal["meta"]["calibration"]["key"] == tcal.key


def test_unported_pipe_still_raises_with_tune(tmp_path, monkeypatch):
    """pipe > 1 under torchrun (one process a stage) raises naming its
    ROADMAP item before the tuner measures anything."""
    from repro_torch.distributed import trainer as ttrainer

    monkeypatch.setattr(ttrainer, "torchrun_env", lambda: ttrainer.TorchrunEnv(
        0, 2, 0, "localhost", 29500))
    spec = _spec(tmp_path, pipe=2, dp=2)
    sess = Session(spec, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP Next 19"):
        sess.train()
    assert sess._tuned is None


def test_launcher_autotune_in_process(capsys, tmp_path):
    from repro_torch.launch import train as launcher

    cache = tmp_path / "cache.json"
    launcher.main(["--arch", "granite-3-2b", "--steps", "2", "--batch", "2",
                   "--seq", "16", "--device", "cpu", "--autotune",
                   "--tune-cache", str(cache)])
    out = capsys.readouterr().out.strip().splitlines()
    line = next(x for x in out if x.startswith("autotune: "))
    assert "minibatch*=21464 (m_bound), microbatch*=7" in line
    assert "calibrated vs" in line and "datasheet (measured" in line
    assert json.loads(out[-1])["kind"] == "train"
    assert list(json.loads(cache.read_text())["calibrations"]) == [
        "torch-cpu/h100-8/" + ttune.cfg_cache_key(
            get_config("granite-3-2b").reduced())]
    assert launcher.build_parser().get_default("tune_cache") == \
        ttune.DEFAULT_CACHE_PATH
