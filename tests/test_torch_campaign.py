"""The port's campaigns (``repro_torch.api.campaign``, ``Session.sweep``)
and the twins of the paper's experiment scripts, against the JAX package
on the CPU.

- ``pareto_front`` and ``_cell_metrics`` give JAX's numbers on the same
  points (ties included).
- ``Session.sweep(kind="plan" | "dryrun")`` on JAX's own grids
  (``tests/test_topology.py``'s 8 cells, on TPU clusters both packages
  price identically) gives JAX's ``summary()`` exactly; the reports pass
  both validators, and each package's ``Campaign`` reads the other's JSON
  and JAX's golden.
- An infeasible cell is skipped with JAX's error text; any other error (a
  kernel fault, ``KernelError``, or a bug) propagates.
- The measured kinds run on one or two reduced cells; a train cell's
  losses equal JAX's ``Session.train()`` from the same params at 2e-4.
- ``benchmarks/torch_sweep.py --quick`` runs in this process;
  ``torch_lemma32_ps_sizing`` and ``torch_table2_conv_memory`` give JAX's
  rows; ``torch_fig2_throughput_vs_batch`` JAX's algorithm per batch.

No test here starts a process.
"""
import copy
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.api import Campaign as JCampaign
from repro.api import JobSpec as JJobSpec
from repro.api import Report as JReport
from repro.api import Session as JSession
from repro.api import campaign as jcampaign
from repro.api import validate_report as jax_validate_report
from repro.models import common as jcommon
from repro.models import model as JM
from repro_torch.api import (CAMPAIGN_SCHEMA_ID, COMPRESSIONS, MESHES,
                             SYNCS, TOPOLOGIES, Campaign, JobSpec, Report,
                             Session, pareto_front, validate_report)
from repro_torch.api import campaign as tcampaign
from repro_torch.api import spec as tspec
from repro_torch.kernels._build import KernelError
from repro_torch.models import model as TM
from repro_torch.models.common import DeviceCountError
from repro_torch.models.convert import params_from_numpy

REPO = Path(__file__).resolve().parent.parent
GOLDENS = REPO / "tests" / "goldens"
BASE = dict(arch="granite-3-2b", steps=2, batch=4, seq=32)
# tests/test_topology.py::test_session_sweep_campaign_pareto's grid
GRID8 = {"topology": ["flat8", "2x4"], "arch": ["granite-3-2b", "mamba2-780m"],
         "batch": [4, 8]}


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _both_valid(rep):
    d = json.loads(rep.to_json())
    validate_report(d)
    jax_validate_report(d)


# ---------------------------------------------------------------------------
# The campaign module
# ---------------------------------------------------------------------------


def test_exports_and_schema_are_jax_s():
    import repro.api as japi

    assert CAMPAIGN_SCHEMA_ID == jcampaign.CAMPAIGN_SCHEMA_ID
    for name, got in (("MESHES", MESHES), ("SYNCS", SYNCS),
                      ("COMPRESSIONS", COMPRESSIONS),
                      ("TOPOLOGIES", TOPOLOGIES)):
        assert got is getattr(tspec, name)
        assert set(getattr(japi, name)) <= set(got), name
    assert Session.SWEEP_KINDS == JSession.SWEEP_KINDS


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pareto_front_equals_jax_with_ties(seed):
    rng = np.random.default_rng(seed)
    # values on a coarse grid, so many points tie on one axis or both
    pts = [{"tokens_per_s": float(t), "efficiency": float(e)}
           for t, e in rng.integers(0, 4, (24, 2)) / 4.0]
    pts += [dict(pts[0]), dict(pts[3])]  # exact duplicates
    assert pareto_front(pts) == jcampaign.pareto_front(pts)
    assert pareto_front(pts)
    assert pareto_front([]) == jcampaign.pareto_front([]) == []


def test_cell_metrics_equal_jax_measured_and_predicted():
    plan = Session(JobSpec(**BASE, topology="2x4"), device="cpu").plan()
    d = plan.to_dict()
    cases = [d["plan"]]
    inf_plan = dict(d["plan"], est_step_time=float("inf"), fits=False)
    cases.append(inf_plan)
    for p in cases:
        for measured in ({}, {"tokens_per_s": 1234.5}):
            got = tcampaign._cell_metrics(Report(
                kind="plan", spec=d["spec"], plan=p, measured=measured))
            want = jcampaign._cell_metrics(JReport(
                kind="plan", spec=d["spec"], plan=p, measured=measured))
            assert got == want
    assert tcampaign._cell_metrics(plan)["source"] == "predicted"


# ---------------------------------------------------------------------------
# Session.sweep against JAX's
# ---------------------------------------------------------------------------


def test_plan_sweep_equals_jax_and_artifacts_cross():
    camp = Session.sweep(JobSpec(**BASE), GRID8, kind="plan", device="cpu")
    jcamp = JSession.sweep(JJobSpec(**BASE), GRID8, kind="plan")
    assert len(camp) == 8 and not camp.skipped
    assert camp.cells == jcamp.cells
    assert camp.summary() == jcamp.summary()  # exact floats
    for rep in camp.reports:
        _both_valid(rep)
    by_topo = {c["topology"]: m for c, m in zip(camp.cells, camp.metrics())}
    assert by_topo["2x4"]["schedule"] == "hier_all_reduce"
    # each package's Campaign reads the other's artifact
    back = JCampaign.from_json(camp.to_json())
    assert back.summary() == camp.summary()
    mine = Campaign.from_json(jcamp.to_json())
    assert mine.summary() == jcamp.summary()
    assert mine.summary()["pareto_indices"] == camp.summary()["pareto_indices"]
    assert json.loads(camp.to_json())["schema"] == CAMPAIGN_SCHEMA_ID


def test_dryrun_sweep_equals_jax():
    grid = {"topology": ["flat8", "2x4"]}
    camp = Session.sweep(JobSpec(**BASE), grid, kind="dryrun", device="cpu")
    jcamp = JSession.sweep(JJobSpec(**BASE), grid, kind="dryrun")
    assert camp.summary() == jcamp.summary()
    for rep, jrep in zip(camp.reports, jcamp.reports):
        assert rep.kind == "dryrun"
        assert rep.plan == jrep.plan and rep.predicted == jrep.predicted
        _both_valid(rep)


def test_invalid_cell_skipped_with_jax_s_error_and_bad_calls_raise():
    camp = Session.sweep(JobSpec(**BASE), {"dp": [1, 3]}, kind="plan",
                         device="cpu")
    jcamp = JSession.sweep(JJobSpec(**BASE), {"dp": [1, 3]}, kind="plan")
    assert len(camp) == 1 and camp.skipped == jcamp.skipped
    assert camp.skipped[0]["cell"] == {"dp": 3}
    with pytest.raises(ValueError):
        Session.sweep(JobSpec(**BASE), {}, kind="plan", device="cpu")
    with pytest.raises(ValueError):
        Session.sweep(JobSpec(**BASE), {"dp": [1]}, kind="explode",
                      device="cpu")


def test_kernel_fault_propagates_infeasible_cell_is_skipped(monkeypatch):
    import torch

    real = Session.plan
    faults = {
        8: KernelError("flash_attention: CUDA kernel launch failed with "
                       "error 700"),
        12: RuntimeError("CUDA error: an illegal memory access was "
                         "encountered"),
        28: RuntimeError("The size of tensor a (4) must match the size of "
                         "tensor b (8) at non-singleton dimension 1"),
        32: KeyError("slot1"),
    }
    infeasible = {
        16: ValueError("wrapper refused these inputs"),
        20: torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                        "allocate 12.00 GiB"),
        24: NotImplementedError("not ported yet (ROADMAP Next 8)"),
        36: DeviceCountError("dp=2 but only 1 devices visible"),
    }

    def plan(self):
        err = faults.get(self.spec.batch) or infeasible.get(self.spec.batch)
        if err is not None:
            raise err
        return real(self)

    monkeypatch.setattr(Session, "plan", plan)
    camp = Session.sweep(JobSpec(**BASE), {"batch": [4, 16, 20, 24, 36]},
                         kind="plan", device="cpu")
    assert camp.cells == [{"batch": 4}]
    assert camp.skipped == [
        {"cell": {"batch": b}, "error": f"{type(e).__name__}: {e}"}
        for b, e in infeasible.items()]
    for b, e in faults.items():
        with pytest.raises(type(e)):
            Session.sweep(JobSpec(**BASE), {"batch": [4, b, 16]},
                          kind="plan", device="cpu")
    assert issubclass(KernelError, RuntimeError)


def test_no_card_raises_before_any_cell():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="cuda"):
        Session.sweep(JobSpec(**BASE), {"batch": [4]}, kind="plan")


# ---------------------------------------------------------------------------
# The measured kinds
# ---------------------------------------------------------------------------


def test_train_cells_measured_and_equal_jax_losses(monkeypatch):
    """Two reduced train cells; each one's losses equal JAX's
    Session.train() on the same spec from the same params (JAX's init,
    converted) at fp32 2e-4 (both sessions run the arch in fp32, as the
    other whole-model parity tests do: in bf16 JAX's one-hot attention
    turns 1-ulp differences into 1e-3 of the loss after one update)."""
    import repro.api.session as jsession_mod
    import repro_torch.api.session as tsession_mod
    from repro.configs.base import get_config as jget_config
    from repro_torch.configs.base import get_config

    monkeypatch.setattr(tsession_mod, "get_config",
                        lambda a: get_config(a).replace(dtype="float32"))
    monkeypatch.setattr(jsession_mod, "get_config",
                        lambda a: jget_config(a).replace(dtype="float32"))
    real_init = TM.init_params

    def jax_init(cfg, seed, device):
        jcfg = jget_config(cfg.name).reduced().replace(dtype=cfg.dtype)
        jp = jcommon.materialize(JM.model_specs(jcfg),
                                 jax.random.PRNGKey(seed))
        assert jcfg.d_model == cfg.d_model
        return params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg,
                                 device)

    monkeypatch.setattr(TM, "init_params", jax_init)
    base = dict(arch="granite-3-2b", steps=2, seq=16, log_every=0)
    camp = Session.sweep(JobSpec(**base), {"batch": [2, 4]}, kind="train",
                         device="cpu")
    monkeypatch.setattr(TM, "init_params", real_init)
    assert camp.kind == "train" and len(camp) == 2 and not camp.skipped
    for cell, m, rep in zip(camp.cells, camp.metrics(), camp.reports):
        _both_valid(rep)
        assert m["source"] == "measured" and m["tokens_per_s"] > 0
        want = JSession(JJobSpec(**base, batch=cell["batch"])).train()
        got = np.asarray(rep.measured["losses"])
        ref = np.asarray(want.measured["losses"])
        assert np.abs(got - ref).max() <= 2e-4 + 2e-4 * np.abs(ref).max(), \
            (cell, got, ref)
    assert JCampaign.from_json(camp.to_json()).summary() == camp.summary()


def test_serve_and_tune_cells_measured(tmp_path):
    serve = Session.sweep(
        JobSpec(arch="granite-3-2b", requests=3, n_new=4, s_max=64),
        {"max_batch": [1, 2]}, kind="serve", device="cpu")
    assert len(serve) == 2 and not serve.skipped
    for rep in serve.reports:
        _both_valid(rep)
        assert rep.measured["n_tokens"] > 0
    assert all(m["source"] == "measured" for m in serve.metrics())
    tune = Session.sweep(
        JobSpec(arch="granite-3-2b", steps=2, batch=2, seq=32, tune=True,
                tune_steps=2, tune_cache=str(tmp_path / "cal.json")),
        {"seed": [0]}, kind="tune", device="cpu")
    assert len(tune) == 1 and not tune.skipped
    _both_valid(tune.reports[0])
    t = tune.reports[0].measured["tuning"]
    assert t["calibration"]["measured"]["copy_mb"] == 32.0  # JAX's, on CPU
    assert Campaign.from_json(tune.to_json()).summary() == tune.summary()


# ---------------------------------------------------------------------------
# JAX's golden
# ---------------------------------------------------------------------------


def test_golden_campaign_loads_and_rejects_corruption():
    raw = json.loads((GOLDENS / "campaign_v1.json").read_text())
    camp = Campaign.from_dict(raw)
    assert len(camp) == 2 and camp.kind == raw["kind"]
    for rep in camp.reports:
        validate_report(json.loads(rep.to_json()))
    assert camp.summary() == JCampaign.from_dict(raw).summary()
    bad = copy.deepcopy(raw)
    bad["schema"] = "repro.api/campaign/v0"
    with pytest.raises(ValueError):
        Campaign.from_dict(bad)
    bad = copy.deepcopy(raw)
    bad["reports"][0].pop("plan")
    with pytest.raises(ValueError):
        Campaign.from_dict(bad)


# ---------------------------------------------------------------------------
# The benchmark twins
# ---------------------------------------------------------------------------


def test_torch_sweep_quick_in_process(tmp_path, capsys):
    out = tmp_path / "campaign.json"
    camp = _script("torch_sweep").main(["--quick", "--device", "cpu",
                                        "--out", str(out)])
    assert "wrote" in capsys.readouterr().out
    back = JCampaign.from_json(out.read_text())
    assert len(back) == 4 and back.kind == "train" and not back.skipped
    m = back.metrics()
    assert all(c["source"] == "measured" and c["tokens_per_s"] > 0 for c in m)
    assert back.summary()["pareto"]
    assert {tuple(sorted(c.items())) for c in camp.cells} == {
        (("dp", dp), ("sync", s)) for dp in (1, 2)
        for s in ("all_reduce", "reduce_scatter_all_gather")}


def test_lemma32_and_table2_rows_equal_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # no results/dryrun: JAX's cross-check off
    for jax_name, name, own in (
            ("lemma32_ps_sizing", "torch_lemma32_ps_sizing", "lemma32_h100"),
            ("table2_conv_memory", "torch_table2_conv_memory", "")):
        want, got = [], []
        _script(jax_name).run(want)
        mod = _script(name)
        if own:
            mod.run(got)
            assert any(r[0].startswith(own) for r in got)
            got = [r for r in got if not r[0].startswith(own)]
        else:
            mod.run(got, device="cpu")
        assert got == want, name
        assert want


def test_fig2_algorithm_per_batch_equals_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # both scripts write results/ here
    jfig2 = _script("fig2_throughput_vs_batch")
    monkeypatch.setattr(jfig2, "_throughput", lambda *a, **k: 1.0)
    want = []
    jfig2.run(want)
    fig2 = _script("torch_fig2_throughput_vs_batch")
    monkeypatch.setattr(fig2, "throughput", lambda *a, **k: 1.0)
    got = []
    rep = fig2.run_default(got, device="cpu")
    assert [(r[0], r[2]) for r in got] == [(r[0], r[2]) for r in want]
    assert {r[2] for r in got} == {"dense", "chunked"}  # the knee is inside
    _both_valid(rep)
    assert [p["algorithm"] for p in rep.measured["points"]] == \
        [r[2] for r in want]
