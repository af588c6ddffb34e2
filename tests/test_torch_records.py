"""The port's record trail and benchmark harness against the JAX package's,
on the CPU at the reduced config:

- ``tools/torch_bench_trajectory.py`` distils a port Report into JAX's
  ``_train_record``/``_serve_record`` floats exactly, and its ``compare``
  gives JAX's verdicts (within budget, over the 35% budget, a first
  landing, a changed spec) on the same two records; it reads the commit
  from ``.git`` without starting a process; the committed
  ``BENCH_torch_{train,serve}.json`` hold full-width card records;
- ``benchmarks/torch_serve_continuous.py``'s ``measure`` passes checks 1
  and 2, and its heads, both runtimes' ``decode_token_steps`` and
  ``replicas_predicted`` equal JAX's ``Session.serve()`` on the same spec
  from the same params (JAX's init, converted; both in fp32);
- ``benchmarks/torch_telemetry.py`` at dp 2 (threaded gloo ranks)
  reconciles its spans, and both Reports pass both validators;
- ``benchmarks/torch_ilp_planner.py``'s single-pod rows equal
  ``benchmarks/ilp_planner.py``'s exactly, with an ``h100-8`` row per arch;
- ``benchmarks/torch_dp_scaling.py``'s Fig. 4 columns equal JAX's
  ``amdahl.speedup``, ``multi_device_speedup`` and ``pipelined_speedup``
  on the same ``StepTimes`` to 1e-12;
- ``benchmarks/torch_run.py`` prints the CSV, refuses the two names
  without a twin (Queue A item 5) and unknown ones, and ``--fast`` drops
  JAX's names.

No test here starts a process, and none checks a wall clock.
"""
import importlib.util
import json
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.api import JobSpec as JJobSpec
from repro.api import Session as JSession
from repro.api import validate_report as jax_validate_report
from repro.configs.base import get_config as jget_config
from repro.core import amdahl as jamdahl
from repro.core import pipeline as jpipe
from repro.models import common as jcommon
from repro.models import model as JM
from repro.obs import validate_metrics as jax_validate_metrics
from repro_torch.api import validate_report
from repro_torch.configs.base import ARCH_IDS
from repro_torch.core import pipeline as tpipe
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.obs import validate_metrics

REPO = Path(__file__).resolve().parent.parent


def _load(rel: str):
    path = REPO / rel
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


traj = _load("tools/torch_bench_trajectory.py")
jtraj = _load("tools/bench_trajectory.py")


@pytest.fixture(scope="module")
def telemetry(tmp_path_factory):
    tel = _load("benchmarks/torch_telemetry.py")
    out = tmp_path_factory.mktemp("telemetry")
    return tel.measure(tel.parse_args(
        ["--device", "cpu", "--reduced", "--quick", "--no-bench-append",
         "--outdir", str(out)]))


def _jax_init(cfg, seed, device):
    """JAX's init of the reduced ``cfg``, converted to the port's tree."""
    jcfg = jget_config(cfg.name).reduced().replace(dtype=cfg.dtype)
    jp = jcommon.materialize(JM.model_specs(jcfg), jax.random.PRNGKey(seed))
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg,
                             device)


@pytest.fixture(scope="module")
def serve_cell(tmp_path_factory):
    """measure() of the --quick cell in fp32 from JAX's init (converted;
    ``--init seeded``), with the module's parsed args."""
    sc = _load("benchmarks/torch_serve_continuous.py")
    args = sc.parse_args(["--device", "cpu", "--reduced", "--quick",
                          "--dtype", "float32", "--init", "seeded",
                          "--no-bench-append",
                          "--outdir", str(tmp_path_factory.mktemp("serve"))])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TM, "init_params", _jax_init)
        out = sc.measure(args)
        # every head token of both runtimes against the plain forward of
        # the same weights
        tf = sc.teacher_forced(args, out)
    return sc, args, out, tf


# ---------------------------------------------------------------------------
# tools/torch_bench_trajectory.py
# ---------------------------------------------------------------------------


def test_distilled_records_equal_jax(telemetry, serve_cell):
    """The same floats, to 0, on the port's train and serve Reports."""
    _, _, out, _ = serve_cell
    reps = [("train", telemetry["train"]), ("serve", telemetry["serve"]),
            ("serve", out["continuous"]), ("serve", out["static"])]
    for area, rep in reps:
        d = json.loads(rep.to_json())
        got = traj.DISTILL[area](d)
        assert got == jtraj.DISTILL[area](d), area
    train = traj._train_record(json.loads(telemetry["train"].to_json()))
    assert {"overlap_fraction", "exposed_comm_s"} <= set(train)
    serve = traj._serve_record(json.loads(out["continuous"].to_json()))
    assert serve["wasted_decode_steps"] == 0.0
    assert traj.HEADLINE == jtraj.HEADLINE
    assert traj.DEFAULT_BUDGET == jtraj.DEFAULT_BUDGET == 0.35
    assert traj.TRAJECTORY_SCHEMA_ID == jtraj.TRAJECTORY_SCHEMA_ID


def _scaled(rep, factor=1.0, n_new=None):
    d = json.loads(rep.to_json())
    d["measured"]["tokens_per_s"] *= factor
    if n_new is not None:
        d["spec"]["n_new"] = n_new
    return d


@pytest.mark.parametrize("case", ["within", "over", "first", "spec"])
def test_append_and_compare_verdicts_equal_jax(case, serve_cell, tmp_path,
                                               monkeypatch, capsys):
    _, _, out, _ = serve_cell
    rep = out["continuous"]
    traj.append_record("serve", _scaled(rep), root=tmp_path, sha="a" * 7,
                       note="first")
    second = {"within": _scaled(rep, 0.9), "over": _scaled(rep, 0.5),
              "first": _scaled(rep, 0.5),
              "spec": _scaled(rep, 0.5, n_new=99)}[case]
    rec = traj.append_record("serve", second, root=tmp_path, sha="b" * 7)
    path = traj.trajectory_path("serve", tmp_path)
    assert path == tmp_path / "BENCH_torch_serve.json"
    d = json.loads(path.read_text())
    assert d["schema"] == "repro.obs/bench-trajectory/v1"
    assert [r["sha"] for r in d["records"]] == ["aaaaaaa", "bbbbbbb"]
    assert d["records"][0]["note"] == "first" and "note" not in rec
    if case == "first":  # the previous record has no tokens/s yet
        d["records"][0]["metrics"]["tokens_per_s"] = 0.0
        path.write_text(json.dumps(d))
    capsys.readouterr()
    got = traj.compare("serve", root=tmp_path)
    got_out = capsys.readouterr().out
    monkeypatch.setattr(jtraj, "trajectory_path", lambda area: path)
    want = jtraj.compare("serve")
    want_out = capsys.readouterr().out
    assert [m.replace("BENCH_torch_", "BENCH_") for m in got] == want
    assert got_out.replace("BENCH_torch_", "BENCH_") == want_out
    assert bool(want) == (case == "over")
    if case == "first":
        assert "no baseline" in want_out
    if case == "spec":
        assert "spec changed" in want_out


@pytest.mark.parametrize("area", ["train", "serve"])
def test_committed_trajectories_are_full_width_card_runs(area):
    """``BENCH_torch_<area>.json`` at the repo root: JAX's schema, and each
    record a full-width run whose note names a card (not the CPU), with
    the area's headline metrics."""
    d = traj.load_trajectory(area)
    assert d["schema"] == jtraj.TRAJECTORY_SCHEMA_ID and d["area"] == area
    assert d["records"]
    for rec in d["records"]:
        assert rec["spec"]["reduced"] is False and rec["kind"] == area
        assert rec["note"] and not rec["note"].startswith("cpu")
        assert set(traj.HEADLINE[area]) <= set(rec["metrics"])


@pytest.mark.parametrize("layout", ["ref", "packed", "detached", "none"])
def test_sha_read_from_git_without_a_process(layout, tmp_path):
    sha = "0123456789abcdef0123456789abcdef01234567"
    git = tmp_path / ".git"
    if layout != "none":
        (git / "refs" / "heads").mkdir(parents=True)
    if layout == "ref":
        (git / "HEAD").write_text("ref: refs/heads/main\n")
        (git / "refs" / "heads" / "main").write_text(sha + "\n")
    elif layout == "packed":
        (git / "HEAD").write_text("ref: refs/heads/main\n")
        (git / "packed-refs").write_text(
            "# pack-refs with: peeled fully-peeled sorted\n"
            f"{'f' * 40} refs/heads/other\n{sha} refs/heads/main\n")
    elif layout == "detached":
        (git / "HEAD").write_text(sha + "\n")
    assert traj.git_sha(tmp_path) == ("unknown" if layout == "none"
                                      else sha[:7])


# ---------------------------------------------------------------------------
# The serve and telemetry cells
# ---------------------------------------------------------------------------


def test_serve_cell_checks_and_equals_jax(serve_cell):
    sc, args, out, tf = serve_cell
    for check in (sc.check_streams, sc.check_decode_work):
        ok, msg = check(out)
        assert ok, msg
    for mode in sc.MODES:
        validate_report(json.loads(out[mode].to_json()))
    summary = json.loads((Path(args.outdir)
                          / "torch_serve_continuous_summary.json").read_text())
    assert summary["dtype"] == "float32"
    assert Path(summary["report"]).exists()
    jcfg = jget_config(args.arch).reduced().replace(dtype="float32")
    spec = sc.base_spec(args).to_dict()
    base = {k: spec[k] for k in ("arch", "reduced", "shape", "requests",
                                 "n_new", "s_max", "max_batch", "seed",
                                 "arrival")}
    for mode in sc.MODES:
        want = JSession(JJobSpec(**base, serve_mode=mode),
                        config=jcfg).serve().measured
        got = out[mode].measured
        assert sc.heads(out[mode]) == {r["rid"]: r["head"]
                                       for r in want["per_request"]}, mode
        for key in ("decode_token_steps", "wasted_decode_steps",
                    "engine_steps"):
            assert got["serving"]["throughput"][key] == \
                want["serving"]["throughput"][key], (mode, key)
        assert got["serving"]["replica_lemma"]["predicted"]["replicas"] == \
            want["serving"]["replica_lemma"]["predicted"]["replicas"], mode
    assert out["summary"]["replicas_predicted"] == \
        out["continuous"].measured["serving"]["replica_lemma"]["predicted"][
            "replicas"]
    # teacher-forced on its own head, each runtime took the plain dense
    # forward's top-1 at every step of every request
    for mode in sc.MODES:
        r = tf[mode]
        assert r["tokens"] == sum(len(h) for h in sc.heads(out[mode])
                                  .values()) == 37, (mode, r)
        assert r["off_top"] == 0 and r["deficit"] == 0.0, (mode, r)


def test_parted_streams_are_located(serve_cell, monkeypatch):
    """Check 1 names the request and step where the heads part, and the
    teacher-forced witness finds the altered tokens off the plain
    forward's top-1; check 2 fails on waste."""
    sc, args, out, _ = serve_cell
    parted = dict(out)
    cont = json.loads(out["continuous"].to_json())
    cont["measured"]["per_request"][2]["head"][3] += 1
    parted["continuous"] = types.SimpleNamespace(measured=cont["measured"])
    cont["measured"]["per_request"][4]["head"][0] += 1
    assert sc.parting_steps(parted) == {2: 3, 4: 0}
    assert sc.first_divergence(parted) == (2, 3)
    ok, msg = sc.check_streams(parted)
    assert not ok and "request 2, step 3" in msg and "2 of 5" in msg
    monkeypatch.setattr(TM, "init_params", _jax_init)
    note = sc.parting_note(args, parted)
    assert "request 2, step 3" in note and "static took" in note
    # the altered tokens are off the plain forward's top-1: the teacher-
    # forced witness finds both
    tf = sc.teacher_forced(args, parted)
    assert tf["static"]["off_top"] == 0
    assert tf["continuous"]["off_top"] >= 2
    assert tf["continuous"]["deficit"] > 0 and "off its top-1" in note
    cont["measured"]["serving"]["throughput"]["wasted_decode_steps"] = 1
    assert not sc.check_decode_work(parted)[0]


def test_serve_cell_smoothed_weights_hold_checks(tmp_path):
    """The cell's default weights (the seeded init with smoothed
    attention) in the arch's own bf16: checks 1 and 2 hold, both runtimes
    serve the same smoothed weights, and they are not the seeded ones."""
    sc = _load("benchmarks/torch_serve_continuous.py")
    args = sc.parse_args(["--device", "cpu", "--reduced", "--quick",
                          "--no-bench-append", "--outdir", str(tmp_path)])
    assert args.init == "smooth"
    out = sc.measure(args)
    for check in (sc.check_streams, sc.check_decode_work):
        ok, msg = check(out)
        assert ok, msg
    s = out["summary"]
    assert (s["init"], s["dtype"], s["attn"]) == ("smooth", "bfloat16",
                                                  "kernel")
    from repro_torch.configs.base import get_config

    cfg = get_config(args.arch).reduced()
    smooth = sc.weights(args, cfg, "cpu")
    args.init = "seeded"
    seeded = sc.weights(args, cfg, "cpu")
    wq = lambda p: p["slots"]["slot0"]["mixer"]["wq"]  # noqa: E731
    assert wq(smooth).dtype == wq(seeded).dtype
    assert not torch.equal(wq(smooth), wq(seeded))
    assert torch.equal(smooth["embed"], seeded["embed"])


@pytest.mark.parametrize("case", ["bf16-cuda", "fp32-cuda", "fp32-cpu",
                                  "mla-cpu"])
def test_serve_attn_impl_routes_by_dtype_and_device(case):
    """``"kernel"`` for a GQA model in bf16 on either device and in any
    dtype on the CPU (the kernels' plain versions); ``"dense"`` for fp32 on
    a CUDA device (the kernels take bf16 only) and for MLA anywhere."""
    from repro_torch.api.session import serve_attn_impl
    from repro_torch.configs.base import get_config

    arch = "minicpm3-4b" if case == "mla-cpu" else "granite-3-2b"
    cfg = get_config(arch)
    if case.startswith("fp32"):
        cfg = cfg.replace(dtype="float32")
    device = case.split("-")[1]
    want = "dense" if case in ("fp32-cuda", "mla-cpu") else "kernel"
    assert serve_attn_impl(cfg, device) == want
    assert serve_attn_impl(cfg) == ("dense" if case == "mla-cpu"
                                    else "kernel")


def test_telemetry_cell_reconciles_at_dp2(telemetry):
    train, serve = telemetry["train"], telemetry["serve"]
    sync = train.measured["sync"]
    assert train.spec["dp"] == 2 and sync["sync_overlap"]
    assert sync["n_buckets"] == len(sync["per_bucket_comm_s"]) > 1
    for rep in (train, serve):
        d = json.loads(rep.to_json())
        validate_report(d)
        jax_validate_report(d)
        validate_metrics(d["measured"]["metrics"])
        jax_validate_metrics(d["measured"]["metrics"])
    assert Path(train.meta["trace_file"]).exists()
    assert telemetry["train_report"].exists()
    assert telemetry["serve_report"].exists()


# ---------------------------------------------------------------------------
# The ILP planner, Fig. 4's columns and the harness
# ---------------------------------------------------------------------------


def test_ilp_rows_equal_jax():
    want, got = [], []
    _load("benchmarks/ilp_planner.py").run(want)
    _load("benchmarks/torch_ilp_planner.py").run(got)
    own = ("ilp_h100", "planner_h100")
    assert [r for r in got if r[0].split("/")[0] not in own] == want
    for prefix in own:
        assert sorted(r[0].split("/")[1] for r in got
                      if r[0].split("/")[0] == prefix) == sorted(ARCH_IDS)


@pytest.mark.parametrize("pipe", [0, 2, 4])
def test_fig4_columns_equal_jax(pipe):
    dps = _load("benchmarks/torch_dp_scaling.py")
    jfig4 = _load("benchmarks/fig4_speedup.py")
    rng = np.random.default_rng(pipe)
    for _ in range(4):
        phases = dict(zip(("data_load", "data_prep", "h2d", "compute",
                           "param_update", "dist_update", "param_refresh"),
                          rng.uniform(0.0, 0.2, 7) * [1, 1, 1, 5, 1, 1, 1]))
        t, jt = tpipe.StepTimes(**phases), jpipe.StepTimes(**phases)
        m = 4 * max(pipe, 1)
        for g in (1, 2, 4, 8):
            cell = dps.fig4_cell(t, g, pipe, m)
            r_o = jt.r_o()
            want = {"estimated": jamdahl.speedup(g, r_o),
                    "actual_sim": jpipe.multi_device_speedup(jt, g)}
            if pipe > 1 and g % pipe == 0:
                want["pipelined_1f1b"] = jfig4.pipelined_speedup(g, r_o,
                                                                 pipe, m)
            assert set(cell) == set(want)
            for k, v in want.items():
                assert abs(cell[k] - v) <= 1e-12, (g, pipe, k)


def test_harness_csv_and_refusals(capsys, tmp_path, monkeypatch):
    run = _load("benchmarks/torch_run.py")
    rows = run.main(["--only", "ilp,lemma32", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "name,value,derived" in out
    prefixes = {r[0].split("/")[0] for r in rows}
    assert {"ilp", "ilp_h100", "planner", "planner_h100", "lemma32"} <= \
        prefixes
    for name, value, derived in rows[:5]:
        assert f"{name},{value},{derived}" in out
    # the dry-run twins run; with no records in the working dir their
    # tables are empty
    monkeypatch.chdir(tmp_path)
    rows = run.main(["--only", "dryrun,roofline", "--device", "cpu"])
    assert ("dryrun/ok_fraction", 0.0, "0/0") in rows
    assert (tmp_path / "results" / "torch_roofline.md").exists()
    with pytest.raises(ValueError, match="unknown benchmark"):
        run.select("ilp,nope", False)
    assert run.ALL == _load("benchmarks/run.py").ALL
    assert set(run.entries("cpu", True)) == set(run.DEFAULT)


def test_fast_drops_jax_s_names(monkeypatch):
    """JAX's harness under --fast, every module faked: the names it runs
    are the port's --fast list."""
    ran = []
    pkg = types.ModuleType("benchmarks")
    pkg.__path__ = []
    monkeypatch.setitem(sys.modules, "benchmarks", pkg)
    for mod in ("table2_conv_memory", "fig2_throughput_vs_batch",
                "fig3_convergence", "fig4_speedup", "lemma32_ps_sizing",
                "sync_strategies", "sweep", "autotune", "ilp_planner",
                "dryrun_summary", "roofline", "telemetry",
                "serve_continuous"):
        fake = types.ModuleType(f"benchmarks.{mod}")
        fake.run = lambda rows, mod=mod: ran.append(mod)
        monkeypatch.setitem(sys.modules, f"benchmarks.{mod}", fake)
        setattr(pkg, mod, fake)
    jrun = _load("benchmarks/run.py")
    monkeypatch.setattr(sys, "argv", ["run", "--fast"])
    jrun.main()
    names = {"table2_conv_memory": "table2", "lemma32_ps_sizing": "lemma32",
             "sweep": "sweep", "ilp_planner": "ilp",
             "dryrun_summary": "dryrun", "roofline": "roofline"}
    want = [names[m] for m in ran]
    port = _load("benchmarks/torch_run.py")
    assert port.select(",".join(port.DEFAULT), True) == want
    assert set(want) <= set(port.DEFAULT)
