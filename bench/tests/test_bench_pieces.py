"""The pieces inside a layer (``attn/core``, ``moe/*``) in the join of
spans to kernels (``bench/progtrace.py``) and the per-layer metrics that
read them (``bench/pieces.py``):

- on a hand-written trace of a granite layer: the new spans, which lie
  outside the ``model/`` area, leave ``mixer_ms``, ``mlp_ms``, the
  phases and the launches as they were (an idle gap inside a piece takes
  its name), and the pieces' device time is summed over their phases;
- on a CPU-sized run of the DeepSeek-V2 cell's program step and of
  granite's, on one card and as one rank of the four-card trainer,
  under ``torch.profiler``: the result line of a traced run
  prints every new metric of the cell; a trace without the program's
  new spans (the parent's) reads none of them;
- the readers' sums and shares against the record by hand; a record
  with nothing to read reads nothing.
"""
from __future__ import annotations

import json
import os
import tempfile
import time

import pytest
from torch.profiler import ProfilerActivity, profile

from test_bench_mla_moe import tiny_run as tiny_moe_run
from test_bench_progtrace import (as_device_trace, device, launch,
                                  profiled_steps, span, write_trace)

from bench import flops, flops_mla_moe, harness, progtrace
from bench import run as run_mod

KIND = "NVIDIA H100 80GB HBM3"
NEW = {"attn_core_ms.train", "attn_core_roofline.train",
       "moe_dispatch_ms.train", "expert_roofline.train", "mfu_moe.train"}
DS = "deepseek-v2-train-share-s4k-fp32"


def granite_layer(with_pieces: bool):
    """One step of one layer: the mixer (projections around the core) and
    the MLP, forward, recompute inside the MLP's backward, backward."""
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1, "tid": 2,
         "ts": 600, "dur": 1},
        span("train/step", 1, 0, 2000),
        span("train/forward", 1, 0, 400),
        span("model/mixer@fwd", 1, 10, 200),
        span("model/mlp@fwd", 1, 210, 390),
        span("train/backward", 1, 400, 1900),
        span("model/mlp@bwd", 2, 500, 1000),
        span("model/mixer@recompute", 2, 510, 700),
        span("model/mixer@bwd", 2, 1100, 1800),
        launch(1, 1, 20), device(1, 20, 60),        # q/k/v projections
        launch(2, 1, 70), device(2, 70, 150),       # the core
        launch(3, 1, 160), device(3, 160, 190),     # o projection
        launch(4, 1, 220), device(4, 220, 380),     # the MLP
        launch(5, 2, 520), device(5, 520, 560),     # projections again
        launch(6, 2, 570), device(6, 570, 650),     # the core again
        launch(7, 2, 720), device(7, 720, 900),     # the MLP's backward
        launch(8, 2, 1200), device(8, 1200, 1400),  # the core's backward
        launch(9, 2, 1500), device(9, 1500, 1700),  # projections' backward
    ]
    if with_pieces:
        ev += [span("attn/core@fwd", 1, 65, 155),
               span("attn/core@recompute", 2, 565, 655),
               span("attn/core@bwd", 2, 1150, 1450)]
    return ev


def test_the_pieces_leave_the_layers_as_they_were():
    bare = progtrace.reduce_events(granite_layer(False))
    with_pieces = progtrace.reduce_events(granite_layer(True))
    for key in ("busy_ms", "launches", "forward_ms", "backward_ms",
                "recompute_ms", "mixer_ms", "mlp_ms", "head_loss_ms",
                "outside_model_ms"):
        assert with_pieces[key] == bare[key], key
    # the same gaps, a gap inside the core now named by it
    assert [g for _, g in with_pieces["idle_gaps"]] == \
        [g for _, g in bare["idle_gaps"]]
    assert ["attn/core@bwd", pytest.approx(0.100)] in with_pieces["idle_gaps"]
    assert bare["mixer_ms"] == pytest.approx(0.670)
    assert bare["mlp_ms"] == pytest.approx(0.340)
    by = with_pieces["by_span"]
    assert by["attn/core@fwd"]["device_ms"] == pytest.approx(0.080)
    assert by["attn/core@recompute"]["device_ms"] == pytest.approx(0.080)
    assert by["attn/core@bwd"]["device_ms"] == pytest.approx(0.200)
    # the core's kernels are still the mixer's
    assert by["model/mixer@fwd"]["device_ms"] == pytest.approx(0.150)


def record(config, batch, seq, **kw):
    rec = {"config": config, "batch": batch, "seq": seq, "chips": 1,
           "device_kind": KIND, "steps": 4, "window_s": 12.0, "spans": {},
           "counters": {}, "profiles": []}
    rec.update(kw)
    return rec


def test_readers_by_hand(monkeypatch):
    by_span = {"attn/core@fwd": {"device_ms": 100.0},
               "attn/core@recompute": {"device_ms": 100.0},
               "attn/core@bwd": {"device_ms": 250.0},
               "moe/route@fwd": {"device_ms": 3.0},
               "moe/dispatch@bwd": {"device_ms": 4.0},
               "moe/combine@recompute": {"device_ms": 5.0},
               "moe/experts@fwd": {"device_ms": 20.0},
               "moe/experts@bwd": {"device_ms": 40.0}}
    monkeypatch.setattr(progtrace, "readings",
                        lambda rec: [{"by_span": by_span},
                                     {"by_span": {}}])
    c = harness.config("deepseek-v2-ep8-share-fp32")
    # 2 profiled steps, 6,000 assignments to held experts kept a step
    rec = record(c, 1, 4096, counters={
        "moe.kept": {"count": 2, "sum": 12000.0},
        "moe.dropped": {"count": 2, "sum": 4000.0}})
    read = lambda n: harness.metric(n).read(rec)  # noqa: E731
    assert read("attn_core_ms.train") == pytest.approx(450.0)
    assert read("moe_dispatch_ms.train") == pytest.approx(12.0)
    core = 4 * flops_mla_moe.attn_core_flops_fwd(c, 1, 4096)
    assert read("attn_core_roofline.train") == pytest.approx(
        100 * core / (0.450 * 67e12))
    experts = 4 * 6000 * 2 * 3 * 5120 * 1536
    assert read("expert_roofline.train") == pytest.approx(
        100 * experts / (0.060 * 67e12))
    # the routed experts at the 6,000 kept, not the 12,288 expected
    model = flops_mla_moe.train_flops(c, 1, 4096) \
        - 6 * (12288 - 6000) * 3 * 5120 * 1536
    assert read("mfu_moe.train") == pytest.approx(
        100 * model / (3.0 * 67e12))
    # a program that counts no kept assignments: no expert roofline, and
    # the whole step at the expected share
    rec["counters"] = {}
    assert read("expert_roofline.train") is None
    assert read("mfu_moe.train") == pytest.approx(
        100 * flops_mla_moe.train_flops(c, 1, 4096) / (3.0 * 67e12))
    # granite: the attention core alone, per card
    g = harness.config("granite-3-2b-fp32")
    one = harness.metric("attn_core_roofline.train").read(record(g, 2, 4096))
    four = harness.metric("attn_core_roofline.train").read(
        record(g, 8, 4096, chips=4))
    assert one == pytest.approx(four) == pytest.approx(
        100 * 4 * flops.mixer_flops_fwd(g, 2, 4096) / (0.450 * 67e12))
    for name in ("expert_roofline.train", "mfu_moe.train"):
        assert harness.metric(name).read(record(g, 2, 4096)) is None


@pytest.mark.parametrize("name", sorted(NEW))
def test_a_reader_with_nothing_to_read_returns_nothing(name, tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    c = harness.config("deepseek-v2-ep8-share-fp32")
    empty = record(c, 1, 4096, steps=0, device_kind="cpu")
    assert harness.metric(name).read(empty) is None


def moe_profiled_steps(steps=2):
    """The DeepSeek-V2 driver's step and loader at CPU size, profiled:
    (the profile's events, the program's counters as the driver keeps
    them)."""
    from repro_torch.obs import trace
    from repro_torch.data.pipeline import PrefetchLoader
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import adamw

    from bench import traffic as traffic_lib, weights, weights_mla_moe
    from bench.drivers import train_mla_moe

    r = tiny_moe_run()
    B, S = int(r.traffic["batch"]), int(r.traffic["seq"])
    cfg, run_cfg, opt = train_mla_moe.session_setup(r, batch=B)
    params = weights.nested(weights_mla_moe.make(r.config, r.seed, "cpu"))
    loader = PrefetchLoader(cfg, B, S, device="cpu",
                            corpus=traffic_lib.Corpus(r.traffic,
                                                      cfg.vocab_size, r.seed))
    state = adamw.init_state(opt, params)
    step = build_train_step(cfg, run_cfg, opt)
    trace.PROFILER_TRACER.counts()  # none before the profile
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(steps):
                params, state, _ = step(params, state, next(loader)[0])
    finally:
        loader.close()
    counters = {name: {"count": steps, "sum": total}
                for name, total in trace.PROFILER_TRACER.counts().items()}
    path = os.path.join(tempfile.gettempdir(), "profile.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)["traceEvents"], counters


def traced_line(cell, counters=None):
    """``bench/run.py``'s last line of a traced run of ``cell`` on an H100
    (by name), from a record as the drivers make it."""
    r = harness.Run.of(cell, 2 ** 33 + 7, 10.0, True, time.time())
    record_ = {"config": r.config, "batch": int(r.traffic["batch"]),
               "seq": int(r.traffic["seq"]), "chips": int(r.cell["chips"]),
               "device_kind": KIND, "steps": 2, "window_s": 10.0,
               "spans": {}, "counters": counters or {}, "profiles": []}
    out = {"record": record_, "correct": True, "attempted": 1, "failed": 0,
           "checks": {}, "memory_peak_bytes": 0,
           "profiles": [{"busy_s": 1.0, "window_s": 1.0, "device_ops": [],
                         "idle_gaps": []}]}
    return run_mod.result(r, out, int(r.cell["chips"]), KIND)


def new_metrics(cell):
    return {m["name"] for m in harness.cell_metrics(
        harness.benchmark(), cell, "per_layer")} & NEW


@pytest.mark.parametrize("cell", [DS, "granite-train-s4k-fp32",
                                  "granite-train-s512-dp4-fp32"])
def test_a_traced_cpu_run_prints_every_new_metric(cell, tmp_path,
                                                  monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    events, counters = moe_profiled_steps() if cell == DS \
        else (profiled_steps(cell), {})
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert "attn/core@bwd" in names
    # torch.distributed annotates its collectives (gloo:all_reduce)
    assert all(progtrace.SPAN_NAME.match(n) for n in names if ":" not in n)
    path = write_trace(cell, as_device_trace(events))
    line = traced_line(cell, counters)
    want = new_metrics(cell)
    assert want == (NEW if cell == DS else {"attn_core_ms.train",
                                            "attn_core_roofline.train"})
    assert want <= set(line["metrics"]), want - set(line["metrics"])
    m = {k: v["value"] for k, v in line["metrics"].items()}
    red = progtrace.reduce_file(path)
    assert 0 < m["attn_core_ms.train"] < red["mixer_ms"]
    if cell == DS:
        assert 0 < m["moe_dispatch_ms.train"] < red["mlp_ms"]
        assert {"moe/experts@fwd", "moe/shared@bwd"} <= names
        assert counters["moe.kept"]["sum"] > 0
    # without the new spans (the parent's program) they read nothing
    bare = [e for e in as_device_trace(events)
            if not str(e.get("name")).startswith(("attn/", "moe/"))]
    write_trace(cell, bare)
    line = traced_line(cell)
    assert not set(line["metrics"]) & (NEW - {"mfu_moe.train"})
    assert progtrace.reduce_file(path)["mixer_ms"] == red["mixer_ms"]
