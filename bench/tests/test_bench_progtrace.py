"""The join of the program's spans to the device's work
(``bench/progtrace.py``) and the per-layer metrics that read it:

- on a hand-written Chrome trace: a kernel launched from a second thread
  (the autograd engine's), kernels overlapping on two streams, a launch
  outside every span, one from a thread the profiler does not follow
  (the overlapped trainer's communication thread), an annotation not
  the program's, and the idle gaps, one outside every span;
- on a CPU-sized run of each cell's program step under ``torch.profiler``
  (each leaf operator stands in for a kernel launched where it ran): the
  result line of a traced run prints every new metric of the cell; a
  trace without the program's spans, or one an earlier process wrote,
  reads nothing.
"""
from __future__ import annotations

import json
import os
import tempfile
import time

import pytest
from torch.profiler import ProfilerActivity, profile

from conftest import tiny_run

from bench import harness, progtrace
from bench import run as run_mod
from bench.drivers import shared

NEW = {
    "data_queue_ms.train", "forward_ms.train", "backward_ms.train",
    "recompute_ms.train", "mixer_ms.train", "mlp_ms.train",
    "head_loss_ms.train", "optimizer_ms.train", "launches.train",
    "sync_exposed_device_ms.train"}


def span(name, tid, a, b):
    return {"ph": "X", "cat": "user_annotation", "name": name, "pid": 1,
            "tid": tid, "ts": a, "dur": b - a}


def launch(corr, tid, t, driver=False):
    return {"ph": "X", "cat": "cuda_driver" if driver else "cuda_runtime",
            "name": "cuLaunchKernelEx" if driver else "cudaLaunchKernel",
            "pid": 1, "tid": tid, "ts": t, "dur": 1,
            "args": {"correlation": corr}}


def device(corr, a, b, stream=7, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": f"op{corr}", "pid": 0,
            "tid": stream, "ts": a, "dur": b - a,
            "args": {"correlation": corr, "stream": stream}}


def hand_trace():
    return [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1, "tid": 1,
         "ts": 40, "dur": 5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1, "tid": 2,
         "ts": 405, "dur": 5},
        span("data/wait", 1, -100, -50),
        span("train/step", 1, 0, 1000),
        span("train/forward", 1, 10, 300),
        span("model/mixer@fwd", 1, 20, 100),
        span("train/backward", 1, 300, 800),
        span("train/optimizer", 1, 800, 950),
        span("sync/wait", 1, 850, 860),
        span("nccl:all_reduce", 1, 851, 859),  # not the program's
        span("model/mixer@bwd", 2, 400, 600),
        span("model/mixer@recompute", 2, 420, 450),
        launch(1, 1, 50), device(1, 60, 160),
        launch(2, 1, 200), device(2, 150, 250, stream=8),
        launch(3, 2, 430), device(3, 430, 480),
        launch(4, 2, 700), device(4, 700, 750),
        launch(5, 99, 500, driver=True), device(5, 500, 900, stream=20),
        launch(6, 1, 820), device(6, 820, 880),
        span("data/h2d", 1, 1090, 1120),
        launch(7, 1, 1100), device(7, 1100, 1110, cat="gpu_memcpy"),
        {"ph": "X", "cat": "gpu_user_annotation", "name": "train/step",
         "pid": 0, "tid": 7, "ts": 60, "dur": 900},
    ]


def test_the_join_on_a_hand_written_trace():
    r = progtrace.reduce_events(hand_trace())
    assert r["steps"] == 1 and r["overlapped"]
    assert r["forward_ms"] == pytest.approx(0.190)  # two streams, union
    # the engine thread's kernels, the one outside its spans; not the
    # communication thread's, though train/backward was open
    assert r["backward_ms"] == pytest.approx(0.100)
    assert r["recompute_ms"] == pytest.approx(0.050)
    assert r["mixer_ms"] == pytest.approx(0.150)  # fwd + recompute in bwd
    assert r["optimizer_ms"] == pytest.approx(0.060)
    assert r["mlp_ms"] == 0.0 and r["head_loss_ms"] == 0.0
    assert r["launches"] == 6  # kernels in the step; the copy after it not
    assert r["data_wait_ms"] == pytest.approx(0.050)
    assert r["sync_ms"] == pytest.approx(0.400)
    # the comm thread's 400 us less the 50 + 60 us other kernels ran
    assert r["sync_exposed_ms"] == pytest.approx(0.290)
    assert r["busy_ms"] == pytest.approx(0.650)
    assert r["outside_model_ms"] == pytest.approx(0.140)
    assert r["idle_gaps"] == [["train/step", pytest.approx(0.200)],
                              ["train/backward", pytest.approx(0.180)],
                              ["model/mixer@bwd", pytest.approx(0.020)]]
    by = r["by_span"]
    assert by["data/h2d"]["device_ms"] == pytest.approx(0.010)
    assert by["bucket_sync"]["device_ms"] == pytest.approx(0.400)
    assert by["train/backward"]["idle_ms"] == pytest.approx(0.180)
    # the sync's kernel is not the step's, though its launch is counted
    assert by["train/step"]["device_ms"] == pytest.approx(0.350)


def test_without_sync_wait_an_unfollowed_thread_is_the_steps():
    ev = [e for e in hand_trace() if e.get("name") != "sync/wait"]
    r = progtrace.reduce_events(ev)
    assert not r["overlapped"] and r["sync_ms"] == 0.0
    assert "bucket_sync" not in r["by_span"]
    assert r["backward_ms"] == pytest.approx(0.450)


def test_a_layer_holds_its_own_recompute_alone():
    """Block remat recomputes the block inside the MLP's backward: the
    mixer's recomputed kernels are the mixer's, not the MLP's."""
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1, "tid": 2,
         "ts": 600, "dur": 1},
        span("train/step", 1, 0, 1000),
        span("train/backward", 1, 0, 1000),
        span("model/block@bwd", 2, 100, 900),
        span("model/mlp@bwd", 2, 100, 500),
        span("model/block@recompute", 2, 110, 300),
        span("model/mixer@recompute", 2, 120, 200),
        span("model/mlp@recompute", 2, 210, 290),
        span("model/mixer@bwd", 2, 500, 900),
        launch(1, 2, 130), device(1, 130, 170),    # mixer, recomputed
        launch(2, 2, 220), device(2, 220, 260),    # mlp, recomputed
        launch(3, 2, 295), device(3, 295, 298),    # block's norm, recomputed
        launch(4, 2, 310), device(4, 310, 410),    # the MLP's backward
        launch(5, 2, 600), device(5, 600, 800),    # the mixer's backward
    ]
    r = progtrace.reduce_events(ev)
    assert r["mixer_ms"] == pytest.approx(0.240)
    assert r["mlp_ms"] == pytest.approx(0.140)
    assert r["recompute_ms"] == pytest.approx(0.083)
    by = r["by_span"]
    assert by["model/mlp@bwd"]["device_ms"] == pytest.approx(0.183)
    assert by["model/mlp@bwd"]["self_ms"] == pytest.approx(0.100)
    assert by["model/block@recompute"]["self_ms"] == pytest.approx(0.003)


def test_a_gap_outside_every_span_is_the_next_launchs():
    """Between two steps no program span is open (an annotation not the
    program's does not count): the gap is the next kernel's span's."""
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1, "tid": 1,
         "ts": 5, "dur": 1},
        span("ProfilerStep#0", 1, 0, 400),
        span("train/step", 1, 0, 100),
        span("train/step", 1, 300, 400),
        span("train/forward", 1, 302, 398),
        launch(1, 1, 5), device(1, 10, 90),
        launch(2, 1, 305), device(2, 310, 390),
    ]
    r = progtrace.reduce_events(ev)
    assert r["steps"] == 2
    assert r["idle_gaps"] == [["train/forward", pytest.approx(0.220)]]
    assert "ProfilerStep#0" not in r["by_span"]


def test_of_two_cells_of_one_shape_the_one_this_process_traced(
        tmp_path, monkeypatch):
    """A second cell of the same configuration and shape (another
    ``sync``, say) leaves the first its traces; two traced raise."""
    root = tmp_path / "bench"
    for sub in ("workloads", "traffic"):
        (root / sub).mkdir(parents=True)
    cell = harness.cell("granite-train-s4k-fp32")
    traffic = harness.traffic(cell["traffic"])
    (root / "traffic" / f"{cell['traffic']}.json").write_text(
        json.dumps(traffic))
    for name in ("granite-a", "granite-b"):
        (root / "workloads" / f"{name}.json").write_text(json.dumps(cell))
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    monkeypatch.setattr(harness, "HERE", root)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp))
    rec = {"config": {"name": cell["config"]}, "chips": 1,
           "batch": int(traffic["batch"]), "seq": int(traffic["seq"])}
    assert progtrace.cells_of(rec) == ["granite-a", "granite-b"]
    assert progtrace.trace_files(rec) == []

    def write(name):
        path = tmp / f"bench-trace-{name}.json"
        path.write_text(json.dumps({"traceEvents": hand_trace()}))
        return str(path)

    b = write("granite-b")
    assert progtrace.trace_files(rec) == [b]
    assert progtrace.largest(rec, "launches") == 6
    a = write("granite-a")
    with pytest.raises(RuntimeError, match="granite-a"):
        progtrace.trace_files(rec)
    old = harness.process_start() - 3600
    os.utime(a, (old, old))  # an earlier process's
    assert progtrace.trace_files(rec) == [b]


def test_nothing_to_read():
    ev = [e for e in hand_trace() if e.get("cat") != "user_annotation"]
    assert progtrace.reduce_events(ev) is None
    assert progtrace.reduce_events([]) is None


# ---------------------------------------------------------------------------
# A CPU-sized run of each cell's program step
# ---------------------------------------------------------------------------


def as_device_trace(events):
    """A CPU profile with each leaf operator as a kernel launched where
    it ran, on a card that runs it at once."""
    ops = sorted((e for e in events if e.get("ph") == "X"
                  and e.get("cat") == "cpu_op"),
                 key=lambda e: (e["tid"], e["ts"]))
    out = list(events)
    for k, e in enumerate(ops):
        nxt = ops[k + 1] if k + 1 < len(ops) else None
        if nxt is not None and nxt["tid"] == e["tid"] \
                and nxt["ts"] < e["ts"] + e["dur"]:
            continue  # it has a child: not a leaf
        out.append(launch(k, e["tid"], e["ts"]))
        out.append(device(k, e["ts"], e["ts"] + e["dur"]))
    return out


def profiled_steps(cell, steps=2):
    """The driver's profiled steps at CPU size: the cell's step and loader
    as the drivers build them, profiled; returns the trace's events."""
    from repro_torch.data.pipeline import PrefetchLoader
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import adamw
    from bench import traffic as traffic_lib, weights

    r = tiny_run(cell)
    B, S = int(r.traffic["batch"]), int(r.traffic["seq"])
    cfg, run_cfg, opt = shared.session_setup(r, batch=B)
    params = weights.nested(weights.make(r.config, r.seed, "cpu"))
    corpus = traffic_lib.Corpus(r.traffic, cfg.vocab_size, r.seed)
    one_card = int(harness.cell(cell)["chips"]) == 1
    trainer = None
    if one_card:
        loader = PrefetchLoader(cfg, B, S, device="cpu", corpus=corpus)
        state = adamw.init_state(opt, params)
        step = build_train_step(cfg, run_cfg, opt)
    else:  # the four-card driver's trainer, one rank of one
        import torch.distributed as dist
        from repro_torch.distributed.trainer import DataParallelTrainer

        loader = PrefetchLoader(cfg, B, S, device=["cpu"], corpus=corpus,
                                shard=(0, 1))
        trainer = DataParallelTrainer(
            cfg, run_cfg, opt, strategy="all_reduce", sync_overlap=True,
            bucket_mb=0.05, devices=["cpu"], rank=0, world=1,
            store=dist.HashStore())
        params, state = trainer.replicate(params)
        step = trainer.step_fn()
    try:
        for _ in range(0 if one_card else trainer.N_CALIB_STEPS):
            params, state, _ = step(params, state, next(loader)[0])
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(steps):
                batch, _ = next(loader)
                params, state, _ = step(params, state, batch)
    finally:
        loader.close()
        if trainer is not None:
            trainer.close()
    path = os.path.join(tempfile.gettempdir(), "profile.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)["traceEvents"]


def write_trace(cell, events):
    chips = int(harness.cell(cell)["chips"])
    name = (f"bench-trace-{cell}.json" if chips == 1
            else f"bench-trace-{cell}-rank0.json")
    path = os.path.join(tempfile.gettempdir(), name)
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    return path


def traced_line(cell):
    """``bench/run.py``'s last line of a traced run of ``cell``, from a
    record as the drivers make it (the new metrics read the trace)."""
    r = harness.Run.of(cell, 2 ** 33 + 7, 10.0, True, time.time())
    chips = int(r.cell["chips"])
    record = {"config": r.config, "batch": int(r.traffic["batch"]),
              "seq": int(r.traffic["seq"]), "chips": chips,
              "device_kind": "cpu", "steps": 0, "window_s": 1.0,
              "spans": {}, "counters": {}, "profiles": []}
    profiles = [{"busy_s": 1.0, "window_s": 1.0, "device_ops": [],
                 "idle_gaps": []}]
    out = {"record": record, "profiles": profiles, "correct": True,
           "attempted": 1, "failed": 0, "checks": {},
           "memory_peak_bytes": 0}
    return run_mod.result(r, out, chips, "cpu")


def cell_metrics(cell):
    return {m["name"] for m in harness.cell_metrics(
        harness.benchmark(), cell, "per_layer")} & NEW


@pytest.mark.parametrize("cell", ["granite-train-s4k-fp32",
                                  "mamba2-train-s2k-fp32",
                                  "granite-train-s512-dp4-fp32"])
def test_a_traced_cpu_run_prints_every_new_metric(cell, tmp_path,
                                                  monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    events = profiled_steps(cell)
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"data/wait", "data/h2d", "model/mixer@fwd"} <= names
    # torch.distributed annotates its collectives (gloo:all_reduce)
    ours = {n for n in names if ":" not in n}
    assert all(progtrace.SPAN_NAME.match(n) for n in ours), ours
    assert not any(progtrace.SPAN_NAME.match(n) for n in names - ours)
    path = write_trace(cell, as_device_trace(events))
    line = traced_line(cell)
    want = cell_metrics(cell)
    assert want and want <= set(line["metrics"]), want - set(line["metrics"])
    m = {k: v["value"] for k, v in line["metrics"].items()}
    red = progtrace.reduce_file(path)
    assert red["steps"] == 2
    # the phases hold the step's device time; the model's spans hold
    # most of the forward and backward
    assert red["forward_ms"] > 0 and red["backward_ms"] > 0
    assert m["launches.train"] == red["launches"] > 0
    if "optimizer_ms.train" in m:
        whole = m["forward_ms.train"] + m["backward_ms.train"] \
            + m["optimizer_ms.train"]
        assert whole <= red["busy_ms"] * 1.001
    assert 0 < m["recompute_ms.train"] < m["forward_ms.train"]
    assert red["outside_model_ms"] < m["forward_ms.train"] \
        + m["backward_ms.train"]
    assert m["mixer_ms.train"] > 0 and m["head_loss_ms.train"] > 0
    assert m["data_queue_ms.train"] >= 0
    # without the program's spans (the parent's run) nothing is read
    bare = [e for e in as_device_trace(events)
            if e.get("cat") != "user_annotation"]
    write_trace(cell, bare)
    assert not set(traced_line(cell)["metrics"]) & NEW
    # a trace an earlier process wrote is not this run's
    write_trace(cell, as_device_trace(events))
    old = harness.process_start() - 3600
    os.utime(path, (old, old))
    assert not set(traced_line(cell)["metrics"]) & NEW
