"""Each per-layer metric's reader against a small synthetic record, and
the device-trace reduction against a synthetic Chrome trace."""
from __future__ import annotations

import pytest

from bench import devtrace, flops, harness

KIND = "NVIDIA H100 80GB HBM3"


def record(**kw):
    rec = {"config": harness.config("granite-3-2b-fp32"), "batch": 2, "seq": 4096,
           "chips": 1, "device_kind": KIND, "steps": 4, "window_s": 12.0,
           "spans": {"data_wait": [0.001, 0.003], "grad": [2.0, 4.0],
                     "adamw": [0.1, 0.3]},
           "counters": {"train/exposed_comm_s": {"count": 4, "sum": 0.2}},
           "profiles": [{"busy_s": 0.9, "window_s": 1.0},
                        {"busy_s": 0.7, "window_s": 1.0}]}
    rec.update(kw)
    return rec


def read(name, rec):
    return harness.metric(name).read(rec)


def test_readers_on_a_synthetic_record():
    rec = record()
    assert read("data_wait_ms.train", rec) == pytest.approx(2.0)
    assert read("grad_ms.train", rec) == pytest.approx(3000.0)
    least = flops.adamw_bytes(rec["config"]) / 3.35e12
    assert read("adamw_roofline.train", rec) == pytest.approx(
        100 * least / 0.2)
    assert read("sync_exposed_ms.train", rec) == pytest.approx(50.0)
    assert read("mfu.train", rec) == pytest.approx(
        100 * flops.train_flops(rec["config"], 2, 4096) / (3.0 * 67e12))
    assert read("device_idle.train", rec) == pytest.approx(30.0)


def test_mfu_is_per_card():
    one = read("mfu.train", record())
    four = read("mfu.train", record(chips=4, batch=8))
    assert four == pytest.approx(one)


@pytest.mark.parametrize("name", ["data_wait_ms.train", "grad_ms.train",
                                  "adamw_roofline.train",
                                  "sync_exposed_ms.train", "mfu.train",
                                  "device_idle.train"])
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    empty = record(spans={}, counters={}, profiles=[], steps=0,
                   device_kind="cpu")
    assert read(name, empty) is None


def test_trace_reduction():
    ev = [
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 50, "dur": 100},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 400,
         "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "adam", "ts": 500, "dur": 20},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 140,
         "dur": 300},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
         "ts": 200, "dur": 100},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 0},
    ]
    rec = devtrace.reduce_trace(ev, 0.001)
    assert rec["busy_s"] == pytest.approx(220e-6)  # 0-150, 400-450, 500-520
    assert rec["window_s"] == 0.001
    assert rec["device_ops"][0] == ["gemm", pytest.approx(200e-6)]
    gaps = rec["idle_gaps"]
    assert gaps[0] == ["cudaStreamSynchronize", pytest.approx(250e-6)]
    assert gaps[1] == ["host idle", pytest.approx(50e-6)]
    assert devtrace.reduce_trace([], 1.0) == {}
