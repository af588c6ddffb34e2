"""The port's dry run end to end on the CPU: ``run_one`` on reduced
granite at a (2, 4) mesh (JAX's own smoke combination,
``tests/test_distributed.py:97-121``, which fails under the installed
jax), its record's keys against JAX's schema, the extrapolation identity
``base + (n - 1) x delta == full``, and the two tables that read the
records (``benchmarks/torch_dryrun_summary.py``,
``benchmarks/torch_roofline.py``).  Every trace runs on ``meta``: nothing
is allocated."""
import importlib.util
import json
from pathlib import Path

import pytest

from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.launch import dryrun as D

REPO = Path(__file__).resolve().parent.parent
# JAX's record (src/repro/launch/dryrun.py:172-226), with lower_s and
# compile_s replaced by trace_s
JAX_TOP = {"arch", "shape", "mesh", "variant", "optimized", "num_devices",
           "pattern_cycles", "ok", "full", "derived", "count_details"}
JAX_FULL = {"flops", "bytes_accessed", "memory", "collectives", "wire_bytes"}
JAX_MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes"}
KEYS = ("flops", "bytes_accessed", "wire_bytes")


def _load(rel):
    spec = importlib.util.spec_from_file_location(Path(rel).stem, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_dryrun")
    cfg = get_config("granite-3-2b").reduced().replace(num_layers=3)
    shapes = {"train_4k": ShapeConfig("train_4k", 128, 8, "train"),
              "decode_32k": ShapeConfig("decode_32k", 128, 8, "decode"),
              "long_500k": ShapeConfig("long_500k", 128, 1, "decode")}
    ok = {}
    for name, shape in shapes.items():
        ok[name] = D.run_one("granite-3-2b", name, "single", out,
                             mesh_shape=(2, 4), config=cfg, shape=shape,
                             optimized=name == "decode_32k")
    # a combination that cannot shard: 4 heads over a model axis of 8
    ok["prefill_32k"] = D.run_one(
        "granite-3-2b", "prefill_32k", "single", out, mesh_shape=(1, 8),
        config=cfg.replace(d_ff=500),
        shape=ShapeConfig("prefill_32k", 128, 2, "prefill"))
    return out, ok


def _rec(out, shape):
    return json.loads((out / f"granite-3-2b__{shape}__single.json")
                      .read_text())


@pytest.mark.parametrize("shape", ("train_4k", "decode_32k", "long_500k"))
def test_run_one_record(records, shape):
    out, ok = records
    assert ok[shape]
    rec = _rec(out, shape)
    assert JAX_TOP <= set(rec) and rec["ok"]
    assert JAX_FULL | {"trace_s"} <= set(rec["full"])
    assert set(rec["full"]["memory"]) == JAX_MEMORY
    assert rec["num_devices"] == 8 and rec["pattern_cycles"] == 3
    assert rec["full"]["memory"]["argument_bytes"] > 0
    assert rec["full"]["memory"]["alias_bytes"] == 0
    d, c = rec["derived"], rec["count_details"]
    assert d["flops"] > 0 and d["wire_bytes"] > 0
    for k in KEYS:  # eager traces count every layer: the identity is exact
        assert d[k] == rec["full"][k]
        assert d[k + "_base"] == c["1"][k]
        assert d[k] == d[k + "_base"] + 2 * d[k + "_per_cycle"]
    if shape == "train_4k":  # FSDP off, ZeRO-1 on the data axis of 2
        cols = rec["full"]["collectives"]
        assert {"all-gather", "all-reduce", "reduce-scatter"} <= set(cols)


def test_refused_sharding_is_recorded(records):
    out, ok = records
    assert not ok["prefill_32k"]
    rec = _rec(out, "prefill_32k")
    assert rec["ok"] is False and "ValueError" in rec["error"]
    assert "traceback" in rec


def test_summary_and_roofline_render_the_records(records, tmp_path):
    out, _ = records
    summary = _load("benchmarks/torch_dryrun_summary.py")
    roof = _load("benchmarks/torch_roofline.py")
    rows = []
    lines = summary.run(rows, indir=out, outdir=tmp_path)
    assert "**3/4 combinations trace.**" in lines
    assert rows == [("dryrun/ok_fraction", 0.75, "3/4")]
    reports = json.loads((tmp_path / "torch_dryrun_report.json").read_text())
    assert len(reports["reports"]) == 4
    assert reports["reports"][0]["measured"]["ok"] is True
    rows = []
    lines = roof.run(rows, indir=out, outdir=tmp_path)
    assert (tmp_path / "torch_roofline.md").exists()
    assert any("FAILED" in ln for ln in lines)
    assert sorted(r[0].split("/")[2] for r in rows) == \
        ["decode_32k", "long_500k", "train_4k"]
    # the model axis of 4 fits one 8-card node: priced on NVLink
    assert roof.link_bw(_rec(out, "train_4k")) == 450e9
