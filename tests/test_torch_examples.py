"""The examples' twins (``examples/torch_*.py``) run in this process on the
CPU (``--device cpu``; no process is started), each from a temporary
working directory so that what it writes under ``results/`` stays there:

* ``torch_planner_demo``: one plan per arch x input shape on the port's
  clusters (``single`` one 8 x H100 node, ``multi`` two), each the plan
  that ``Session.plan()`` reports for the same job, its Report passing
  the port's ``validate_report``;
* ``torch_quickstart --steps 2``: the train and serve Reports it returns
  and the two it saves pass ``validate_report``.

``tests/test_torch_imports.py`` holds every twin to the import guard and
to raising without a card when ``--device`` is left at its default.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from repro_torch.api import JobSpec, Session, validate_report
from repro_torch.configs.base import ARCH_IDS, SHAPES

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def _example(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("mesh,chips", [("single", 8), ("multi", 16)])
def test_planner_demo_plans_are_the_sessions(mesh, chips, tmp_path,
                                             monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    spec, rows = _example("torch_planner_demo").main(
        ["--mesh", mesh, "--device", "cpu"])
    out = capsys.readouterr().out
    assert spec.chips == chips and spec.chip.name == "h100-sxm"
    assert [(a, s) for a, s, _ in rows] == [(a, s) for a in ARCH_IDS
                                            for s in SHAPES]
    for arch, shape, p in rows:
        assert f"{arch:24s} {shape:12s} {p.microbatch:3d} " in out
    for arch, shape in (("granite-3-2b", "train_4k"),
                        ("jamba-1.5-large-398b", "decode_32k")):
        rep = Session(JobSpec(arch=arch, shape=shape, mesh=mesh),
                      device="cpu").plan().to_dict()
        validate_report(rep)
        p = next(p for a, s, p in rows if (a, s) == (arch, shape))
        for key in ("microbatch", "attn_impl", "remat", "fsdp", "opt_kind",
                    "sync_schedule", "fits"):
            assert rep["plan"][key] == getattr(p, key), (arch, shape, key)
        assert rep["plan"]["est_step_time"] == p.est_step_time
        assert rep["plan"]["est_memory_gb"] == p.est_memory_gb


def test_quickstart_reports_validate(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    rep, srep = _example("torch_quickstart").main(
        ["--device", "cpu", "--steps", "2"])
    out = capsys.readouterr().out
    assert "== generating" in out and "reports: results/" in out
    assert rep.kind == "train" and srep.kind == "serve"
    losses = rep.measured["losses"]
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    assert len(srep.measured["per_request"]) == 2
    for r, name in ((rep, "train"), (srep, "serve")):
        validate_report(r.to_dict())
        saved = tmp_path / "results" / f"torch_quickstart_{name}_report.json"
        assert validate_report(json.loads(saved.read_text()))["kind"] == name
