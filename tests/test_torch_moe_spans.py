"""The spans inside a layer (``models/spans.py::layer``) and the MoE
counters, on the CPU at a tiny DeepSeek-V2 (one dense MLA layer, two MLA
+ MoE layers, 2 of 4 experts held) and granite-3-2b:

- a traced step opens ``attn/core`` in every attention layer and
  ``moe/route``, ``moe/dispatch``, ``moe/experts``, ``moe/combine`` and
  ``moe/shared`` in every MoE layer, each ``@fwd``, ``@recompute`` (block
  remat) and ``@bwd``, each inside its layer's span of the same phase;
  a step built without a tracer shows them in a profile alone;
- ``moe.kept`` plus ``moe.dropped`` is the step's assignments to held
  experts (the forward's: remat's recompute counts nothing), read once
  after the step; a disabled tracer counts nothing;
- a traced step is bitwise the untraced one;
- counters added from more threads than cores lose no update.
"""
from __future__ import annotations

import collections
import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.base import get_config
from repro_torch.launch.steps import build_train_step
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models.blocks import RunConfig
from repro_torch.models.common import tree_items
from repro_torch.obs.trace import NULL_TRACER, PROFILER_TRACER, Tracer
from repro_torch.optim import adamw

PIECES = ("moe/route", "moe/dispatch", "moe/experts", "moe/combine",
          "moe/shared")
PHASES = ("fwd", "recompute", "bwd")


def _cfg(arch="deepseek-v2-236b"):
    kw = dict(vocab_size=256, dtype="float32")
    if arch == "deepseek-v2-236b":
        kw.update(num_layers=3, experts_held=2)
    else:
        kw.update(num_layers=2)
    return get_config(arch).reduced().replace(**kw)


def _step(cfg, tracer, remat="block"):
    run = RunConfig(attn_impl="auto", remat=remat)
    opt = adamw.OptConfig(lr=1e-3, warmup_steps=0, total_steps=8)
    params = M.init_params(cfg, 0, "cpu")
    state = adamw.init_state(opt, params)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int64))
    step = build_train_step(cfg, run, opt, tracer=tracer)
    return step(params, state, {"tokens": toks, "labels": toks})


def _inside(inner, outer):
    return (outer.t0_s <= inner.t0_s + 1e-9
            and inner.t1_s <= outer.t1_s + 1e-9)


@pytest.mark.parametrize("remat", ["block", "none"])
def test_a_traced_step_opens_every_piece_in_every_phase(remat):
    cfg = _cfg()
    tr = Tracer(enabled=True)
    _step(cfg, tr, remat)
    count = collections.Counter(e.name for e in tr.events())
    moe_layers = cfg.num_layers - cfg.first_k_dense
    for phase in PHASES:
        n = 0 if phase == "recompute" and remat == "none" else 1
        assert count[f"attn/core@{phase}"] == n * cfg.num_layers, phase
        for piece in PIECES:
            assert count[f"{piece}@{phase}"] == n * moe_layers, (piece,
                                                                 phase)
    # each piece inside its layer's span of the same phase
    for phase in PHASES:
        for name, layer in [("attn/core", "model/mixer")] + [
                (p, "model/mlp") for p in PIECES]:
            outer = tr.events(f"{layer}@{phase}")
            for e in tr.events(f"{name}@{phase}"):
                assert any(_inside(e, o) for o in outer), (name, phase)
    # the backward runs the pieces in reverse: the combine's opens first
    for a, b in zip(tr.events("moe/combine@bwd"),
                    tr.events("moe/experts@bwd")):
        assert a.t0_s <= b.t0_s


def test_granite_opens_the_attention_core_and_no_moe_piece():
    tr = Tracer(enabled=True)
    _step(_cfg("granite-3-2b"), tr)
    count = collections.Counter(e.name for e in tr.events())
    for phase in PHASES:
        assert count[f"attn/core@{phase}"] == 2
    assert not any(n.startswith("moe/") for n in count)
    assert tr.counts() == {}


def test_the_profile_alone_shows_the_pieces(tmp_path):
    cfg = _cfg()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _step(cfg, None)
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        names = collections.Counter(
            e["name"] for e in json.load(f)["traceEvents"]
            if e.get("cat") == "user_annotation")
    for phase in PHASES:
        assert names[f"attn/core@{phase}"] == cfg.num_layers
        for piece in PIECES:
            assert names[f"{piece}@{phase}"] == 2
    PROFILER_TRACER.counts()  # the profiled step's, cleared


@pytest.mark.parametrize("remat", ["block", "none"])
def test_kept_and_dropped_count_the_assignments_to_held_experts(remat):
    cfg = _cfg()
    topk, calls = moe._router_topk, []

    def recorded(logits, top_k):
        w, idx, aux = topk(logits, top_k)
        calls.append(idx)
        return w, idx, aux

    moe._router_topk = recorded
    try:
        tr = Tracer(enabled=True)
        _step(cfg, tr, remat)
    finally:
        moe._router_topk = topk
    moe_layers = cfg.num_layers - cfg.first_k_dense
    assert len(calls) == moe_layers * (2 if remat == "block" else 1)
    held = sum(int((idx < cfg.experts_held).sum())
               for idx in calls[:moe_layers])
    got = tr.counts()
    assert set(got) == {"moe.kept", "moe.dropped"}
    assert got["moe.kept"] + got["moe.dropped"] == held > 0
    assert got["moe.kept"] > 0
    assert tr.counts() == {}  # read once, then cleared
    off = Tracer(enabled=False)
    _step(cfg, off, remat)
    assert off.counts() == {}


def test_a_traced_step_is_bitwise_the_untraced_one():
    cfg = _cfg()
    base = _step(cfg, NULL_TRACER)
    got = _step(cfg, Tracer(enabled=True))
    assert torch.equal(got[2]["loss"], base[2]["loss"])
    for (p, x), (_, y) in zip(tree_items(got[0]), tree_items(base[0])):
        assert torch.equal(x, y), p


def test_counters_from_many_threads_lose_no_update():
    tr = Tracer(enabled=True)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def add():
            for _ in range(2000):
                tr.count("n", 1)

        threads = [threading.Thread(target=add) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert tr.counts() == {"n": 32000.0}
