"""The port's spans inside the train step (``obs/trace.py``,
``models/spans.py``, ``launch/steps.py``, ``data/pipeline.py``,
``distributed/trainer.py``), on the CPU at reduced sizes of granite-3-2b
(dense GQA) and mamba2-780m (the SSD stack):

- an enabled span is a ``user_annotation`` of a running ``torch.profiler``
  with its name, nesting and thread; ``PROFILER_TRACER``'s spans exist
  only there; a disabled tracer records nothing;
- a traced step is bitwise the untraced one (loss, parameters, moments),
  with and without block remat;
- one step's span tree: one ``train/step`` holding ``train/forward``,
  ``train/backward`` and ``train/optimizer``; ``model/mixer`` once a layer
  in each of ``fwd``, ``recompute`` and ``bwd`` under block remat, and no
  ``recompute`` without it; the phases in a profile's own annotations;
- a disabled tracer leaves the loss's autograd graph as it was;
- the loader's ``data/wait`` and ``data/h2d`` once a batch;
- the data-parallel trainer: its private tracer holds no ``model/*``
  span; overlapped, on two gloo ranks, ``bucket_sync`` runs on the
  communication thread and ``train/sync_calls`` counts the plan's buckets
  a step.
"""
from __future__ import annotations

import collections
import json
import threading
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import PrefetchLoader
from repro_torch.distributed.trainer import DataParallelTrainer
from repro_torch.launch.steps import build_grad_fn, build_train_step
from repro_torch.models import model as M
from repro_torch.models.blocks import RunConfig
from repro_torch.models.common import tree_items, tree_unflatten
from repro_torch.obs import trace
from repro_torch.obs.trace import NULL_TRACER, PROFILER_TRACER, Tracer
from repro_torch.optim import adamw

ARCHS = ("granite-3-2b", "mamba2-780m")
LAYERS = 2
TIMEOUT = timedelta(seconds=60)


def _cfg(arch):
    return get_config(arch).reduced().replace(
        vocab_size=256, num_layers=LAYERS, dtype="float32")


def _batch(cfg, seed=0, rows=2, seq=32):
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (rows, seq)).astype(np.int64))
    return {"tokens": toks, "labels": toks}


def _step(arch, remat, tracer):
    cfg = _cfg(arch)
    run = RunConfig(attn_impl="auto", remat=remat)
    opt = adamw.OptConfig(lr=1e-3, warmup_steps=0, total_steps=8)
    params = M.init_params(cfg, 0, "cpu")
    state = adamw.init_state(opt, params)
    step = build_train_step(cfg, run, opt, tracer=tracer)
    return step(params, state, _batch(cfg))


def _annotations(prof_path):
    with open(prof_path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"]


def _inside(inner, outer):
    return (outer.t0_s <= inner.t0_s + 1e-9
            and inner.t1_s <= outer.t1_s + 1e-9)


def test_an_enabled_span_is_a_profiler_annotation(tmp_path):
    """Name, nesting and thread in the profile; PROFILER_TRACER's spans
    there alone, the disabled tracer's nowhere."""
    tr = Tracer(enabled=True)

    def other():
        with tr.span("other/thread"):
            torch.ones(8).add_(1)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("outer", step=3):
            with tr.span("inner"):
                torch.ones(8).mul_(2)
            with PROFILER_TRACER.span("profiled/only"):
                torch.ones(8).mul_(3)
            with NULL_TRACER.span("never"):
                torch.ones(8).mul_(4)
        t = threading.Thread(target=other)
        t.start()
        t.join()
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    ann = {e["name"]: e for e in _annotations(path)}
    assert {"outer", "inner", "profiled/only"} <= set(ann)
    assert "never" not in ann
    main = threading.get_native_id()
    assert ann["outer"]["tid"] == ann["inner"]["tid"] == main
    o, i = ann["outer"], ann["inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    # the tracer's own log holds every enabled span, the other thread's too
    names = {e.name: e for e in tr.events()}
    assert set(names) == {"outer", "inner", "other/thread"}
    assert names["outer"].args == {"step": 3}
    assert names["inner"].depth == 1 and names["outer"].depth == 0
    assert names["other/thread"].tid != names["outer"].tid
    # out of a profile PROFILER_TRACER opens nothing
    assert not PROFILER_TRACER.enabled
    assert PROFILER_TRACER.span("x") is trace.NULL_SPAN


@pytest.mark.parametrize("remat", ["block", "none"])
@pytest.mark.parametrize("arch", ARCHS)
def test_a_traced_step_is_bitwise_the_untraced_one(arch, remat):
    base = _step(arch, remat, NULL_TRACER)
    for tr in (Tracer(enabled=True), None):
        got = _step(arch, remat, tr)
        assert torch.equal(got[2]["loss"], base[2]["loss"])
        for (p, x), (_, y) in zip(tree_items(got[0]), tree_items(base[0])):
            assert torch.equal(x, y), p
        for slot in ("m", "v"):
            for (p, x), (_, y) in zip(tree_items(got[1][slot]),
                                      tree_items(base[1][slot])):
                assert torch.equal(x, y), (slot, p)


@pytest.mark.parametrize("remat", ["block", "none"])
@pytest.mark.parametrize("arch", ARCHS)
def test_one_steps_span_tree(arch, remat):
    tr = Tracer(enabled=True)
    _step(arch, remat, tr)
    ev = tr.events()
    count = collections.Counter(e.name for e in ev)
    assert count["train/step"] == 1
    step = tr.events("train/step")[0]
    for name in ("train/forward", "train/backward", "train/optimizer"):
        (e,) = tr.events(name)
        assert _inside(e, step), name
    fwd, bwd = tr.events("train/forward")[0], tr.events("train/backward")[0]
    n = _cfg(arch).num_layers
    assert count["model/mixer@fwd"] == n
    assert count["model/mixer@bwd"] == n
    assert count["model/mixer@recompute"] == (n if remat == "block" else 0)
    assert count["model/block@fwd"] == n and count["model/embed@fwd"] == 1
    assert count["model/head_loss@fwd"] == count["model/head_loss@bwd"] == 1
    assert not any(k.endswith("@recompute") for k in count) \
        or remat == "block"
    for e in ev:
        if e.name.endswith("@fwd"):
            assert _inside(e, fwd), e.name
        if e.name.endswith(("@bwd", "@recompute")):
            assert _inside(e, bwd), e.name
    # a layer's backward nests inside its block's, in layer order
    blocks = sorted(tr.events("model/block@bwd"), key=lambda e: e.t0_s)
    mixers = sorted(tr.events("model/mixer@bwd"), key=lambda e: e.t0_s)
    assert all(_inside(m, b) for m, b in zip(mixers, blocks))


def test_the_profile_alone_tells_the_phases_apart(tmp_path):
    """A step built without a tracer, under torch.profiler: the model's
    spans with their phases are the profile's annotations."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _step("granite-3-2b", "block", None)
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    count = collections.Counter(e["name"] for e in _annotations(path))
    for phase in ("fwd", "recompute", "bwd"):
        assert count[f"model/mixer@{phase}"] == LAYERS, phase
    assert count["train/step"] == 1 and count["train/optimizer"] == 1


def _graph_size(loss):
    seen, todo = set(), [loss.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo.extend(f for f, _ in fn.next_functions)
    return len(seen)


@pytest.mark.parametrize("arch", ARCHS)
def test_a_disabled_tracer_adds_nothing(arch):
    cfg = _cfg(arch)
    run = RunConfig(attn_impl="auto", remat="none")
    tree = tree_unflatten((p, t.requires_grad_()) for p, t in
                          tree_items(M.init_params(cfg, 0, "cpu")))
    sizes = {}
    for name, tr in (("none", None), ("null", NULL_TRACER),
                     ("off", Tracer(enabled=False)),
                     ("profiler", PROFILER_TRACER),
                     ("on", Tracer(enabled=True))):
        if tr is None:
            loss, _ = M.loss_fn(tree, _batch(cfg), cfg, run)
        else:
            with trace.use(tr):
                loss, _ = M.loss_fn(tree, _batch(cfg), cfg, run)
        sizes[name] = _graph_size(loss)
        if tr is not None and not tr.enabled:
            assert len(tr) == 0
    assert sizes["null"] == sizes["off"] == sizes["profiler"] == sizes["none"]
    # two identities a layer span: embed, head_loss, and per layer the
    # block, the mixer, the MLP and (granite) the attention core
    per_layer = (3 if cfg.d_ff else 2) + (1 if cfg.has_attention else 0)
    assert sizes["on"] == sizes["none"] + 2 * (2 + per_layer * LAYERS)
    assert trace.current() is NULL_TRACER


def test_the_current_tracer_is_process_wide_and_shared():
    a, b = Tracer(enabled=True), Tracer(enabled=True)
    assert trace.current() is NULL_TRACER
    with trace.use(a):
        got = []
        t = threading.Thread(target=lambda: got.append(trace.current()))
        t.start()
        t.join()
        assert got == [a]
        with trace.use(b):  # overlapping: the first block's tracer
            assert trace.current() is a
        assert trace.current() is a
    assert trace.current() is NULL_TRACER


def test_the_current_tracer_under_contention():
    """More threads than cores entering and leaving ``use`` with a short
    switch interval: inside a block the current tracer is always set, and
    when every block has ended it is NULL_TRACER again."""
    import sys

    tracers = [Tracer(enabled=True) for _ in range(16)]
    lost = []

    def churn(tr):
        for _ in range(300):
            with trace.use(tr):
                if trace.current() is NULL_TRACER:
                    lost.append(tr)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=churn, args=(tr,))
                   for tr in tracers]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not lost and trace.current() is NULL_TRACER


def test_the_sync_counters_under_four_communication_threads():
    """Four ranks' communication threads count into one registry: no
    increment is lost."""
    import sys

    steps = DataParallelTrainer.N_CALIB_STEPS + 1
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    tr = DataParallelTrainer(*_trainer_args(), devices=["cpu"] * 4,
                             group_timeout=TIMEOUT, sync_overlap=True,
                             bucket_mb=0.05)
    try:
        tr.train(batch=8, seq=16, steps=steps, log_every=0)
        counters = tr.metrics.section()["counters"]
        n = tr._plan.n_buckets
    finally:
        tr.close()
        sys.setswitchinterval(interval)
    assert counters["train/sync_calls"] == steps * n * 4


def test_the_loader_spans_each_batch():
    cfg = _cfg("granite-3-2b")
    tr = Tracer(enabled=True)
    loader = PrefetchLoader(cfg, 2, 16, device="cpu", tracer=tr)
    try:
        for _ in range(3):
            next(loader)
    finally:
        loader.close()
    count = collections.Counter(e.name for e in tr.events())
    assert count == {"data/wait": 3, "data/h2d": 3}


def _trainer_args():
    cfg = get_config("granite-3-2b").reduced().replace(
        vocab_size=256, d_model=64, num_heads=2, num_kv_heads=1, head_dim=32,
        d_ff=128, dtype="float32")
    return (cfg, RunConfig(attn_impl="dense", remat="none"),
            adamw.OptConfig(lr=1e-3, warmup_steps=0, total_steps=8))


def test_the_trainers_private_tracer_leaves_model_spans_off():
    tr = DataParallelTrainer(*_trainer_args(), devices=["cpu"] * 2,
                             group_timeout=TIMEOUT)
    try:
        tr.train(batch=4, seq=16, steps=2, log_every=0)
        names = {e.name for e in tr.tracer.events()}
    finally:
        tr.close()
    assert "compute" in names
    assert not any(n.startswith(("model/", "train/forward", "bucket_sync"))
                   for n in names)
    inner = {"model/mixer@fwd", "model/mixer@bwd", "train/forward",
             "train/backward"}
    # the caller's tracer takes the phases; the step's inner spans only
    # where the caller asks for them
    for step_spans in (False, True):
        mine = Tracer(enabled=True)
        tr = DataParallelTrainer(*_trainer_args(), devices=["cpu"] * 2,
                                 group_timeout=TIMEOUT, tracer=mine,
                                 step_tracer=mine if step_spans else None)
        try:
            tr.train(batch=4, seq=16, steps=2, log_every=0)
        finally:
            tr.close()
        names = {e.name for e in mine.events()}
        assert "compute" in names
        if step_spans:
            assert inner <= names
        else:
            assert not any(n.startswith(("model/", "train/forward",
                                         "bucket_sync")) for n in names)


def test_bucket_sync_on_the_communication_thread_and_the_sync_counters():
    """Two one-rank trainers in threads over gloo, overlapped: after the
    calibration steps every bucket's sync is a ``bucket_sync`` span on
    the rank's communication thread, and each rank hands the plan's
    buckets to the collectives once a step."""
    steps = DataParallelTrainer.N_CALIB_STEPS + 2
    store = dist.HashStore()
    out, errors = [None, None], []

    def rank(r):
        try:
            mine = Tracer(enabled=True)
            tr = DataParallelTrainer(
                *_trainer_args(), devices=["cpu"], rank=r, world=2,
                store=store, group_timeout=TIMEOUT, sync_overlap=True,
                bucket_mb=0.05, tracer=mine, step_tracer=mine)
            try:
                tr.train(batch=8, seq=16, steps=steps, log_every=0)
                out[r] = (mine, tr._plan.n_buckets, tr.metrics.section(),
                          threading.get_ident())
            finally:
                tr.close()
        except BaseException as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    if errors:
        raise errors[0]
    for mine, n_buckets, section, step_thread in out:
        assert n_buckets > 1
        syncs = mine.events("bucket_sync")
        fused = [e for e in syncs if e.tid != step_thread]
        # the calibration steps sync on the step's thread, the fused ones
        # on the communication thread
        assert len(syncs) == steps * n_buckets
        assert len(fused) == (steps - DataParallelTrainer.N_CALIB_STEPS) \
            * n_buckets
        assert sorted(e.args["bucket"] for e in fused) == sorted(
            list(range(n_buckets)) * 2)
        for name in ("sync/wait", "train/optimizer", "train/loss_sync"):
            assert len(mine.events(name)) == 2, name
        assert section["counters"]["train/sync_calls"] == steps * n_buckets
        assert section["counters"]["train/sync_bytes"] > 0


def test_build_grad_fn_sets_the_current_tracer_for_the_step():
    cfg = _cfg("granite-3-2b")
    run = RunConfig(attn_impl="auto", remat="none")
    tr = Tracer(enabled=True)
    grads_of = build_grad_fn(cfg, run, tracer=tr)
    grads_of(M.init_params(cfg, 0, "cpu"), _batch(cfg))
    assert trace.current() is NULL_TRACER
    count = collections.Counter(e.name for e in tr.events())
    assert count["train/forward"] == count["train/backward"] == 1
    assert count["model/block@fwd"] == LAYERS
