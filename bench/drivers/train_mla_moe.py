"""One card, the MLA + MoE family (``mixer`` ``"mla_moe"``): granite's
one-card driver (``bench/drivers/train.py``) with this family's weights
(``bench/weights_mla_moe.py``), FLOP count (``bench/flops_mla_moe.py``)
and reference (``bench/reference/mla_moe.py``).  The step is the one
``Session.train()`` builds (``launch/steps.py::build_train_step`` on the
session's RunConfig and OptConfig), fed by the program's
``PrefetchLoader`` from the benchmark's corpus.

The reference is handed the program's experts of each compared step and
takes them for the tokens whose ranking differs from its own only at
near ties of the router's logits (``reference/mla_moe.py``).  Besides
granite's readings the driver counts, on the compared steps, the tokens
so taken and the tokens whose k experts still differ between the
program and the reference in each MoE layer, and, over the profiled
steps of a traced run, the program's counters ``moe.kept`` and
``moe.dropped`` (assignments to held experts kept and dropped by
capacity), read once after those steps.  The test fault
``routed_dropped`` leaves the routed experts' output out of the
program's MoE layers.
"""
from __future__ import annotations

import contextlib
import os
import sys
import tempfile
import time
from typing import Dict, List

import torch

from bench import devtrace, traffic as traffic_lib, weights, weights_mla_moe
from bench.drivers import shared, train
from bench.harness import Run
from bench.reference import mla_moe as ref_mla_moe


def session_setup(run: Run, *, batch: int):
    """(cfg, RunConfig, OptConfig) as ``shared.session_setup`` builds them,
    the job's length and peak learning rate the configuration's (a job of
    ``total_steps`` warms up over a tenth of them), the layout held to
    this family's."""
    from repro_torch.api import JobSpec, Session
    from repro_torch.models import model as M
    from repro_torch.models.common import tree_items

    cfg = shared.program_config(run.config)
    want = run.config["optimizer"]
    spec = JobSpec(arch=run.config["registry_id"], reduced=False,
                   batch=batch, seq=int(run.traffic["seq"]),
                   steps=int(want["total_steps"]), lr=float(want["lr"]))
    session = Session(spec, config=cfg, device=run.device)
    run_cfg, opt = session.build_run_opt()
    got = {k: getattr(opt, k) for k in shared.OPT_KEYS}
    if got != {k: want[k] for k in shared.OPT_KEYS}:
        raise ValueError(f"the session's optimizer {got} is not the "
                         f"configuration's {want}")
    weights_mla_moe.check_layout(run.config, {
        "/".join(p): s.shape for p, s in tree_items(M.model_specs(cfg))})
    return cfg, run_cfg, opt


@contextlib.contextmanager
def dropped_experts(faults):
    """With the test fault ``routed_dropped``, the program's MoE layers
    without the routed experts' output (their shared experts kept)."""
    from repro_torch.models import moe

    expert_pass = moe._local_expert_pass

    def dropped(*args, **kw):
        out, aux = expert_pass(*args, **kw)
        return out * 0.0, aux

    if "routed_dropped" in faults:
        moe._local_expert_pass = dropped
    try:
        yield
    finally:
        moe._local_expert_pass = expert_pass


@contextlib.contextmanager
def recorded_routes():
    """A list to which each step appends a list; the program's router
    appends each call's experts (T, k) to the last one: the forward's
    layers first, then block remat's recompute."""
    from repro_torch.models import moe

    topk, routes = moe._router_topk, []

    def recorded(logits, top_k):
        w, idx, aux = topk(logits, top_k)
        routes[-1].append(idx.detach().clone())
        return w, idx, aux

    moe._router_topk = recorded
    try:
        yield routes
    finally:
        moe._router_topk = topk


def change_norms(run: Run, params) -> Dict[str, float]:
    """Each leaf's distance from its initial value, made again from the
    seed one leaf at a time."""
    out = {}
    by_path = {leaf[0]: leaf for leaf in weights_mla_moe.layout(run.config)}
    for path, t in weights.flat(params).items():
        t0 = weights.make_leaf(by_path[path], run.seed, t.device)
        out[path] = float(torch.linalg.vector_norm(t.float() - t0))
        del t0
    return out


def reference(run: Run, device, *, batch: int, numerics: str = "fp32",
              prefer=None) -> Dict:
    """The reference's readings on the compared batches, each batch's rows
    together (the capacity rule counts the tokens given together);
    ``prefer``: the program's experts a compared step and MoE layer,
    which the reference takes at near ties (``reference/mla_moe.py``)."""
    seq = int(run.traffic["seq"])
    if int(run.cell["reference_rows"]) != batch:
        raise ValueError("the MoE reference takes a batch's rows together: "
                         "reference_rows must be the batch")
    corpus = traffic_lib.Corpus(run.traffic, int(run.config["model"]
                                                 ["vocab_size"]), run.seed)
    batches = []
    for i in range(shared.compared_steps(run)):
        tok, lab = traffic_lib.global_batch(corpus, batch, seq, i)
        batches.append((torch.from_numpy(tok).to(device),
                        torch.from_numpy(lab).to(device)))
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        flat0 = weights_mla_moe.make(run.config, run.seed, device)
        t0 = time.perf_counter()
        out = ref_mla_moe.follow(run.config, flat0, batches,
                                 steps=shared.compared_steps(run),
                                 numerics=numerics, prefer=prefer)
        shared.sync(device)
        print(f"bench: reference ({numerics}) {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = flags
    return out


def route_flips(prog: List[List[torch.Tensor]], ref: List[List[torch.Tensor]],
                layers: int) -> List[List[int]]:
    """Per compared step and MoE layer, the tokens whose set of experts
    differs between the program and the reference (every token where
    the two routed different tokens: a fault of the batch).  A step of
    either with fewer than ``layers`` routes recorded is refused: the
    program's router was not seen."""
    for name, steps in (("program", prog), ("reference", ref)):
        seen = [len(s) for s in steps]
        if len(steps) < 1 or min(seen) < layers:
            raise RuntimeError(f"the {name}'s routes of {layers} MoE layers "
                               f"were not recorded on every compared step "
                               f"(recorded: {seen})")

    def differ(p, r):
        if p.shape != r.shape:
            return r.shape[0]
        return int((torch.sort(p, dim=-1).values
                    != torch.sort(r.to(p.device), dim=-1).values)
                   .any(dim=-1).sum())

    return [[differ(p, r) for p, r in zip(p_step[: len(r_step)], r_step)]
            for p_step, r_step in zip(prog, ref)]


def tie_counts(ties) -> Dict:
    """The reference's near ties (``ties`` of ``mla_moe.follow``): the
    tokens it took from the program a step and MoE layer, and of the
    tokens whose ranking differed, the largest logit distance taken and
    the smallest left (None where there is none)."""
    taken, took, left = [], [], []
    for step in ties:
        taken.append([t[0] if t else 0 for t in step])
        for t in step:
            gaps = t[1] if t else []
            took += [g for g in gaps if g <= ref_mla_moe.TIE]
            left += [g for g in gaps if g > ref_mla_moe.TIE]
    return {"taken": taken, "largest_taken": max(took, default=None),
            "smallest_left": min(left, default=None)}


def run(r: Run) -> Dict:
    from repro_torch.data.pipeline import PrefetchLoader
    from repro_torch.launch.steps import build_grad_fn, build_train_step
    from repro_torch.obs import trace
    from repro_torch.optim import adamw

    B, S = int(r.traffic["batch"]), int(r.traffic["seq"])
    n_cmp = shared.compared_steps(r)
    dev = torch.device(r.device)
    t_imports = time.time()
    cfg, run_cfg, opt = session_setup(r, batch=B)
    params = weights.nested(weights_mla_moe.make(r.config, r.seed, dev))
    shared.sync(dev)
    t_weights = time.time()
    state = adamw.init_state(opt, params)
    grads_of = build_grad_fn(cfg, run_cfg)
    step_fn = train.faulty(build_train_step(cfg, run_cfg, opt), grads_of, opt,
                           r.faults - {"routed_dropped"}, adamw)
    corpus = traffic_lib.Corpus(r.traffic, cfg.vocab_size, r.seed)
    loader = PrefetchLoader(cfg, B, S, device=dev, corpus=corpus)
    spans = {"data_wait": [], "grad": [], "adamw": []}
    counters: Dict[str, Dict[str, float]] = {}
    profile = None
    try:
        with dropped_experts(r.faults):
            losses = []
            with recorded_routes() as prog_routes:
                for k in range(n_cmp):
                    batch, _ = next(loader)
                    prog_routes.append([])
                    params, state, m = step_fn(params, state, batch)
                    losses.append(m["loss"])
                    if k == 0:
                        grad_m = shared.leaf_norms(state["m"])
            prog = shared.program_readings([float(x) for x in losses], grad_m,
                                           change_norms(r, params), opt.b1)
            shared.sync(dev)
            setup_peak = torch.cuda.max_memory_allocated() \
                if dev.type == "cuda" else 0
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            setup_s = time.time() - r.t_start
            print(f"bench: set-up {setup_s:.1f} s: start to driver "
                  f"{t_imports - r.t_start:.1f}, session and weights "
                  f"{t_weights - t_imports:.1f}, compared steps "
                  f"{time.time() - t_weights:.1f}", file=sys.stderr,
                  flush=True)
            steps = 0
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < r.seconds:
                if not r.trace:
                    batch, _ = next(loader)
                    params, state, _ = step_fn(params, state, batch)
                else:
                    t = time.perf_counter()
                    batch, _ = next(loader)
                    spans["data_wait"].append(time.perf_counter() - t)
                    t = time.perf_counter()
                    _, _, grads = grads_of(params, batch)
                    shared.sync(dev)
                    spans["grad"].append(time.perf_counter() - t)
                    t = time.perf_counter()
                    params, state, _ = adamw.apply_updates(opt, params, grads,
                                                           state)
                    del grads
                    shared.sync(dev)
                    spans["adamw"].append(time.perf_counter() - t)
                steps += 1
            shared.sync(dev)
            window_s = time.perf_counter() - t0
            window_peak = torch.cuda.max_memory_allocated() \
                if dev.type == "cuda" else 0
            if r.trace and dev.type == "cuda":
                profiled = 0

                def some_steps():
                    nonlocal params, state, profiled
                    t, n = time.perf_counter(), 0
                    while n < 2 or time.perf_counter() - t < 1.5:
                        b, _ = next(loader)
                        params, state, _ = step_fn(params, state, b)
                        n += 1
                    shared.sync(dev)
                    profiled += n

                trace.PROFILER_TRACER.counts()  # none before the profile
                path = os.path.join(tempfile.gettempdir(),
                                    f"bench-trace-{r.workload}.json")
                profile = devtrace.capture(some_steps, path)
                for name, total in trace.PROFILER_TRACER.counts().items():
                    counters[name] = {"count": profiled, "sum": total}
                print(f"bench: chrome trace {path}; counters a step "
                      + ", ".join(f"{k} {c['sum'] / c['count']:.1f}"
                                  for k, c in counters.items()),
                      file=sys.stderr)
    finally:
        loader.close()
    del params, state, step_fn, grads_of, batch, m, losses
    shared.free_device()
    moe_layers = cfg.num_layers - cfg.first_k_dense
    ref = reference(r, dev, batch=B,
                    prefer=[step[:moe_layers] for step in prog_routes])
    flips = route_flips(prog_routes, ref["routes"], moe_layers)
    ties = tie_counts(ref["ties"])
    print(f"bench: tokens routed differently, a compared step by MoE layer "
          f"(of {B * S}): {flips}; near ties the reference took from the "
          f"program: {ties['taken']}, the largest logit distance taken "
          f"{ties['largest_taken']}, the smallest left "
          f"{ties['smallest_left']}", file=sys.stderr, flush=True)
    ok, checks = shared.judge(r, prog, ref)
    record = {
        "config": r.config, "batch": B, "seq": S, "chips": 1,
        "device_kind": torch.cuda.get_device_name(dev)
        if dev.type == "cuda" else "cpu",
        "steps": steps, "window_s": window_s, "spans": spans,
        "counters": counters, "profiles": [profile] if profile else [],
    }
    return {
        "correct": ok, "checks": checks,
        "attempted": steps + n_cmp,
        "failed": 0 if ok else n_cmp,
        "end_to_end": {
            "train_tokens_per_s": steps * B * S / window_s,
            "train_peak_mem_gib": window_peak / 2 ** 30,
            "setup_s": setup_s,
        },
        "record": record,
        "memory_peak_bytes": max(setup_peak, window_peak),
        "profiles": record["profiles"],
        "readings": {"program": prog, "reference": ref},
        "route_flips": flips,
        "route_ties": ties,
    }
