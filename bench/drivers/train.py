"""One card: the train step ``Session.train()`` builds for the cell
(``launch/steps.py::build_train_step`` on the session's RunConfig and
OptConfig), fed by the program's ``PrefetchLoader`` from the benchmark's
corpus.

Set-up makes the weights from the seed, builds the step and runs the
compared steps (they also warm up every shape).  The window is
whole steps until ``seconds`` have passed, ended by a device synchronize.
With ``trace`` the window calls the step's two halves apart (the
program's ``grads_of`` and ``adamw.apply_updates``, each ended by a
synchronize) and then profiles a few whole steps.  After the window the
program's state is freed and the reference follows the compared steps.
"""
from __future__ import annotations

import os
import sys
import tempfile
import time
from typing import Dict

import torch

from bench import devtrace, traffic as traffic_lib, weights
from bench.drivers import shared
from bench.harness import Run


def faulty(step_fn, grads_of, opt, faults, adamw):
    """The train step with the test faults planted (none in a real run):
    ``frozen`` returns the state unchanged, ``half_batch`` drops half the
    rows, ``leaf_altered`` doubles one gradient leaf where it is made."""
    if not faults:
        return step_fn

    def step(params, state, batch):
        if "half_batch" in faults:
            n = batch["tokens"].shape[0] // 2
            batch = {k: v[:n] for k, v in batch.items()}
        if "frozen" in faults:
            loss, _, _ = grads_of(params, batch)
            return params, state, {"loss": loss}
        loss, _, grads = grads_of(params, batch)
        if "leaf_altered" in faults:
            grads["embed"] = grads["embed"] * 2.0
        params, state, _ = adamw.apply_updates(opt, params, grads, state)
        return params, state, {"loss": loss}

    return step


def run(r: Run) -> Dict:
    from repro_torch.data.pipeline import PrefetchLoader
    from repro_torch.launch.steps import build_grad_fn, build_train_step
    from repro_torch.optim import adamw

    B, S = int(r.traffic["batch"]), int(r.traffic["seq"])
    n_cmp = shared.compared_steps(r)
    dev = torch.device(r.device)
    t_imports = time.time()
    cfg, run_cfg, opt = shared.session_setup(r, batch=B)
    params = weights.nested(weights.make(r.config, r.seed, dev))
    shared.sync(dev)
    t_weights = time.time()
    state = adamw.init_state(opt, params)
    grads_of = build_grad_fn(cfg, run_cfg)
    step_fn = faulty(build_train_step(cfg, run_cfg, opt), grads_of, opt,
                     r.faults, adamw)
    corpus = traffic_lib.Corpus(r.traffic, cfg.vocab_size, r.seed)
    loader = PrefetchLoader(cfg, B, S, device=dev, corpus=corpus)
    spans = {"data_wait": [], "grad": [], "adamw": []}
    profile = None
    try:
        losses = []
        for k in range(n_cmp):
            batch, _ = next(loader)
            params, state, m = step_fn(params, state, batch)
            losses.append(m["loss"])
            if k == 0:
                grad_m = shared.leaf_norms(state["m"])
        prog = shared.program_readings([float(x) for x in losses], grad_m,
                                       shared.change_norms(r, params),
                                       opt.b1)
        shared.sync(dev)
        setup_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" \
            else 0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.time() - r.t_start
        print(f"bench: set-up {setup_s:.1f} s: start to driver "
              f"{t_imports - r.t_start:.1f}, session and weights "
              f"{t_weights - t_imports:.1f}, compared steps "
              f"{time.time() - t_weights:.1f}", file=sys.stderr, flush=True)
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
            def some_steps():
                nonlocal params, state
                t, n = time.perf_counter(), 0
                while n < 2 or time.perf_counter() - t < 1.5:
                    b, _ = next(loader)
                    params, state, _ = step_fn(params, state, b)
                    n += 1
                shared.sync(dev)

            path = os.path.join(tempfile.gettempdir(),
                                f"bench-trace-{r.workload}.json")
            profile = devtrace.capture(some_steps, path)
            print(f"bench: chrome trace {path}", file=sys.stderr)
    finally:
        loader.close()
    del params, state, step_fn, grads_of, batch, m, losses
    shared.free_device()
    ref = shared.reference(r, dev, batch=B)
    ok, checks = shared.judge(r, prog, ref)
    record = {
        "config": r.config, "batch": B, "seq": S, "chips": 1,
        "device_kind": torch.cuda.get_device_name(dev)
        if dev.type == "cuda" else "cpu",
        "steps": steps, "window_s": window_s, "spans": spans,
        "counters": {}, "profiles": [profile] if profile else [],
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
    }
