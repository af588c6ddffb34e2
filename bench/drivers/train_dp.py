"""Ranks on several cards: the program's ``DataParallelTrainer`` in
one-rank mode, one process per card, on a ``TCPStore`` at localhost;
strategy ``all_reduce`` over NCCL, overlapped (``sync_overlap=True``) at
the trainer's default bucket size.  The harness drives
``trainer.step_fn()`` itself, each rank fed by ``PrefetchLoader(shard=
(rank, world))`` from the benchmark's corpus.

:func:`run` is the launcher: it starts one process per rank (this file,
``--rank r``), waits for every one to exit, and merges what they wrote.
Ranks exchange nothing but through the store and NCCL; NCCL's shared-
memory transport is off (NVLink's P2P carries the traffic), so a run
leaves no file in /dev/shm.  Set-up is the weights, the trainer and the
compared steps (three: the trainer's two serial calibration steps and the
first fused step).  The window is whole steps until ``seconds`` have
passed on every rank (a one-float all-reduce after each step decides).
Rank 0 checks its state against the reference over the whole global
batch after the window: its first moment after step 1 holds the synced
gradient.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path
from typing import Dict

if __name__ == "__main__":  # a rank process: the launcher set PYTHONPATH
    sys.path[:0] = [p for p in os.environ.get("PYTHONPATH", "").split(
        os.pathsep) if p]

from bench import devtrace, harness, traffic as traffic_lib, weights  # noqa: E402
from bench.drivers import shared  # noqa: E402

RANK_TIMEOUT_S = 330
PROFILED_STEPS = 4


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(r: harness.Run) -> Dict:
    """Launch the ranks and merge their results."""
    world = int(r.cell["chips"])
    tmp = tempfile.mkdtemp(prefix="bench-dp-")
    Path(tmp, "run.json").write_text(json.dumps(
        {"cell": r.cell, "config": r.config, "traffic": r.traffic}))
    env = dict(os.environ, NCCL_SHM_DISABLE="1", PYTHONPATH=os.pathsep.join(
        [str(harness.ROOT / "src"), str(harness.ROOT)]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
           if p]))
    port = free_port()
    procs = []
    try:
        for rank in range(world):
            cmd = [sys.executable, str(Path(__file__).resolve()),
                   "--rank", str(rank), "--world", str(world),
                   "--port", str(port), "--workload", r.workload,
                   "--seed", str(r.seed), "--seconds", repr(r.seconds),
                   "--trace", str(int(r.trace)), "--t-start", repr(r.t_start),
                   "--device", r.device, "--out", tmp,
                   "--faults", ",".join(sorted(r.faults))]
            procs.append(subprocess.Popen(cmd, env=env,
                                          stdout=subprocess.DEVNULL))
        deadline = time.monotonic() + RANK_TIMEOUT_S
        codes = []
        for p in procs:
            try:
                codes.append(p.wait(timeout=max(deadline - time.monotonic(),
                                                1.0)))
            except subprocess.TimeoutExpired:
                codes.append(None)
        if any(c != 0 for c in codes):
            raise RuntimeError(f"rank exit codes {codes}")
        outs = [json.loads(Path(tmp, f"rank{i}.json").read_text())
                for i in range(world)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    head = outs[0]
    profiles = [o["profile"] for o in outs if o["profile"]]
    head["record"]["profiles"] = profiles
    head["profiles"] = profiles if len(profiles) == world else []
    head["end_to_end"]["train_peak_mem_gib"] = max(
        o["end_to_end"]["train_peak_mem_gib"] for o in outs)
    head["memory_peak_bytes"] = max(o["memory_peak_bytes"] for o in outs)
    head["forbidden"] = sorted({m for o in outs for m in o["forbidden"]})
    return head


class NoExchange:
    """A test fault: the strategy with its collectives left out (each
    rank keeps its own gradient)."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def sync(self, grads, axes, dp):
        return grads


def rank_main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    for k in ("--rank", "--world", "--port", "--seed", "--trace"):
        ap.add_argument(k, type=int, required=True)
    for k in ("--workload", "--device", "--out"):
        ap.add_argument(k, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--t-start", type=float, required=True)
    ap.add_argument("--faults", default="")
    a = ap.parse_args(argv)
    given = json.loads(Path(a.out, "run.json").read_text())
    r = harness.Run(a.workload, a.seed, a.seconds, bool(a.trace),
                    given["cell"], given["config"], given["traffic"],
                    a.t_start, device=a.device,
                    faults=frozenset(f for f in a.faults.split(",") if f))
    out = rank(r, a.rank, a.world, a.port)
    Path(a.out, f"rank{a.rank}.json").write_text(json.dumps(out))
    return 0


def rank(r: harness.Run, rank_id: int, world: int, port: int) -> Dict:
    import torch
    import torch.distributed as dist
    from repro_torch.core.ps import DEFAULT_BUCKET_MB
    from repro_torch.data.pipeline import PrefetchLoader
    from repro_torch.distributed.trainer import DataParallelTrainer

    B, S = int(r.traffic["batch"]), int(r.traffic["seq"])
    n_cmp = shared.compared_steps(r)
    cuda = r.device == "cuda"
    dev = torch.device("cuda", rank_id) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
    t_imports = time.time()
    store = dist.TCPStore("127.0.0.1", port, world, is_master=rank_id == 0,
                          timeout=timedelta(seconds=300))
    cfg, run_cfg, opt = shared.session_setup(
        r, batch=B, dp=world, sync="all_reduce", sync_overlap=True)
    trainer = DataParallelTrainer(
        cfg, run_cfg, opt, strategy="all_reduce", sync_overlap=True,
        bucket_mb=DEFAULT_BUCKET_MB, devices=[dev], rank=rank_id,
        world=world, store=store)
    if "no_exchange" in r.faults:
        trainer.strategy = NoExchange(trainer.strategy)
    params, states = trainer.replicate(
        weights.nested(weights.make(r.config, r.seed, dev)))
    shared.sync(dev)
    t_weights = time.time()
    step = trainer.step_fn()
    corpus = traffic_lib.Corpus(r.traffic, cfg.vocab_size, r.seed)
    loader = PrefetchLoader(cfg, B, S, device=[dev], corpus=corpus,
                            shard=(rank_id, world))
    exposed = trainer.metrics.histogram("train/exposed_comm_s")
    waits, profile = [], None
    try:
        losses = []
        for k in range(n_cmp):
            batch, _ = next(loader)
            params, states, m = step(params, states, batch)
            losses.append(float(m["loss"]))
            if k == 0:
                grad_m = shared.leaf_norms(states[0]["m"])
        prog = shared.program_readings(losses, grad_m,
                                       shared.change_norms(r, params[0]),
                                       opt.b1)
        shared.sync(dev)
        setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        c0, s0 = exposed.count, exposed.sum
        setup_s = time.time() - r.t_start
        if rank_id == 0:
            print(f"bench: set-up {setup_s:.1f} s: start to rank "
                  f"{t_imports - r.t_start:.1f}, store, trainer and weights "
                  f"{t_weights - t_imports:.1f}, compared steps "
                  f"{time.time() - t_weights:.1f}", file=sys.stderr,
                  flush=True)
        steps = 0
        t0 = time.perf_counter()
        while True:
            t = time.perf_counter()
            batch, _ = next(loader)
            waits.append(time.perf_counter() - t)
            params, states, _ = step(params, states, batch)
            steps += 1
            late = time.perf_counter() - t0 >= r.seconds
            if trainer.barrier(1.0 if late else 0.0) > 0:
                break
        shared.sync(dev)
        window_s = time.perf_counter() - t0
        window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        counters = {"train/exposed_comm_s": {"count": exposed.count - c0,
                                             "sum": exposed.sum - s0}}
        if r.trace and cuda:
            def some_steps():
                nonlocal params, states
                for _ in range(PROFILED_STEPS):
                    b, _ = next(loader)
                    params, states, _ = step(params, states, b)
                shared.sync(dev)

            path = os.path.join(tempfile.gettempdir(),
                                f"bench-trace-{r.workload}-rank{rank_id}.json")
            profile = devtrace.capture(some_steps, path)
    finally:
        loader.close()
        trainer.close()
    del params, states, step, trainer, batch
    shared.free_device()
    out = {
        "attempted": steps + n_cmp,
        "end_to_end": {"train_tokens_per_s": steps * B * S / window_s,
                       "train_peak_mem_gib": window_peak / 2 ** 30,
                       "setup_s": setup_s},
        "memory_peak_bytes": max(setup_peak, window_peak),
        "profile": profile,
        "forbidden": harness.forbidden_loaded(),
        "record": {"config": r.config, "batch": B, "seq": S, "chips": world,
                   "device_kind": torch.cuda.get_device_name(dev)
                   if cuda else "cpu",
                   "steps": steps, "window_s": window_s,
                   "spans": {"data_wait": waits}, "counters": counters,
                   "profiles": []},
    }
    if rank_id == 0:
        ref = shared.reference(r, dev, batch=B)
        ok, checks = shared.judge(r, prog, ref)
        out.update(correct=ok, checks=checks,
                   failed=0 if ok else n_cmp,
                   readings={"program": prog, "reference": ref})
    return out


if __name__ == "__main__":
    sys.exit(rank_main())
