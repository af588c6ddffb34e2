"""What the program's spans cost in a profiled run: the wall time of
profiled steps with the spans on (the step, loader and trainer built
without a tracer, so their spans follow the profiler, as in a traced
run) and off (built with ``NULL_TRACER``), in pairs of adjacent steps of
the same profile, the order alternating, each step ended by a device
synchronize.  Adjacent steps see the card in the same state (whole
profiled turns of either variant drift by several percent over a run),
so each pair's ratio sees the spans alone.

    python3 bench/trace_cost.py --workload <cell> --seed <n> [--pairs 4]

A four-card cell runs under ``torchrun --nproc-per-node 4``: each rank
builds the cell's overlapped trainer twice on its card (spans on, off),
shares the weights and state between them, and rank 0 prints.  Prints
one JSON line: the card, each step's wall by variant, each pair's ratio
on over off, and their median.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from bench import harness, traffic as traffic_lib, weights  # noqa: E402
from bench.drivers import shared  # noqa: E402


def pairs_of(run_steps, pairs: int):
    """Walls of ``pairs`` (off, on) pairs of single steps in one profile,
    the order alternating; a step of each first, unmeasured."""
    from torch.profiler import ProfilerActivity, profile

    for name in ("off", "on"):
        run_steps(name, 1)
    walls = {"on": [], "off": []}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for k in range(pairs):
            for name in (("off", "on") if k % 2 == 0 else ("on", "off")):
                t0 = time.perf_counter()
                run_steps(name, 1)
                walls[name].append(time.perf_counter() - t0)
    return walls


def one_card(r: harness.Run, pairs: int):
    import torch
    from repro_torch.data.pipeline import PrefetchLoader
    from repro_torch.launch.steps import build_train_step
    from repro_torch.obs.trace import NULL_TRACER
    from repro_torch.optim import adamw

    B, S = int(r.traffic["batch"]), int(r.traffic["seq"])
    dev = torch.device("cuda")
    cfg, run_cfg, opt = shared.session_setup(r, batch=B)
    held = {"params": weights.nested(weights.make(r.config, r.seed, dev))}
    held["state"] = adamw.init_state(opt, held["params"])
    built = {}
    for name, tr in (("off", NULL_TRACER), ("on", None)):
        corpus = traffic_lib.Corpus(r.traffic, cfg.vocab_size, r.seed)
        built[name] = (build_train_step(cfg, run_cfg, opt, tracer=tr),
                       PrefetchLoader(cfg, B, S, device=dev, corpus=corpus,
                                      tracer=tr))

    def run_steps(name, n):
        step, loader = built[name]
        for _ in range(n):
            batch, _ = next(loader)
            held["params"], held["state"], _ = step(
                held["params"], held["state"], batch)
        torch.cuda.synchronize(dev)

    try:
        return pairs_of(run_steps, pairs)
    finally:
        for _, loader in built.values():
            loader.close()


def four_cards(r: harness.Run, pairs: int):
    import torch
    import torch.distributed as dist
    from repro_torch.core.ps import DEFAULT_BUCKET_MB
    from repro_torch.data.pipeline import PrefetchLoader
    from repro_torch.distributed.trainer import (DataParallelTrainer,
                                                 torchrun_env, torchrun_store)
    from repro_torch.obs.trace import NULL_TRACER

    env = torchrun_env()
    if env is None:
        raise SystemExit("a four-card cell runs under torchrun")
    B, S = int(r.traffic["batch"]), int(r.traffic["seq"])
    dev = torch.device("cuda", env.local_rank)
    torch.cuda.set_device(dev)
    store = torchrun_store(env)
    cfg, run_cfg, opt = shared.session_setup(
        r, batch=B, dp=env.world, sync="all_reduce", sync_overlap=True)
    built = {}
    held = {}
    for name, tr in (("off", NULL_TRACER), ("on", None)):
        trainer = DataParallelTrainer(
            cfg, run_cfg, opt, strategy="all_reduce", sync_overlap=True,
            bucket_mb=DEFAULT_BUCKET_MB, devices=[dev], rank=env.rank,
            world=env.world, store=dist.PrefixStore(name, store), tracer=tr)
        if not held:
            held["params"], held["state"] = trainer.replicate(
                weights.nested(weights.make(r.config, r.seed, dev)))
        corpus = traffic_lib.Corpus(r.traffic, cfg.vocab_size, r.seed)
        built[name] = (trainer, trainer.step_fn(), PrefetchLoader(
            cfg, B, S, device=[dev], corpus=corpus,
            shard=(env.rank, env.world), tracer=tr))

    def run_steps(name, n):
        _, step, loader = built[name]
        for _ in range(n):
            batch, _ = next(loader)
            held["params"], held["state"], _ = step(
                held["params"], held["state"], batch)
        torch.cuda.synchronize(dev)

    try:
        for name in built:  # the calibration steps, serial
            run_steps(name, DataParallelTrainer.N_CALIB_STEPS)
        walls = pairs_of(run_steps, pairs)
    finally:
        for trainer, _, loader in built.values():
            loader.close()
            trainer.close()
    return walls if env.rank == 0 else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=4)
    a = ap.parse_args(argv)
    r = harness.Run.of(a.workload, a.seed, 0.0, True, harness.process_start())
    four = int(r.cell["chips"]) > 1
    walls = (four_cards if four else one_card)(r, a.pairs)
    if walls is None:
        return 0
    ratios = [on / off for on, off in zip(walls["on"], walls["off"])]
    print(json.dumps({"workload": a.workload, "seed": a.seed,
                      "card": harness.card(), "wall_s": walls,
                      "on_over_off": ratios,
                      "median_on_over_off": statistics.median(ratios)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
