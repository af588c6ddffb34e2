"""Fig. 4 on the cards: the measured data-parallel speedup against Lemma
3.1's, one process per card (the counterpart of
``benchmarks/fig4_speedup.py``, whose "actual" is a pipeline simulator).

    PYTHONPATH=src python benchmarks/torch_dp_scaling.py \\
        [--gpus 1,2,4,8] [--steps 8] [--batch-per-rank 4] [--seq 512] \\
        [--out results/torch_dp_scaling.jsonl]
    # a CPU rehearsal: gloo processes, the reduced config
    PYTHONPATH=src python benchmarks/torch_dp_scaling.py --device cpu \\
        --reduced --gpus 1,2 --seq 64 --steps 4

For each G in ``--gpus`` that the machine has, it starts ``torchrun
--standalone --nproc-per-node G`` on this file; each process is one rank
(``DataParallelTrainer(rank=r, world=G, store=the job's TCPStore)`` on
``cuda:LOCAL_RANK``) and runs the cells in turn, each on its own groups:

- granite-3-2b at full width (40 layers, random weights from seed 0),
  ``all_reduce``, serial and overlapped (``sync_overlap``, 4 MiB buckets),
  in turns: serial, overlapped, overlapped, serial;
- the same at ``--small-layers`` layers for each of the four strategies
  (the flat ones do not fit unbucketed at full width: their flat vector
  copies add ~30 GB to the ~64 GB a rank holds).

Every cell: ``--batch-per-rank`` x ``--seq`` tokens per rank (weak
scaling), ``auto`` attention with block remat, AdamW, ``--steps`` steps;
the steady state leaves out the first two steps (an overlapped run also
its first fused step).  Rank 0 prints one JSON line per cell: tokens/s
(G x tokens per rank over the slowest rank's mean steady step), R_O from
``StepTimes``, Lemma 3.1's ``speedup(G, R_O)``, the ``SyncReport``
(measured sync beside Lemma 3.2 priced on the H100 node's NVLink tier),
the compute barrier's cost (in the steady steps, where it also waits for
the slowest rank, and alone, every rank already there), each rank's
compute without the barrier, rank 0's step walls, peak memory, and the
card's name and power limit.  This process then adds the measured speedup against G = 1 of the
same cell and the per-rank compute against G = 1's, prints each line
again, and writes them all to ``--out``.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cells(args):
    """(name, layers, strategy, overlap) per cell, full width first."""
    full = None if args.reduced else 40
    # serial and overlapped in turns (serial, overlap, overlap, serial), so
    # the two are compared within one job
    out = [("full-all_reduce", full, "all_reduce", False),
           ("full-all_reduce-overlap", full, "all_reduce", True),
           ("full-all_reduce-overlap-2", full, "all_reduce", True),
           ("full-all_reduce-2", full, "all_reduce", False)]
    for s in ("all_reduce", "reduce_scatter_all_gather", "parameter_server",
              "hier_all_reduce"):
        out.append((f"{args.small_layers}L-{s}", args.small_layers, s, False))
    return out


def worker(args) -> None:
    """One rank of a torchrun job: every cell, rank 0 printing."""
    import torch.distributed as dist

    from repro_torch.configs.base import get_config
    from repro_torch.core import amdahl
    from repro_torch.distributed.trainer import (DataParallelTrainer,
                                                 torchrun_env,
                                                 torchrun_store)
    from repro_torch.models.blocks import RunConfig
    from repro_torch.optim.adamw import OptConfig

    env = torchrun_env()
    if env is None:
        raise SystemExit("--worker runs under torchrun")
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("torch_dp_scaling: needs a CUDA device")
        dev = torch.device("cuda", env.local_rank)
        torch.cuda.set_device(dev)
        card = smi()
    else:
        dev, card = torch.device("cpu"), "cpu"
    store = torchrun_store(env, timeout=timedelta(seconds=600))
    G = env.world
    granite = get_config("granite-3-2b")
    if args.reduced:
        granite = granite.reduced()
    run = RunConfig(attn_impl="auto", remat="block")
    batch = args.batch_per_rank * G
    for n, (name, layers, strategy, overlap) in enumerate(cells(args)):
        cfg = granite.replace(num_layers=layers) if layers else granite
        opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=args.steps)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        tr = DataParallelTrainer(
            cfg, run, opt, strategy=strategy, devices=[dev], rank=env.rank,
            world=G, store=dist.PrefixStore(f"cell{n}", store),
            sync_overlap=overlap)
        try:
            res = tr.train(batch=batch, seq=args.seq, steps=args.steps,
                           log_every=0)
            rep = tr.report()
            s = tr.summary
            # the compute barrier in the steady steps (the first one also
            # sets up the NCCL communicator), and every rank's compute
            # without it: its own gradients
            warm = tr.N_CALIB_STEPS + 1 if overlap else 2
            bars = [e.dur_s for e in tr.tracer.events("barrier")][warm:]
            bar = sum(bars) / len(bars) if bars else 0.0
            own = tr.all_gather(torch.tensor(
                [tr._local_summary()["compute"] - bar], dtype=torch.float64))
            # the barrier alone, every rank already there
            tr.barrier()
            t1 = time.perf_counter()
            for _ in range(20):
                tr.barrier()
            idle_barrier = (time.perf_counter() - t1) / 20
        finally:
            tr.close()
        tokens = batch * args.seq
        line = {
            "cell": name, "G": G, "layers": cfg.num_layers,
            "strategy": strategy, "overlap": overlap,
            "tokens_per_rank": args.batch_per_rank * args.seq,
            "steps": args.steps, "step_s": s["step"],
            "tokens_per_s": tokens / s["step"] if s["step"] > 0 else 0.0,
            "slowest_rank": s["slowest_rank"],
            "compute_s": s["compute"], "comm_s": s["comm"],
            "update_s": s["update"], "r_o": rep.r_o_measured,
            "lemma31_speedup": amdahl.speedup(G, rep.r_o_measured),
            "barrier_ms_in_step": bar * 1e3,
            "own_compute_s": own.flatten().tolist(),
            "barrier_ms_alone": idle_barrier * 1e3,
            "peak_gb": s["peak_bytes"] / 1e9,
            "losses": res.losses, "wall_s": time.perf_counter() - t0,
            "step_walls_s": [t.compute + t.dist_update + t.param_update
                             for t in res.step_times],
            "fused_walls_s": [f["wall_s"] for f in tr._fused_steps],
            "sync": rep.as_dict(), "card": card,
        }
        if env.rank == 0:
            print("CELL " + json.dumps(line), flush=True)
        del tr, res
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gpus", default="1,2,4,8",
                    help="process counts G to run, where the machine has "
                         "that many cards")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch-per-rank", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--small-layers", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config (a CPU rehearsal)")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds per torchrun job")
    ap.add_argument("--out", default="results/torch_dp_scaling.jsonl")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("torch_dp_scaling: needs a CUDA device")
        have = torch.cuda.device_count()
        print(smi(), flush=True)
    else:
        have = os.cpu_count() or 1
    gs = [g for g in map(int, args.gpus.split(",")) if g <= have]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    flags = [f"--steps={args.steps}", f"--batch-per-rank={args.batch_per_rank}",
             f"--seq={args.seq}", f"--small-layers={args.small_layers}",
             f"--device={args.device}"] + (["--reduced"] if args.reduced
                                           else [])
    rows, failed = [], []
    for g in gs:
        t0 = time.perf_counter()
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(g), str(Path(__file__).resolve()),
               "--worker"] + flags
        try:
            proc = subprocess.run(cmd, env=env, capture_output=True,
                                  text=True, timeout=args.timeout)
            rc, out, err = proc.returncode, proc.stdout, proc.stderr
        except subprocess.TimeoutExpired as e:
            rc, out, err = 124, e.stdout or "", e.stderr or ""
            out = out.decode() if isinstance(out, bytes) else out
            err = err.decode() if isinstance(err, bytes) else err
        got = [json.loads(line[5:]) for line in out.splitlines()
               if line.startswith("CELL ")]
        print(f"G={g}: torchrun exit {rc}, {len(got)} cells in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if rc != 0:
            failed.append(g)
            print(err[-4000:], file=sys.stderr, flush=True)
        rows += got
    base = {r["cell"]: r for r in rows if r["G"] == 1}
    for r in rows:
        b = base.get(r["cell"])
        if b:
            r["speedup"] = r["tokens_per_s"] / b["tokens_per_s"]
            r["compute_vs_G1"] = r["compute_s"] / b["compute_s"]
        print(json.dumps(r), flush=True)
    path = ROOT / args.out
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    print(f"wrote {path}", flush=True)
    if failed:
        raise SystemExit(f"torch_dp_scaling: torchrun failed at G = {failed}")


if __name__ == "__main__":
    main()
