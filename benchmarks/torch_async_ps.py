"""The bounded-staleness parameter server on the cards, one process per
card: the measured step against the T_step(s, k) model
(``repro_torch.core.ps.async_step_time``) and against the synchronous
parameter-server trainer of the same job.

    PYTHONPATH=src python benchmarks/torch_async_ps.py \\
        [--gpus 1,2,4] [--layers 4] [--steps 8] [--batch-per-rank 4] \\
        [--seq 512] [--out results/torch_async_ps.jsonl]
    # a CPU rehearsal: gloo processes, the reduced config
    PYTHONPATH=src python benchmarks/torch_async_ps.py --device cpu \\
        --reduced --gpus 1,2 --seq 64 --steps 4

For each G in ``--gpus`` that the machine has, it starts ``torchrun
--standalone --nproc-per-node G`` on this file; each process is one rank
(``rank=r, world=G`` on ``cuda:LOCAL_RANK``, the job's ``TCPStore``) and
runs the cells in turn, each on its own groups:

- ``ps``: the synchronous ``DataParallelTrainer`` with the
  ``parameter_server`` strategy (N_ps = G servers);
- ``s{s}k{k}``: the ``AsyncPSTrainer`` at staleness s in {0, 2} and k in
  {0, 1} backup workers (k < G);
- ``ps-2``: the synchronous trainer again, so the spread of one cell
  within the job is known.

Every cell: granite-3-2b at full width and ``--layers`` layers (4 by
default: the parameter server's flat copies, ~4 x the 10.1 GB of fp32
gradients at 40 layers, and the worker copy do not fit beside a rank's
30 GB of params and moments in 80 GB), random weights from seed 0,
``--batch-per-rank`` x ``--seq`` tokens per rank, ``auto`` attention with
block remat, AdamW, ``--steps`` steps; the steady state leaves out the
first two.  Rank 0 prints one JSON line per cell: tokens/s (G x tokens per
rank over the slowest rank's mean steady step), compute, sync and update,
the async report (refreshes, ages, drops, and the model's terms priced on
the H100 node's NVLink tier at the measured compute), peak memory and the
card's name and power limit.  This process adds each cell's step against
the mean of its job's two ``ps`` cells, prints each line again and writes
them to ``--out``.
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


def cells(G: int):
    """(name, staleness, backup workers or None for the synchronous PS)."""
    out = [("ps", 0, None)]
    for k in (0, 1):
        if k < G:
            out += [(f"s{s}k{k}", s, k) for s in (0, 2)]
    return out + [("ps-2", 0, None)]


def worker(args) -> None:
    """One rank of a torchrun job: every cell, rank 0 printing."""
    import torch.distributed as dist

    from repro_torch.configs.base import get_config
    from repro_torch.distributed import AsyncPSTrainer, DataParallelTrainer
    from repro_torch.distributed.trainer import torchrun_env, torchrun_store
    from repro_torch.models.blocks import RunConfig
    from repro_torch.optim.adamw import OptConfig

    env = torchrun_env()
    if env is None:
        raise SystemExit("--worker runs under torchrun")
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("torch_async_ps: needs a CUDA device")
        dev = torch.device("cuda", env.local_rank)
        torch.cuda.set_device(dev)
        card = smi()
    else:
        dev, card = torch.device("cpu"), "cpu"
    store = torchrun_store(env, timeout=timedelta(seconds=600))
    G = env.world
    cfg = get_config("granite-3-2b")
    cfg = cfg.reduced() if args.reduced else cfg.replace(
        num_layers=args.layers)
    run = RunConfig(attn_impl="auto", remat="block")
    batch = args.batch_per_rank * G
    for n, (name, s, k) in enumerate(cells(G)):
        opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=args.steps)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        kw = dict(devices=[dev], rank=env.rank, world=G,
                  store=dist.PrefixStore(f"cell{n}", store))
        if k is None:
            tr = DataParallelTrainer(cfg, run, opt,
                                     strategy="parameter_server", **kw)
        else:
            tr = AsyncPSTrainer(cfg, run, opt, staleness=s,
                                backup_workers=k, **kw)
        t0 = time.perf_counter()
        try:
            res = tr.train(batch=batch, seq=args.seq, steps=args.steps,
                           log_every=0)
            rep = tr.report()
            summ = tr.summary
            a = tr.async_report().as_dict() if k is not None else None
        finally:
            tr.close()
        step = summ["step"]
        line = {
            "cell": name, "G": G, "layers": cfg.num_layers,
            "staleness": s, "backup_workers": k,
            "tokens_per_rank": args.batch_per_rank * args.seq,
            "steps": args.steps, "step_s": step,
            "tokens_per_s": batch * args.seq / step if step > 0 else 0.0,
            "slowest_rank": summ["slowest_rank"],
            "compute_s": summ["compute"], "comm_s": summ["comm"],
            "update_s": summ["update"],
            "model_wall_step_s": (a["t_step_model"]["wall_step"]
                                  if a else None),
            "async_ps": a, "sync": rep.as_dict(),
            "peak_gb": summ["peak_bytes"] / 1e9, "losses": res.losses,
            "step_walls_s": [t.compute + t.dist_update + t.param_update
                             for t in res.step_times],
            "wall_s": time.perf_counter() - t0, "card": card,
        }
        if env.rank == 0:
            print("CELL " + json.dumps(line), flush=True)
        del tr, res
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gpus", default="1,2,4",
                    help="process counts G to run, where the machine has "
                         "that many cards")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch-per-rank", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config (a CPU rehearsal)")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds per torchrun job")
    ap.add_argument("--out", default="results/torch_async_ps.jsonl")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("torch_async_ps: needs a CUDA device")
        have = torch.cuda.device_count()
        print(smi(), flush=True)
    else:
        have = os.cpu_count() or 1
    gs = [g for g in map(int, args.gpus.split(",")) if g <= have]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    flags = [f"--steps={args.steps}", f"--batch-per-rank={args.batch_per_rank}",
             f"--seq={args.seq}", f"--layers={args.layers}",
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
        ps = [r["step_s"] for r in got if r["cell"] in ("ps", "ps-2")]
        for r in got:
            r["step_vs_sync_ps"] = (r["step_s"] / (sum(ps) / len(ps))
                                    if ps else None)
        rows += got
    for r in rows:
        print(json.dumps(r), flush=True)
    path = ROOT / args.out
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    print(f"wrote {path}", flush=True)
    if failed:
        raise SystemExit(f"torch_async_ps: torchrun failed at G = {failed}")


if __name__ == "__main__":
    main()
