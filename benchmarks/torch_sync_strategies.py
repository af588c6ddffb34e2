"""Measured gradient sync against Lemma 3.2, per strategy, on the cards.

    PYTHONPATH=src python -m benchmarks.torch_sync_strategies \\
        [--layers 4] [--steps 5] [--batch-per-rank 2] [--seq 512] \\
        [--link-bw 450e9] [--device cuda]

Runs ``DataParallelTrainer`` on every visible card (one rank each, NCCL;
``--device cpu --dp N`` runs N ranks on the CPU over gloo) for each of
the four strategies, uncompressed: granite-3-2b at full width with
``--layers`` layers, random weights from seed 0, ``auto`` attention with
block remat, AdamW.  Prints one JSON line per strategy with the
``SyncReport`` (the measured sync phase beside Lemma 3.2's prediction for
the same payload, dp and ``--link-bw``) and the card's name and power
limit.  ``--link-bw`` defaults to 450e9 bytes/s, the H100 SXM data
sheet's NVLink bandwidth per direction (900 GB/s both ways).
``run(csv_rows)`` is the harness entry (``benchmarks/torch_run.py``).
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from repro_torch.configs.base import get_config
from repro_torch.distributed.collectives import STRATEGIES
from repro_torch.distributed.trainer import DataParallelTrainer
from repro_torch.models.blocks import RunConfig
from repro_torch.optim.adamw import OptConfig


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch-per-rank", type=int, default=2)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--link-bw", type=float, default=450e9)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dp", type=int, default=0,
                    help="ranks (default: every visible card)")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config (a CPU rehearsal)")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    """Every strategy's line (also printed), in STRATEGIES order."""
    args = parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("torch_sync_strategies: needs a CUDA device")
        dp = args.dp or torch.cuda.device_count()
        devices = [f"cuda:{i}" for i in range(dp)]
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        print(card, flush=True)
    else:
        dp = args.dp or 2
        devices = [args.device] * dp
        card = "cpu (no device numbers)"
    cfg = get_config("granite-3-2b")
    cfg = cfg.reduced() if args.reduced else cfg.replace(
        num_layers=args.layers)
    run = RunConfig(attn_impl="auto", remat="block")
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=args.steps)
    lines = []
    for name in STRATEGIES:
        tr = DataParallelTrainer(cfg, run, opt, strategy=name,
                                 devices=devices, link_bw=args.link_bw)
        try:
            res = tr.train(batch=args.batch_per_rank * dp, seq=args.seq,
                           steps=args.steps, log_every=0)
            rep = tr.report().as_dict()
        finally:
            tr.close()
        line = {"strategy": name, "dp": dp, "layers": cfg.num_layers,
                "losses": res.losses, "sync": rep, "card": card}
        print(json.dumps(line), flush=True)
        lines.append(line)
        del tr
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return lines


def run(csv_rows, device="cuda", reduced=False):
    """Harness entry (``benchmarks/torch_run.py --only sync``): every
    strategy in this process on the visible cards (two gloo ranks on the
    CPU; ``--reduced`` at seq 64 there), no re-exec: torch needs no flag
    set before it is imported.  JAX's ``measured_comm_s`` rows, with the
    measured R_O beside Lemma 3.2's prediction."""
    print("\n== sync strategies: measured vs Lemma 3.2 ==")
    for line in main(["--device", device] + (
            ["--reduced", "--seq", "64"] if reduced else [])):
        s = line["sync"]
        key = f"sync/{s['strategy']}/{s['compression']}"
        csv_rows.append((f"{key}/measured_comm_s", s["measured_comm_s"],
                         f"predicted={s['predicted_comm_s']:.4f},"
                         f"dp={line['dp']}"))
        csv_rows.append((f"{key}/r_o_measured", s["r_o_measured"],
                         f"masked={s['masked_measured']}"))


if __name__ == "__main__":
    main()
