"""Training launcher of the port — a thin CLI over ``repro_torch.api``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        [--reduced | --full] [--steps 100] [--batch 8] [--seq 128] \\
        [--dp 2 --sync all_reduce|reduce_scatter_all_gather|parameter_server|hier_all_reduce
               [--compress none|bf16|int8|topk] [--topology 2x4]
               [--overlap --bucket-mb 4]] \\
        [--report-out PATH] [--device cuda]

    # one process per card (or per CPU rank with --device cpu)
    torchrun --standalone --nproc-per-node N -m repro_torch.launch.train \\
        --arch granite-3-2b --dp N --sync all_reduce ...

The flags are ``repro.launch.train``'s, mapped 1:1 onto a
:class:`~repro_torch.api.JobSpec`, plus ``--device`` (default ``cuda``;
``cuda`` without a card raises).  ``--dp N`` runs the data-parallel
trainer on N ranks: in one process, one thread each (``cuda:0..N-1``, or
N ranks on the CPU), or, under ``torchrun`` with N processes, this
process's rank on ``cuda:LOCAL_RANK`` (``--dp`` must equal WORLD_SIZE);
then only rank 0 prints and writes the report.  Options whose modules
are not ported (``--plan``, ``--pipe``, ``--staleness``,
``--backup-workers``, ``--autotune``, ``--ckpt-dir``, and ``--sync auto``
with ``--dp``) raise ``NotImplementedError``.  It prints the JAX
launcher's summary lines and its JSON last line.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from repro_torch.api import JobSpec, Session
from repro_torch.distributed.trainer import torchrun_env


def build_spec(args) -> JobSpec:
    return JobSpec(
        arch=args.arch, reduced=args.reduced, steps=args.steps,
        batch=args.batch, seq=args.seq, lr=args.lr,
        use_planner=args.plan, dp=args.dp, pipe=args.pipe,
        n_microbatch=args.microbatch, sync=args.sync,
        compress=args.compress, topology=args.topology,
        sync_overlap=args.overlap, bucket_mb=args.bucket_mb,
        staleness=args.staleness, backup_workers=args.backup_workers,
        tune=args.autotune, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every or (50 if args.ckpt_dir else 0),
        trace_dir=args.trace_dir)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="train the reduced family member (default); "
                         "--full / --no-reduced for the full config")
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="alias for --no-reduced")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--plan", action="store_true",
                    help="consult the planner (not ported: raises)")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint directory (not ported: raises)")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--staleness", type=int, default=0,
                    help="bounded-staleness async PS (not ported: raises)")
    ap.add_argument("--backup-workers", type=int, default=0,
                    help="backup workers (not ported: raises)")
    ap.add_argument("--dp", type=int, default=0,
                    help="run the data-parallel trainer on this many ranks "
                         "(0 = the single-device loop)")
    ap.add_argument("--pipe", type=int, default=0,
                    help="1F1B pipeline stages (not ported: > 1 raises)")
    ap.add_argument("--microbatch", type=int, default=0,
                    help="1F1B microbatches per step")
    ap.add_argument("--sync", default="auto",
                    help="gradient-sync strategy ('auto', the planner's "
                         "choice, is not ported: name one with --dp)")
    ap.add_argument("--compress", default="none",
                    help="gradient compression: none|bf16|int8|topk")
    ap.add_argument("--overlap", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="bucketed comm/compute overlap of the gradient sync "
                         "(with --dp)")
    ap.add_argument("--bucket-mb", type=float, default=0.0,
                    help="sync-bucket size target [MiB] with --overlap "
                         "(0 = the default, 4)")
    ap.add_argument("--topology", default="",
                    help="named cluster topology (core.hardware.CLUSTERS, "
                         "e.g. 2x4); empty = flat")
    ap.add_argument("--autotune", action="store_true",
                    help="closed-loop autotuner first (not ported: raises)")
    ap.add_argument("--report-out", default="",
                    help="write the Report JSON here")
    ap.add_argument("--trace-dir", default="",
                    help="write a Chrome-trace JSON of the run here")
    ap.add_argument("--metrics-json", default="",
                    help="write the run's metrics/v1 section to this path")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    return ap


def main():
    args = build_parser().parse_args()
    env = torchrun_env()
    sess = Session(build_spec(args), device=args.device)
    cfg = sess.cfg
    lead = env is None or env.rank == 0  # the one process that reports
    if lead:
        print(f"training {cfg.name} ({'reduced' if args.reduced else 'FULL'}) "
              f"batch={args.batch} seq={args.seq} steps={args.steps} "
              f"device={sess.device}"
              + (f" ranks={env.world} (one process each)" if env else ""))
    rep = sess.train()
    if not lead:
        return
    m = rep.measured
    if "sync" in m:
        print("sync report:", json.dumps(m["sync"], indent=2, default=str))
        s = m["sync"]
        if s["sync_overlap"]:
            print(f"overlap: {s['n_buckets']} buckets hide "
                  f"{s['overlap_fraction']:.0%} of sync "
                  f"(exposed {s['exposed_comm_time']*1e3:.1f}ms of "
                  f"{s['measured_comm_s']*1e3:.1f}ms serial)")
    losses = m["losses"]
    print(f"loss {np.mean(losses[:5]):.4f} -> {np.mean(losses[-5:]):.4f}; "
          f"{m['tokens_per_s']:,.0f} tok/s; R_O={m['r_o']:.4f}")
    if args.metrics_json:
        p = Path(args.metrics_json)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(m["metrics"], indent=2))
        print(f"wrote metrics {p}")
    if "trace_file" in rep.meta:
        print(f"wrote trace {rep.meta['trace_file']} "
              f"({rep.meta['trace_events']} events)")
    if args.report_out:
        print(f"wrote {rep.save(args.report_out)}")
    steps = m["step_times_mean"]
    summary = {
        "kind": "train",
        "loss_first": float(np.mean(losses[:5])),
        "loss_last": float(np.mean(losses[-5:])),
        "tokens_per_s": m["tokens_per_s"],
        "r_o": m["r_o"],
        "step_time_s": steps.get("compute", 0.0)
        + steps.get("dist_update", 0.0) + steps.get("param_update", 0.0),
    }
    if "sync" in m and m["sync"]["sync_overlap"]:
        summary["overlap_fraction"] = m["sync"]["overlap_fraction"]
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
