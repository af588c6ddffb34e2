"""Training launcher of the port — a thin CLI over ``repro_torch.api``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        [--reduced | --full] [--steps 100] [--batch 8] [--seq 128] [--plan] \\
        [--dp 2 --sync auto|all_reduce|reduce_scatter_all_gather|parameter_server|hier_all_reduce
               [--compress none|bf16|int8|topk] [--topology 2x4]
               [--overlap --bucket-mb 4]
               [--staleness 2 --backup-workers 1 [--sync auto]]] \\
        [--pipe 2 [--microbatch 4] [--dp 4]] \\
        [--autotune [--tune-cache results/calibration_cache.json]] \\
        [--ckpt-dir DIR [--ckpt-every 50]] [--report-out PATH] [--device cuda]

    # one process per card (or per CPU rank with --device cpu)
    torchrun --standalone --nproc-per-node N -m repro_torch.launch.train \\
        --arch granite-3-2b --dp N --sync all_reduce ...

The flags are ``repro.launch.train``'s, mapped 1:1 onto a
:class:`~repro_torch.api.JobSpec`, plus ``--device`` (default ``cuda``;
``cuda`` without a card raises).  ``--dp N`` runs the data-parallel
trainer on N ranks: in one process, one thread each (``cuda:0..N-1``, or
N ranks on the CPU), or, under ``torchrun`` with N processes, this
process's rank on ``cuda:LOCAL_RANK`` (``--dp`` must equal WORLD_SIZE);
then only rank 0 prints, writes the report and the checkpoints.
``--staleness`` / ``--backup-workers`` (with ``--dp``) run the
bounded-staleness parameter server (``--sync auto`` is then the
parameter server); otherwise ``--sync auto`` (the default) with ``--dp``
runs the planner's schedule.  ``--plan`` prints the plan (priced on the
H100 cluster the mesh names, or on ``--topology``) and runs with its
attention, remat, microbatch and optimizer.  ``--autotune`` runs the
closed-loop autotuner first (``Session.tune``: the kernel variants timed,
short training steps measured, the hardware constants calibrated), prints
its choices and adopts its attention and microbatch; the calibration
persists in ``--tune-cache`` ('' disables it).  ``--ckpt-dir``
checkpoints every ``--ckpt-every`` steps (0: 50) and resumes from the
newest complete step there.  ``--pipe P`` (> 1) runs the 1F1B pipeline
trainer over P stages and ``--microbatch`` microbatches (0: P), with
``--dp`` (default P) entries in all, stage-major, driven by this one
process (on one card every stage shares it; under ``torchrun`` it
raises ``NotImplementedError``).  It prints the JAX launcher's summary
lines and its JSON last line.
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
        tune=args.autotune, tune_cache=args.tune_cache,
        ckpt_dir=args.ckpt_dir,
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
                    help="print the planner's plan and adopt its knobs "
                         "(microbatch / attention / remat / optimizer)")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint directory: save every --ckpt-every "
                         "steps, resume from its newest complete step")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="steps between checkpoints (0 = 50 with "
                         "--ckpt-dir)")
    ap.add_argument("--staleness", type=int, default=0,
                    help="bounded-staleness async PS: max worker param age "
                         "(with --dp)")
    ap.add_argument("--backup-workers", type=int, default=0,
                    help="async PS: drop the slowest k of dp gradients per "
                         "step (with --dp)")
    ap.add_argument("--dp", type=int, default=0,
                    help="run the data-parallel trainer on this many ranks "
                         "(0 = the single-device loop)")
    ap.add_argument("--pipe", type=int, default=0,
                    help="1F1B pipeline stages (> 1: the pipeline "
                         "trainer; --dp then counts every stage's shards)")
    ap.add_argument("--microbatch", type=int, default=0,
                    help="1F1B microbatches per step")
    ap.add_argument("--sync", default="auto",
                    help="gradient-sync strategy ('auto' = the planner's "
                         "schedule; with --staleness or --backup-workers "
                         "the parameter server)")
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
                    help="run the closed-loop autotuner first (time the "
                         "kernel variants, calibrate the hardware "
                         "constants) and adopt its knobs for the run")
    ap.add_argument("--tune-cache", default="results/calibration_cache.json",
                    help="calibration-cache JSON for --autotune "
                         "('' disables persistence)")
    ap.add_argument("--report-out", default="",
                    help="write the Report JSON here")
    ap.add_argument("--trace-dir", default="",
                    help="write a Chrome-trace JSON of the run here")
    ap.add_argument("--metrics-json", default="",
                    help="write the run's metrics/v1 section to this path")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    env = torchrun_env()
    sess = Session(build_spec(args), device=args.device)
    cfg = sess.cfg
    lead = env is None or env.rank == 0  # the one process that reports
    if lead and args.plan:
        print("planner:", sess.resolved_plan)
    if lead:
        print(f"training {cfg.name} ({'reduced' if args.reduced else 'FULL'}) "
              f"batch={args.batch} seq={args.seq} steps={args.steps} "
              f"device={sess.device}"
              + (f" ranks={env.world} (one process each)" if env else ""))
        if args.dp and args.sync == "auto" and not (args.staleness
                                                    or args.backup_workers):
            print(f"sync resolved from planner: "
                  f"{sess.resolved_plan.sync_schedule}")
    if args.autotune:
        t = sess.tuned  # every rank measures; rank 0 reports
        r = t.replan
        if lead:
            print(f"autotune: minibatch*={t.chosen_minibatch} (m_bound), "
                  f"microbatch*={t.chosen_microbatch}, attn={t.attn_impl()}; "
                  f"step predicted {r['est_step_time_calibrated_s']*1e3:.1f}ms "
                  f"calibrated vs "
                  f"{r['est_step_time_uncalibrated_s']*1e3:.3g}ms datasheet "
                  f"(measured {r['measured_step_s']*1e3:.1f}ms)")
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
    if "async_ps" in m:
        a = m["async_ps"]
        print(f"async PS: staleness={a['staleness']} "
              f"(age mean {a['mean_age']:.2f} / max {a['max_age']}), "
              f"backup_workers={a['backup_workers']} "
              f"({a['drops']} grads dropped), "
              f"pull amortized 1/{a['staleness'] + 1}; model wall step "
              f"{a['t_step_model']['wall_step']*1e3:.3g}ms at "
              f"{a['t_step_model']['efficiency']:.0%} statistical "
              f"efficiency")
    if "pipeline" in m:
        pr = m["pipeline"]
        print(f"pipeline: {pr['pipe']} stages x {pr['n_microbatch']} "
              f"microbatches, bubble measured {pr['bubble_measured']:.3f} "
              f"vs model {pr['bubble_model']:.3f} "
              f"(serial {pr['bubble_serial']:.3f})")
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
    if "async_ps" in m:
        summary["staleness"] = m["async_ps"]["staleness"]
        summary["backup_workers"] = m["async_ps"]["backup_workers"]
        summary["mean_age"] = m["async_ps"]["mean_age"]
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
