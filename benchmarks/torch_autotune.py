"""The paper's closed-loop autotuner on the card: ``Session.tune()`` at
full width, measured, calibrated and checked against itself (the port's
twin of ``benchmarks/autotune.py``).

    PYTHONPATH=src python benchmarks/torch_autotune.py [--arch granite-3-2b] \\
        [--batch 2] [--seq 512] [--steps 3] \\
        [--cache results/calibration_cache.json | --cache ''] \\
        [--out results/torch_autotune.json]
    # data parallel, one process per card (--dp equal to the process count;
    # the global --batch splits over the ranks; rank 0 writes)
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
        benchmarks/torch_autotune.py --dp 4 --batch 8
    # a CPU rehearsal at the reduced config
    PYTHONPATH=src python benchmarks/torch_autotune.py --device cpu \\
        --reduced --seq 64 --out build/torch_autotune.json

``run(csv_rows)`` is the harness entry (``benchmarks/torch_run.py``): one
tune in this process on the visible card, no re-exec (torch needs no flag
set before it is imported, as JAX's forced device count is).

``Session.tune()`` times the four CUDA kernels against their plain
versions (``bench_kernels``), measures ``--steps`` training steps of the
executed config at ``--batch`` x ``--seq`` (``auto`` attention, no remat;
with ``--dp`` the ``all_reduce`` trainer and then the overlap sweep at
1, 4 and 16 MiB buckets), fits a ``Calibration``, runs the paper's
minibatch procedure on the production job (granite-3-2b ``train_4k`` on
one 8 x H100 node, ``h100-8``) and re-plans it on the measured constants.
A cache that already holds this backend/cluster/config skips the
measured steps (the report says ``from_cache``); ``--cache ''`` measures
and keeps nothing.

It checks the JAX benchmark's two acceptance properties and exits
non-zero when either fails:

1. the chosen minibatch is the largest ``X_mini`` with Eq. 5's
   ``m_bound >= 0`` (``m_bound`` falls with ``X_mini``);
2. the calibrated step estimate of the executed job lands closer to the
   measured step than the data sheet's (``replan.calibrated_closer``).

It prints each op's pick and times, the calibration, both step estimates
of the executed job and of the production job, the stages' spans, the
peak device memory, and the card's name and power limit; the report
(kind ``tune``) goes to ``--out`` with that provenance under ``meta``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def bench(args) -> dict:
    from repro_torch.api import JobSpec, Session, validate_report
    from repro_torch.core import memory_model as mm
    from repro_torch.distributed.trainer import torchrun_env

    env = torchrun_env()
    lead = env is None or env.rank == 0
    dev = torch.device(args.device)
    spec = JobSpec(arch=args.arch, reduced=args.reduced, batch=args.batch,
                   seq=args.seq, steps=1, dp=args.dp, log_every=0, tune=True,
                   tune_steps=args.steps, tune_cache=args.cache)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    session = Session(spec, device=args.device)
    rep = session.tune()
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
            else None)
    d = rep.to_dict()
    validate_report(d)
    t = d["measured"]["tuning"]

    # acceptance 1: chosen minibatch == the largest X_mini with m_bound >= 0
    mb = t["minibatch"]
    chosen, hbm = mb["chosen"], mb["m_gpu_bytes"]
    ok_mb = (mm.m_bound(mm.ALEXNET, chosen, hbm) >= 0
             > mm.m_bound(mm.ALEXNET, chosen + 1, hbm))
    # acceptance 2: the calibrated prediction beats the data sheet's
    r = t["replan"]
    ok_cal = bool(r["calibrated_closer"])

    spans = {name: session.last_tracer.total_s(name)
             for name in ("bench_kernels", "measure", "tune_overlap",
                          "replan")}
    card = smi() if dev.type == "cuda" else "cpu (no device numbers)"
    d["meta"]["bench"] = {"wall_s": wall, "spans_s": spans,
                          "peak_bytes": peak, "card": card,
                          "acceptance": {"m_bound_edge": ok_mb,
                                         "calibrated_closer": ok_cal}}
    if not lead:
        return d
    print(f"card: {card}")
    print(f"minibatch* (m_bound)      : {chosen} (the edge: {ok_mb}) "
          f"[bound at chosen {mb['m_bound_at_chosen'] / 2**20:.1f} MiB, at "
          f"next {mb['m_bound_at_next'] / 2**20:.1f} MiB]")
    print(f"microbatch* (train_memory): {mb['microbatch']['chosen']} "
          f"(plan's {mb['microbatch']['plan_microbatch']}, "
          f"{mb['microbatch']['attn_impl']}, remat "
          f"{mb['microbatch']['remat']})")
    for op, entry in t["kernels"].items():
        times = ", ".join(f"{n}={v * 1e3:.4f}ms"
                          for n, v in sorted(entry["times_s"].items(),
                                             key=lambda kv: kv[1]))
        print(f"{op:22s} -> {entry['chosen']:15s} ({times}); errors "
              f"{entry['errors'] or '{}'}")
    cal = t["calibration"]
    print(f"calibration [{cal['backend']}/{cal['cluster']}/{cal['arch']}]: "
          f"achieved {cal['achieved_flops']:.4e} FLOP/s "
          f"({r['flops_efficiency']:.4f} of the data sheet), matmul "
          f"{cal['matmul_flops']:.4e}, triad {cal['hbm_bw']:.4e} B/s, link "
          f"{cal['link_bw']:.4e} B/s, overlap {cal['overlap_fraction']:.4f} "
          f"at {cal['bucket_mb']:g} MiB")
    m = d["measured"]
    print(f"measured: best step {m.get('best_step_s', 0.0):.4f} s, best "
          f"compute {m.get('best_compute_s', 0.0):.4f} s, from_cache "
          f"{m.get('from_cache', False)}")
    print(f"executed step: measured {r['measured_step_s']:.4f} s | "
          f"calibrated {r['est_step_time_calibrated_s']:.4f} s | data sheet "
          f"{r['est_step_time_uncalibrated_s']:.4f} s -> calibrated closer: "
          f"{ok_cal}")
    prod = r["production"]
    print(f"production re-plan ({spec.shape} on {t['cluster']}): est "
          f"{prod['uncalibrated']['est_step_time']:.4f} s (data sheet) -> "
          f"{prod['calibrated']['est_step_time']:.4f} s (measured "
          f"constants), sync {prod['calibrated']['sync_schedule']}, "
          f"microbatch {prod['calibrated']['microbatch']}")
    print(f"spans (s) {json.dumps(spans)}; wall {wall:.1f} s; peak "
          + (f"{peak / 1e9:.2f} GB (max_memory_allocated)" if peak is not None
             else "not measured (cpu)"))
    return d


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced family member (a CPU rehearsal)")
    ap.add_argument("--batch", type=int, default=2,
                    help="global batch of the measured steps")
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--steps", type=int, default=3,
                    help="measured training steps")
    ap.add_argument("--dp", type=int, default=0,
                    help="data-parallel ranks: under torchrun one process "
                         "each; 0 = the single-device loop")
    ap.add_argument("--cache", default="results/calibration_cache.json",
                    help="calibration cache ('' = measure, keep nothing)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="results/torch_autotune.json")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.distributed.trainer import torchrun_env

    d = bench(args)
    acc = d["meta"]["bench"]["acceptance"]
    env = torchrun_env()
    if env is None or env.rank == 0:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(d, indent=2, default=str))
        print(f"wrote {out}")
        print(json.dumps({"acceptance": acc}))
    return 0 if all(acc.values()) else 1


def run(csv_rows, device="cuda", reduced=False):
    """Harness entry (``benchmarks/torch_run.py --only autotune``): one
    ``Session.tune()`` in this process on the visible card (the single-
    device loop; ``--reduced`` at seq 64 on the CPU), JAX's rows; a failed
    acceptance property raises."""
    print("\n== autotune: measured calibration + the paper's procedure ==")
    sys.path.insert(0, str(ROOT / "src"))
    d = bench(parse_args(["--device", device] + (
        ["--reduced", "--seq", "64"] if reduced else [])))
    acc = d["meta"]["bench"]["acceptance"]
    if not all(acc.values()):
        raise RuntimeError(f"torch_autotune: acceptance failed: {acc}")
    t = d["measured"]["tuning"]
    csv_rows.append(("autotune/minibatch_chosen",
                     t["minibatch"]["chosen"], "largest m_bound-feasible"))
    r_ = t["replan"]
    csv_rows.append(("autotune/abs_err_calibrated_s",
                     r_["abs_err_calibrated_s"],
                     f"datasheet={r_['abs_err_uncalibrated_s']:.4g}"))
    csv_rows.append(("autotune/flops_efficiency", r_["flops_efficiency"], ""))


if __name__ == "__main__":
    sys.exit(main())
