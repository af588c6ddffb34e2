"""The port's telemetry cell (the twin of ``benchmarks/telemetry.py``): the
tracing and metrics layer exercised end to end, feeding
``BENCH_torch_train.json``.

    PYTHONPATH=src python -m benchmarks.torch_telemetry [--devices N] \\
        [--device cuda] [--no-bench-append]
    # a CPU rehearsal: the reduced config, 2 threaded gloo ranks
    PYTHONPATH=src python -m benchmarks.torch_telemetry --device cpu \\
        --reduced --quick --no-bench-append

Runs one traced, overlapped data-parallel ``Session.train()`` (granite-3-2b
at full width, ``--reduced`` for the CPU; ``sync="auto"``,
``sync_overlap``, ``--bucket-mb`` buckets; batch 8 x seq 64, 8 steps as
JAX's defaults) and one traced static ``Session.serve()`` (``max_batch``
2, ``shape="decode_32k"``, 4 requests, ``n_new`` 4, ``s_max`` 64), then
holds them to JAX's reconciliations.  On the card an untimed
run of ``WARMUP_STEPS`` of the same training spec goes first, so the
timed run's tokens/s holds no first-call costs of the process (CUDA
context, cuBLAS handles, the caching allocator's first growth):

1. the ``bucket_sync`` spans of the last calibration step equal
   ``SyncReport.per_bucket_comm_s`` within 5% (the same clock: this
   guards the plumbing, not the noise);
2. the trace file holds ``compute``, ``bucket_sync``, ``fused_step`` and
   ``step`` spans;
3. the sorted ``prefill`` spans equal the sorted ``batches[*].prefill_s``;
4. both Reports pass ``validate_report`` and their metrics sections
   ``validate_metrics``.

``--devices`` ranks need as many cards (the default takes every visible
card, up to JAX's 4); on the CPU they are threaded gloo ranks.  At one
rank the trainer still buckets and times each bucket's sync, but the
group has one member, so no byte crosses a link: the run says so, and
its overlap fraction says nothing about a link.  Then it appends one
record to ``BENCH_torch_train.json`` (under ``--bench-root``) through
``tools/torch_bench_trajectory.py``, the card's name and power limit in
its note, and compares it with the record before (warn only).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

SPANS = ("compute", "bucket_sync", "fused_step", "step")
WARMUP_STEPS = 3  # two calibration steps and one fused step


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--devices", type=int, default=0,
                    help="data-parallel ranks (default: every visible card "
                         "up to 4; 4 on the CPU)")
    ap.add_argument("--bucket-mb", type=float, default=0.5)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--n-new", type=int, default=4)
    ap.add_argument("--s-max", type=int, default=64)
    ap.add_argument("--outdir", default="results")
    ap.add_argument("--quick", action="store_true",
                    help="2 ranks, few steps, tiny shapes")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config (a CPU rehearsal)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-bench-append", dest="bench_append",
                    action="store_false", default=True,
                    help="skip appending to BENCH_torch_train.json")
    ap.add_argument("--bench-root", default=str(ROOT),
                    help="directory of BENCH_torch_train.json")
    ap.add_argument("--sha", default="",
                    help="the record's commit (default: read from .git)")
    args = ap.parse_args(argv)
    if args.quick:
        args.devices, args.steps, args.batch, args.seq = 2, 6, 4, 32
        args.requests, args.n_new = 3, 3
    if not args.devices:
        if args.device == "cuda":
            import torch

            args.devices = max(min(4, torch.cuda.device_count()), 1)
        else:
            args.devices = 4
    return args


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"torch_telemetry: {msg}")


def measure(args) -> Dict[str, Any]:
    """Both traced runs and their reconciliations (each raises when it
    fails); returns ``{"train": Report, "serve": Report, "card": str,
    "train_report": path, "serve_report": path}``."""
    from repro_torch.api import JobSpec, Session, validate_report
    from repro_torch.obs import validate_metrics

    card = smi() if args.device == "cuda" else "cpu (no device numbers)"
    if args.device == "cuda":
        from repro_torch.kernels import _build

        _build.build()  # nvcc runs here, outside the serve's wall
    outdir = Path(args.outdir)
    trace_dir = str(outdir / "traces")

    # -- overlapped train ---------------------------------------------------
    spec = JobSpec(arch=args.arch, reduced=args.reduced, steps=args.steps,
                   batch=args.batch, seq=args.seq, dp=args.devices,
                   sync="auto", sync_overlap=True, bucket_mb=args.bucket_mb,
                   log_every=0, trace_dir=trace_dir)
    if args.device == "cuda":
        import gc

        import torch

        Session(spec.replace(steps=WARMUP_STEPS, trace_dir=""),
                device=args.device).train()
        gc.collect()
        torch.cuda.empty_cache()
    sess = Session(spec, device=args.device)
    rep = sess.train()
    validate_report(rep.to_dict())
    validate_metrics(rep.measured["metrics"])
    sync = rep.measured["sync"]
    per_bucket = sync["per_bucket_comm_s"] or []
    _require(len(per_bucket) == sync["n_buckets"] > 0,
             f"{sync['n_buckets']} buckets but per_bucket_comm_s "
             f"{per_bucket}")
    spans = [e.dur_s for e in sess.last_tracer.events("bucket_sync")
             ][-len(per_bucket):]
    worst = 0.0
    for k, (a, b) in enumerate(zip(spans, per_bucket)):
        err = abs(a - b) / max(b, 1e-12)
        worst = max(worst, err)
        _require(err < 0.05, f"bucket {k}: span {a:.6f} s vs SyncReport "
                             f"{b:.6f} s ({err:.1%})")
    trace_file = rep.meta["trace_file"]
    names = {e.get("name") for e in
             json.loads(Path(trace_file).read_text())["traceEvents"]}
    missing = [n for n in SPANS if n not in names]
    _require(not missing, f"trace missing {missing} spans: {sorted(names)}")
    train_path = outdir / "torch_telemetry_train_report.json"
    rep.save(train_path)
    link = ("" if args.devices > 1 else
            "; one rank: the bucket syncs cross no link, so the overlap "
            "fraction says nothing about one")
    print(f"train: dp {args.devices}, {sync['strategy']}, overlap "
          f"{sync['overlap_fraction']:.0%} across {sync['n_buckets']} "
          f"buckets, bucket_sync spans within {worst:.2%} of "
          f"per_bucket_comm_s; {rep.measured['tokens_per_s']:.1f} tok/s; "
          f"trace {trace_file} ({rep.meta['trace_events']} events), report "
          f"{train_path}{link} ({card})", flush=True)

    # -- serve (static: its batch spans are what GenResult.stats() reports;
    # the continuous runtime has its own cell, torch_serve_continuous) ------
    sspec = JobSpec(arch=args.arch, reduced=args.reduced, shape="decode_32k",
                    requests=args.requests, n_new=args.n_new,
                    s_max=args.s_max, max_batch=2, serve_mode="static",
                    trace_dir=trace_dir)
    ssess = Session(sspec, device=args.device)
    srep = ssess.serve()
    validate_report(srep.to_dict())
    validate_metrics(srep.measured["metrics"])
    prefill_spans = sorted(e.dur_s
                           for e in ssess.last_tracer.events("prefill"))
    prefill_stats = sorted(b["prefill_s"] for b in srep.measured["batches"])
    _require(prefill_spans == prefill_stats,
             f"prefill spans {prefill_spans} != GenResult stats "
             f"{prefill_stats}")
    serve_path = outdir / "torch_telemetry_serve_report.json"
    srep.save(serve_path)
    print(f"serve: {srep.measured['n_tokens']} tokens at "
          f"{srep.measured['tokens_per_s']:.1f} tok/s, {len(prefill_spans)} "
          f"prefill spans equal to the batches' prefill_s, trace "
          f"{srep.meta['trace_file']}, report {serve_path} ({card})",
          flush=True)
    return {"train": rep, "serve": srep, "card": card,
            "train_report": train_path, "serve_report": serve_path}


def append(args, out) -> None:
    """One train record into ``--bench-root``'s BENCH_torch_train.json,
    then the comparison with the record before it (warn only)."""
    sys.path.insert(0, str(ROOT / "tools"))
    import torch_bench_trajectory as traj

    root = Path(args.bench_root)
    sync = out["train"].measured["sync"]
    rec = traj.append_record(
        "train", out["train_report"], root=root, sha=args.sha or None,
        note=(f"{out['card']}; torch_telemetry dp {args.devices}, "
              f"{sync['n_buckets']} buckets"
              + (", one rank: no link" if args.devices == 1 else "")))
    print(f"BENCH_torch_train: appended {rec['sha']} "
          f"{json.dumps(rec['metrics'])}")
    for r in traj.compare("train", root=root):
        print("WARN " + r, file=sys.stderr)


def main(argv=None) -> Dict[str, Any]:
    args = parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("torch_telemetry: --device cuda but no card is "
                             "visible; pass --device cpu --reduced")
    out = measure(args)
    if args.bench_append:
        append(args, out)
    return out


def run(csv_rows, device="cuda", reduced=False):
    """Harness entry (``benchmarks/torch_run.py --only telemetry``): the
    cell in this process, no record appended (records come from the
    cell's own command line)."""
    print("\n== telemetry: traced overlapped train + serve ==")
    out = main(["--no-bench-append", "--device", device]
               + (["--reduced"] if reduced else []))
    sync = out["train"].measured["sync"]
    csv_rows.append(("telemetry/overlap_fraction", sync["overlap_fraction"],
                     f"{sync['n_buckets']} buckets"))
    csv_rows.append(("telemetry/tokens_per_s",
                     out["train"].measured["tokens_per_s"], "train"))
    srep = out["serve"].measured
    csv_rows.append(("telemetry/serve_decode_p99_s",
                     srep["metrics"]["histograms"]["serve/decode_s"]["p99"],
                     f"{srep['tokens_per_s']:.1f} tok/s"))


if __name__ == "__main__":
    main()
