"""Serving launcher of the port — a thin CLI over ``repro_torch.api``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
        [--continuous | --static] [--requests 6] [--n-new 16] \\
        [--s-max 256] [--kv-block 16] [--max-kv-blocks 0] \\
        [--prefill-chunk 0] [--arrival-trace poisson:0.5] [--slo-ms 0] \\
        [--report-out PATH] [--reduced | --no-reduced] [--device cuda]

The flags are those of ``repro.launch.serve`` plus ``--reduced/
--no-reduced`` (default reduced, as the JAX launcher hard-codes) and
``--device`` (default ``cuda``; ``cuda`` without a card raises).  It prints
the same JSON summary line, without ``replicas_predicted`` (the replica
lemma's prediction is not ported yet).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.api import JobSpec, Session


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--n-new", type=int, default=16)
    ap.add_argument("--s-max", type=int, default=256)
    ap.add_argument("--max-batch", type=int, default=4)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--continuous", dest="mode", action="store_const",
                      const="continuous", default="continuous",
                      help="in-flight batching over the paged KV cache "
                           "(default)")
    mode.add_argument("--static", dest="mode", action="store_const",
                      const="static",
                      help="FIFO BatchScheduler with a linear cache")
    ap.add_argument("--kv-block", type=int, default=16,
                    help="paged-KV block size [tokens]")
    ap.add_argument("--max-kv-blocks", type=int, default=0,
                    help="KV pool cap; 0 = the run's working set")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill size (0 = whole-prompt); "
                         "attention-only stacks, else whole-prompt")
    ap.add_argument("--arrival-trace", default="",
                    help="arrival spec: '' | poisson:RATE | burst:NxGAP")
    ap.add_argument("--slo-ms", type=float, default=0.0,
                    help="latency SLO; 0 = 2x the measured mean")
    ap.add_argument("--report-out", default="",
                    help="write the report JSON here")
    ap.add_argument("--trace-dir", default="",
                    help="write a Chrome-trace JSON of the run here")
    ap.add_argument("--metrics-json", default="",
                    help="write the run's metrics/v1 section to this path")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the reduced family member (default) or the "
                         "full-width config (--no-reduced)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()

    spec = JobSpec(arch=args.arch, reduced=args.reduced, shape="decode_32k",
                   requests=args.requests, n_new=args.n_new,
                   s_max=args.s_max, max_batch=args.max_batch,
                   serve_mode=args.mode, kv_block=args.kv_block,
                   max_kv_blocks=args.max_kv_blocks,
                   prefill_chunk=args.prefill_chunk,
                   arrival=args.arrival_trace, slo_ms=args.slo_ms,
                   trace_dir=args.trace_dir)
    rep = Session(spec, device=args.device).serve()
    m = rep.measured
    for r in m["per_request"]:
        print(f"req {r['rid']}: {r['tokens']} tokens, head={r['head']}")
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
    hists = m["metrics"]["histograms"]
    sv = m["serving"]
    summary = {
        "kind": "serve",
        "mode": sv["mode"],
        "requests": m["requests"],
        "n_tokens": m["n_tokens"],
        "wall_s": m["wall_s"],
        "tokens_per_s": m["tokens_per_s"],
        "decode_p99_s": hists.get("serve/decode_s", {}).get("p99", 0.0),
        "prefill_p99_s": hists.get("serve/prefill_s", {}).get("p99", 0.0),
        "latency_p99_s": sv["latency_s"]["p99"],
        "queue_depth_p99": hists.get("serve/queue_depth", {}).get("p99", 0.0),
        "wasted_decode_steps": sv["throughput"]["wasted_decode_steps"],
        "kv_peak_occupancy": sv["kv_cache"]["peak_occupancy"],
        "slo_s": sv["slo"]["slo_s"],
        "slo_attained": sv["slo"]["attained"],
    }
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
