"""The planner's own shape on one card: full-width granite-3-2b trained
with the knobs the plan picks, against the plan's estimates.

    PYTHONPATH=src python benchmarks/torch_plan_check.py [--steps 2] \\
        [--out results/torch_plan_check.json]
    # a CPU rehearsal at the reduced config and a small batch
    PYTHONPATH=src python benchmarks/torch_plan_check.py --device cpu \\
        --reduced --batch 4 --seq 64

``Session.plan()`` prices the full model for the ``train_4k`` shape on
mesh ``single``, one 8 x H100 node (``h100-8``).  There it picks a
microbatch of 1 (of 4096 tokens), an attention algorithm and a remat,
and estimates the step (``est_step_time``, for a
card's share of the global batch: 256 / 8 = 32 rows of 4096) and the
memory a card holds (``est_memory_gb``, with the optimizer state sharded
over the 8 data-parallel ranks, as the JAX package's GSPMD trainer keeps
it; the port's trainer replicates it).  This script runs one card's share
of that step, ``--steps`` times, through the training loop with the run
configuration ``Session.build_run_opt()`` gives under ``use_planner``, in
three configurations:

1. ``plan``         — the plan's attention and remat as they are;
2. ``dense+block``  — the plan's attention with ``remat="block"``;
3. ``chunked+block``— ``chunked`` attention with ``remat="block"``.

For each it records the steady step (the last step's compute + update,
the loop's ``StepTimes``), tokens/s, and ``max_memory_allocated()``, or
the out-of-memory error if the configuration does not fit.  It prints
one JSON line per configuration and a summary line (also written to
``--out``) with the plan, its estimates, the port's resident bytes (fp32
params, grads and AdamW's two moments on every card: 16 bytes a
parameter) and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
# the plan this script checks: train_4k on one 8 x H100 node (h100-8)
MESH = "single"
SHAPE = "train_4k"


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def run_config(cfg, run, opt, *, batch, seq, steps, device, label):
    """One configuration: the loop for ``steps`` steps from seed 0, or the
    out-of-memory error it raised."""
    from repro_torch.train.loop import train

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    line = {"config": label, "attn_impl": run.attn_impl, "remat": run.remat,
            "microbatch": run.microbatch, "batch": batch, "seq": seq,
            "steps": steps}
    t0 = time.perf_counter()
    try:
        res = train(cfg, run, opt, batch=batch, seq=seq, steps=steps, seed=0,
                    device=device, log_every=1)
    except torch.cuda.OutOfMemoryError as e:
        line["oom"] = str(e).splitlines()[0]
        res = None
    if dev.type == "cuda":
        torch.cuda.synchronize()
        line["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    line["wall_s"] = time.perf_counter() - t0
    if res is not None:
        steps_s = [t.compute + t.dist_update + t.param_update
                   for t in res.step_times]
        line.update(losses=res.losses, step_s=steps_s,
                    steady_step_s=steps_s[-1],
                    tokens_per_s=batch * seq / steps_s[-1])
    del res
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return line


def main() -> None:
    from repro_torch.api import JobSpec, Session
    from repro_torch.core import memory_model as mm

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--batch", type=int, default=0,
                    help="rows a step (0: the plan's, global batch / dp)")
    ap.add_argument("--seq", type=int, default=0,
                    help="tokens a row (0: the shape's)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="run the reduced config (a CPU rehearsal); the "
                         "plan is still the full model's")
    ap.add_argument("--out", default="results/torch_plan_check.json")
    args = ap.parse_args()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("torch_plan_check: needs a CUDA device")
        card = smi()
        print(card, flush=True)
    else:
        card = "cpu"
    probe = Session(JobSpec(arch="granite-3-2b", reduced=False,
                            shape=SHAPE, mesh=MESH),
                    device=args.device)
    plan = probe.resolved_plan
    batch = args.batch or max(probe.shape.global_batch // plan.mesh[0], 1)
    seq = args.seq or probe.shape.seq_len
    session = Session(JobSpec(arch="granite-3-2b", reduced=args.reduced,
                              shape=SHAPE, mesh=MESH,
                              use_planner=True, steps=args.steps,
                              batch=batch, seq=seq), device=args.device)
    run, opt = session.build_run_opt()
    dry = session.dryrun().predicted
    n = mm.n_params(session.cfg)
    head = {
        "plan": {k: getattr(plan, k) for k in (
            "arch", "shape", "mesh", "microbatch", "attn_impl", "remat",
            "opt_kind", "sync_schedule", "est_step_time", "est_memory_gb",
            "fits")},
        "cluster": plan.topology["name"], "chip": plan.topology["chip"],
        "step_time_terms": dry["step_time_terms"],
        "plan_memory_bytes": dry["memory_bytes"],
        "executed": {"name": session.cfg.name,
                     "num_layers": session.cfg.num_layers, "n_params": n},
        "port_resident_gb": 16 * n / 1e9,
        "card": card,
    }
    print(json.dumps(head), flush=True)
    lines = []
    for label, r in (
            ("plan", run),
            ("dense+block", dataclasses.replace(run, remat="block")),
            ("chunked+block", dataclasses.replace(run, attn_impl="chunked",
                                                  remat="block"))):
        line = run_config(session.cfg, r, opt, batch=batch, seq=seq,
                          steps=args.steps, device=args.device, label=label)
        line["card"] = card
        print(json.dumps(line), flush=True)
        lines.append(line)
    head["runs"] = lines
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(head) + "\n")
    print(f"wrote {out}", flush=True)


if __name__ == "__main__":
    main()
