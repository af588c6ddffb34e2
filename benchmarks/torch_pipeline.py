"""1F1B pipeline parallelism on the cards: each stage on a card of its own,
one process driving every stage (``repro_torch.distributed.pipeline``).

    PYTHONPATH=src python benchmarks/torch_pipeline.py \\
        [--pipes 2,4] [--steps 5] [--seq 512] \\
        [--out results/torch_pipeline.jsonl]
    # a CPU rehearsal: every stage on the CPU, the reduced config
    PYTHONPATH=src python benchmarks/torch_pipeline.py --device cpu \\
        --reduced --pipes 2 --seq 64 --steps 3

For each P in ``--pipes`` that the machine has cards for (P cards, stage
s on ``cuda:s``; with ``--share`` every stage on ``cuda:0`` instead) and
each m in {P, 2P} microbatches: granite-3-2b at full width (all 40
layers; with ``--reduced`` the reduced config at two cycles a stage),
random weights from seed 0, ``auto`` attention with block remat, AdamW, 512-token rows, max(4, m)
rows a step (4 x 512 tokens where m <= 4; one row a microbatch at m = 8),
``--steps`` steps, the first two left out as warm-up.  One JSON line per
cell: each stage's fwd and bwd time per microbatch (best of the steady
steps), the measured bubble (those times replayed through the 1F1B DAG)
against the model (p-1)/(m+p-1) and the serial schedule, the makespan,
the copy of one microbatch's activations (rows, seq, d_model) in bf16
from a stage's card to the next (CUDA events, the median of 20), the
steady step wall and its phases, tokens/s over the steady steps and over
the run, peak memory per card (``max_memory_allocated``; the reserved
peak and the allocator's retries beside it), and the card's name and
power limit.  ``--profile`` adds one more step under ``torch.profiler``:
its wall, each card's kernel time, the idle share that leaves of the
profiled and of the steady unprofiled step, the kernel launches and the
top kernels.  With one shard a stage no gradient sync runs.  A P with
fewer cards than stages gets a line with ``"measured": false``.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def copy_ms(src: torch.device, dst: torch.device, shape) -> float:
    """Median of 20 copies of a bf16 tensor of ``shape`` from ``src`` to
    ``dst`` (CUDA events on the source card's stream)."""
    x = torch.randn(shape, device=src).to(torch.bfloat16)
    x.to(dst)
    times = []
    for _ in range(20):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        x.to(dst)
        b.record()
        torch.cuda.synchronize(src)
        torch.cuda.synchronize(dst)
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def profile_step(tr, cfg, batch: int, seq: int) -> dict:
    """One more step under ``torch.profiler``: its wall, each card's kernel
    time (busy) and the idle share that leaves, and the kernel launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import PrefetchLoader

    loader = PrefetchLoader(cfg, batch, seq, device=tr.devices[0], seed=1)
    b, _ = next(loader)
    loader.close()
    step = tr.step_fn()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(tr.params, tr.opt_state, b)
        wall = time.perf_counter() - t0
    busy: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = f"cuda:{e.device_index}"
            busy[key] = busy.get(key, 0.0) + e.self_device_time_total / 1e6
    launches = sum(e.count for e in prof.key_averages()
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cuLaunchKernelEx", "cudaLaunchKernelExC"))
    top = sorted(((e.key, e.self_device_time_total / 1e3)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall * 1e3,
            "busy_ms": {k: v * 1e3 for k, v in busy.items()},
            "idle_share": {k: 1.0 - v / wall for k, v in busy.items()},
            "kernel_launches": int(launches),
            "top_kernels_ms": top}


def cell(args, cfg, P: int, m: int, devices, smi_line: str) -> dict:
    from repro_torch.distributed.pipeline import PipelineTrainer
    from repro_torch.models.blocks import RunConfig
    from repro_torch.optim.adamw import OptConfig

    batch = max(4, m)
    cards = sorted({d for d in devices if d.type == "cuda"},
                   key=lambda d: d.index)
    for d in cards:
        torch.cuda.synchronize(d)  # initializes the card's allocator
        torch.cuda.reset_peak_memory_stats(d)
    tr = PipelineTrainer(
        cfg, RunConfig(attn_impl="auto", remat="block"),
        OptConfig(lr=1e-3, warmup_steps=1, total_steps=args.steps + 1),
        pipe=P, n_microbatch=m, devices=devices)
    prof = None
    try:
        res = tr.train(batch=batch, seq=args.seq, steps=args.steps,
                       log_every=0)
        pr = tr.pipeline_report().as_dict()
        if args.profile:
            prof = profile_step(tr, cfg, batch, args.seq)
    finally:
        tr.close()
    steady = res.step_times[2:] or res.step_times
    step = float(np.mean([t.compute + t.dist_update + t.param_update
                          for t in steady]))
    if prof is not None:  # the profiler inflates its own step's wall
        prof["idle_share_of_steady_step"] = {
            k: 1.0 - v / 1e3 / step for k, v in prof["busy_ms"].items()}
    rows = batch // m
    copies = None
    if len(cards) > 1:
        copies = [copy_ms(devices[s], devices[s + 1],
                          (rows, args.seq, cfg.d_model))
                  for s in range(P - 1)]
    out = {
        "cell": f"pipe{P}_m{m}", "measured": True, "pipe": P,
        "n_microbatch": m, "layers": cfg.num_layers,
        "stage_cut": pr["stage_cut"], "batch": batch, "seq": args.seq,
        "devices": [str(d) for d in devices],
        "fwd_ms": [[t * 1e3 for t in row] for row in pr["fwd_times_s"]],
        "bwd_ms": [[t * 1e3 for t in row] for row in pr["bwd_times_s"]],
        "bubble_measured": pr["bubble_measured"],
        "bubble_model": pr["bubble_model"],
        "bubble_serial": pr["bubble_serial"],
        "makespan_ms": pr["makespan_s"] * 1e3,
        "activation_copy_ms": copies,
        "step_ms": step * 1e3,
        "step_phases_ms": {k: float(np.mean([getattr(t, k) for t in steady]))
                           * 1e3 for k in ("param_refresh", "compute",
                                           "dist_update", "param_update")},
        "tokens_per_s_steady": batch * args.seq / step,
        "tokens_per_s_run": res.tokens_per_s,
        "losses": res.losses,
        "peak_gb": {str(d): torch.cuda.max_memory_allocated(d) / 1e9
                    for d in cards},
        "reserved_peak_gb": {str(d): torch.cuda.max_memory_reserved(d) / 1e9
                             for d in cards},
        "alloc_retries": {str(d): torch.cuda.memory_stats(d).get(
            "num_alloc_retries", 0) for d in cards},
        "profiled_step": prof,
        "card": smi_line,
    }
    del tr
    gc.collect()
    if cards:
        torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pipes", default="2,4")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--share", action="store_true",
                    help="every stage on cuda:0")
    ap.add_argument("--profile", action="store_true",
                    help="profile one more step (torch.profiler)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="results/torch_pipeline.jsonl")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.base import get_config
    from repro_torch.models.common import resolve_device

    if resolve_device(args.device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    pipes = [int(x) for x in args.pipes.split(",")]
    cfg = get_config("granite-3-2b")
    if args.reduced:  # two cycles a stage, as Session deepens it
        cfg = cfg.reduced()
        cfg = cfg.replace(num_layers=2 * max(pipes) * len(cfg.pattern))
    on_cpu = resolve_device(args.device).type == "cpu"
    smi_line = "cpu" if on_cpu else smi()
    n_cards = 0 if on_cpu else torch.cuda.device_count()
    print(f"card: {smi_line}; {n_cards} cards", flush=True)
    lines = []
    for P in pipes:
        for m in (P, 2 * P):
            if on_cpu:
                devices = [torch.device("cpu")] * P
            elif args.share:
                devices = [torch.device("cuda", 0)] * P
            elif n_cards >= P:
                devices = [torch.device("cuda", s) for s in range(P)]
            else:
                line = {"cell": f"pipe{P}_m{m}", "measured": False,
                        "pipe": P, "n_microbatch": m,
                        "why": f"{P} stages need {P} cards; {n_cards} here",
                        "card": smi_line}
                print(json.dumps(line), flush=True)
                lines.append(line)
                continue
            line = cell(args, cfg, P, m, devices, smi_line)
            print(json.dumps(line), flush=True)
            lines.append(line)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("".join(json.dumps(x) + "\n" for x in lines))
    print(f"wrote {out}", flush=True)


if __name__ == "__main__":
    main()
