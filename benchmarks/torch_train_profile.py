"""Where a training step of the PyTorch/CUDA port spends its time, on the card.

    PYTHONPATH=src python -m benchmarks.torch_train_profile \\
        [--layers 40] [--batch 4] [--seq 512] [--steps 3] \\
        [--trace results/torch_train_trace.json]

Full-width granite-3-2b (random weights from seed 0, fp32 masters on the
card) with the session's run configuration (``attn_impl="auto"``,
``remat="block"``, AdamW).  After two warm-up steps it times ``--steps``
steps split into their two parts, each ended by a device synchronize: the
gradients (forward, block recompute, backward: ``launch.steps.
build_grad_fn``) and the AdamW update (``optim.adamw.apply_updates``).
Then one more step runs under ``torch.profiler`` (CPU and CUDA
activities).  Prints the top operators by device time and by host time
and one JSON summary line: the parts' wall times, the step's bounds (the
FLOPs of 6·N·tokens plus the recompute's 2·N·tokens at 989 TFLOP/s bf16;
AdamW's bytes at 3.35 TB/s), the profiled step's device busy time and the
idle share it leaves of the unprofiled step, the kernel launches, and the
peak memory.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import PrefetchLoader
from repro_torch.launch.steps import build_grad_fn
from repro_torch.models import model as M
from repro_torch.models.blocks import RunConfig
from repro_torch.models.common import materialize, param_count
from repro_torch.optim.adamw import OptConfig, apply_updates, init_state

H100_BF16_FLOPS = 989e12  # H100 SXM data sheet, dense bf16
H100_HBM_BPS = 3.35e12    # H100 SXM data sheet
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx",
            "cudaLaunchKernelExC")


def _device_us(evt) -> float:
    """An event's own time on the device [us], across torch versions."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=40)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--trace", default="",
                    help="write the Chrome trace of the profiled step here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_train_profile: needs a CUDA device")

    cfg = get_config("granite-3-2b").replace(num_layers=args.layers)
    run = RunConfig(attn_impl="auto", remat="block")
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=100)
    params = materialize(M.model_specs(cfg), 0, "cuda")
    state = init_state(opt, params)
    grads_of = build_grad_fn(cfg, run)
    loader = PrefetchLoader(cfg, args.batch, args.seq, device="cuda")

    def step():
        nonlocal params, state
        batch, _ = next(loader)
        t0 = time.perf_counter()
        _, _, grads = grads_of(params, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, state, _ = apply_updates(opt, params, grads, state)
        del grads
        torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t1

    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):  # warm-up: cuBLAS handles and heuristics, allocator
        step()
    parts = [step() for _ in range(args.steps)]
    grad_s = min(p[0] for p in parts)
    update_s = min(p[1] for p in parts)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
    loader.close()
    events = prof.key_averages()
    busy_us = sum(_device_us(e) for e in events
                  if e.device_type == DeviceType.CUDA)
    n = param_count(M.model_specs(cfg))
    tokens = args.batch * args.seq
    flops = 8.0 * n * tokens  # 6·N·T plus the block recompute's 2·N·T
    adam_bytes = 28.0 * n      # p, g, m, v read; p, m, v written (fp32)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi)
    print(events.table(sort_by="self_cuda_time_total", row_limit=20))
    print(events.table(sort_by="self_cpu_time_total", row_limit=15))
    step_s = grad_s + update_s
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "gpu": smi,
        "layers": args.layers, "params": n, "tokens_per_step": tokens,
        "grad_s": grad_s, "update_s": update_s, "step_s": step_s,
        "tokens_per_s": tokens / step_s,
        "flops_per_step": flops,
        "grad_bound_s": flops / H100_BF16_FLOPS,
        "update_bound_s": adam_bytes / H100_HBM_BPS,
        "profiled_device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / step_s,
        "kernel_launches": int(sum(e.count for e in events
                                   if e.key in LAUNCHES)),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
    }))
    if args.trace:
        prof.export_chrome_trace(args.trace)
        print(f"wrote {args.trace}")


if __name__ == "__main__":
    main()
