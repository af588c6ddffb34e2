"""Where a serving run of the PyTorch/CUDA port spends its time, on the card.

    PYTHONPATH=src python -m benchmarks.torch_serve_profile \\
        [--requests 8] [--n-new 32] [--s-max 512] [--max-batch 4] \\
        [--trace results/torch_serve_trace.json]

Runs ``Session.serve()`` of full-width granite-3-2b three times: to warm up
(cuBLAS heuristics, kernel builds), to measure, and under ``torch.profiler``
with CPU and CUDA activities.  Prints the top operators by device time and
by host time and one JSON summary line: the measured run's wall clock,
tokens/s and p50 step times, and the profiled run's device busy time (the
sum of the device-side rows: kernels, copies) with the idle share it leaves
of the measured wall clock.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.api import JobSpec, Session


def _device_us(evt) -> float:
    """An event's own time on the device [us], across torch versions."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--n-new", type=int, default=32)
    ap.add_argument("--s-max", type=int, default=512)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--trace", default="",
                    help="write the Chrome trace of the profiled run here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_serve_profile: needs a CUDA device")

    spec = JobSpec(arch="granite-3-2b", reduced=False, requests=args.requests,
                   n_new=args.n_new, s_max=args.s_max,
                   max_batch=args.max_batch)
    Session(spec, device="cuda").serve()  # warm-up
    plain = Session(spec, device="cuda").serve().measured  # unprofiled
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rep = Session(spec, device="cuda").serve()
        torch.cuda.synchronize()
    m = rep.measured
    events = prof.key_averages()
    # device busy time: the device-side rows only (kernels, copies, sets);
    # the operator rows that launched them repeat the same time
    busy_us = sum(_device_us(e) for e in events
                  if e.device_type == DeviceType.CUDA)
    wall_s = m["wall_s"]
    steps = m["serving"]["throughput"]["engine_steps"]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi)
    print(events.table(sort_by="self_cuda_time_total", row_limit=15))
    print(events.table(sort_by="self_cpu_time_total", row_limit=15))
    # The profiler slows the host, so the idle share is taken against the
    # unprofiled run's wall clock.  The profile also holds the session's
    # weight initialisation (a few ms of device time), so busy time
    # slightly overstates the serve's.
    summary = {
        "device": torch.cuda.get_device_name(0),
        "gpu": smi,
        "wall_s": plain["wall_s"],
        "tokens_per_s": plain["tokens_per_s"],
        "decode_step_p50_s":
            plain["metrics"]["histograms"]["serve/decode_s"]["p50"],
        "prefill_p50_s":
            plain["metrics"]["histograms"]["serve/prefill_s"]["p50"],
        "engine_steps": steps,
        "profiled_wall_s": wall_s,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / plain["wall_s"],
        "kernel_launches": int(sum(e.count for e in events
                                   if e.key in ("cudaLaunchKernel",
                                                "cuLaunchKernel",
                                                "cuLaunchKernelEx",
                                                "cudaLaunchKernelExC"))),
    }
    # the port's own kernels, by device time per launch
    summary["port_kernels"] = {
        m.group(0): {"launches": int(e.count),
                     "device_us_per_launch": _device_us(e) / max(e.count, 1)}
        for e in events if e.device_type == DeviceType.CUDA
        for m in [re.search(r"(flash|decode)_kernel<[^>]*>", e.key)] if m}
    print(json.dumps(summary))
    if args.trace:
        prof.export_chrome_trace(args.trace)
        print(f"wrote {args.trace}")


if __name__ == "__main__":
    main()
