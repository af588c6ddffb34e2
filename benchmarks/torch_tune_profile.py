"""Where the kernel-choice stage of the PyTorch/CUDA port spends its time,
on the card.

    PYTHONPATH=src python -m benchmarks.torch_tune_profile \\
        [--seq 128] [--repeats 2] [--trace results/torch_tune_trace.json]

Runs ``bench_kernels`` (``repro_torch.core.autotune``: every variant of
every op in ``kernels/ops.py::TUNABLE_OPS``) three times: to warm up (kernel
builds, cuBLAS heuristics), to measure, and under ``torch.profiler`` with
CPU and CUDA activities.  Prints the top operators by device time and one
JSON summary line: the measured run's wall clock and choices, the profiled
run's device busy time with the idle share it leaves of the measured wall
clock, and the port's kernels by device time per launch.
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

from repro_torch.core.autotune import bench_kernels
from repro_torch.obs.trace import monotonic


def _device_us(evt) -> float:
    """An event's own time on the device [us], across torch versions."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--trace", default="",
                    help="write the Chrome trace of the profiled run here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_tune_profile: needs a CUDA device")

    def run():
        return bench_kernels(seq=args.seq, repeats=args.repeats)

    run()  # warm-up
    torch.cuda.synchronize()
    t0 = monotonic()
    res = run()
    torch.cuda.synchronize()
    wall_s = monotonic() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    busy_us = sum(_device_us(e) for e in events
                  if e.device_type == DeviceType.CUDA)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi)
    print(events.table(sort_by="self_cuda_time_total", row_limit=20))
    summary = {
        "device": torch.cuda.get_device_name(0),
        "gpu": smi,
        "seq": args.seq,
        "repeats": args.repeats,
        "wall_s": wall_s,
        "chosen": {op: e["chosen"] for op, e in res.items()},
        "times_s": {op: e["times_s"] for op, e in res.items()},
        "errors": {op: e["errors"] for op, e in res.items() if e["errors"]},
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
        # the port's own kernels, by device time per launch
        "port_kernels": {
            m.group(0): {"launches": int(e.count),
                         "device_us_per_launch":
                             _device_us(e) / max(e.count, 1)}
            for e in events if e.device_type == DeviceType.CUDA
            for m in [re.search(r"(flash|decode|decode_combine)_kernel<[^>]*>|"
                                r"(chunk|output)_pass<[^>]*>|state_pass",
                                e.key)]
            if m},
    }
    print(json.dumps(summary))
    if args.trace:
        prof.export_chrome_trace(args.trace)
        print(f"wrote {args.trace}")


if __name__ == "__main__":
    main()
