"""The SSD scan kernels against the model's own chunked scan, on the card.

    python benchmarks/torch_ssd_vs_chunked.py [--src DIR] [--iters 20]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``),
so that two trees can be compared on one card by running this once per
tree (parent, change, change, parent).  At mamba2-780m width (B 1, L 2048,
H 48, P 64, N 128, chunk 256), on bf16 inputs from seed 0 in model layout,
it times ``kernels.ssd_scan.ssd_scan`` (what ``ssm_forward(impl="kernel")``
runs) and ``models.ssm.ssd_chunked`` in bf16 (what ``impl="auto"`` runs),
then one full mamba2-780m mixer layer (random weights from seed 0, x (1,
2048, 1536) bf16) with each impl.  Device time: every kernel a call
launches, summed from torch.profiler over ``--iters`` calls; event time:
CUDA events around ``--iters`` calls (it holds the host's cost).  Prints
one line per case, then one JSON line.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ssd_scan as ssd_k
    from repro_torch.models import ssm
    from repro_torch.models.common import materialize

    if not torch.cuda.is_available():
        raise SystemExit("torch_ssd_vs_chunked: needs a CUDA device")

    def times(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
        return {"ms": start.elapsed_time(end) / args.iters,
                "device_ms": us / args.iters / 1e3}

    g = torch.Generator(device="cuda").manual_seed(0)
    B, L, H, P, N, chunk = 1, 2048, 48, 64, 128, 256
    x = torch.randn(B, L, H, P, generator=g, device="cuda").to(torch.bfloat16)
    dt = torch.nn.functional.softplus(
        torch.randn(B, L, H, generator=g, device="cuda")).to(torch.bfloat16)
    a = -torch.exp(torch.randn(H, generator=g, device="cuda") * 0.5)
    b = torch.randn(B, L, N, generator=g, device="cuda").to(torch.bfloat16)
    c = torch.randn(B, L, N, generator=g, device="cuda").to(torch.bfloat16)
    a16 = a.to(torch.bfloat16)
    cfg = get_config("mamba2-780m")
    p = materialize(ssm.ssm_specs(cfg, 1), 0, "cuda")
    p = {k: v[0].to(torch.bfloat16) for k, v in p.items()}
    xl = torch.randn(1, 2048, cfg.d_model, generator=g,
                     device="cuda").to(torch.bfloat16)
    cases = {
        "ssd_scan kernels": lambda: ssd_k.ssd_scan(
            x.transpose(1, 2), dt.transpose(1, 2), a, b, c, chunk=chunk),
        "ssd_chunked bf16": lambda: ssm.ssd_chunked(x, dt, a16, b, c, chunk),
        "layer impl=kernel": lambda: ssm.ssm_forward(p, xl, None, cfg,
                                                     impl="kernel"),
        "layer impl=auto": lambda: ssm.ssm_forward(p, xl, None, cfg,
                                                   impl="auto"),
    }
    out = {}
    for name, fn in cases.items():
        out[name] = times(fn)
        print(f"{name}: {out[name]['ms']:.4f} ms (device "
              f"{out[name]['device_ms']:.4f}); src {args.src}", flush=True)
    print(json.dumps({"src": args.src, "iters": args.iters,
                      "device": torch.cuda.get_device_name(0), **out}))


if __name__ == "__main__":
    main()
