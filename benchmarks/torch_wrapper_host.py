"""Host time per call of the kernels' wrappers, on the card.

    python benchmarks/torch_wrapper_host.py [--src DIR] [--calls 500]
        [--rounds 9]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``),
so that two trees can be compared on one card by running this once per
tree.  For each case it makes bf16 inputs from a seed, warms up, then,
``rounds`` times, issues ``calls`` wrapper calls with no synchronisation
between them and reads the host clock around them; the median over the
rounds of the host microseconds per call (the least beside it) is what
the wrapper costs the serving path's host (checks, ctypes, allocation and
the launch itself).  It also reads the wall clock up to the end of the
last call's kernels; where that is much larger than the host time, the
card, not the host, set the pace, and the host time is not the wrapper's
cost alone.  Cases: the decode wrapper at the serving shape (B 4, H 32,
KV 8, D 64, s_max 512, every row in its first 64-key tile) and at S 4096,
the flash wrapper at a serving prompt bucket (S 32), and the SSD scan
wrapper at a tuning shape (B 1, H 2, L 128, P 32, N 16, chunk 32) and at
mamba2-780m width (L 2048, H 48, P 64, N 128, chunk 256), on the
model-layout views ssm_forward passes.  Prints one line
per case, then one JSON line.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--calls", type=int, default=500)
    ap.add_argument("--rounds", type=int, default=9)
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch

    from repro_torch.kernels import decode_attention as dec_k
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import ssd_scan as ssd_k

    if not torch.cuda.is_available():
        raise SystemExit("torch_wrapper_host: needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(
            torch.bfloat16)

    cases = {}
    for S, pos in ((512, [47, 20, 63, 9]), (4096, [4095, 1000, 2047, 17])):
        q, k, v = randn(4, 32, 64), randn(4, S, 8, 64), randn(4, S, 8, 64)
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        cases[f"decode_attention[B=4,S={S}]"] = (
            lambda q=q, kt=kt, vt=vt, p=p: dec_k.decode_attention(
                q, kt, vt, p, scale=0.125))
    # the model's (B,S,H,D) tensors as transposed views, as the path passes
    qt, kt, vt = (randn(1, 32, h, 64).transpose(1, 2) for h in (32, 8, 8))
    cases["flash_attention[S=32]"] = (
        lambda: fa_k.flash_attention(qt, kt, vt, scale=0.125))
    for B, L, H, P, N, chunk in ((1, 128, 2, 32, 16, 32),
                                 (1, 2048, 48, 64, 128, 256)):
        x, dt = randn(B, L, H, P), randn(B, L, H).abs()
        scan = (x.transpose(1, 2), dt.transpose(1, 2),
                -torch.ones(H, device="cuda"), randn(B, L, N), randn(B, L, N))
        cases[f"ssd_scan[B={B},L={L},H={H},P={P},N={N},chunk={chunk}]"] = (
            lambda scan=scan, chunk=chunk: ssd_k.ssd_scan(*scan, chunk=chunk))

    out = {}
    for name, fn in cases.items():
        for _ in range(50):
            fn()
        host, wall = [], []
        for _ in range(args.rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.calls):
                fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            host.append((t1 - t0) / args.calls * 1e6)
            wall.append((t2 - t0) / args.calls * 1e6)
        out[name] = {"host_us_median": statistics.median(host),
                     "host_us_min": min(host),
                     "wall_us_median": statistics.median(wall)}
        print(f"{name}: host {out[name]['host_us_median']:.2f} us per call "
              f"(median of {args.rounds} rounds of {args.calls} calls; min "
              f"{out[name]['host_us_min']:.2f}), wall "
              f"{out[name]['wall_us_median']:.2f} us; src {args.src}",
              flush=True)
    print(json.dumps({"src": args.src, "calls": args.calls,
                      "rounds": args.rounds,
                      "device": torch.cuda.get_device_name(0), **out}))


if __name__ == "__main__":
    main()
