"""Where the SSD scan kernels' time goes, on the card: the three passes
against copies of themselves with parts taken out.

    python benchmarks/torch_ssd_breakdown.py [--iters 10] [--rounds 2]

Builds ``src/repro_torch/csrc/ssd_scan.cu`` as it is and copies into
``build/ssd_breakdown/``, each with one part removed.  The copies compute
wrong values; they only time what is left:

    chunk_no_mma       pass 1 without its products (loads, the cumsums,
                       the stores of the chunk states remain)
    output_no_offdiag  pass 3 without the C B^T tiles left of the diagonal
    output_no_diag     pass 3 without the diagonal tiles
    output_no_inter    pass 3 without the C h term
    output_no_compute  pass 3 without any strip work: loads, C B^T, the
                       per-head staging and barriers
    one_head           passes 1 and 3 on the first head of each group
                       only: what a block costs before its heads

Times each pass, device time per call from torch.profiler over
``--iters`` calls, ``--rounds`` times, on bf16 inputs from seed 0 at
mamba2-780m width (B 1, L 2048, H 48, P 64, N 128, chunk 256), in model
layout.  Prints one line per round and variant, then one JSON line of the
last round.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

VARIANTS = {
    "full": [],
    "chunk_no_mma": [("for (int k0 = 0; k0 < Qp; k0 += 16) {",
                      "for (int k0 = 0; k0 < Qp && Q < 0; k0 += 16) {")],
    "output_no_offdiag": [
        ("  for (int tj = tj0; tj < tj1; ++tj) {  // tiles left of the diagonal",
         "  for (int tj = tj0; tj < tj1 && tj0 < 0; ++tj) {")],
    "output_no_diag": [("  if (!diag) return;",
                        "  if (!diag || tj1 >= 0) return;")],
    "output_no_inter": [("  if (inter) {  // C_i h_start, then times e0",
                         "  if (inter && tj0 < 0) {")],
    "output_no_compute": [("    if (lp >= nlp) continue;",
                           "    if (lp >= nlp || Q > 0) continue;")],
    "one_head": [("h1 = min(h0 + g.G1, g.H);", "h1 = h0 + 1;"),
                 ("h1 = min(h0 + g.G3, g.H);", "h1 = h0 + 1;")],
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, str(SRC))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import ssd_scan as ssd_k

    if not torch.cuda.is_available():
        raise SystemExit("torch_ssd_breakdown: needs a CUDA device")
    out_dir = _build.BUILD_DIR / "ssd_breakdown"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, out_dir / header.name)
    source = (_build.CSRC / "ssd_scan.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} is not in the source once")
            text = text.replace(old, new)
        (out_dir / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"),
             str(out_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed:\n{log[-3000:]}")

    g = torch.Generator(device="cuda").manual_seed(0)
    B, L, H, P, N, chunk = 1, 2048, 48, 64, 128, 256
    x = torch.randn(B, L, H, P, generator=g, device="cuda").to(torch.bfloat16)
    dt = torch.nn.functional.softplus(
        torch.randn(B, L, H, generator=g, device="cuda")).to(torch.bfloat16)
    a = -torch.exp(torch.randn(H, generator=g, device="cuda") * 0.5)
    b = torch.randn(B, L, N, generator=g, device="cuda").to(torch.bfloat16)
    c = torch.randn(B, L, N, generator=g, device="cuda").to(torch.bfloat16)
    scan_args = (x.transpose(1, 2), dt.transpose(1, 2), a, b, c)

    def call():
        return ssd_k.ssd_scan(*scan_args, chunk=chunk)

    result = {}
    for rnd in range(args.rounds):
        for name in VARIANTS:
            fn = ctypes.CDLL(str(out_dir / f"{name}.so")).ssd_scan_bf16
            fn.argtypes, fn.restype = ssd_k._ARGTYPES, ctypes.c_int
            ssd_k._FN[:] = [fn]
            y, h = call()
            torch.cuda.synchronize()
            if name == "full":  # the copy of the source as it is
                wy, wh = ref.ssd_scan_ref(*scan_args, chunk=chunk)
                err = (y.float() - wy.float()).abs()
                if not bool((err <= 3e-2 + 3e-2 * wy.float().abs()).all()):
                    raise SystemExit(f"full: y off by {err.max().item()}")
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(args.iters):
                    call()
                torch.cuda.synchronize()
            times = {}
            for e in prof.key_averages():
                m = re.search(r"(chunk|state|output)_pass", e.key)
                if e.device_type == DeviceType.CUDA and m:
                    times[m.group(0)] = getattr(
                        e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0.0)) / args.iters
            result[name] = times
            print(f"round {rnd} {name}: " + ", ".join(
                f"{k} {v:.2f} us" for k, v in times.items()), flush=True)
    ssd_k._FN.clear()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "shape": dict(B=B, L=L, H=H, P=P, N=N, chunk=chunk),
                      "device_us_per_call": result}))


if __name__ == "__main__":
    main()
