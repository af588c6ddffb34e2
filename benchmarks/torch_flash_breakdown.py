"""Where the flash kernel's time goes, on the card: the kernel against
copies of itself with parts of its tile step taken out.

    python benchmarks/torch_flash_breakdown.py [--iters 20]

Builds ``src/repro_torch/csrc/flash_attention.cu`` as it is and four
copies into ``build/breakdown/``, each with parts of the per-tile work
removed.  The copies compute wrong values; they only time what is left:

    no_exp           P = the scaled scores: no exponentials
    no_exp_no_gemm   also no wgmma (neither S = Q K^T nor O += P V)
    alu_only         also no K/V tile copies: the softmax's other
                     arithmetic, the barriers, Q's load and the store
    loads_only       the K/V tile copies and the barriers; no tile step

Times each, device time per call from torch.profiler over ``--iters``
calls, on bf16 inputs from seed 0 at B 1, S 2048, causal: H 32, KV 8,
D 64 (granite-3-2b's attention) and H 16, KV 4, D 128.  Prints one line
per case and variant (the full kernel is also held to
``ref.flash_attention_ref``), then one JSON line.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

EXP = {"ex2(fmaf(s[i], sc, -m[hf]))": "s[i]",
       "ex2(fmaf(s[i + 1], sc, -m[hf]))": "s[i + 1]"}
GEMM = {"wgmma_rs<D>(acc, p[kk], sw128_desc(vs + kk * 16 * 128, BK * 128, "
        "1024));": "acc[kk] += __uint_as_float(p[kk][0] ^ p[kk][3]);",
        "wgmma_ss<BK>(s,": "if (0) wgmma_ss<BK>(s,"}
LOADS = {"if (t + 1 < t_end) load_kv(t + 1, stage ^ 1);": "",
         "  load_kv(t_begin, 0);\n": "\n"}
STEP = {"if (w_lo <= w_hi && key0 <= wk_hi && key0 + BK - 1 >= wk_lo) {":
        "if (w_lo > (1 << 30)) {"}
VARIANTS = {"full": [], "no_exp": [EXP], "no_exp_no_gemm": [EXP, GEMM],
            "alu_only": [EXP, GEMM, LOADS], "loads_only": [STEP]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(SRC))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build, _launch, ref
    from repro_torch.kernels import flash_attention as fa_k

    if not torch.cuda.is_available():
        raise SystemExit("torch_flash_breakdown: needs a CUDA device")
    out_dir = _build.BUILD_DIR / "breakdown"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "flash_attention.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = source
        for edit in edits:
            for old, new in edit.items():
                if old not in text:
                    raise SystemExit(f"{name}: '{old}' not in the kernel")
                text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(out_dir / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        fn = ctypes.CDLL(str(out_dir / f"{name}.so")).flash_attention_bf16
        fn.argtypes, fn.restype = fa_k._ARGTYPES, ctypes.c_int
        fns[name] = fn

    def device_us(call):
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                call()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        if [e.count for e in kernels] != [args.iters]:
            raise SystemExit(f"profiler kernels {[(e.key[:40], e.count) for e in kernels]}")
        return float(kernels[0].self_device_time_total) / args.iters

    results = {}
    for H, KV, D in ((32, 8, 64), (16, 4, 128)):
        S = 2048
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn(1, S, h, D, generator=g, device="cuda")
                   .to(torch.bfloat16).transpose(1, 2) for h in (H, KV, KV))
        want = ref.flash_attention_ref(q, k, v, scale=D ** -0.5).float()
        case = f"S={S},H={H},KV={KV},D={D}"
        for name, fn in fns.items():
            out = torch.empty_like(q)

            def call(fn=fn, out=out):
                err = fn(_launch.ptr(q), _launch.ptr(k), _launch.ptr(v),
                         _launch.ptr(out), 1, H, KV, S, S, D,
                         *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                         *out.stride()[:3], D ** -0.5, 0, 0.0, 0,
                         _launch.stream(q))
                if err:
                    raise SystemExit(f"{name}: CUDA error {err}")
            call()
            torch.cuda.synchronize()
            if name == "full":
                err = (out.float() - want).abs()
                if not bool((err <= 3e-2 + 3e-2 * want.abs()).all()):
                    raise SystemExit(f"{case}: the kernel is off by "
                                     f"{err.max().item()}")
            us = device_us(call)
            results.setdefault(case, {})[name] = us
            print(f"{case} {name}: {us:.2f} us on the device", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"device": smi, "iters": args.iters,
                      "device_us": results}))


if __name__ == "__main__":
    main()
