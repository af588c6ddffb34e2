#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0, no result line):

1. build  — compile every CUDA kernel from src/repro_torch/csrc with nvcc,
   all sources in parallel; print the build time and ptxas's register /
   spill report.
2. kernels — run each kernel's wrapper on bf16 tensors on the card, at the
   shapes the serving path gives it and at larger ones, and hold it to its
   plain PyTorch version on the same inputs (|err| <= 3e-2 + 3e-2 * |want|,
   tests/test_kernels.py's bf16 tolerance).  Print per case the max error,
   the kernel's time, the plain version's, the least time the card could
   take (bound: bytes at 3.35 TB/s or FLOPs at 989 TFLOP/s bf16, whichever
   is larger, counted for this run's inputs) and the time of one PyTorch
   library call of the same function (scaled_dot_product_attention, timed
   as a yardstick only; the port never calls it).
3. serve  — Session.serve() of full-width granite-3-2b (40 layers, random
   weights from seed 0): 8 requests, n_new 32, s_max 512, max_batch 4, on
   the hand-written kernels.  The kernels' launch counters are zeroed just
   before and read just after: flash launches must equal prefills x 40 and
   decode launches engine steps x 40.  Every request must return its n_new
   tokens and no logits row may hold a NaN or inf.
4. reference — one full-width prefill and one decode step with the
   kernels against the plain dense path on the same weights and prompt.

Then it prints the card's name and power limit (nvidia-smi), a
{"kernels": [...]} JSON line, and, last, the
{"ok": true, "device": {...}} line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

H100_HBM_BPS = 3.35e12   # H100 SXM data sheet, bytes/s
H100_BF16_FLOPS = 989e12  # H100 SXM data sheet, dense bf16 tensor-core FLOP/s
TOL = 3e-2  # bf16 rtol = atol, as tests/test_kernels.py
LAYERS = 40  # granite-3-2b


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def sync(torch) -> None:
    """Surface a fault of the last launch here, where it happened."""
    torch.cuda.synchronize()


def time_ms(torch, fn, iters: int = 20) -> float:
    """Device time of one call: CUDA events around ``iters`` calls after
    warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / H100_HBM_BPS, flops / H100_BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def flash_case(torch, mods, *, S, window=0, cap=0.0, B=1, H=32, KV=8, D=64,
               seed=0, dev="cuda"):
    fa_k, ref = mods["fa_k"], mods["ref"]
    F = torch.nn.functional
    g = torch.Generator(device=dev).manual_seed(seed)
    # model layout (B,S,H,D), handed to the kernel as transposed views, as
    # the serving path does
    q = torch.randn(B, S, H, D, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(B, S, KV, D, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(B, S, KV, D, generator=g, device=dev).to(torch.bfloat16)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    scale = D ** -0.5
    got = fa_k.flash_attention(qt, kt, vt, scale=scale, window=window, cap=cap)
    sync(torch)
    want = ref.flash_attention_ref(qt, kt, vt, scale=scale, window=window,
                                   cap=cap)
    err = (got.float() - want.float()).abs()
    if not bool((err <= TOL + TOL * want.float().abs()).all()):
        fail(f"flash_attention S={S} window={window} cap={cap}: max |err| "
             f"{err.max().item()} outside the bf16 tolerance")
    ms = time_ms(torch, lambda: fa_k.flash_attention(
        qt, kt, vt, scale=scale, window=window, cap=cap))
    plain_ms = time_ms(torch, lambda: ref.flash_attention_ref(
        qt, kt, vt, scale=scale, window=window, cap=cap), iters=5)
    library_ms = None
    if not cap:  # SDPA has no tanh cap
        pos = torch.arange(S, device=dev)
        mask = pos[None, :] <= pos[:, None]
        if window:
            mask &= (pos[:, None] - pos[None, :]) < window
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True))
    qpos = torch.arange(S)
    lo = (qpos - window + 1).clamp(min=0) if window else torch.zeros_like(qpos)
    pairs = int((qpos - lo + 1).sum())  # (q, k) pairs the mask keeps, per head
    nbytes = 2 * (2 * B * H * S * D + 2 * B * KV * S * D)
    b_ms, b_by = bound(nbytes, 4 * D * pairs * H * B)
    return dict(max_abs_err=err.max().item(), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)


def decode_case(torch, mods, *, B, S, pos, window=0, cap=0.0, H=32, KV=8,
                D=64, seed=1, dev="cuda"):
    dec_k, ref = mods["dec_k"], mods["ref"]
    F = torch.nn.functional
    g = torch.Generator(device=dev).manual_seed(seed)
    # q (B,1,H,D) and a linear cache (B,S,KV,D), as the decode step holds
    q = torch.randn(B, 1, H, D, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(B, S, KV, D, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(B, S, KV, D, generator=g, device=dev).to(torch.bfloat16)
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    q0, kt, vt = q[:, 0], k.transpose(1, 2), v.transpose(1, 2)
    scale = D ** -0.5
    got = dec_k.decode_attention(q0, kt, vt, p, scale=scale, window=window,
                                 cap=cap)
    sync(torch)
    want = ref.decode_attention_ref(q0, kt, vt, p, scale=scale, window=window,
                                    cap=cap)
    err = (got.float() - want.float()).abs()
    if not bool((err <= TOL + TOL * want.float().abs()).all()):
        fail(f"decode_attention B={B} S={S}: max |err| {err.max().item()} "
             "outside the bf16 tolerance")
    ms = time_ms(torch, lambda: dec_k.decode_attention(
        q0, kt, vt, p, scale=scale, window=window, cap=cap))
    plain_ms = time_ms(torch, lambda: ref.decode_attention_ref(
        q0, kt, vt, p, scale=scale, window=window, cap=cap), iters=5)
    library_ms = None
    if not cap:
        kpos = torch.arange(S, device=dev)
        mask = kpos[None, :] <= p[:, None]
        if window:
            mask &= (p[:, None] - kpos[None, :]) < window
        mask = mask[:, None, None, :]  # (B,1,1,S)
        qs = q.transpose(1, 2)  # (B,H,1,D)
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True))
    keys = sum(pp + 1 - (max(0, pp - window + 1) if window else 0)
               for pp in pos)  # cache positions the rows read
    nbytes = 2 * (2 * B * H * D + 2 * keys * KV * D) + 4 * B
    b_ms, b_by = bound(nbytes, 4 * D * H * keys)
    return dict(max_abs_err=err.max().item(), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)


def reference_check(torch, M, RunConfig, materialize, cfg, dev="cuda",
                    prompt_len=64):
    """Full-width prefill + one decode step through the kernels against the
    plain dense path, same weights and prompt.  The random weights are
    rescaled so every attention projection has std 1/sqrt(fan-in of the
    whole product) (the JAX init takes fan-in = heads for the (D,H,hd)
    projections, which makes the scores' std ~100 and the softmax one-hot,
    so any rounding difference in a layer's input is amplified through the
    stack); with smooth attention the two paths must agree within the bf16
    tolerance at every depth."""
    params = M.cast_params(materialize(M.model_specs(cfg), 0, dev), cfg)
    D, H, KV = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    mix = params["slots"]["slot0"]["mixer"]
    mix["wq"].mul_((H / D) ** 0.5)
    mix["wk"].mul_((KV / D) ** 0.5)
    mix["wv"].mul_((KV / D) ** 0.5)
    mix["wo"].mul_(H ** -0.5)
    toks = torch.randint(0, cfg.vocab_size, (1, prompt_len), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(3))
    pos = torch.tensor([prompt_len], dtype=torch.int32, device=dev)
    outs = {}
    for impl in ("kernel", "dense"):
        run = RunConfig(attn_impl=impl)
        logits, caches, _ = M.forward(params, {"tokens": toks}, cfg, run,
                                      with_cache=True)
        caches = {"slots": {"slot0": {  # room for the decoded position
            n: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, prompt_len))
            for n, c in caches["slots"]["slot0"].items()}}}
        step, _ = M.decode_step(params, toks[:, -1:], pos, caches, cfg, run)
        V = cfg.vocab_size  # columns past it are the -1e30 padding mask
        outs[impl] = (logits[0, -1, :V].float(), step[0, -1, :V].float())
    for i, what in enumerate(("prefill", "decode")):
        got, want = outs["kernel"][i], outs["dense"][i]
        if got.shape != (cfg.vocab_size,) or not bool(torch.isfinite(got).all()):
            fail(f"{what} logits: shape {tuple(got.shape)} or not finite")
        err = (got - want).abs().max().item()
        lim = TOL + TOL * want.abs().max().item()
        print(f"[reference] {cfg.num_layers}-layer {what} logits, kernels vs "
              f"dense: max |diff| {err:.4f} (limit {lim:.4f}), argmax "
              f"{int(got.argmax())} vs {int(want.argmax())}", flush=True)
        if err > lim:
            fail(f"{what} logits: kernels and dense path differ by {err}")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script runs on the card")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        fail(f"{src / 'repro_torch'} not found: run from a checkout of the repo")
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.api import JobSpec, Session
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import decode_attention as dec_k
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.models import model as M
    from repro_torch.models.blocks import RunConfig
    from repro_torch.models.common import materialize

    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}",
          flush=True)

    # 1. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"[build] {len(logs)} kernels in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    # 2. kernels ---------------------------------------------------------------
    mods = {"fa_k": fa_k, "dec_k": dec_k, "ref": ref}
    cases = []
    for S in (8, 16, 32, 64):  # the serving path's prompt buckets
        cases.append((f"flash_attention[S={S}]", "flash_attention",
                      flash_case(torch, mods, S=S)))
    cases.append(("flash_attention[S=2048]", "flash_attention",
                  flash_case(torch, mods, S=2048)))
    cases.append(("flash_attention[S=2048,window=512,cap=50]",
                  "flash_attention",
                  flash_case(torch, mods, S=2048, window=512, cap=50.0)))
    path_pos = [47, 20, 63, 9]  # rows of the serving batch: s_max 512
    cases.append(("decode_attention[B=4,S=512]", "decode_attention",
                  decode_case(torch, mods, B=4, S=512, pos=path_pos)))
    ragged = [4095, 1000, 2047, 17]
    cases.append(("decode_attention[B=4,S=4096]", "decode_attention",
                  decode_case(torch, mods, B=4, S=4096, pos=ragged)))
    cases.append(("decode_attention[B=4,S=4096,window=1024,cap=30]",
                  "decode_attention",
                  decode_case(torch, mods, B=4, S=4096, pos=ragged,
                              window=1024, cap=30.0)))
    for name, _, r in cases:
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"[kernel] {name}: max_abs_err {r['max_abs_err']:.3e}  "
              f"kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})  "
              f"library {lib} ms", flush=True)

    # 3. serve -----------------------------------------------------------------
    spec = JobSpec(arch="granite-3-2b", reduced=False, requests=8, n_new=32,
                   s_max=512, max_batch=4)
    session = Session(spec, device="cuda")
    fa_k.flash_attention.launches = 0
    dec_k.decode_attention.launches = 0
    rep = session.serve()
    launches = {"flash_attention": fa_k.flash_attention.launches,
                "decode_attention": dec_k.decode_attention.launches}
    m = rep.measured
    hists, counters = m["metrics"]["histograms"], m["metrics"]["counters"]
    prefills = hists["serve/prefill_s"]["count"]
    steps = m["serving"]["throughput"]["engine_steps"]
    want_tokens = [n_new for _, _, n_new in session._serve_workload()]
    got_tokens = [r["tokens"] for r in m["per_request"]]
    if got_tokens != want_tokens:
        fail(f"tokens per request {got_tokens} != n_new {want_tokens}")
    if counters["serve/nonfinite_logit_rows"]:
        fail(f"{counters['serve/nonfinite_logit_rows']} logits rows hold "
             "NaN or inf")
    if launches["flash_attention"] != prefills * LAYERS:
        fail(f"flash launches {launches['flash_attention']} != prefills "
             f"{prefills} x {LAYERS}")
    if launches["decode_attention"] != steps * LAYERS:
        fail(f"decode launches {launches['decode_attention']} != engine "
             f"steps {steps} x {LAYERS}")
    print(f"[serve] granite-3-2b full width: {len(got_tokens)} requests, "
          f"{m['n_tokens']} tokens in {m['wall_s']:.3f} s = "
          f"{m['tokens_per_s']:.1f} tok/s; decode step p50 "
          f"{hists['serve/decode_s']['p50'] * 1e3:.2f} ms over {steps} steps; "
          f"prefill p50 {hists['serve/prefill_s']['p50'] * 1e3:.2f} ms over "
          f"{prefills} prefills; launches {launches}", flush=True)
    del rep, session

    # 4. reference -------------------------------------------------------------
    reference_check(torch, M, RunConfig, materialize, get_config("granite-3-2b"))

    leaked = sorted(n for n in sys.modules
                    if n.split(".")[0] in ("jax", "jaxlib", "repro"))
    if leaked:
        fail(f"the port imported {leaked[:5]}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/csrc/{kernel}.cu",
         "replaces": {"flash_attention":
                      "src/repro/kernels/flash_attention.py:81",
                      "decode_attention":
                      "src/repro/kernels/decode_attention.py:103"}[kernel],
         "launches": launches[kernel], **r}
        for name, kernel, r in cases]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
