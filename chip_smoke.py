#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0, no result line):

1. build  — compile every CUDA kernel from src/repro_torch/csrc with nvcc,
   all sources in parallel; print the build time and ptxas's register /
   spill report, and the count of HGMMA (wgmma) instructions in the flash
   library's SASS and of HMMA/HGMMA (tensor-core) instructions in the scan
   library's (cuobjdump -sass); neither may be 0.
2. kernels — run each kernel's wrapper on bf16 tensors on the card, at the
   shapes the serving path gives it and at larger ones (flash at S 8-2048
   and at D 128; decode at s_max 512 and S 4096), and hold it to its
   plain PyTorch version on the same inputs (|err| <= 3e-2 + 3e-2 * |want|,
   tests/test_kernels.py's bf16 tolerance).  Print per case the max error,
   the kernel's time (CUDA events around 20 wrapper calls, so it holds the
   wrapper's host cost) and its device time (torch.profiler: every kernel
   a call launches, summed), the plain version's time, the least time the
   card could take (bound: bytes at 3.35 TB/s or FLOPs at 989 TFLOP/s
   bf16, whichever is larger, counted for this run's inputs) and the event
   and device time of one PyTorch library call of the same function
   (scaled_dot_product_attention: with is_causal, on its flash backend, for
   flash without a window, and with an explicit mask where there is a
   window or a decode row's pos; timed as a yardstick only, the port never
   calls it).  A device time must hold every kernel of every timed call,
   or the phase fails.
3. serve  — Session.serve() of full-width granite-3-2b (40 layers, random
   weights from seed 0): 8 requests, n_new 32, s_max 512, max_batch 4, on
   the hand-written kernels.  The kernels' launch counters are zeroed just
   before and read just after: flash launches must equal prefills x 40 and
   decode launches engine steps x 40.  Every request must return its n_new
   tokens and no logits row may hold a NaN or inf.
4. reference — one full-width prefill and one decode step with the
   kernels against the plain dense path on the same weights and prompt.
5. paged and scan kernels — the paged decode kernel on the tuning shape
   and on PagedKVCache pools of full-width granite-3-2b (40 layers, KV 8,
   D 64, kv_block 16; ragged rows, non-contiguous tables from admissions
   and releases, a strided layer view; s_max 512, and S = 4096 without and
   with window and cap): bitwise equal to the linear decode kernel on the
   gathered cache and within the bf16 tolerance of the plain version.  The SSD scan
   kernels at the tuning shapes (chunks 32/64/128) and at mamba2-780m width
   (H 48, P 64, N 128: L 2048 at chunk 256, one chunk of L = 192 < 256, and
   a ragged chunk of 20 at L 2000) against ref.ssd_scan_ref (y at the bf16
   tolerance, the fp32 state at 1e-3).  Times as in phase 2, the scan's
   device time holding every pass it launches (ssd_kernels); at L 2048 also
   each pass's device time and models.ssm.ssd_chunked in bf16 on the same
   inputs (what impl="auto" runs), whose device time the kernels must beat.
   The paged kernel's library yardstick is gather_kv_blocks followed by
   SDPA, timed together; the scan has no single PyTorch call (null).
6. mamba layer — one full-width mamba2-780m ssm_forward layer (random
   weights from seed 0, x (1, 2048, 1536) bf16) with impl="kernel" against
   impl="auto" on the same values in fp32, at tests/test_kernels.py's bf16
   SSD tolerance; the scan kernel's launch counter must move by one.  Then
   the layer's event and device time in bf16 with impl="kernel" and with
   impl="auto".
7. tune — the kernel-choice stage of the paper's procedure:
   bench_kernels(device="cuda") at the JAX package's defaults (seq 128,
   repeats 2, scan chunks 32/64/128), with all four launch counters zeroed
   just before and read just after (each must be (1 + repeats) x its
   kernel variants); no kernel variant may be in ``errors``, and each is
   held to its plain variant on the same inputs.  Then host_microbench()
   and choose_conv_algs(128, the card's memory).

8. train — the training path, which launches none of the four kernels
   (their counters are zeroed before and must read 0 after):
   Session.train() of full-width granite-3-2b (40 layers, random weights
   from seed 0; batch 4 x seq 512, 4 steps, RunConfig(attn_impl="auto",
   remat="block"), AdamW with warmup 1 on fp32 masters held on the card):
   every loss finite; it prints tokens/s, the step phases, R_O,
   torch.cuda.max_memory_allocated() and the wall time.  The same 4 steps
   from weights with smoothed attention (as phase 4): every loss finite,
   the last below the first (at JAX's init the 40-layer model does not
   learn in 4 steps: PERF.md).
   Then one train step of a 2-layer full-width model in fp32 (TF32 off)
   on the card against the same step on the CPU (loss, grad_norm, every
   gradient and the updated params within 2e-4 + 2e-4 * max |want|, but
   where the clipped gradient is below 100 * eps: there AdamW's first
   step turns on ~1e-8 of rounding, and the limit is 2 * lr + 2e-4), and the
   DataParallelTrainer with all_reduce over NCCL at dp = 1 (4 layers, 3
   steps) against the loop from the same params (same limit), with its
   SyncReport.  Both use attention-smoothed weights (as phase 4).
9. processes and overlap — no kernel launches either: (1) the one-rank
   DataParallelTrainer (rank 0 of 1, over NCCL on a TCPStore in this
   process: what each torchrun process builds) from phase 8's params and
   seed, 3 steps, bitwise equal to phase 8's threaded dp = 1 trainer; (2)
   the training launcher under torchrun --standalone --nproc-per-node 1
   (granite-3-2b reduced, --dp 1, 3 steps) as a child with a 300 s limit:
   it must exit 0 with a report that holds a sync section; (3) the
   overlapped trainer (2 serial-bucketed calibration steps, 2 fused) at
   full width and 4 layers, 4 steps, bitwise equal to the serial trainer;
   it prints the buckets, the overlap fraction, exposed against serial
   comm and the SyncReport priced on the H100 node's NVLink tier.

Then it prints the card's name and power limit (nvidia-smi), a
{"kernels": [...]} JSON line, and, last, the
{"ok": true, "device": {...}} line.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

H100_HBM_BPS = 3.35e12   # H100 SXM data sheet, bytes/s
H100_BF16_FLOPS = 989e12  # H100 SXM data sheet, dense bf16 tensor-core FLOP/s
TOL = 3e-2  # bf16 rtol = atol, as tests/test_kernels.py
FP32_TOL = 2e-4  # fp32, as tests/test_kernels.py
SSD_RTOL, SSD_ATOL = 5e-2, 1e-1  # tests/test_kernels.py's bf16 SSD tolerance
LAYERS = 40  # granite-3-2b
REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:81",
    "decode_attention": "src/repro/kernels/decode_attention.py:103",
    "paged_decode_attention": "src/repro/kernels/decode_attention.py:145",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:73",
}
SOURCES = {
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "decode_attention": "src/repro_torch/csrc/decode_attention.cu",
    "paged_decode_attention": "src/repro_torch/csrc/decode_attention.cu",
    "ssd_scan": "src/repro_torch/csrc/ssd_scan.cu",
}


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


def profile_kernels(torch, fn, calls: int) -> dict:
    """{kernel name: (launches, device us)} of ``calls`` calls of ``fn``,
    from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.count, float(getattr(e, "self_device_time_total",
                                           getattr(e, "self_cuda_time_total",
                                                   0.0))))
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def device_ms(torch, fn, kernels=None, iters: int = 20) -> float:
    """Device time of one call: every kernel the call launches on the card,
    summed from torch.profiler over ``iters`` calls after warm-up.  Unlike
    the event time it holds none of the host's cost per call.  ``kernels``
    is the number of kernels one call launches (None for a library call:
    then it is what a profile of one call shows).  The profile of ``iters``
    calls must hold each kernel of one call exactly ``iters`` times and
    nothing else; a profile that lost records is taken again, up to three
    times, and then the run fails: a device time that misses kernels is
    never reported."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        one = profile_kernels(torch, fn, 1)
        many = profile_kernels(torch, fn, iters)
        n_one = sum(c for c, _ in one.values())
        if (kernels is None or n_one == kernels) and {
                k: c for k, (c, _) in many.items()} == {
                k: iters * c for k, (c, _) in one.items()}:
            us = sum(t for _, t in many.values())
            if us <= 0.0:
                fail("torch.profiler recorded no device time")
            return us / iters / 1e3
    fail(f"torch.profiler lost kernel records in three tries: one call "
         f"{[(k[:40], c) for k, (c, _) in one.items()]} (want {kernels} "
         f"kernels), {iters} calls {[(k[:40], c) for k, (c, _) in many.items()]}")


def timings(torch, kernel, plain, library=None, kernels: int = 1) -> dict:
    """The kernel's event and device time (it launches ``kernels`` kernels
    per call), the plain version's event time and the library call's event
    and device time (None without one)."""
    return dict(
        ms=time_ms(torch, kernel), device_ms=device_ms(torch, kernel, kernels),
        plain_ms=time_ms(torch, plain, iters=5),
        library_ms=None if library is None else time_ms(torch, library),
        library_device_ms=None if library is None else device_ms(torch,
                                                                  library))


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
    library = None
    if not cap and not window:  # is_causal: SDPA's flash backend

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, scale=scale, enable_gqa=True)
    elif not cap:  # SDPA has no tanh cap; a window needs an explicit mask
        pos = torch.arange(S, device=dev)
        mask = (pos[None, :] <= pos[:, None]) & (
            (pos[:, None] - pos[None, :]) < window)

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True)
    times = timings(
        torch, lambda: fa_k.flash_attention(qt, kt, vt, scale=scale,
                                            window=window, cap=cap),
        lambda: ref.flash_attention_ref(qt, kt, vt, scale=scale,
                                        window=window, cap=cap), library)
    qpos = torch.arange(S)
    lo = (qpos - window + 1).clamp(min=0) if window else torch.zeros_like(qpos)
    pairs = int((qpos - lo + 1).sum())  # (q, k) pairs the mask keeps, per head
    nbytes = 2 * (2 * B * H * S * D + 2 * B * KV * S * D)
    b_ms, b_by = bound(nbytes, 4 * D * pairs * H * B)
    return dict(max_abs_err=err.max().item(), bound_ms=b_ms, bound_by=b_by,
                **times)


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
    library = None
    if not cap:
        kpos = torch.arange(S, device=dev)
        mask = kpos[None, :] <= p[:, None]
        if window:
            mask &= (p[:, None] - kpos[None, :]) < window
        mask = mask[:, None, None, :]  # (B,1,1,S)
        qs = q.transpose(1, 2)  # (B,H,1,D)

        def library():
            return F.scaled_dot_product_attention(
                qs, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True)
    times = timings(
        torch, lambda: dec_k.decode_attention(q0, kt, vt, p, scale=scale,
                                              window=window, cap=cap),
        lambda: ref.decode_attention_ref(q0, kt, vt, p, scale=scale,
                                         window=window, cap=cap), library,
        kernels=decode_kernels(dec_k, B, KV, S))
    keys = sum(pp + 1 - (max(0, pp - window + 1) if window else 0)
               for pp in pos)  # cache positions the rows read
    nbytes = 2 * (2 * B * H * D + 2 * keys * KV * D) + 4 * B
    b_ms, b_by = bound(nbytes, 4 * D * H * keys)
    return dict(max_abs_err=err.max().item(), bound_ms=b_ms, bound_by=b_by,
                **times)


def decode_kernels(dec_k, B: int, KV: int, S: int) -> int:
    """Kernels one decode call launches: the split pass, and the combine
    when there is more than one split."""
    return 2 if dec_k.decode_splits(B, KV, S)[0] > 1 else 1


def print_cases(cases) -> None:
    def ms(x):
        return "null" if x is None else f"{x:.4f}"
    for name, _, r in cases:
        print(f"[kernel] {name}: max_abs_err {r['max_abs_err']:.3e}  "
              f"kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f})  "
              f"plain {r['plain_ms']:.4f} ms  "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})  "
              f"library {ms(r['library_ms'])} ms (device "
              f"{ms(r['library_device_ms'])})", flush=True)


def smooth_attention(params, cfg):
    """Rescale the attention projections in place so each has std
    1/sqrt(fan-in of the whole product); returns ``params``."""
    D, H, KV = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    mix = params["slots"]["slot0"]["mixer"]
    mix["wq"].mul_((H / D) ** 0.5)
    mix["wk"].mul_((KV / D) ** 0.5)
    mix["wv"].mul_((KV / D) ** 0.5)
    mix["wo"].mul_(H ** -0.5)
    return params


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
    params = smooth_attention(
        M.cast_params(materialize(M.model_specs(cfg), 0, dev), cfg), cfg)
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


def within(got, want, rtol=TOL, atol=TOL):
    err = (got.float() - want.float()).abs()
    return bool((err <= atol + rtol * want.float().abs()).all()), \
        err.max().item()


def paged_case(torch, mods, name, q, kp, vp, table, pos, *, window=0,
               cap=0.0, kernel_table=None):
    """The paged kernel on pools (N,KV,bs,D) (strided views allowed) and a
    table (B,nb): bitwise equal to the linear kernel on the gathered cache,
    within the bf16 tolerance of the plain version.  ``kernel_table`` is
    the table the kernel gets (entries past a row's length poisoned with
    -1: the kernel must never read them); the gather takes ``table``."""
    dec_k, ref, ops = mods["dec_k"], mods["ref"], mods["ops"]
    F = torch.nn.functional
    kt = table if kernel_table is None else kernel_table
    B, H, D = q.shape
    KV, bs = kp.shape[1], kp.shape[2]
    S = table.shape[1] * bs
    scale = D ** -0.5
    got = dec_k.paged_decode_attention(q, kp, vp, kt, pos, scale=scale,
                                       window=window, cap=cap)
    sync(torch)
    kl = ops.gather_kv_blocks(kp.transpose(1, 2), table)  # (B,S,KV,D)
    vl = ops.gather_kv_blocks(vp.transpose(1, 2), table)
    lin = dec_k.decode_attention(q, kl.transpose(1, 2), vl.transpose(1, 2),
                                 pos, scale=scale, window=window, cap=cap)
    sync(torch)
    if not torch.equal(got, lin):
        fail(f"{name}: paged kernel differs from the linear kernel on the "
             f"gathered cache by {(got.float() - lin.float()).abs().max()}")
    want = ref.paged_decode_attention_ref(q, kp, vp, table, pos, scale=scale,
                                          window=window, cap=cap)
    ok, err = within(got, want)
    if not ok:
        fail(f"{name}: max |err| {err} outside the bf16 tolerance")
    library = None
    if not cap:  # SDPA has no tanh cap
        kpos = torch.arange(S, device=q.device)
        mask = kpos[None, :] <= pos[:, None].long()
        if window:
            mask &= (pos[:, None].long() - kpos[None, :]) < window
        mask = mask[:, None, None, :]

        def library():  # the gather and the attention, timed together
            k_lin = ops.gather_kv_blocks(kp.transpose(1, 2), table)
            v_lin = ops.gather_kv_blocks(vp.transpose(1, 2), table)
            return F.scaled_dot_product_attention(
                q[:, :, None], k_lin.transpose(1, 2), v_lin.transpose(1, 2),
                attn_mask=mask, scale=scale, enable_gqa=True)
    times = timings(
        torch, lambda: dec_k.paged_decode_attention(
            q, kp, vp, kt, pos, scale=scale, window=window, cap=cap),
        lambda: ref.paged_decode_attention_ref(
            q, kp, vp, table, pos, scale=scale, window=window, cap=cap),
        library, kernels=decode_kernels(dec_k, B, KV, S))
    keys = sum(p + 1 - (max(0, p - window + 1) if window else 0)
               for p in pos.tolist())  # cache positions the rows read
    blocks = sum(p // bs + 1 for p in pos.tolist())  # table entries read
    nbytes = 2 * (2 * B * H * D + 2 * keys * KV * D) + 4 * (B + blocks)
    b_ms, b_by = bound(nbytes, 4 * D * H * keys)
    return dict(max_abs_err=err, bound_ms=b_ms, bound_by=b_by, **times)


def granite_pools(torch, PagedKVCache, cfg, *, s_max, lengths, layer=17,
                  seed=5):
    """A PagedKVCache of full-width granite-3-2b (pools (N, 40, bs, KV, D)
    bf16, max_batch 4 rows' worth of blocks) filled with random values.
    Filler requests are admitted and released between the rows, so the
    rows' tables are ragged and non-contiguous.  Returns the layer's pools
    as strided kernel-layout views (N, KV, bs, D), the table (0-padded for
    the gather, -1-padded for the kernel) and pos = length - 1."""
    import numpy as np
    bs = 16
    kv = PagedKVCache(cfg, block_size=bs, n_blocks=4 * (s_max // bs),
                      s_max=s_max, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    pools = [kv._pools[("slots", "slot0", leaf)] for leaf in ("k", "v")]
    for pool in pools:
        pool.copy_(torch.randn(pool.shape, generator=g, device="cuda"))
    tok = iter(range(1, 10 ** 6))  # distinct prompts: no prefix sharing
    rows = []
    for i, n in enumerate(lengths):
        filler = 100 + i
        kv.admit(filler, np.array([next(tok)]), s_max // (4 * (i + 1)))
        kv.admit(i, np.array([next(tok)]), n)
        rows.append(kv._tables[i])
        kv.release(filler)
    nb = max(len(t) for t in rows)
    table = torch.zeros((len(rows), nb), dtype=torch.int32, device="cuda")
    poisoned = torch.full_like(table, -1)
    for r, t in enumerate(rows):
        table[r, :len(t)] = torch.tensor(t, dtype=torch.int32)
        poisoned[r, :len(t)] = table[r, :len(t)]
    if all(t == sorted(t) and t[-1] - t[0] == len(t) - 1 for t in rows):
        fail("granite_pools: every table is contiguous")
    kp, vp = (p[:, layer].transpose(1, 2) for p in pools)
    pos = torch.tensor([n - 1 for n in lengths], dtype=torch.int32,
                       device="cuda")
    return kp, vp, table, poisoned, pos


def ssd_case(torch, mods, name, *, B, L, H, P, N, chunk, seed=7,
             yardstick=False):
    """The scan kernels on model-layout views (x (B,L,H,P) and dt (B,L,H)
    transposed, as ssm_forward passes them) against ref.ssd_scan_ref.  The
    device time must hold every pass of every timed call.  With
    ``yardstick``: each pass's device time, and models.ssm.ssd_chunked in
    bf16 on the same inputs in model layout (what impl="auto" runs; no
    single PyTorch call computes the scan, so the library column stays
    null), whose device time the kernels must beat."""
    ssd_k, ref = mods["ssd_k"], mods["ref"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B, L, H, P, generator=g, device="cuda").to(torch.bfloat16)
    dt = torch.nn.functional.softplus(
        torch.randn(B, L, H, generator=g, device="cuda")).to(torch.bfloat16)
    a = -torch.exp(torch.randn(H, generator=g, device="cuda") * 0.5)
    b = torch.randn(B, L, N, generator=g, device="cuda").to(torch.bfloat16)
    c = torch.randn(B, L, N, generator=g, device="cuda").to(torch.bfloat16)
    args = (x.transpose(1, 2), dt.transpose(1, 2), a, b, c)
    y, h = ssd_k.ssd_scan(*args, chunk=chunk)
    sync(torch)
    wy, wh = ref.ssd_scan_ref(*args, chunk=chunk)
    ok_y, err = within(y, wy)
    ok_h, err_h = within(h, wh, 1e-3, 1e-3)  # fp32 both, sums reordered
    if not (ok_y and ok_h):
        fail(f"{name}: max |err| y {err}, h {err_h} outside the tolerance")
    kernels = ssd_k.ssd_kernels(B, H, L, chunk)
    times = timings(torch, lambda: ssd_k.ssd_scan(*args, chunk=chunk),
                    lambda: ref.ssd_scan_ref(*args, chunk=chunk),
                    kernels=kernels)
    Q = min(chunk, L)
    tri = Q * (Q + 1) // 2  # (i, j) pairs of a chunk the causal mask keeps
    nc = L // Q
    # C B^T once per (batch, chunk) (it is shared by the heads); per head
    # and chunk the masked product with x, C h and the state update
    flops = 2 * B * nc * (tri * N + H * (tri * P + 2 * Q * N * P))
    nbytes = (2 * 2 * B * L * H * P + 2 * B * L * H + 2 * 2 * B * L * N
              + 4 * H + 4 * B * H * N * P)
    b_ms, b_by = bound(nbytes, flops)
    out = dict(max_abs_err=err, bound_ms=b_ms, bound_by=b_by, **times)
    if not yardstick:
        return out
    passes = profile_kernels(torch, lambda: ssd_k.ssd_scan(*args, chunk=chunk),
                             20)
    if len(passes) != kernels or any(n != 20 for n, _ in passes.values()):
        fail(f"{name}: the profile of 20 calls shows {passes}, not "
             f"{kernels} passes 20 times each")
    out["pass_device_ms"] = {
        re.search(r"(chunk|state|output)_pass", k).group(0): t / 20 / 1e3
        for k, (_, t) in passes.items()}
    ssm, a16 = mods["ssm"], a.to(torch.bfloat16)

    def chunked():
        return ssm.ssd_chunked(x, dt, a16, b, c, chunk)

    out["ssd_chunked_ms"] = time_ms(torch, chunked)
    out["ssd_chunked_device_ms"] = device_ms(torch, chunked)
    print(f"[kernel] {name}: passes on the device "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in
                      out["pass_device_ms"].items())
          + f"; models.ssm.ssd_chunked bf16 {out['ssd_chunked_ms']:.4f} ms "
          f"(device {out['ssd_chunked_device_ms']:.4f})", flush=True)
    if out["device_ms"] >= out["ssd_chunked_device_ms"]:
        fail(f"{name}: the kernels take {out['device_ms']} ms on the device, "
             f"ssd_chunked {out['ssd_chunked_device_ms']} ms")
    return out


def mamba_layer_check(torch, ssm, materialize, get_config, ssd_k):
    """One full-width mamba2-780m mixer layer: the scan on the kernel
    against ssm_forward's plain chunked path.  The plain path runs in fp32
    on the same bf16-rounded weights and input: in bf16, ssd_chunked rounds
    the cumsum of the log decay to bf16 (an ulp of 0.5 at |cl| ~ 100), which
    alone moves the layer's output by more than the tolerance (printed
    below as the bf16 plain path's distance, for information)."""
    cfg = get_config("mamba2-780m")
    p = materialize(ssm.ssm_specs(cfg, 1), 0, "cuda")
    p = {k: v[0].to(torch.bfloat16) for k, v in p.items()}
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(1, 2048, cfg.d_model, generator=g,
                    device="cuda").to(torch.bfloat16)
    ssd_k.ssd_scan.launches = 0
    out, cache = ssm.ssm_forward(p, x, None, cfg, impl="kernel")
    sync(torch)
    if ssd_k.ssd_scan.launches != 1:
        fail(f"mamba layer: {ssd_k.ssd_scan.launches} scan launches, not 1")
    p32 = {k: v.float() for k, v in p.items()}
    want, want_cache = ssm.ssm_forward(p32, x.float(), None, cfg, impl="auto")
    bf16_auto, _ = ssm.ssm_forward(p, x, None, cfg, impl="auto")
    if out.shape != want.shape or not bool(torch.isfinite(out).all()):
        fail(f"mamba layer: output {tuple(out.shape)} or not finite")
    ok, err = within(out, want, SSD_RTOL, SSD_ATOL)
    ok_h, err_h = within(cache["state"], want_cache["state"], SSD_RTOL,
                         SSD_ATOL)
    print(f"[mamba] mamba2-780m layer, x (1, 2048, {cfg.d_model}) bf16, "
          f"chunk {cfg.ssm_chunk}: kernel vs plain fp32 max |diff| out "
          f"{err:.4f}, state {err_h:.4f} (rtol {SSD_RTOL}, atol {SSD_ATOL}); "
          f"plain bf16 vs plain fp32 max |diff| out "
          f"{(bf16_auto.float() - want).abs().max().item():.4f}; max |out| "
          f"{want.abs().max().item():.3f}; scan launches "
          f"{ssd_k.ssd_scan.launches}", flush=True)
    if not (ok and ok_h):
        fail(f"mamba layer: kernel path differs from the plain path by "
             f"{err} (out), {err_h} (state)")
    layer = {impl: (lambda impl=impl: ssm.ssm_forward(p, x, None, cfg,
                                                      impl=impl))
             for impl in ("kernel", "auto")}
    t = {impl: (time_ms(torch, fn, iters=10), device_ms(torch, fn, iters=10))
         for impl, fn in layer.items()}
    print(f"[mamba] mamba2-780m layer in bf16, impl=\"kernel\" "
          f"{t['kernel'][0]:.4f} ms (device {t['kernel'][1]:.4f}), "
          f"impl=\"auto\" (ssd_chunked) {t['auto'][0]:.4f} ms (device "
          f"{t['auto'][1]:.4f})", flush=True)


def tune_phase(torch, autotune, ops, wrappers):
    """bench_kernels on the card with every launch counter zeroed just
    before and read just after; returns the launches."""
    repeats, chunks = 2, (32, 64, 128)
    for fn in wrappers.values():
        fn.launches = 0
    res = autotune.bench_kernels(seq=128, repeats=repeats, ssd_chunks=chunks,
                                 device="cuda")
    launches = {name: fn.launches for name, fn in wrappers.items()}
    for op, entry in res.items():
        bad = {n: e for n, e in entry["errors"].items()
               if n.startswith("kernel")}
        if bad:
            fail(f"tune: {op} kernel variants raised: {bad}")
        print(f"[tune] {op}: chosen {entry['chosen']}; times "
              + ", ".join(f"{n} {t * 1e3:.4f} ms"
                          for n, t in entry["times_s"].items()), flush=True)
    per_variant = 1 + repeats
    want = {"flash_attention": per_variant, "decode_attention": per_variant,
            "paged_decode_attention": per_variant,
            "ssd_scan": per_variant * len(chunks)}
    if launches != want:
        fail(f"tune: launches {launches} != {want}")
    for op in ops.TUNABLE_OPS:  # the kernel variants against the plain ones
        inputs = ops.tune_inputs(op, seq=128, device="cuda")
        cands = ops.tune_candidates(op, ssd_chunks=chunks)
        plain = cands["gather_ref" if "gather_ref" in cands else "ref"](*inputs)
        for name, fn in cands.items():
            if not name.startswith("kernel"):
                continue
            got = fn(*inputs)
            sync(torch)
            pairs = zip(got, plain) if isinstance(got, tuple) else [(got, plain)]
            for i, (g_, w_) in enumerate(pairs):
                tol = (1e-3, 1e-3) if g_.dtype == torch.float32 else (TOL, TOL)
                ok, err = within(g_, w_, *tol)
                if not ok:
                    fail(f"tune: {op}/{name} output {i} differs from the "
                         f"plain variant by {err}")
    print(f"[tune] launches {launches}; every kernel variant within "
          "tolerance of its plain variant", flush=True)
    print(f"[tune] host_microbench {json.dumps(autotune.host_microbench())}")
    mem = torch.cuda.get_device_properties(0).total_memory
    conv = autotune.choose_conv_algs(128, mem)
    print(f"[tune] choose_conv_algs(128, {mem}): M_bound "
          f"{conv['m_bound_bytes']:.4e} B; "
          + ", ".join(f"{l['layer']} {l['chosen']}" for l in conv["layers"]),
          flush=True)
    return launches


def trees_close(tree_items, got, want, tol=FP32_TOL):
    """Max |got - want| over every leaf, and whether each leaf is within
    tol + tol * max |want|."""
    worst, ok = 0.0, True
    for (_, g), (_, w) in zip(tree_items(got), tree_items(want)):
        w = w.float().to(g.device)
        err = (g.float() - w).abs().max().item()
        worst = max(worst, err)
        ok &= err <= tol + tol * w.abs().max().item()
    return ok, worst


def adam_close(tree_items, got, want, grads, *, scale, lr,
               tol=FP32_TOL):
    """Updated params after one AdamW step against a reference: within
    tol + tol * max |want| per leaf, except where the reference's clipped
    gradient is below 100 * eps (AdamW's first step moves an element by
    lr * g / (|g| + eps), which there turns on rounding of ~1e-8): there
    within 2 * lr, the most that step can move it, plus tol for the
    rounding of the update itself.  Returns (ok, max diff elsewhere, count
    of those elements, max diff on them)."""
    ok, worst, n_eps, worst_eps = True, 0.0, 0, 0.0
    for (_, g), (_, w), (_, gr) in zip(tree_items(got), tree_items(want),
                                       tree_items(grads)):
        d = (g.float().cpu() - w.float().cpu()).abs()
        tiny = (gr.float().cpu() * scale).abs() < 100 * 1e-8
        lim = tol + tol * w.float().abs().max().item()
        rest = d[~tiny].max().item() if bool((~tiny).any()) else 0.0
        eps = d[tiny].max().item() if bool(tiny.any()) else 0.0
        ok &= rest <= lim and eps <= 2 * lr + tol
        worst, worst_eps = max(worst, rest), max(worst_eps, eps)
        n_eps += int(tiny.sum())
    return ok, worst, n_eps, worst_eps


def train_phase(torch, wrappers) -> None:
    """Phase 8: the training path (see the module docstring)."""
    from repro_torch.api import JobSpec, Session
    from repro_torch.configs.base import get_config
    from repro_torch.distributed.trainer import DataParallelTrainer
    from repro_torch.launch.steps import build_grad_fn
    from repro_torch.models import model as M
    from repro_torch.models.common import materialize, tree_items, tree_map
    from repro_torch.optim.adamw import OptConfig, apply_updates, init_state
    from repro_torch.train.loop import train

    for fn in wrappers.values():
        fn.launches = 0
    granite = get_config("granite-3-2b")
    # 8.1: full width through the entry point a user calls
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    spec = JobSpec(arch="granite-3-2b", reduced=False, steps=4, batch=4,
                   seq=512, log_every=1)
    session = Session(spec, device="cuda")
    rep = session.train()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    m = rep.measured
    losses = m["losses"]
    hist = m["metrics"]["histograms"]["train/step_s"]
    print(f"[train] granite-3-2b full width (40 layers, "
          f"{rep.meta['executed_config']['n_params']:,} params), batch 4 x "
          f"seq 512, 4 steps, auto attention + block remat, AdamW on fp32 "
          f"masters: losses {[round(x, 4) for x in losses]}", flush=True)
    print(f"[train] tokens/s {m['tokens_per_s']:.1f} over the run (first "
          f"step included); step wall p50 {hist['p50'] * 1e3:.1f} ms, min "
          f"{hist['min'] * 1e3:.1f}, max {hist['max'] * 1e3:.1f}; steady "
          f"step phases (s) {json.dumps(m['step_times_mean'])}; R_O "
          f"{m['r_o']:.4f}; peak memory {peak / 1e9:.2f} GB "
          f"(max_memory_allocated); phase wall {wall:.1f} s", flush=True)
    if not all(map(math.isfinite, losses)):
        fail(f"full-width training losses {losses}: not finite")
    run, opt = session.build_run_opt()
    del rep, session
    torch.cuda.empty_cache()

    # 8.1b: learning at full width and depth.  At JAX's init (fan-in =
    # heads for wq/wk/wv: scores of std ~64, a one-hot softmax) the
    # 40-layer model does not learn in 4 steps (PERF.md, section 6: the
    # loss rose for 4 of 4 seeds); with the attention weights smoothed, as
    # in phase 4, the same loop with the same run and optimizer settings
    # must bring the loss down.
    params = smooth_attention(materialize(M.model_specs(granite), 0, "cuda"),
                              granite)
    res = train(granite, run, opt, batch=4, seq=512, steps=4, seed=0,
                device="cuda", params=params, log_every=0)
    print(f"[train] the same 40-layer run with smoothed attention weights: "
          f"losses {[round(x, 4) for x in res.losses]}", flush=True)
    if not all(map(math.isfinite, res.losses)) \
            or not res.losses[-1] < res.losses[0]:
        fail(f"full-width training losses {res.losses}: not finite or not "
             "falling")
    del params
    torch.cuda.empty_cache()

    # 8.2: one step on the card against the same step on the CPU, fp32
    cfg = granite.replace(num_layers=2, dtype="float32")
    opt = OptConfig(lr=1e-3, warmup_steps=0)
    p_cpu = smooth_attention(materialize(M.model_specs(cfg), 0, "cpu"), cfg)
    p_gpu = tree_map(lambda a: a.to("cuda"), p_cpu)
    toks = torch.randint(0, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(4))
    grads_of = build_grad_fn(cfg, run)
    out = {}
    for dev, p in (("cuda", p_gpu), ("cpu", p_cpu)):
        t = toks.to(dev)
        loss, _, g = grads_of(p, {"tokens": t, "labels": t})
        _, _, gnorm = apply_updates(opt, p, g, init_state(opt, p))
        out[dev] = (loss.item(), gnorm.item(), g)
    for k, name in enumerate(("loss", "grad_norm")):
        got, want = out["cuda"][k], out["cpu"][k]
        if abs(got - want) > FP32_TOL + FP32_TOL * abs(want):
            fail(f"card and CPU {name}: {got} vs {want}")
    ok_g, worst_g = trees_close(tree_items, out["cuda"][2],
                                out["cpu"][2])
    ok_p, worst_p, n_eps, worst_eps = adam_close(
        tree_items, p_gpu, p_cpu, out["cpu"][2],
        scale=min(1.0, opt.grad_clip / out["cpu"][1]), lr=opt.lr)
    print(f"[train] 2-layer full-width fp32 step, card vs CPU: loss "
          f"{out['cuda'][0]:.6f} vs {out['cpu'][0]:.6f}, grad_norm "
          f"{out['cuda'][1]:.6f} vs {out['cpu'][1]:.6f}; grads max |diff| "
          f"{worst_g:.3e}; updated params max |diff| {worst_p:.3e} (limit "
          f"2e-4 + 2e-4 * max |want| per leaf), and {worst_eps:.3e} on the "
          f"{n_eps} elements whose clipped gradient is below 100 * eps, "
          f"where AdamW's first direction g / (|g| + eps) turns on 1e-8 "
          f"of rounding (limit 2 * lr + 2e-4)", flush=True)
    if not ok_g:
        fail(f"card and CPU gradients differ by up to {worst_g}")
    if not ok_p:
        fail(f"card and CPU updated params differ by up to {worst_p} "
             f"({worst_eps} where the gradient is below 100 * eps)")
    del out, p_cpu, p_gpu

    # 8.3: the data-parallel trainer, all_reduce over NCCL at dp = 1,
    # against the loop from the same params and loader seed
    cfg = granite.replace(num_layers=4)
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=3)
    p0 = smooth_attention(materialize(M.model_specs(cfg), 0, "cuda"), cfg)
    p_loop = tree_map(torch.clone, p0)
    res = train(cfg, run, opt, batch=4, seq=512, steps=3, device="cuda",
                params=p_loop, log_every=0)
    tr = DataParallelTrainer(cfg, run, opt, strategy="all_reduce",
                             devices=["cuda:0"])
    try:
        res_dp = tr.train(batch=4, seq=512, steps=3, params=p0, log_every=0)
        sync = tr.report().as_dict()
    finally:
        tr.close()
    ok, worst = trees_close(tree_items, tr.params[0], p_loop)
    print(f"[train] DataParallelTrainer all_reduce over NCCL, dp 1, 4 "
          f"layers, 3 steps: losses {res_dp.losses} vs the loop's "
          f"{res.losses}; params max |diff| {worst:.3e}", flush=True)
    print(f"[train] sync report {json.dumps(sync)}", flush=True)
    if not ok or max(abs(a - b) for a, b in zip(res_dp.losses, res.losses)) \
            > FP32_TOL + FP32_TOL * max(map(abs, res.losses)):
        fail("the dp = 1 trainer and the loop disagree")
    threaded = tr.params[0]
    del tr, p0, p_loop
    torch.cuda.empty_cache()
    moved = {name: fn.launches for name, fn in wrappers.items()
             if fn.launches}
    if moved:
        fail(f"the training path launched kernels: {moved}")
    print("[train] no kernel launched on the training path", flush=True)
    return threaded


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def procs_phase(torch, wrappers, threaded) -> None:
    """Phase 9: processes and overlap (see the module docstring)."""
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch.configs.base import get_config
    from repro_torch.distributed.trainer import DataParallelTrainer
    from repro_torch.models import model as M
    from repro_torch.models.common import materialize, tree_items
    from repro_torch.models.blocks import RunConfig
    from repro_torch.optim.adamw import OptConfig

    for fn in wrappers.values():
        fn.launches = 0
    cfg = get_config("granite-3-2b").replace(num_layers=4)
    run = RunConfig(attn_impl="auto", remat="block")

    def fresh():  # phase 8.3's params, optimizer and run
        return (smooth_attention(materialize(M.model_specs(cfg), 0, "cuda"),
                                 cfg),
                OptConfig(lr=1e-3, warmup_steps=1, total_steps=3))

    def bitwise(a, b):
        return all(torch.equal(x, y) for (_, x), (_, y)
                   in zip(tree_items(a), tree_items(b)))

    # 9.1: the one-rank trainer a torchrun process builds, in this process
    p0, opt = fresh()
    store = dist.TCPStore("127.0.0.1", free_port(), 1, True,
                          timeout=timedelta(seconds=120))
    tr = DataParallelTrainer(cfg, run, opt, strategy="all_reduce",
                             devices=["cuda:0"], rank=0, world=1, store=store)
    t0 = time.perf_counter()
    try:
        res = tr.train(batch=4, seq=512, steps=3, params=p0, log_every=0)
        rep = tr.report().as_dict()
        # the first barrier also sets up the NCCL communicator
        barrier = [e.dur_s for e in tr.tracer.events("barrier")][1:]
    finally:
        tr.close()
    same = bitwise(tr.params[0], threaded)
    print(f"[procs] one-rank trainer (rank 0 of 1, NCCL on a TCPStore), "
          f"granite-3-2b full width, 4 layers, 3 steps: losses "
          f"{res.losses}; params bitwise equal to phase 8's threaded dp = 1 "
          f"trainer: {same}; compute barrier "
          f"{[round(b * 1e3, 3) for b in barrier]} ms in steps 1-2; "
          f"{time.perf_counter() - t0:.1f} s",
          flush=True)
    print(f"[procs] sync report {json.dumps(rep)}", flush=True)
    if not same:
        fail("the one-rank trainer and the threaded dp = 1 trainer differ")
    del tr, p0, threaded, store
    torch.cuda.empty_cache()

    # 9.2: the launcher under torchrun, one process on this card
    root = Path(__file__).resolve().parent
    out = root / "build" / "chip_smoke" / "torchrun_report.json"
    out.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "1", "-m", "repro_torch.launch.train",
           "--arch", "granite-3-2b", "--device", "cuda", "--dp", "1",
           "--sync", "all_reduce", "--steps", "3", "--batch", "4",
           "--seq", "128", "--report-out", str(out)]
    t0 = time.perf_counter()
    try:
        child = subprocess.run(cmd, env=env, capture_output=True, text=True,
                               timeout=300)
    except subprocess.TimeoutExpired:
        fail("the torchrun child did not finish in 300 s")
    wall = time.perf_counter() - t0
    if child.returncode != 0:
        fail(f"torchrun exited {child.returncode}: "
             f"{(child.stdout + child.stderr)[-3000:]}")
    try:
        rep = json.loads(out.read_text())["measured"]["sync"]
    except (OSError, ValueError, KeyError) as e:
        fail(f"the torchrun child's report does not parse: {e!r}")
    print(f"[procs] torchrun --standalone --nproc-per-node 1 -m "
          f"repro_torch.launch.train (granite-3-2b reduced, --dp 1, 3 steps) "
          f"exited 0 in {wall:.1f} s; its report's sync: dp {rep['dp']}, "
          f"measured_comm_s {rep['measured_comm_s']:.6f}, link_bw "
          f"{rep['link_bw']:.3e}", flush=True)

    # 9.3: overlapped against serial, dp = 1, 4 steps
    params = {}
    for overlap in (False, True):
        p0, opt = fresh()
        opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=4)
        tr = DataParallelTrainer(cfg, run, opt, strategy="all_reduce",
                                 devices=["cuda:0"], sync_overlap=overlap)
        try:
            tr.train(batch=4, seq=512, steps=4, params=p0, log_every=0)
            rep = tr.report()
        finally:
            tr.close()
        params[overlap] = tr.params[0]
        del tr, p0
    same = bitwise(params[True], params[False])
    print(f"[procs] overlapped all_reduce, dp 1, 4 layers, 4 steps (2 "
          f"calibration + 2 fused): {rep.n_buckets} buckets of "
          f"{rep.bucket_mb} MiB; overlap_fraction {rep.overlap_fraction:.4f}, "
          f"exposed {rep.exposed_comm_time * 1e3:.3f} ms of "
          f"{rep.measured_comm_s * 1e3:.3f} ms serial comm; params bitwise "
          f"equal to the serial trainer's: {same}", flush=True)
    print(f"[procs] overlap sync report (priced at {rep.link_bw:.3e} B/s, "
          f"the H100 node's NVLink tier) {json.dumps(rep.as_dict())}",
          flush=True)
    if not same:
        fail("the overlapped and the serial trainer differ")
    del params
    torch.cuda.empty_cache()
    moved = {name: fn.launches for name, fn in wrappers.items()
             if fn.launches}
    if moved:
        fail(f"phase 9 launched kernels: {moved}")


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
    from repro_torch.core import autotune
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import decode_attention as dec_k
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import ssd_scan as ssd_k
    from repro_torch.models import model as M
    from repro_torch.models import ssm
    from repro_torch.models.blocks import RunConfig
    from repro_torch.models.common import materialize
    from repro_torch.serve.kvcache import PagedKVCache

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
    hgmma = sum("HGMMA" in line
                for line in _build.sass("flash_attention").splitlines())
    print(f"[build] flash_attention: {hgmma} HGMMA (wgmma) instructions in "
          "the SASS (cuobjdump -sass)", flush=True)
    if hgmma == 0:
        fail("the flash kernel's SASS holds no HGMMA: it does not run on "
             "the tensor cores")
    hmma = sum("HMMA" in line or "HGMMA" in line
               for line in _build.sass("ssd_scan").splitlines())
    print(f"[build] ssd_scan: {hmma} HMMA/HGMMA (tensor-core) instructions "
          "in the SASS (cuobjdump -sass)", flush=True)
    if hmma == 0:
        fail("the scan kernels' SASS holds no HMMA or HGMMA: they do not "
             "run on the tensor cores")

    # 2. kernels ---------------------------------------------------------------
    mods = {"fa_k": fa_k, "dec_k": dec_k, "ssd_k": ssd_k, "ref": ref,
            "ops": ops, "ssm": ssm}
    cases = []
    for S in (8, 16, 32, 64):  # the serving path's prompt buckets
        cases.append((f"flash_attention[S={S}]", "flash_attention",
                      flash_case(torch, mods, S=S)))
    cases.append(("flash_attention[S=512]", "flash_attention",
                  flash_case(torch, mods, S=512)))
    cases.append(("flash_attention[S=2048]", "flash_attention",
                  flash_case(torch, mods, S=2048)))
    cases.append(("flash_attention[S=2048,D=128,H=16,KV=4]", "flash_attention",
                  flash_case(torch, mods, S=2048, D=128, H=16, KV=4)))
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
    print_cases(cases)

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

    # 5. paged and scan kernels ------------------------------------------------
    new_cases = []
    q, kp, vp, table, pos = ops.tune_inputs("paged_decode_attention", seq=128)
    new_cases.append(("paged_decode_attention[tune: B=1,H=KV=2,S=128,bs=16]",
                      "paged_decode_attention",
                      paged_case(torch, mods, "paged tune", q, kp, vp, table,
                                 pos)))
    granite = get_config("granite-3-2b")
    g = torch.Generator(device="cuda").manual_seed(6)
    for label, s_max, lengths, window, cap in [
            ("B=4,s_max=512", 512, [100, 300, 50, 512], 0, 0.0),
            ("B=4,S=4096", 4096, [4096, 1000, 2048, 17], 0, 0.0),
            ("B=4,S=4096,window=1024,cap=30", 4096, [4096, 1000, 2048, 17],
             1024, 30.0)]:
        kp, vp, table, poisoned, pos = granite_pools(
            torch, PagedKVCache, granite, s_max=s_max, lengths=lengths)
        q = torch.randn(4, granite.num_heads, granite.head_dim, generator=g,
                        device="cuda").to(torch.bfloat16)
        name = f"paged_decode_attention[granite pools,{label}]"
        new_cases.append((name, "paged_decode_attention",
                          paged_case(torch, mods, name, q, kp, vp, table, pos,
                                     window=window, cap=cap,
                                     kernel_table=poisoned)))
        del kp, vp
    for chunk in (32, 64, 128):
        name = f"ssd_scan[tune: B=1,H=2,L=128,P=32,N=16,chunk={chunk}]"
        new_cases.append((name, "ssd_scan",
                          ssd_case(torch, mods, name, B=1, L=128, H=2, P=32,
                                   N=16, chunk=chunk)))
    name = "ssd_scan[mamba2-780m: B=1,L=2048,H=48,P=64,N=128,chunk=256]"
    new_cases.append((name, "ssd_scan",
                      ssd_case(torch, mods, name, B=1, L=2048, H=48, P=64,
                               N=128, chunk=256, yardstick=True)))
    for label, L, chunk in (("one chunk, Q = L = 192 < chunk", 192, 256),
                            ("ragged Q = 20", 2000, 20)):
        name = (f"ssd_scan[mamba2-780m width, {label}: B=1,L={L},H=48,P=64,"
                f"N=128,chunk={chunk}]")
        new_cases.append((name, "ssd_scan",
                          ssd_case(torch, mods, name, B=1, L=L, H=48, P=64,
                                   N=128, chunk=chunk)))
    print_cases(new_cases)
    print("[kernel] paged: bitwise equal to the linear kernel on the gathered "
          "cache in every case; library = gather_kv_blocks + SDPA, timed "
          "together. ssd_scan: library null, no single PyTorch call computes "
          "the SSD scan; its yardstick is models.ssm.ssd_chunked in bf16 "
          "(ssd_chunked_ms)", flush=True)
    cases += new_cases

    # 6. mamba layer -----------------------------------------------------------
    mamba_layer_check(torch, ssm, materialize, get_config, ssd_k)

    # 7. tune ------------------------------------------------------------------
    tuned = tune_phase(torch, autotune, ops, {
        "flash_attention": fa_k.flash_attention,
        "decode_attention": dec_k.decode_attention,
        "paged_decode_attention": dec_k.paged_decode_attention,
        "ssd_scan": ssd_k.ssd_scan})
    # B1 and B2 keep the serve phase's counts; B3 and B4 run on this path
    for kernel in ("paged_decode_attention", "ssd_scan"):
        launches[kernel] = tuned[kernel]

    # 8. train -----------------------------------------------------------------
    wrappers = {
        "flash_attention": fa_k.flash_attention,
        "decode_attention": dec_k.decode_attention,
        "paged_decode_attention": dec_k.paged_decode_attention,
        "ssd_scan": ssd_k.ssd_scan}
    threaded = train_phase(torch, wrappers)

    # 9. processes and overlap ---------------------------------------------------
    procs_phase(torch, wrappers, threaded)

    leaked = sorted(n for n in sys.modules
                    if n.split(".")[0] in ("jax", "jaxlib", "repro"))
    if leaked:
        fail(f"the port imported {leaked[:5]}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[kernel],
         "replaces": REPLACES[kernel], "launches": launches[kernel], **r}
        for name, kernel, r in cases]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
