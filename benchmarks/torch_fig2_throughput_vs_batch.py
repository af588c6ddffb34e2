"""Paper Fig. 2 on the port: throughput against mini-batch size, with the
knee where the memory bound forces a slower algorithm (the twin of
``benchmarks/fig2_throughput_vs_batch.py``).

    PYTHONPATH=src python benchmarks/torch_fig2_throughput_vs_batch.py \\
        [--device cuda|cpu] [--full] [--out results/torch_fig2_report.json]

Default: the JAX script's configuration — granite-3-2b reduced with vocab
1024, seq 256, batches 1-32, ``remat="none"``, and the synthetic 48 MiB
bound: a batch runs ``dense`` attention while its dense score working set
(``2 B H S^2 4 L`` bytes) fits the bound, else ``chunked`` (the paper's
FFT -> GEMM fallback, inverted to attention).  The choice per batch is
JAX's (:func:`choose_impl`); the throughput is the port's training step on
``--device`` (one warm-up step, then the mean of 3).  It writes the same
``bench`` Report, validated by the port's ``validate_report``.

``--full``: the knee on the card.  Full-width granite-3-2b (40 layers) at
seq 512, ``remat="none"``; the bound is the card's memory
(``torch.cuda.get_device_properties(0).total_memory``) less the resident
fp32 state measured after the params and AdamW's moments are allocated.
The batch runs up past where the card runs out of memory; per batch it
prints the algorithm the bound picks and the measured tokens/s, or "out of
memory", and ``max_memory_allocated`` beside the memory model's
``train_memory`` for the same batch, algorithm and remat, both in GB.  Then
``Session.tune()``'s chosen minibatch (Eq. 5's edge) and microbatch (the
production ``train_4k`` job on ``h100-8``), and the memory model's
``max_microbatch`` at this script's own shape, beside the measured knee.
The points run the training step directly, not ``Session.sweep(kind=
"bench")``: a bench cell trains on ``Session``'s own attention and remat
(``auto`` + block remat), where Fig. 2 sets both per point.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

SEQ = 256
BATCHES = (1, 2, 4, 8, 16, 32)
BOUND_BYTES = 48 * 2**20  # synthetic "GPU memory" bound for the demo model
FULL_SEQ = 512
FULL_BATCHES = (1, 2, 4, 8, 12, 16, 24, 32)


def dense_bytes(cfg, batch: int, seq: int) -> int:
    """The dense-attention score working set the bound is held against:
    fp32 scores + probs for every layer."""
    return 2 * batch * cfg.num_heads * seq * seq * 4 * cfg.num_layers


def choose_impl(cfg, batch: int, seq: int, bound: float) -> str:
    """Algorithm choice under the memory bound (the ILP's degenerate case:
    one layer type, two algorithms)."""
    return "dense" if dense_bytes(cfg, batch, seq) <= bound else "chunked"


def _step_inputs(cfg, batch: int, seq: int, dev):
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    toks = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32),
        device=dev)
    return {"tokens": toks, "labels": toks}


def throughput(cfg, run, batch: int, seq: int, *, device, iters: int = 3,
               params=None, state=None) -> float:
    """Tokens/s of the port's training step at ``batch`` x ``seq``: one
    warm-up step, then the mean of ``iters``."""
    import torch

    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import adamw as opt_lib

    dev = torch.device(device)
    opt = opt_lib.OptConfig(lr=1e-3)
    if params is None:
        params = M.init_params(cfg, 0, dev)
        state = opt_lib.init_state(opt, params)
    step = build_train_step(cfg, run, opt)
    b = _step_inputs(cfg, batch, seq, dev)
    params, state, m = step(params, state, b)
    float(m["loss"])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        params, state, m = step(params, state, b)
    float(m["loss"])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return batch * seq / ((time.perf_counter() - t0) / iters)


def _report(spec, sess, points, bound, meta_extra):
    from repro_torch.api import Report
    from repro_torch.obs import MetricsRegistry

    meta = sess.report_meta()  # records the executed config actually run
    meta.update(benchmark="torch_fig2_throughput_vs_batch",
                run_config={"remat": "none",
                            "attn_impl": "per-point (see measured.points)"},
                **meta_extra)
    reg = MetricsRegistry()
    ran = [p for p in points if p.get("tokens_per_s")]
    for p in ran:
        reg.inc("bench/points")
        reg.observe("bench/tokens_per_s", p["tokens_per_s"])
    return Report(kind="bench", spec=spec.to_dict(),
                  plan=sess.resolved_plan.to_dict(),
                  measured={"tokens_per_s": max(p["tokens_per_s"]
                                                for p in ran),
                            "points": points, "bound_bytes": bound,
                            "metrics": reg.section()},
                  predicted=sess.plan().predicted, meta=meta).validate()


def run_default(csv_rows, device="cuda"):
    """JAX's configuration on ``device``."""
    from repro_torch.api import JobSpec, Session
    from repro_torch.configs.base import get_config
    from repro_torch.models.blocks import RunConfig

    cfg = get_config("granite-3-2b").reduced().replace(vocab_size=1024)
    spec = JobSpec(arch="granite-3-2b", reduced=True, steps=3, batch=32,
                   seq=SEQ, log_every=0)
    sess = Session(spec, config=cfg, device=device)
    print("\n== Fig. 2: throughput vs mini-batch size ==")
    print(f"{'batch':>6s} {'algorithm':>10s} {'tok/s':>10s}")
    points = []
    for batch in BATCHES:
        impl = choose_impl(cfg, batch, SEQ, BOUND_BYTES)
        tput = throughput(cfg, RunConfig(attn_impl=impl, remat="none"),
                          batch, SEQ, device=device)
        print(f"{batch:6d} {impl:>10s} {tput:10,.0f}", flush=True)
        csv_rows.append((f"fig2/batch{batch}", tput, impl))
        points.append({"batch": batch, "algorithm": impl,
                       "tokens_per_s": tput})
    print("(knee where the bound forces dense->chunked, as in the paper's "
          "FFT->GEMM fallback)")
    return _report(spec, sess, points, BOUND_BYTES, {})


def run_full(csv_rows):
    """The knee on the card: full width, the card's own memory."""
    import torch

    from repro_torch.api import JobSpec, Session
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.core import memory_model as mm
    from repro_torch.models import model as M
    from repro_torch.models.blocks import RunConfig
    from repro_torch.optim import adamw as opt_lib

    dev = torch.device("cuda")
    cfg = get_config("granite-3-2b")
    total = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    params = M.init_params(cfg, 0, dev)
    state = opt_lib.init_state(opt_lib.OptConfig(lr=1e-3), params)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() - before
    bound = total - resident
    print(f"\n== Fig. 2 on the card: granite-3-2b full width ({cfg.num_layers}"
          f" layers), seq {FULL_SEQ}, remat none; card memory {total / 1e9:.2f}"
          f" GB, resident fp32 params + AdamW moments {resident / 1e9:.2f} GB,"
          f" bound {bound / 1e9:.2f} GB ==")
    print(f"{'batch':>6s} {'algorithm':>10s} {'tok/s':>12s} {'peak_GB':>9s} "
          f"{'est_GB':>9s}")
    points, knee = [], 0
    for batch in FULL_BATCHES:
        impl = choose_impl(cfg, batch, FULL_SEQ, bound)
        est = mm.train_memory(
            cfg, ShapeConfig("fig2", FULL_SEQ, batch, "train"), dp=1, tp=1,
            fsdp=False, microbatch=batch, attn_impl=impl, remat="none",
            seq_parallel=False).total / 1e9  # GB, as the measured peak
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        point = {"batch": batch, "algorithm": impl, "est_gb": est}
        try:
            tput = throughput(cfg, RunConfig(attn_impl=impl, remat="none"),
                              batch, FULL_SEQ, device=dev, params=params,
                              state=state)
            point["tokens_per_s"] = tput
            knee = batch
            shown = f"{tput:12,.1f}"
        except torch.cuda.OutOfMemoryError:
            point["tokens_per_s"] = None
            point["oom"] = True
            shown = f"{'out of memory':>12s}"
        peak = torch.cuda.max_memory_allocated() / 1e9
        point["peak_gb"] = peak
        print(f"{batch:6d} {impl:>10s} {shown} {peak:9.2f} {est:9.2f}",
              flush=True)
        csv_rows.append((f"fig2_full/batch{batch}",
                         point["tokens_per_s"] or 0.0, impl))
        points.append(point)
    del params, state
    gc.collect()
    torch.cuda.empty_cache()

    spec = JobSpec(arch="granite-3-2b", reduced=False, batch=2,
                   seq=FULL_SEQ, steps=2, log_every=0, tune=True,
                   tune_steps=3)
    sess = Session(spec, device="cuda")
    mb = sess.tune().measured["tuning"]["minibatch"]
    own = mm.max_microbatch(
        cfg, ShapeConfig("fig2", FULL_SEQ, 4096, "train"), dp=1,
        tp=1, fsdp=False, attn_impl="dense", remat="none",
        seq_parallel=False, hbm_bytes=total)
    print(f"measured knee: batch {knee} is the largest that ran; "
          f"Session.tune(): minibatch* {mb['chosen']} (Eq. 5's edge on "
          f"{mb['m_gpu_bytes']:.4g} B), microbatch* "
          f"{mb['microbatch']['chosen']} (train_4k on h100-8); the memory "
          f"model's max_microbatch at seq {FULL_SEQ}, dp 1, dense, no remat "
          f"on {total / 1e9:.2f} GB: {own}")
    csv_rows.append(("fig2_full/knee_batch", knee, "largest batch that ran"))
    csv_rows.append(("fig2_full/tune_microbatch", mb["microbatch"]["chosen"],
                     "train_4k on h100-8"))
    csv_rows.append(("fig2_full/model_max_microbatch", own,
                     f"seq {FULL_SEQ} dp 1 dense remat none"))
    return _report(spec, sess, points, bound, {
        "knee_batch": knee, "resident_bytes": resident,
        "tune_minibatch": mb["chosen"],
        "tune_microbatch": mb["microbatch"]["chosen"],
        "model_max_microbatch": own})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="full-width granite-3-2b at seq 512 on the card's "
                         "own memory")
    ap.add_argument("--out", default="results/torch_fig2_report.json")
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda but no card is visible; pass "
                               "--device cpu")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    elif args.full:
        raise ValueError("--full measures the card's memory: run it on cuda")
    rows = []
    rep = run_full(rows) if args.full else run_default(rows, args.device)
    print(f"wrote {rep.save(args.out)}")
    print(json.dumps({"rows": rows}))
    return rep


if __name__ == "__main__":
    main()
