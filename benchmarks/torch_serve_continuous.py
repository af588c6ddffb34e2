"""Continuous-vs-static serving on the port (the twin of
``benchmarks/serve_continuous.py``).

    PYTHONPATH=src python -m benchmarks.torch_serve_continuous \\
        [--quick] [--device cuda] [--dtype float32] [--init seeded] \\
        [--no-bench-append] [--bench-root DIR] [--sha SHA]
    # a CPU rehearsal at the reduced config
    PYTHONPATH=src python -m benchmarks.torch_serve_continuous \\
        --device cpu --reduced --quick --no-bench-append

Runs one seeded ragged workload through ``Session.serve()`` in
``static``, then ``continuous`` mode: granite-3-2b at full width (40
layers; ``--reduced`` for the CPU), ``shape="decode_32k"``, 8 requests,
``n_new`` up to 24, ``s_max`` 128, ``max_batch`` 2 (``--quick``: 5
requests, ``n_new`` 16, ``s_max`` 96).  Both runtimes serve one set of
random weights from ``--seed`` (:func:`weights`): by default the seeded
init with smoothed attention (``models.common.smooth_attention``), since
the seeded init alone (``--init seeded``, JAX's) makes every softmax
nearly one-hot, and at full width the rounding between two GEMM shapes
then picks other tokens.  On the card every prefill runs B1 and every
decode step B2; the kernels are built, and each runtime is run once on
a two-request workload, before either timed run starts, so neither wall holds ``nvcc`` or the process's first CUDA
calls.  :func:`measure` runs both and saves the continuous Report and a
summary (``--outdir``) before any check runs.  Then, hard, as JAX's
cell:

1. :func:`check_streams`: each request's token head is the same in both
   runtimes;
2. :func:`check_decode_work`: continuous ``decode_token_steps`` equals the
   tokens delivered with none wasted, and is below static's;
3. :func:`check_speed`: continuous tokens/s is above static's.

Only when all three pass does it append one record to
``BENCH_torch_serve.json`` (under ``--bench-root``) through
``tools/torch_bench_trajectory.py``, with the card's name and power limit
in its note, and compare it with the one before (warn only).
Where check 1 fails it prints the first request and step where the
heads part, and holds every head token of both runtimes against a plain
``"dense"`` forward of the same weights (:func:`teacher_forced`): how
many are not its top-1, and by how much at most.  ``--dtype float32`` serves both runtimes in fp32, on the card on
plain ``"dense"`` attention (``api.session.serve_attn_impl``: the kernels
take bf16 only), which tells a bf16 near-tie from a fault.  Both Reports
are saved beside the summary.  Every number printed on the card stands
beside the card's name and power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

MODES = ("static", "continuous")
INITS = ("smooth", "seeded")


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--n-new", type=int, default=24)
    ap.add_argument("--s-max", type=int, default=128)
    ap.add_argument("--max-batch", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arrival", default="",
                    help="arrival trace spec for the continuous run")
    ap.add_argument("--outdir", default="results")
    ap.add_argument("--quick", action="store_true",
                    help="fewer requests, shorter generations")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config (a CPU rehearsal)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="",
                    help="run the arch in this dtype (default: its own, "
                         "bf16; any other serves on plain dense attention "
                         "on the card)")
    ap.add_argument("--init", default="smooth", choices=INITS,
                    help="the weights: the seeded init with smoothed "
                         "attention, or the seeded init alone (JAX's)")
    ap.add_argument("--no-bench-append", dest="bench_append",
                    action="store_false", default=True,
                    help="skip appending to BENCH_torch_serve.json")
    ap.add_argument("--bench-root", default=str(ROOT),
                    help="directory of BENCH_torch_serve.json")
    ap.add_argument("--sha", default="",
                    help="the record's commit (default: read from .git)")
    args = ap.parse_args(argv)
    if args.quick:
        args.requests, args.n_new, args.s_max = 5, 16, 96
    return args


def base_spec(args):
    from repro_torch.api import JobSpec

    return JobSpec(arch=args.arch, reduced=args.reduced, shape="decode_32k",
                   requests=args.requests, n_new=args.n_new,
                   s_max=args.s_max, max_batch=args.max_batch,
                   seed=args.seed, arrival=args.arrival)


def config_of(args):
    """The executed config where ``--dtype`` overrides the arch's own;
    None (the session's own choice) otherwise."""
    from repro_torch.configs.base import get_config

    if not args.dtype:
        return None
    cfg = get_config(args.arch)
    return (cfg.reduced() if args.reduced else cfg).replace(dtype=args.dtype)


def card_of(device: str) -> str:
    return smi() if device == "cuda" else "cpu (no device numbers)"


def weights(args, cfg, device):
    """The weights both runtimes serve: ``models.model.init_params`` from
    ``--seed``, with smoothed attention under ``--init smooth``, cast to
    ``cfg.dtype`` once."""
    from repro_torch.models import model as M
    from repro_torch.models.common import smooth_attention

    params = M.init_params(cfg, args.seed, device)
    if args.init == "smooth":
        smooth_attention(params, cfg)
    return M.cast_params(params, cfg)


def measure(args, watch=None) -> Dict[str, Any]:
    """Serve the workload statically, then continuously; save the
    continuous Report and the summary; return ``{"static": Report,
    "continuous": Report, "summary": dict, "report": path}``.  ``watch(mode)``
    gives a context manager entered around each timed ``Session.serve()``
    (a caller's launch counters); both Reports are validated."""
    from repro_torch.api import Session, validate_report
    from repro_torch.api.session import serve_attn_impl

    watch = watch or (lambda mode: contextlib.nullcontext())
    card = card_of(args.device)
    if args.device == "cuda":
        from repro_torch.kernels import _build

        _build.build()  # nvcc runs here, outside both runtimes' walls
    base = base_spec(args)
    probe = Session(base, config=config_of(args), device=args.device)
    cfg, dev = probe.cfg, probe.device
    params = weights(args, cfg, dev)
    del probe
    if dev.type == "cuda":  # untimed, uncounted
        for mode in MODES:
            Session(base.replace(serve_mode=mode, requests=2, n_new=2),
                    config=cfg, device=dev, serve_params=params).serve()
    out: Dict[str, Any] = {}
    Path(args.outdir).mkdir(parents=True, exist_ok=True)
    for mode in MODES:
        session = Session(base.replace(serve_mode=mode), config=cfg,
                          device=dev, serve_params=params)
        with watch(mode):
            rep = session.serve()
        validate_report(rep.to_dict())
        m = rep.measured
        tp = m["serving"]["throughput"]
        print(f"{mode:>10}: {m['n_tokens']} tokens {m['tokens_per_s']:8.1f} "
              f"tok/s  decode-steps {tp['decode_token_steps']:4d} (wasted "
              f"{tp['wasted_decode_steps']}), engine steps "
              f"{tp['engine_steps']}, p99 "
              f"{m['serving']['latency_s']['p99'] * 1e3:.0f} ms ({card})",
              flush=True)
        out[mode] = rep
        del session
        rep.save(Path(args.outdir) / f"torch_serve_{mode}_report.json")
    crep, srep = out["continuous"], out["static"]
    csv_, ssv = crep.measured["serving"], srep.measured["serving"]
    outdir = Path(args.outdir)
    report_path = outdir / "torch_serve_continuous_report.json"
    c_tps = crep.measured["tokens_per_s"]
    s_tps = srep.measured["tokens_per_s"]
    summary = {
        "continuous_tokens_per_s": c_tps,
        "static_tokens_per_s": s_tps,
        "speedup": c_tps / s_tps,
        "decode_steps_saved": (ssv["throughput"]["decode_token_steps"]
                               - csv_["throughput"]["decode_token_steps"]),
        "engine_steps": {mode: out[mode].measured["serving"]["throughput"]
                         ["engine_steps"] for mode in MODES},
        "kv_peak_occupancy": csv_["kv_cache"]["peak_occupancy"],
        "latency_p99_s": csv_["latency_s"]["p99"],
        "replicas_predicted": csv_["replica_lemma"]["predicted"]["replicas"],
        "dtype": cfg.dtype,
        "attn": serve_attn_impl(cfg, dev),
        "init": args.init,
        "card": card,
        "report": str(report_path),
    }
    (outdir / "torch_serve_continuous_summary.json").write_text(
        json.dumps(summary, indent=2))
    out.update(summary=summary, report=report_path)
    return out


def heads(rep) -> Dict[int, list]:
    return {r["rid"]: r["head"] for r in rep.measured["per_request"]}


def parting_steps(out) -> Dict[int, int]:
    """request -> the first step where its two token heads differ, for
    every request whose heads differ."""
    a, b = heads(out["static"]), heads(out["continuous"])
    parts = {}
    for rid in sorted(set(a) | set(b)):
        x, y = a.get(rid, []), b.get(rid, [])
        steps = [i for i, (p, q) in enumerate(zip(x, y)) if p != q]
        if steps or len(x) != len(y):
            parts[rid] = steps[0] if steps else min(len(x), len(y))
    return parts


def first_divergence(out) -> Optional[Tuple[int, int]]:
    """(request, step) where the two runtimes' token heads first part;
    None where they are equal."""
    parts = parting_steps(out)
    if not parts:
        return None
    rid = min(parts)
    return rid, parts[rid]


def check_streams(out) -> Tuple[bool, str]:
    """Check 1: the same token heads in both runtimes."""
    parts = parting_steps(out)
    if not parts:
        return True, "token heads equal between runtimes"
    rid, step = first_divergence(out)
    return False, (f"token streams part in {len(parts)} of "
                   f"{len(heads(out['static']))} requests (request: step "
                   f"{parts}); first at request {rid}, step {step}: static "
                   f"{heads(out['static']).get(rid)} against continuous "
                   f"{heads(out['continuous']).get(rid)}")


def check_decode_work(out) -> Tuple[bool, str]:
    """Check 2: continuous computes exactly the tokens it delivers, none
    wasted, and fewer decode-token steps than static."""
    ctp = out["continuous"].measured["serving"]["throughput"]
    s_steps = out["static"].measured["serving"]["throughput"][
        "decode_token_steps"]
    c_steps, delivered = ctp["decode_token_steps"], \
        out["continuous"].measured["n_tokens"]
    ok = (c_steps == delivered and ctp["wasted_decode_steps"] == 0
          and c_steps < s_steps)
    return ok, (f"continuous {c_steps} decode-token steps for {delivered} "
                f"delivered ({ctp['wasted_decode_steps']} wasted), static "
                f"{s_steps}")


def check_speed(out) -> Tuple[bool, str]:
    """Check 3: continuous tokens/s above static's (a wall clock)."""
    c = out["continuous"].measured["tokens_per_s"]
    s = out["static"].measured["tokens_per_s"]
    return c > s, (f"continuous {c:.1f} tok/s against static {s:.1f} "
                   f"({c / s:.3f}x)")


CHECKS = (check_streams, check_decode_work, check_speed)


def teacher_forced(args, out) -> Dict[str, Dict[str, Any]]:
    """Every head token each runtime delivered against one plain
    ``"dense"`` forward of the same weights (:func:`weights`) in the run's
    dtype over the request's prompt and that runtime's own head before it:
    no cache, no padding, no kernel.  Per runtime: ``tokens`` held,
    ``off_top`` the tokens that are not the forward's top-1, and the
    largest ``deficit`` (the top-1 logit less the taken token's), also over
    that row's logits' std, with its ``at`` (request, step).  A pad that
    reaches a real row or a wrong ``pos`` takes tokens far below the top;
    rounding between two layouts takes at most near-ties."""
    import numpy as np
    import torch

    from repro_torch.api import Session
    from repro_torch.models import model as M
    from repro_torch.models.blocks import RunConfig

    session = Session(base_spec(args), config=config_of(args),
                      device=args.device)
    cfg, dev = session.cfg, session.device
    work = session._serve_workload()
    params = weights(args, cfg, dev)
    res: Dict[str, Dict[str, Any]] = {}
    for mode in MODES:
        r = {"tokens": 0, "off_top": 0, "deficit": 0.0, "deficit_std": 0.0,
             "at": None}
        for rid, head in sorted(heads(out[mode]).items()):
            prompt = work[rid][0]
            toks = np.concatenate([prompt, np.asarray(head[:-1], np.int32)])
            with torch.no_grad():
                lg = M.forward(params, {"tokens": torch.as_tensor(
                    toks[None], device=dev)}, cfg,
                    RunConfig(attn_impl="dense"))[0]
            n = len(prompt)
            lg = lg[0, n - 1:n - 1 + len(head), :cfg.vocab_size].float()
            taken = torch.as_tensor(head, device=dev)[:, None]
            deficit = lg.max(-1).values - lg.gather(1, taken)[:, 0]
            std = lg.std(-1)
            r["tokens"] += len(head)
            r["off_top"] += int((deficit > 0).sum())
            step = int(deficit.argmax())
            if float(deficit[step]) > r["deficit"]:
                r.update(deficit=float(deficit[step]),
                         deficit_std=float(deficit[step] / std[step]),
                         at=(rid, step))
        res[mode] = r
    return res


def parting_note(args, out) -> str:
    """Where check 1 fails: the first parting, and :func:`teacher_forced`
    for both runtimes."""
    rid, step = first_divergence(out)
    h_s, h_c = heads(out["static"])[rid], heads(out["continuous"])[rid]
    tf = teacher_forced(args, out)
    return (f"at request {rid}, step {step} static took {h_s[step]}, "
            f"continuous {h_c[step]}; against the plain dense forward "
            f"({out['summary']['dtype']}) teacher-forced on each runtime's "
            f"own head: " + "; ".join(
                f"{mode} {r['off_top']} of {r['tokens']} tokens off its "
                f"top-1, largest deficit {r['deficit']:.4g} "
                f"({r['deficit_std']:.3g} std) at {r['at']}"
                for mode, r in tf.items()))


def append(args, report_path, note: str) -> None:
    """One record into ``--bench-root``'s BENCH_torch_serve.json, then the
    comparison with the record before it (warn only)."""
    sys.path.insert(0, str(ROOT / "tools"))
    import torch_bench_trajectory as traj

    root = Path(args.bench_root)
    rec = traj.append_record("serve", report_path, root=root,
                             sha=args.sha or None, note=note)
    print(f"BENCH_torch_serve: appended {rec['sha']} "
          f"{json.dumps(rec['metrics'])}")
    for r in traj.compare("serve", root=root):
        print("WARN " + r, file=sys.stderr)


def main(argv=None) -> Dict[str, Any]:
    args = parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("torch_serve_continuous: --device cuda but no "
                             "card is visible; pass --device cpu --reduced")
    out = measure(args)
    s = out["summary"]
    failed = []
    for n, check in enumerate(CHECKS, 1):
        ok, msg = check(out)
        if not ok and check is check_streams:
            msg += "; " + parting_note(args, out)
        print(f"check {n} {'pass' if ok else 'FAIL'}: {msg} ({s['card']})",
              flush=True)
        if not ok:
            failed.append(f"check {n}: {msg}")
    print(f"continuous/static speedup {s['speedup']:.3f}x, "
          f"{s['decode_steps_saved']} decode steps saved, engine steps "
          f"{s['engine_steps']}, report {out['report']} ({s['card']})",
          flush=True)
    if failed:
        raise SystemExit("torch_serve_continuous: " + "; ".join(failed))
    if args.bench_append:
        append(args, out["report"],
               f"{s['card']}; torch_serve_continuous, {s['init']} init, "
               f"{s['dtype']} on {s['attn']}, static "
               f"{s['static_tokens_per_s']:.1f} tok/s, engine steps "
               f"{s['engine_steps']}")
    return out


def run(csv_rows, device="cuda", reduced=False):
    """Harness entry (``benchmarks/torch_run.py --only serve_continuous``):
    the ``--quick`` cell in this process, checks hard, no record appended
    (records come from the cell's own command line)."""
    print("\n== serve_continuous: in-flight batching vs FIFO batches ==")
    out = main(["--quick", "--no-bench-append", "--device", device]
               + (["--reduced"] if reduced else []))
    s = out["summary"]
    csv_rows.append(("serve_continuous/tokens_per_s",
                     s["continuous_tokens_per_s"],
                     f"{s['speedup']:.2f}x over static"))
    csv_rows.append(("serve_continuous/decode_steps_saved",
                     s["decode_steps_saved"],
                     f"p99 {s['latency_p99_s'] * 1e3:.0f} ms"))


if __name__ == "__main__":
    main()
