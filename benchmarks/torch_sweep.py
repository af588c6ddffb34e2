"""Campaign sweep on the port — the paper's configuration guidelines as one
grid (the twin of ``benchmarks/sweep.py``).

Fans a scenario grid out through ``repro_torch.api.Session.sweep`` and
writes the :class:`repro_torch.api.Campaign` artifact
(``repro.api/campaign/v1``, which either package reads: one validated
``repro.api/report/v1`` per cell plus the Pareto summary of throughput vs
efficiency):

    PYTHONPATH=src python -m benchmarks.torch_sweep \\
        [--arch granite-3-2b] [--kind plan|dryrun|train|bench|serve|tune]
        [--quick] [--full] [--calibrate] [--device cuda|cpu]
        [--out results/torch_sweep_campaign.json]

``--quick`` is JAX's smoke cell: 1 arch x 2 sync x 2 dp *training* runs
(2 steps, batch 4, seq 32).  On one card the ``dp=2`` cells are recorded
as skipped (two ranks need two cards); on two cards, or on the CPU (two
threaded gloo ranks), all four run.  The default (no ``--quick``) is the
predictive plan-mode sweep over topologies x archs x ``sync_overlap``.
``--full`` runs the full-width configs (``reduced=False``), and
``--calibrate`` prices every cell on ``Session(base).tuned.calibration``
(one ``Session.tune()`` of the base spec first).
"""
from __future__ import annotations

import argparse
from pathlib import Path


def _grids(args):
    if args.quick:
        return {"sync": ["all_reduce", "reduce_scatter_all_gather"],
                "dp": [1, 2]}
    # predictive (plan/dryrun) cells only see plan-affecting fields — the
    # planner prices (arch, shape, topology, sync_overlap), not execution
    # knobs like batch/compress/dp; sweep those with --kind train instead
    archs = [args.arch] + [a for a in ("mamba2-780m",) if a != args.arch]
    return {"topology": ["flat8", "2x4", "4x4-ib", "pod"], "arch": archs,
            "sync_overlap": [False, True]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--kind", default="plan",
                    help="Session method per cell: plan|dryrun|train|bench|"
                         "serve|tune")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--quick", action="store_true",
                    help="smoke: 1 arch x 2 sync x 2 dp training cells")
    ap.add_argument("--full", action="store_true",
                    help="full-width configs (reduced=False)")
    ap.add_argument("--calibrate", action="store_true",
                    help="price every cell on Session(base).tuned."
                         "calibration")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="results/torch_sweep_campaign.json")
    args = ap.parse_args(argv)
    if args.quick:
        args.kind, args.steps, args.batch, args.seq = "train", 2, 4, 32

    from repro_torch.api import JobSpec, Session

    base = JobSpec(arch=args.arch, reduced=not args.full, steps=args.steps,
                   batch=args.batch, seq=args.seq, log_every=0)
    calibration = None
    if args.calibrate:
        calibration = Session(base, device=args.device).tuned.calibration
        print(f"calibration {calibration.key}: achieved_flops "
              f"{calibration.achieved_flops:.4e} FLOP/s, hbm_bw "
              f"{calibration.hbm_bw:.4e} B/s")
    camp = Session.sweep(base, _grids(args), kind=args.kind, progress=True,
                         calibration=calibration, device=args.device)
    summary = camp.summary()
    print(f"\n{summary['n_ok']}/{summary['n_cells']} cells ok; "
          f"Pareto front ({len(summary['pareto'])} cells):")
    for cell in summary["pareto"]:
        knobs = {k: v for k, v in cell.items()
                 if k not in ("tokens_per_s", "efficiency", "source")}
        print(f"  {knobs}  ->  {cell['tokens_per_s']:,.0f} tok/s "
              f"@ eff {cell['efficiency']:.3f}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(camp.to_json())
    print(f"wrote {out}")
    return camp


def run(csv_rows, device="cuda"):
    """Harness entry: predictive topology sweep, no training (JAX's rows)."""
    print("\n== campaign sweep: topology x batch x compress (plan mode) ==")
    camp = main(["--kind", "plan", "--device", device,
                 "--out", "results/torch_sweep_campaign.json"])
    for cell, m in zip(camp.cells, camp.metrics()):
        key = "sweep/" + "/".join(f"{k}={cell[k]}" for k in sorted(cell))
        csv_rows.append((f"{key}/tokens_per_s", m["tokens_per_s"],
                         f"sched={m['schedule']} eff={m['efficiency']:.3f}"))


if __name__ == "__main__":
    main()
