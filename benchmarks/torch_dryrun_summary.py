"""§Dry-run on the port: one table over ``results/torch_dryrun/*.json``
(both meshes), the twin of ``benchmarks/dryrun_summary.py``: which (arch
x shape x mesh) combinations the rank program traces, with per-chip
memory, FLOPs and the collective mix.  Writes
``results/torch_dryrun_summary.md`` and ``results/torch_dryrun_report.json``,
one unified ``Report`` per traced combination (the port's
``Session(...).dryrun()``: spec and analytic plan, with the trace's
numbers under ``measured``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python benchmarks/torch_dryrun_summary.py

The records come from ``meta`` traces (no device): ``trace s`` is the
trace's wall time on the host, where JAX's table has XLA's compile time.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs.base import ARCH_IDS, SHAPES  # noqa: E402

INDIR = "results/torch_dryrun"


def _unified_reports(records):
    """One kind="dryrun" Report per traced combination: the planner's
    prediction beside what the trace measured."""
    from repro_torch.api import JobSpec, Session

    reports = []
    for (arch, shape, mesh_kind), r in records:
        rep = Session(JobSpec(arch=arch, reduced=False, shape=shape,
                              mesh=mesh_kind), device="cpu").dryrun()
        f = r.get("full", {})
        rep.measured = {
            "ok": bool(r.get("ok")),
            "variant": r.get("variant", ""),
            "trace_s": f.get("trace_s", 0.0),
            "memory": f.get("memory", {}),
            "derived": r.get("derived", {}),
        }
        rep.meta["benchmark"] = "torch_dryrun_summary"
        reports.append(rep.validate().to_dict())
    return reports


def run(csv_rows=None, write_md=True, indir=INDIR, outdir="results"):
    lines = [
        "# Dry run on the port — every (arch × shape × mesh), rank 0 "
        "traced on meta",
        "",
        "| arch | shape | mesh | ok | variant | trace s | args GiB/chip |"
        " temp GiB/chip | per-chip FLOPs | wire GiB/chip | top collective |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    n_ok = n_all = 0
    records = []
    for arch in ARCH_IDS:
        for shape in SHAPES:
            for mesh in ("single", "multi"):
                p = Path(indir) / f"{arch}__{shape}__{mesh}.json"
                if not p.exists():
                    continue
                r = json.loads(p.read_text())
                records.append(((arch, shape, mesh), r))
                n_all += 1
                if not r.get("ok"):
                    lines.append(f"| {arch} | {shape} | {mesh} | **FAIL** | "
                                 f"{r.get('error', '')[:60]} | | | | | | |")
                    continue
                n_ok += 1
                f = r.get("full", {})
                m = f.get("memory", {})
                d = r.get("derived", {})
                cols = f.get("collectives", {})
                top = (max(cols, key=lambda k: cols[k]["wire_bytes"])
                       if cols else "-")
                lines.append(
                    f"| {arch} | {shape} | {mesh} | ok | "
                    f"{r.get('variant', '')} | {f.get('trace_s', 0):.1f} | "
                    f"{m.get('argument_bytes', 0)/2**30:.1f} | "
                    f"{m.get('temp_bytes', 0)/2**30:.1f} | "
                    f"{d.get('flops', 0):.2e} | "
                    f"{d.get('wire_bytes', 0)/2**30:.1f} | {top} |")
    lines.insert(2, f"**{n_ok}/{n_all} combinations trace.**")
    lines.insert(3, "")
    out = Path(outdir)
    if write_md:
        out.mkdir(parents=True, exist_ok=True)
        (out / "torch_dryrun_summary.md").write_text("\n".join(lines) + "\n")
    print(f"dry-run summary: {n_ok}/{n_all} ok -> "
          f"{out / 'torch_dryrun_summary.md'}")
    if records:
        out.mkdir(parents=True, exist_ok=True)
        path = out / "torch_dryrun_report.json"
        path.write_text(json.dumps({"reports": _unified_reports(records)},
                                   indent=2, default=str))
        print(f"unified reports -> {path}")
    if csv_rows is not None:
        csv_rows.append(("dryrun/ok_fraction", n_ok / max(n_all, 1),
                         f"{n_ok}/{n_all}"))
    return lines


if __name__ == "__main__":
    run()
