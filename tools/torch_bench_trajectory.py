"""bench-trajectory for the PyTorch/CUDA port — its per-run performance
record (the twin of ``tools/bench_trajectory.py``).

Each run of ``benchmarks/torch_telemetry.py`` and
``benchmarks/torch_serve_continuous.py`` appends one record to
``BENCH_torch_train.json`` or ``BENCH_torch_serve.json``: headline
numbers (step time, tokens/s, overlap fraction, serve p99) plus the
commit, and the card's name and power limit in the ``note``.  The
compare mode prices the newest record against the previous one under a
per-metric regression budget: within budget passes, over budget warns
(``--warn-only``) or fails.

    # append a record distilled from a Report JSON
    PYTHONPATH=src python tools/torch_bench_trajectory.py append \\
        --area serve --report results/torch_serve_continuous_report.json \\
        [--sha 1a2b3c4] [--note "NVIDIA H100 80GB HBM3, 700.00 W"] [--root DIR]

    # compare the last two records (exit 1 on an over-budget regression)
    python tools/torch_bench_trajectory.py compare --area serve [--warn-only]

The schema (``repro.obs/bench-trajectory/v1``), the record's shape, the
headline metrics and the 35% budget are the JAX tool's; only the file
names differ, so either package's records read the same way.  Reports
are checked with ``repro_torch.api.validate_report``.  The tool starts
no process: the commit comes from ``--sha`` or is read from ``.git``
(``HEAD``, then the ref file or ``packed-refs``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

REPO = Path(__file__).resolve().parent.parent

TRAJECTORY_SCHEMA_ID = "repro.obs/bench-trajectory/v1"

# area -> headline metrics under budget: {name: direction}, where "down"
# means smaller is better (regression = increase) and "up" the reverse
HEADLINE = {
    "train": {"step_time_s": "down", "tokens_per_s": "up"},
    "serve": {"decode_p99_s": "down", "tokens_per_s": "up"},
}
DEFAULT_BUDGET = 0.35  # fractional regression allowed on a headline metric
SPEC_KEYS = ("arch", "reduced", "steps", "batch", "seq", "dp", "sync_overlap",
             "staleness", "backup_workers", "requests", "n_new",
             "serve_mode")


def git_sha(root: Path = REPO) -> str:
    """The short commit of ``root``'s checkout, read from ``.git`` without
    running git; "unknown" where there is no readable ``.git``."""
    git = root / ".git"
    try:
        head = (git / "HEAD").read_text().strip()
        if not head.startswith("ref: "):
            return head[:7]
        ref = head[5:]
        ref_file = git / ref
        if ref_file.is_file():
            return ref_file.read_text().strip()[:7]
        for line in (git / "packed-refs").read_text().splitlines():
            parts = line.split()
            if len(parts) == 2 and parts[1] == ref:
                return parts[0][:7]
    except OSError:
        pass
    return "unknown"


def trajectory_path(area: str, root: Path = REPO) -> Path:
    return Path(root) / f"BENCH_torch_{area}.json"


def load_trajectory(area: str, root: Path = REPO) -> Dict[str, Any]:
    p = trajectory_path(area, root)
    if not p.exists():
        return {"schema": TRAJECTORY_SCHEMA_ID, "area": area, "records": []}
    d = json.loads(p.read_text())
    if d.get("schema") != TRAJECTORY_SCHEMA_ID:
        raise SystemExit(f"{p}: schema {d.get('schema')!r} != "
                         f"{TRAJECTORY_SCHEMA_ID!r}")
    return d


def save_trajectory(area: str, d: Dict[str, Any], root: Path = REPO) -> Path:
    p = trajectory_path(area, root)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(d, indent=2) + "\n")
    return p


# ---------------------------------------------------------------------------
# Record distillation: Report JSON -> one flat trajectory record (JAX's)
# ---------------------------------------------------------------------------


def _train_record(rep: Dict[str, Any]) -> Dict[str, float]:
    m = rep["measured"]
    st = m.get("step_times_mean", {})
    out = {
        "step_time_s": (st.get("compute", 0.0) + st.get("dist_update", 0.0)
                        + st.get("param_update", 0.0)),
        "tokens_per_s": float(m["tokens_per_s"]),
        "r_o": float(m.get("r_o", 0.0)),
    }
    sync = m.get("sync") or {}
    if sync.get("sync_overlap"):
        out["overlap_fraction"] = float(sync["overlap_fraction"])
        out["exposed_comm_s"] = float(sync["exposed_comm_time"])
    return out


def _serve_record(rep: Dict[str, Any]) -> Dict[str, float]:
    m = rep["measured"]
    hists = (m.get("metrics") or {}).get("histograms", {})
    decode = hists.get("serve/decode_s", {})
    prefill = hists.get("serve/prefill_s", {})
    out = {
        "tokens_per_s": float(m["tokens_per_s"]),
        "wall_s": float(m.get("wall_s", 0.0)),
        "decode_p99_s": float(decode.get("p99", 0.0)),
        "prefill_p99_s": float(prefill.get("p99", 0.0)),
        "requests": float(m.get("requests", 0)),
    }
    sv = m.get("serving") or {}
    if sv:  # serving/v1 section: record the SLO-facing distribution too
        out["latency_p99_s"] = float(sv["latency_s"]["p99"])
        out["wasted_decode_steps"] = float(
            sv["throughput"]["wasted_decode_steps"])
        out["kv_peak_occupancy"] = float(sv["kv_cache"]["peak_occupancy"])
    return out


DISTILL = {"train": _train_record, "serve": _serve_record}


def append_record(area: str, report: Union[str, Path, Dict[str, Any]], *,
                  root: Path = REPO, sha: Optional[str] = None,
                  note: str = "") -> Dict[str, Any]:
    """Validate ``report`` (a Report dict or the path of its JSON), distil
    it and append the record to ``root``'s ``BENCH_torch_<area>.json``."""
    rep = (report if isinstance(report, dict)
           else json.loads(Path(report).read_text()))
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.api import validate_report

    validate_report(rep)
    record: Dict[str, Any] = {
        "sha": sha or git_sha(),
        "created": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "kind": rep["kind"],
        "spec": {k: rep["spec"].get(k) for k in SPEC_KEYS},
        "metrics": DISTILL[area](rep),
    }
    if note:
        record["note"] = note
    d = load_trajectory(area, root)
    d["records"].append(record)
    save_trajectory(area, d, root)
    return record


# ---------------------------------------------------------------------------
# Comparison: newest record vs its predecessor, headline budget (JAX's)
# ---------------------------------------------------------------------------


def compare(area: str, *, budget: float = DEFAULT_BUDGET,
            root: Path = REPO) -> List[str]:
    """Return over-budget regression messages ([] = within budget)."""
    records = load_trajectory(area, root)["records"]
    name = f"BENCH_torch_{area}"
    if len(records) < 2:
        print(f"{name}: {len(records)} record(s), nothing to compare")
        return []
    prev, cur = records[-2], records[-1]
    if prev.get("spec") != cur.get("spec"):
        print(f"{name}: spec changed between records "
              f"({prev.get('sha')} -> {cur.get('sha')}), comparison skipped")
        return []
    regressions: List[str] = []
    for metric, direction in HEADLINE[area].items():
        a = float(prev["metrics"].get(metric, 0.0))
        b = float(cur["metrics"].get(metric, 0.0))
        if a <= 0.0:  # metric's first landing (or degenerate): inform only
            print(f"{name}/{metric}: no baseline ({a} -> {b})")
            continue
        delta = (b - a) / a
        regressed = delta > budget if direction == "down" \
            else delta < -budget
        arrow = f"{a:.6g} -> {b:.6g} ({delta:+.1%})"
        if regressed:
            regressions.append(
                f"{name}/{metric}: {arrow} exceeds the "
                f"{budget:.0%} budget ({'lower' if direction == 'down' else 'higher'}"
                " is better)")
        else:
            print(f"{name}/{metric}: {arrow} ok")
    return regressions


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    ap_a = sub.add_parser("append", help="distill a Report into a record")
    ap_a.add_argument("--area", required=True, choices=sorted(HEADLINE))
    ap_a.add_argument("--report", required=True,
                      help="Report JSON to distill (must validate)")
    ap_a.add_argument("--sha", default="", help="override the commit")
    ap_a.add_argument("--note", default="",
                      help="free text; the card's name and power limit")
    ap_c = sub.add_parser("compare", help="newest record vs predecessor")
    ap_c.add_argument("--area", required=True, choices=sorted(HEADLINE))
    ap_c.add_argument("--budget", type=float, default=DEFAULT_BUDGET,
                      help=f"fractional regression budget "
                           f"(default {DEFAULT_BUDGET})")
    ap_c.add_argument("--warn-only", action="store_true",
                      help="report over-budget regressions but exit 0")
    for p in (ap_a, ap_c):
        p.add_argument("--root", default=str(REPO),
                       help="directory of the BENCH_torch_*.json files")
    args = ap.parse_args(argv)
    root = Path(args.root)

    if args.cmd == "append":
        rec = append_record(args.area, args.report, root=root,
                            sha=args.sha or None, note=args.note)
        print(f"BENCH_torch_{args.area}: appended {rec['sha']} "
              f"{json.dumps(rec['metrics'])}")
        return 0

    regressions = compare(args.area, budget=args.budget, root=root)
    for r in regressions:
        print(("WARN " if args.warn_only else "FAIL ") + r, file=sys.stderr)
    return 0 if (not regressions or args.warn_only) else 1


if __name__ == "__main__":
    sys.exit(main())
