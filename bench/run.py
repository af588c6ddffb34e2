"""The benchmark of the PyTorch and CUDA port, one run of one cell:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``bench/workloads/<cell>.json``)
names its configuration, its traffic, its chips and its driver
(``bench/drivers/<driver>.py``).  The run loads, warms up, measures for
``--seconds``, checks the timed path against the plain reference
(``bench/reference/``), and prints one JSON line last: with ``--trace 0``
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
(readers in ``bench/metrics/``) and the device's busy time.  It exits
non-zero and prints no result without the cards the cell asks for, when
the program cannot be imported, or when a module of JAX or of the JAX
package was loaded.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
os.environ["PYTHONPATH"] = os.pathsep.join(
    [str(ROOT / "src"), str(ROOT)]
    + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])
os.environ.setdefault("USE_FLAX", "0")

from bench import harness  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result(run: harness.Run, out: dict, chips: int, kind: str) -> dict:
    """The contract's last line from a driver's output."""
    bench = harness.benchmark()
    metrics = {}
    if not run.trace:
        for m in harness.cell_metrics(bench, run.workload, "end_to_end"):
            metrics[m["name"]] = {"value": out["end_to_end"][m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in harness.cell_metrics(bench, run.workload, "per_layer"):
            value = harness.metric(m["name"]).read(out["record"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    line = {"correct": bool(out["correct"]), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if run.trace:
        profs = out["profiles"]
        device["busy_s"] = sum(p["busy_s"] for p in profs) / len(profs)
        device["window_s"] = sum(p["window_s"] for p in profs) / len(profs)
        worst = max(profs, key=lambda p: 1 - p["busy_s"] / p["window_s"])
        line["breakdown"] = {"device_ops": worst["device_ops"],
                             "idle_gaps": worst["idle_gaps"]}
    line["checks"] = out["checks"]
    return line


def main(argv=None) -> int:
    t_start = harness.process_start()
    args = parse(argv)
    run = harness.Run.of(args.workload, args.seed, args.seconds,
                         bool(args.trace), t_start)
    chips = int(run.cell["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: the cell asks for {chips} CUDA devices; "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    print(f"bench: {run.workload} seed {run.seed} on {harness.card()}",
          file=sys.stderr, flush=True)
    driver = importlib.import_module(f"bench.drivers.{run.cell['driver']}")
    out = driver.run(run)
    if run.trace and not out["profiles"]:
        print("bench: torch.profiler gave no device record in three tries",
              file=sys.stderr)
        return 3
    bad = harness.forbidden_loaded()
    if bad or out.get("forbidden"):
        print(f"bench: modules that must not load were loaded: "
              f"{sorted(set(bad) | set(out.get('forbidden', [])))}",
              file=sys.stderr)
        return 4
    line = result(run, out, chips, kind)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
