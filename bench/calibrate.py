"""Readings that the limits of ``correct`` are set from, at a cell's own
size, in one process:

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--out FILE]

For each seed of ``--seeds``: the program's three compared steps against
the reference (the run's own comparison, with no window).  For each seed
of ``--control-seeds``: the control (the reference one precision below
the configuration's, ``reference/model.py::CONTROL``: TF32 operands for
fp32) and the
half-batch fault (the reference on the first half of each batch's rows)
and, on a cell of several cards, the exchange left out (the reference on
rank 0's rows alone: the gradient rank 0 keeps without the all-reduce),
each in the program's place against the fp32 reference; these run on one
card.  A state left
unchanged reads 1 on ``grad_gap`` and ``update_gap`` by construction and
is not run.  One JSON line per reading.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from bench import check, harness  # noqa: E402
from bench.drivers import shared  # noqa: E402
from bench.reference.model import CONTROL  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    lines = []

    def emit(kind, seed, values):
        line = json.dumps({"workload": args.workload, "kind": kind,
                           "seed": seed, **values})
        print(line, flush=True)
        lines.append(line)

    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl = [int(s) for s in args.control_seeds.split(",") if s]
    print(f"calibrate: {harness.card()}", file=sys.stderr, flush=True)
    for seed in seeds:
        run = harness.Run.of(args.workload, seed, 0.0, False, time.time())
        driver = importlib.import_module(
            f"bench.drivers.{run.cell['driver']}")
        out = driver.run(run)
        prog, ref = out["readings"]["program"], out["readings"]["reference"]
        emit("program", seed, dict(
            check.readings(prog, ref, int(run.cell["loss_steps"])),
            losses=[prog["losses"], ref["losses"]],
            worst=check.worst_leaves(prog, ref)))
        del out
        shared.free_device()
    for seed in ctl:
        run = harness.Run.of(args.workload, seed, 0.0, False, time.time())
        batch = int(run.traffic["batch"])
        ref = shared.reference(run, "cuda", batch=batch)
        kind = CONTROL[run.config["model"]["dtype"]]
        ctl = shared.reference(run, "cuda", batch=batch, numerics=kind)
        emit("control_" + kind, seed, dict(
            check.readings(ctl, ref, int(run.cell["loss_steps"])),
            losses=[ctl["losses"], ref["losses"]],
            worst=check.worst_leaves(ctl, ref)))
        shared.free_device()
        n = int(run.cell["loss_steps"])
        emit("half_batch", seed, check.readings(
            shared.reference(run, "cuda", batch=batch,
                             rows=list(range(batch // 2))), ref, n))
        shared.free_device()
        chips = int(run.cell["chips"])
        if chips > 1:  # rank 0 keeping its own gradient: its rows alone
            emit("no_exchange", seed, check.readings(
                shared.reference(run, "cuda", batch=batch,
                                 rows=list(range(batch // chips))), ref, n))
            shared.free_device()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write("".join(line + "\n" for line in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
