"""The port's benchmark harness (the twin of ``benchmarks/run.py``): one
``torch_*`` twin per paper table or figure, each in this process, and one
consolidated ``name,value,derived`` CSV at the end.

    PYTHONPATH=src python -m benchmarks.torch_run [--only table2,fig2,...] \\
        [--fast] [--device cuda]
    # a CPU rehearsal: the arithmetic twins at once, the measured ones at
    # the reduced configs
    PYTHONPATH=src python -m benchmarks.torch_run --device cpu --reduced \\
        --only ilp,lemma32

It takes JAX's thirteen names in JAX's order, and ``--fast`` drops the
same ones (fig2, fig3, fig4, sync, autotune, telemetry,
serve_continuous).  Each name runs its twin's ``run(csv_rows)``:

- table2: ``torch_table2_conv_memory``; fig2:
  ``torch_fig2_throughput_vs_batch`` (``run_default``); fig3:
  ``torch_fig3_convergence``; fig4: ``torch_dp_scaling``; lemma32:
  ``torch_lemma32_ps_sizing``; sync: ``torch_sync_strategies``; sweep:
  ``torch_sweep``; autotune: ``torch_autotune``; ilp:
  ``torch_ilp_planner``; telemetry: ``torch_telemetry``;
  serve_continuous: ``torch_serve_continuous``.
- dryrun: ``torch_dryrun_summary``; roofline: ``torch_roofline``.  Both
  read the port's dry-run records (``results/torch_dryrun/``, written by
  ``python -m repro_torch.launch.dryrun``); with none there they render
  empty tables.  An unknown name is an error.

The measured twins run on ``--device`` (the card unless the caller asks
for the CPU, where ``--reduced`` picks the reduced configs); the harness
appends no ``BENCH_torch_*.json`` record (the telemetry and serve cells
do that from their own command lines).  A twin that fails raises: no
name is skipped.
"""
from __future__ import annotations

import argparse
import importlib.util
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

ALL = ("table2", "fig2", "fig3", "fig4", "lemma32", "sync", "sweep",
       "autotune", "ilp", "dryrun", "roofline", "telemetry",
       "serve_continuous")
SLOW = ("fig2", "fig3", "fig4", "sync", "autotune", "telemetry",
        "serve_continuous")
DEFAULT = ALL


def _twin(name: str):
    """The ``benchmarks/<name>.py`` module, loaded from its file (the twins
    are scripts, run as ``python benchmarks/x.py`` or ``-m
    benchmarks.x``)."""
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entries(device: str, reduced: bool):
    """name -> a callable taking ``csv_rows``."""
    dev = {"device": device}
    both = {"device": device, "reduced": reduced}
    return {
        "table2": lambda rows: _twin("torch_table2_conv_memory").run(
            rows, **dev),
        "fig2": lambda rows: _twin("torch_fig2_throughput_vs_batch")
        .run_default(rows, **dev),
        "fig3": lambda rows: _twin("torch_fig3_convergence").run(rows, **dev),
        "fig4": lambda rows: _twin("torch_dp_scaling").run(rows, **both),
        "lemma32": lambda rows: _twin("torch_lemma32_ps_sizing").run(rows),
        "sync": lambda rows: _twin("torch_sync_strategies").run(rows, **both),
        "sweep": lambda rows: _twin("torch_sweep").run(rows, **dev),
        "autotune": lambda rows: _twin("torch_autotune").run(rows, **both),
        "ilp": lambda rows: _twin("torch_ilp_planner").run(rows),
        "dryrun": lambda rows: _twin("torch_dryrun_summary").run(rows),
        "roofline": lambda rows: _twin("torch_roofline").run(rows),
        "telemetry": lambda rows: _twin("torch_telemetry").run(rows, **both),
        "serve_continuous": lambda rows: _twin("torch_serve_continuous").run(
            rows, **both),
    }


def select(only: str, fast: bool) -> list:
    """The names to run: ``only`` in its order, less the slow ones under
    ``fast``; an unknown name raises."""
    which = [w.strip() for w in only.split(",") if w.strip()]
    for name in which:
        if name not in ALL:
            raise ValueError(f"unknown benchmark {name!r}; known: "
                             f"{', '.join(DEFAULT)}")
    if fast:
        which = [w for w in which if w not in SLOW]
    return which


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=",".join(DEFAULT))
    ap.add_argument("--fast", action="store_true",
                    help="skip the slow measured benchmarks (" +
                         ", ".join(SLOW) + ")")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced configs (a CPU rehearsal)")
    args = ap.parse_args(argv)
    which = select(args.only, args.fast)
    card = "cpu (no device numbers)"
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("torch_run: --device cuda but no card is "
                             "visible; pass --device cpu --reduced")
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    run = entries(args.device, args.reduced)
    csv_rows: list = []
    t0 = time.time()
    for name in which:
        run[name](csv_rows)
    print(f"\n== consolidated CSV ({time.time()-t0:.0f}s total; {card}) ==")
    print("name,value,derived")
    for name, value, derived in csv_rows:
        print(f"{name},{value},{derived}")
    return csv_rows


if __name__ == "__main__":
    main()
