"""What every driver shares: finding a cell, its configuration and its
traffic by name; the per-layer metric readers (``bench/metrics/<name>.py``,
listed for the cell in ``BENCHMARK.json``); the process's start time; the
card's name and power limit; and the check that nothing of JAX or the JAX
package was loaded.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def load_json(path: Path) -> Dict:
    return json.loads(path.read_text())


def benchmark() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> Dict:
    return load_json(HERE / "workloads" / f"{name}.json")


def config(name: str) -> Dict:
    return load_json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> Dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def metric(name: str):
    """The reader module of per-layer metric ``name``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: Dict, workload: str, kind: str) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` entries that apply to a cell."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def process_start() -> float:
    """This process's start on the wall clock (from /proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def card() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi prints it."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def forbidden_loaded() -> List[str]:
    """Top-level names of loaded modules that must not be, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclass
class Run:
    """One run's inputs, handed to a driver."""

    workload: str
    seed: int
    seconds: float
    trace: bool
    cell: Dict
    config: Dict
    traffic: Dict
    t_start: float
    device: str = "cuda"
    faults: frozenset = frozenset()  # test faults planted in the step

    @classmethod
    def of(cls, workload: str, seed: int, seconds: float, trace: bool,
           t_start: float, **kw) -> "Run":
        c = cell(workload)
        return cls(workload, int(seed), float(seconds), bool(trace), c,
                   config(c["config"]), traffic(c["traffic"]), t_start, **kw)
