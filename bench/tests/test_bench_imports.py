"""What the benchmark runs loads neither JAX nor the JAX package nor
``benchmarks/``, and the reference loads nothing of the program: checked
in a fresh interpreter, by top-level module names compared whole."""
from __future__ import annotations

import json
import subprocess
import sys

from conftest import ROOT

PROBE = """
import importlib, json, sys
from pathlib import Path
sys.path[:0] = [{src!r}, {root!r}]
for name in {mods!r}:
    importlib.import_module(name)
from bench import harness
for p in sorted((Path({root!r}) / "bench" / "metrics").glob("*.py")):
    harness.metric(p.stem)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(mods):
    code = PROBE.format(src=str(ROOT / "src"), root=str(ROOT), mods=mods)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax_nor_the_jax_package():
    tops = loaded(["bench.run", "bench.drivers.train", "bench.drivers.train_dp",
                   "bench.calibrate", "repro_torch.api",
                   "repro_torch.distributed.trainer",
                   "repro_torch.data.pipeline"])
    assert "repro_torch" in tops and "bench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def test_the_reference_loads_nothing_of_the_program():
    tops = loaded(["bench.reference.model", "bench.reference.train"])
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax",
                       "benchmarks"}
