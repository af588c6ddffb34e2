"""Shared helpers of the benchmark's tests: small copies of the cells'
configurations that a CPU holds, and the repository on the import path."""
from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

TINY = {
    "attn": dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                 head_dim=16, d_ff=128, vocab_size=300),
    "mamba": dict(num_layers=2, d_model=64, ssm_state=16, ssm_head_dim=16,
                  ssm_chunk=16, vocab_size=300),
}


def tiny_run(workload: str, *, seed: int = 2 ** 33 + 5, faults=(),
             batch: int = 2, seq: int = 64, chips: int = 0):
    """The cell's Run at a CPU size: the configuration's widths cut (and
    listed as reduced), a small batch and sequence."""
    from bench import harness

    r = harness.Run.of(workload, seed, 0.2, False, time.time(), device="cpu",
                       faults=frozenset(faults))
    r.config = copy.deepcopy(r.config)
    model = TINY[r.config["mixer"]]
    r.config["model"].update(model)
    r.config["reduced"] = sorted(set(model) | set(r.config["reduced"]))
    r.traffic = dict(r.traffic, batch=batch, seq=seq, shard_tokens=4096)
    r.cell = dict(r.cell, reference_rows=max(batch // 2, 1))
    if chips:
        r.cell["chips"] = chips
    return r


@pytest.fixture
def cuda():
    """Skip unless a CUDA device is visible (decided here, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
