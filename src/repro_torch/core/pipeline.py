"""The mini-batch pipeline's per-step timings (the port of
``repro.core.pipeline``'s ``StepTimes``; the 1F1B schedule model and the
simulators stay in the JAX package until pipeline parallelism is ported,
ROADMAP A12).

Steps (paper Fig. 1): (1) parameter refresh, (2) data loading, (3) data
preparation, (4) host->device transfer, (5) device compute, (6) parameter
update, (7) distributed update.  Steps 2-4 are prefetched behind the
previous step's compute (double buffering).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

STEP_NAMES = (
    "param_refresh", "data_load", "data_prep", "h2d", "compute",
    "param_update", "dist_update",
)


@dataclass
class StepTimes:
    """Per-step durations (seconds) of one mini-batch round."""

    param_refresh: float = 0.0
    data_load: float = 0.0
    data_prep: float = 0.0
    h2d: float = 0.0
    compute: float = 0.0
    param_update: float = 0.0
    dist_update: float = 0.0

    def as_dict(self) -> Dict[str, float]:
        return {k: getattr(self, k) for k in STEP_NAMES}

    @property
    def t_c(self) -> float:
        return self.compute

    def overhead(self, *, pipelined: bool = True) -> float:
        """Non-hidden overhead T_O.

        Un-pipelined: every step serializes.  Pipelined: steps 2-4 prefetch
        behind the previous compute (hidden iff their sum <= T_C); steps 1,
        6, 7 serialize."""
        io = self.data_load + self.data_prep + self.h2d
        sync = self.param_refresh + self.param_update + self.dist_update
        if not pipelined:
            return io + sync
        return max(io - self.compute, 0.0) + sync

    def r_o(self, *, pipelined: bool = True) -> float:
        """The paper's R_O = T_O / T_C (Lemma 3.1)."""
        return self.overhead(pipelined=pipelined) / max(self.compute, 1e-12)
