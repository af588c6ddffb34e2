"""The mini-batch pipeline's per-step timings (the port of
``repro.core.pipeline``'s ``StepTimes``) and the two pieces of the 1F1B
model the planner prices a pipeline cut with (``pipeline_bubble``,
``balanced_stage_cut``); the 1F1B schedule and the simulators wait for
pipeline parallelism (ROADMAP Next 3).

Steps (paper Fig. 1): (1) parameter refresh, (2) data loading, (3) data
preparation, (4) host->device transfer, (5) device compute, (6) parameter
update, (7) distributed update.  Steps 2-4 are prefetched behind the
previous step's compute (double buffering).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

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


# ---------------------------------------------------------------------------
# 1F1B pipeline-parallel schedule (Fig. 1 generalized to p stages)
# ---------------------------------------------------------------------------


def pipeline_bubble(p: int, m: int) -> float:
    """Analytic bubble fraction of the non-interleaved 1F1B schedule:
    ``(p-1)/(m+p-1)`` — the fill/drain idle share with ``p`` stages and
    ``m`` microbatches, exact when every stage's fwd (resp. bwd) takes the
    same time."""
    if p <= 1:
        return 0.0
    if m < 1:
        raise ValueError(f"n_microbatch must be >= 1, got {m}")
    return (p - 1) / (m + p - 1)


def balanced_stage_cut(n_cycles: int, p: int) -> Tuple[int, ...]:
    """Contiguous cut of ``n_cycles`` layer cycles into ``p`` stages:
    boundaries ``(0, c_1, ..., n_cycles)`` of length ``p + 1``, remainder
    cycles assigned to the earliest stages."""
    if not 1 <= p <= n_cycles:
        raise ValueError(f"need 1 <= pipe <= n_cycles, got pipe={p} "
                         f"over {n_cycles} cycles")
    base, rem = divmod(n_cycles, p)
    cuts = [0]
    for s in range(p):
        cuts.append(cuts[-1] + base + (1 if s < rem else 0))
    return tuple(cuts)
