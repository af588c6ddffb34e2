"""Lemma 3.2 — parameter-server sizing and the comm-time forms the
gradient-sync strategies are priced with (a copy of the parts of
``repro.core.ps`` that ``distributed/collectives.py`` and ``SyncReport``
call; serving's replica lemma, the staleness model and the planner's
``SyncPlan`` stay in the JAX package).

Paper form:  N_ps >= 2 * S_p * N_w / (B_ps * T_C).
Units: S_p and wire bytes in bytes, B_ps / bw in bytes/s, T_C and comm
times in seconds, N_w / N_ps / dp counts.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.core.hardware import Tier

# Runnable schedules (repro_torch.distributed.collectives executes them)
SCHEDULES = ("all_reduce", "reduce_scatter_all_gather", "parameter_server",
             "hier_all_reduce")


def n_parameter_servers(s_p: float, n_w: int, b_ps: float, t_c: float) -> int:
    """Lemma 3.2 (Eq. 8), ceil'd. s_p bytes, b_ps bytes/s, t_c seconds."""
    if t_c <= 0 or b_ps <= 0:
        raise ValueError("t_c, b_ps > 0")
    return max(1, math.ceil(2.0 * s_p * n_w / (b_ps * t_c)))


def io_time(s_p: float, n_w: int, n_ps: int, b_ps: float) -> float:
    """Communication time for one pull+push round (Eq. 7 LHS)."""
    return 2.0 * s_p * n_w / (n_ps * b_ps)


def masked(s_p: float, n_w: int, n_ps: int, b_ps: float, t_c: float) -> bool:
    """True iff I/O hides behind compute (the ideal-pipeline condition)."""
    return io_time(s_p, n_w, n_ps, b_ps) <= t_c


def flat_wire_bytes(s_p: float, dp: int) -> float:
    """Per-worker wire bytes of a ring all-reduce / RS+AG over dp workers."""
    frac = (dp - 1) / dp if dp > 1 else 0.0
    return 2.0 * s_p * frac


def hier_wire_bytes(s_p: float, tier_sizes: Sequence[int]) -> Tuple[float, ...]:
    """Per-worker wire bytes at each tier of the hierarchical schedule:
    tier 0 reduce-scatters and all-gathers the full payload, tier k only
    the 1/prod(d_<k) shard that survived the inner reductions."""
    out, shard = [], s_p
    for d in tier_sizes:
        out.append(flat_wire_bytes(shard, d))
        shard /= max(d, 1)
    return tuple(out)


def hier_comm_time(s_p: float, tiers: Sequence[Tier]) -> Tuple[float, Tuple[Dict, ...]]:
    """Total comm time and the per-tier breakdown of ``hier_all_reduce``:
    the phases are sequential, so the total is the sum of per-tier times."""
    wires = hier_wire_bytes(s_p, [t.size for t in tiers])
    per_tier = tuple(
        {"tier": t.name, "size": t.size, "bw": t.bw,
         "wire_bytes": w, "time_s": w / t.bw + (t.latency if t.size > 1 else 0.0)}
        for t, w in zip(tiers, wires))
    return sum(p["time_s"] for p in per_tier), per_tier


def predicted_comm_time(schedule: str, s_p: float, dp: int, link_bw: float,
                        *, n_ps: int = 0,
                        tiers: Optional[Sequence[Tier]] = None) -> float:
    """Lemma 3.2's comm-time prediction for a runnable schedule: ring
    all-reduce and RS+AG move 2*S_p*(dp-1)/dp per worker; the sharded
    parameter server is Eq. 7's 2*S_p*N_w/(N_ps*B_ps); the hierarchical
    schedule sums its per-tier phases (without ``tiers``, one flat tier at
    ``link_bw``)."""
    if schedule == "parameter_server":
        return io_time(s_p, dp, n_ps or dp, link_bw)
    if schedule in ("all_reduce", "reduce_scatter_all_gather"):
        return flat_wire_bytes(s_p, dp) / link_bw
    if schedule == "hier_all_reduce":
        if not tiers:
            tiers = (Tier("flat", dp, link_bw),)
        return hier_comm_time(s_p, tiers)[0]
    raise KeyError(f"unknown schedule {schedule!r}; known: {SCHEDULES}")
