"""Lemma 3.2 — parameter-server sizing and the comm-time forms the
gradient-sync strategies are priced with, and the overlap-aware step
pricing of bucketed sync (a copy of the parts of ``repro.core.ps`` that
``distributed/collectives.py``, ``distributed/overlap.py`` and
``SyncReport`` call; serving's replica lemma, the staleness model and the
planner's ``SyncPlan`` stay in the JAX package).

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


# ---------------------------------------------------------------------------
# Overlap-aware step pricing (bucketed comm/compute pipelining)
# ---------------------------------------------------------------------------

# fraction of the compute step spent in the forward pass under the standard
# 1:2 fwd:bwd FLOP split (the backward differentiates both matmul operands)
FWD_FRACTION = 1.0 / 3.0

# Default sync-bucket payload target (MiB) shared by the cost model and the
# executable bucketing (repro_torch.distributed.overlap imports it from here —
# core stays import-light and never imports distributed).
DEFAULT_BUCKET_MB = 4.0


def bucket_count(grad_bytes: float, bucket_mb: float) -> int:
    """Size-level sync-bucket count: ceil(payload / cap).

    The executable leaf-level plan (``repro_torch.distributed.overlap.
    build_bucket_plan``) packs whole leaves under the same cap, so its
    bucket count is >= this (unless a single leaf exceeds the cap on its
    own) — the modeled hideable window ``(n-1)/n`` stays a conservative
    estimate of the real schedule's granularity."""
    mb = bucket_mb if bucket_mb > 0 else DEFAULT_BUCKET_MB
    if grad_bytes <= 0:
        return 1
    return max(math.ceil(grad_bytes / (mb * 2.0 ** 20)), 1)


def overlap_exposed_comm(t_comm: float, t_bwd: float, n_buckets: int, *,
                         overlap_efficiency: float = 1.0) -> float:
    """Comm time left *outside* compute after bucketed overlap [s].

    With ``n_buckets`` dependency-ordered sync buckets, the first bucket's
    gradients are ready after ~``t_bwd / n_buckets`` of the backward pass,
    so up to ``t_bwd * (n_buckets - 1) / n_buckets`` of backward compute can
    hide collectives (Shi et al.'s wait-free backpropagation window).
    ``overlap_efficiency`` in [0, 1] derates the window to the *achieved*
    overlap (``SyncReport.overlap_fraction``, calibrated by the autotuner);
    0 — or a single bucket, whose gradients only complete with the backward
    itself — degrades exactly to the serial ``t_comm``.
    """
    if t_comm <= 0:
        return 0.0
    if n_buckets <= 1 or overlap_efficiency <= 0 or t_bwd <= 0:
        return t_comm
    window = t_bwd * (n_buckets - 1) / n_buckets
    window *= min(max(overlap_efficiency, 0.0), 1.0)
    return max(t_comm - window, 0.0)


def overlap_step_time(t_fwd: float, t_bwd: float, t_comm: float,
                      n_buckets: int, *,
                      overlap_efficiency: float = 1.0) -> Dict[str, float]:
    """The overlapped step-time model (units: seconds):

        T_step = T_fwd + max(T_bwd, T_bwd_tail + T_comm * (1 - f) ...)
               = T_fwd + T_bwd + T_exposed

    where ``T_exposed = max(T_comm - window, 0)`` with the hideable window
    ``(T_bwd - T_bwd/n) * efficiency`` — comm launched per bucket as its
    gradients complete, only the residual sticking out past the backward.
    Returns the breakdown; ``total`` with ``n_buckets <= 1`` or zero
    efficiency is exactly the serial ``T_fwd + T_bwd + T_comm``.
    """
    exposed = overlap_exposed_comm(t_comm, t_bwd, n_buckets,
                                   overlap_efficiency=overlap_efficiency)
    hidden = t_comm - exposed
    return {
        "t_fwd": t_fwd, "t_bwd": t_bwd, "t_comm": t_comm,
        "n_buckets": float(max(n_buckets, 1)),
        "hidden_comm": hidden, "exposed_comm": exposed,
        "overlap_fraction": hidden / t_comm if t_comm > 0 else 0.0,
        "total": t_fwd + t_bwd + exposed,
    }
