"""Lemma 3.2 — parameter-server sizing and the comm-time forms the
gradient-sync strategies are priced with, the overlap-aware step pricing
of bucketed sync, and the bounded-staleness / backup-worker step model
(a copy of the parts of ``repro.core.ps`` that
``distributed/collectives.py``, ``distributed/overlap.py``,
``distributed/async_ps.py`` and ``SyncReport`` call; serving's replica
lemma and the planner's ``SyncPlan`` stay in the JAX package).

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


# ---------------------------------------------------------------------------
# Bounded-staleness async PS: Lemma 3.2 with its synchrony assumption relaxed
# ---------------------------------------------------------------------------
# Eq. 7 prices ONE pull + ONE push per worker per step.  Bounded staleness
# (refresh window s) keeps the push every step but amortizes the pull over
# s+1 steps — each worker re-pulls only when its copy would exceed age s —
# so the per-step server traffic drops from 2*S_p to S_p*(1 + 1/(s+1)).
# Backup workers drop the slowest k of dp gradients: the synchronization
# barrier waits for order statistic (dp-k) instead of dp.  With exponential
# per-worker delay of mean ``mean_delay`` the expected barrier wait is
# mean_delay * (H_dp - H_k) (max of dp exponentials minus the k tail terms),
# so k > 0 shaves exactly the slow tail the paper's §2 taxonomy flags.
# Staleness is not free: stale gradients dilute progress-per-step, modeled
# as the standard hyperbolic discount 1/(1 + gamma*s) on statistical
# efficiency (Hitchhiker's-Guide-style SSP analyses).

# statistical-efficiency discount per unit staleness in 1/(1 + gamma*s);
# calibrated SSP studies put the knee near s~4-8, gamma 0.05-0.2
DEFAULT_STALENESS_GAMMA = 0.1


def _harmonic(n: int) -> float:
    """H_n = sum_{i<=n} 1/i (H_0 = 0)."""
    return sum(1.0 / i for i in range(1, max(n, 0) + 1))


def straggler_wait(dp: int, k: int, mean_delay: float) -> float:
    """Expected barrier wait [s] when the sync waits for dp-k of dp workers
    whose per-step delays are iid exponential(mean_delay).

    E[max of dp] = mean_delay * H_dp; dropping the slowest k removes the
    k largest gap terms, leaving mean_delay * (H_dp - H_k).  k = 0 is the
    full synchronous barrier, k = dp-1 waits only for the fastest worker.
    """
    if not 0 <= k < max(dp, 1):
        raise ValueError(f"need 0 <= k < dp, got k={k} dp={dp}")
    if dp <= 1 or mean_delay <= 0:
        return 0.0
    return mean_delay * (_harmonic(dp) - _harmonic(k))


def staleness_efficiency(s: int, gamma: float = DEFAULT_STALENESS_GAMMA) -> float:
    """Statistical efficiency in (0, 1]: progress per step relative to the
    synchronous baseline under bounded staleness s (1/(1 + gamma*s);
    s = 0 is exactly 1)."""
    if s < 0:
        raise ValueError(f"staleness must be >= 0, got {s}")
    return 1.0 / (1.0 + gamma * max(s, 0))


def async_step_time(s_p: float, n_w: int, n_ps: int, b_ps: float, t_c: float,
                    *, staleness: int = 0, backup_workers: int = 0,
                    mean_delay: float = 0.0,
                    gamma: float = DEFAULT_STALENESS_GAMMA) -> Dict[str, float]:
    """T_step(s, k): the bounded-staleness/backup-worker step-time model.

    Per-step PS traffic is ``push + pull/(s+1)`` (push every step, pull
    amortized over the refresh window); the barrier waits
    ``straggler_wait(dp, k, mean_delay)``; and ``effective_step`` divides
    the wall clock by :func:`staleness_efficiency` so plans that trade
    synchrony for throughput still pay the statistical-progress price.
    With ``staleness=0, backup_workers=0, mean_delay=0`` the ``io`` term is
    exactly Eq. 7's :func:`io_time` and the model degenerates to the
    synchronous lemma.
    """
    push = s_p * n_w / (n_ps * b_ps)
    pull = push / (staleness + 1)
    wait = straggler_wait(n_w, backup_workers, mean_delay)
    eff = staleness_efficiency(staleness, gamma)
    io = push + pull
    exposed_io = max(io - t_c, 0.0)
    wall = t_c + exposed_io + wait
    return {
        "t_compute": t_c,
        "io": io,
        "push": push,
        "pull": pull,
        "pull_amortization": 1.0 / (staleness + 1),
        "straggler_wait": wait,
        "efficiency": eff,
        "wall_step": wall,
        "effective_step": wall / eff,
    }
