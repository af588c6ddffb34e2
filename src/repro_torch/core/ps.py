"""Lemma 3.2 — parameter-server sizing, the comm-time forms the
gradient-sync strategies are priced with, the tier-aware placement of the
servers, the lemma as a decision (``grad_sync_plan``, which schedule masks
behind T_C on a topology), the overlap-aware step pricing of bucketed
sync, the bounded-staleness / backup-worker step model, and the serving
form of the lemma (replicas against a latency SLO): a copy of
``repro.core.ps``.

Paper form:  N_ps >= 2 * S_p * N_w / (B_ps * T_C).
Units: S_p and wire bytes in bytes, B_ps / bw in bytes/s, T_C and comm
times in seconds, N_w / N_ps / dp counts.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.core.hardware import ClusterSpec, Tier

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


# ---------------------------------------------------------------------------
# Tier-aware Lemma 3.2: B_ps depends on where the servers sit
# ---------------------------------------------------------------------------

PS_PLACEMENTS = ("in_node", "cross_node")


def ps_placement_bw(cluster: ClusterSpec, placement: str) -> float:
    """The ``B_ps`` a parameter server sees on this cluster.

    ``in_node``: the PS shard is colocated with its workers' node, so
    push/pull rides the innermost (fastest) tier.  ``cross_node``: the PS
    pool lives across the slow tier (the paper's dedicated-PS deployment),
    so every byte crosses the narrowest spanning link.
    """
    if placement == "in_node":
        return cluster.tiers[0].bw
    if placement == "cross_node":
        return cluster.min_bw
    raise KeyError(f"unknown placement {placement!r}; known: {PS_PLACEMENTS}")


def n_parameter_servers_tiered(s_p: float, n_w: int, cluster: ClusterSpec,
                               t_c: float, *,
                               placement: str = "cross_node") -> int:
    """Lemma 3.2 with ``B_ps`` read off the topology tier the servers sit
    on, instead of a flat scalar."""
    return n_parameter_servers(s_p, n_w, ps_placement_bw(cluster, placement),
                               t_c)


def ps_placement_plan(s_p: float, n_w: int, cluster: ClusterSpec,
                      t_c: float) -> Dict[str, Dict[str, float]]:
    """Both Lemma 3.2 regimes side by side: the N_ps you need when servers
    are in-node vs across the slow tier, and which placement is cheaper
    (fewer servers for the same maskability)."""
    out: Dict[str, Dict[str, float]] = {}
    for placement in PS_PLACEMENTS:
        bw = ps_placement_bw(cluster, placement)
        n_ps = n_parameter_servers(s_p, n_w, bw, t_c)
        out[placement] = {
            "b_ps": bw,
            "n_ps": n_ps,
            "io_time_s": io_time(s_p, n_w, n_ps, bw),
        }
    out["recommended"] = min(
        PS_PLACEMENTS, key=lambda p: out[p]["n_ps"])  # type: ignore[assignment]
    return out


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


@dataclass(frozen=True)
class SyncPlan:
    schedule: str  # one of SCHEDULES (PS only via explicit request)
    comm_time: float
    compute_time: float
    masked: bool
    note: str
    bottleneck_tier: str = ""
    per_tier: Tuple[Dict, ...] = field(default_factory=tuple)


def tpu_grad_sync_plan(param_bytes: float, dp: int, link_bw: float,
                       t_c: float, *, zero_sharded: bool = True) -> SyncPlan:
    """Lemma 3.2 on the TPU data axis.

    all-reduce moves ~2*S_p*(dp-1)/dp per chip; reduce-scatter + all-gather
    moves the same wire bytes but splits the optimizer work 1/dp per chip
    (the ZeRO '"N_ps = dp parameter servers'" mapping) and lets the
    all-gather overlap the next step's first layers.
    """
    wire = flat_wire_bytes(param_bytes, dp)
    comm = wire / link_bw
    schedule = "reduce_scatter_all_gather" if zero_sharded else "all_reduce"
    return SyncPlan(
        schedule=schedule,
        comm_time=comm,
        compute_time=t_c,
        masked=comm <= t_c,
        note=(f"wire {wire/1e9:.2f} GB over dp={dp}; "
              + ("hidden behind compute" if comm <= t_c else
                 "NOT maskable - increase T_C (bigger microbatch) or shrink S_p")),
    )


def grad_sync_plan(param_bytes: float, dp_tiers: Sequence[Tier], t_c: float,
                   *, zero_sharded: bool = True) -> SyncPlan:
    """Tier-aware Lemma 3.2: pick the cheapest schedule for this topology.

    On a uniform (single spanning tier) view this reduces exactly to
    :func:`tpu_grad_sync_plan`.  On a hierarchy it prices the flat ring at
    the bottleneck bandwidth against the hierarchical reduce/exchange/
    broadcast and returns whichever masks better, with the per-tier
    breakdown and the bottleneck tier named either way.
    """
    spanning = [t for t in dp_tiers if t.size > 1]
    dp = math.prod(t.size for t in dp_tiers) if dp_tiers else 1
    if len(spanning) <= 1:
        bw = spanning[0].bw if spanning else dp_tiers[0].bw
        flat = tpu_grad_sync_plan(param_bytes, dp, bw, t_c,
                                  zero_sharded=zero_sharded)
        lat = spanning[0].latency if spanning else 0.0
        if lat:
            comm = flat.comm_time + lat
            flat = dataclasses.replace(flat, comm_time=comm,
                                       masked=comm <= t_c)
        name = spanning[0].name if spanning else dp_tiers[0].name
        return dataclasses.replace(flat, bottleneck_tier=name)

    min_bw = min(t.bw for t in spanning)
    # the flat ring spans every tier, so it pays each spanning tier's
    # latency too — without this the comparison would be biased flat-ward
    flat_time = (flat_wire_bytes(param_bytes, dp) / min_bw
                 + sum(t.latency for t in spanning))
    hier_time, per_tier = hier_comm_time(param_bytes, dp_tiers)
    if hier_time < flat_time:
        bottleneck = max((p for p in per_tier if p["size"] > 1),
                         key=lambda p: p["time_s"])["tier"]
        return SyncPlan(
            schedule="hier_all_reduce",
            comm_time=hier_time,
            compute_time=t_c,
            masked=hier_time <= t_c,
            note=(f"hierarchical {'x'.join(str(t.size) for t in dp_tiers)}: "
                  f"{hier_time:.3f}s vs flat {flat_time:.3f}s at bottleneck "
                  f"tier '{bottleneck}'; "
                  + ("hidden behind compute" if hier_time <= t_c
                     else "NOT maskable")),
            bottleneck_tier=bottleneck,
            per_tier=per_tier,
        )
    flat = tpu_grad_sync_plan(param_bytes, dp, min_bw, t_c,
                              zero_sharded=zero_sharded)
    if flat_time != flat.comm_time:  # carry the latency hops priced above
        flat = dataclasses.replace(flat, comm_time=flat_time,
                                   masked=flat_time <= t_c)
    bottleneck = min(spanning, key=lambda t: t.bw).name
    return dataclasses.replace(flat, bottleneck_tier=bottleneck)


# ---------------------------------------------------------------------------
# Lemma 3.2 for inference — replica sizing against a latency SLO
# ---------------------------------------------------------------------------
# The training lemma sizes servers so I/O hides behind compute.  Serving has
# the same structure with the roles renamed: the "step time" is one decode
# step (HBM-bound weight + KV traffic), the "budget" is the latency SLO, and
# the sized resource is replicas instead of parameter servers.
#
# Model: each replica is an M/D/1 queue (Poisson arrivals at rate
# lambda/N_rep, deterministic service T_svc / batch).  Mean wait
# W_q = rho * T_svc / (2 * (1 - rho)); requiring W_q <= slack = SLO - T_svc
# gives the utilization ceiling rho* = x / (1 + x) with x = 2*slack/T_svc,
# and hence  N_rep = ceil(lambda * T_svc / (batch * rho*)).


def decode_step_time(param_bytes: float, kv_bytes: float, hbm_bw: float) -> float:
    """One decode step is HBM-bound: stream weights + resident KV once.
    param_bytes/kv_bytes in bytes, hbm_bw in bytes/s -> seconds."""
    if hbm_bw <= 0:
        raise ValueError("hbm_bw > 0")
    return (param_bytes + kv_bytes) / hbm_bw


def service_time(t_prefill: float, n_new: int, t_step: float) -> float:
    """End-to-end service time for one request: prefill + n_new decode steps.
    (The prefill samples the first token, so n_new-1 further steps would be
    exact; we keep n_new as a half-step of slack for sampling overhead.)"""
    return t_prefill + n_new * t_step


def md1_wait(rho: float, t_svc: float) -> float:
    """M/D/1 mean queueing delay at utilization rho (0 <= rho < 1)."""
    if not 0 <= rho < 1:
        raise ValueError("0 <= rho < 1")
    return rho * t_svc / (2.0 * (1.0 - rho))


def serve_utilization_bound(slo_s: float, t_svc: float) -> float:
    """Largest per-replica utilization rho* with W_q(rho*) <= SLO - T_svc.
    Returns 0.0 when the SLO is not attainable even on an idle replica
    (slack <= 0) -- callers must treat 0 as "no finite replica count"."""
    slack = slo_s - t_svc
    if slack <= 0 or t_svc <= 0:
        return 0.0
    x = 2.0 * slack / t_svc
    return x / (1.0 + x)


def n_replicas(arrival_rate: float, t_svc: float, batch: int,
               rho_star: float) -> int:
    """Replica count so each replica runs at <= rho*; ceil'd like Eq. 8."""
    if rho_star <= 0:
        raise ValueError("SLO unattainable: rho* <= 0")
    per_replica = batch * rho_star / t_svc  # sustainable req/s per replica
    return max(1, math.ceil(arrival_rate / per_replica))


def serve_replica_plan(*, arrival_rate: float, t_prefill_s: float,
                       t_step_s: float, n_new: int, batch: int,
                       slo_s: float) -> Dict[str, object]:
    """The inference lemma as a decision, JSON-safe (no inf/nan).

    arrival_rate in requests/s offered to the fleet; slo_s is the p-mean
    end-to-end latency target.  Returns predicted replicas, the service
    time, the utilization ceiling, and whether the SLO is attainable at
    all (slack > 0).
    """
    t_svc = service_time(t_prefill_s, n_new, t_step_s)
    rho_star = serve_utilization_bound(slo_s, t_svc)
    attainable = rho_star > 0
    replicas = n_replicas(arrival_rate, t_svc, batch, rho_star) if attainable else 0
    plan: Dict[str, object] = {
        "t_service_s": t_svc,
        "t_step_s": t_step_s,
        "utilization_bound": rho_star,
        "replicas": replicas,
        "attainable": attainable,
        "arrival_rate": arrival_rate,
        "slo_s": slo_s,
    }
    if attainable:
        rho = arrival_rate * t_svc / (batch * replicas)
        plan["utilization"] = rho
        plan["wait_s"] = md1_wait(min(rho, rho_star), t_svc)
    return plan
