"""The 7-step mini-batch pipeline (paper Fig. 1) — timing model and
simulator (a copy of ``repro.core.pipeline``, which the port does not
import).

Steps: (1) parameter refresh, (2) data loading, (3) data preparation,
(4) host->device transfer, (5) device compute, (6) parameter update,
(7) distributed update.  Step 5 is compute T_C; the pipeline hides steps
2-4 behind step 5 of the previous batch (double buffering) and steps 6-7
behind the next step's early layers when the sync plan allows.

Used in three places: measuring R_O from real timings (the train loop
emits per-step durations), simulating multi-device speedup for Fig. 4
(:func:`multi_device_speedup`), and feeding Lemma 3.1/3.2 in the planner.

The second half is the *pipeline-parallel* schedule model: a
non-interleaved 1F1B schedule over ``p`` stages and ``m`` microbatches,
its analytic bubble fraction ``(p-1)/(m+p-1)``, and an event-driven
simulator that replays measured per-op times through the schedule's
dependency DAG.  The executable counterpart is
``repro_torch.distributed.pipeline.PipelineTrainer``, which replays its
traced per-(stage, microbatch) span durations through
:func:`simulate_1f1b` to set the measured bubble against the model.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

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
        6, 7 serialize unless the distributed-update plan masks them.
        """
        io = self.data_load + self.data_prep + self.h2d
        sync = self.param_refresh + self.param_update + self.dist_update
        if not pipelined:
            return io + sync
        return max(io - self.compute, 0.0) + sync

    def r_o(self, *, pipelined: bool = True) -> float:
        """The paper's R_O = T_O / T_C."""
        return self.overhead(pipelined=pipelined) / max(self.compute, 1e-12)


def simulate_epoch(times: StepTimes, n_batches: int, *, pipelined: bool = True,
                   jitter: float = 0.0, seed: int = 0) -> float:
    """Wall-clock of n_batches rounds under the pipeline model. ``jitter``
    adds lognormal noise to each step (the paper notes real overheads are
    stochastic while the lemma treats R_O as constant)."""
    import random

    rng = random.Random(seed)

    def j(x: float) -> float:
        if jitter <= 0 or x == 0:
            return x
        return x * rng.lognormvariate(0.0, jitter)

    total = 0.0
    first_io = None
    for i in range(n_batches):
        io = j(times.data_load) + j(times.data_prep) + j(times.h2d)
        sync = j(times.param_refresh) + j(times.param_update) + j(times.dist_update)
        comp = j(times.compute)
        if not pipelined:
            total += io + comp + sync
            continue
        if first_io is None:
            first_io = io
            total += io  # pipeline warm-up: first batch's data is not hidden
        # double buffering: batch i+1's I/O overlaps batch i's compute;
        # sync steps serialize after compute (unless a SyncPlan masks them)
        total += max(io, comp) + sync
    return total


def multi_device_speedup(times: StepTimes, g: int, *, bus_shared: bool = True,
                         pipelined: bool = True) -> float:
    """Fig. 4 'actual' model: with G devices the compute splits G ways, but
    shared-bus steps (2-4) scale their demand by G, and parameter traffic
    (1, 6, 7) grows with G. Returns speedup vs G=1."""
    t1 = simulate_epoch(times, 64, pipelined=pipelined)
    scaled = StepTimes(
        param_refresh=times.param_refresh * (g if bus_shared else 1),
        data_load=times.data_load * g if bus_shared else times.data_load,
        data_prep=times.data_prep,  # CPU-bound, assume enough cores
        h2d=times.h2d * g if bus_shared else times.h2d,
        compute=times.compute,  # per-device batch kept constant (weak scaling)
        param_update=times.param_update * (g if bus_shared else 1),
        dist_update=times.dist_update,
    )
    tg = simulate_epoch(scaled, 64, pipelined=pipelined)
    # weak scaling: G devices process G batches in tg vs 1 batch in t1
    return g * t1 / tg if tg > 0 else float(g)


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


def stage_sequence_1f1b(p: int, m: int, s: int) -> List[Tuple[str, int]]:
    """Stage ``s``'s op order under non-interleaved 1F1B: ``p - 1 - s``
    warm-up forwards, a steady one-forward-one-backward phase, then the
    cool-down backwards.  Microbatches complete in index order on every
    stage."""
    w = min(p - 1 - s, m)
    seq: List[Tuple[str, int]] = [("fwd", j) for j in range(w)]
    for j in range(m - w):
        seq.append(("fwd", w + j))
        seq.append(("bwd", j))
    seq += [("bwd", j) for j in range(m - w, m)]
    return seq


def schedule_1f1b(p: int, m: int) -> List[Tuple[int, str, int]]:
    """A deterministic topological execution order ``(stage, kind, micro)``
    of the 1F1B DAG — what a host-orchestrated runtime executes serially.

    Dependencies: ``fwd(s, j)`` needs ``fwd(s-1, j)``; ``bwd(s, j)`` needs
    ``bwd(s+1, j)`` and ``fwd(s, j)``; plus each stage runs its own ops in
    :func:`stage_sequence_1f1b` order."""
    seqs = [stage_sequence_1f1b(p, m, s) for s in range(p)]
    ptr = [0] * p
    done: set = set()
    order: List[Tuple[int, str, int]] = []
    total = sum(len(sq) for sq in seqs)
    while len(order) < total:
        progressed = False
        for s in range(p):
            if ptr[s] >= len(seqs[s]):
                continue
            kind, j = seqs[s][ptr[s]]
            if kind == "fwd":
                ready = s == 0 or (s - 1, "fwd", j) in done
            else:
                ready = ((s, "fwd", j) in done
                         and (s == p - 1 or (s + 1, "bwd", j) in done))
            if ready:
                order.append((s, kind, j))
                done.add((s, kind, j))
                ptr[s] += 1
                progressed = True
        if not progressed:  # pragma: no cover - the 1F1B DAG is deadlock-free
            raise RuntimeError("1F1B schedule deadlocked")
    return order


@dataclass
class PipelineSim:
    """Event-driven replay of per-op times through the 1F1B DAG."""

    makespan: float
    stage_busy: Tuple[float, ...]
    op_start: Dict[Tuple[int, str, int], float]
    op_finish: Dict[Tuple[int, str, int], float]

    @property
    def bubble_fraction(self) -> float:
        p = len(self.stage_busy)
        denom = p * self.makespan
        if denom <= 0:
            return 0.0
        return 1.0 - sum(self.stage_busy) / denom


def _op_time(times: Sequence[Sequence[float]], s: int, j: int) -> float:
    t = float(times[s][j])
    if t < 0:
        raise ValueError(f"negative op time {t} at stage {s} micro {j}")
    return t


def simulate_1f1b(fwd_times: Sequence[Sequence[float]],
                  bwd_times: Sequence[Sequence[float]]) -> PipelineSim:
    """Simulate the 1F1B schedule with per-op durations
    ``fwd_times[s][j]`` / ``bwd_times[s][j]`` (``p`` stages x ``m``
    microbatches).  Each op starts at max(stage free, deps finished);
    returns makespan, per-stage busy time, and the bubble fraction
    ``1 - sum(busy) / (p * makespan)``.

    With uniform ``f`` and ``b`` the makespan is ``(m+p-1)(f+b)`` and the
    bubble equals :func:`pipeline_bubble` exactly.
    """
    p = len(fwd_times)
    if p == 0 or len(bwd_times) != p:
        raise ValueError("fwd_times/bwd_times must have one row per stage")
    m = len(fwd_times[0])
    if any(len(row) != m for row in fwd_times) or \
            any(len(row) != m for row in bwd_times):
        raise ValueError("ragged microbatch rows")
    start: Dict[Tuple[int, str, int], float] = {}
    finish: Dict[Tuple[int, str, int], float] = {}
    avail = [0.0] * p
    busy = [0.0] * p
    for (s, kind, j) in schedule_1f1b(p, m):
        ready = 0.0
        if kind == "fwd":
            if s > 0:
                ready = finish[(s - 1, "fwd", j)]
            dur = _op_time(fwd_times, s, j)
        else:
            ready = finish[(s, "fwd", j)]
            if s < p - 1:
                ready = max(ready, finish[(s + 1, "bwd", j)])
            dur = _op_time(bwd_times, s, j)
        t0 = max(avail[s], ready)
        start[(s, kind, j)] = t0
        finish[(s, kind, j)] = t0 + dur
        avail[s] = t0 + dur
        busy[s] += dur
    return PipelineSim(makespan=max(avail), stage_busy=tuple(busy),
                       op_start=start, op_finish=finish)


def simulate_serial(fwd_times: Sequence[Sequence[float]],
                    bwd_times: Sequence[Sequence[float]]) -> PipelineSim:
    """The no-overlap reference schedule: one op at a time, each microbatch
    forwarded through every stage then backwarded — what a pipeline without
    microbatch interleaving costs.  Its bubble approaches ``1 - 1/p``; 1F1B
    must beat it (the fig4 ``--quick`` assertion)."""
    p, m = len(fwd_times), len(fwd_times[0])
    t = 0.0
    busy = [0.0] * p
    start: Dict[Tuple[int, str, int], float] = {}
    finish: Dict[Tuple[int, str, int], float] = {}
    for j in range(m):
        for s in list(range(p)) + list(range(p - 1, -1, -1)):
            kind = "fwd" if (s, "fwd", j) not in start else "bwd"
            dur = _op_time(fwd_times if kind == "fwd" else bwd_times, s, j)
            start[(s, kind, j)] = t
            t += dur
            finish[(s, kind, j)] = t
            busy[s] += dur
    return PipelineSim(makespan=t, stage_busy=tuple(busy),
                       op_start=start, op_finish=finish)
