"""AsyncPSTrainer (the port of ``repro.distributed.async_ps``):
bounded-staleness parameter-server data parallelism.

Relaxes the synchronous-worker assumption under Lemma 3.2 (the paper's §2
taxonomy names stragglers and I/O stalls as exactly what breaks it at
scale) along two axes:

**Bounded staleness** (``staleness = s``): each rank's replica of the
parameters is the "server" copy and advances every step, but each worker
computes its gradients against a private copy that it refreshes only on
its scheduled slot — worker ``w`` pulls at steps where
``(t + w) % (s + 1) == 0`` — so a worker's gradients are computed against
parameters at most ``s`` steps stale, the pull traffic in Eq. 7 amortizes
over ``s + 1`` steps, and refreshes stagger across workers.  ``s = 0`` has
every worker pull every step: the refresh is a byte-exact ``copy_`` of the
server params and the gradients are the synchronous trainer's, so the run
is **bitwise** the ``parameter_server`` strategy's.

**Backup workers** (``backup_workers = k``): each step drops the slowest
``k`` of ``dp`` gradients (simulated per-step delays, seeded exponential:
every rank draws the whole vector, so in one-rank mode every process
agrees on who is dropped) and averages the survivors, pre-scaled by
``dp / (dp - k)`` so the inherited sync's mean over ``dp`` is the survivor
mean.  ``k = 0`` multiplies by exactly 1.0 (IEEE-exact), so the
synchronous path is the same code path, not a special case.

As in JAX, the executed step runs the full parameter-server sync (push
and pull) every step; the ``pull / (s + 1)`` amortization lives in the
cost model (``repro_torch.core.ps.async_step_time``) that
:meth:`AsyncPSTrainer.async_report` sets against the measured refresh,
drop and age counters.

Each local rank's worker copy sits beside its replica on the rank's
device, one more parameter-sized tree per rank.  The copies are derived
state, never checkpointed: :meth:`AsyncPSTrainer.train` rebuilds them from
the (possibly restored) server params, with every age at 0.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.core import ps as ps_lib
from repro_torch.distributed.collectives import get_strategy
from repro_torch.distributed.compression import get_compressor
from repro_torch.distributed.trainer import DataParallelTrainer, _step_metrics
from repro_torch.models.common import tree_items, tree_map
from repro_torch.train import loop as loop_lib


@dataclass
class AsyncPSReport:
    """Measured async-PS behaviour vs the relaxed-lemma step model."""

    staleness: int
    backup_workers: int
    dp: int
    steps: int
    refreshes: int              # total worker pulls actually performed
    mean_age: float             # mean params age (steps) at grad time
    max_age: int                # never exceeds `staleness` by construction
    drops: int                  # total gradients dropped (= steps * k)
    drop_counts: Tuple[int, ...]  # per-worker drop totals
    pull_amortization: float    # 1 / (s + 1): Eq. 7 pull traffic factor
    t_step_model: Dict[str, float]  # repro_torch.core.ps.async_step_time terms

    def as_dict(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self.__dataclass_fields__}


class AsyncPSTrainer(DataParallelTrainer):
    """Bounded-staleness + backup-worker variant of the PS trainer, in
    either of the base trainer's modes (all ranks in threads, or one rank
    per process).

    Parameters (beyond :class:`DataParallelTrainer`'s)
    ----------
    staleness:
        Max age ``s`` (in steps) of the params a worker may compute
        gradients against.  0 = fully synchronous.
    backup_workers:
        Slowest ``k`` gradients dropped per step, ``0 <= k < dp``.
    mean_delay_s:
        Mean of the seeded exponential per-worker delay used to *rank*
        workers each step (and to price the straggler model); the
        simulation never sleeps.
    delay_seed:
        Seed of the delay draws.
    """

    def __init__(self, cfg, run, opt, *, staleness: int = 0,
                 backup_workers: int = 0, mean_delay_s: float = 0.01,
                 strategy="parameter_server", compression="none",
                 delay_seed: int = 0, **kwargs):
        if kwargs.pop("sync_overlap", False):
            raise ValueError("AsyncPSTrainer: sync_overlap is a synchronous-"
                             "schedule optimization; staleness already "
                             "amortizes the pull traffic")
        strategy = (get_strategy(strategy) if isinstance(strategy, str)
                    else strategy)
        compression = (get_compressor(compression)
                       if isinstance(compression, str) else compression)
        # refused before the base class builds (and waits on) its groups
        if strategy.hierarchical:
            raise ValueError("AsyncPSTrainer needs a flat strategy (the "
                             "worker refresh schedule assumes one data axis)")
        if compression.stateful:
            raise ValueError("AsyncPSTrainer: error-feedback compressors "
                             "assume every gradient lands; incompatible "
                             "with backup-worker drops")
        if staleness < 0:
            raise ValueError(f"staleness must be >= 0, got {staleness}")
        super().__init__(cfg, run, opt, strategy=strategy,
                         compression=compression, **kwargs)
        if not 0 <= backup_workers < self.dp:
            self.close()
            raise ValueError(f"need 0 <= backup_workers < dp={self.dp}, "
                             f"got {backup_workers}")
        self.staleness = int(staleness)
        self.backup_workers = int(backup_workers)
        self.mean_delay_s = float(mean_delay_s)
        self.delay_seed = int(delay_seed)
        self._reset()

    def _reset(self) -> None:
        """Fresh worker copies (built at the first step) and counters."""
        self._workers = None      # per local rank: a private params tree
        self._mask = np.zeros(self.dp, bool)
        self._ages = np.zeros(self.dp, np.int64)
        self._refreshes = 0
        self._age_sum = 0
        self._age_max = 0
        self._drop_counts = np.zeros(self.dp, np.int64)
        self._steps_run = 0

    # ------------------------------------------------------------------
    def _refresh_mask(self, t: int) -> np.ndarray:
        """Worker w pulls at steps with (t + w) % (s + 1) == 0 — every
        worker's age stays <= s and refreshes stagger across the window."""
        return ((t + np.arange(self.dp)) % (self.staleness + 1)) == 0

    def _step_weights(self, rng: np.random.Generator) -> np.ndarray:
        """Per-worker gradient weights for this step: drop the k slowest
        (by simulated seeded delay), scale survivors so the mean over dp is
        the survivor mean.  k=0 -> all exactly 1.0."""
        dp, k = self.dp, self.backup_workers
        delays = rng.exponential(self.mean_delay_s, dp)
        w = np.full(dp, dp / (dp - k) if k else 1.0, np.float32)
        if k:
            dropped = np.argsort(delays)[-k:]
            w[dropped] = 0.0
            self._drop_counts[dropped] += 1
        return w

    def _compute(self, params, batch, i):
        """Local rank i's gradients at its worker copy, refreshed first
        (a byte-exact copy of the rank's server replica) when this step's
        schedule says so."""
        if self._mask[self.ranks[i]]:
            with torch.no_grad():
                for (_, w), (_, p) in zip(tree_items(self._workers[i]),
                                          tree_items(params[i])):
                    w.copy_(p)
        return super()._compute(self._workers, batch, i)

    # ------------------------------------------------------------------
    def step_fn(self):
        """Loop-compatible step: refresh scheduled workers from the server
        copy, compute per-worker grads at their (possibly stale) params,
        drop/rescale, then the inherited sync + server update."""
        counter = {"t": 0}
        rng = np.random.default_rng(self.delay_seed)

        def step(params, opt_state, batch):
            t = counter["t"]
            counter["t"] = t + 1
            if self._workers is None:
                self._workers = self._each(
                    lambda i: tree_map(torch.clone, params[i]))
                self._ages[:] = 0
            tr = self.tracer
            self._mask = mask = self._refresh_mask(t)
            losses, grads, t_c = self._compute_phase(params, batch)
            self._refreshes += int(mask.sum())
            self._ages[mask] = 0
            self._age_sum += int(self._ages.sum())
            self._age_max = max(self._age_max, int(self._ages.max()))
            self._ages += 1
            with tr.span("dist_update") as sp_s:
                w = self._step_weights(rng)

                def sync(i):
                    wi = float(w[self.ranks[i]])
                    for _, g in tree_items(grads[i]):
                        g.mul_(wi)
                    return self._sync(grads, opt_state, i)

                synced = self._each(sync)
            del grads
            with tr.span("param_update") as sp_u:
                gnorms = self._each(
                    lambda i: self._update(params, opt_state, synced, i))
            self._steps_run += 1
            self._publish_phases(t_c, sp_s.elapsed_s, sp_u.elapsed_s)
            self.metrics.observe("train/refreshes", float(mask.sum()))
            return params, opt_state, _step_metrics(
                losses, gnorms[0], sp_s.elapsed_s, sp_u.elapsed_s)

        return step

    # ------------------------------------------------------------------
    def train(self, **kw) -> loop_lib.TrainResult:
        # fresh worker copies + counters per run: a resumed run rebuilds
        # the workers from the restored server params (the copies are
        # derived state, deliberately absent from checkpoints — all
        # workers restart fresh, ages 0)
        self._reset()
        return super().train(**kw)

    # ------------------------------------------------------------------
    def async_report(self) -> AsyncPSReport:
        """Measured staleness/straggler counters + the T_step(s, k) model
        evaluated at this run's measured compute time (the steady-state
        mean; in one-rank mode the slowest rank's), priced at the
        trainer's link bandwidth."""
        n_ps = self.strategy.n_servers or self.dp
        model = ps_lib.async_step_time(
            self._grad_bytes, self.dp, n_ps, self.link_bw,
            self.summary["compute"], staleness=self.staleness,
            backup_workers=self.backup_workers, mean_delay=self.mean_delay_s)
        steps = self._steps_run
        return AsyncPSReport(
            staleness=self.staleness,
            backup_workers=self.backup_workers,
            dp=self.dp,
            steps=steps,
            refreshes=self._refreshes,
            mean_age=(self._age_sum / (steps * self.dp)) if steps else 0.0,
            max_age=self._age_max,
            drops=int(self._drop_counts.sum()),
            drop_counts=tuple(int(c) for c in self._drop_counts),
            pull_amortization=1.0 / (self.staleness + 1),
            t_step_model=model,
        )
