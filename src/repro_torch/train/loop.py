"""Instrumented training loop (the port of ``repro.train.loop``): the
paper's Fig.-1 pipeline made executable.

Each iteration measures the steps: data load / prep / h2d come from the
``PrefetchLoader``; the ``step`` span times the train step, and a step
callable may split its own distributed and parameter-update phases out of
it (``t_comm`` / ``t_update`` in its metrics, as the data-parallel trainer
does).  On a card, each span ends after a device synchronize, so its wall
clock is the measurement, not the enqueue.  The loop emits ``StepTimes``
so R_O (Lemma 3.1) is evaluated on real timings.

Checkpointing (``ckpt_dir``) saves the logical training state every
``ckpt_every`` steps through an async ``CheckpointManager`` and resumes
from the newest complete step, in the JAX package's format (see
:func:`train`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_into)
from repro_torch.configs.base import ModelConfig
from repro_torch.core.pipeline import STEP_NAMES, StepTimes
from repro_torch.data.pipeline import Placement, PrefetchLoader
from repro_torch.launch.steps import build_train_step
from repro_torch.models import model as M
from repro_torch.models.blocks import RunConfig
from repro_torch.models.common import resolve_device
from repro_torch.obs.trace import Tracer, monotonic
from repro_torch.optim import adamw as opt_lib


@dataclass
class TrainResult:
    losses: List[float]
    step_times: List[StepTimes]
    tokens_per_s: float
    start_step: int = 0

    @property
    def mean_r_o(self) -> float:
        ros = [t.r_o() for t in self.step_times[2:]]
        return float(np.mean(ros)) if ros else 0.0

    def summary(self) -> Dict[str, Any]:
        """The measured block of a report: loss trajectory, throughput,
        R_O, and steady-state (warmup-excluded) means of every Fig.-1
        step."""
        steady = self.step_times[2:] or self.step_times
        means = {name: float(np.mean([getattr(t, name) for t in steady]))
                 for name in STEP_NAMES} if steady else {}
        head, tail = self.losses[:5], self.losses[-5:]
        return {
            "steps": len(self.losses),
            "start_step": int(self.start_step),
            "loss_first": float(np.mean(head)) if head else float("nan"),
            "loss_last": float(np.mean(tail)) if tail else float("nan"),
            "losses": [float(l) for l in self.losses],
            "tokens_per_s": float(self.tokens_per_s),
            "r_o": self.mean_r_o,
            "step_times_mean": means,
        }


def sync_devices(devices) -> None:
    """Wait for every card among ``devices`` (no-op for the CPU)."""
    for d in {torch.device(d) for d in devices}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _logical(params, opt_state) -> dict:
    """The tree a checkpoint holds: params and the optimizer state without
    its ``"ef"`` error-feedback slot, which depends on the rank layout and
    is kept zero-fresh on resume (JAX's rule)."""
    return {"params": params,
            "opt_state": {k: v for k, v in opt_state.items() if k != "ef"}}


def _resume(ckpt_dir: str, params, opt_state,
           step: Optional[int] = None) -> int:
    """Restore checkpoint ``step`` (the newest when None) into ``params``
    and ``opt_state`` in place and return its step.  Both are one tree
    each, or (the data-parallel trainer's replicas) lists of per-rank
    trees, each of which receives the same logical tree."""
    reps = (list(zip(params, opt_state)) if isinstance(params, list)
            else [(params, opt_state)])
    trees = [_logical(p, s) for p, s in reps]
    step = restore_into(trees, ckpt_dir, step)
    for (_, state), tree in zip(reps, trees):
        state.update(tree["opt_state"])  # the int step comes back new
    return step


def train(cfg: ModelConfig, run: RunConfig, opt: opt_lib.OptConfig, *,
          batch: int, seq: int, steps: int, seed: int = 0,
          device: Placement = "cuda",
          loader: Optional[PrefetchLoader] = None,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
          start_step: Optional[int] = None,
          log_every: int = 10, params=None, opt_state=None,
          step_fn: Optional[Callable] = None,
          tracer: Optional[Tracer] = None) -> TrainResult:
    """Train for ``steps`` steps on ``device`` (``cuda`` unless the caller
    asks for ``cpu``; a list of devices places one batch shard on each,
    for a ``step_fn`` that runs one rank per device).

    ``step_fn`` (optional) replaces the default train step
    (``launch.steps.build_train_step``) with a caller-built executor, e.g.
    ``repro_torch.distributed.DataParallelTrainer``'s phase-split step.  It
    may attach host-side phase timings to its metrics as plain floats
    under ``t_comm`` / ``t_update``; they are split out of compute into
    ``StepTimes.dist_update`` / ``.param_update``.  ``tracer`` wraps every
    iteration in a ``step`` span and the loader wait in ``data_wait``; a
    missing or disabled tracer is replaced by a private enabled one, since
    the span wall clock is the compute measurement.

    Checkpointing: when ``ckpt_dir`` is set the loop saves the logical
    training state (``params`` + ``opt_state`` minus ``"ef"``; with a
    ``step_fn`` over per-rank replicas, the first local rank's) every
    ``ckpt_every`` steps through an async :class:`CheckpointManager`
    (``ckpt_every=0`` saves nothing), and AUTO-RESUMES: if a complete
    checkpoint exists in ``ckpt_dir``, it is restored into every replica
    in place and training restarts from its step with the loader
    fast-forwarded, so the resumed losses continue an uninterrupted run,
    on any number of ranks.  ``start_step`` pins the step to resume from
    (0: none), for ranks that agreed on it; None takes the newest.  The
    spans ``ckpt_restore``, ``ckpt_enqueue`` (the host copy a save costs
    the step) and ``ckpt_write`` (the writer thread's disk time) time the
    checkpoint work."""
    if tracer is None or not tracer.enabled:
        tracer = Tracer(enabled=True)
    devices = list(device) if isinstance(device, (list, tuple)) else [device]
    devices = [resolve_device(d) for d in devices]
    if params is None:
        params = M.init_params(cfg, seed, devices[0])
    if opt_state is None:
        opt_state = opt_lib.init_state(opt, params)

    if start_step is None:
        start_step = (latest_step(ckpt_dir) or 0) if ckpt_dir else 0
    if start_step:
        with tracer.span("ckpt_restore", step=start_step):
            _resume(ckpt_dir, params, opt_state, start_step)
            sync_devices(devices)
        print(f"  resuming from checkpoint step {start_step}"
              + (f" >= steps {steps}; nothing to do" if start_step >= steps
                 else ""), flush=True)
    mgr = (CheckpointManager(ckpt_dir, tracer) if ckpt_dir and ckpt_every
           else None)

    own_loader = loader is None
    if loader is None:
        loader = PrefetchLoader(cfg, batch, seq, device=device, seed=seed,
                                skip_batches=start_step)
    if step_fn is None:
        step_fn = build_train_step(cfg, run, opt)

    losses: List[float] = []
    times: List[StepTimes] = []
    sync_devices(devices)
    t_start = monotonic()
    try:
        for i in range(start_step, steps):
            with tracer.span("data_wait", step=i):
                dev_batch, bt = next(loader)
            with tracer.span("step", step=i) as sp:
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     dev_batch)
                loss = float(metrics["loss"])
                sync_devices(devices)
            t_comp = sp.elapsed_s
            t_comm = float(metrics.pop("t_comm", 0.0))
            t_upd = float(metrics.pop("t_update", 0.0))
            losses.append(loss)
            times.append(StepTimes(
                data_load=bt.data_load, data_prep=bt.data_prep, h2d=bt.h2d,
                compute=max(t_comp - t_comm - t_upd, 0.0),
                param_update=t_upd, dist_update=t_comm))
            if mgr is not None and (i + 1) % ckpt_every == 0:
                mgr.save(i + 1, _logical(params[0], opt_state[0])
                         if isinstance(params, list)
                         else _logical(params, opt_state))
            if log_every and (i % log_every == 0 or i == steps - 1):
                print(f"  step {i:4d} loss {loss:.4f} "
                      f"compute {t_comp*1e3:.0f}ms io "
                      f"{(bt.data_load+bt.data_prep+bt.h2d)*1e3:.0f}ms",
                      flush=True)
    finally:
        if own_loader:
            loader.close()
        if mgr is not None:
            mgr.close()
    wall = monotonic() - t_start
    tokens = max(steps - start_step, 0) * batch * seq
    return TrainResult(losses, times, tokens / max(wall, 1e-9), start_step)
